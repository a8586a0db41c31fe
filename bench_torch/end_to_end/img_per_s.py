"""Images served per second: requests answered 200, with a body that
passed the check, within the window, over its length."""


def read(run):
    done = sum(1 for r in run.records
               if r.status == 200 and r.body_hash not in run.wrong
               and r.done <= run.t_end)
    return done / run.seconds
