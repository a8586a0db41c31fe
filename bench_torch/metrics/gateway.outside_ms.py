"""Mean ms a request spends outside the handler (HTTP gateway,
server/app.py): the client-seen time from send to answer, less the
Server-Timing total (f_fetch + f_process). The max_clients semaphore,
the event loop and HTTP."""


def read(run):
    v = [(r.done - r.sent) * 1e3 - r.timing["f_fetch"] - r.timing["f_process"]
         for r in run.records
         if r.status == 200 and "f_fetch" in r.timing
         and "f_process" in r.timing]
    return sum(v) / len(v) if v else None
