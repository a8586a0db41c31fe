"""Mean ms a request waited for a codec thread (engine, server/state.py
and engine/processor.py `note_pool_wait`): /stats engine
Δpool_wait_ms_total / Δrequests over the window."""

from harness import spans


def read(run):
    return spans.ratio(run, ("engine", "pool_wait_ms_total"),
                       ("engine", "requests"))
