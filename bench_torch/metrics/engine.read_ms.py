"""Mean ms of the entropy reader per JPEG it decoded (engine,
engine/processor.py `_note_read`: the reader's header and decode calls,
on the slot route and the dict route alike, not the slot's making):
/stats engine Δread_ms_total / Δreads over the window. None where the
server has no such counter."""

from harness import spans


def read(run):
    return spans.ratio(run, ("engine", "read_ms_total"), ("engine", "reads"))
