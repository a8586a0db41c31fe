"""Mean scans the entropy reader decoded per JPEG (engine,
engine/processor.py `_note_read`; 1 for an interleaved baseline stream,
10 for libjpeg's standard progressive script of a YCbCr stream): /stats
engine Δread_scans_total / Δreads over the window. None where the
server has no such counter."""

from harness import spans


def read(run):
    return spans.ratio(run, ("engine", "read_scans_total"),
                       ("engine", "reads"))
