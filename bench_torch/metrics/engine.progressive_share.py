"""% of the JPEGs the entropy reader decoded that were progressive
(SOF2) streams (engine, engine/processor.py `_note_read`): /stats engine
100 × Δprogressive_reads / Δreads over the window. None where the
server has no such counter."""

from harness import spans


def read(run):
    return spans.ratio(run, ("engine", "progressive_reads"),
                       ("engine", "reads"), 100.0)
