"""Mean Server-Timing f_encode (ms): the engine's host encode
(engine/processor.py)."""

from harness import readers


def read(run):
    return readers.mean_timing(run, "f_encode")
