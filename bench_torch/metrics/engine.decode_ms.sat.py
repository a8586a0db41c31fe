"""Mean Server-Timing f_decode (ms): the engine's host decode
(engine/processor.py), in the cells judged on throughput."""

from harness import readers


def read(run):
    return readers.mean_timing(run, "f_decode")
