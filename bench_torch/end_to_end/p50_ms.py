"""Median latency (ms) over every request of the window, each timed
from when it was due; a failed request counts as infinite."""

from harness import readers


def read(run):
    return readers.latency_ms(run, 50)
