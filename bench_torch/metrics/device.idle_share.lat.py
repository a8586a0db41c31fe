"""Percent of the traced capture in which neither a kernel nor a copy
ran on the card (one H100): 1 - busy / capture, in the cells judged
on latency."""

from harness import readers


def read(run):
    return readers.idle_pct(run)
