"""The resample kernel's (csrc/resample.cu) share of its roofline in
the traced capture, in percent (harness.readers.roofline_pct,
work/resample.py)."""

import sys

from harness import readers


def read(run):
    return readers.roofline_pct(run, "resample", sys.stderr)
