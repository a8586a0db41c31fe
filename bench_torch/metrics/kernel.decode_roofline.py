"""The fused decode kernel's (csrc/jpeg_decode.cu, jpeg_decode_rgb)
share of its roofline in the traced capture, in percent
(harness.readers.roofline_pct, work/jpeg_decode_rgb.py)."""

import sys

from harness import readers


def read(run):
    return readers.roofline_pct(run, "jpeg_decode_rgb", sys.stderr)
