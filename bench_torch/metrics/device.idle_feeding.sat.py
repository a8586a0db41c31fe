"""Percent of the traced capture in which neither a kernel nor a copy
ran on the card (one H100) while the batcher's device thread was inside
`fanlin.batcher.stage` or `.submit` (harness.spans.idle_feeding_pct), in
the cells judged on throughput. Prints the spans' report of the run."""

import sys

from harness import spans


def read(run):
    spans.report(run, sys.stderr)
    return spans.idle_feeding_pct(run)
