"""Mean ms a batch waited for its results after its submit (micro-
batcher, engine/batcher.py: from the hand-over to the collect thread to
its event): /stats batcher Δdevice_wait_ms_total / Δbatches over the
window. Prints the spans' report of a traced run."""

import sys

from harness import spans


def read(run):
    spans.report(run, sys.stderr)
    return spans.ratio(run, ("batcher", "device_wait_ms_total"),
                       ("batcher", "batches"))
