"""Mean ms of a batch's submit on the device thread (micro-batcher,
engine/batcher.py, `asm.submit()`: uploads, launches, plan rebuilds and
pageable uploads): /stats batcher Δsubmit_ms_total / Δbatches over the
window."""

from harness import spans


def read(run):
    return spans.ratio(run, ("batcher", "submit_ms_total"),
                       ("batcher", "batches"))
