"""Mean ms the device thread waited for a pipeline permit before a
batch's submit (micro-batcher, engine/batcher.py): /stats batcher
Δpermit_wait_ms_total / Δbatches over the window."""

from harness import spans


def read(run):
    return spans.ratio(run, ("batcher", "permit_wait_ms_total"),
                       ("batcher", "batches"))
