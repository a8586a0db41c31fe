"""Mean ms the device thread spent staging a batch (micro-batcher,
engine/batcher.py, `fused.make_assembly`): /stats batcher
Δstage_ms_total / Δbatches over the window."""

from harness import spans


def read(run):
    return spans.ratio(run, ("batcher", "stage_ms_total"),
                       ("batcher", "batches"))
