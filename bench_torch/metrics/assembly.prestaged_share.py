"""% of the window's images whose coefficient wire a codec thread staged
into a pooled slot before the batch (batch assembly, ops/fused.py
`WireSlotPool`, engine/batcher.py `prestage`): /stats batcher
100 × Δprestaged / Δimages. None where the server has no such counter."""

from harness import spans


def read(run):
    return spans.ratio(run, ("batcher", "prestaged"), ("batcher", "images"),
                       100.0)
