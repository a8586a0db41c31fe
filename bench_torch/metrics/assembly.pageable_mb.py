"""MB (1e6 bytes) uploaded from pageable host memory per image (batch
assembly, ops/fused.py `_device_cached` misses): /stats batcher
Δpageable_bytes / Δimages over the window."""

from harness import spans


def read(run):
    return spans.ratio(run, ("batcher", "pageable_bytes"),
                       ("batcher", "images"), 1e-6)
