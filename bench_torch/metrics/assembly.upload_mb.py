"""MB (1e6 bytes) staged to the card per image (batch assembly,
ops/fused.py): /stats batcher Δupload_bytes / Δimages over the window."""

from harness import readers


def read(run):
    return readers.window_ratio(run, "upload_bytes", "images", 1e-6)
