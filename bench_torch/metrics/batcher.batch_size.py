"""Images per device batch (engine/batcher.py): /stats batcher
Δimages / Δbatches over the window."""

from harness import readers


def read(run):
    return readers.window_ratio(run, "images", "batches")
