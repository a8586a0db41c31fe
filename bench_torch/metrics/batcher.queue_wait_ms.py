"""Mean ms an image waited in the micro-batcher (engine/batcher.py):
/stats batcher Δqueue_wait_ms_total / Δimages over the window."""

from harness import readers


def read(run):
    return readers.window_ratio(run, "queue_wait_ms_total", "images")
