"""Mean ms from an image's future resolved on the collect thread to its
request thread holding the result (micro-batcher, engine/batcher.py
`note_handoff`): /stats batcher Δhandoff_ms_total / Δimages over the
window."""

from harness import spans


def read(run):
    return spans.ratio(run, ("batcher", "handoff_ms_total"),
                       ("batcher", "images"))
