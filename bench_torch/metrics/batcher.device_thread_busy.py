"""Percent of the window the batcher's device thread spent staging and
submitting served batches (micro-batcher, engine/batcher.py): 100 ×
Δ(stage_ms_total + submit_ms_total) / Δt_ms of /stats."""

from harness import spans


def read(run):
    return spans.device_thread_busy_pct(run)
