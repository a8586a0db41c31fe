"""What the metric readers (end_to_end/*.py, metrics/*.py) share. Each
returns None where its run has nothing to read."""

from __future__ import annotations

import math
from typing import Optional

from . import cell as cell_mod
from . import imaging, peaks


def percentile(values, p: float) -> Optional[float]:
    """Nearest rank: the smallest value with at least p % of the values
    at or below it (an infinite value, a failed request, sorts last)."""
    s = sorted(values)
    if not s:
        return None
    return s[max(math.ceil(p / 100.0 * len(s)) - 1, 0)]


def latency_ms(run, p: float) -> Optional[float]:
    """The p-th percentile over every request of the window, each from
    when it was due; a failed one counts as infinite."""
    v = percentile([r.latency_s for r in run.records], p)
    return None if v is None else v * 1e3


def mean_timing(run, mark: str) -> Optional[float]:
    """Mean Server-Timing `mark` (ms) over the window's answered
    requests that carry it."""
    v = [r.timing[mark] for r in run.records
         if r.status == 200 and mark in r.timing]
    return sum(v) / len(v) if v else None


def delta(before: dict, after: dict, key: str) -> float:
    return after["batcher"][key] - before["batcher"][key]


def window_ratio(run, num: str, den: str, scale: float = 1.0) -> Optional[float]:
    d = delta(run.stats_before, run.stats_after, den)
    if d <= 0:
        return None
    return delta(run.stats_before, run.stats_after, num) / d * scale


def idle_pct(run) -> Optional[float]:
    cap = run.capture
    if cap is None or cap.trace is None or not cap.trace.device:
        return None
    return 100.0 * (1.0 - cap.trace.busy_s() / cap.seconds)


_LEAST = {}


def roofline_pct(run, kernel: str, log=None) -> Optional[float]:
    """The share of the kernel's device time in the capture that the
    least work of its images needs: the calls the trace holds times the
    capture's mean batch (Δimages / Δbatches of /stats around it), each
    image at the mean least time of the (source, query) pairs answered
    during the capture, over the summed duration of the kernel's
    records."""
    cap = run.capture
    if cap is None or cap.trace is None:
        return None
    work = cell_mod.load_module("work", kernel)
    recs = cap.trace.kernels(work.TRACE_NAME)
    calls = len(cap.trace.kernels(work.CALL_NAME))
    device_s = cap.trace.seconds(recs)
    batches = delta(cap.stats_before, cap.stats_after, "batches")
    images = delta(cap.stats_before, cap.stats_after, "images")
    answered = [r for r in run.records
                if r.status == 200 and cap.t0 <= r.done <= cap.t1]
    if not calls or device_s <= 0 or batches <= 0 or not answered:
        return None
    least, by = 0.0, set()
    for r in answered:
        key = (kernel, r.src, r.query)
        if key not in _LEAST:
            src = run.sources[r.src]
            geo = imaging.geometry(src["w"], src["h"], r.query)
            _LEAST[key] = work.least(geo, src, peaks)
        least += _LEAST[key]["bound_s"]
        by.add(_LEAST[key]["bound_by"])
    least_s = calls * images / batches * least / len(answered)
    if log is not None:
        print(f"{kernel}: bound by {' and '.join(sorted(by))} "
              f"(H100 peaks, {peaks.CLOCK_HZ / 1e9:.2f} GHz assumed for "
              f"integer issue); {calls} calls, {images / batches:.3f} "
              f"images a batch, least {least_s * 1e3:.4f} ms of "
              f"{device_s * 1e3:.4f} ms on the device", file=log)
    return 100.0 * least_s / device_s
