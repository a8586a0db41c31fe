"""Server-Timing response header (client-visible stage profiling),
the reference's simple-server-timing-header equivalent
(reference src/main.rs:139-146, 181, 225-231). The port adds the
engine's marks f_decode / f_device / f_encode between f_fetch and
f_process (`engine.processor`); each stage's span in a `GET /profile`
capture comes from the same clock reads as its mark."""

from __future__ import annotations

import time
from typing import List, Tuple

HEADER_KEY = "Server-Timing"


class Timer:
    def __init__(self):
        self._t0 = time.perf_counter_ns()
        self._marks: List[Tuple[str, float]] = []

    def add(self, name: str) -> Tuple[int, int]:
        """Mark the time since the last mark (or the start); returns the
        two perf_counter_ns stamps the mark spans."""
        t0, now = self._t0, time.perf_counter_ns()
        self._marks.append((name, (now - t0) / 1e6))
        self._t0 = now
        return t0, now

    def add_duration(self, name: str, dur_ms: float) -> None:
        """Record an externally-measured stage (engine sub-stages)."""
        self._marks.append((name, dur_ms))

    def header_value(self) -> str:
        return ", ".join(f"{name};dur={dur:.1f}" for name, dur in self._marks)
