"""Server-Timing response header (client-visible stage profiling),
the reference's simple-server-timing-header equivalent
(reference src/main.rs:139-146, 181, 225-231). The TPU build adds
finer-grained marks (f_batch / f_device / f_encode) when the
micro-batcher is active."""

from __future__ import annotations

import time
from typing import List, Tuple

HEADER_KEY = "Server-Timing"


class Timer:
    def __init__(self):
        self._t0 = time.perf_counter()
        self._marks: List[Tuple[str, float]] = []

    def add(self, name: str) -> None:
        now = time.perf_counter()
        self._marks.append((name, (now - self._t0) * 1000.0))
        self._t0 = now

    def add_duration(self, name: str, dur_ms: float) -> None:
        """Record an externally-measured stage (engine sub-stages)."""
        self._marks.append((name, dur_ms))

    def header_value(self) -> str:
        return ", ".join(f"{name};dur={dur:.1f}" for name, dur in self._marks)
