"""A torch.profiler Chrome trace of the server (`GET /profile`), read
for the device's activity: its kernels and copies, the union of their
intervals (busy time), and what the host was doing in the longest
gaps between them."""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


def union_us(spans: List[Tuple[float, float]]) -> float:
    """The length covered by the union of (start, end) intervals."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


class Trace:
    def __init__(self, events: List[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS]
        self.host = [e for e in xs if e.get("cat") in HOST_CATS]

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events)

    def kernels(self, name_part: str) -> List[dict]:
        return [e for e in self.device
                if e.get("cat") == "kernel" and name_part in e.get("name", "")]

    @staticmethod
    def seconds(events: List[dict]) -> float:
        return sum(float(e["dur"]) for e in events) / 1e6

    def busy_s(self) -> float:
        if not self.device:
            return 0.0
        # from the first stamp: stamps near 1e12 us round the sums
        base = min(float(e["ts"]) for e in self.device)
        return union_us([(float(e["ts"]) - base,
                          float(e["ts"]) - base + float(e["dur"]))
                         for e in self.device]) / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        """The n device operations that took the most time, summed by
        name: [[name, seconds], ...]."""
        total: Dict[str, float] = defaultdict(float)
        for e in self.device:
            total[e.get("name", "?")] += float(e["dur"]) / 1e6
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The n longest gaps between device activity, each named by the
        host operation that overlaps it most ("no host op traced" where
        none does): [[name, seconds], ...]."""
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in self.device)
        gaps, end = [], None
        for a, b in spans:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        e.get("name", "?")) for e in self.host))
        out = []
        for a, b in gaps[:n]:
            best: Optional[Tuple[float, str]] = None
            for ha, hb, name in host:
                if ha >= b:
                    break
                over = min(b, hb) - max(a, ha)
                if over > 0 and (best is None or over > best[0]):
                    best = (over, name)
            out.append([best[1] if best else "no host op traced",
                        (b - a) / 1e6])
        return out
