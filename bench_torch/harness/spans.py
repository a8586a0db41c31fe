"""The port's own spans in a `GET /profile` capture, and its `/stats`
counters read as a window: what the per-layer metrics of the stages
between the gateway and the card read.

The spans are the capture's `cat: "fanlin"` events
(fanlin_tpu_torch/utils/profiling.py): complete events on the thread
that ran the stage, and pairs of async events ("b", "e") keyed by a
request's id for the stages of a request that cross threads. The
counters are /stats `gateway`, `engine` and `batcher` sections, and
`t_ms`, the server's clock at the read. Every reader returns None where
the run has nothing to read, as a program without these spans or
counters has not.

`report` prints what PERF.md reads from a traced run: the share of the
requests that the spans account for, which spans enclose the card's
pageable copies, what the host did in the card's longest idle gaps, and
the answers inside the capture against those before and after it.
"""

from __future__ import annotations

import dataclasses
import json
import math
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from . import readers
from .devtrace import DEVICE_CATS, union_us

CAT = "fanlin"
CLOCK_SYNC = "fanlin.clock_sync"
FEEDING = ("fanlin.batcher.stage", "fanlin.batcher.submit")
# a request's children: what the gateway, the pool and the engine time
REQUEST_PARTS = ("fanlin.gateway.admit", "fanlin.origin.fetch",
                 "fanlin.engine.pool_wait", "fanlin.engine.decode",
                 "fanlin.engine.device", "fanlin.engine.encode")
# the phases of a request's batch, read by the batch's id
BATCH_PARTS = ("fanlin.batcher.stage", "fanlin.batcher.permit_wait",
               "fanlin.batcher.submit", "fanlin.batcher.device_wait",
               "fanlin.batcher.unpack")
PAGEABLE_COPY = "Memcpy HtoD (Pageable -> Device)"


@dataclasses.dataclass
class Span:
    name: str
    ts: float  # microseconds, the trace's clock
    dur: float
    tid: int
    args: dict
    on_thread: bool = True  # a complete event; False: a request's async one

    @property
    def end(self) -> float:
        return self.ts + self.dur


class Spans:
    """The fanlin spans of one Chrome trace, with the card's intervals
    and the capture's start (its first clock-sync annotation)."""

    def __init__(self, events: List[dict]):
        self.spans: List[Span] = []
        opened: Dict[tuple, list] = defaultdict(list)
        self.start: Optional[float] = None
        self.device: List[Tuple[float, float, str]] = []
        # the card's pageable H2D copies, each with the host call that
        # issued it (its CUDA runtime event, by correlation id)
        self.pageable: List[Tuple[float, float, object]] = []
        self.runtime: Dict[object, Tuple[float, float]] = {}
        for e in events:
            cat, ph = e.get("cat"), e.get("ph")
            if cat in DEVICE_CATS and ph == "X" and "dur" in e:
                ts = float(e["ts"])
                self.device.append((ts, ts + float(e["dur"]),
                                    e.get("name", "?")))
                if e.get("name") == PAGEABLE_COPY:
                    self.pageable.append((ts, ts + float(e["dur"]), (
                        e.get("args") or {}).get("correlation")))
            elif cat == "cuda_runtime" and ph == "X" and "dur" in e:
                ts = float(e["ts"])
                self.runtime[(e.get("args") or {}).get("correlation")] = (
                    ts, ts + float(e["dur"]))
            elif e.get("name") == CLOCK_SYNC and ph == "X":
                ts = float(e["ts"])
                self.start = ts if self.start is None else min(self.start, ts)
            if cat != CAT:
                continue
            if ph == "X":
                self.spans.append(Span(e["name"], float(e["ts"]),
                                       float(e["dur"]), e.get("tid"),
                                       e.get("args") or {}))
            elif ph == "b":
                opened[(e["name"], e.get("id"))].append(e)
            elif ph == "e":
                waiting = opened.get((e["name"], e.get("id")))
                if waiting:
                    b = waiting.pop(0)
                    self.spans.append(Span(
                        e["name"], float(b["ts"]),
                        float(e["ts"]) - float(b["ts"]), b.get("tid"),
                        b.get("args") or {}, on_thread=False))
        self.by_name: Dict[str, List[Span]] = defaultdict(list)
        for s in self.spans:
            self.by_name[s.name].append(s)

    @classmethod
    def load(cls, path) -> "Spans":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    def named(self, name: str) -> List[Span]:
        return self.by_name.get(name, [])


_LOADED: Dict[str, Spans] = {}


def of_run(run) -> Optional[Spans]:
    """The spans of the run's capture, or None without a capture or
    without a fanlin span in it."""
    cap = run.capture
    if cap is None or not cap.trace_file:
        return None
    if cap.trace_file not in _LOADED:
        _LOADED.clear()
        _LOADED[cap.trace_file] = Spans.load(cap.trace_file)
    spans = _LOADED[cap.trace_file]
    return spans if spans.spans and spans.start is not None else None


# -- /stats as a window -------------------------------------------------------

def delta(run, section: Optional[str], key: str) -> Optional[float]:
    """After − before of /stats `section.key` (of a top-level key when
    `section` is None) over the window; None where either read lacks
    it."""
    try:
        a, b = run.stats_after, run.stats_before
        if section is not None:
            a, b = a[section], b[section]
        return float(a[key]) - float(b[key])
    except (KeyError, TypeError, ValueError):
        return None


def ratio(run, num: Tuple[Optional[str], str], den: Tuple[Optional[str], str],
          scale: float = 1.0) -> Optional[float]:
    """Δnum / Δden × scale over the window, each a (section, key); None
    where either is missing or Δden is not positive."""
    n, d = delta(run, *num), delta(run, *den)
    if n is None or d is None or d <= 0:
        return None
    return n / d * scale


def device_thread_busy_pct(run) -> Optional[float]:
    """100 × Δ(stage_ms_total + submit_ms_total) / Δt_ms: the share of
    the window the batcher's device thread spent staging and submitting
    served batches."""
    stage = delta(run, "batcher", "stage_ms_total")
    submit = delta(run, "batcher", "submit_ms_total")
    t = delta(run, None, "t_ms")
    if stage is None or submit is None or t is None or t <= 0:
        return None
    return 100.0 * (stage + submit) / t


# -- the capture --------------------------------------------------------------

def _merged(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs: List[List[float]], ys: List[List[float]]) -> float:
    """The length common to two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _window(spans: Spans, seconds: float) -> Tuple[float, float]:
    return spans.start, spans.start + seconds * 1e6


def feeding(spans: Spans, lo: float, hi: float) -> List[List[float]]:
    """The device thread's staging and submits of served batches,
    clipped to [lo, hi], merged."""
    return _merged((max(s.ts, lo), min(s.end, hi))
                   for name in FEEDING for s in spans.named(name)
                   if not s.args.get("warm") and s.end > lo and s.ts < hi)


def idle_feeding_pct(run) -> Optional[float]:
    """Percent of the capture in which no kernel or copy runs on the card
    and the device thread is inside `fanlin.batcher.stage` or
    `.submit`: the card's idle time that the device thread's serial host
    work explains."""
    spans = of_run(run)
    if spans is None:
        return None
    lo, hi = _window(spans, run.capture.seconds)
    feed = feeding(spans, lo, hi)
    busy = _merged((a, b) for a, b, _ in spans.device)
    idle_feed = union_us([tuple(x) for x in feed]) - _overlap(feed, busy)
    return 100.0 * idle_feed / (run.capture.seconds * 1e6)


def _rid_index(spans: Spans, names) -> Dict[str, Dict[object, Span]]:
    out: Dict[str, Dict[object, Span]] = {}
    for name in names:
        out[name] = {s.args.get("rid"): s for s in spans.named(name)}
    return out


def request_residuals(spans: Spans, with_return: bool = False
                      ) -> List[Tuple[float, float]]:
    """For every image request wholly inside the capture (it has a
    fetch span): (its `fanlin.request` µs, what its children leave out
    of it, µs). `with_return` counts the way back from the codec thread
    (`fanlin.engine.pool_return`) as a child too."""
    names = REQUEST_PARTS + (("fanlin.engine.pool_return",)
                             if with_return else ())
    idx = _rid_index(spans, names)
    out = []
    for r in spans.named("fanlin.request"):
        rid = r.args.get("rid")
        if r.ts < spans.start or rid not in idx["fanlin.origin.fetch"]:
            continue
        parts = sum(idx[n][rid].dur for n in names if rid in idx[n])
        out.append((r.dur, r.dur - parts))
    return out


def device_residuals(spans: Spans) -> List[Tuple[float, float]]:
    """For every `fanlin.engine.device` span inside the capture: (its
    µs, what its queue span, its batch's stage, permit wait, submit,
    device wait (with the time it queued for the collect thread) and
    unpack, and its hand-back leave out of it, µs)."""
    idx = _rid_index(spans, ("fanlin.batcher.queue",
                             "fanlin.batcher.handoff"))
    batches: Dict[object, float] = defaultdict(float)
    for name in BATCH_PARTS:
        for s in spans.named(name):
            if not s.args.get("warm"):
                batches[s.args.get("batch")] += (
                    s.dur + 1e3 * float(s.args.get("queued_ms", 0.0)))
    out = []
    for d in spans.named("fanlin.engine.device"):
        rid = d.args.get("rid")
        q = idx["fanlin.batcher.queue"].get(rid)
        if d.ts < spans.start or q is None:
            continue
        h = idx["fanlin.batcher.handoff"].get(rid)
        parts = q.dur + batches.get(q.args.get("batch"), 0.0) + (
            h.dur if h is not None else 0.0)
        out.append((d.dur, d.dur - parts))
    return out


def covered_share(residuals, floor_us: float) -> Optional[float]:
    """The share of (total, residual) pairs whose residual is at most
    max(floor_us, 5 % of the total)."""
    if not residuals:
        return None
    ok = sum(1 for t, r in residuals if r <= max(floor_us, 0.05 * t))
    return ok / len(residuals)


def pageable_enclosed(spans: Spans) -> Tuple[int, int, int]:
    """The card's pageable H2D copies: (those issued inside a
    `fanlin.assembly.pageable_upload` span, that is whose CUDA runtime
    call lies in it; those whose copy on the card lies in it too; all
    of them). A pageable copy may run on the card after its call has
    returned: the call returns once the bytes are in CUDA's pinned
    staging buffer."""
    ups = [(u.ts, u.end) for u in
           spans.named("fanlin.assembly.pageable_upload")]

    def within(a, b):
        return any(lo <= a and b <= hi for lo, hi in ups)

    issued = done = 0
    for a, b, corr in spans.pageable:
        call = spans.runtime.get(corr)
        if call is not None and within(*call):
            issued += 1
            done += within(a, b)
    return issued, done, len(spans.pageable)


def idle_gaps(spans: Spans, seconds: float, n: int = 10) -> List[tuple]:
    """The n longest gaps between the card's activity inside the
    capture, each with the fanlin span of a batcher thread that overlaps
    it most: [(gap ms, span name, its thread, overlap ms)]."""
    lo, hi = _window(spans, seconds)
    busy = _merged((max(a, lo), min(b, hi)) for a, b, _ in spans.device
                   if b > lo and a < hi)
    gaps, end = [], lo
    for a, b in busy:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [s for s in spans.spans if s.on_thread and s.name.startswith(
        ("fanlin.batcher.", "fanlin.assembly."))]
    out = []
    for a, b in gaps[:n]:
        best = (0.0, "no batcher span", "")
        for s in host:
            over = min(b, s.end) - max(a, s.ts)
            if over > best[0]:
                best = (over, s.name, s.args.get("thread", ""))
        out.append(((b - a) / 1e3, best[1], best[2], best[0] / 1e3))
    return out


def phase_means(spans: Spans) -> Dict[str, Tuple[int, float, float]]:
    """Per batcher phase of served batches: (spans, mean ms, mean CPU
    ms of its thread)."""
    out = {}
    for name in BATCH_PARTS:
        ss = [s for s in spans.named(name) if not s.args.get("warm")]
        if ss:
            out[name] = (len(ss), sum(s.dur for s in ss) / len(ss) / 1e3,
                         sum(float(s.args.get("cpu_ms", 0.0)) for s in ss)
                         / len(ss))
    return out


def inside_outside(run) -> Optional[dict]:
    """The answers of the window before the capture, inside it and after
    it (where the server writes the trace out): img/s and p50 ms of
    each, by when they were answered."""
    cap = run.capture
    if cap is None:
        return None

    def part(lo, hi):
        rs = [r for r in run.records if lo <= r.done < hi]
        v = readers.percentile([r.latency_s for r in rs], 50)
        return {"img_per_s": (sum(r.status == 200 for r in rs) / (hi - lo)
                              if hi > lo else None),
                "p50_ms": None if v is None or math.isinf(v) else v * 1e3}

    return {"before": part(run.t0, cap.t0), "inside": part(cap.t0, cap.t1),
            "after": part(cap.t1, run.t_end)}


_REPORTED = set()


def report(run, log) -> None:
    """Print, once per run, what the traced run's spans show (module
    docstring); the answers inside the capture and around it also for a
    program without spans."""
    if run.capture is None or id(run) in _REPORTED:
        return
    _REPORTED.add(id(run))
    io = inside_outside(run)
    print(f"spans: answers before / inside / after the capture "
          f"{json.dumps(io)}", file=log)
    spans = of_run(run)
    if spans is None:
        print("spans: no fanlin span in the capture", file=log)
        return
    for label, res in (("request", request_residuals(spans)),
                       ("request+return",
                        request_residuals(spans, with_return=True))):
        share = covered_share(res, 1000.0)
        left = sorted(r for _, r in res)
        print(f"spans: {label} coverage {share} of {len(res)} (max(1 ms, "
              f"5 %)); residual ms p50 "
              f"{readers.percentile(left, 50) / 1e3 if left else None} p95 "
              f"{readers.percentile(left, 95) / 1e3 if left else None}",
              file=log)
    res = device_residuals(spans)
    left = sorted(r for _, r in res)
    print(f"spans: device coverage {covered_share(res, 500.0)} of {len(res)} "
          f"(max(0.5 ms, 5 %)); residual ms p50 "
          f"{readers.percentile(left, 50) / 1e3 if left else None} p95 "
          f"{readers.percentile(left, 95) / 1e3 if left else None}",
          file=log)
    issued, done, copies = pageable_enclosed(spans)
    print(f"spans: pageable H2D copies issued inside a pageable_upload "
          f"span {issued} of {copies}, done inside it {done}", file=log)
    means = {k.rsplit(".", 1)[1]: [n, round(ms, 4), round(cpu, 4)]
             for k, (n, ms, cpu) in phase_means(spans).items()}
    print(f"spans: batch phases [spans, mean ms, mean cpu ms] "
          f"{json.dumps(means)}", file=log)
    for gap in idle_gaps(spans, run.capture.seconds):
        print("spans: idle gap %.3f ms: %s on %s for %.3f ms" % gap,
              file=log)
