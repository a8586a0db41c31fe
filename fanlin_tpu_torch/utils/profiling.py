"""One torch.profiler capture at a time in this process, and the port's
own spans and per-thread tallies.

torch.profiler drives one process-wide Kineto session, but tells only
the thread that started it that it is on: a second capture started from
another thread is not refused, and stopping the first then ends the
second's session under it (the process can crash there). So every
capture of the port (the gateway's `GET /profile`, `tpu.profile_dir`)
goes through `exclusive`, which refuses a second one with ProfilerBusy
instead. A capture opened with torch.profiler directly is not seen:
start none beside a server that has the route.

Spans. While `exclusive` holds a capture, `span` and `record` append
one record each (name, start and end on `time.perf_counter_ns`, the OS
thread id and name, args) to an in-memory list; `export` writes them
into the capture's Chrome trace with `cat: "fanlin"`, on the profiler's
clock. With no capture running a span costs one test of a module-level
flag (`on()`), allocates nothing and calls no torch function: callers
that build args guard with `on()` themselves. A span with a `key` (a
request id) is written as a pair of async events of that id, so the
spans of one request line up on one track across threads, and requests
that overlap on one thread (the event loop) render apart; a span
without one is a complete event on the thread that recorded it.
Records reach every thread, whatever Kineto registers, and carry args,
which `torch.profiler.record_function` does not export.

The clock: at capture start three `record_function` annotations named
`CLOCK_SYNC` are each bracketed by `perf_counter_ns` reads; the offset
from `perf_counter_ns` to the trace's microseconds is the one every
annotation's begin and end allow (`_clock_offset_ns`).

Tallies. `tally()` opens a per-thread count over a block; `note(key, n)`
adds to the open one of its thread, if any (the batcher counts the
plan rebuilds and pageable uploads of a batch's submit this way).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import re
import threading
import time
from typing import List, Optional, Tuple

import torch

_LOCK = threading.Lock()
_log = logging.getLogger("fanlin.profiling")

CAT = "fanlin"
CLOCK_SYNC = "fanlin.clock_sync"
_SYNCS = 3

# The request id the gateway gives each request (server.app's
# trace_middleware); asyncio.to_thread carries it to the codec thread,
# and the micro-batcher stores it beside each entry. None outside a
# request.
REQUEST_ID: contextvars.ContextVar = contextvars.ContextVar(
    "fanlin_request_id", default=None)

# The open capture's span records; None while no capture runs.
_RECORDS: Optional[list] = None
_TLS = threading.local()


class ProfilerBusy(RuntimeError):
    """A capture is already running in this process."""


def on() -> bool:
    """Whether a capture records spans now."""
    return _RECORDS is not None


def record(name: str, t0_ns: int, t1_ns: int, key=None, **args) -> None:
    """A span from two `time.perf_counter_ns` stamps, which may come
    from two threads; written as async events of `key` when given (its
    args gain `rid`), else on this thread. Kept only while a capture
    runs."""
    recs = _RECORDS
    if recs is None:
        return
    if key is not None:
        args["rid"] = key
    recs.append((name, t0_ns, t1_ns, threading.get_native_id(),
                 threading.current_thread().name, key, args))


class _Span:
    __slots__ = ("name", "key", "args", "t0")

    def __init__(self, name, key, args):
        self.name, self.key, self.args = name, key, args

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        record(self.name, self.t0, time.perf_counter_ns(), self.key,
               **self.args)
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, key=None, **args):
    """A context manager recording the block as a span (see `record`);
    a shared no-op object while no capture runs."""
    if _RECORDS is None:
        return _NO_SPAN
    return _Span(name, key, args)


@contextlib.contextmanager
def tally():
    """Count this thread's `note` calls over the block: yields the dict
    of counts."""
    prev = getattr(_TLS, "tally", None)
    counts: dict = {}
    _TLS.tally = counts
    try:
        yield counts
    finally:
        _TLS.tally = prev


def note(key: str, n: int = 1) -> None:
    """Add n to `key` of this thread's open tally, if one is open."""
    counts = getattr(_TLS, "tally", None)
    if counts is not None:
        counts[key] = counts.get(key, 0) + n


def _clock_syncs() -> List[Tuple[int, int, int]]:
    """CLOCK_SYNC annotations, each as (before, inside, after)
    perf_counter_ns reads."""
    out = []
    for _ in range(_SYNCS):
        a = time.perf_counter_ns()
        with torch.profiler.record_function(CLOCK_SYNC):
            b = time.perf_counter_ns()
        out.append((a, b, time.perf_counter_ns()))
    return out


@contextlib.contextmanager
def exclusive(cuda: bool):
    """torch.profiler over the block: host activity of every thread
    (Kineto's `profile_all_threads`: the batcher's device thread launches
    the kernels), and the CUDA device's when `cuda` (a process that must
    not touch CUDA passes False); the port's spans are recorded
    meanwhile (`export` writes both). Raises ProfilerBusy while another
    capture of the port runs, or when this thread is already
    profiling."""
    global _RECORDS
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    if not _LOCK.acquire(blocking=False):
        raise ProfilerBusy("a torch.profiler capture is already running in "
                           "this process")
    try:
        if torch.autograd._profiler_enabled():
            raise ProfilerBusy("this thread is already profiling")
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities,
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            prof.fanlin_syncs = _clock_syncs()
            prof.fanlin_spans = _RECORDS = []
            try:
                yield prof
            finally:
                _RECORDS = None
    finally:
        _LOCK.release()


def prepare(cuda: bool) -> None:
    """Let Kineto initialise here, with an empty capture. It initialises
    at a process's first capture, and only on the thread that imported
    torch: a first capture started from another thread (an aiohttp
    handler's worker thread) records nothing, the card's kernels
    included. Call it from that thread before serving captures; while
    another capture runs, Kineto is up already and it does nothing."""
    try:
        with exclusive(cuda):
            pass
    except ProfilerBusy:
        pass


def _sync_marks(text: str) -> List[Tuple[float, float]]:
    """(ts, dur) in µs of the CLOCK_SYNC annotations of a Chrome trace's
    text, found without parsing the whole of it: each is the object that
    opens at one of the few braces before its name."""
    dec = json.JSONDecoder()
    needle = '"%s"' % CLOCK_SYNC
    out = []
    pos = text.find(needle)
    while pos >= 0:
        start = pos
        for _ in range(3):
            start = text.rfind("{", 0, start)
            if start < 0:
                break
            try:
                ev, _ = dec.raw_decode(text, start)
            except ValueError:
                continue
            if (isinstance(ev, dict) and ev.get("name") == CLOCK_SYNC
                    and "dur" in ev):
                out.append((float(ev["ts"]), float(ev["dur"])))
                break
        pos = text.find(needle, pos + 1)
    return sorted(out)


def _clock_offset_ns(marks: List[Tuple[float, float]],
                     syncs) -> Optional[float]:
    """trace ns − perf_counter_ns from the CLOCK_SYNC annotations' (ts,
    dur) µs in the trace and their reads: the middle of the range that
    every annotation's begin (between its `before` and `inside` reads)
    and end (between `inside` and `after`) allow; the mean of each one's
    own middle if the ranges do not meet. None when the trace lacks
    them."""
    if len(marks) < len(syncs) or not syncs:
        return None
    lo, hi, mids = -float("inf"), float("inf"), []
    for (ts, dur), (a, b, c) in zip(marks, syncs):
        begin, end = ts * 1e3, (ts + dur) * 1e3
        one_lo, one_hi = max(begin - b, end - c), min(begin - a, end - b)
        mids.append((one_lo + one_hi) / 2)
        lo, hi = max(lo, one_lo), min(hi, one_hi)
    return (lo + hi) / 2 if lo <= hi else sum(mids) / len(mids)


def span_events(records, offset_ns: float, pid: int) -> list:
    """Chrome trace events of span records, on the trace's clock."""
    out, names = [], {}
    for name, t0, t1, tid, tname, key, args in records:
        ts = round((t0 + offset_ns) / 1e3, 3)
        dur = round(max(t1 - t0, 0) / 1e3, 3)
        args = dict(args, thread=tname)
        if key is None:
            out.append({"ph": "X", "cat": CAT, "name": name, "pid": pid,
                        "tid": tid, "ts": ts, "dur": dur, "args": args})
        else:
            common = {"cat": CAT, "name": name, "id": key, "pid": pid,
                      "tid": tid}
            out.append(dict(common, ph="b", ts=ts, args=args))
            out.append(dict(common, ph="e", ts=round(ts + dur, 3)))
        names[tid] = tname
    out += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
             "args": {"name": tname}} for tid, tname in names.items()]
    return out


_EVENTS = re.compile(r'"traceEvents"\s*:\s*\[')


def export(prof, path: str) -> None:
    """Write the capture's Chrome trace to `path`, with the spans
    recorded during it (`cat: "fanlin"`) on the trace's clock, put at the
    head of its `traceEvents`. The trace is edited as text, not parsed:
    parsing a camera-sized capture would hold the interpreter's lock for
    seconds while the server serves."""
    prof.export_chrome_trace(path)
    records = getattr(prof, "fanlin_spans", None)
    if not records:
        return
    with open(path) as f:
        text = f.read()
    offset = _clock_offset_ns(_sync_marks(text), prof.fanlin_syncs)
    head = _EVENTS.search(text)
    if offset is None or head is None:
        _log.warning("no %s annotation or no traceEvents in the capture: "
                     "its %d spans are left out", CLOCK_SYNC, len(records))
        return
    at = head.end()
    more = ", ".join(json.dumps(e) for e in span_events(records, offset,
                                                        os.getpid()))
    if not text[at:].lstrip().startswith("]"):
        more += ", "
    with open(path, "w") as f:
        f.write(text[:at])
        f.write(more)
        f.write(text[at:])


def capture_trace(trace_dir: str, seconds: float, cuda: bool) -> str:
    """Profile this process for `seconds` and write the capture into
    `trace_dir` as a Chrome trace, the port's spans in it; returns the
    file's path."""
    os.makedirs(trace_dir, exist_ok=True)
    with exclusive(cuda) as prof:
        time.sleep(seconds)
    path = os.path.join(trace_dir, f"fanlin-{os.getpid()}-"
                                   f"{time.time_ns()}.pt.trace.json")
    export(prof, path)
    return path
