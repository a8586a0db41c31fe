"""Request micro-batcher: concurrent requests become one device batch
per shape group, pipelined on a CUDA stream, with the host mirror as
the failover lane.

Port of fanlin_tpu/engine/batcher.py. HTTP gives one image at a time;
the batcher

* groups each request by `_group_key` (the reference's keys: source and
  output buckets, blur, and for coefficient sources and device encode
  front-ends the exact geometry);
* flushes a group when it reaches ``max_batch`` or when its oldest
  entry has waited ``window_ms`` (one scheduler thread, woken on
  demand), so an idle server adds at most one window of latency;
* lets a request join a flushed batch of its group that the device
  thread has not picked up yet, up to ``max_batch``: while the device
  is busy, a burst fills the batches that wait for it instead of
  queueing one small batch per window (the reference flushes each
  window's group as a batch of its own);
* runs each batch in two halves: the device thread stages it and
  submits it on its own CUDA stream (pinned uploads, kernels, pinned
  downloads, an event), and a collect thread waits on the event and
  hands out the results, while the device thread submits the next
  batch; at most ``pipeline_depth`` batches sit between the halves;
* lets the thread that submits a coefficient image stage its wire
  first (`prestage`), into a pinned slot of its own (a dict copied in,
  or an empty slot the entropy reader writes), so the device thread
  only enqueues that image's upload; the slot is freed with its last
  holder (torch's caching host allocator reuses its block once the
  upload has finished);
* sheds entries whose request was abandoned (the gateway's cancel
  event) or whose deadline passed, before any staging or device work;
* optionally caps each group's queue (``max_queue``), rejecting at
  admission with `BatcherOverload`.

The failover side (`host_fallback`, `device_stall_s`) serves a batch
from the numpy host mirror (`ops.hostexec`), on a small pool of host
threads, only while the card does not answer:

* stall: a watchdog scans the submit timestamps of the batches in
  flight; one past ``device_stall_s`` wedges the batcher. A kernel
  cannot be cancelled, so the stuck collect thread is abandoned (its
  pipeline permit is released once, by whichever side comes first), the
  device and collect threads are replaced by fresh ones (the device
  thread with a fresh CUDA stream), and the stalled batch, the batches
  queued behind it and every batch while wedged go to the mirror;
* recovery: the stuck call returning, or a probe (the stalled batch run
  again on a stream of its own) finishing, clears the wedge; probes that
  hang back off up to `_PROBE_MAX_INTERVAL_S`. A probe that raises ends
  the wedge as well: the card answers, with an error, so batches go back
  to it and fail there.

A device call that raises is not a stall: its batch fails (counted in
`device_errors`, logged at ERROR, answered 500 by the gateway), with or
without `host_fallback`, and never reaches the mirror. So a kernel that
fails to launch, or fails to build (`ops._build.KernelBuildError`),
shows on every batch it touches. A sticky CUDA error (an illegal
address, a failed launch) poisons the context: every later CUDA call of
the process raises, so every batch fails until the process is restarted
(the reference has no restart either). The stall is the one case the
mirror takes, because there the card gives no answer at all, right or
wrong, and the request would otherwise wait out its deadline.

Every mirror-served batch is counted (`host_fallbacks`, and
`device_stalls` for the stall), logged at WARNING, and its futures carry
the mirror flag (`BatchingRunner.consume_host_mirror_flag`), which the
gateway answers with `X-Cache-Warmth: cold` and `Cache-Control:
no-store`. What never reaches the mirror: a device call that raised,
warmup batches (`warm_batch`), and anything before the batcher exists:
its kernels are built when it is made, outside any watched call, and the
port without CUDA refuses to start, so there is no boot-time wedge. The
reference's cold-compile lane (a bucket served from the mirror while
its XLA program compiles) has no counterpart: nothing compiles per
shape on the card. Nor have its soft-degrade (a device priced slower
than the mirror) and queue-pressure spillover (`tpu.spill_wait_ms`,
accepted and inert): no measured load on the card has a batch that the
mirror finishes sooner than the card would.

Every phase of a served batch is timed with one pair of clock reads,
added to a counter of `stats` and, while a `GET /profile` capture runs,
recorded as a span (`utils.profiling`) that names the batch (`batch`,
its images `n`, the request ids it serves `rids`) and this thread's CPU
time over it (`cpu_ms`: wall time far above it is a wait for the GIL or
a lock):

* `fanlin.batcher.queue`, per entry, from `submit` to the device thread
  taking its batch (`queue_wait_ms_total`, per image);
* `fanlin.assembly.prestage`, per image, on the codec thread before it
  submits: a coefficient image's wire staged into its own pinned slot
  (`prestage`; counted in `prestaged` when its batch is taken);
* on the device thread `fanlin.batcher.stage` (`fused.make_assembly`),
  `.permit_wait` (a pipeline permit) and `.submit` (`asm.submit()`,
  with its plan rebuilds and pageable uploads, `pageable_bytes`,
  `pageable_uploads`, `plan_rebuilds`), each `<phase>_ms_total`;
* on the collect thread `fanlin.batcher.device_wait`, the wait for the
  batch's event (`device_wait_ms_total` counts it from the hand-over to
  the collect thread; the span starts when the collect thread takes the
  batch, its `queued_ms` the time before), and `.unpack`, the rest of
  the collect (`unpack_ms_total`);
* `fanlin.batcher.handoff`, per image, from its future resolved to
  `BatchingRunner.run` holding the result (`handoff_ms_total`).

Warm and mirror batches get the same spans, with `warm` / `mirror`
args, and count in none of these counters.

The port defines its own contextvars and exceptions: it imports
nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import logging
import os
import threading
import time
from concurrent.futures import Future, InvalidStateError, ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops import fused
from ..ops import _build
from ..ops.plan import ImagePlan, bucket_h, bucket_w
from ..utils import profiling
from . import jpeg_coeffs

_logger = logging.getLogger("fanlin.batcher")

_CPU = torch.device("cpu")

# How long close() waits for the threads to drain when the stall
# watchdog is off.
_CLOSE_BUDGET_S = 60.0

# Recovery-probe backoff ceiling while a wedge persists: a probe that
# hangs abandons a thread stuck in a device call, so a long outage must
# not probe at the stall cadence forever.
_PROBE_MAX_INTERVAL_S = 300.0

# Absolute time.monotonic() deadline of the current request, set by the
# gateway's timeout middleware and carried into the engine's worker
# thread by asyncio.to_thread's context copy. None = no deadline.
REQUEST_DEADLINE: contextvars.ContextVar = contextvars.ContextVar(
    "fanlin_request_deadline", default=None
)

# threading.Event the gateway sets when it stops waiting for the
# request (408 or client disconnect): a queued entry carrying a set
# event is cancelled at dispatch and never staged.
REQUEST_CANCEL: contextvars.ContextVar = contextvars.ContextVar(
    "fanlin_request_cancel", default=None
)


class BatcherOverload(RuntimeError):
    """A group's pending queue exceeded max_queue — shed at admission."""


class RequestExpired(Exception):
    """Entry dropped because its request deadline passed before device
    dispatch; the gateway answers 408."""


class DeviceStalled(RuntimeError):
    """A warm batch that the stall watchdog gave up on, or that a wedge
    cancelled before it ran: warmup batches are never mirror-served."""


def _safe_result(fut: Future, result, mirror: bool = False,
                 t_ns: int = None, batch: int = None) -> None:
    """set_result tolerant of a future resolved (or cancelled)
    elsewhere: after a stall the batch is mirror-served while the stuck
    device call may still complete; whichever side comes second is
    dropped. mirror: mark the future as served by the host mirror.
    t_ns, batch: the perf_counter_ns stamp of the resolve and the batch
    id, carried on the future for the hand-back's span."""
    if fut.cancelled():
        return
    try:
        if mirror:
            fut.fanlin_host_mirror = True
        if t_ns is not None:
            fut.fanlin_resolved = (t_ns, batch)
        fut.set_result(result)
    except InvalidStateError:
        pass


def _safe_fail(fut: Future, exc: BaseException) -> None:
    if fut.cancelled():
        return
    try:
        fut.set_exception(exc)
    except InvalidStateError:
        pass


class _PermitOnce:
    """Exactly-once release of one pipeline permit: the watchdog frees
    a stalled batch's permit when it fails the batch over, and the stuck
    collect's own release, if it ever returns, is then a no-op
    (BoundedSemaphore raises on over-release)."""

    __slots__ = ("_sem", "_done", "_lock")

    def __init__(self, sem):
        self._sem = sem
        self._done = False
        self._lock = threading.Lock()

    def release(self) -> None:
        with self._lock:
            if self._done:
                return
            self._done = True
        self._sem.release()


class _BatchTag:
    """A batch as its spans name it: its id, the request ids of its
    entries, its kind of run (`warm` / `mirror` args), and when the
    device thread handed it to the collect thread (perf_counter_ns)."""

    __slots__ = ("id", "rids", "n", "flags", "t_handed")

    def __init__(self, bid: int, rids: list, n: int, **flags):
        self.id, self.rids, self.n, self.flags = bid, rids, n, flags
        self.t_handed = None


class _Watch:
    """One device call in flight, as the stall watchdog sees it. It
    holds the assembly (and so its pinned buffers) until both the
    abandoned call and the mirror are done with it."""

    __slots__ = ("t0", "token", "asm", "futures", "stale", "releaser",
                 "warm")

    def __init__(self, token, asm, futures, releaser, warm):
        self.t0 = time.monotonic()
        self.token = token
        self.asm = asm
        self.futures = futures
        self.stale = False
        self.releaser = releaser
        self.warm = warm


def _load_kernels(device: torch.device) -> None:
    """Build and load the CUDA kernel library now (a no-op on the CPU),
    before any device call is watched: a build that takes longer than
    the stall bound, or fails, must never look like a stalled device
    and send batches to the mirror. A failed build raises
    KernelBuildError here, and the server does not start."""
    if device.type == "cuda":
        _build.load()


def _group_key(plan: ImagePlan, kind: str) -> Tuple:
    """The batch a request may share (fanlin_tpu/engine/batcher.py
    :194-239, the same tuples for the same inputs)."""
    if kind.startswith(("coef", "cmyk")):
        # coefficient sources key on the EXACT source geometry (the
        # chroma upsample's edges are positional); pixel-out batches by
        # output bucket, device-encoded ones by exact output dims
        sink = kind.split("+", 1)[1] if "+" in kind else "rgb"
        if sink == "rgb":
            out_key = (bucket_h(plan.out_h), bucket_w(plan.out_w))
        else:
            out_key = (plan.out_h, plan.out_w)
        return (kind, plan.src_h, plan.src_w) + out_key + (
            plan.blur_sigma > 0,
        )
    if kind.startswith("jpegdct:"):
        return (kind, bucket_h(plan.src_h), bucket_w(plan.src_w),
                plan.out_h, plan.out_w, plan.blur_sigma > 0)
    if kind in ("jpeg420", "webp420") or kind.startswith("png:"):
        # the device encode front-ends crop at one true geometry
        return (kind, bucket_h(plan.src_h), bucket_w(plan.src_w),
                plan.out_h, plan.out_w, plan.blur_sigma > 0)
    return ("rgb", bucket_h(plan.src_h), bucket_w(plan.src_w),
            bucket_h(plan.out_h), bucket_w(plan.out_w), plan.blur_sigma > 0)


class MicroBatcher:
    """Shape-grouped batching queue with adaptive flush, feeding one
    device through a two-stage (submit / collect) pipeline, with the
    host mirror as the failover lane."""

    def __init__(self, max_batch: int, window_ms: float,
                 device: torch.device, pipeline_depth: int = 2,
                 max_queue: int = 0, fast: bool = False,
                 host_fallback: bool = False, device_stall_s: float = 30.0):
        """device: where batches run. pipeline_depth: batches allowed
        between submit and collect. max_queue: per-group cap on admitted
        entries not yet picked up by the device thread (0 = unlimited).
        fast: every batch's resample products in bf16 (`tpu.fast`), the
        warmup's too.

        host_fallback: arm the failover lane (`tpu.host_fallback`);
        without it nothing is watched and a stalled batch waits for the
        device. device_stall_s: a device call in flight longer than this
        wedges the batcher (0 = no watchdog). A device call that raises
        fails its batch either way.

        Builds the kernels first (`_load_kernels`): raises
        KernelBuildError when they do not build."""
        _load_kernels(device)
        self.device = device
        self.fast = bool(fast)
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.max_queue = max_queue
        self._host_fallback = bool(host_fallback)
        self.device_stall_s = max(float(device_stall_s), 0.0)
        self._armed = self._host_fallback and self.device_stall_s > 0
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        # key -> (flush deadline, [(plan, image, future, kind,
        #         req_deadline, cancel_ev, t_submitted_ns, request_id)])
        self._groups: Dict[Tuple, Tuple[float, list]] = {}
        # key -> entries admitted but not yet picked up by the device
        # thread (the backlog max_queue bounds)
        self._backlog: Dict[Tuple, int] = {}
        # key -> a flushed batch, not full, that the device thread has
        # not picked up yet: new entries of the group join it
        self._queued: Dict[Tuple, list] = {}
        # each device thread's CUDA stream
        self._tls = threading.local()
        self._device = self._new_device_executor()
        self._collector = ThreadPoolExecutor(
            1, thread_name_prefix="fanlin-collect")
        # the mirror lane: hostexec is per-assembly numpy, so batches run
        # side by side (capped: each holds full f32 intermediates)
        self._host = ThreadPoolExecutor(
            max(1, min(4, os.cpu_count() or 1)),
            thread_name_prefix="fanlin-hostexec")
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self._inflight = threading.BoundedSemaphore(self.pipeline_depth)
        self._closed = False
        # failover state, guarded by self._lock
        self._wedged = False
        self._watch: Dict[int, _Watch] = {}
        self._watch_token = 0
        self._probe_asm = None  # the last stalled batch, run as the probe
        self._probing = False
        self._last_probe = 0.0
        self._probe_interval = max(self.device_stall_s, 2.0)
        self._probe_threads = 0
        # tasks queued on the device executor and not started: a wedge
        # cancels them and hands them on (their thread is stuck)
        self._pending_device: Dict[int, tuple] = {}
        self._pending_token = 0
        # executors replaced by past wedges; close() joins them
        self._abandoned: list = []
        # batch ids of the spans, warm and mirror batches included
        self._batch_ids = itertools.count(1)
        # observability counters (the gateway's /stats)
        self.stats = {"batches": 0, "images": 0,
                      # images whose wire a codec thread staged
                      # (`prestage`); the rest the device thread stages
                      "prestaged": 0,
                      "full_flushes": 0,
                      "timer_flushes": 0, "queued_joins": 0,
                      "shed_expired": 0,
                      "shed_cancelled": 0, "rejected_overload": 0,
                      "pipeline_depth": self.pipeline_depth,
                      # host->device bytes of the batches' wires
                      # (pixels, or coefficient blocks and tables)
                      "upload_bytes": 0,
                      # queued entries across groups (gauge), and the
                      # submit->dispatch wait of dispatched entries
                      # (cumulative ms; mean = total / images)
                      "backlog": 0,
                      "queue_wait_ms_total": 0.0,
                      # the phases of the served batches on the card,
                      # cumulative ms (module docstring; per batch =
                      # total / batches, handoff's per image)
                      "stage_ms_total": 0.0,
                      "permit_wait_ms_total": 0.0,
                      "submit_ms_total": 0.0,
                      "device_wait_ms_total": 0.0,
                      "unpack_ms_total": 0.0,
                      "handoff_ms_total": 0.0,
                      # what their submits did on the host besides
                      # launching: pageable uploads of shared matrices
                      # (`fused._device_cached` misses) and rebuilds of
                      # the padded plan matrices (`plan._uniform_entry`,
                      # `_folded_padded` misses)
                      "pageable_bytes": 0,
                      "pageable_uploads": 0,
                      "plan_rebuilds": 0,
                      # startup batches run by engine.warmup
                      "warm_batches": 0,
                      # batches served by the host mirror (a stalled
                      # batch, and every batch while wedged)
                      "host_fallbacks": 0,
                      # device calls past device_stall_s (watchdog, or
                      # pipeline permits held past it)
                      "device_stalls": 0,
                      # served batches whose device call raised: failed,
                      # never mirror-served
                      "device_errors": 0,
                      # 0/1 gauge: the device is wedged, every batch
                      # rides the mirror
                      "device_wedged": 0,
                      # abandoned recovery probes still in a device call
                      "probe_threads": 0}
        self._scheduler = threading.Thread(
            target=self._flush_loop, name="fanlin-batch-flush", daemon=True)
        self._scheduler.start()
        if self._armed:
            threading.Thread(target=self._stall_watchdog,
                             name="fanlin-stallwatch", daemon=True).start()

    def _new_device_executor(self) -> ThreadPoolExecutor:
        return ThreadPoolExecutor(1, thread_name_prefix="fanlin-device",
                                  initializer=self._init_device_thread)

    def _init_device_thread(self) -> None:
        """The device thread's own device and CUDA stream (a thread that
        replaces a stuck one gets a stream of its own)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            self._tls.stream = torch.cuda.Stream(self.device)

    def _on_stream(self):
        stream = getattr(self._tls, "stream", None)
        if stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(stream)

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    # -- gauges ------------------------------------------------------------

    def device_available(self) -> bool:
        """False while the device is wedged: the engine then feeds pixel
        sources and converts CMYK pixels on the host. (The reference has
        a second gauge, prefer_pixel_source, that also steers to pixels
        after a streak of coefficient batches mirrored without a wedge;
        here a batch reaches the mirror only while wedged.)"""
        with self._lock:
            return not self._wedged

    # -- submission --------------------------------------------------------

    def prestage(self, meta):
        """Stage a coefficient image's wire into a pinned slot of its own
        on the calling thread (a codec thread, before it submits the
        image): a meta's grids and tables copied in, or, given a
        `jpeg_coeffs.Header`, the empty slot of its geometry that the
        reader then writes (`jpeg_coeffs.read_into_slot`). Returns the
        `fused.WireSlot` to submit in the meta's place, or what it was
        given when no pinned memory is to be had (the device thread then
        stages a meta). While a capture runs, a staged image is the span
        `fanlin.assembly.prestage` of its request."""
        t0 = time.perf_counter_ns()
        pinned = self.device.type == "cuda"
        try:
            if isinstance(meta, jpeg_coeffs.Header):
                slot = fused.WireSlot.empty(meta.h, meta.w, meta.subsamp,
                                            meta.grids, pinned)
            else:
                slot = fused.WireSlot(meta, pinned)
        except RuntimeError:  # no pinned memory to be had
            return meta
        if profiling.on():
            profiling.record("fanlin.assembly.prestage", t0,
                             time.perf_counter_ns(),
                             profiling.REQUEST_ID.get(), bytes=slot.nbytes)
        return slot

    def submit(self, plan: ImagePlan, image, kind: str = "rgb") -> Future:
        """Queue one image (pixels, or a coefficient dict or its
        `prestage` slot for coef* and cmyk* kinds); the future resolves
        to its result."""
        key = _group_key(plan, kind)
        fut: Future = Future()
        req_deadline = REQUEST_DEADLINE.get()
        cancel_ev = REQUEST_CANCEL.get()
        flush_now = None
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher closed")
            if self.max_queue and self._backlog.get(key, 0) >= self.max_queue:
                # rejected before a group is registered, so no empty
                # group is left for the scheduler
                self.stats["rejected_overload"] += 1
                raise BatcherOverload(
                    f"group backlog over {self.max_queue} pending entries")
            self._backlog[key] = self._backlog.get(key, 0) + 1
            self.stats["backlog"] += 1
            item = (plan, image, fut, kind, req_deadline, cancel_ev,
                    time.perf_counter_ns(), profiling.REQUEST_ID.get())
            queued = self._queued.get(key)
            if queued is not None:
                queued.append(item)
                self.stats["queued_joins"] += 1
                if len(queued) >= self.max_batch:
                    del self._queued[key]
                return fut
            entry = self._groups.get(key)
            if entry is None:
                entry = (time.monotonic() + self.window_s, [])
                self._groups[key] = entry
                self._wake.notify()  # a new deadline for the scheduler
            entry[1].append(item)
            if len(entry[1]) >= self.max_batch:
                flush_now = self._groups.pop(key)[1]
                self.stats["full_flushes"] += 1
        if flush_now is not None:
            self._dispatch(flush_now)
        return fut

    def _dispatch(self, group) -> None:
        """Queue a batch on its lane: the mirror while wedged, else the
        device thread, tracked until it starts so that a wedge declared
        meanwhile hands it to the mirror (the stuck thread would never
        run it)."""
        with self._lock:
            wedged = self._wedged
            if not wedged:
                self._pending_token += 1
                tok = self._pending_token
                dev = self._device
        if wedged:
            self._submit_host(group, "device wedged")
            return
        try:
            fut = dev.submit(self._run_batch, group)
        except RuntimeError as e:
            # the executor is shut down: close(), or a wedge between the
            # check and the submit (then the mirror takes the batch)
            with self._lock:
                wedged = self._wedged
            if wedged:
                self._submit_host(group, "device wedged")
                return
            with self._lock:
                self._claim(group)
            for entry in group:
                _safe_fail(entry[2], e)
            return
        self._track(tok, dev, fut,
                    lambda: self._submit_host(group, "device wedged"))

    def _track(self, tok: int, dev, fut, on_wedge) -> None:
        """Record a device-executor task until it starts; `on_wedge`
        takes it over if a wedge cancels it."""
        with self._lock:
            raced = self._wedged and dev is not self._device
            if not raced:
                self._pending_device[tok] = (fut, on_wedge)
        if raced:
            # wedged between the check and the submit: the task sits on
            # the quarantined executor's queue
            if fut.cancel():
                on_wedge()
            return
        fut.add_done_callback(
            lambda _f, tok=tok: self._pending_device.pop(tok, None))

    def _claim(self, group) -> None:
        """Close `group` to new entries (a lane takes it, or it failed).
        Called with the lock held."""
        key = _group_key(group[0][0], group[0][3])
        if self._queued.get(key) is group:
            del self._queued[key]

    def _take(self, group) -> None:
        """A lane picks `group` up: no entry joins it from here on, and
        its entries leave the backlog."""
        key0 = _group_key(group[0][0], group[0][3])
        with self._lock:
            self._claim(group)
            left = self._backlog.get(key0, 0) - len(group)
            if left > 0:
                self._backlog[key0] = left
            else:
                self._backlog.pop(key0, None)
            self.stats["backlog"] = max(self.stats["backlog"] - len(group), 0)

    def _flush_loop(self) -> None:
        """Single scheduler: sleep until the earliest group deadline,
        flush everything past due."""
        while True:
            due = []
            with self._lock:
                if self._closed:
                    return
                now = time.monotonic()
                next_deadline = None
                for key in list(self._groups):
                    deadline, _ = self._groups[key]
                    if deadline <= now:
                        group = self._groups.pop(key)[1]
                        due.append(group)
                        if len(group) < self.max_batch:
                            self._queued[key] = group
                    elif next_deadline is None or deadline < next_deadline:
                        next_deadline = deadline
                self.stats["timer_flushes"] += len(due)
                if not due:
                    self._wake.wait(timeout=None if next_deadline is None
                                    else max(next_deadline - now, 0.0))
            for group in due:
                self._dispatch(group)

    def warm_batch(self, plans, payloads, kinds) -> Future:
        """Run one batch on the device thread, on its stream, outside
        the counters of served traffic (engine.warmup): it loads the
        kernels' modules and grows the pinned staging pool as a served
        batch of that kind would. The future resolves to the batch's
        results. A warm batch never reaches the mirror: one that raises
        fails its future, one that stalls (or that a wedge cancels)
        fails it with DeviceStalled. Raises RuntimeError once the
        batcher is closed."""
        wf: Future = Future()

        def run():
            watch = None
            tag = _BatchTag(next(self._batch_ids), [], len(plans), warm=True)
            try:
                t0, c0 = time.perf_counter_ns(), time.thread_time_ns()
                asm = fused.make_assembly(plans, payloads, kinds,
                                          self.device, fast=self.fast)
                t1, c1 = time.perf_counter_ns(), time.thread_time_ns()
                self._phase("stage", tag, t0, t1, c0, c1, counted=False)
                if self._armed:
                    watch = self._watch_add(asm, [wf], None, warm=True)
                with self._on_stream():
                    out = asm.submit()
                t2, c2 = time.perf_counter_ns(), time.thread_time_ns()
                self._phase("submit", tag, t1, t2, c1, c2, counted=False)
                asm.wait()
                t3, c3 = time.perf_counter_ns(), time.thread_time_ns()
                self._phase("device_wait", tag, t2, t3, c2, c3,
                            counted=False)
                results = asm.collect(out)
                self._phase("unpack", tag, t3, time.perf_counter_ns(), c3,
                            time.thread_time_ns(), counted=False)
            except BaseException as e:
                if watch is not None:
                    self._watch_done(watch, roundtrip_ok=False)
                _safe_fail(wf, e)
                if not isinstance(e, Exception):
                    raise
                return
            if watch is not None:
                self._watch_done(watch, roundtrip_ok=True)
            with self._lock:
                self.stats["warm_batches"] += 1
            _safe_result(wf, results)

        with self._lock:
            if self._wedged:
                wf.set_exception(DeviceStalled("device wedged: warmup "
                                               "batch not run"))
                return wf
            self._pending_token += 1
            tok = self._pending_token
            dev = self._device
        try:
            fut = dev.submit(run)
        except RuntimeError as e:
            _safe_fail(wf, e)
            raise
        self._track(tok, dev, fut, lambda: _safe_fail(wf, DeviceStalled(
            "device wedged before the warmup batch ran")))
        return wf

    # -- device-stall failover ----------------------------------------------

    def _declare_wedged(self, probe_asm=None) -> None:
        """Mark the device wedged and quarantine the device-side
        executors: each has one thread, and a wedge means it is stuck in
        a device call, so tasks queued behind it would never start.
        Fresh executors (a fresh CUDA stream on the device thread) serve
        once recovery is signalled; tasks still queued on the old device
        executor are handed over here; close() joins the old ones within
        its budget. Caller must NOT hold self._lock."""
        with self._lock:
            if probe_asm is not None:
                self._probe_asm = probe_asm
            pending, old = [], []
            if not self._wedged:
                self._wedged = True
                self.stats["device_wedged"] = 1
                # a fresh outage probes fast again; only consecutive
                # hung probes within one wedge back the interval off
                self._probe_interval = max(self.device_stall_s, 2.0)
                old = [self._device, self._collector]
                self._abandoned += old
                self._device = self._new_device_executor()
                self._collector = ThreadPoolExecutor(
                    1, thread_name_prefix="fanlin-collect")
                pending = list(self._pending_device.values())
                self._pending_device.clear()
        for fut, on_wedge in pending:
            if fut.cancel():
                on_wedge()
        for ex in old:
            # the worker exits when its stuck call returns, instead of
            # idling forever
            ex.shutdown(wait=False)

    def _watch_add(self, asm, futures, releaser, warm: bool = False) -> _Watch:
        with self._lock:
            self._watch_token += 1
            watch = _Watch(self._watch_token, asm, futures, releaser, warm)
            self._watch[watch.token] = watch
        return watch

    def _mark_recovered_locked(self) -> bool:
        """Clear the wedge; caller holds self._lock. True when this call
        cleared it (the caller logs, outside the lock)."""
        if not self._wedged:
            return False
        self._wedged = False
        self.stats["device_wedged"] = 0
        self._probe_interval = max(self.device_stall_s, 2.0)
        return True

    def _watch_done(self, watch: _Watch, roundtrip_ok: bool) -> None:
        """Unregister a device call; a completed round trip while wedged
        means the device came back."""
        with self._lock:
            self._watch.pop(watch.token, None)
            recovered = roundtrip_ok and self._mark_recovered_locked()
        if recovered:
            _logger.warning("device recovered after a stall; serving from "
                            "the device")

    def _stall_watchdog(self) -> None:
        """Scan the device calls in flight: one past device_stall_s
        (counted from its submit) wedges the batcher and its batch is
        served from the mirror; while wedged, one bounded probe runs
        per probe interval. The stuck call itself cannot be interrupted:
        its return is a recovery signal (_watch_done)."""
        period = min(self.device_stall_s / 4.0, 1.0)
        while True:
            time.sleep(period)
            stale = []
            with self._lock:
                if self._closed:
                    return
                now = time.monotonic()
                for watch in self._watch.values():
                    if watch.stale or now - watch.t0 < self.device_stall_s:
                        continue
                    watch.stale = True
                    stale.append(watch)
                    self.stats["device_stalls"] += 1
            if stale:
                self._declare_wedged(probe_asm=stale[-1].asm)
            probe = None
            with self._lock:
                if (self._wedged and not self._probing
                        and self._probe_asm is not None
                        and now - self._last_probe >= self._probe_interval):
                    self._probing = True
                    self._last_probe = now
                    probe = self._probe_asm
            if probe is not None:
                threading.Thread(target=self._probe_device, args=(probe,),
                                 name="fanlin-deviceprobe",
                                 daemon=True).start()
            for watch in stale:
                _logger.error(
                    "device call stalled > %.1f s (%s batch of %d); "
                    "serving from the host mirror until the device "
                    "answers again", self.device_stall_s,
                    "warmup" if watch.warm else "served",
                    len(watch.asm.plans))
                if watch.warm:
                    for f in watch.futures:
                        _safe_fail(f, DeviceStalled(
                            f"warmup batch stalled > {self.device_stall_s} s"))
                    continue
                # the stuck call holds a pipeline permit: free it for the
                # fresh pipeline (its own release becomes a no-op)
                watch.releaser.release()
                with self._lock:
                    self.stats["host_fallbacks"] += 1
                self._mirror_async(watch.asm, watch.futures, "device stall")

    def _probe_run(self, asm) -> None:
        """The probe's device work: the stalled batch run again, on a
        stream of its own, from its staged host arrays."""
        twin = asm.replica()
        if self.device.type != "cuda":
            twin.run()
            return
        torch.cuda.set_device(self.device)
        with torch.cuda.stream(torch.cuda.Stream(self.device)):
            twin.run()

    def _probe_device(self, asm) -> None:
        """One bounded recovery attempt. The device call runs on a daemon
        thread of its own; if it hangs past the stall budget it is
        abandoned, but it still clears the wedge if it ever completes.
        Consecutive hung probes back the interval off up to
        _PROBE_MAX_INTERVAL_S. A probe that raises clears the wedge too:
        the device answered, so the mirror stops serving and batches go
        back to the device, where the error (a sticky CUDA error, a
        kernel that fails to launch) fails them, counted and logged."""
        done = threading.Event()

        def _run():
            err = None
            try:
                self._probe_run(asm)
            except Exception as e:
                err = e
            finally:
                with self._lock:
                    self._probe_threads -= 1
                    self.stats["probe_threads"] = self._probe_threads
                    recovered = self._mark_recovered_locked()
                done.set()
            if err is not None:
                _logger.error("device recovery probe raised (%s): the "
                              "device answers, so the host mirror stops "
                              "serving and batches go back to it", err)
            elif recovered:
                _logger.warning("device probe succeeded; serving from the "
                                "device")

        with self._lock:
            self._probe_threads += 1
            self.stats["probe_threads"] = self._probe_threads
        threading.Thread(target=_run, name="fanlin-deviceprobe-run",
                         daemon=True).start()
        budget = max(self.device_stall_s, 2.0)
        finished = done.wait(budget)
        with self._lock:
            self._probing = False
            if not finished:
                self._probe_interval = min(self._probe_interval * 2.0,
                                           _PROBE_MAX_INTERVAL_S)
                nxt = self._probe_interval
        if not finished:
            _logger.error("device recovery probe not answering after %.0f s; "
                          "abandoned (it still clears the wedge if it "
                          "completes), next probe in %.0f s", budget, nxt)

    # -- the lanes ----------------------------------------------------------

    def _live_entries(self, group) -> list:
        """Drop entries whose request is dead: cancel the future when
        the gateway's cancel event fired, fail it when its deadline
        passed. Neither pays staging or device time."""
        now = time.monotonic()
        live = []
        cancelled = expired = 0
        for entry in group:
            fut, req_deadline, cancel_ev = entry[2], entry[4], entry[5]
            if fut.cancelled():
                continue
            if cancel_ev is not None and cancel_ev.is_set():
                cancelled += 1
                fut.cancel()
                continue
            if req_deadline is not None and req_deadline <= now:
                expired += 1
                _safe_fail(fut, RequestExpired(
                    "request deadline passed before device dispatch"))
                continue
            live.append(entry)
        if cancelled or expired:
            with self._lock:
                self.stats["shed_cancelled"] += cancelled
                self.stats["shed_expired"] += expired
        return live

    def _count_batch(self, group) -> Tuple[_BatchTag, int]:
        """Count a dispatched batch and its entries' queue wait. Returns
        the batch's tag and the perf_counter_ns stamp at which it was
        taken, where its entries' `fanlin.batcher.queue` spans end."""
        now = time.perf_counter_ns()
        tag = _BatchTag(next(self._batch_ids), [g[7] for g in group],
                        len(group))
        prestaged = sum(isinstance(g[1], fused.WireSlot) for g in group)
        with self._lock:
            self.stats["batches"] += 1
            self.stats["images"] += len(group)
            self.stats["prestaged"] += prestaged
            self.stats["queue_wait_ms_total"] += sum(
                now - g[6] for g in group) / 1e6
        if profiling.on():
            for g in group:
                profiling.record("fanlin.batcher.queue", g[6], now, g[7],
                                 batch=tag.id)
        return tag, now

    def _phase(self, name: str, tag: _BatchTag, t0: int, t1: int, c0: int,
               c1: int, counted: bool = True, **extra) -> None:
        """One phase of a batch on this thread, from t0 to t1
        (perf_counter_ns), its CPU time c0 to c1 (thread_time_ns). When
        `counted`, its ms are added to stats[name + "_ms_total"] and each
        of `extra` to its own counter; while a capture runs it is the
        span `fanlin.batcher.<name>`, `extra` among its args."""
        if counted:
            with self._lock:
                self.stats[name + "_ms_total"] += (t1 - t0) / 1e6
                for k, v in extra.items():
                    self.stats[k] += v
        if profiling.on():
            args = dict(tag.flags, **extra)
            profiling.record("fanlin.batcher." + name, t0, t1, batch=tag.id,
                             n=tag.n, rids=tag.rids, cpu_ms=(c1 - c0) / 1e6,
                             **args)

    def note_handoff(self, fut: Future, t_ns: int) -> None:
        """The result of `fut` reached its caller at `t_ns`: the time
        since the future was resolved is added to `handoff_ms_total`
        and is the caller's `fanlin.batcher.handoff` span. A future
        resolved without a stamp (failed, cancelled) is skipped."""
        stamp = getattr(fut, "fanlin_resolved", None)
        if stamp is None:
            return
        t0, bid = stamp
        with self._lock:
            self.stats["handoff_ms_total"] += (t_ns - t0) / 1e6
        if profiling.on():
            profiling.record("fanlin.batcher.handoff", t0, t_ns,
                             profiling.REQUEST_ID.get(), batch=bid)

    def _make_host_assembly(self, group, tag: _BatchTag):
        """The batch staged for the mirror alone: on the CPU, so the
        mirror lane never calls into CUDA (no pinned allocation on a
        card that may be failing): the entries' slots are read as they
        are, a dict is staged into an unpinned one."""
        t0, c0 = time.perf_counter_ns(), time.thread_time_ns()
        asm = fused.make_assembly([g[0] for g in group],
                                  [g[1] for g in group],
                                  [g[3] for g in group], _CPU,
                                  fast=self.fast)
        asm.fanlin_batch = tag
        self._phase("stage", tag, t0, time.perf_counter_ns(), c0,
                    time.thread_time_ns(), counted=False, mirror=True)
        return asm

    def _submit_host(self, group, reason: str) -> None:
        """Mirror-lane submit that cannot kill its caller: if the host
        executor is shut down too (close), fail the group's futures."""
        try:
            self._host.submit(self._run_host_batch, group, reason)
        except RuntimeError:
            with self._lock:
                self._claim(group)
            for entry in group:
                _safe_fail(entry[2], RuntimeError("batcher closed"))

    def _run_host_batch(self, group, reason: str) -> None:
        """A batch routed straight to the mirror (the device wedged), on
        the host pool."""
        self._take(group)
        futures = [g[2] for g in group]
        try:
            group = self._live_entries(group)
            if not group:
                return
            tag, _ = self._count_batch(group)
            futures = [g[2] for g in group]
            asm = self._make_host_assembly(group, tag)
        except Exception as e:
            for f in futures:
                _safe_fail(f, e)
            return
        with self._lock:
            self.stats["host_fallbacks"] += 1
        self._run_host(asm, futures, reason)

    def _mirror_async(self, asm, futures, reason: str) -> None:
        """Serve an assembled batch from the mirror on the host pool,
        never inline on the device thread (that would serialize the
        mirror on one core and stall the device lane); inline only if
        the pool is shut down (close), so futures never strand."""
        try:
            self._host.submit(self._run_host, asm, futures, reason)
        except RuntimeError:
            self._run_host(asm, futures, reason)

    def _run_host(self, asm, futures, reason: str) -> None:
        from ..ops import hostexec

        _logger.warning("host mirror serving a batch of %d (%s)",
                        len(asm.plans), reason)
        t0, c0 = time.perf_counter_ns(), time.thread_time_ns()
        try:
            results = hostexec.run_host(asm)
        except Exception as e:
            for f in futures:
                _safe_fail(f, e)
            return
        t1, c1 = time.perf_counter_ns(), time.thread_time_ns()
        tag = getattr(asm, "fanlin_batch", None)
        for f, r in zip(futures, results):
            _safe_result(f, r, mirror=True, t_ns=t1,
                         batch=tag.id if tag is not None else None)
        if tag is not None:
            # the mirror's run stands in for the card's
            self._phase("device_wait", tag, t0, t1, c0, c1, counted=False,
                        mirror=True)

    def _device_failed(self, exc: Exception, futures, where: str) -> None:
        """A device call of a served batch raised: fail its futures,
        count it and log it. Never mirror-served: a kernel that fails to
        launch or to build must show, not hide behind the host."""
        with self._lock:
            self.stats["device_errors"] += 1
        _logger.error("device %s failed (%s): failing a batch of %d", where,
                      exc, len(futures))
        for f in futures:
            _safe_fail(f, exc)

    def _run_batch(self, group) -> None:
        """Submit half, on the device thread: stage the batch, submit
        it on the thread's stream and hand it to the collect thread; or,
        while the device is wedged, hand it to the mirror."""
        self._take(group)
        futures = [g[2] for g in group]
        asm = releaser = watch = None
        try:
            group = self._live_entries(group)
            if not group:
                return
            tag, t0 = self._count_batch(group)
            c0 = time.thread_time_ns()
            futures = [g[2] for g in group]
            with self._lock:
                wedged = self._wedged
                if wedged:
                    self.stats["host_fallbacks"] += 1
            if wedged:
                self._mirror_async(self._make_host_assembly(group, tag),
                                   futures, "device wedged")
                return
            asm = fused.make_assembly([g[0] for g in group],
                                      [g[1] for g in group],
                                      [g[3] for g in group], self.device,
                                      fast=self.fast)
            asm.fanlin_batch = tag
            t1, c1 = time.perf_counter_ns(), time.thread_time_ns()
            self._phase("stage", tag, t0, t1, c0, c1)
            # bound submit-ahead to the pipeline depth; permits held by
            # stuck collects must not block the device thread forever
            permitted = self._inflight.acquire(
                timeout=self.device_stall_s if self._armed else None)
            t2, c2 = time.perf_counter_ns(), time.thread_time_ns()
            self._phase("permit_wait", tag, t1, t2, c1, c2)
            if not permitted:
                with self._lock:
                    self.stats["device_stalls"] += 1
                    self.stats["host_fallbacks"] += 1
                self._declare_wedged(probe_asm=asm)
                _logger.error("pipeline permits held > %.1f s (collects not "
                              "returning); serving from the host mirror",
                              self.device_stall_s)
                self._mirror_async(asm, futures, "device stall")
                return
            releaser = _PermitOnce(self._inflight)
            if self._armed:
                watch = self._watch_add(asm, futures, releaser)
            with self._on_stream(), profiling.tally() as counts:
                out = asm.submit()
            t3 = time.perf_counter_ns()
            self._phase("submit", tag, t2, t3, c2, time.thread_time_ns(),
                        upload_bytes=asm.upload_bytes, **counts)
            tag.t_handed = t3
            self._collector.submit(self._collect_batch, asm, out, futures,
                                   watch, releaser)
        except BaseException as e:
            # idempotent: a raising collector.submit (a wedge's
            # quarantine) reaches here holding both
            if watch is not None:
                self._watch_done(watch, roundtrip_ok=False)
            if releaser is not None:
                releaser.release()
            if watch is not None and watch.stale and isinstance(e, Exception):
                return  # the watchdog served it already
            if isinstance(e, Exception) and asm is not None:
                with self._lock:
                    wedged = self._wedged
                    if wedged:
                        self.stats["host_fallbacks"] += 1
                if wedged:
                    # a wedge declared meanwhile quarantined the collect
                    # thread: the batch is the wedge's, as if queued
                    self._mirror_async(asm, futures, "device wedged")
                else:
                    self._device_failed(e, futures, "submit")
                return
            for f in futures:
                _safe_fail(f, e)
            if not isinstance(e, Exception):
                raise

    def _collect_batch(self, asm, out, futures, watch, releaser) -> None:
        """Collect half: wait for the batch's event and resolve its
        futures, while the device thread submits the next batch. A
        stalled batch keeps this thread (and the assembly) until the
        device lets the wait return."""
        tag = asm.fanlin_batch
        t0, c0 = time.perf_counter_ns(), time.thread_time_ns()
        try:
            asm.wait()
            t1, c1 = time.perf_counter_ns(), time.thread_time_ns()
            results = asm.collect(out)
        except Exception as e:
            releaser.release()
            if watch is not None:
                self._watch_done(watch, roundtrip_ok=False)
                if watch.stale:
                    return  # the watchdog served it already
            self._device_failed(e, futures, "collect")
            return
        releaser.release()
        if watch is not None:
            # unwatched from here on, so `stale` is final
            self._watch_done(watch, roundtrip_ok=True)
        if watch is not None and watch.stale:
            return  # mirror-served already; the late result is dropped
        t2, c2 = time.perf_counter_ns(), time.thread_time_ns()
        for f, r in zip(futures, results):
            _safe_result(f, r, t_ns=t2, batch=tag.id)
        # from the hand-over: the batch may have waited for this thread
        with self._lock:
            self.stats["device_wait_ms_total"] += (t1 - tag.t_handed) / 1e6
        self._phase("device_wait", tag, t0, t1, c0, c1, counted=False,
                    queued_ms=(t0 - tag.t_handed) / 1e6)
        self._phase("unpack", tag, t1, t2, c1, c2)

    def close(self) -> bool:
        """Drain and shut down: queued groups are dispatched (to the
        mirror while wedged), then every thread finishes. Returns True
        when all finished within the budget: the stall bound (5 s at
        most while wedged: those threads are not coming back), or
        _CLOSE_BUDGET_S without a watchdog."""
        with self._lock:
            self._closed = True
            self._wake.notify()
            wedged = self._wedged
        budget = self.device_stall_s if self._armed else _CLOSE_BUDGET_S
        if wedged:
            budget = min(budget, 5.0)
        deadline = time.monotonic() + budget
        # the scheduler may hold popped groups it is about to dispatch
        self._scheduler.join(timeout=5)
        with self._lock:
            pending = [entry[1] for entry in self._groups.values()]
            self._groups.clear()
        for group in pending:
            self._dispatch(group)
        clean = True
        with self._lock:
            # device first: its batches still hand off to the collector
            # and the mirror, which shut down after it
            executors = [self._device, self._collector, self._host]
            executors += self._abandoned
        for ex in executors:
            ex.shutdown(wait=False)
            for t in list(getattr(ex, "_threads", ())):
                t.join(timeout=max(deadline - time.monotonic(), 0.1))
                clean = clean and not t.is_alive()
        if not clean:
            _logger.error("batcher close timed out after %.0f s: device "
                          "threads still stuck", budget)
        return clean


class BatchingRunner:
    """Engine-compatible runner backed by a MicroBatcher: the calling
    worker thread blocks on futures while its images ride shared
    batches."""

    def __init__(self, batcher: MicroBatcher):
        self.batcher = batcher
        self._tls = threading.local()

    @property
    def device(self) -> torch.device:
        return self.batcher.device

    @property
    def fast(self) -> bool:
        return self.batcher.fast

    def run(self, plans: List[ImagePlan], images: List[np.ndarray],
            kinds: List[str] = None):
        if kinds is None:
            kinds = ["rgb"] * len(plans)
        futures = [self.batcher.submit(p, i, k)
                   for p, i, k in zip(plans, images, kinds)]
        results = []
        for f in futures:
            results.append(f.result())
            self.batcher.note_handoff(f, time.perf_counter_ns())
        # sticky per thread, consumed by the engine at the end of the
        # request (a GIF makes several run() calls)
        if any(getattr(f, "fanlin_host_mirror", False) for f in futures):
            self._tls.host_mirror = True
        return results

    def prestage(self, meta):
        """`MicroBatcher.prestage`, on the calling thread."""
        return self.batcher.prestage(meta)

    def consume_host_mirror_flag(self) -> bool:
        """True when a run() on this thread since the last consume was
        served by the host mirror."""
        v = getattr(self._tls, "host_mirror", False)
        self._tls.host_mirror = False
        return v

    def device_available(self) -> bool:
        return self.batcher.device_available()
