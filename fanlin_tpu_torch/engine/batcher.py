"""Request micro-batcher: concurrent requests become one device batch
per shape group, pipelined on a CUDA stream.

Port of fanlin_tpu/engine/batcher.py (:116-239, :572-697, :920-1231,
:1261-1351) without its TPU-relay failover lanes. HTTP gives one image
at a time; the batcher

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
* sheds entries whose request was abandoned (the gateway's cancel
  event) or whose deadline passed, before any staging or device work;
* optionally caps each group's queue (``max_queue``), rejecting at
  admission with `BatcherOverload`.

A batch whose submit or collect raises fails its requests' futures:
nothing is served from the CPU instead. The reference's host mirror,
stall watchdog, soft-degrade, spillover, cold-compile warm threads and
mesh are not in the port (`tpu.host_fallback`, `device_stall_s` and
`spill_wait_ms` do nothing yet).

The port defines its own contextvars and exceptions: it imports
nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from concurrent.futures import Future, InvalidStateError, ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops import fused
from ..ops.plan import ImagePlan, bucket_h, bucket_w

# How long close() waits for the device and collect threads to drain.
_CLOSE_BUDGET_S = 60.0

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


def _safe_result(fut: Future, result) -> None:
    """set_result tolerant of a future resolved (or cancelled)
    elsewhere."""
    if fut.cancelled():
        return
    try:
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
    """Exactly-once release of one pipeline permit (BoundedSemaphore
    raises on over-release; the submit and collect error paths may
    both try)."""

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
    device through a two-stage (submit / collect) pipeline."""

    def __init__(self, max_batch: int, window_ms: float,
                 device: torch.device, pipeline_depth: int = 2,
                 max_queue: int = 0, fast: bool = False):
        """device: where batches run. pipeline_depth: batches allowed
        between submit and collect. max_queue: per-group cap on admitted
        entries not yet picked up by the device thread (0 = unlimited).
        fast: every batch's resample products in bf16 (`tpu.fast`), the
        warmup's too."""
        self.device = device
        self.fast = bool(fast)
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.max_queue = max_queue
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        # key -> (flush deadline, [(plan, image, future, kind,
        #         req_deadline, cancel_ev, t_submitted)])
        self._groups: Dict[Tuple, Tuple[float, list]] = {}
        # key -> entries admitted but not yet picked up by the device
        # thread (the backlog max_queue bounds)
        self._backlog: Dict[Tuple, int] = {}
        # key -> a flushed batch, not full, that the device thread has
        # not picked up yet: new entries of the group join it
        self._queued: Dict[Tuple, list] = {}
        self._stream = None
        self._device = ThreadPoolExecutor(
            1, thread_name_prefix="fanlin-device",
            initializer=self._init_device_thread)
        self._collector = ThreadPoolExecutor(
            1, thread_name_prefix="fanlin-collect")
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self._inflight = threading.BoundedSemaphore(self.pipeline_depth)
        self._closed = False
        # observability counters (the gateway's /stats)
        self.stats = {"batches": 0, "images": 0, "full_flushes": 0,
                      "timer_flushes": 0, "queued_joins": 0,
                      "shed_expired": 0,
                      "shed_cancelled": 0, "rejected_overload": 0,
                      "pipeline_depth": self.pipeline_depth,
                      # host->device bytes of the batches' wires
                      # (pixels, or coefficient blocks and tables)
                      "upload_bytes": 0,
                      # queued entries across groups (gauge), and the
                      # submit->dispatch wait of dispatched entries
                      # (cumulative ms and peak; mean = total / images)
                      "backlog": 0,
                      "queue_wait_ms_total": 0.0,
                      "queue_wait_ms_peak": 0.0,
                      # startup batches run by engine.warmup
                      "warm_batches": 0}
        self._scheduler = threading.Thread(
            target=self._flush_loop, name="fanlin-batch-flush", daemon=True)
        self._scheduler.start()

    def _init_device_thread(self) -> None:
        """The device thread's own device and CUDA stream."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            self._stream = torch.cuda.Stream(self.device)

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    # -- submission --------------------------------------------------------

    def submit(self, plan: ImagePlan, image, kind: str = "rgb") -> Future:
        """Queue one image (pixels, or a coefficient dict for coef*
        kinds); the future resolves to its result."""
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
                    time.monotonic())
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
        """Queue a batch on the device thread; if that executor is shut
        down already (close), fail the batch's futures."""
        try:
            self._device.submit(self._run_batch, group)
        except RuntimeError as e:
            with self._lock:
                self._claim(group)
            for entry in group:
                _safe_fail(entry[2], e)

    def _claim(self, group) -> None:
        """Close `group` to new entries (the device thread takes it, or
        it failed). Called with the lock held."""
        key = _group_key(group[0][0], group[0][3])
        if self._queued.get(key) is group:
            del self._queued[key]

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
        results."""
        def run():
            asm = fused.make_assembly(plans, payloads, kinds, self.device,
                                      fast=self.fast)
            with self._on_stream():
                out = asm.submit()
            results = asm.collect(out)
            with self._lock:
                self.stats["warm_batches"] += 1
            return results

        return self._device.submit(run)

    # -- device execution --------------------------------------------------

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

    def _run_batch(self, group) -> None:
        """Submit half, on the device thread: stage the batch, submit
        it on the thread's stream and hand it to the collect thread."""
        key0 = _group_key(group[0][0], group[0][3])
        with self._lock:
            self._claim(group)  # no entry joins it from here on
            left = self._backlog.get(key0, 0) - len(group)
            if left > 0:
                self._backlog[key0] = left
            else:
                self._backlog.pop(key0, None)
            self.stats["backlog"] = max(self.stats["backlog"] - len(group), 0)
        futures = [g[2] for g in group]
        releaser = None
        try:
            group = self._live_entries(group)
            if not group:
                return
            now = time.monotonic()
            with self._lock:
                self.stats["batches"] += 1
                self.stats["images"] += len(group)
                for g in group:
                    wait_ms = (now - g[6]) * 1000.0
                    self.stats["queue_wait_ms_total"] += wait_ms
                    if wait_ms > self.stats["queue_wait_ms_peak"]:
                        self.stats["queue_wait_ms_peak"] = wait_ms
            futures = [g[2] for g in group]
            asm = fused.make_assembly([g[0] for g in group],
                                      [g[1] for g in group],
                                      [g[3] for g in group], self.device,
                                      fast=self.fast)
            # bound submit-ahead to the pipeline depth
            self._inflight.acquire()
            releaser = _PermitOnce(self._inflight)
            with self._on_stream():
                out = asm.submit()
            with self._lock:
                self.stats["upload_bytes"] += asm.upload_bytes
            self._collector.submit(self._collect_batch, asm, out, futures,
                                   releaser)
        except BaseException as e:
            if releaser is not None:
                releaser.release()
            for f in futures:
                _safe_fail(f, e)
            if not isinstance(e, Exception):
                raise

    def _collect_batch(self, asm, out, futures, releaser) -> None:
        """Collect half: wait for the batch's event and resolve its
        futures, while the device thread submits the next batch."""
        try:
            results = asm.collect(out)
        except Exception as e:
            for f in futures:
                _safe_fail(f, e)
            return
        finally:
            releaser.release()
        for f, r in zip(futures, results):
            _safe_result(f, r)

    def close(self) -> bool:
        """Drain and shut down: queued groups are dispatched, then the
        device and collect threads finish. Returns True when every
        thread finished within the close budget."""
        with self._lock:
            self._closed = True
            self._wake.notify()
        deadline = time.monotonic() + _CLOSE_BUDGET_S
        # the scheduler may hold popped groups it is about to dispatch
        self._scheduler.join(timeout=5)
        with self._lock:
            pending = [entry[1] for entry in self._groups.values()]
            self._groups.clear()
        for group in pending:
            self._dispatch(group)
        clean = True
        # device first: its queued batches still hand off to the
        # collector, which shuts down after it
        for ex in (self._device, self._collector):
            ex.shutdown(wait=False)
            for t in list(getattr(ex, "_threads", ())):
                t.join(timeout=max(deadline - time.monotonic(), 0.1))
                clean = clean and not t.is_alive()
        return clean


class BatchingRunner:
    """Engine-compatible runner backed by a MicroBatcher: the calling
    worker thread blocks on futures while its images ride shared
    batches."""

    def __init__(self, batcher: MicroBatcher):
        self.batcher = batcher

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
        return [f.result() for f in futures]

    def device_available(self) -> bool:
        """Always True: the port has no wedge detection yet."""
        return True

    def prefer_pixel_source(self) -> bool:
        """Always False: the port has no host mirror to steer away
        from."""
        return False
