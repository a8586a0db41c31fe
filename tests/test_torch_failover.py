"""The port's failover lane on the CPU: the host mirror serving while
the device does not answer (fanlin_tpu_torch.engine.batcher with
`host_fallback` and `device_stall_s`).

Twins of tests/test_device_stall.py (stalls, wedge, probes, fresh
executors, close, the worker-side gauges) on `torch.device("cpu")`, with
the device's faults injected by monkeypatching the assemblies' submit /
collect / run. Where the JAX package's test drives a part the port
leaves out, its twin holds what the port does instead: a device call
that raises fails its batch (the reference mirrors it), nothing is
mirrored at startup or for warmup, batches while wedged never touch the
device, a kernel build runs before any call is watched and its failure
is never mirrored, and the JPEG coefficient source resumes as soon as
the wedge clears (the port has no soft-degrade, spillover or
coefficient-mirror streak). Then the rest of the slice: the CMYK host
twin while wedged, the mirror flag over the worker socket, the
gateway's cold headers, its response cache and its 500 on a device
error, sticky CUDA errors, deferred warmup and the port refusing to
start without CUDA.

Tolerances: a mirror-served result is within 1 LSB of the device
path's (PARITY.md known-diff #6); a device-served one is equal to it.
Every test runs under its own time limit (`time_limit`) and waits on
events or polled conditions with deadlines; stall bounds are 0.2-0.5 s.
"""

import asyncio
import functools
import io
import json
import logging
import os
import random
import signal
import sys
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from fanlin_tpu_torch import config as tconfig
from fanlin_tpu_torch.engine import batcher as batcher_mod
from fanlin_tpu_torch.engine import icc as ticc
from fanlin_tpu_torch.engine import warmup as warmup_mod
from fanlin_tpu_torch.engine.batcher import (BatchingRunner, DeviceStalled,
                                             MicroBatcher)
from fanlin_tpu_torch.engine.processor import COLD_MARK, Engine
from fanlin_tpu_torch.ops import _build
from fanlin_tpu_torch.ops import cmyk_lut as tlut
from fanlin_tpu_torch.ops import fused, hostexec
from fanlin_tpu_torch.ops import plan as plan_mod
from fanlin_tpu_torch.server import app as app_mod
from fanlin_tpu_torch.server import workers as w
from fanlin_tpu_torch.spec.content import Format
from fanlin_tpu_torch.spec.query import parse_query
from tests.conftest import make_test_image, psnr
from tests.test_torch_icc import cmyk_jpeg, make_cmyk_profile

CPU = torch.device("cpu")
GOLDEN = os.path.abspath(os.path.join(os.path.dirname(__file__), "golden"))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def time_limit(seconds: float):
    """Fail the test (TimeoutError in its thread) past `seconds` instead
    of hanging its xdist worker."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            def expire(_sig, _frame):
                raise TimeoutError(f"{fn.__name__} ran past its {seconds} s "
                                   "limit")

            old = signal.signal(signal.SIGALRM, expire)
            signal.setitimer(signal.ITIMER_REAL, seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.setitimer(signal.ITIMER_REAL, 0)
                signal.signal(signal.SIGALRM, old)
        return run
    return deco


def _rgba(img):
    out = np.empty(img.shape[:2] + (4,), dtype=np.uint8)
    out[..., :3] = img
    out[..., 3] = 255
    return out


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


def _case(w_, h_, qs):
    """(image, plan, the device path's result) of one geometry."""
    img = _rgba(make_test_image(w_, h_))
    plan = plan_mod.plan_image(w_, h_, parse_query(qs))
    return img, plan, fused.BatchAssembly([plan], [img], CPU).run()[0]


def _within_lsb(got, want, lsb=1):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max()) \
        <= lsb


def _mirrored(fut) -> bool:
    return getattr(fut, "fanlin_host_mirror", False)


def _batcher(**kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("window_ms", 1.0)
    kw.setdefault("host_fallback", True)
    return MicroBatcher(device=CPU, **kw)


# -- twins of tests/test_device_stall.py --------------------------------------


@time_limit(60)
def test_warm_stall_fails_over_and_recovers(monkeypatch, caplog):
    img, plan, expected = _case(157, 103, "w=71&h=59")
    relay_back, stuck = threading.Event(), threading.Event()
    real_collect, real_run = fused.BatchAssembly.collect, fused.BatchAssembly.run
    hang_once = [True]

    def wedged_collect(self, out):
        if hang_once[0]:
            hang_once[0] = False
            stuck.set()
            assert relay_back.wait(30.0)
        return real_collect(self, out)

    def wedged_run(self):
        if not relay_back.is_set():
            assert relay_back.wait(30.0)
        return real_run(self)

    monkeypatch.setattr(fused.BatchAssembly, "collect", wedged_collect)
    monkeypatch.setattr(fused.BatchAssembly, "run", wedged_run)
    caplog.set_level(logging.WARNING, logger="fanlin.batcher")
    batcher = _batcher(device_stall_s=0.4)
    try:
        # the stuck batch itself: from the mirror, flagged, counted, logged
        f1 = batcher.submit(plan, img)
        r1 = f1.result(timeout=10.0)
        assert stuck.is_set() and _mirrored(f1)
        _within_lsb(r1, expected)
        assert batcher.stats["device_stalls"] >= 1
        assert batcher.stats["device_wedged"] == 1
        assert batcher.stats["host_fallbacks"] == 1
        assert any(r.levelno == logging.WARNING
                   and "host mirror serving a batch" in r.getMessage()
                   for r in caplog.records)
        # while wedged: straight to the mirror
        before = batcher.stats["host_fallbacks"]
        f2 = batcher.submit(plan, img)
        _within_lsb(f2.result(timeout=10.0), expected)
        assert _mirrored(f2) and batcher.stats["host_fallbacks"] > before
        # the stuck call returns: recovered, the next batch on the device
        relay_back.set()
        assert _wait(lambda: batcher.stats["device_wedged"] == 0)
        f3 = batcher.submit(plan, img)
        np.testing.assert_array_equal(f3.result(timeout=30.0), expected)
        assert not _mirrored(f3)
    finally:
        relay_back.set()
        batcher.close()


@time_limit(60)
def test_probe_recovers_after_collect_raises(monkeypatch):
    img, plan, expected = _case(149, 107, "w=67&h=61")
    relay_back, died = threading.Event(), threading.Event()
    real_collect, real_run = fused.BatchAssembly.collect, fused.BatchAssembly.run
    hang_once = [True]

    def dying_collect(self, out):
        if hang_once[0]:
            hang_once[0] = False
            time.sleep(0.6)  # past device_stall_s, then torn down
            died.set()
            raise RuntimeError("synthetic device tear-down")
        return real_collect(self, out)

    def probe_run(self):
        if not relay_back.is_set():
            assert relay_back.wait(30.0)
        return real_run(self)

    monkeypatch.setattr(fused.BatchAssembly, "collect", dying_collect)
    monkeypatch.setattr(fused.BatchAssembly, "run", probe_run)
    batcher = _batcher(device_stall_s=0.3)
    try:
        f1 = batcher.submit(plan, img)
        _within_lsb(f1.result(timeout=10.0), expected)
        assert _mirrored(f1)
        assert _wait(lambda: batcher.stats["device_wedged"] == 1)
        # the stuck collect raising is no round trip: still wedged, and
        # the already mirrored batch is not served or counted again
        assert died.wait(10.0)
        time.sleep(0.2)
        assert batcher.stats["device_wedged"] == 1
        assert batcher.stats["host_fallbacks"] == 1
        assert batcher.stats["device_errors"] == 0
        relay_back.set()
        assert _wait(lambda: batcher.stats["device_wedged"] == 0,
                     timeout=15.0), "the probe never recovered the device"
        f2 = batcher.submit(plan, img)
        np.testing.assert_array_equal(f2.result(timeout=30.0), expected)
        assert not _mirrored(f2)
    finally:
        relay_back.set()
        batcher.close()


@time_limit(60)
def test_close_is_bounded_while_wedged(monkeypatch):
    img, plan, _ = _case(151, 109, "w=73&h=57")
    relay_back = threading.Event()
    real_collect = fused.BatchAssembly.collect

    def wedged_collect(self, out):
        assert relay_back.wait(60.0)
        return real_collect(self, out)

    monkeypatch.setattr(fused.BatchAssembly, "collect", wedged_collect)
    monkeypatch.setattr(fused.BatchAssembly, "run",
                        lambda self: relay_back.wait(60.0) and None)
    batcher = _batcher(device_stall_s=0.3)
    try:
        batcher.submit(plan, img).result(timeout=10.0)
        assert _wait(lambda: batcher.stats["device_wedged"] == 1)
        t0 = time.monotonic()
        clean = batcher.close()
        took = time.monotonic() - t0
        assert clean is False, "close claimed clean with a stuck thread"
        assert took < 20.0, f"wedged close took {took:.1f}s"
    finally:
        relay_back.set()


@time_limit(60)
def test_close_clean_when_healthy():
    batcher = _batcher(device_stall_s=5.0)
    img, plan, expected = _case(83, 61, "w=41&h=31")
    f = batcher.submit(plan, img)
    np.testing.assert_array_equal(f.result(timeout=30.0), expected)
    assert not _mirrored(f)
    assert batcher.close() is True
    assert batcher.stats["host_fallbacks"] == 0


@time_limit(60)
def test_queued_batches_fail_over_on_wedge(monkeypatch):
    img, plan, expected = _case(163, 101, "w=79&h=53")
    relay_back, stuck = threading.Event(), threading.Event()
    real_submit = fused.BatchAssembly.submit
    hang_once = [True]

    def wedged_submit(self):
        # the first device call blocks in submit: later flushes queue
        # behind it on the device executor
        if hang_once[0]:
            hang_once[0] = False
            stuck.set()
            assert relay_back.wait(30.0)
        return real_submit(self)

    monkeypatch.setattr(fused.BatchAssembly, "submit", wedged_submit)
    monkeypatch.setattr(fused.BatchAssembly, "run",
                        lambda self: relay_back.wait(30.0) and None)
    batcher = _batcher(max_batch=1, device_stall_s=0.4)
    try:
        f1 = batcher.submit(plan, img)
        assert stuck.wait(10.0)
        queued = [batcher.submit(plan, img) for _ in range(3)]
        for f in queued:
            _within_lsb(f.result(timeout=10.0), expected)
        assert all(_mirrored(f) for f in queued)
        _within_lsb(f1.result(timeout=10.0), expected)
        assert _mirrored(f1)
        assert batcher.stats["host_fallbacks"] == 4
    finally:
        relay_back.set()
        batcher.close()


@time_limit(90)
def test_recovery_uses_fresh_executors(monkeypatch):
    """A collect that never returns must not poison the pipeline past
    recovery: the quarantined executors are replaced (the post-recovery
    batch is submitted by another device thread, which makes its own
    CUDA stream on a card) and the stuck permit is force-released, so
    with pipeline_depth=1 the next batch rides the device at once."""
    img, plan, expected = _case(167, 97, "w=83&h=47")
    relay_back, never = threading.Event(), threading.Event()
    real_collect, real_run = fused.BatchAssembly.collect, fused.BatchAssembly.run
    real_submit = fused.BatchAssembly.submit
    hang_once = [True]
    probe_calls = [0]
    submitters = []

    def recording_submit(self):
        submitters.append(threading.current_thread())
        return real_submit(self)

    def wedged_collect(self, out):
        if hang_once[0]:
            hang_once[0] = False
            never.wait(120.0)
            raise RuntimeError("abandoned")
        return real_collect(self, out)

    def probe_run(self):
        probe_calls[0] += 1
        if not relay_back.is_set():
            relay_back.wait(120.0)  # a hung probe: abandoned after ~2 s
            raise RuntimeError("abandoned probe")
        return real_run(self)

    monkeypatch.setattr(fused.BatchAssembly, "submit", recording_submit)
    monkeypatch.setattr(fused.BatchAssembly, "collect", wedged_collect)
    monkeypatch.setattr(fused.BatchAssembly, "run", probe_run)
    batcher = _batcher(device_stall_s=0.3, pipeline_depth=1)
    try:
        f1 = batcher.submit(plan, img)
        f1.result(timeout=10.0)
        assert _mirrored(f1)
        assert _wait(lambda: batcher.stats["device_wedged"] == 1)
        assert _wait(lambda: probe_calls[0] >= 1, timeout=10.0)
        relay_back.set()
        assert _wait(lambda: batcher.stats["device_wedged"] == 0,
                     timeout=20.0), "a hung probe blocked later probes"
        f2 = batcher.submit(plan, img)
        np.testing.assert_array_equal(f2.result(timeout=30.0), expected)
        assert not _mirrored(f2)
        first, last = submitters[0], submitters[-1]
        assert first.name.startswith("fanlin-device")
        assert last.name.startswith("fanlin-device") and last is not first
    finally:
        relay_back.set()
        never.set()
        batcher.close()


@time_limit(60)
def test_wedged_close_drains_pending_to_mirror(monkeypatch):
    img, plan, expected = _case(173, 91, "w=87&h=43")
    relay_back = threading.Event()
    real_collect = fused.BatchAssembly.collect

    def wedged_collect(self, out):
        assert relay_back.wait(60.0)
        return real_collect(self, out)

    monkeypatch.setattr(fused.BatchAssembly, "collect", wedged_collect)
    monkeypatch.setattr(fused.BatchAssembly, "run",
                        lambda self: relay_back.wait(60.0) and None)
    batcher = _batcher(max_batch=8, device_stall_s=0.3)
    try:
        batcher.submit(plan, img).result(timeout=10.0)
        assert _wait(lambda: batcher.stats["device_wedged"] == 1)
        batcher.window_s = 100.0  # f2 waits in its group until close()
        f2 = batcher.submit(plan, img)
        assert batcher.close() is False  # a stuck thread: unclean
        _within_lsb(f2.result(timeout=10.0), expected)
        assert _mirrored(f2)
    finally:
        relay_back.set()


def _watchdogs() -> set:
    """The live stall-watchdog threads. A test compares the set, not its
    size: a watchdog of an earlier test's batcher may exit meanwhile."""
    return {t for t in threading.enumerate() if t.name == "fanlin-stallwatch"}


@time_limit(60)
def test_device_stall_config_knob():
    cfg = tconfig.TpuConfig.from_obj({"device_stall_s": 7.5})
    assert cfg.device_stall_s == 7.5
    assert tconfig.TpuConfig().device_stall_s == 30.0
    assert tconfig.TpuConfig().host_fallback is True
    assert tconfig.TpuConfig().spill_wait_ms == 500.0
    for bad in ({"device_stall_s": "30s"}, {"device_stall_s": True},
                {"device_stall_s": -1}, {"batch_window_ms": "2ms"}):
        with pytest.raises(tconfig.ConfigError):
            tconfig.TpuConfig.from_obj(bad)
    # 0 disables the watchdog: no new watchdog thread
    before = _watchdogs()
    b = _batcher(device_stall_s=0.0)
    try:
        assert _watchdogs() <= before
    finally:
        b.close()
    # the config reaches the batcher; spill_wait_ms is accepted and inert
    made = app_mod.make_batcher(tconfig.Config.from_obj(_raw(
        {"device_stall_s": 2.5, "spill_wait_ms": 40, "host_fallback": False})),
        CPU)
    try:
        assert (made.device_stall_s, made._host_fallback) == (2.5, False)
        assert not any("spill" in k for k in vars(made))
    finally:
        made.close()


@time_limit(60)
def test_dispatch_survives_executor_shutdown_race():
    """_dispatch reads the device executor under the lock and submits
    outside it; close (or a wedge) may shut it down in between. Not
    wedged, the batch fails (it is not the mirror's); wedged, the mirror
    takes it. The scheduler stays alive either way."""
    img, plan, expected = _case(151, 103, "w=71&h=41")
    batcher = _batcher(max_batch=4, window_ms=5.0, device_stall_s=30.0)
    try:
        batcher._device.shutdown(wait=False)
        f1 = batcher.submit(plan, img)  # timer flush -> _dispatch raise
        with pytest.raises(RuntimeError, match="shutdown"):
            f1.result(timeout=15.0)
        assert not _mirrored(f1) and batcher._scheduler.is_alive()
        assert batcher.stats["host_fallbacks"] == 0
        # wedged between _dispatch's check and its submit
        fut = Future()
        real_submit = batcher._device.submit
        calls = []

        def wedge_then_refuse(*a, **k):
            calls.append(1)
            with batcher._lock:
                batcher._wedged = True
            raise RuntimeError("cannot schedule new futures after shutdown")

        batcher._device.submit = wedge_then_refuse
        batcher._dispatch([(plan, img, fut, "rgb", None, None,
                            time.perf_counter_ns(), None)])
        _within_lsb(fut.result(timeout=15.0), expected)
        assert calls == [1] and _mirrored(fut)
        batcher._device.submit = real_submit
        with batcher._lock:
            batcher._mark_recovered_locked()
            batcher._device = batcher._new_device_executor()
        f2 = batcher.submit(plan, img)
        np.testing.assert_array_equal(f2.result(timeout=15.0), expected)
        assert not _mirrored(f2)
    finally:
        batcher.close()


@time_limit(60)
def test_submit_host_fails_futures_when_host_lane_closed():
    img, plan, _ = _case(61, 47, "w=30&h=20")
    batcher = _batcher(max_batch=4, window_ms=5.0, device_stall_s=30.0)
    try:
        batcher._host.shutdown(wait=False)
        fut = Future()
        batcher._submit_host([(plan, img, fut, "rgb", None, None, 0.0)],
                             "test")
        with pytest.raises(RuntimeError, match="closed"):
            fut.result(timeout=5.0)
    finally:
        batcher.close()


def _jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


@time_limit(60)
def test_wedged_engine_prefers_pixel_source_path():
    """While the runner reports the device unavailable, a JPEG takes the
    pixel path (the same bytes), and the coefficient path resumes on
    recovery."""
    class ToggleRunner:
        """The mirror as a runner, with a switchable availability."""

        def __init__(self):
            self.up = True

        def run(self, plans, images, kinds=None):
            return hostexec.run_host(fused.make_assembly(
                plans, images, kinds or ["rgb"], CPU))

        def device_available(self):
            return self.up

    runner = ToggleRunner()
    engine = Engine(runner=runner)
    data = _jpeg(make_test_image(97, 71), quality=88)
    q = parse_query("w=40&h=30")
    _, healthy = engine.process_image(data, q, Format())
    assert engine.stats == {"coef_src": 1, "pixel_src": 0}
    runner.up = False
    _, wedged = engine.process_image(data, q, Format())
    assert engine.stats["pixel_src"] == 1
    assert wedged == healthy
    runner.up = True
    engine.process_image(data, q, Format())
    assert engine.stats["coef_src"] == 2


@time_limit(60)
def test_recovery_resumes_the_coefficient_source(monkeypatch):
    """A coefficient batch stalls and is mirror-served; while wedged a
    JPEG takes the pixel path; once the stuck call returns the wedge
    clears and the very next JPEG uploads coefficients again (nothing
    keeps the engine on pixels after recovery). All bodies agree."""
    data = _jpeg(make_test_image(149, 101), quality=90)
    params = parse_query("w=70&h=50")
    back = threading.Event()
    real_collect = fused.CoefBatchAssembly.collect
    hang_once = [True]

    def wedged_collect(self, out):
        if hang_once[0]:
            hang_once[0] = False
            assert back.wait(30.0)
        return real_collect(self, out)

    monkeypatch.setattr(fused.CoefBatchAssembly, "collect", wedged_collect)
    monkeypatch.setattr(fused.BatchAssembly, "run",
                        lambda self: back.wait(30.0) and None)
    b = _batcher(max_batch=4, device_stall_s=0.3)
    try:
        engine = Engine(runner=BatchingRunner(b))
        marks = [[], [], []]
        outs = [engine.process_image(data, params, Format(), marks[0])[1]]
        assert engine.stats == {"coef_src": 1, "pixel_src": 0}
        assert b.stats["device_wedged"] == 1 and not b.device_available()
        outs.append(engine.process_image(data, params, Format(), marks[1])[1])
        assert engine.stats["pixel_src"] == 1
        back.set()
        assert _wait(lambda: b.stats["device_wedged"] == 0)
        assert b.device_available()
        outs.append(engine.process_image(data, params, Format(), marks[2])[1])
        assert engine.stats == {"coef_src": 2, "pixel_src": 1}
        assert [(COLD_MARK, 0.0) in m for m in marks] == [True, True, False]
        decoded = [np.asarray(Image.open(io.BytesIO(o))) for o in outs]
        assert all(psnr(d, decoded[2]) >= 45.0 for d in decoded)
    finally:
        back.set()
        b.close()


@time_limit(60)
def test_startup_and_warmup_never_served_by_the_mirror(monkeypatch):
    """Twin of the boot-wedge test: the port has no boot-time wedge (it
    refuses to start without CUDA), so a fresh batcher is available and
    its startup warmup rides the device; a warm batch that raises fails
    its future and one that stalls fails with DeviceStalled, neither
    mirror-served or counted as a fallback."""
    mb = _batcher(max_batch=4, window_ms=5.0, device_stall_s=0.3)
    try:
        assert mb.device_available() and mb.stats["device_wedged"] == 0
        shapes = ((64, 48, "w=30&h=20"),)
        n = 2 * len(warmup_mod._kinds(False, False))  # B = 1 and 4
        assert warmup_mod.warm(mb, shapes, device_decode=False) == n
        assert mb.stats["warm_batches"] == n
        plan = plan_mod.plan_image(64, 48, parse_query("w=30&h=20"),
                                   opaque=True)
        img = make_test_image(64, 48)
        real_submit = fused.BatchAssembly.submit
        state = {"mode": "raise"}
        release = threading.Event()

        def faulty_submit(self):
            if state["mode"] == "raise":
                raise RuntimeError("device error during warmup")
            if state["mode"] == "stall":
                release.wait(20.0)
            return real_submit(self)

        monkeypatch.setattr(fused.BatchAssembly, "submit", faulty_submit)
        monkeypatch.setattr(fused.BatchAssembly, "run",
                            lambda self: release.wait(20.0) and None)
        with pytest.raises(RuntimeError, match="during warmup"):
            mb.warm_batch([plan], [img], ["rgb"]).result(timeout=10)
        state["mode"] = "stall"
        with pytest.raises(DeviceStalled):
            mb.warm_batch([plan], [img], ["rgb"]).result(timeout=10)
        assert mb.stats["device_stalls"] == 1
        assert mb.stats["host_fallbacks"] == 0
        assert mb.stats["device_errors"] == 0
        release.set()
        assert _wait(lambda: mb.stats["device_wedged"] == 0)
    finally:
        release.set()
        mb.close()


@time_limit(60)
def test_failover_disabled_fails_the_batch(monkeypatch):
    """Twin of the failover-disabled boot test: without host_fallback
    no watchdog runs and a raising device call fails its futures,
    counted as a device error, with nothing mirrored."""
    before = _watchdogs()
    img, plan, _ = _case(61, 47, "w=30&h=20")

    def broken(self):
        raise RuntimeError("device submit failed")

    monkeypatch.setattr(fused.BatchAssembly, "submit", broken)
    mb = _batcher(max_batch=4, window_ms=5.0, device_stall_s=0.3,
                  host_fallback=False)
    try:
        assert _watchdogs() <= before
        with pytest.raises(RuntimeError, match="submit failed"):
            mb.submit(plan, img).result(timeout=10)
        assert mb.device_available()
        assert mb.stats["host_fallbacks"] == 0
        assert mb.stats["device_errors"] == 1
    finally:
        mb.close()


def _fake_stats(r, monkeypatch, batcher):
    calls = {"n": 0}

    def fake():
        calls["n"] += 1
        return {"batcher": batcher}

    monkeypatch.setattr(r, "service_stats", fake)
    return calls


@time_limit(30)
def test_remote_runner_device_available_ttl(monkeypatch):
    """The worker-side gauge is the service's wedge gauge behind a ~1 s
    cache; an unreachable service keeps the last known value."""
    r = w.RemoteRunner("/nonexistent")
    calls = _fake_stats(r, monkeypatch, {"device_wedged": 1})
    assert r.device_available() is False
    assert r.device_available() is False  # cached
    assert calls["n"] == 1
    monkeypatch.setattr(r, "service_stats", lambda: None)
    r._avail = (0.0, False)  # expire the cache
    assert r.device_available() is False  # unreachable: last known
    _fake_stats(r, monkeypatch, {"device_wedged": 0})
    r._avail = (0.0, False)
    assert r.device_available() is True


@time_limit(90)
def test_worker_engine_follows_the_service_wedge(tmp_path):
    """A worker's Engine over RemoteRunner: JPEGs upload coefficients
    while the service's device serves, take the pixel source (answered
    cold by the service's mirror) once the worker's gauge reads the
    wedge, and go back to coefficients on the first refresh after
    recovery; the bodies agree."""
    path = str(tmp_path / "svc.sock")
    svc = w.DeviceService(tconfig.Config.from_obj(_raw({})), path,
                          device=CPU)
    svc.start()
    try:
        runner = w.RemoteRunner(path)
        engine = Engine(runner=runner)
        data = _jpeg(make_test_image(131, 89), quality=90)
        q = parse_query("w=60&h=40")
        marks = [[], [], []]
        outs = [engine.process_image(data, q, Format(), marks[0])[1]]
        svc.batcher._declare_wedged()  # no probe batch: stays wedged
        runner._avail = (0.0, True)  # expire the worker's cache
        outs.append(engine.process_image(data, q, Format(), marks[1])[1])
        with svc.batcher._lock:
            svc.batcher._mark_recovered_locked()
        runner._avail = (0.0, False)
        outs.append(engine.process_image(data, q, Format(), marks[2])[1])
        assert engine.stats == {"coef_src": 2, "pixel_src": 1}
        assert [(COLD_MARK, 0.0) in m for m in marks] == [False, True, False]
        decoded = [np.asarray(Image.open(io.BytesIO(o))) for o in outs]
        assert outs[0] == outs[2]
        assert psnr(decoded[1], decoded[0]) >= 45.0
        assert svc.batcher.stats["host_fallbacks"] == 1
    finally:
        assert svc.stop()


@time_limit(60)
def test_wedged_batches_never_touch_the_device(monkeypatch):
    """Twin of the wedged cold-bucket test: while wedged, batches are
    staged on the host and served by the mirror without any device
    call (the port's counterpart of spawning no compile), and the first
    batch after recovery rides the device."""
    img, plan, expected = _case(59, 43, "w=31&h=23")
    calls = []
    real_submit = fused.BatchAssembly.submit

    def counting_submit(self):
        calls.append(self.device)
        return real_submit(self)

    monkeypatch.setattr(fused.BatchAssembly, "submit", counting_submit)
    mb = _batcher(max_batch=4, window_ms=5.0, device_stall_s=30.0)
    try:
        mb._declare_wedged()  # no probe batch: stays wedged
        f = mb.submit(plan, img)
        _within_lsb(f.result(timeout=30), expected)
        assert _mirrored(f) and calls == []
        with mb._lock:
            mb._mark_recovered_locked()
        f2 = mb.submit(plan, img)
        np.testing.assert_array_equal(f2.result(timeout=30), expected)
        assert not _mirrored(f2) and calls == [CPU]
    finally:
        mb.close()


@time_limit(120)
def test_flapping_link_soak(monkeypatch):
    """Stalls past the bound, short stalls, raising collects and
    raising submits, flapping under concurrent load: no request lost or
    hung, every result within 1 LSB, a raised device error failing only
    its own requests with that error, and once healthy the device path
    serves the exact result again."""
    img, plan, expected = _case(149, 97, "w=67&h=53")
    expected = np.asarray(expected).astype(np.int16)
    rng = random.Random(11)
    healthy = threading.Event()
    real_collect, real_submit = (fused.BatchAssembly.collect,
                                 fused.BatchAssembly.submit)
    injected = ("device tear-down", "transfer error at submit")

    def flaky_collect(self, out):
        if not healthy.is_set():
            roll = rng.random()
            if roll < 0.25:
                time.sleep(0.7)   # past the stall bound: wedge
            elif roll < 0.40:
                time.sleep(0.15)  # slow, inside the bound
            elif roll < 0.50:
                raise RuntimeError(injected[0])
        return real_collect(self, out)

    def flaky_submit(self):
        if not healthy.is_set() and rng.random() < 0.10:
            raise RuntimeError(injected[1])
        return real_submit(self)

    monkeypatch.setattr(fused.BatchAssembly, "collect", flaky_collect)
    monkeypatch.setattr(fused.BatchAssembly, "submit", flaky_submit)
    batcher = _batcher(device_stall_s=0.3)
    errors, failed, lock = [], [0], threading.Lock()

    def submitter(n):
        for _ in range(n):
            f = batcher.submit(plan, img)
            try:
                r = np.asarray(f.result(timeout=20.0)).astype(np.int16)
            except RuntimeError as e:
                with lock:
                    if str(e) in injected and not _mirrored(f):
                        failed[0] += 1
                    else:
                        errors.append(repr(e))
                continue
            except Exception as e:
                with lock:
                    errors.append(repr(e))
                continue
            d = int(np.abs(r - expected).max())
            if d > 1:
                with lock:
                    errors.append(f"diff {d}")

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads finely
    try:
        threads = [threading.Thread(target=submitter, args=(20,))
                   for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
        assert not any(t.is_alive() for t in threads), "a submitter hung"
        assert not errors, errors[:5]
        # each failed request's batch was counted (a batch holds up to
        # max_batch requests)
        assert failed[0] <= batcher.max_batch * batcher.stats["device_errors"]
        healthy.set()
        assert _wait(lambda: batcher.stats["device_wedged"] == 0,
                     timeout=30.0), "the wedge never cleared once healthy"
        f = batcher.submit(plan, img)
        r = np.asarray(f.result(timeout=30.0)).astype(np.int16)
        np.testing.assert_array_equal(r, expected)
    finally:
        sys.setswitchinterval(switch)
        healthy.set()
        batcher.close()


@time_limit(60)
def test_make_assembly_failure_fails_fast_with_fallback_armed(monkeypatch):
    img, plan, _ = _case(151, 101, "w=73&h=53")

    def broken_make_assembly(*a, **k):
        raise RuntimeError("synthetic staging failure")

    monkeypatch.setattr(fused, "make_assembly", broken_make_assembly)
    batcher = _batcher(device_stall_s=0.5)
    try:
        f = batcher.submit(plan, img)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="synthetic staging failure"):
            f.result(timeout=5.0)
        assert time.monotonic() - t0 < 2.0, "the failure was not fast"
        assert batcher._inflight._value == batcher.pipeline_depth
        assert batcher.stats["host_fallbacks"] == 0
    finally:
        batcher.close()


@time_limit(60)
def test_collector_submit_failure_releases_permit_and_fails():
    """A collect thread that cannot take the batch (its executor shut
    down, no wedge): the batch fails as a device error, its permit and
    watch are released, nothing is mirrored."""
    img, plan, _ = _case(153, 99, "w=69&h=51")

    class DeadExecutor:
        def submit(self, *a, **k):
            raise RuntimeError("cannot schedule new futures after shutdown")

        def shutdown(self, *a, **k):
            pass

    batcher = _batcher(max_batch=1, device_stall_s=30.0)
    batcher._collector = DeadExecutor()
    try:
        for _ in range(batcher.pipeline_depth + 2):
            f = batcher.submit(plan, img)
            with pytest.raises(RuntimeError, match="shutdown"):
                f.result(timeout=10.0)
            assert not _mirrored(f)
        assert batcher.stats["device_errors"] == batcher.pipeline_depth + 2
        assert batcher.stats["host_fallbacks"] == 0
        assert _wait(
            lambda: batcher._inflight._value == batcher.pipeline_depth)
        assert not batcher._watch
    finally:
        batcher.close()


@time_limit(60)
def test_abandoned_probe_late_success_recovers(monkeypatch):
    """A probe that hangs past its budget is abandoned, and still clears
    the wedge when it completes (the stuck collect here never returns
    within the test, so only the late probe can)."""
    img, plan, expected = _case(141, 103, "w=61&h=47")
    probe_gate, probe_started, never = (threading.Event(), threading.Event(),
                                        threading.Event())
    real_collect, real_run = fused.BatchAssembly.collect, fused.BatchAssembly.run
    hang_once = [True]

    def wedged_collect(self, out):
        if hang_once[0]:
            hang_once[0] = False
            never.wait(30.0)
            raise RuntimeError("abandoned")
        return real_collect(self, out)

    def gated_run(self):
        probe_started.set()
        assert probe_gate.wait(30.0)
        return real_run(self)

    monkeypatch.setattr(fused.BatchAssembly, "collect", wedged_collect)
    monkeypatch.setattr(fused.BatchAssembly, "run", gated_run)
    batcher = _batcher(device_stall_s=0.3)
    try:
        _within_lsb(batcher.submit(plan, img).result(timeout=10.0), expected)
        assert _wait(lambda: batcher.stats["device_wedged"] == 1)
        assert probe_started.wait(10.0)
        assert _wait(lambda: not batcher._probing, timeout=10.0)
        assert batcher.stats["probe_threads"] >= 1
        assert batcher.stats["device_wedged"] == 1
        probe_gate.set()
        assert _wait(lambda: batcher.stats["device_wedged"] == 0,
                     timeout=15.0), "the late probe never recovered"
        assert _wait(lambda: batcher.stats["probe_threads"] == 0)
    finally:
        probe_gate.set()
        never.set()
        batcher.close()


@time_limit(60)
def test_probe_backoff_on_hung_probes(monkeypatch):
    img, plan, _ = _case(139, 101, "w=59&h=43")
    probe_gate, never = threading.Event(), threading.Event()
    real_collect = fused.BatchAssembly.collect
    hang_once = [True]

    def wedged_collect(self, out):
        if hang_once[0]:
            hang_once[0] = False
            never.wait(30.0)
        return real_collect(self, out)

    def gated_run(self):
        assert probe_gate.wait(30.0)
        raise RuntimeError("still down")

    monkeypatch.setattr(fused.BatchAssembly, "collect", wedged_collect)
    monkeypatch.setattr(fused.BatchAssembly, "run", gated_run)
    batcher = _batcher(device_stall_s=0.3)
    try:
        base = batcher._probe_interval
        batcher.submit(plan, img).result(timeout=10.0)
        assert _wait(lambda: batcher.stats["device_wedged"] == 1)
        assert _wait(lambda: batcher._probe_interval > base, timeout=15.0), \
            "a hung probe never backed off"
        # a fresh wedge probes fast again
        with batcher._lock:
            batcher._mark_recovered_locked()
        batcher._declare_wedged()
        assert batcher._probe_interval == base
    finally:
        probe_gate.set()
        never.set()
        batcher.close()


# -- what the port does instead of the mirror ------------------------------------


@time_limit(60)
def test_slow_device_keeps_everything_on_device(monkeypatch):
    """A device alive but slow, batches waiting behind it far past the
    reference's spill_wait_ms, with the knob set: every batch still
    rides the device (no spillover, no soft-degrade in the port)."""
    img, plan, expected = _case(167, 109, "w=71&h=53")
    real_collect = fused.BatchAssembly.collect

    def slow_collect(self, out):
        time.sleep(0.15)
        return real_collect(self, out)

    monkeypatch.setattr(fused.BatchAssembly, "collect", slow_collect)
    cfg = tconfig.Config.from_obj(_raw({"spill_wait_ms": 20,
                                        "max_batch": 1,
                                        "pipeline_depth": 1,
                                        "batch_window_ms": 1}))
    batcher = app_mod.make_batcher(cfg, CPU)
    try:
        futs = [batcher.submit(plan, img) for _ in range(4)]
        for f in futs:
            np.testing.assert_array_equal(f.result(timeout=30.0), expected)
        # the batches queued behind the slow collects far past 20 ms
        assert (batcher.stats["queue_wait_ms_total"]
                / batcher.stats["images"]) > 20
        assert batcher.stats["host_fallbacks"] == 0
        assert not any(_mirrored(f) for f in futs)
    finally:
        batcher.close()


@time_limit(60)
def test_healthy_device_never_mirrors():
    img, plan, expected = _case(151, 101, "w=67&h=47")
    batcher = _batcher(max_batch=1, device_stall_s=30.0)
    try:
        futs = [batcher.submit(plan, img) for _ in range(8)]
        for f in futs:
            np.testing.assert_array_equal(f.result(timeout=30.0), expected)
        assert batcher.stats["host_fallbacks"] == 0
        assert batcher.stats["device_errors"] == 0
        assert not any(_mirrored(f) for f in futs)
    finally:
        batcher.close()


@pytest.mark.parametrize("where", ["submit", "collect"])
@time_limit(60)
def test_device_error_fails_the_batch(monkeypatch, caplog, where):
    """A device call that raises, at submit or at collect, with the
    mirror armed: the batch fails with that error, counted in
    device_errors and logged at ERROR; nothing is mirrored, no wedge,
    and the next batch rides the device."""
    img, plan, expected = _case(157, 101, "w=67&h=49")
    real = getattr(fused.BatchAssembly, where)
    once = [True]

    def raise_once(self, *a):
        if once[0]:
            once[0] = False
            raise RuntimeError("resample kernel launch failed: CUDA error 209")
        return real(self, *a)

    monkeypatch.setattr(fused.BatchAssembly, where, raise_once)
    caplog.set_level(logging.WARNING, logger="fanlin.batcher")
    batcher = _batcher(device_stall_s=0.3)
    try:
        f = batcher.submit(plan, img)
        with pytest.raises(RuntimeError, match="CUDA error 209"):
            f.result(timeout=10.0)
        assert not _mirrored(f)
        st = batcher.stats
        assert (st["device_errors"], st["host_fallbacks"],
                st["device_wedged"]) == (1, 0, 0)
        assert any(r.levelno == logging.ERROR and where in r.getMessage()
                   and "CUDA error 209" in r.getMessage()
                   for r in caplog.records)
        assert not any("host mirror" in r.getMessage()
                       for r in caplog.records)
        f2 = batcher.submit(plan, img)
        np.testing.assert_array_equal(f2.result(timeout=10.0), expected)
        assert not _mirrored(f2)
        assert _wait(
            lambda: batcher._inflight._value == batcher.pipeline_depth)
    finally:
        batcher.close()


# -- the rest of the slice -----------------------------------------------------


@time_limit(60)
def test_kernel_build_error_is_never_mirrored(monkeypatch, caplog):
    img, plan, _ = _case(61, 47, "w=30&h=20")

    def no_build(self):
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(fused.BatchAssembly, "submit", no_build)
    caplog.set_level(logging.ERROR, logger="fanlin.batcher")
    mb = _batcher(device_stall_s=0.5)
    try:
        f = mb.submit(plan, img)
        with pytest.raises(_build.KernelBuildError):
            f.result(timeout=10)
        assert mb.stats["host_fallbacks"] == 0
        assert mb.stats["device_errors"] == 1
        assert mb.device_available()
        assert any("nvcc not found" in r.getMessage()
                   for r in caplog.records)
    finally:
        mb.close()
    assert issubclass(_build.KernelBuildError, RuntimeError)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build._nvcc()


@time_limit(60)
def test_kernel_build_runs_before_any_watched_call(monkeypatch):
    """The kernels build when the batcher is made, before its watchdog
    or any device call: a build slower than device_stall_s that then
    fails raises KernelBuildError from the constructor (and from
    build_state: the server does not start), with no batcher threads
    left and nothing to mirror."""
    seen = []

    def slow_failing_build(device):
        seen.append(device)
        time.sleep(0.5)  # past the stall bound below
        raise _build.KernelBuildError("build failed (1): nvcc ...")

    monkeypatch.setattr(batcher_mod, "_load_kernels", slow_failing_build)
    names = ("fanlin-stallwatch", "fanlin-batch-flush")
    before = set(threading.enumerate())
    with pytest.raises(_build.KernelBuildError):
        _batcher(device_stall_s=0.2)
    assert seen == [CPU]
    assert not [t for t in threading.enumerate()
                if t.name in names and t not in before]
    cfg = tconfig.Config.from_obj(_raw({"device_stall_s": 0.2}))
    with pytest.raises(_build.KernelBuildError):
        asyncio.run(app_mod.build_state(cfg, device=CPU))
    # the real loader builds only for a CUDA device
    monkeypatch.undo()
    monkeypatch.setattr(_build, "load", lambda: seen.append("load"))
    batcher_mod._load_kernels(CPU)
    batcher_mod._load_kernels(torch.device("cuda", 0))
    assert seen == [CPU, CPU, "load"]


@time_limit(60)
def test_sticky_cuda_error_fails_every_batch(monkeypatch):
    """A sticky CUDA error poisons the context: every batch after it
    fails with the error, counted, until the process is restarted; the
    mirror never takes over and the device is not reported wedged."""
    img, plan, _ = _case(61, 47, "w=30&h=20")

    def poisoned(self):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(fused.BatchAssembly, "submit", poisoned)
    monkeypatch.setattr(fused.BatchAssembly, "run", poisoned)
    mb = _batcher(device_stall_s=0.2)
    try:
        for n in (1, 2):
            f = mb.submit(plan, img)
            with pytest.raises(RuntimeError, match="illegal memory access"):
                f.result(timeout=10)
            assert not _mirrored(f)
            assert mb.stats["device_errors"] == n
        assert mb.stats["host_fallbacks"] == 0
        assert mb.stats["device_wedged"] == 0 and mb.device_available()
    finally:
        mb.close()


@pytest.mark.parametrize("error", ["sticky", "build"])
@time_limit(60)
def test_probe_error_ends_the_wedge(monkeypatch, caplog, error):
    """A stall wedges the batcher and the mirror serves; then the probe
    raises (a sticky CUDA error, or a kernel build failure): the device
    answered, so the wedge ends, the mirror stops serving, and the next
    batch fails with the error on the device, never mirrored."""
    exc = (RuntimeError("CUDA error: an illegal memory access was "
                        "encountered") if error == "sticky"
           else _build.KernelBuildError("build failed (1): nvcc"))
    img, plan, expected = _case(143, 97, "w=63&h=45")
    never = threading.Event()
    real_collect = fused.BatchAssembly.collect
    broken = threading.Event()
    hang_once = [True]

    def wedged_collect(self, out):
        if hang_once[0]:
            hang_once[0] = False
            never.wait(30.0)
        return real_collect(self, out)

    def failing(self):
        broken.set()
        raise exc

    def failing_probe(self):
        assert go.wait(30.0)
        failing(self)

    go = threading.Event()
    monkeypatch.setattr(fused.BatchAssembly, "collect", wedged_collect)
    monkeypatch.setattr(fused.BatchAssembly, "run", failing_probe)
    caplog.set_level(logging.ERROR, logger="fanlin.batcher")
    batcher = _batcher(device_stall_s=0.3)
    try:
        f1 = batcher.submit(plan, img)
        _within_lsb(f1.result(timeout=10.0), expected)
        assert _mirrored(f1) and batcher.stats["device_wedged"] == 1
        monkeypatch.setattr(fused.BatchAssembly, "submit", failing)
        go.set()
        assert broken.wait(15.0), "no probe ran"
        assert _wait(lambda: batcher.stats["device_wedged"] == 0)
        assert _wait(lambda: any("probe raised" in r.getMessage()
                                 for r in caplog.records))
        fallbacks = batcher.stats["host_fallbacks"]
        f2 = batcher.submit(plan, img)
        with pytest.raises(type(exc)):
            f2.result(timeout=10.0)
        assert not _mirrored(f2)
        assert batcher.stats["host_fallbacks"] == fallbacks == 1
        assert batcher.stats["device_errors"] == 1
    finally:
        go.set()
        never.set()
        batcher.close()


@time_limit(60)
def test_warmup_defers_while_wedged():
    """warm() defers while device_ok is False, and resumes when it
    turns True; no warm batch runs meanwhile."""
    mb = _batcher(max_batch=2, device_stall_s=30.0)
    up = threading.Event()
    ran = []
    try:
        real = mb.warm_batch

        def counting(*a):
            ran.append(up.is_set())
            return real(*a)

        mb.warm_batch = counting
        done = []
        old = warmup_mod._DEFER_POLL_S
        warmup_mod._DEFER_POLL_S = 0.05
        try:
            t = threading.Thread(target=lambda: done.append(warmup_mod.warm(
                mb, ((64, 48, "w=30&h=20"),), device_decode=False,
                device_ok=up.is_set)))
            t.start()
            time.sleep(0.4)
            assert ran == [] and not done
            up.set()
            t.join(timeout=30)
        finally:
            warmup_mod._DEFER_POLL_S = old
        n = 2 * len(warmup_mod._kinds(False, False))  # B = 1 and 2
        assert done == [n] and ran == [True] * n
    finally:
        mb.close()


def _cmyk_engine(runner):
    prof = make_cmyk_profile(0)
    engine = Engine(CPU, runner=runner,
                    cmyk2rgb=ticc.CMYK2RGB.with_icc_profile(prof))
    engine.enable_device_icc()
    return engine


def _exif_rotated(data: bytes) -> bytes:
    """The CMYK stream with an EXIF orientation 6: the pixel route."""
    im = Image.open(io.BytesIO(data))
    exif = Image.Exif()
    exif[0x0112] = 6
    buf = io.BytesIO()
    im.save(buf, format="JPEG", quality=95, exif=exif.tobytes())
    return buf.getvalue()


@time_limit(60)
def test_icc_with_the_device_wedged_uses_the_host_twin(monkeypatch):
    """While wedged, a CMYK source on the pixel route converts through
    DeviceCmykTransform.convert_host (no device touch), equal to the
    device form's bytes; the coefficient route stays on coefficients,
    mirror-served; both responses are marked cold."""
    xform = tlut.DeviceCmykTransform(
        tlut.sample_lut(ticc.CMYK2RGB.with_icc_profile(
            make_cmyk_profile(0)).convert, 17), CPU)
    px = np.asarray(Image.open(io.BytesIO(cmyk_jpeg(96, 64, seed=2))))
    np.testing.assert_array_equal(xform.convert_host(px), xform.convert(px))

    mb = _batcher(max_batch=2, device_stall_s=30.0)
    try:
        engine = _cmyk_engine(BatchingRunner(mb))
        data = cmyk_jpeg(96, 64, seed=2)
        rotated = _exif_rotated(data)
        q = parse_query("w=48&h=32")
        healthy = [engine.process_image(d, q, Format(), [])[1]
                   for d in (data, rotated)]
        calls = []
        monkeypatch.setattr(tlut.DeviceCmykTransform, "convert",
                            lambda self, px: calls.append(1))
        mb._declare_wedged()
        marks = [[], []]
        wedged = [engine.process_image(d, q, Format(), m)[1]
                  for d, m in zip((data, rotated), marks)]
        assert calls == []
        assert all((COLD_MARK, 0.0) in m for m in marks)
        assert engine.stats["coef_src"] == 2  # CMYK kept its route
        for a, b in zip(wedged, healthy):
            assert psnr(np.asarray(Image.open(io.BytesIO(a))),
                        np.asarray(Image.open(io.BytesIO(b)))) >= 45.0
        assert mb.stats["host_fallbacks"] == 2
    finally:
        mb.close()


def _raw(tpu: dict) -> dict:
    return {
        "port": 0, "bind_addr": "127.0.0.1", "max_clients": 8,
        "client": {"s3": {"aws_region": "x"},
                   "web": {"user_agent": "t", "timeout": 2}},
        "providers": [{"path": "baz", "src": "file://localhost" + GOLDEN}],
        "tpu": {"warmup": False, **tpu},
    }


def _fail_next_submits(monkeypatch, n: int):
    """The next `n` device submits of any assembly raise."""
    real = fused.BatchAssembly.submit
    left = [n]

    def submit(self):
        if left[0] > 0:
            left[0] -= 1
            raise RuntimeError("transient device error")
        return real(self)

    # a coefficient batch's submit reaches it through super()
    monkeypatch.setattr(fused.BatchAssembly, "submit", submit)
    return left


@time_limit(60)
def test_gateway_marks_mirror_responses_cold(monkeypatch):
    """A mirror-served response (the device wedged) carries
    X-Cache-Warmth: cold and Cache-Control: no-store and is never put in
    the response cache; the next, device-served one is cached as
    before."""
    cfg = tconfig.Config.from_obj(_raw({"response_cache_mb": 8}))
    url = "/baz/lenna_src.jpg?w=300&h=200"

    async def body():
        state = await app_mod.build_state(cfg, device=CPU)
        batcher = state.engine.runner.batcher
        client = TestClient(TestServer(app_mod.create_app(cfg, state)))
        await client.start_server()
        try:
            batcher._declare_wedged()  # no probe batch: stays wedged
            r1 = await client.get(url)
            b1 = await r1.read()
            with batcher._lock:
                batcher._mark_recovered_locked()
            r2 = await client.get(url)
            await r2.read()
            r3 = await client.get(url)
            await r3.read()
            stats = json.loads(await (await client.get("/stats")).text())
            return r1, b1, r2, r3, stats, state.response_cache
        finally:
            await client.close()

    r1, b1, r2, r3, stats, cache = asyncio.run(body())
    assert r1.status == 200 and r1.headers["X-Cache-Warmth"] == "cold"
    assert r1.headers["Cache-Control"] == "no-store"
    assert "__host_mirror__" not in r1.headers["Server-Timing"]
    assert "X-Cache" not in r2.headers and "X-Cache-Warmth" not in r2.headers
    assert r3.headers.get("X-Cache") == "hit"
    assert stats["batcher"]["host_fallbacks"] == 1
    assert stats["batcher"]["device_errors"] == 0


@time_limit(60)
def test_gateway_answers_500_on_device_error(monkeypatch):
    """A device error fails the request: 500, not cold, not cached, and
    the next request is served by the device and cached."""
    cfg = tconfig.Config.from_obj(_raw({"response_cache_mb": 8}))
    url = "/baz/lenna_src.jpg?w=300&h=200"

    async def body():
        state = await app_mod.build_state(cfg, device=CPU)
        client = TestClient(TestServer(app_mod.create_app(cfg, state)))
        await client.start_server()
        try:
            _fail_next_submits(monkeypatch, 1)
            r1 = await client.get(url)
            await r1.read()
            r2 = await client.get(url)
            await r2.read()
            r3 = await client.get(url)
            await r3.read()
            stats = json.loads(await (await client.get("/stats")).text())
            return r1, r2, r3, stats
        finally:
            await client.close()

    r1, r2, r3, stats = asyncio.run(body())
    assert r1.status == 500 and "X-Cache-Warmth" not in r1.headers
    assert r2.status == 200 and "X-Cache-Warmth" not in r2.headers
    assert r3.headers.get("X-Cache") == "hit"
    assert stats["batcher"]["device_errors"] == 1
    assert stats["batcher"]["host_fallbacks"] == 0


@time_limit(90)
def test_worker_socket_carries_the_mirror_flag(tmp_path, monkeypatch):
    """In worker mode the service's mirror flag crosses the socket with
    the reply: the worker answers cold, and its gauges read the
    service's wedge."""
    path = str(tmp_path / "svc.sock")
    cfg = tconfig.Config.from_obj(_raw({}))
    svc = w.DeviceService(cfg, path, device=CPU)
    svc.start()
    try:
        runner = w.RemoteRunner(path)
        plan = plan_mod.plan_image(64, 48, parse_query("w=30&h=20"),
                                   opaque=True)
        img = make_test_image(64, 48)
        svc.batcher._declare_wedged()  # no probe batch: stays wedged
        out = runner.run([plan], [img], ["rgb"])
        assert runner.consume_host_mirror_flag()
        assert not runner.consume_host_mirror_flag()
        assert out[0].shape == (20, 30, 3)
        assert runner.device_available() is False
        with svc.batcher._lock:
            svc.batcher._mark_recovered_locked()
        runner.run([plan], [img], ["rgb"])
        assert not runner.consume_host_mirror_flag()
        runner._avail = (0.0, False)  # expire the cache
        assert runner.device_available() is True

        async def cold_through_gateway():
            client_cfg = tconfig.Config.from_obj(_raw({}))
            state = await app_mod.build_state(client_cfg, runner=runner)
            client = TestClient(TestServer(app_mod.create_app(client_cfg,
                                                              state)))
            await client.start_server()
            try:
                svc.batcher._declare_wedged()
                r = await client.get("/baz/lenna_src.jpg?w=30&h=20")
                await r.read()
                return r
            finally:
                await client.close()

        r = asyncio.run(cold_through_gateway())
        assert r.status == 200 and r.headers["X-Cache-Warmth"] == "cold"
        assert svc.batcher.stats["host_fallbacks"] == 2
        assert svc.batcher.stats["device_errors"] == 0
    finally:
        assert svc.stop()


@time_limit(60)
def test_port_without_cuda_refuses_to_start():
    """The port never starts on the CPU by itself (so there is no
    boot-time wedge and no mirror at startup): build_state without a
    device raises where CUDA is absent."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    cfg = tconfig.Config.from_obj(_raw({}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        asyncio.run(app_mod.build_state(cfg))
    from fanlin_tpu_torch import device as device_mod
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_mod.cuda_device()


@time_limit(30)
def test_probe_runs_a_replica_of_the_stalled_batch():
    """The recovery probe runs the stalled batch again from its staged
    host arrays, through a replica whose transfer state is its own."""
    img, plan, expected = _case(61, 47, "w=30&h=20")
    asm = fused.BatchAssembly([plan], [img], CPU)
    twin = asm.replica()
    assert twin._io is not asm._io and twin.x is asm.x
    np.testing.assert_array_equal(twin.run()[0], expected)
    with ThreadPoolExecutor(1) as ex:
        mb = _batcher(device_stall_s=30.0)
        try:
            ex.submit(mb._probe_run, asm).result(timeout=10)
        finally:
            mb.close()
