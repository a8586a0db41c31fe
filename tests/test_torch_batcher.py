"""The port's micro-batcher (fanlin_tpu_torch.engine.batcher) on the CPU.

The first ten tests are twins of tests/test_batcher.py, run on the
port's MicroBatcher with torch.device("cpu"). The rest hold the port's
`_group_key` equal to the JAX package's, batched outputs against the
JAX package (at most 1 LSB, the float resample sums in another order)
and byte-equal to the port's own serial runs, the single-flight plan
cache, and a raising batch failing its futures without hanging.
"""

import io
import sys
import threading
import time
from concurrent.futures import CancelledError

import numpy as np
import pytest
import torch
from PIL import Image

from fanlin_tpu.engine import batcher as jbatcher
from fanlin_tpu.engine import native_codecs
from fanlin_tpu.ops import fused as jfused
from fanlin_tpu.spec.query import parse_query as jparse_query
from fanlin_tpu_torch.engine import batcher as batcher_mod
from fanlin_tpu_torch.engine.batcher import (BatcherOverload, BatchingRunner,
                                             MicroBatcher, _group_key)
from fanlin_tpu_torch.engine.jpeg_coeffs import read_jpeg_coeffs
from fanlin_tpu_torch.ops import fused
from fanlin_tpu_torch.ops import plan as plan_mod
from fanlin_tpu_torch.spec.query import parse_query
from tests.conftest import make_test_image

CPU = torch.device("cpu")
JOIN_S = 30


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rgba(img):
    out = np.empty(img.shape[:2] + (4,), dtype=np.uint8)
    out[..., :3] = img
    out[..., 3] = 255
    return out


def _single(img, q):
    return fused.transform_single(img, q, CPU)


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)


def _close(a, b, max_lsb=1):
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    assert a.shape == b.shape and int(d.max()) <= max_lsb


def test_batched_results_match_sync():
    batcher = MicroBatcher(max_batch=4, window_ms=5.0, device=CPU)
    runner = BatchingRunner(batcher)
    imgs = [_rgba(make_test_image(64, 64, seed=i)) for i in range(6)]
    q = parse_query("w=32&h=32")
    plans = [plan_mod.plan_image(64, 64, q) for _ in imgs]

    results = [None] * 6

    def work(i):
        results[i] = runner.run([plans[i]], [imgs[i]])[0]

    threads = [threading.Thread(target=work, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    _join(threads)
    assert batcher.close()

    for i in range(6):
        np.testing.assert_array_equal(results[i], _single(imgs[i], q))
        _close(results[i], jfused.transform_single(
            imgs[i], jparse_query("w=32&h=32")))


def test_mixed_shapes_group_separately():
    batcher = MicroBatcher(max_batch=8, window_ms=2.0, device=CPU)
    runner = BatchingRunner(batcher)
    img_small = _rgba(make_test_image(64, 64))
    img_big = _rgba(make_test_image(200, 200))
    q = parse_query("w=32&h=32")
    p1 = plan_mod.plan_image(64, 64, q)
    p2 = plan_mod.plan_image(200, 200, q)
    out = runner.run([p1, p2], [img_small, img_big])
    assert batcher.close()
    assert out[0].shape == (32, 32, 4)
    assert out[1].shape == (32, 32, 4)
    assert batcher.stats["batches"] == 2
    np.testing.assert_array_equal(out[0], _single(img_small, q))
    np.testing.assert_array_equal(out[1], _single(img_big, q))


def test_full_batch_flushes_immediately():
    batcher = MicroBatcher(max_batch=2, window_ms=10_000.0, device=CPU)
    runner = BatchingRunner(batcher)
    imgs = [_rgba(make_test_image(32, 32, seed=i)) for i in range(2)]
    q = parse_query("grayscale=true")
    plans = [plan_mod.plan_image(32, 32, q) for _ in imgs]
    # both submitted together -> max_batch -> flush without the timer
    out = runner.run(plans, imgs)
    assert batcher.close()
    assert len(out) == 2
    assert batcher.stats["full_flushes"] == 1
    assert batcher.stats["timer_flushes"] == 0


def test_pipeline_overlaps_submit_and_collect(monkeypatch):
    """While batch N's collect blocks, batch N+1 is already submitted:
    the two halves overlap in time."""
    events = []
    real_submit = fused.BatchAssembly.submit
    real_collect = fused.BatchAssembly.collect

    def traced_submit(self):
        events.append(("submit", self.oh, time.monotonic()))
        return real_submit(self)

    def slow_collect(self, out):
        events.append(("collect_start", self.oh, time.monotonic()))
        time.sleep(0.4)  # stands in for device execution + download
        r = real_collect(self, out)
        events.append(("collect_end", self.oh, time.monotonic()))
        return r

    monkeypatch.setattr(fused.BatchAssembly, "submit", traced_submit)
    monkeypatch.setattr(fused.BatchAssembly, "collect", slow_collect)
    batcher = MicroBatcher(max_batch=1, window_ms=1.0, device=CPU,
                           pipeline_depth=2)
    runner = BatchingRunner(batcher)
    img = _rgba(make_test_image(64, 64))
    # two output buckets -> two groups -> two batches
    q1, q2 = parse_query("w=32&h=32"), parse_query("w=48&h=24")
    p1 = plan_mod.plan_image(64, 64, q1)
    p2 = plan_mod.plan_image(64, 64, q2)
    outs = [None, None]
    t1 = threading.Thread(
        target=lambda: outs.__setitem__(0, runner.run([p1], [img])[0]))
    t2 = threading.Thread(
        target=lambda: outs.__setitem__(1, runner.run([p2], [img])[0]))
    t1.start()
    t2.start()
    _join([t1, t2])
    assert batcher.close()
    assert outs[0].shape == (32, 32, 4) and outs[1].shape[:2] == (24, 48)
    submits = sorted(t for kind, _, t in events if kind == "submit")
    ends = sorted(t for kind, _, t in events if kind == "collect_end")
    assert len(submits) == 2 and len(ends) == 2
    # the second submit happened while the first collect was blocking
    assert submits[1] < ends[0], (submits, ends)


def test_entries_join_a_batch_the_device_thread_has_not_taken(monkeypatch):
    """While the device thread is busy, entries of a group join its
    flushed batch that waits for the device thread, up to max_batch,
    instead of queueing a batch per window; the batch they fill is
    closed to more."""
    release = threading.Event()
    real = fused.make_assembly
    calls = []

    def blocking(plans, *a, **k):
        calls.append(len(plans))
        if len(calls) == 1:
            assert release.wait(JOIN_S)
        return real(plans, *a, **k)

    monkeypatch.setattr(fused, "make_assembly", blocking)
    b = MicroBatcher(max_batch=4, window_ms=1.0, device=CPU)
    img = _rgba(make_test_image(64, 64))
    q1, q2 = parse_query("w=32&h=32"), parse_query("w=48&h=24")
    p1 = plan_mod.plan_image(64, 64, q1)
    p2 = plan_mod.plan_image(64, 64, q2)
    try:
        futs = [b.submit(p1, img)]  # the device thread blocks on it
        deadline = time.monotonic() + JOIN_S
        while not calls and time.monotonic() < deadline:
            time.sleep(0.001)
        futs.append(b.submit(p2, img))  # flushed, then waits
        while (b.stats["timer_flushes"] < 2
               and time.monotonic() < deadline):
            time.sleep(0.001)
        assert b.stats["timer_flushes"] == 2
        futs += [b.submit(p2, img) for _ in range(4)]
        assert b.stats["queued_joins"] == 3
        release.set()
        outs = [f.result(timeout=JOIN_S) for f in futs]
    finally:
        release.set()
        assert b.close()
    # the blocker, then the waiting batch filled to 4, then the fifth
    assert calls == [1, 4, 1]
    assert b.stats["batches"] == 3 and b.stats["images"] == 6
    assert b.stats["backlog"] == 0
    np.testing.assert_array_equal(outs[0], _single(img, q1))
    for out in outs[1:]:
        np.testing.assert_array_equal(out, _single(img, q2))


def test_expired_entries_are_shed_before_device_work(monkeypatch):
    calls = []

    def no_device_work(*a, **k):
        calls.append(1)
        raise AssertionError("device work for an expired entry")

    monkeypatch.setattr(fused, "make_assembly", no_device_work)
    b = MicroBatcher(max_batch=4, window_ms=1.0, device=CPU)
    try:
        img = _rgba(make_test_image(32, 32))
        plan = plan_mod.plan_image(32, 32, parse_query("w=16&h=16"))
        token = batcher_mod.REQUEST_DEADLINE.set(time.monotonic() - 0.001)
        try:
            fut = b.submit(plan, img)
        finally:
            batcher_mod.REQUEST_DEADLINE.reset(token)
        with pytest.raises(batcher_mod.RequestExpired, match="deadline"):
            fut.result(timeout=10)
        assert b.stats["shed_expired"] == 1
        assert not calls
    finally:
        b.close()


def test_live_deadline_rides_through_untouched():
    b = MicroBatcher(max_batch=4, window_ms=1.0, device=CPU)
    try:
        img = _rgba(make_test_image(32, 32))
        plan = plan_mod.plan_image(32, 32, parse_query("w=16&h=16"))
        token = batcher_mod.REQUEST_DEADLINE.set(time.monotonic() + 30.0)
        try:
            fut = b.submit(plan, img)
        finally:
            batcher_mod.REQUEST_DEADLINE.reset(token)
        out = fut.result(timeout=30)
        assert out.shape == (16, 16, 4)
        assert b.stats["shed_expired"] == 0
    finally:
        b.close()


def test_max_queue_rejects_at_admission():
    b = MicroBatcher(max_batch=64, window_ms=10_000.0, device=CPU,
                     max_queue=2)
    try:
        img = _rgba(make_test_image(32, 32))
        plan = plan_mod.plan_image(32, 32, parse_query("w=16&h=16"))
        f1 = b.submit(plan, img)
        f2 = b.submit(plan, img)
        with pytest.raises(BatcherOverload):
            b.submit(plan, img)
        assert b.stats["rejected_overload"] == 1
    finally:
        assert b.close()
    # close() dispatches the queued group
    assert f1.result(timeout=30).shape == (16, 16, 4)
    assert f2.result(timeout=30).shape == (16, 16, 4)


def test_cancelled_entry_never_stages(monkeypatch):
    calls = []

    def no_device_work(*a, **k):
        calls.append(1)
        raise AssertionError("device work for a cancelled entry")

    monkeypatch.setattr(fused, "make_assembly", no_device_work)
    b = MicroBatcher(max_batch=4, window_ms=5.0, device=CPU)
    try:
        img = _rgba(make_test_image(32, 32))
        plan = plan_mod.plan_image(32, 32, parse_query("w=16&h=16"))
        ev = threading.Event()
        token = batcher_mod.REQUEST_CANCEL.set(ev)
        try:
            fut = b.submit(plan, img)
        finally:
            batcher_mod.REQUEST_CANCEL.reset(token)
        ev.set()  # the middleware gave up while the entry is queued
        with pytest.raises(CancelledError):
            fut.result(timeout=10)
        assert fut.cancelled()
        assert b.stats["shed_cancelled"] == 1
        assert not calls
    finally:
        b.close()


def test_unset_cancel_event_rides_through():
    b = MicroBatcher(max_batch=4, window_ms=1.0, device=CPU)
    try:
        img = _rgba(make_test_image(32, 32))
        q = parse_query("w=16&h=16")
        plan = plan_mod.plan_image(32, 32, q)
        ev = threading.Event()
        token = batcher_mod.REQUEST_CANCEL.set(ev)
        try:
            fut = b.submit(plan, img)
        finally:
            batcher_mod.REQUEST_CANCEL.reset(token)
        out = fut.result(timeout=30)
        np.testing.assert_array_equal(out, _single(img, q))
        assert b.stats["shed_cancelled"] == 0
    finally:
        b.close()


def test_backpressure_metrics_track_queue_depth_and_wait():
    """The backlog gauge counts queued entries and returns to zero after
    dispatch; dispatched entries record their submit->dispatch wait,
    which for a timer flush is about the batch window, and the batch's
    phases after it are counted too."""
    b = MicroBatcher(max_batch=8, window_ms=30.0, device=CPU)
    try:
        assert b.stats["backlog"] == 0
        img = _rgba(make_test_image(32, 32))
        plan = plan_mod.plan_image(32, 32, parse_query("w=16&h=16"))
        futs = [b.submit(plan, img) for _ in range(3)]
        assert b.stats["backlog"] == 3
        for f in futs:
            f.result(timeout=30)
        assert b.stats["backlog"] == 0
        assert b.stats["images"] == 3
        mean = b.stats["queue_wait_ms_total"] / b.stats["images"]
        assert mean >= 10.0
        # one timer-flushed batch of the three: staged and collected once
        assert b.stats["batches"] == 1
        assert b.stats["stage_ms_total"] > 0
        assert b.stats["unpack_ms_total"] > 0
    finally:
        b.close()


# (src_w, src_h, query): bucket edges, crop, canvas, blur, no resize
PLAN_CASES = [(512, 512, "w=300&h=200"), (640, 480, "w=100&h=100&crop=true"),
              (101, 83, "w=300&h=300&rgb=1,2,3"), (512, 512, "w=100&h=80&blur=1"),
              (37, 23, "")]
KINDS = ["rgb", "jpeg420", "webp420", "png:1", "png:3", "png:4", "jpegdct:75",
         "coef", "coef444", "coef422", "coef440",
         "coef+jpeg420", "coef444+webp420", "coef422+png:3", "coef440+png:4",
         "coef+jpegdct:75", "cmyk444", "cmyk420+jpeg420"]


@pytest.mark.parametrize("kind", KINDS)
def test_group_key_matches_jax(kind):
    for w, h, qs in PLAN_CASES:
        got = _group_key(
            plan_mod.plan_image(w, h, parse_query(qs), opaque=True), kind)
        want = jbatcher._group_key(
            jfused.plan_image(w, h, jparse_query(qs), opaque=True), kind)
        assert got == want, (w, h, qs)


def _coef_sources():
    srcs = {}
    for name, sub in (("s420", 2), ("s444", 0)):
        buf = io.BytesIO()
        Image.fromarray(make_test_image(96, 72, seed=sub)).save(
            buf, format="JPEG", quality=85, subsampling=sub)
        srcs[name] = buf.getvalue()
    return srcs


@pytest.mark.skipif(not native_codecs.available(),
                    reason="native codec core not built")
def test_batched_coef_outputs_match_jax_and_serial():
    """Eight concurrent coefficient requests over two sources, two
    queries and two sinks form one batch per group; each result equals
    the port's serial run byte for byte and the JAX package's
    CoefBatchAssembly within 1 LSB."""
    KIND = {420: "coef", 444: "coef444"}
    metas = {n: read_jpeg_coeffs(d) for n, d in _coef_sources().items()}
    jmetas = {n: native_codecs.read_jpeg_coeffs(d)
              for n, d in _coef_sources().items()}
    jobs = [(n, qs, sink) for n in metas for qs in ("w=40&h=30", "w=20&h=20")
            for sink in ("", "+jpeg420")]
    batcher = MicroBatcher(max_batch=8, window_ms=50.0, device=CPU)
    runner = BatchingRunner(batcher)
    results = [None] * (2 * len(jobs))

    def work(i):
        n, qs, sink = jobs[i % len(jobs)]
        m = metas[n]
        p = plan_mod.plan_image(m["w"], m["h"], parse_query(qs), opaque=True)
        results[i] = runner.run([p], [m], [KIND[m["subsamp"]] + sink])[0]

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(results))]
    for t in threads:
        t.start()
    _join(threads)
    assert batcher.close()
    assert batcher.stats["images"] == len(results)
    assert batcher.stats["batches"] < len(results)
    for i, got in enumerate(results):
        n, qs, sink = jobs[i % len(jobs)]
        m = metas[n]
        p = plan_mod.plan_image(m["w"], m["h"], parse_query(qs), opaque=True)
        serial = fused.make_assembly([p], [m], [KIND[m["subsamp"]] + sink],
                                     CPU).run()[0]
        if sink:
            assert got[0] == serial[0] == "ycbcr420"
            for g, s in zip(got[1:], serial[1:]):
                np.testing.assert_array_equal(g, s)
            continue
        np.testing.assert_array_equal(got, serial)
        jm = jmetas[n]
        jp = jfused.plan_image(jm["w"], jm["h"], jparse_query(qs),
                               opaque=True)
        _close(got, jfused.CoefBatchAssembly([jp], [jm]).run()[0])


def test_concurrent_plan_image_is_single_flight():
    """16 threads missing the plan cache at once share one plan object,
    so their batch is uniform (and takes the kernel on CUDA)."""
    q = parse_query("w=123&h=45")
    barrier = threading.Barrier(16)
    plans = [None] * 16

    def work(i):
        barrier.wait(timeout=JOIN_S)
        plans[i] = plan_mod.plan_image(333, 222, q, opaque=True)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        _join(threads)
    finally:
        sys.setswitchinterval(old)
    assert all(p is plans[0] for p in plans)
    img = make_test_image(333, 222)
    asm = fused.BatchAssembly(plans, [img] * 16, CPU)
    assert asm.uniform and asm.uses_kernel()


def test_stress_more_threads_than_cores():
    """32 threads x 2 requests over two groups: every entry is counted
    once and the backlog drains to zero."""
    b = MicroBatcher(max_batch=8, window_ms=2.0, device=CPU)
    runner = BatchingRunner(b)
    img = make_test_image(24, 16)
    plans = [plan_mod.plan_image(24, 16, parse_query(qs), opaque=True)
             for qs in ("w=12&h=8", "w=200&h=150")]
    errors = []

    def work(i):
        try:
            for k in range(2):
                p = plans[(i + k) % 2]
                out = runner.run([p], [img])[0]
                assert out.shape == (p.out_h, p.out_w, 3)
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        _join(threads)
    finally:
        sys.setswitchinterval(old)
        assert b.close()
    assert not errors
    assert b.stats["images"] == 64
    assert b.stats["backlog"] == 0
    assert b.stats["batches"] >= 64 // 8


@pytest.mark.parametrize("half", ["submit", "collect"])
def test_raising_batch_fails_its_futures(monkeypatch, half):
    """A batch whose submit or collect raises fails every future of the
    batch (no hang, no CPU fallback), and the pipeline keeps serving."""
    real = getattr(fused.BatchAssembly, half)
    state = {"raise": True}

    def flaky(self, *a):
        if state["raise"]:
            raise RuntimeError(f"device {half} failed")
        return real(self, *a)

    monkeypatch.setattr(fused.BatchAssembly, half, flaky)
    b = MicroBatcher(max_batch=2, window_ms=1.0, device=CPU,
                     pipeline_depth=1)
    try:
        img = make_test_image(32, 32)
        plan = plan_mod.plan_image(32, 32, parse_query("w=16&h=16"),
                                   opaque=True)
        futs = [b.submit(plan, img) for _ in range(2)]
        for f in futs:
            with pytest.raises(RuntimeError, match=f"device {half} failed"):
                f.result(timeout=10)
        state["raise"] = False
        # the permit came back: the next batch runs
        assert b.submit(plan, img).result(timeout=10).shape == (16, 16, 3)
    finally:
        assert b.close()


def test_native_codecs_first_load_is_seen_by_every_thread(monkeypatch):
    """Concurrent first requests all see the native codec core's load
    result (a caller must not read "not built" while another loads it:
    under the batcher that picked different encode paths, and bytes,
    for identical requests)."""
    from fanlin_tpu_torch.engine import native_codecs as tnc

    want = tnc.available()
    monkeypatch.setattr(tnc, "_LIB", None)
    monkeypatch.setattr(tnc, "_TRIED", False)
    barrier = threading.Barrier(16)
    seen = [None] * 16

    def work(i):
        barrier.wait(timeout=JOIN_S)
        seen[i] = tnc.available()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    _join(threads)
    assert seen == [want] * 16
