"""Coefficient wires staged before they reach a batch, and the padded plan
matrices kept on the device by content (fanlin_tpu_torch/ops/fused.py
`WireSlot`, `_uniform_device`; engine/batcher.py `prestage`;
engine/processor.py's slot route), on the CPU.

A batch made from prestaged slots answers as the JAX package's
CoefBatchAssembly does, at 4:2:0 and 4:4:4 and at n = 1, 3 (bucket 4)
and 8, and as the same batch staged from dicts, which the host mirror
reads the same grids from; a slot is zero past its true grids whatever
its buffer held; a batch uploads its real images' slots alone; the
batcher counts prestaged images and sheds a cancelled one; cycling the
five camera srcset plans rebuilds each once and uploads each once; a
plan rebuilt with equal content finds its device copy.

The engine's routes: under a runner that stages (the server's batcher),
an upright JPEG with no source cache is read straight into its slot
(counted in `slot_reads`); a rotation, a source cache or a runner that
does not stage take the dict route; either route counts the reader's
decode, its scans and its ms (`read_stats`); a stream the reader
refuses, in its
header or inside its scans (the slot then dropped), takes the pixel
path. Every route answers as the dict route of an Engine on its own
runner does."""

import io
import re
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from fanlin_tpu.engine import native_codecs
from fanlin_tpu.ops import fused as jfused
from fanlin_tpu.spec.query import parse_query as jparse_query
from fanlin_tpu_torch.engine import jpeg_coeffs
from fanlin_tpu_torch.engine.batcher import (REQUEST_CANCEL, BatchingRunner,
                                             MicroBatcher)
from fanlin_tpu_torch.engine.jpeg_coeffs import read_jpeg_coeffs
from fanlin_tpu_torch.engine.processor import Engine, ProcessError
from fanlin_tpu_torch.engine.source_cache import SourceCache
from fanlin_tpu_torch.ops import filters, fused, hostexec, jpeg_decode
from fanlin_tpu_torch.ops import plan as plan_mod
from fanlin_tpu_torch.spec.content import Format
from fanlin_tpu_torch.spec.query import parse_query
from fanlin_tpu_torch.utils import profiling
from tests.conftest import make_test_image
from tests.test_torch_coef import _close, _oriented_jpeg
from tests.test_torch_jpeg_coeffs import _refused

CPU = torch.device("cpu")

# PIL's subsampling argument: 2 is 4:2:0, 0 is 4:4:4
LAYOUTS = {420: 2, 444: 0}

# an Engine's read_stats before the reader has decoded a stream
NO_READS = {"slot_reads": 0, "reads": 0, "read_ms_total": 0.0,
            "progressive_reads": 0, "read_scans_total": 0}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jpegs(subsamp, n, w=72, h=50):
    """n distinct w x h JPEGs of one layout."""
    out = []
    for i in range(n):
        img = np.roll(make_test_image(w, h), 7 * i, axis=1)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=85,
                                  subsampling=LAYOUTS[subsamp])
        out.append(buf.getvalue())
    return out


def _metas(subsamp, n, w=72, h=50):
    """n read_jpeg_coeffs metas of distinct w x h JPEGs of one layout."""
    out = [read_jpeg_coeffs(d) for d in _jpegs(subsamp, n, w, h)]
    assert all(m is not None and m["subsamp"] == subsamp for m in out)
    return out


def _plan(qs, w=72, h=50):
    return plan_mod.plan_image(w, h, parse_query(qs), opaque=True)


def _slots(metas):
    """The metas prestaged, as a codec thread stages them on the CPU."""
    return [fused.WireSlot(m, pinned=False) for m in metas]


@pytest.mark.skipif(not native_codecs.available(),
                    reason="native codec core not built")
@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("subsamp", [420, 444])
@pytest.mark.parametrize("sink", ["rgb", "jpeg420"])
def test_slot_batch_equals_device_thread_staging(subsamp, n, sink):
    """A batch of prestaged slots against the JAX package's
    CoefBatchAssembly on the same JPEGs (test_torch_coef.py's
    tolerances)."""
    data = _jpegs(subsamp, n)
    slots = _slots([read_jpeg_coeffs(d) for d in data])
    kind = "coef" if subsamp == 420 else "coef444"
    kinds = [kind if sink == "rgb" else f"{kind}+{sink}"] * n
    got = fused.make_assembly([_plan("w=40&h=30")] * n, slots, kinds, CPU)
    assert got.wires == slots and got.b == plan_mod.bucket_b(n)
    # the real images' slots alone cross the link
    assert got.upload_bytes == n * slots[0].nbytes
    jplan = jfused.plan_image(72, 50, jparse_query("w=40&h=30"), opaque=True)
    want = jfused.CoefBatchAssembly(
        [jplan] * n, [native_codecs.read_jpeg_coeffs(d) for d in data],
        jpeg420=sink == "jpeg420").run()
    assert len(want) == n
    for a, b in zip(got.run(), want):
        if isinstance(a, tuple):
            assert a[0] == b[0]
            for x, y in zip(a[1:], b[1:]):
                _close(x, y)
        else:
            _close(a, b)


@pytest.mark.parametrize("subsamp", [420, 444])
def test_mixed_batch_and_folded_route_equal_device_thread_staging(subsamp):
    """Some images prestaged in slots and some given as dicts, against
    the same batch all given as dicts (the assembly stages each into a
    slot); the folded route (which reads the bucket's padding images
    too) and a non-uniform batch."""
    metas = _metas(subsamp, 3)
    payloads = [fused.WireSlot(metas[0], False), metas[1],
                fused.WireSlot(metas[2], False)]
    kind = "coef" if subsamp == 420 else "coef444"
    p1, p2 = _plan("w=40&h=30"), _plan("w=31&h=22&blur=1")
    for plans, k in (([p1] * 3, kind), ([p1] * 3, kind + fused.FOLD_SUFFIX),
                     ([p1, p2, p1], kind)):
        want = fused.make_assembly(plans, metas, [k] * 3, CPU).run()
        asm = fused.make_assembly(plans, payloads, [k] * 3, CPU)
        assert asm.wires[0] is payloads[0] and asm.wires[2] is payloads[2]
        assert asm.wires[1].meta is metas[1]
        for a, b in zip(asm.run(), want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("subsamp", [420, 444])
def test_host_grids_and_mirror_of_a_slot_batch(subsamp):
    metas = _metas(subsamp, 3)
    plans = [_plan("w=40&h=30")] * 3
    kind = "coef" if subsamp == 420 else "coef444"
    want = fused.make_assembly(plans, metas, [kind] * 3, CPU)
    got = fused.make_assembly(plans, _slots(metas), [kind] * 3, CPU)
    for a, b, key in zip(got.host_grids(), want.host_grids(),
                         fused.CoefBatchAssembly.PLANES):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        assert a.shape[0] == 4 and not a[3:].any()  # the bucket's padding
        for i, m in enumerate(metas):
            r, c = m[key].shape[:2]
            np.testing.assert_array_equal(a[i, :r, :c], m[key])
            assert not a[i, r:].any() and not a[i, :, c:].any()
    np.testing.assert_array_equal(got.q, want.q)
    for a, b in zip(hostexec.run_host(got), hostexec.run_host(want)):
        np.testing.assert_array_equal(a, b)


def _random_meta(subsamp, w, h, rng):
    """A read_jpeg_coeffs-shaped dict of w x h at `subsamp` with non-zero
    random true grids (MCU-rounded, as the reader gives them)."""
    dv, dh = jpeg_decode.chroma_divisors(subsamp)
    my, mx = -(-h // (8 * dv)), -(-w // (8 * dh))  # MCU rows, columns

    def grid(r, c):
        return rng.integers(1, 1000, (r, c, 64)).astype(np.int16)

    return {"y": grid(my * dv, mx * dh), "cb": grid(my, mx),
            "cr": grid(my, mx), "lq": rng.integers(1, 99, 64),
            "cq": rng.integers(1, 99, 64), "w": w, "h": h,
            "subsamp": subsamp, "gray": False}


@pytest.mark.parametrize("subsamp", [420, 422, 440, 444])
def test_slot_is_zero_past_its_true_grids(subsamp, monkeypatch):
    """A slot's buffer comes from the allocator as it is (a reused pinned
    block holds an earlier image's bytes): filled with non-zero bytes
    here, the slot still holds the meta's grids and tables and zeros in
    every block past its true grids, inside the bucket's grid."""
    meta = _random_meta(subsamp, 75, 37, np.random.default_rng(subsamp))
    empty = torch.empty
    with monkeypatch.context() as m:
        m.setattr(torch, "empty",
                  lambda *a, **k: empty(*a, **k).fill_(0xA5))
        slot = fused.WireSlot(meta, pinned=False)
    assert slot.nbytes == slot.buf.numel()
    for grid, key in zip(slot.grids, fused.CoefBatchAssembly.PLANES):
        r, c = meta[key].shape[:2]
        assert grid.shape[0] > r and grid.shape[1] > c  # padding to check
        np.testing.assert_array_equal(grid[:r, :c], meta[key])
        assert not grid[r:].any() and not grid[:, c:].any()
    np.testing.assert_array_equal(slot.q, np.stack([meta["lq"], meta["cq"]]))


def test_dict_batch_uploads_its_real_images_slots():
    """A batch of three dicts (bucket 4) stages three slots and uploads
    their bytes alone; the device wire holds zeros in the padding image."""
    metas = _metas(420, 3)
    asm = fused.make_assembly([_plan("w=40&h=30")] * 3, metas, ["coef"] * 3,
                              CPU)
    assert asm.b == 4 and len(asm.wires) == 3
    assert [w.meta for w in asm.wires] == metas
    assert asm.upload_bytes == 3 * asm.wires[0].nbytes
    *grids, q = asm.device_wire()
    for grid, host in zip(grids, asm.host_grids()):
        np.testing.assert_array_equal(grid.numpy(), host)
    np.testing.assert_array_equal(q.numpy(), asm.q)
    assert not q[3:].any()


def test_batcher_counts_prestaged_images_and_sheds_a_cancelled_one():
    """Images fed only prestaged: `prestaged` counts each, and they
    answer as a batch staged from dicts does; a prestaged entry whose
    request was cancelled is shed before staging and counted as shed,
    with nothing left to hand back."""
    metas = _metas(420, 3)
    plan = _plan("w=40&h=30")
    want = fused.make_assembly([plan] * 3, metas, ["coef"] * 3, CPU).run()
    b = MicroBatcher(max_batch=4, window_ms=50.0, device=CPU)
    try:
        staged = [b.prestage(m) for m in metas]
        assert all(isinstance(s, fused.WireSlot) for s in staged)
        s0 = dict(b.stats)
        futs = [b.submit(plan, s, "coef") for s in staged]
        got = [f.result(timeout=60) for f in futs]
        s1 = dict(b.stats)
        cancel = threading.Event()
        cancel.set()
        tok = REQUEST_CANCEL.set(cancel)
        try:
            fut = b.submit(plan, b.prestage(metas[0]), "coef")
        finally:
            REQUEST_CANCEL.reset(tok)
        for _ in range(200):
            if fut.done():
                break
            threading.Event().wait(0.05)
        assert fut.cancelled()
        s2 = dict(b.stats)
    finally:
        assert b.close()
    assert s1["images"] - s0["images"] == 3
    assert s1["prestaged"] - s0["prestaged"] == 3
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, w)
    assert s2["shed_cancelled"] - s1["shed_cancelled"] == 1
    assert (s2["images"], s2["prestaged"]) == (s1["images"], s1["prestaged"])


CAMERA = ["w=640&h=480", "w=750&h=563", "w=828&h=621", "w=1080&h=810",
          "w=1200&h=900"]


def test_camera_plans_cycle_without_rebuilds_or_uploads():
    """The five srcset plans of a 12 MP source, 20 rounds through the
    assembly: each padded set is built once and each matrix uploaded
    once, though the host cache cannot hold all five (119.5 MiB)."""
    plan_mod._UNIFORM_CACHE.clear()
    fused._RESIDENT.clear()
    plans = [plan_mod.plan_image(4032, 3024, parse_query(q), opaque=True)
             for q in CAMERA]
    img = np.zeros((3024, 4032, 3), np.uint8)
    asms = [fused.BatchAssembly([p], [img], CPU) for p in plans]
    with profiling.tally() as counts:
        for _ in range(20):
            for asm in asms:
                mats = asm.uniform_matrices()
                assert mats[2] is None and mats[3] is None  # no blur
    assert counts["plan_rebuilds"] == 5
    assert counts["pageable_uploads"] == 5 * 3  # av, ah and the bands
    assert fused._RESIDENT.bytes > plan_mod._UNIFORM_CACHE.max_bytes


def test_plan_rebuilt_with_equal_content_hits_the_device_copy():
    params = parse_query("w=97&h=61&blur=2")
    a = plan_mod._plan_image_uncached(300, 200, params, filters.LANCZOS3, True)
    b = plan_mod._plan_image_uncached(300, 200, params, filters.LANCZOS3, True)
    c = plan_mod._plan_image_uncached(300, 200, parse_query(
        "w=97&h=61&blur=2&crop=true"), filters.LANCZOS3, True)
    assert a is not b and a.matrix_key == b.matrix_key != c.matrix_key
    with profiling.tally() as counts:
        first = fused._uniform_device(a, CPU)
    assert counts["pageable_uploads"] == 5  # av, ah, bv, bh, bands
    with profiling.tally() as counts:
        again = fused._uniform_device(b, CPU)
        fused._uniform_device(a, CPU)
    assert counts == {}
    assert all(x is y for x, y in zip(first, again))
    with profiling.tally() as counts:
        fused._uniform_device(c, CPU)
    assert counts["pageable_uploads"] == 5


def test_stalled_batch_forgets_its_slots_and_the_mirror_reads_them(
        monkeypatch):
    """A prestaged batch whose collect hangs past the stall bound: the
    mirror serves it from the stalled batch's own slots (the bytes the
    device path gives, within the mirror's 1 LSB), which the stuck call
    keeps alive as long as it holds them."""
    meta, = _metas(420, 1)
    plan = _plan("w=40&h=30")
    want = fused.make_assembly([plan], [meta], ["coef"], CPU).run()[0]
    back, stuck = threading.Event(), threading.Event()
    real_collect = fused.CoefBatchAssembly.collect
    real_run_host = hostexec.run_host
    mirrored = []

    def wedged_collect(self, out):
        stuck.set()
        assert back.wait(30.0)
        return real_collect(self, out)

    def run_host(asm):
        mirrored.append(list(asm.wires))
        return real_run_host(asm)

    b = MicroBatcher(max_batch=2, window_ms=1.0, device=CPU,
                     host_fallback=True, device_stall_s=0.3)
    monkeypatch.setattr(fused.CoefBatchAssembly, "collect", wedged_collect)
    monkeypatch.setattr(hostexec, "run_host", run_host)
    try:
        slot = b.prestage(meta)
        fut = b.submit(plan, slot, "coef")
        got = fut.result(timeout=20.0)
        assert stuck.is_set() and getattr(fut, "fanlin_host_mirror", False)
        assert int(np.abs(got.astype(np.int16) - want.astype(np.int16))
                   .max()) <= 1
        assert mirrored == [[slot]]
        assert b.stats["prestaged"] == 1
    finally:
        back.set()
        b.close()


@pytest.fixture
def staging():
    """An Engine serving through a CPU micro-batcher, as the server's
    does, its runner recording what it was asked to stage and to run."""
    b = MicroBatcher(max_batch=4, window_ms=1.0, device=CPU)
    runner = BatchingRunner(b)
    runner.staged, runner.ran = [], []
    prestage, run = runner.prestage, runner.run

    def record_prestage(meta):
        runner.staged.append(meta)
        return prestage(meta)

    def record_run(plans, images, kinds=None):
        runner.ran.extend(images)
        return run(plans, images, kinds)

    runner.prestage, runner.run = record_prestage, record_run
    try:
        yield Engine(CPU, runner=runner)
    finally:
        assert b.close()


def _answer(engine, data, qs="w=40&h=30"):
    """What the engine answers: (mime, body), or its ProcessError's text
    (object addresses left out)."""
    try:
        return engine.process_image(data, parse_query(qs), Format())
    except ProcessError as e:
        return re.sub(r" at 0x[0-9a-f]+", "", str(e))


def _source(kind):
    img = make_test_image(75, 37, seed=5)
    if kind == "rotated":
        return _oriented_jpeg(6)
    buf = io.BytesIO()
    if kind == "gray":
        Image.fromarray(img).convert("L").save(buf, "JPEG", quality=85)
    else:
        Image.fromarray(img).save(buf, "JPEG", quality=85, subsampling=1,
                                  progressive=kind == "progressive")
    return buf.getvalue()


@pytest.mark.parametrize("kind,route", [
    ("plain", "slot"), ("gray", "slot"), ("progressive", "slot"),
    ("rotated", "dict"), ("plain", "cached"), ("plain", "no_prestage")])
def test_engine_routes_a_jpeg(staging, kind, route):
    """The slot route where the runner stages, the orientation is 1 and
    there is no source cache; else the dict route (its dict staged, or
    sent as it is to a runner that does not stage). Each answers as an
    Engine on its own runner (the dict route) does."""
    data = _source(kind)
    want = _answer(Engine(CPU), data)
    engine = Engine(CPU) if route == "no_prestage" else staging
    if route == "cached":
        engine.source_cache = SourceCache(8)
    assert _answer(engine, data) == want
    assert engine.stats == {"pixel_src": 0, "coef_src": 1}
    # the reader decoded it once on either route: 10 scans in PIL's
    # progressive script, one in a baseline stream
    stats = dict(engine.read_stats)
    assert stats.pop("read_ms_total") > 0
    assert stats == {"slot_reads": int(route == "slot"), "reads": 1,
                     "progressive_reads": int(kind == "progressive"),
                     "read_scans_total": 10 if kind == "progressive" else 1}
    if route == "no_prestage":
        return
    runner = engine.runner
    staged, = runner.staged
    ran, = runner.ran
    assert isinstance(ran, fused.WireSlot)
    assert runner.batcher.stats["prestaged"] == 1
    if route == "slot":
        # the reader wrote the slot of the stream's header
        assert isinstance(staged, jpeg_coeffs.Header)
        assert ran.meta["gray"] == (kind == "gray")
        assert ran.meta["y"].base is not None  # a view of the slot
    else:
        assert isinstance(staged, dict) and ran.meta is staged


@pytest.mark.parametrize("kind", ["arithmetic", "12bit", "cmyk", "dht_less"])
def test_refused_stream_takes_the_pixel_path(staging, kind):
    """A stream the reader refuses answers as the dict route does: from
    its header (no slot made) or inside its scans (DHT-less: its slot
    made, then dropped)."""
    data = _refused(kind)
    assert _answer(staging, data) == _answer(Engine(CPU), data)
    assert staging.read_stats == NO_READS
    assert staging.stats["coef_src"] == 0
    runner = staging.runner
    assert [type(x) for x in runner.staged] == (
        [jpeg_coeffs.Header] if kind == "dht_less" else [])
    assert not any(isinstance(x, fused.WireSlot) for x in runner.ran)


def test_slot_route_without_pinned_memory_sends_the_dict(staging,
                                                         monkeypatch):
    """No pinned memory to be had: the batcher hands the header back and
    the engine sends the read_jpeg_coeffs dict, which the device thread
    stages, as before."""
    data = _source("plain")
    want = _answer(Engine(CPU), data)

    def no_memory(*a, **k):
        raise RuntimeError("out of pinned memory")

    monkeypatch.setattr(fused.WireSlot, "empty", no_memory)
    assert _answer(staging, data) == want
    ran, = staging.runner.ran
    assert isinstance(ran, dict) and ran["w"] == 75
    # read once, by the dict reader
    stats = dict(staging.read_stats)
    assert stats.pop("read_ms_total") > 0
    assert stats == {"slot_reads": 0, "reads": 1, "progressive_reads": 0,
                     "read_scans_total": 1}
    assert staging.runner.batcher.stats["prestaged"] == 0
