"""Coefficient wires staged before they reach a batch, and the padded plan
matrices kept on the device by content (fanlin_tpu_torch/ops/fused.py
`WireSlot`, `WireSlotPool`, `_uniform_device`; engine/batcher.py
`prestage`), on the CPU.

A batch made from pooled slots gives the same bytes as the same batch
staged on the device thread, at 4:2:0 and 4:4:4 and at n = 1, 3 (bucket
4) and 8, and the host mirror reads the same grids from it; a slot is
not handed out again before its batch's upload is done; an image that
finds no free slot is staged on the device thread and not counted in
`prestaged`; cycling the five camera srcset plans rebuilds each once and
uploads each once; a plan rebuilt with equal content finds its device
copy."""

import io
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from fanlin_tpu_torch.engine.batcher import REQUEST_CANCEL, MicroBatcher
from fanlin_tpu_torch.engine.jpeg_coeffs import read_jpeg_coeffs
from fanlin_tpu_torch.ops import filters, fused, hostexec
from fanlin_tpu_torch.ops import plan as plan_mod
from fanlin_tpu_torch.spec.query import parse_query
from fanlin_tpu_torch.utils import profiling
from tests.conftest import make_test_image

CPU = torch.device("cpu")

# PIL's subsampling argument: 2 is 4:2:0, 0 is 4:4:4
LAYOUTS = {420: 2, 444: 0}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _metas(subsamp, n, w=72, h=50):
    """n read_jpeg_coeffs metas of distinct w x h JPEGs of one layout."""
    out = []
    for i in range(n):
        img = np.roll(make_test_image(w, h), 7 * i, axis=1)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=85,
                                  subsampling=LAYOUTS[subsamp])
        meta = read_jpeg_coeffs(buf.getvalue())
        assert meta is not None and meta["subsamp"] == subsamp
        out.append(meta)
    return out


def _plan(qs, w=72, h=50):
    return plan_mod.plan_image(w, h, parse_query(qs), opaque=True)


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("subsamp", [420, 444])
@pytest.mark.parametrize("sink", ["rgb", "jpeg420"])
def test_slot_batch_equals_device_thread_staging(subsamp, n, sink):
    metas = _metas(subsamp, n)
    plans = [_plan("w=40&h=30")] * n
    pool = fused.WireSlotPool(CPU, per_geometry=n)
    slots = [pool.stage(m) for m in metas]
    assert all(isinstance(s, fused.WireSlot) for s in slots)
    kind = "coef" if subsamp == 420 else "coef444"
    kinds = [kind if sink == "rgb" else f"{kind}+{sink}"] * n
    want = fused.make_assembly(plans, metas, kinds, CPU)
    got = fused.make_assembly(plans, slots, kinds, CPU)
    assert got.slots == slots and got.b == plan_mod.bucket_b(n)
    # the real images' slots alone cross the link
    assert got.upload_bytes == n * slots[0].nbytes
    assert want.upload_bytes == want.b * slots[0].nbytes
    for a, b in zip(got.run(), want.run()):
        if isinstance(a, tuple):
            assert a[0] == b[0]
            for x, y in zip(a[1:], b[1:]):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("subsamp", [420, 444])
def test_mixed_batch_and_folded_route_equal_device_thread_staging(subsamp):
    """Some images staged in slots and some not; the folded route (which
    reads the bucket's padding images too) and a non-uniform batch."""
    metas = _metas(subsamp, 3)
    pool = fused.WireSlotPool(CPU, per_geometry=4)
    payloads = [pool.stage(metas[0]), metas[1], pool.stage(metas[2])]
    kind = "coef" if subsamp == 420 else "coef444"
    p1, p2 = _plan("w=40&h=30"), _plan("w=31&h=22&blur=1")
    for plans, k in (([p1] * 3, kind), ([p1] * 3, kind + fused.FOLD_SUFFIX),
                     ([p1, p2, p1], kind)):
        want = fused.make_assembly(plans, metas, [k] * 3, CPU).run()
        asm = fused.make_assembly(plans, payloads, [k] * 3, CPU)
        assert asm.slots == [payloads[0], payloads[2]]
        for a, b in zip(asm.run(), want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("subsamp", [420, 444])
def test_host_grids_and_mirror_of_a_slot_batch(subsamp):
    metas = _metas(subsamp, 3)
    plans = [_plan("w=40&h=30")] * 3
    pool = fused.WireSlotPool(CPU, per_geometry=3)
    kind = "coef" if subsamp == 420 else "coef444"
    want = fused.make_assembly(plans, metas, [kind] * 3, CPU)
    got = fused.make_assembly(plans, [pool.stage(m) for m in metas],
                              [kind] * 3, CPU)
    for a, b in zip(got.host_grids(), want.host_grids()):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.q, want.q)
    for a, b in zip(hostexec.run_host(got), hostexec.run_host(want)):
        np.testing.assert_array_equal(a, b)


def test_slot_is_not_handed_out_before_its_release():
    """A slot stays out of the pool from its staging until `release`
    (what the collect side does once the batch's upload has finished);
    a reuse at the same geometry rewrites only its true grids, over a
    padding still zero."""
    a, b = _metas(420, 2)
    pool = fused.WireSlotPool(CPU, per_geometry=1)
    slot = pool.stage(a)
    assert pool.stage(b) is None  # the only slot is out
    asm = fused.make_assembly([_plan("w=40&h=30")], [slot], ["coef"], CPU)
    asm.run()
    assert pool.stage(b) is None  # run, not yet handed back
    pool.release(asm.slots)
    pool.release(asm.slots)  # a second release changes nothing
    again = pool.stage(b)
    assert again is slot and again.meta is b
    assert pool.stage(a) is None
    for grid, key in zip(again.grids, fused.WireSlot.PLANES):
        r, c = b[key].shape[:2]
        np.testing.assert_array_equal(grid[:r, :c], b[key])
        assert not grid[r:].any() and not grid[:, c:].any()
    # a discarded slot is forgotten: the pool makes a new one
    pool.discard([again])
    fresh = pool.stage(a)
    assert fresh is not None and fresh is not again


def test_pool_byte_cap_drops_free_slots_of_other_geometries():
    small, = _metas(420, 1)
    big, = _metas(420, 1, w=200, h=150)
    size = fused.WireSlotPool(CPU, 1)._slot_bytes(fused.wire_geometry(big))
    pool = fused.WireSlotPool(CPU, per_geometry=2, max_bytes=size + 1)
    s1 = pool.stage(small)
    assert pool.stage(big) is None  # the small slot is out: no room
    pool.release([s1])
    s2 = pool.stage(big)  # the free small slot is dropped for it
    assert s2 is not None and pool.bytes == size


def _grid_meta(w, h):
    """A 4:4:4 read_jpeg_coeffs-shaped dict of w x h with zero grids."""
    grid = np.zeros((-(-h // 8), -(-w // 8), 64), np.int16)
    q = np.ones(64, np.uint16)
    return {"y": grid, "cb": grid, "cr": grid, "lq": q, "cq": q,
            "w": w, "h": h, "subsamp": 444, "gray": False}


def test_pool_records_stay_bounded_over_many_source_sizes():
    """Sources of many sizes leave a record only for the geometries that
    still have a slot alive: discarded ones leave none, and released
    ones at most what the byte cap holds, the least recently used
    dropped first."""
    metas = [_grid_meta(40 + 8 * i, 24 + 8 * i) for i in range(60)]
    pool = fused.WireSlotPool(CPU, per_geometry=2)
    for m in metas:
        pool.discard([pool.stage(m)])
    assert not pool._shelves and pool.bytes == 0
    cap = 4 * pool._slot_bytes(fused.wire_geometry(metas[-1]))
    most = cap // pool._slot_bytes(fused.wire_geometry(metas[0]))
    pool = fused.WireSlotPool(CPU, per_geometry=2, max_bytes=cap)
    for _ in range(3):
        for m in metas:
            slot = pool.stage(m)
            assert slot is not None
            pool.release([slot])
            assert len(pool._shelves) <= most and pool.bytes <= cap
    assert all(f.made == 1 == len(f.free) for f in pool._shelves.values())
    last = [fused.wire_geometry(m) for m in metas[-len(pool._shelves):]]
    assert list(pool._shelves) == last
    assert pool.bytes == sum(pool._slot_bytes(g) for g in last)


def test_batcher_falls_back_when_no_slot_is_free():
    """Three images of one geometry against a pool of one slot: the
    first is prestaged, the others are staged on the device thread; all
    three answer as a batch staged wholly on the device thread does, the
    counter counts one, and the slot is back once its batch is
    collected."""
    metas = _metas(420, 3)
    plan = _plan("w=40&h=30")
    want = fused.make_assembly([plan] * 3, metas, ["coef"] * 3, CPU).run()
    b = MicroBatcher(max_batch=4, window_ms=50.0, device=CPU)
    b._slots.per_geometry = 1
    try:
        staged = [b.prestage(m) for m in metas]
        assert staged[0] is not None and staged[1:] == [None, None]
        s0 = dict(b.stats)
        futs = [b.submit(plan, s if s is not None else m, "coef")
                for s, m in zip(staged, metas)]
        got = [f.result(timeout=60) for f in futs]
        s1 = dict(b.stats)
    finally:
        assert b.close()
    assert s1["images"] - s0["images"] == 3
    assert s1["prestaged"] - s0["prestaged"] == 1
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, w)
    assert b._slots.stage(metas[0]) is staged[0]


def test_batcher_hands_back_slots_of_shed_and_refused_entries():
    meta, = _metas(420, 1)
    plan = _plan("w=40&h=30")
    b = MicroBatcher(max_batch=4, window_ms=5.0, device=CPU)
    b._slots.per_geometry = 1
    try:
        slot = b.prestage(meta)
        cancel = threading.Event()
        cancel.set()
        tok = REQUEST_CANCEL.set(cancel)
        try:
            fut = b.submit(plan, slot, "coef")
        finally:
            REQUEST_CANCEL.reset(tok)
        for _ in range(200):
            if fut.done():
                break
            threading.Event().wait(0.05)
        assert fut.cancelled()
        assert b.prestage(meta) is slot  # shed before staging: back
    finally:
        assert b.close()
    with pytest.raises(RuntimeError):
        b.submit(plan, slot, "coef")  # closed: refused, handed back
    assert slot.state == "free"


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
    mirror serves it from the slots (the bytes the device path gives,
    within the mirror's 1 LSB), the pool forgets them, and the stuck
    call's late return does not hand them back for reuse."""
    meta, = _metas(420, 1)
    plan = _plan("w=40&h=30")
    want = fused.make_assembly([plan], [meta], ["coef"], CPU).run()[0]
    back, stuck = threading.Event(), threading.Event()
    real_collect = fused.CoefBatchAssembly.collect

    def wedged_collect(self, out):
        stuck.set()
        assert back.wait(30.0)
        return real_collect(self, out)

    b = MicroBatcher(max_batch=2, window_ms=1.0, device=CPU,
                     host_fallback=True, device_stall_s=0.3)
    b._slots.per_geometry = 1
    monkeypatch.setattr(fused.CoefBatchAssembly, "collect", wedged_collect)
    try:
        slot = b.prestage(meta)
        fut = b.submit(plan, slot, "coef")
        got = fut.result(timeout=20.0)
        assert stuck.is_set() and getattr(fut, "fanlin_host_mirror", False)
        assert int(np.abs(got.astype(np.int16) - want.astype(np.int16))
                   .max()) <= 1
        assert slot.state == "gone"
        assert b.stats["prestaged"] == 1
    finally:
        back.set()
        b.close()
    assert slot.state == "gone"
    fresh = b._slots.stage(meta)  # the forgotten slot is not reused
    assert fresh is not None and fresh is not slot
