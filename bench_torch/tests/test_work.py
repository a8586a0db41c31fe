"""The benchmark's copies of the yardstick: its work functions equal
chip_smoke.py's at the README and 12 MP shapes, and its Lanczos3
weights and geometry equal the port's plans (a check of the copy, not
a dependency: the harness imports neither)."""

import importlib.util

import numpy as np
import pytest

from harness import cell, imaging, peaks

SHAPES = [(512, 512, 444, "w=300&h=200")] + [
    (4032, 3024, 420, q["query"])
    for q in cell.load_json("traffic", "camera-srcset-closed")["queries"]]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", cell.REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("w,h,subsamp,query", SHAPES)
def test_resample_work_equals_chip_smoke(smoke, w, h, subsamp, query):
    work = cell.load_module("work", "resample")
    geo = imaging.geometry(w, h, query)
    av, ah = geo.weights()
    crop = (geo.out_h, geo.out_w)
    mine = work.resample_work(av, ah, crop, 3)
    theirs = smoke.resample_work(av, ah, None, None, crop, 3)
    for k in ("flop", "tf32_flop", "nbytes"):
        assert mine[k] == theirs[k]
    b = work.least(geo, {"w": w, "h": h, "subsamp": subsamp}, peaks)
    ms, by = smoke.resample_bound(theirs)
    assert b["bound_s"] * 1e3 == pytest.approx(ms, rel=1e-12)
    assert b["bound_by"] == by


@pytest.mark.parametrize("w,h,subsamp,query", SHAPES)
def test_decode_work_equals_chip_smoke(smoke, w, h, subsamp, query):
    work = cell.load_module("work", "jpeg_decode_rgb")
    geo = imaging.geometry(w, h, query)
    b = work.least(geo, {"w": w, "h": h, "subsamp": subsamp}, peaks)
    theirs = smoke.decode_bound(w, h, subsamp, 1, 1, h, w)
    assert b["bytes"] == theirs["bytes"]
    assert b["bound_s"] * 1e3 == pytest.approx(theirs["bound_ms"], rel=1e-12)
    assert b["bound_by"] == theirs["bound_by"]
    for n, bb, sh, sw in ((8, 8, 512, 512), (5, 8, 3072, 4096)):
        mine = work.decode_work(w, h, subsamp, n, bb, sh, sw)
        theirs = smoke.decode_bound(w, h, subsamp, n, bb, sh, sw)
        assert mine["bytes"] == theirs["bytes"]
        assert mine["int32_ops"] == theirs["int32_ops"]


def test_peaks_equal_chip_smoke(smoke):
    assert peaks.HBM_BYTES_PER_S == smoke.HBM_BYTES_PER_S
    assert peaks.TF32_FLOP_PER_S == smoke.TF32_FLOP_PER_S
    assert peaks.BF16_FLOP_PER_S == smoke.BF16_FLOP_PER_S
    assert peaks.INT32_OPS_PER_S == smoke.INT32_OPS_PER_S
    assert peaks.F32_UNFUSED_OPS_PER_S == smoke.F32_UNFUSED_OPS_PER_S


@pytest.mark.parametrize("w,h,subsamp,query", SHAPES)
def test_weights_and_geometry_equal_the_ports_plan(w, h, subsamp, query):
    from fanlin_tpu_torch.ops import filters, plan
    from fanlin_tpu_torch.spec.query import parse_query

    p = plan.plan_image(w, h, parse_query(query), filters.LANCZOS3,
                        opaque=True)
    geo = imaging.geometry(w, h, query)
    av, ah = geo.weights()
    assert (geo.out_h, geo.out_w) == (p.out_h, p.out_w)
    assert geo.canvas == p.use_canvas
    assert (geo.x0, geo.y0, geo.rw, geo.rh) == tuple(p.box)
    assert np.array_equal(av, p.av) and np.array_equal(ah, p.ah)
    assert tuple(geo.fill) == tuple(p.fill)
