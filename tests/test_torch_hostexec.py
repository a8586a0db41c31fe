"""The port's host mirror (fanlin_tpu_torch.ops.hostexec) on the CPU.

On the same seeded inputs, `run_host` of the port's assembly against
`fanlin_tpu.ops.hostexec.run_host` of the JAX package's assembly, and
against the port's own CPU path (the kernels' plain versions), for every
source and sink kind: pixels with and without alpha, uniform and
per-image matrices, blur, the YCbCr 4:2:0, WebP, PNG (3 and 4 channels)
and jpegdct sinks, JPEG coefficients 4:4:4, 4:2:0 and 4:2:2, and CMYK /
YCCK.

Tolerances: against the JAX mirror at most 1 LSB; against the port's
CPU path at most 1 LSB and at most 0.5 % of bytes differing (PARITY.md
known-diff #6: the resample sums run in another order). The decoded
planes of coefficient and CMYK batches equal `jpeg_decode_rgb_ref` and
`jpeg_decode_cmyk_rgb_ref` array for array. jpegdct coefficients: the
mirror's DCT on the port's own planes differs from the port's fixed-order
DCT only at quantisation ties (as in tests/test_torch_dct.py).
"""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from fanlin_tpu.engine import native_codecs
from fanlin_tpu.ops import fused as jfused
from fanlin_tpu.ops import hostexec as jhostexec
from fanlin_tpu.spec.query import parse_query as jparse_query
from fanlin_tpu_torch.engine import icc as ticc
from fanlin_tpu_torch.engine.jpeg_coeffs import (read_jpeg_coeffs,
                                                 read_jpeg_coeffs4)
from fanlin_tpu_torch.engine.png_writer import write_png
from fanlin_tpu_torch.ops import cmyk_lut as tlut
from fanlin_tpu_torch.ops import dct as tdct
from fanlin_tpu_torch.ops import filters as tfilters
from fanlin_tpu_torch.ops import fused as tfused
from fanlin_tpu_torch.ops import host_decode, hostexec
from fanlin_tpu_torch.ops import jpeg_decode_kernels as jk
from fanlin_tpu_torch.ops import plan as tplan
from fanlin_tpu_torch.spec.query import parse_query
from tests.conftest import make_test_image
from tests.test_torch_dct import _differ_at_ties_only, _exact_quotients
from tests.test_torch_icc import adobe_ycck, cmyk_jpeg, make_cmyk_profile

CPU = torch.device("cpu")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
W, H = 160, 120


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _img(seed, alpha=None):
    base = make_test_image(W, H, seed=seed)
    if alpha is None:
        return base
    a = np.random.default_rng(seed).integers(0, 256, (H, W), dtype=np.uint8)
    if alpha == "opaque":
        a[:] = 255
    return np.dstack([base, a])


def _arrays(res):
    """The arrays of one collect() result, in order; PNG filter rows as
    the pixels they encode (a pixel 1 LSB apart changes its filtered
    byte by 255 mod 256, and may change its row's filter)."""
    if isinstance(res, tuple) and res[0] == "pngrows":
        png = write_png(res[1], res[2], res[3], res[4], 75)
        with Image.open(io.BytesIO(png)) as im:
            return [np.asarray(im)]
    if isinstance(res, tuple):
        return [x for x in res[1:] if isinstance(x, np.ndarray)]
    return [res]


def _meta(res):
    """The non-array fields of one collect() result."""
    if isinstance(res, tuple):
        return [x for x in res if not isinstance(x, np.ndarray)]
    return []


def _close(got, want, max_lsb=1, max_frac=None):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _meta(g) == _meta(w)
        for a, b in zip(_arrays(g), _arrays(w)):
            assert a.shape == b.shape and a.dtype == b.dtype, (a.shape,
                                                              b.shape)
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert int(d.max(initial=0)) <= max_lsb
            if max_frac is not None:
                assert float((d > 0).mean()) <= max_frac


def _both(queries, images, jpeg420=False):
    """The port's and the JAX package's pixel assemblies of one batch:
    one plan per (distinct) query, shared by the images that use it."""
    opaque = all(im.shape[2] == 3 for im in images)
    tplans = {q: tplan.plan_image(W, H, parse_query(q), opaque=opaque)
              for q in set(queries)}
    jplans = {q: jfused.plan_image(W, H, jparse_query(q), opaque=opaque)
              for q in set(queries)}
    tasm = tfused.BatchAssembly([tplans[q] for q in queries], images, CPU,
                                jpeg420=jpeg420)
    if isinstance(jpeg420, tuple) and jpeg420[0] == "jpegdct":
        jasm = jfused.BatchAssembly([jplans[q] for q in queries], images,
                                    jpeg420=True, jpegdct=True,
                                    quality=jpeg420[1])
    else:
        jasm = jfused.BatchAssembly([jplans[q] for q in queries], images,
                                    jpeg420=jpeg420)
    return tasm, jasm


PIXEL_CASES = {
    "uniform": (["w=100&h=80"] * 2, (None, None)),
    "uniform_gray": (["w=100&h=80&grayscale=true"] * 2, (None, None)),
    "uniform_invert_crop": (["w=64&h=64&crop=true&inverse=true"] * 2,
                            (None, None)),
    "uniform_canvas": (["w=300&h=200&rgb=5,6,7"] * 2, (None, None)),
    "uniform_blur": (["w=60&h=40&blur=1"] * 2, (None, None)),
    "nonuniform": (["w=100&h=80", "w=90&h=70&grayscale=true",
                    "w=100&h=80&rgb=9,9,9"], (None, None, None)),
    "nonuniform_blur": (["w=100&h=80&blur=2", "w=96&h=80"], (None, None)),
    "alpha_canvas": (["w=300&h=200&rgb=9,9,9"], ("noise",)),
    "alpha_uniform": (["w=100&h=80"] * 2, ("noise", "noise")),
    "alpha_mixed_nonuniform": (["w=100&h=80", "w=80&h=100&rgb=1,2,3"],
                               ("noise", None)),
    "alpha_blur": (["w=70&h=50&blur=2"], ("noise",)),
}


@pytest.mark.parametrize("case", sorted(PIXEL_CASES))
def test_pixel_batches(case):
    queries, alphas = PIXEL_CASES[case]
    images = [_img(i + 1, a) for i, a in enumerate(alphas)]
    tasm, jasm = _both(queries, images)
    assert tasm.uniform == jasm.uniform
    got = hostexec.run_host(tasm)
    _close(got, jhostexec.run_host(jasm))
    _close(got, tasm.run(), max_frac=0.005)


SINKS = {"jpeg420": True, "webp": "webp", "png3": ("png", 3),
         "png4": ("png", 4), "png1": ("png", 1)}


@pytest.mark.parametrize("sink", sorted(SINKS))
@pytest.mark.parametrize("qs", ["w=100&h=80", "w=99&h=77&rgb=4,5,6&blur=1",
                                "w=101&h=81&grayscale=true"])
def test_sink_batches(sink, qs):
    alpha = "noise" if sink == "png4" else None
    images = [_img(3, alpha), _img(4, alpha)]
    tasm, jasm = _both([qs, qs], images, jpeg420=SINKS[sink])
    got = hostexec.run_host(tasm)
    _close(got, jhostexec.run_host(jasm))
    _close(got, tasm.run(), max_frac=0.005)


@pytest.mark.parametrize("quality", [50, 75, 95])
def test_jpegdct_sink(quality):
    """The jpegdct sink: equal to the JAX mirror; against the port's
    CPU path, its YCbCr planes within the chain's tolerance, and the DCT
    on identical planes differing only at quantisation ties."""
    qs = "w=100&h=80"
    images = [_img(5), _img(6)]
    tasm, jasm = _both([qs, qs], images, jpeg420=("jpegdct", quality))
    got = hostexec.run_host(tasm)
    _close(got, jhostexec.run_host(jasm))
    assert [r[4:] for r in got] == [r[4:] for r in tasm.run()]
    planes_asm, _ = _both([qs, qs], images, jpeg420=True)
    planes = hostexec.run_host(planes_asm)
    _close(planes, planes_asm.run(), max_frac=0.005)
    y, cb, cr = (np.stack([p[i] for p in planes]) for i in (1, 2, 3))
    mirror = hostexec._np_dct_tail(y, cb, cr, quality)
    card = tdct.ycbcr420_to_planar(
        *(torch.from_numpy(p) for p in (y, cb, cr)),
        *tdct.ijg_quant_tables(quality))
    for m, c, plane, mult, tab in zip(mirror, card, (y, cb, cr), (16, 8, 8),
                                      tdct.ijg_quant_tables(quality)):
        exact = tdct.blocks_from_planar(_exact_quotients(plane, mult, tab))
        _differ_at_ties_only(m, tdct.blocks_from_planar(c.numpy()), exact)
    for i, r in enumerate(got):
        for k in range(3):
            np.testing.assert_array_equal(r[1 + k], mirror[k][i])


def _golden(name):
    with open(os.path.join(GOLDEN, f"{name}_src.jpg"), "rb") as f:
        return f.read()


def _jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


COEF_SOURCES = {
    "lenna444": lambda: _golden("lenna"),
    "synth420": lambda: _golden("synth"),
    "pil420_odd": lambda: _jpeg(make_test_image(101, 83, seed=3), quality=85,
                                subsampling=2),
    "pil422": lambda: _jpeg(make_test_image(101, 83, seed=4), quality=85,
                            subsampling=1),
}
KIND = {420: "coef", 422: "coef422", 440: "coef440", 444: "coef444"}


def _coef_planes(asm):
    """jpeg_decode_rgb_ref of the assembly's wire, for its real
    images."""
    n = len(asm.plans)
    grids = [torch.from_numpy(g) for g in asm.host_grids()]
    return jk.jpeg_decode_rgb_ref(*grids, torch.from_numpy(asm.q),
                                  asm.subsamp, asm.true_h, asm.true_w,
                                  asm.sh, asm.sw, n).numpy()[:n]


@pytest.mark.parametrize("qs", ["w=300&h=200", "w=64&h=48&blur=2",
                                "w=120&h=90&rgb=1,2,3&inverse=true"])
@pytest.mark.parametrize("src", sorted(COEF_SOURCES))
def test_coef_batches(src, qs):
    data = COEF_SOURCES[src]()
    meta = read_jpeg_coeffs(data)
    kind = KIND[meta["subsamp"]]
    plan = tplan.plan_image(meta["w"], meta["h"], parse_query(qs),
                            opaque=True)
    tasm = tfused.make_assembly([plan, plan], [meta, meta], [kind] * 2, CPU)
    np.testing.assert_array_equal(hostexec.decode_coef(tasm),
                                  _coef_planes(tasm))
    got = hostexec.run_host(tasm)
    _close(got, tasm.run(), max_frac=0.005)
    if src.startswith("pil422") or not native_codecs.available():
        return  # the JAX package's coefficient wire: 4:2:0 / 4:4:4 here
    jmeta = native_codecs.read_jpeg_coeffs(data)
    jplan = jfused.plan_image(meta["w"], meta["h"], jparse_query(qs),
                              opaque=True)
    jasm = jfused.CoefBatchAssembly([jplan, jplan], [jmeta, jmeta])
    _close(got, jhostexec.run_host(jasm))


def test_coef_sink_and_fold_batches():
    """A coefficient batch with a device encode front-end, and a folded
    (fast_decode) and a bf16 (fast) one: the mirror serves the last two
    with the exact decode and f32 products, the default route's bytes."""
    meta = read_jpeg_coeffs(_golden("lenna"))
    plan = tplan.plan_image(meta["w"], meta["h"], parse_query("w=300&h=200"),
                            opaque=True)
    asm = tfused.make_assembly([plan], [meta], ["coef444+png:3"], CPU)
    _close(hostexec.run_host(asm), asm.run(), max_frac=0.005)
    exact = tfused.make_assembly([plan], [meta], ["coef444"], CPU)
    want = hostexec.run_host(exact)
    for kind, fast in (("coef444-fold", False), ("coef444", True)):
        asm = tfused.make_assembly([plan], [meta], [kind], CPU, fast=fast)
        assert asm.fold or asm.fast
        _close(hostexec.run_host(asm), want, max_lsb=0)


def _lut(seed=0):
    conv = ticc.CMYK2RGB.with_icc_profile(make_cmyk_profile(seed))
    return tlut.sample_lut(conv.convert, 17)


def _cmyk_source(name):
    data = cmyk_jpeg(120, 88, seed=1)
    if name == "cmyk444":
        return data
    if name == "ycck444":
        return adobe_ycck(data)
    arr = np.asarray(Image.open(io.BytesIO(data)))
    out = native_codecs.encode_jpeg_cmyk(255 - arr, 92, True)
    if out is None:
        pytest.skip("native codec core not built (YCCK 4:2:0 writer)")
    return out


@pytest.mark.parametrize("qs", ["w=60&h=44", "w=50&h=50&crop=true&blur=1"])
@pytest.mark.parametrize("name", ["cmyk444", "ycck444", "ycck420"])
def test_cmyk_batches(name, qs):
    data = _cmyk_source(name)
    lut = _lut()
    meta = read_jpeg_coeffs4(data)
    flat = np.ascontiguousarray(lut.reshape(-1, 3).astype(np.float32))
    meta.update(lut_flat=flat, lut_n=17, lut_key="")
    kind = "cmyk%d%s" % (meta["subsamp"], "y" if meta["ycck"] else "")
    plan = tplan.plan_image(meta["w"], meta["h"], parse_query(qs),
                            opaque=True)
    tasm = tfused.make_assembly([plan, plan], [meta, meta], [kind] * 2, CPU)
    grids = [torch.from_numpy(g) for g in tasm.host_grids()]
    want_planes = jk.jpeg_decode_cmyk_rgb_ref(
        *grids, torch.from_numpy(tasm.q), torch.from_numpy(flat), 17,
        tasm.subsamp, tasm.ycck, tasm.true_h, tasm.true_w, tasm.sh, tasm.sw,
        2).numpy()
    np.testing.assert_array_equal(hostexec.decode_coef(tasm), want_planes)
    got = hostexec.run_host(tasm)
    _close(got, tasm.run(), max_frac=0.005)
    jplan = jfused.plan_image(meta["w"], meta["h"], jparse_query(qs),
                              opaque=True)
    jasm = jfused.make_assembly([jplan, jplan], [meta, meta], [kind] * 2)
    _close(got, jhostexec.run_host(jasm))


def test_lut_planes_equals_the_plain_version():
    """The numpy LUT (the mirror's and convert_host's) equals the port's
    plain torch lut_planes on 200,000 seeded samples and the grid's
    edges."""
    rng = np.random.default_rng(3)
    flat = _lut(1).reshape(-1, 3).astype(np.float32)
    px = rng.integers(0, 256, (4, 200_000), dtype=np.uint8)
    px[:, :256] = np.arange(256, dtype=np.uint8)
    got = host_decode.lut_planes(*px, flat, 17)
    want = tlut.lut_planes(*(torch.from_numpy(p) for p in px),
                           torch.from_numpy(flat), 17)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_windowed_apply_matches_dense():
    """The windowed batched-GEMM applies reproduce the dense product for
    every matrix family the mirror uses, on both contraction sides
    (a twin of tests/test_cold_bucket.py::test_windowed_apply_matches_
    dense; the 8-tap block-diagonal family is the JAX decode's, which
    the port's mirror does not apply)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 384, 97)).astype(np.float32)
    xt = np.ascontiguousarray(np.swapaxes(x, 1, 2))  # (5, 97, 384)
    blockdiag = np.kron(np.eye(48, dtype=np.float32),
                        rng.standard_normal((8, 8)).astype(np.float32))
    for m in (
        tfilters.gaussian_matrix(384, 11.0),         # banded
        tfilters.resample_matrix(384, 384, tfilters.LANCZOS3),
        tfilters.resample_matrix(384, 120, tfilters.LANCZOS3),
        blockdiag,                                   # 8-tap blocks
        np.pad(tfilters.resample_matrix(384, 100, tfilters.LANCZOS3),
               ((30, 50), (0, 0))),
    ):
        mf = m.astype(np.float32)
        dense_r = np.einsum("os,bsw->bow", mf, x, optimize=True)
        win_r = hostexec._apply_rows(m, x)
        assert np.abs(dense_r - win_r).max() < 1e-3, m.shape
        dense_c = np.einsum("bhs,os->bho", xt, mf, optimize=True)
        win_c = hostexec._apply_cols(m, xt)
        assert np.abs(dense_c - win_c).max() < 1e-3, m.shape
