"""The port's folded decode-resize (`tpu.fast_decode`, K11) on the CPU.

The iDCT, the triangle chroma upsample and YCbCr->RGB fold into the
resample matrices on the host (`jpeg_decode.folded_matrices`); the
device runs one full-f32 matmul pair per plane
(`jpeg_decode.folded_decode_resample`) in place of the decode and
resample kernels. Held here:

* against the port's own staged path (the exact decode): the JAX
  package's budget, >= 45 dB and max |diff| <= 16
  (tests/test_folded_decode.py, twinned here case for case, but for its
  jpegdct overflow-ladder test: the ladder is not in the port);
* against the JAX package's folded path on the same metas: at most 1
  LSB anywhere and at most 0.5 % of bytes differing (both sum f32
  products, in different orders); `folded_matrices` equal to the JAX's;
* the Engine's kind routing, and spectral_db refused with fast_decode.
"""

import asyncio
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from fanlin_tpu.engine import native_codecs as jnative
from fanlin_tpu.ops import fused as jfused
from fanlin_tpu.ops import jpeg_decode as jjd
from fanlin_tpu.spec.query import parse_query as jparse_query
from fanlin_tpu_torch import cli
from fanlin_tpu_torch.config import Config, ConfigError
from fanlin_tpu_torch.engine import Engine, codecs
from fanlin_tpu_torch.engine.batcher import _group_key
from fanlin_tpu_torch.engine.jpeg_coeffs import read_jpeg_coeffs
from fanlin_tpu_torch.ops import fused as tfused
from fanlin_tpu_torch.ops import jpeg_decode as tjd
from fanlin_tpu_torch.ops import plan as tplan
from fanlin_tpu_torch.server.app import build_state, check_ported
from fanlin_tpu_torch.spec.content import Format
from fanlin_tpu_torch.spec.query import parse_query
from tests.conftest import make_test_image, psnr

CPU = torch.device("cpu")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
KIND = {420: "coef", 422: "coef422", 440: "coef440", 444: "coef444"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def jax_fold():
    """The JAX package's fold switch is a process global: on for the
    test, off again after it."""
    jfused.set_fold(True)
    yield
    jfused.set_fold(False)


def _jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _meta(w=512, h=512, seed=7, quality=92):
    return read_jpeg_coeffs(_jpeg(make_test_image(w, h, seed=seed),
                                  quality=quality))


def _run(plan, metas, fold, jpeg420=False):
    asm = tfused.CoefBatchAssembly([plan] * len(metas), metas, CPU,
                                   jpeg420, fold=fold)
    assert asm.fold == fold
    return asm.run()


def _plan(meta, qs):
    return tplan.plan_image(meta["w"], meta["h"], parse_query(qs),
                            opaque=True)


# --- twins of tests/test_folded_decode.py: against the staged path ---

@pytest.mark.parametrize("qs,dims", [
    ("w=300&h=200", (512, 512)),          # fit + canvas (bench row 3)
    ("w=300&h=200&crop=true", (512, 512)),
    ("w=100&h=80&rgb=7,8,9", (500, 375)), # odd dims + fill colour
    ("w=60&h=40&blur=1", (512, 512)),     # blur composes after
    ("w=700&h=600", (512, 512)),          # upscale + canvas
])
def test_folded_matches_staged(qs, dims):
    w, h = dims
    metas = [_meta(w, h, seed=s) for s in (1, 2)]
    plan = _plan(metas[0], qs)
    folded = _run(plan, metas, True)
    staged = _run(plan, metas, False)
    for f, s in zip(folded, staged):
        assert f.shape == s.shape
        d = psnr(f, s)
        assert d >= 45.0, (qs, d)
        assert int(np.abs(f.astype(int) - s.astype(int)).max()) <= 16, qs


@pytest.mark.parametrize("qs", ["w=100&h=80&grayscale=true",
                                "w=100&h=80&inverse=true"])
def test_folded_gray_and_invert_fall_back_to_staged(qs):
    """grayscale and invert need the decoded pixels: such a batch asked
    to fold runs the staged route, bytes and all."""
    meta = _meta()
    plan = _plan(meta, qs)
    asm = tfused.CoefBatchAssembly([plan], [meta], CPU, fold=True)
    assert not asm.fold and asm.uses_kernel()
    np.testing.assert_array_equal(asm.run()[0], _run(plan, [meta], False)[0])


def test_folded_with_jpeg420_tail():
    meta = _meta(seed=3)
    plan = _plan(meta, "w=300&h=200")
    (tag, fy, fcb, fcr) = _run(plan, [meta], True, jpeg420=True)[0]
    (_, sy, scb, scr) = _run(plan, [meta], False, jpeg420=True)[0]
    assert tag == "ycbcr420"
    for f, s in ((fy, sy), (fcb, scb), (fcr, scr)):
        assert psnr(f, s) >= 45.0


def test_folded_vs_libjpeg_ground_truth():
    """Folded identity resize against the host decoder's pixels (PIL's
    libjpeg): above the 45 dB parity bar."""
    data = _jpeg(make_test_image(), quality=92)
    host, _, _ = codecs.decode(data)
    meta = read_jpeg_coeffs(data)
    out = _run(_plan(meta, ""), [meta], True)[0]
    d = psnr(out[:, :, :3], host)
    assert d >= 45.0, d


def test_upsample_triangle_matches_integer_filter():
    """The triangle matrix is the fancy upsample without its integer
    rounding: within 1 on random data."""
    rng = np.random.default_rng(0)
    c = rng.integers(0, 256, (1, 12, 9)).astype(np.int32)
    exact = tjd.fancy_upsample_h2v2(torch.from_numpy(c)).numpy()[0]
    uv = tjd._upsample_triangle(24, 12)
    uh = tjd._upsample_triangle(18, 9)
    lin = uv @ c[0].astype(np.float64) @ uh.T
    assert np.abs(lin - exact).max() <= 1.0


# --- the host matrices against the JAX package's ---

@pytest.mark.parametrize("subsamp", [420, 422, 440, 444])
def test_folded_matrices_equal_jax(subsamp):
    meta = _meta(301, 199, seed=5)
    plan = _plan(meta, "w=120&h=90&rgb=1,2,3")
    gh = tplan.bucket_h16(199)
    got = tplan._folded_padded(plan, subsamp)
    jplan = jfused.plan_image(301, 199, jparse_query("w=120&h=90&rgb=1,2,3"),
                              opaque=True)
    av, ah, _, _ = jfused._uniform_padded(jplan, gh, jfused.bucket_w(301))
    want = jjd.folded_matrices(av, ah, 199, 301, subsamp)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # the entry is cached by plan and layout
    assert tplan._folded_padded(plan, subsamp) is got


def test_grid_height_is_the_coefficient_grid():
    """A 7x5 source: the pixel bucket is 8 rows, the coefficient grid 16
    (whole 4:2:0 MCU rows); the folded matrices contract over the grid."""
    meta = read_jpeg_coeffs(_jpeg(make_test_image(7, 5, seed=4),
                                  quality=90, subsampling=2))
    plan = _plan(meta, "w=3&h=2")
    asm = tfused.CoefBatchAssembly([plan], [meta], CPU, fold=True)
    assert asm.sh == 8 and asm.device_wire()[0].shape[1] == 2  # 16 rows
    mats = tplan._folded_padded(plan, 420)
    assert mats[0].shape[1] == 16 and mats[2].shape[1] == 8
    assert mats[4].shape[1] == 2 and mats[6].shape[1] == 1


# --- the assembly against the JAX package's folded assembly ---

def _source(name) -> bytes:
    if name in ("lenna", "synth"):
        with open(os.path.join(GOLDEN, f"{name}_src.jpg"), "rb") as f:
            return f.read()
    if name == "pil422":
        return _jpeg(make_test_image(301, 199, seed=3), quality=85,
                     subsampling=1)
    if name == "nat440":
        data = jnative.encode_jpeg_subsamp(make_test_image(301, 199, seed=6),
                                           85, 1, 2)
        if data is None:
            pytest.skip("native codec core not built")
        return data
    if name == "gray":
        gray = Image.fromarray(make_test_image(101, 83)).convert("L")
        return _jpeg(np.asarray(gray), quality=90)
    assert name == "tiny420"
    return _jpeg(make_test_image(7, 5, seed=4), quality=90, subsampling=2)


def _close(a, b, max_lsb=1, max_frac=0.005):
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a - b)
    assert int(d.max()) <= max_lsb
    assert float((d > 0).mean()) <= max_frac


@pytest.mark.parametrize("name,qs,subsamp", [
    ("lenna", "w=300&h=200", 444),
    ("lenna", "w=100&h=80&blur=1", 444),
    ("synth", "w=300&h=200", 420),
    ("synth", "w=100&h=100&crop=true", 420),
    ("pil422", "w=120&h=90&rgb=32,32,32", 422),
    ("nat440", "w=120&h=90", 440),
    ("gray", "w=60&h=40", 444),
    ("tiny420", "w=3&h=2", 420),
])
def test_fold_assembly_matches_jax(jax_fold, name, qs, subsamp):
    data = _source(name)
    meta = jnative.read_jpeg_coeffs(data)  # the JAX package's dict
    assert meta["subsamp"] == subsamp
    jplan = jfused.plan_image(meta["w"], meta["h"], jparse_query(qs),
                              opaque=True)
    jasm = jfused.CoefBatchAssembly([jplan, jplan], [meta, meta])
    assert jasm.fold
    want = jasm.run()
    plan = _plan(meta, qs)
    asm = tfused.make_assembly([plan, plan], [meta, meta],
                               [KIND[subsamp] + tfused.FOLD_SUFFIX] * 2, CPU)
    assert asm.fold and not asm.uses_kernel()
    got = asm.run()
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("sink", ["+jpeg420", "+webp420", "+png:3"])
def test_fold_sinks_match_jax(jax_fold, sink):
    data = _source("synth")
    meta = jnative.read_jpeg_coeffs(data)
    qs = "w=120&h=90"
    jplan = jfused.plan_image(512, 512, jparse_query(qs), opaque=True)
    jkind = "coef+" + sink[1:]
    jasm = jfused.make_assembly([jplan], [meta], [jkind])
    assert jasm.fold
    want = jasm.run()[0]
    got = tfused.make_assembly([_plan(meta, qs)], [meta],
                               ["coef" + tfused.FOLD_SUFFIX + sink],
                               CPU).run()[0]
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        if isinstance(w, np.ndarray):
            _close(g, w)
        else:
            assert g == w


@pytest.fixture
def jax_exact_ladder():
    """With host fallback off the JAX jpegdct assembly runs a wider
    download rung inline instead of serving it from its host mirror."""
    jfused.set_host_fallback(False)
    yield
    jfused.set_host_fallback(True)


def test_fold_jpegdct_sink_matches_jax(jax_fold, jax_exact_ladder):
    """The jpegdct sink after the fold: quantised coefficients within 1
    of the JAX package's, at most 0.5 % of them differing."""
    meta = jnative.read_jpeg_coeffs(_source("lenna"))
    qs = "w=300&h=200"
    jplan = jfused.plan_image(512, 512, jparse_query(qs), opaque=True)
    jasm = jfused.CoefBatchAssembly([jplan], [meta], jpegdct=True,
                                    quality=75)
    assert jasm.fold
    want = jasm.run()[0]
    got = tfused.make_assembly([_plan(meta, qs)], [meta],
                               ["coef444-fold+jpegdct:75"], CPU).run()[0]
    assert got[0] == want[0] == "coeffs"
    assert got[4:] == tuple(want[4:])
    for g, w in zip(got[1:4], want[1:4]):
        _close(g, w)


def test_padded_batch_slots_are_not_collected():
    """Three images in a bucket of four: the zero wire of the fourth
    slot is folded (grey) and never collected; each image equals itself
    folded alone."""
    metas = [_meta(200, 150, seed=s) for s in (1, 2, 3)]
    plan = _plan(metas[0], "w=80&h=60")
    asm = tfused.CoefBatchAssembly([plan] * 3, metas, CPU, fold=True)
    assert asm.b == 4
    got = asm.run()
    assert len(got) == 3
    for g, m in zip(got, metas):
        np.testing.assert_array_equal(g, _run(plan, [m], True)[0])


# --- the Engine's routing and startup ---

class _Recorder:
    """A runner that records each batch's kind and the assembly's route
    and runs it on the CPU."""

    def __init__(self):
        self.device = CPU
        self.seen = []

    def run(self, plans, images, kinds=None):
        asm = tfused.make_assembly(plans, images, kinds, CPU)
        self.seen.append((kinds[0], getattr(asm, "fold", False),
                          asm.uses_kernel()))
        return asm.run()


@pytest.mark.parametrize("fast_decode", [True, False])
def test_engine_kind_routing(fast_decode):
    rec = _Recorder()
    engine = Engine(runner=rec, fast_decode=fast_decode)
    lenna, synth = _source("lenna"), _source("synth")
    png = io.BytesIO()
    Image.fromarray(make_test_image(64, 48)).save(png, format="PNG")
    accepted = Format()
    accepted.accept_webp()
    for data, qs in ((lenna, "w=300&h=200"),
                     (lenna, "w=300&h=200&webp=true&quality=20"),
                     (lenna, "w=300&h=200&grayscale=true"),
                     (lenna, "w=300&h=200&inverse=true"),
                     (synth, "w=300&h=200&blur=1"),
                     (png.getvalue(), "w=32&h=24")):
        engine.process_image(data, parse_query(qs), accepted)
    fold = tfused.FOLD_SUFFIX if fast_decode else ""
    sink = "+jpeg420" if jnative.available() else ""
    webp = "+webp420" if jnative.has_webp_yuv420() else ""
    assert rec.seen == [
        (f"coef444{fold}{sink}", fast_decode, not fast_decode),
        (f"coef444{fold}{webp}", fast_decode, not fast_decode),
        (f"coef444{sink}", False, True),   # grayscale: staged
        (f"coef444{sink}", False, True),   # invert: staged
        (f"coef{fold}{sink}", fast_decode, not fast_decode),
        ("png:3", False, True),            # pixels: never folded
    ]
    assert engine.stats == {"pixel_src": 1, "coef_src": 5}


def test_folded_and_staged_requests_never_share_a_batch():
    plan = tplan.plan_image(512, 512, parse_query("w=300&h=200"), opaque=True)
    assert (_group_key(plan, "coef444" + tfused.FOLD_SUFFIX)
            != _group_key(plan, "coef444"))
    with pytest.raises(ValueError, match="only coefficient kinds fold"):
        tfused.make_assembly([plan], [np.zeros((512, 512, 3), np.uint8)],
                             ["rgb" + tfused.FOLD_SUFFIX], CPU)


def _raw(tpu: dict) -> dict:
    return {"port": 0, "bind_addr": "127.0.0.1", "max_clients": 8,
            "client": {"s3": {"aws_region": "x"},
                       "web": {"user_agent": "t", "timeout": 2}},
            "providers": [{"path": "baz",
                           "src": "file://localhost" + os.path.abspath(GOLDEN)}],
            "tpu": tpu}


def test_spectral_db_refused_with_fast_decode():
    """Spectral thinning is lossy and rides the narrow-link pack modes,
    which the port lacks: with fast_decode it stops startup."""
    raw = _raw({"fast_decode": True, "spectral_db": 30})
    cfg = Config.from_obj(raw)
    with pytest.raises(ConfigError, match="tpu.spectral_db with "
                                          "tpu.fast_decode"):
        check_ported(cfg)
    with pytest.raises(ConfigError):
        asyncio.run(build_state(cfg, device=CPU))
    assert cli.main(["-j", json.dumps(raw)]) == 1
    check_ported(Config.from_obj(_raw({"fast_decode": True})))


def test_warmup_warms_the_folded_kinds(monkeypatch):
    """With fast_decode the warmup runs the folded coefficient kinds
    where the Engine would fold the shape's plan (and the staged ones
    for a grayscale shape), each batch on the folded route."""
    from fanlin_tpu_torch.engine import batcher as batcher_mod
    from fanlin_tpu_torch.engine import warmup

    seen = []
    real = tfused.make_assembly

    def make(plans, payloads, kinds, device, **kw):
        asm = real(plans, payloads, kinds, device, **kw)
        seen.append((kinds[0], getattr(asm, "fold", False)))
        return asm

    monkeypatch.setattr(tfused, "make_assembly", make)
    batcher = batcher_mod.MicroBatcher(2, 2.0, device=CPU)
    try:
        shapes = ((64, 48, "w=32&h=24"), (64, 48, "w=32&h=24&grayscale=true"))
        n = warmup.warm(batcher, shapes, fast_decode=True)
    finally:
        assert batcher.close()
    kinds = warmup._kinds(True, False, True)
    assert n == len(seen) == 2 * 2 * len(kinds)
    coef = [(k, f) for k, f in seen if k.startswith("coef")]
    half = len(coef) // 2
    assert coef[:half] and all(
        f and k.split("+")[0].endswith(tfused.FOLD_SUFFIX)
        for k, f in coef[:half])
    assert all(not f and tfused.FOLD_SUFFIX not in k for k, f in coef[half:])
    assert all(not f for k, f in seen if not k.startswith("coef"))
