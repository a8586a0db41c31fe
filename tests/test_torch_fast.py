"""The port's bf16 resample (`tpu.fast`) on the CPU, against the JAX
package's fast path and against the port's exact route.

`fast` rounds the resample pair's weights and its intermediate to bf16
(round to nearest even) and sums the products in f32
(fanlin_tpu/ops/fused.py:186-194, :343-349; K11's AC pairs,
fanlin_tpu/ops/jpeg_decode.py:571-575); the blur pair and K11's DC
pairs stay f32. On the CPU every route runs its plain torch form: the
resample kernel's `resample_uniform_ref(fast=True)`, the chain's
`_chain(fast=True)`, K11's `folded_decode_resample(fast=True)`.

Tolerances:
* against the JAX package's fast path on the same inputs: at most 1 LSB
  anywhere and at most 0.5 % of bytes differing. The f32 sums run in
  another order, and a sum that lands on the other side of a bf16
  rounding point of the intermediate (its spacing is 1.0 above 128)
  moves the next product's term by up to its weight; the worst case
  measured over these cases is 1, so 1 is asserted. jpegdct
  coefficients: at most one quantisation step, as in
  tests/test_torch_coef.py;
* against the port's exact route: >= 48 dB, the JAX package's own bar
  (tests/test_fused.py::test_fast_mode_close_to_exact).

The JAX package's switch is process-wide (`fused.set_fast_mode`): it is
set only inside `jax_fast`, and reset there. Its CMYK program cache is
not keyed by the switch, so `jax_fast` clears it on the way in and out.
The port keeps no such switch: the runner holds it.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from fanlin_tpu.engine import native_codecs as jnative
from fanlin_tpu.ops import fused as jfused
from fanlin_tpu.spec.query import parse_query as jparse_query
from fanlin_tpu_torch.engine import Engine
from fanlin_tpu_torch.engine.jpeg_coeffs import read_jpeg_coeffs4
from fanlin_tpu_torch.ops import chain as tchain
from fanlin_tpu_torch.ops import fused as tfused
from fanlin_tpu_torch.ops import plan as tplan
from fanlin_tpu_torch.ops import resample_kernels as rk
from fanlin_tpu_torch.spec.content import Format
from fanlin_tpu_torch.spec.query import parse_query
from tests.conftest import make_test_image, psnr
from tests.test_torch_icc import cmyk_jpeg, make_cmyk_profile

CPU = torch.device("cpu")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
KIND = {420: "coef", 422: "coef422", 440: "coef440", 444: "coef444"}
FAST_DB = 48.0


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@contextlib.contextmanager
def jax_fast(fold=False):
    """The JAX package's bf16 (and, with `fold`, folded) switches on
    inside, off after; its CMYK program cache emptied on both sides."""
    jfused.get_cmyk_coef_program.cache_clear()
    jfused.set_fast_mode(True)
    jfused.set_fold(fold)
    try:
        yield
    finally:
        jfused.set_fold(False)
        jfused.set_fast_mode(False)
        jfused.get_cmyk_coef_program.cache_clear()


def _close(a, b, max_lsb=1, max_frac=0.005):
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a - b)
    assert int(d.max()) <= max_lsb, int(d.max())
    assert float((d > 0).mean()) <= max_frac, float((d > 0).mean())


def _same(got, want):
    """Two results of one kind (pixels, or a sink's tuple) within
    _close, their tags and sizes equal."""
    if isinstance(want, tuple):
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            if isinstance(w, np.ndarray):
                _close(g, w)
            else:
                assert g == w
    else:
        _close(got, want)


def _golden(name: str) -> bytes:
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


def _rgba(img, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, img.shape[:2], dtype=np.uint8)
    a[: img.shape[0] // 3] = 255
    return np.dstack([img, a])


# --- twin of tests/test_fused.py::test_fast_mode_close_to_exact ---

def test_fast_mode_close_to_exact():
    """bf16 fast path: pixels are exact in bf16; only the weights and the
    intermediate round. Must stay >= 48 dB of the exact f32 output."""
    img = make_test_image()
    plan = tplan.plan_image(512, 512, parse_query("w=300&h=200"))
    exact = tfused.BatchAssembly([plan], [img], CPU).run()[0]
    fast = tfused.BatchAssembly([plan], [img], CPU, fast=True).run()[0]
    assert fast.shape == exact.shape
    assert not np.array_equal(fast, exact)  # the form does differ
    p = psnr(fast[..., :3], exact[..., :3])
    assert p >= FAST_DB, f"PSNR {p:.2f}"


# --- pixel sources against the JAX package's fast path ---

PIXEL_CASES = {
    # name: ([(src_w, src_h, query, seed)], rgba); one spec = uniform
    "readme": ([(512, 512, "w=300&h=200", 7)], False),
    "blur": ([(512, 512, "w=100&h=80&blur=1", 7)], False),
    "gray": ([(512, 512, "w=300&h=200&grayscale=true", 7)], False),
    "invert": ([(512, 512, "w=300&h=200&inverse=true", 7)], False),
    "canvas": ([(512, 512, "w=300&h=200&rgb=32,32,32", 7)], False),
    "crop": ([(512, 512, "w=100&h=100&crop=true", 7)], False),
    "nonuniform": ([(640, 480, "w=300&h=200", 3),
                    (512, 512, "w=120&h=90", 4)], False),
    "alpha": ([(512, 512, "w=300&h=200&rgb=9,8,7", 5)], True),
}


def _pixel_batch(name):
    specs, rgba = PIXEL_CASES[name]
    if len(specs) == 1:
        specs = specs * 2
    tp, jp, imgs = [], [], []
    for w, h, qs, seed in specs:
        img = make_test_image(w, h, seed=seed)
        if rgba:
            img = _rgba(img, seed)
        tp.append(tplan.plan_image(w, h, parse_query(qs), opaque=not rgba))
        jp.append(jfused.plan_image(w, h, jparse_query(qs), opaque=not rgba))
        imgs.append(img)
    if specs[0] == specs[1]:  # one plan object: a uniform batch
        tp, jp = [tp[0]] * 2, [jp[0]] * 2
    return tp, jp, imgs


@pytest.mark.parametrize("name", list(PIXEL_CASES))
def test_pixel_route_matches_jax_fast(name):
    """The resample kernel's plain bf16 form (uniform opaque batches) and
    the torch chain's (alpha, non-uniform) against the JAX package's
    fast programs; and >= 48 dB from the port's exact route."""
    tp, jp, imgs = _pixel_batch(name)
    asm = tfused.make_assembly(tp, imgs, ["rgb"], CPU, fast=True)
    assert asm.fast
    assert asm.uses_kernel() == (name not in ("nonuniform", "alpha"))
    got = asm.run()
    with jax_fast():
        want = jfused.make_assembly(jp, imgs, ["rgb"]).run()
    exact = tfused.make_assembly(tp, imgs, ["rgb"], CPU).run()
    for g, w, e in zip(got, want, exact):
        _close(g, w)
        assert psnr(g, e) >= FAST_DB


@pytest.mark.parametrize("sink", ["jpeg420", "webp420", "png:3"])
def test_pixel_tails_match_jax_fast(sink):
    tp, jp, imgs = _pixel_batch("readme")
    got = tfused.make_assembly(tp, imgs, [sink], CPU, fast=True).run()
    with jax_fast():
        want = jfused.make_assembly(jp, imgs, [sink]).run()
    for g, w in zip(got, want):
        _same(g, w)


# --- coefficient sources ---

def _coef_source(name):
    data = _golden(f"{name}_src.jpg")
    return data, jnative.read_jpeg_coeffs(data)


@pytest.mark.parametrize("name,qs,subsamp", [
    ("synth", "w=300&h=200", 420),
    ("synth", "w=100&h=80&blur=1", 420),
    ("lenna", "w=300&h=200", 444),
])
def test_coef_route_matches_jax_fast(name, qs, subsamp):
    """jpeg_decode_rgb, then the resample kernel's bf16 form."""
    _, meta = _coef_source(name)
    assert meta["subsamp"] == subsamp
    plan = tplan.plan_image(meta["w"], meta["h"], parse_query(qs),
                            opaque=True)
    jplan = jfused.plan_image(meta["w"], meta["h"], jparse_query(qs),
                              opaque=True)
    asm = tfused.make_assembly([plan] * 2, [meta] * 2, [KIND[subsamp]] * 2,
                               CPU, fast=True)
    assert asm.fast and asm.uses_kernel()
    got = asm.run()
    with jax_fast():
        jasm = jfused.CoefBatchAssembly([jplan] * 2, [meta] * 2)
        assert not jasm.fold
        want = jasm.run()
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("sink", ["+jpeg420", "+webp420", "+png:3"])
def test_coef_tails_match_jax_fast(sink):
    _, meta = _coef_source("synth")
    qs = "w=300&h=200"
    plan = tplan.plan_image(512, 512, parse_query(qs), opaque=True)
    jplan = jfused.plan_image(512, 512, jparse_query(qs), opaque=True)
    got = tfused.make_assembly([plan], [meta], ["coef" + sink], CPU,
                               fast=True).run()[0]
    with jax_fast():
        want = jfused.make_assembly([jplan], [meta], ["coef" + sink]).run()[0]
    _same(got, want)


@pytest.fixture
def jax_exact_ladder():
    """With host fallback off the JAX jpegdct assembly runs a wider
    download rung inline instead of serving it from its host mirror."""
    jfused.set_host_fallback(False)
    yield
    jfused.set_host_fallback(True)


@pytest.mark.parametrize("fold", [False, True])
def test_jpegdct_matches_jax_fast(jax_exact_ladder, fold):
    """The jpegdct sink (K9) after the bf16 resample, staged or folded:
    quantised coefficients within one step of the JAX package's, at most
    0.5 % of them differing."""
    _, meta = _coef_source("lenna")
    qs = "w=300&h=200"
    plan = tplan.plan_image(512, 512, parse_query(qs), opaque=True)
    jplan = jfused.plan_image(512, 512, jparse_query(qs), opaque=True)
    kind = "coef444" + (tfused.FOLD_SUFFIX if fold else "") + "+jpegdct:75"
    got = tfused.make_assembly([plan], [meta], [kind], CPU,
                               fast=True).run()[0]
    with jax_fast(fold=fold):
        jasm = jfused.CoefBatchAssembly([jplan], [meta], jpegdct=True,
                                        quality=75)
        assert jasm.fold == fold
        want = jasm.run()[0]
    assert got[0] == want[0] == "coeffs"
    assert got[4:] == tuple(want[4:])
    for g, w in zip(got[1:4], want[1:4]):
        _close(g, w)


@pytest.mark.parametrize("name,qs", [
    ("lenna", "w=300&h=200"),
    ("lenna", "w=100&h=80&blur=1"),
    ("synth", "w=300&h=200"),
    ("synth", "w=100&h=100&crop=true"),
])
def test_fast_decode_matches_jax_fast(name, qs):
    """`fast` with `fast_decode`: K11 with its AC pairs in bf16 (its DC
    pairs f32) against the JAX folded program under fast; >= 48 dB from
    the port's f32 fold."""
    _, meta = _coef_source(name)
    plan = tplan.plan_image(meta["w"], meta["h"], parse_query(qs),
                            opaque=True)
    jplan = jfused.plan_image(meta["w"], meta["h"], jparse_query(qs),
                              opaque=True)
    kind = KIND[meta["subsamp"]] + tfused.FOLD_SUFFIX
    asm = tfused.make_assembly([plan] * 2, [meta] * 2, [kind] * 2, CPU,
                               fast=True)
    assert asm.fold and asm.fast and not asm.uses_kernel()
    got = asm.run()
    with jax_fast(fold=True):
        jasm = jfused.CoefBatchAssembly([jplan] * 2, [meta] * 2)
        assert jasm.fold
        want = jasm.run()
    exact = tfused.make_assembly([plan] * 2, [meta] * 2, [kind] * 2,
                                 CPU).run()
    for g, w, e in zip(got, want, exact):
        _close(g, w)
        assert psnr(g, e) >= FAST_DB


def _cmyk_meta(data, seed=0):
    from fanlin_tpu_torch.engine import icc as ticc
    from fanlin_tpu_torch.ops import cmyk_lut as tlut

    conv = ticc.CMYK2RGB.with_icc_profile(make_cmyk_profile(seed))
    lut = tlut.sample_lut(conv.convert, 17)
    meta = read_jpeg_coeffs4(data)
    meta.update(lut_flat=np.ascontiguousarray(
        lut.reshape(-1, 3).astype(np.float32)), lut_n=17, lut_key="")
    return meta


@pytest.mark.parametrize("sink", ["", "+jpeg420"])
def test_cmyk_route_matches_jax_fast(sink):
    """CMYK with device ICC: jpeg_decode_cmyk_rgb, then the resample
    kernel's bf16 form, against the JAX CMYK program traced under fast."""
    meta = _cmyk_meta(cmyk_jpeg(300, 220, seed=1))
    qs = "w=120&h=88"
    plan = tplan.plan_image(meta["w"], meta["h"], parse_query(qs),
                            opaque=True)
    jplan = jfused.plan_image(meta["w"], meta["h"], jparse_query(qs),
                              opaque=True)
    kind = "cmyk444" + sink
    asm = tfused.make_assembly([plan], [meta], [kind], CPU, fast=True)
    assert asm.fast and asm.uses_kernel()
    got = asm.run()[0]
    with jax_fast():
        want = jfused.make_assembly([jplan], [meta], [kind]).run()[0]
    exact = tfused.make_assembly([plan], [meta], [kind], CPU).run()[0]
    _same(got, want)
    if not sink:
        assert psnr(got, exact) >= FAST_DB


# --- the switch lives in the runner, not in the process ---

def _body(engine, data, qs):
    return engine.process_image(data, parse_query(qs), Format())[1]


def test_fast_and_exact_engines_interleaved():
    """Two Engines in one process, fast and exact, in turns: each gives
    its own bytes every time, whatever ran before it (no global)."""
    fast, exact = Engine(CPU, fast=True), Engine(CPU)
    assert fast.runner.fast and not exact.runner.fast
    lenna, synth = _golden("lenna_src.jpg"), _golden("synth_src.jpg")
    png = io.BytesIO()
    Image.fromarray(_rgba(make_test_image(96, 64), 3)).save(png, "PNG")
    cases = [(lenna, "w=300&h=200"), (synth, "w=100&h=80&blur=1"),
             (png.getvalue(), "w=48&h=32")]
    first = {(id(e), i): _body(e, d, q) for e in (fast, exact)
             for i, (d, q) in enumerate(cases)}
    for e in (exact, fast, fast, exact):
        for i, (d, q) in enumerate(cases):
            assert _body(e, d, q) == first[(id(e), i)]
    for i in range(len(cases)):
        assert first[(id(fast), i)] != first[(id(exact), i)]


def test_engine_refuses_a_runner_of_the_other_form():
    from fanlin_tpu_torch.engine.processor import SyncDeviceRunner

    with pytest.raises(ValueError, match="fast"):
        Engine(runner=SyncDeviceRunner(CPU), fast=True)
    with pytest.raises(ValueError, match="fast"):
        Engine(runner=SyncDeviceRunner(CPU, fast=True))
    assert Engine(runner=SyncDeviceRunner(CPU, fast=True), fast=True).fast


# --- the launch each assembly selects ---

@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("kind", ["rgb", "coef444", "cmyk444", "rgb-blur"])
def test_make_assembly_selects_the_fast_launch(monkeypatch, kind, fast):
    """make_assembly(fast=...) reaches the resample kernel's wrapper,
    whose launch key names the form (`resample_fast`,
    `resample_blur_fast`); on the CPU nothing is counted."""
    calls = []
    real = rk.resample_uniform

    def spy(*a, **k):
        calls.append(rk.launch_key(a[6] is not None, k["fast"]))
        return real(*a, **k)

    monkeypatch.setattr(rk, "resample_uniform", spy)
    qs = "w=60&h=40" + ("&blur=1" if kind.endswith("blur") else "")
    if kind.startswith("rgb"):
        payload = make_test_image(120, 88)
    elif kind == "coef444":
        buf = io.BytesIO()
        Image.fromarray(make_test_image(120, 88)).save(
            buf, "JPEG", quality=90, subsampling=0)
        payload = jnative.read_jpeg_coeffs(buf.getvalue())
    else:
        payload = _cmyk_meta(cmyk_jpeg(120, 88, seed=2))
    plan = tplan.plan_image(120, 88, parse_query(qs), opaque=True)
    rk.reset_launch_counts()
    asm = tfused.make_assembly([plan], [payload], [kind.split("-")[0]], CPU,
                               fast=fast)
    assert asm.fast == fast and asm.uses_kernel()
    asm.run()
    blur = "blur" if kind.endswith("blur") else ""
    want = "resample" + ("_blur" if blur else "") + ("_fast" if fast else "")
    assert calls == [want]
    assert not any(rk.launch_counts().values())


# --- the kernel's register conversion, emulated ---

def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """csrc/resample.cu's bf16_bits: f32 rounded to bf16 (nearest even)
    by its bits, returned as f32 (the low 16 bits zero)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def test_register_rounding_is_bf16_and_exact_in_tf32():
    """The kernel's conversion equals torch's bf16 rounding (ties to even
    included); the result has no bits below TF32's 10-bit mantissa, and
    the product of two such values, or of one and a pixel 0..255, is
    exact in f32: one TF32 product computes the bf16 product."""
    rng = np.random.default_rng(13)
    x = np.concatenate([
        rng.standard_normal(100_000).astype(np.float32) * 0.3,
        # exact ties: bf16 value + half an ulp
        (_bf16_bits(rng.random(1000).astype(np.float32)).view(np.uint32)
         | 0x8000).view(np.float32)])
    got = _bf16_bits(x)
    want = tchain.bf16_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not (got.view(np.uint32) & 0x1FFF).any()  # exact in TF32
    a, b = got[:50_000], got[50_000:100_000]
    np.testing.assert_array_equal((a * b).astype(np.float64),
                                  a.astype(np.float64) * b.astype(np.float64))
    px = rng.integers(0, 256, 50_000).astype(np.float32)
    np.testing.assert_array_equal((a * px).astype(np.float64),
                                  a.astype(np.float64) * px)


@pytest.mark.parametrize("qs", ["w=300&h=200", "w=300&h=200&grayscale=true",
                                "w=100&h=80&rgb=1,2,3&inverse=true"])
def test_kernel_emulation_matches_plain_fast_form(qs):
    """The fast form's passes 1-2 as the kernel does them, in numpy:
    Av by bf16_bits against the masked pixels (one exact product each,
    summed in f32 over each band), T by bf16_bits against Ah by
    bf16_bits, then the rounding and the canvas; against
    resample_uniform_ref(fast=True): within 1 LSB (the sums' order),
    at most 0.5 % differing."""
    rng = np.random.default_rng(5)
    plan = tplan.plan_image(256, 192, parse_query(qs), opaque=True)
    imgs = [rng.integers(0, 256, (192, 256, 3), dtype=np.uint8)
            for _ in range(2)]
    asm = tfused.BatchAssembly([plan] * 2, imgs, CPU, fast=True)
    av, ah, _, _ = tplan._uniform_padded(plan)
    args = rk.params_from_numpy(asm.flags, asm.fill, asm.box, av, ah,
                                device=CPU)
    flags, fill, box, tav, tah = args[:5]
    want = rk.resample_uniform_ref(flags, fill, box, tav, tah,
                                   torch.from_numpy(asm.x), fast=True,
                                   crop=(plan.out_h, plan.out_w)).numpy()
    x = asm.x.astype(np.int64)
    out = np.zeros_like(want)
    for i in range(asm.b):
        gray, inv, canvas = asm.flags[i] > 0
        luma = (2126 * x[i, 0] + 7152 * x[i, 1] + 722 * x[i, 2]) // 10000
        x0, y0, fw, fh = asm.box[i]
        for c in range(3):
            p = luma if gray else x[i, c]
            if inv and not gray:
                p = 255 - p
            t = (_bf16_bits(av).astype(np.float64)
                 @ p.astype(np.float64)).astype(np.float32)
            f = (_bf16_bits(t).astype(np.float64)
                 @ _bf16_bits(ah).T.astype(np.float64)).astype(np.float32)
            f = np.floor(np.clip(f, 0, 255) + 0.5)
            if canvas:
                mask = np.zeros(f.shape, bool)
                mask[y0:y0 + fh, x0:x0 + fw] = True
                f = np.where(mask, f, asm.fill[i, c])
            out[i, c] = f[:plan.out_h, :plan.out_w]
    _close(out, want)
