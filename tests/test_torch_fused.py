"""The port's transform chain, tails and batch assembly
(fanlin_tpu_torch.ops.fused) against the JAX package's
(fanlin_tpu.ops.fused), on the CPU.

Tolerances: the encode tails are integer or fixed float formulas and
must be BIT-EXACT given identical u8 input; the float resample chain
is held to at most 1 LSB anywhere and at most 0.5 % of bytes
differing (float32 sums in another order may flip a .5 boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fanlin_tpu.ops import filters
from fanlin_tpu.ops import fused as jfused
from fanlin_tpu.spec.query import parse_query
from fanlin_tpu_torch.ops import fused as tfused
from fanlin_tpu_torch.ops import plan as tplan
from fanlin_tpu_torch.ops import resample_kernels as rk
from tests.conftest import make_test_image

CPU = torch.device("cpu")
J_YCBCR = jax.jit(jfused._ycbcr420_tail)
J_WEBP = jax.jit(jfused._webp420_tail)
J_PNG = jax.jit(jfused._png_tail, static_argnums=1)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(a, b, max_lsb=1, max_frac=0.005):
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a - b)
    assert d.max() <= max_lsb, d.max()
    assert (d > 0).mean() <= max_frac, (d > 0).mean()


def _rgba(img, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, img.shape[:2], dtype=np.uint8)
    a[: img.shape[0] // 3] = 255  # some fully opaque rows
    return np.dstack([img, a])


def _batch(specs, rgba=False, filter_name=filters.LANCZOS3):
    """specs: [(src_w, src_h, query, seed)]. Returns (port plans, jax
    plans, images)."""
    tp, jp, imgs = [], [], []
    for w, h, qs, seed in specs:
        img = make_test_image(w, h, seed=seed)
        if rgba:
            img = _rgba(img, seed)
        q = parse_query(qs)
        tp.append(tplan.plan_image(w, h, q, filter_name, opaque=not rgba))
        jp.append(jfused.plan_image(w, h, q, filter_name, opaque=not rgba))
        imgs.append(img)
    return tp, jp, imgs


def _compare_rgb(tp, jp, imgs):
    got = tfused.make_assembly(tp, imgs, ["rgb"], CPU).run()
    want = jfused.make_assembly(jp, imgs, ["rgb"]).run()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)
    return got, want


UNIFORM = [(64, 64, "w=100&h=48", 0), (64, 64, "w=100&h=48", 1)]
UNIFORM_BLUR = [(64, 48, "w=40&h=36&blur=1&rgb=5,6,7", 2)] * 2
MIXED = [(64, 48, "w=40&h=30&grayscale=true", 3),
         (50, 70, "w=40&h=30&blur=2&rgb=9,8,7", 4),
         (7, 5, "w=40&h=30&crop=true&inverse=true", 5)]
MIXED_GEOM = [(64, 48, "w=40&h=30", 6), (80, 40, "w=24&h=60&crop=true", 7),
              (33, 17, "w=50&h=20&blur=1", 8)]


@pytest.mark.parametrize("rgba", [False, True])
@pytest.mark.parametrize("specs", [UNIFORM, UNIFORM_BLUR, MIXED, MIXED_GEOM],
                         ids=["uniform", "uniform_blur", "mixed", "mixed_geom"])
def test_rgb_assembly_matches(specs, rgba):
    tp, jp, imgs = _batch(specs, rgba)
    asm = tfused.make_assembly(tp, imgs, ["rgb"], CPU)
    assert asm.uniform == (len(set(map(id, tp))) == 1)
    assert asm.uses_kernel() == (asm.uniform and not rgba)
    _compare_rgb(tp, jp, imgs)


def test_gray_wins_over_invert():
    tp, jp, imgs = _batch([(64, 48, "w=40&h=30&grayscale=true&inverse=true", 9)] * 2)
    got, _ = _compare_rgb(tp, jp, imgs)
    plain = _batch([(64, 48, "w=40&h=30&grayscale=true", 9)] * 2)
    np.testing.assert_array_equal(
        got[0], tfused.make_assembly(plain[0], plain[2], ["rgb"], CPU).run()[0])


def test_opaque_batch_downloads_alpha_when_asked():
    """A plan made without opaque=True wants alpha: the kernel's three
    channels get a constant 255 alpha plane, as in the reference."""
    q = parse_query("w=50&h=30&crop=true")
    img = make_test_image(64, 48, seed=10)
    tp = tplan.plan_image(64, 48, q)
    jp = jfused.plan_image(64, 48, q)
    got = tfused.make_assembly([tp, tp], [img, img], ["rgb"], CPU).run()
    want = jfused.make_assembly([jp, jp], [img, img], ["rgb"]).run()
    assert got[0].shape == want[0].shape == (30, 50, 4)
    assert (got[0][..., 3] == 255).all()
    _close(got[0], want[0])


def test_gif_frames_nearest_matches():
    specs = [(32, 24, "w=50&h=40", s) for s in (11, 12, 13)]
    tp, jp, imgs = _batch(specs, rgba=True, filter_name=filters.NEAREST)
    _compare_rgb(tp, jp, imgs)


SINKS = ["jpeg420", "webp420", "png:1", "png:3", "png:4"]


@pytest.mark.parametrize("kind", SINKS)
@pytest.mark.parametrize("specs", [UNIFORM, MIXED], ids=["uniform", "mixed"])
def test_sink_assembly_matches(kind, specs):
    """Each sink: the port's tail output is bit-exact against the JAX
    tail applied to the port's own pixels, and the whole assembly
    matches the JAX assembly (bit-exact when the pixels are)."""
    tp, jp, imgs = _batch(specs)
    pixels, want_px = _compare_rgb(tp, jp, imgs)
    got = tfused.make_assembly(tp, imgs, [kind], CPU).run()
    want = jfused.make_assembly(jp, imgs, [kind]).run()
    assert [type(g) for g in got] == [type(w) for w in want]
    x = jnp.asarray(np.stack([p.transpose(2, 0, 1) for p in pixels]))
    if kind.startswith("png:"):
        nch = int(kind.split(":")[1])
        rows = np.asarray(J_PNG(x, nch))
        for i, (g, w) in enumerate(zip(got, want)):
            assert g[0] == "pngrows" and g[2:] == w[2:]
            np.testing.assert_array_equal(g[1], rows[i])
    else:
        tail = J_WEBP if kind == "webp420" else J_YCBCR
        planes = [np.asarray(a) for a in tail(x)]
        for i, (g, w) in enumerate(zip(got, want)):
            assert g[0] == w[0]
            for k in range(3):
                np.testing.assert_array_equal(g[1 + k], planes[k][i])
                _close(g[1 + k], w[1 + k])
    if all(np.array_equal(a, b) for a, b in zip(pixels, want_px)):
        for g, w in zip(got, want):
            for a, b in zip(g[1:], w[1:]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(2, 3, 16, 24), (1, 4, 7, 9), (3, 3, 1, 1),
                                   (2, 4, 5, 2)])
def test_tails_bit_exact(shape):
    """Identical u8 input -> identical tail output, on random pixels."""
    rng = np.random.default_rng(sum(shape))
    u8 = rng.integers(0, 256, shape, dtype=np.uint8)
    t, j = torch.from_numpy(u8), jnp.asarray(u8)
    for tt, jt in ((tfused._ycbcr420_tail, J_YCBCR),
                   (tfused._webp420_tail, J_WEBP)):
        for a, b in zip(tt(t), jt(j)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for nch in (1, 2, 3, 4):
        np.testing.assert_array_equal(tfused._png_tail(t, nch).numpy(),
                                      np.asarray(J_PNG(j, nch)))


def test_transform_single_matches():
    img = make_test_image(40, 30, seed=14)
    q = parse_query("w=20&h=20&rgb=1,2,3")
    _close(tfused.transform_single(img, q, CPU),
           jfused.transform_single(img, q))


def test_coefficient_kinds_not_ported():
    tp, _, imgs = _batch(UNIFORM)
    for kind in ("coef+jpegdct:75", "jpegdct:75", "cmyk420",
                 "cmyk444+jpeg420"):
        with pytest.raises(NotImplementedError):
            tfused.make_assembly(tp, imgs, [kind], CPU)


def test_cpu_assemblies_never_launch_the_kernel():
    rk.reset_launch_counts()
    tp, _, imgs = _batch(UNIFORM_BLUR)
    tfused.make_assembly(tp, imgs, ["jpeg420"], CPU).run()
    assert rk.launch_counts() == {"resample": 0, "resample_blur": 0}
