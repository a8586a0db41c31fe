"""The port's plain decode functions (fanlin_tpu_torch.ops.jpeg_decode)
and the CPU path of the decode kernels' wrappers
(ops.jpeg_decode_kernels, K3 jpeg_islow and K4 jpeg_upsample_rgb)
against the JAX package's fanlin_tpu.ops.jpeg_decode, on the CPU.

All of it is integer work, so the tolerance is none: every array must
be equal, on seeded coefficient grids for the four layouts at odd true
dims and on a crafted grid whose iDCT leaves [0, 255].
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fanlin_tpu.ops import jpeg_decode as J
from fanlin_tpu_torch.ops import jpeg_decode as T
from fanlin_tpu_torch.ops import jpeg_decode_kernels as jk
from fanlin_tpu_torch.ops.plan import bucket_h, bucket_h16, bucket_w

LAYOUTS = [420, 422, 440, 444]
DIMS = [(37, 23), (101, 83), (7, 5)]  # (true_h, true_w), odd on purpose


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _grids(subsamp, true_h, true_w, batch=2, seed=0, crafted=False):
    """Seeded block grids at the bucket's block grid: (y, cb, cr) int16
    (B, bh, bw, 64) and the quant tables (B, 2, 64) int32."""
    rng = np.random.default_rng(seed + subsamp + true_h)
    dv, dh = T.chroma_divisors(subsamp)
    gh, gw = bucket_h16(true_h), bucket_w(true_w)
    shapes = [(gh // 8, gw // 8)] + [(gh // (8 * dv), gw // (8 * dh))] * 2
    grids = []
    for bh, bw in shapes:
        g = np.zeros((batch, bh, bw, 64), np.int16)
        g[..., 0] = rng.integers(-120, 120, (batch, bh, bw))
        g[..., 1:12] = rng.integers(-25, 25, (batch, bh, bw, 11))
        g[..., 12:30] = rng.integers(-3, 3, (batch, bh, bw, 18))
        grids.append(g)
    q = rng.integers(1, 40, (batch, 2, 64)).astype(np.int32)
    if crafted:
        # tests/test_jpeg_device_decode.py's crafted blocks: the iDCT
        # leaves [0, 255] and the output saturates
        y = grids[0]
        y[0, 0, 0, 0] = 1600
        y[0, 1, 1, 0] = -1600
        y[0, 2, 2, 0] = 900
        y[0, 2, 2, 5] = 800
        y[0, 3, 0, 0] = -900
        y[0, 3, 0, 3] = -700
        q[:] = 25
    return grids, q


def _split(g):
    """JAX-side (dc, planar AC with DC zeroed) of a block grid."""
    b, bh, bw, _ = g.shape
    ac = g.copy()
    ac[..., 0] = 0
    planar = ac.reshape(b, bh, bw, 8, 8).transpose(0, 1, 3, 2, 4).reshape(
        b, bh * 8, bw * 8)
    return g[..., 0], planar.astype(np.int32)


@pytest.mark.parametrize("shift", [11, 18])
def test_islow_pass(shift):
    rng = np.random.default_rng(shift)
    s = [rng.integers(-4000, 4000, (3, 5)).astype(np.int32) for _ in range(8)]
    want = J._islow_pass([jnp.asarray(v) for v in s], shift)
    got = T._islow_pass([_t(v) for v in s], shift)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("crafted", [False, True])
def test_islow_idct_planar(crafted):
    (y, _, _), q = _grids(444, 32, 128, crafted=crafted)
    coef = (y.astype(np.int32) * q[:, 0][:, None, None, :]).reshape(
        2, 4, 16, 8, 8).transpose(0, 1, 3, 2, 4).reshape(2, 32, 128)
    _eq(T.islow_idct_planar(_t(coef)), J.islow_idct_planar(jnp.asarray(coef)))


@pytest.mark.parametrize("crafted", [False, True])
def test_islow_decode_plane(crafted):
    (y, _, _), q = _grids(444, 32, 128, crafted=crafted)
    dc, ac = _split(y)
    qf = q[:, 0].astype(np.float32)
    want = J.islow_decode_plane(jnp.asarray(dc), jnp.asarray(ac),
                                jnp.asarray(qf))
    _eq(T.islow_decode_plane(_t(dc), _t(ac), _t(qf)), want)
    # a DC-only plane
    want = J.islow_decode_plane(jnp.asarray(dc), None, jnp.asarray(qf),
                                shape=(32, 128))
    _eq(T.islow_decode_plane(_t(dc), None, _t(qf), shape=(32, 128)), want)


@pytest.mark.parametrize("shape", [(1, 1), (4, 6), (7, 5), (13, 128)])
@pytest.mark.parametrize("name", ["fancy_upsample_h2v2",
                                  "fancy_upsample_h2v1",
                                  "fancy_upsample_v2h1"])
def test_fancy_upsample(name, shape):
    rng = np.random.default_rng(len(name) + shape[0])
    c = rng.integers(0, 256, (2,) + shape).astype(np.int32)
    _eq(getattr(T, name)(_t(c)), getattr(J, name)(jnp.asarray(c)))


def test_ycbcr_to_rgb_libjpeg():
    rng = np.random.default_rng(6)
    y, cb, cr = (rng.integers(0, 256, (2, 33, 65)).astype(np.int32)
                 for _ in range(3))
    got = T.ycbcr_to_rgb_libjpeg(_t(y), _t(cb), _t(cr))
    want = J.ycbcr_to_rgb_libjpeg(jnp.asarray(y), jnp.asarray(cb),
                                  jnp.asarray(cr))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _eq(g, w)


@pytest.mark.parametrize("subsamp", [400, 420, 422, 440, 444])
def test_chroma_divisors(subsamp):
    assert T.chroma_divisors(subsamp) == J.chroma_divisors(subsamp)


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("subsamp", LAYOUTS)
def test_decode_rgb(subsamp, dims):
    """decode{420,422,440,444}_rgb against the JAX twins, and the two
    kernels' CPU path against the same planes."""
    true_h, true_w = dims
    (y, cb, cr), q = _grids(subsamp, true_h, true_w)
    pad_h, pad_w = bucket_h16(true_h), bucket_w(true_w)
    args = []
    for g in (y, cb, cr):
        args += list(_split(g))
    qf = q.astype(np.float32)
    name = f"decode{subsamp}_rgb"
    want = getattr(J, name)(*map(jnp.asarray, args), jnp.asarray(qf[:, 0]),
                            jnp.asarray(qf[:, 1]), true_h, true_w, pad_h, pad_w)
    got = getattr(T, name)(*map(_t, args), _t(qf[:, 0]), _t(qf[:, 1]),
                           true_h, true_w, pad_h, pad_w)
    for g, w in zip(got, want):
        _eq(g, w)

    planes = jk.jpeg_islow(_t(y), _t(cb), _t(cr), _t(q))
    out_h = bucket_h(true_h)
    rgb = jk.jpeg_upsample_rgb(*planes, subsamp, true_h, true_w, out_h, pad_w)
    assert rgb.dtype == torch.uint8 and rgb.shape == (2, 3, out_h, pad_w)
    ref = np.stack([np.asarray(w) for w in want], axis=1)[:, :, :out_h]
    _eq(rgb, ref.astype(np.uint8))


def test_crafted_grid_kernels_match_plain_and_jax():
    """The crafted out-of-range grid through K3 + K4 (CPU path) gives
    the JAX decode's bytes, saturated."""
    (y, cb, cr), q = _grids(444, 32, 32, crafted=True)
    planes = jk.jpeg_islow(_t(y), _t(cb), _t(cr), _t(q))
    ref = jk.jpeg_islow_ref(_t(y), _t(cb), _t(cr), _t(q))
    for p, r in zip(planes, ref):
        _eq(p, r.numpy())
    assert int(planes[0].max()) == 255 and int(planes[0].min()) == 0
    args = []
    for g in (y, cb, cr):
        args += list(_split(g))
    qf = q.astype(np.float32)
    want = J.decode444_rgb(*map(jnp.asarray, args), jnp.asarray(qf[:, 0]),
                           jnp.asarray(qf[:, 1]), 32, 32, 32, 128)
    rgb = jk.jpeg_upsample_rgb(*planes, 444, 32, 32, 32, 128)
    _eq(rgb, np.stack([np.asarray(w) for w in want], 1).astype(np.uint8))


@pytest.mark.parametrize("bad", ["dtype", "q_shape", "subsamp", "dims",
                                 "device"])
def test_wrappers_reject_bad_arguments(bad):
    (y, cb, cr), q = _grids(420, 37, 23, batch=1)
    y, cb, cr, q = map(_t, (y, cb, cr, q))
    if bad == "dtype":
        with pytest.raises(ValueError):
            jk.jpeg_islow(y.to(torch.int32), cb, cr, q)
    elif bad == "q_shape":
        with pytest.raises(ValueError):
            jk.jpeg_islow(y, cb, cr, q[:, :1])
    else:
        planes = jk.jpeg_islow(y, cb, cr, q)
        if bad == "subsamp":
            with pytest.raises(ValueError):
                jk.jpeg_upsample_rgb(*planes, 411, 37, 23, 40, 128)
        elif bad == "dims":
            with pytest.raises(ValueError):
                jk.jpeg_upsample_rgb(*planes, 420, 37, 23, 32, 128)
        else:
            meta = tuple(p.to("meta") for p in planes)
            with pytest.raises(ValueError, match="unsupported device"):
                jk.jpeg_upsample_rgb(*meta, 420, 37, 23, 40, 128)


def test_cpu_path_never_counts_launches():
    jk.reset_launch_counts()
    (y, cb, cr), q = _grids(420, 37, 23, batch=1)
    planes = jk.jpeg_islow(*map(_t, (y, cb, cr, q)))
    jk.jpeg_upsample_rgb(*planes, 420, 37, 23, 40, 128)
    assert jk.launch_counts() == {"jpeg_decode_rgb": 0, "jpeg_islow": 0,
                                  "jpeg_upsample_rgb": 0}
