"""The packed ICC LUT and the fused CMYK decode on the CPU.

`cmyk_lut.pack_lut` lays the sampled LUT out as the kernels read it
(u8 RGB words, the four entries of the K and Y corners to a 16 B row);
`cmyk_lut.lut_planes_packed` is the kernels' order of work on it (four
row gathers, shared weight prefixes, corners 0..15). It must give the
bits of `lut_planes` (the JAX function's order) on every input: 0 bytes
differing. Against the JAX package's `lut_planes` and `_lut_program`,
which XLA may fuse otherwise on the CPU, it is held to 1 LSB with the
count that differs printed (0 on these inputs).

`jpeg_decode_kernels.jpeg_decode_cmyk_rgb` (csrc/jpeg_decode.cu: K12a's
decode with the LUT in its colour stage): its CPU path against its plain
version `jpeg_decode_cmyk_rgb_ref` (K12b's plain version of K12a's) on
every layout, padded images included, against the decode and LUT of the
JAX program `get_cmyk_coef_program` (decode_cmyk then lut_planes, one
jit), and an emulation of the kernel's CTAs: a tile that decodes stages
its CMYK pixels into a noise-filled shared buffer and reads them back in
the kernel's order; one that does not (past the true rect, padded
images) evaluates the LUT at two values and selects per pixel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fanlin_tpu.ops import cmyk_lut as jlut
from fanlin_tpu.ops import jpeg_decode as J
from fanlin_tpu_torch.engine import icc as ticc
from fanlin_tpu_torch.ops import cmyk_lut as tlut
from fanlin_tpu_torch.ops import cmyk_lut_kernels as lk
from fanlin_tpu_torch.ops import jpeg_decode_kernels as jk
from fanlin_tpu_torch.ops.plan import bucket_h, bucket_h16, bucket_w
from tests.test_torch_decode_cmyk import (LAYOUTS, PAD_VALUE, _emulate,
                                          _grids, _split, _tensors)
from tests.test_torch_decode_rgb import TW
from tests.test_torch_icc import make_cmyk_profile


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _lut(seed=0, n=17):
    """(n^4, 3) f32 LUT sampled from a synthetic profile."""
    conv = ticc.CMYK2RGB.with_icc_profile(make_cmyk_profile(seed))
    return np.ascontiguousarray(
        tlut.sample_lut(conv.convert, n).reshape(-1, 3).astype(np.float32))


def _count_differing(got, want):
    return int((np.asarray(got).astype(np.int32)
                != np.asarray(want).astype(np.int32)).sum())


# ---------------------------------------------------------------- pack_lut


@pytest.mark.parametrize("n", [2, 5, 17])
def test_pack_lut_words_are_the_entries(n):
    """Row e, word j holds entry e + (0, 1, n, n + 1)[j] as R | G << 8 |
    B << 16; rows whose Y or K level is n - 1 hold zeros."""
    rng = np.random.default_rng(n)
    flat = rng.integers(0, 256, (n ** 4, 3)).astype(np.float32)
    packed = tlut.pack_lut(flat, n)
    assert packed.dtype == torch.int32 and packed.is_contiguous()
    assert tuple(packed.shape) == (n ** 4, 4)
    p = packed.numpy().astype(np.int64)
    e = np.arange(n ** 4)
    i2, i3 = (e // n) % n, e % n
    base = (i2 < n - 1) & (i3 < n - 1)
    assert not p[~base].any()
    v = flat.astype(np.int64)
    for j, off in enumerate((0, 1, n, n + 1)):
        src = v[e[base] + off]
        want = src[:, 0] | (src[:, 1] << 8) | (src[:, 2] << 16)
        np.testing.assert_array_equal(p[base, j], want)
    # the same from a tensor
    np.testing.assert_array_equal(
        tlut.pack_lut(torch.from_numpy(flat), n).numpy(), packed.numpy())


@pytest.mark.parametrize("bad", ["half", "negative", "over", "shape", "dtype",
                                 "nan", "n"])
def test_pack_lut_refuses(bad):
    flat = _lut(0, 5)
    n = 5
    if bad == "half":
        flat[7, 1] = 127.5
    elif bad == "negative":
        flat[0, 0] = -1
    elif bad == "over":
        flat[-1, 2] = 256
    elif bad == "shape":
        flat = flat[:-1]
    elif bad == "dtype":
        flat = flat.astype(np.float64)
    elif bad == "nan":
        flat[3, 0] = np.nan
    else:
        n = 4
    with pytest.raises(ValueError):
        tlut.pack_lut(flat, n)


# ------------------------------------------- the kernels' order of work


def _cmyk_inputs(n, seed):
    """(N, 4) u8 CMYK: every combination of the n grid levels, 0 and 255,
    the clamp edge (every component from level n - 2 up to 255, where lo
    is n - 2), and 100,000 values from the seed."""
    levels = np.linspace(0, 255, n).round().astype(np.uint8)
    grid = np.stack(np.meshgrid(*[levels] * 4, indexing="ij"),
                    -1).reshape(-1, 4)
    top = np.arange(int(levels[-2]), 256, dtype=np.uint8)
    rng = np.random.default_rng(seed)
    edge = rng.choice(top, (4000, 4))
    rand = rng.integers(0, 256, (100_000, 4), dtype=np.uint8)
    ends = np.array([[0, 0, 0, 0], [255, 255, 255, 255], [0, 255, 0, 255],
                     [255, 0, 255, 0]], np.uint8)
    return np.concatenate([grid, edge, rand, ends])


def _planes_of(px):
    return [torch.from_numpy(np.ascontiguousarray(px[:, i]).astype(np.int32))
            for i in range(4)]


@pytest.mark.parametrize("n,seed", [(17, 0), (17, 1), (5, 2), (2, 3)])
def test_packed_order_is_bit_equal_to_lut_planes(n, seed):
    """lut_planes_packed against lut_planes: 0 bytes differing, on the
    grid levels of every component, 0, 255, the clamp edge and 100,000
    seeded values."""
    px = _cmyk_inputs(n, seed)
    flat = _lut(seed % 2, n)
    planes = _planes_of(px)
    want = tlut.lut_planes(*planes, torch.from_numpy(flat), n)
    got = tlut.lut_planes_packed(*planes, tlut.pack_lut(flat, n), n)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [5, 17])
def test_packed_order_matches_jax(n):
    """lut_planes_packed against the JAX package's lut_planes and its
    pixel program _lut_program on the CPU: within 1 LSB, the count that
    differs printed."""
    px = _cmyk_inputs(n, 7)[-100_000:]
    flat = _lut(0, n)
    got = tlut.lut_planes_packed(*_planes_of(px), tlut.pack_lut(flat, n), n)
    got = np.stack([g.numpy() for g in got], -1).astype(np.uint8)
    want = np.stack([np.asarray(w) for w in jlut.lut_planes(
        *(jnp.asarray(px[:, i].astype(np.int32)) for i in range(4)),
        jnp.asarray(flat), n)], -1)
    h, w = 250, 400
    prog = np.asarray(jlut._lut_program(n, h, w)(
        jnp.asarray(px.reshape(h, w, 4)), jnp.asarray(flat))).reshape(-1, 3)
    for name, ref in (("lut_planes", want), ("_lut_program", prog)):
        d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        print(f"n={n} {name}: {int((d > 0).sum())} of {d.size} bytes differ")
        assert d.max() <= 1


def test_wrappers_cpu_path_follows_packed_order():
    """cmyk_lut and cmyk_lut_pixels on the CPU (the kernel's order on the
    packed LUT) equal cmyk_lut_ref (lut_planes on the f32 LUT)."""
    px = _cmyk_inputs(17, 11)[-4096:].reshape(2, 32, 64, 4)
    flat = _lut(1)
    packed = tlut.pack_lut(flat, 17)
    planes = torch.from_numpy(px).permute(0, 3, 1, 2).contiguous()
    want = lk.cmyk_lut_ref(planes, torch.from_numpy(flat), 17)
    assert torch.equal(lk.cmyk_lut(planes, packed, 17), want)
    assert torch.equal(lk.cmyk_lut_packed_ref(planes, packed, 17), want)
    got = lk.cmyk_lut_pixels(torch.from_numpy(px[1]), packed, 17)
    assert torch.equal(got, want[1].permute(1, 2, 0))


# ------------------------------------------------- the fused decode


DIMS = [(5, 7), (16, 16), (33, 129), (479, 641)]


def _fused_args(subsamp, ycck, dims, batch, n, seed):
    true_h, true_w = dims
    grids, q = _grids(subsamp, true_h, true_w, batch, seed=seed)
    for g in grids:  # padded images are staged as zero coefficients
        g[n:] = 0
    q[n:] = 0
    geometry = (subsamp, ycck, true_h, true_w, bucket_h(true_h),
                bucket_w(true_w), n)
    return grids, q, geometry


@pytest.mark.parametrize("batch,n", [(1, 1), (4, 3)])
@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("subsamp,ycck", LAYOUTS)
def test_fused_cpu_path_equals_composition(subsamp, ycck, dims, batch, n):
    """jpeg_decode_cmyk_rgb's CPU path against its plain version, K12b's
    plain version of K12a's (cmyk_lut_ref of jpeg_decode_cmyk_ref): 0
    bytes differing over the whole (B, 3, sh, sw) tensor, padding
    included."""
    grids, q, geometry = _fused_args(subsamp, ycck, dims, batch, n,
                                     seed=dims[1] + n)
    (_, _, _, _, out_h, out_w, _) = geometry
    flat = _lut(0)
    packed = tlut.pack_lut(flat, 17)
    t = _tensors(grids, q)
    jk.reset_launch_counts()
    got = jk.jpeg_decode_cmyk_rgb(*t, packed, 17, *geometry)
    assert got.dtype == torch.uint8 and got.shape == (batch, 3, out_h, out_w)
    want = jk.jpeg_decode_cmyk_rgb_ref(*t, torch.from_numpy(flat), 17,
                                       *geometry)
    cmyk = jk.jpeg_decode_cmyk_ref(*t, *geometry)
    assert torch.equal(want, lk.cmyk_lut_ref(cmyk, torch.from_numpy(flat),
                                             17))
    assert torch.equal(got, want)
    assert jk.launch_counts()["jpeg_decode_cmyk_rgb"] == 0


@pytest.mark.parametrize("dims", [(5, 7), (33, 129), (479, 641)])
@pytest.mark.parametrize("subsamp,ycck", LAYOUTS)
def test_fused_plain_matches_jax_program(subsamp, ycck, dims):
    """The plain fused decode against the JAX program's decode and LUT
    (jpeg_decode.decode_cmyk then cmyk_lut.lut_planes, in one jit as
    get_cmyk_coef_program runs them): within 1 LSB inside the true rect,
    the count that differs printed."""
    true_h, true_w = dims
    grids, q, geometry = _fused_args(subsamp, ycck, dims, 2, 2,
                                     seed=true_h * 3)
    flat = _lut(1)
    args = []
    for g in grids:
        args += list(_split(g))
    qf = q.astype(np.float32)

    def program(*a):
        planes = J.decode_cmyk(*a[:8], a[8], a[9], true_h, true_w,
                               bucket_h16(true_h), bucket_w(true_w), subsamp,
                               ycck)
        return jnp.stack(jlut.lut_planes(*planes, a[10], 17), axis=1)

    want = np.asarray(jax.jit(program)(
        *map(jnp.asarray, args), jnp.asarray(qf[:, 0]),
        jnp.asarray(qf[:, 1]), jnp.asarray(flat)))
    got = jk.jpeg_decode_cmyk_rgb(*_tensors(grids, q),
                                  tlut.pack_lut(flat, 17), 17, *geometry)
    got = got.numpy()[:, :, :true_h, :true_w].astype(np.int32)
    want = want[:, :, :true_h, :true_w].astype(np.int32)
    d = np.abs(got - want)
    print(f"{subsamp} ycck={ycck} {dims}: {int((d > 0).sum())} of {d.size} "
          "bytes differ from the JAX program")
    assert d.max() <= 1


def _emulate_fused(grids, q, subsamp, ycck, true_h, true_w, out_h, out_w, n,
                   packed, seed=0):
    """The fused kernel's output, CTA by CTA, from its colour stage's
    decisions. A tile that decodes stages the CMYK of the 4-plane
    emulation (0 past the true rect) into a noise-filled buffer of
    th * TW pixels, rows up to out_h only; then each thread converts 4
    rounds of 4 consecutive pixels at q = (r * threads + tid) * 4, until
    its row passes out_h. A tile that does not decode evaluates the LUT
    at its constant and at 0 per 16-pixel vector and selects per pixel
    at true_w."""
    cmyk, _, _ = _emulate(grids, q, subsamp, ycck, true_h, true_w, out_h,
                          out_w, n)
    rng = np.random.default_rng(seed)
    th = jk.decode_tile(subsamp)[0]
    threads = th * TW // 16
    b = cmyk.shape[0]
    out = np.full((b, 3, out_h, out_w), 77, np.uint8)  # every byte written

    def lut(px):  # (N, 4) u8 -> (N, 3) u8
        planes = [torch.from_numpy(px[:, i].astype(np.int32))
                  for i in range(4)]
        rgb = tlut.lut_planes_packed(*planes, packed, 17)
        return np.stack([p.numpy() for p in rgb], -1).astype(np.uint8)

    zero = lut(np.zeros((1, 4), np.uint8))[0]
    for i in range(b):
        for y0 in range(0, out_h, th):
            rows = min(th, out_h - y0)
            for x0 in range(0, out_w, TW):
                if i < n and y0 < true_h and x0 < true_w:
                    s_px = rng.integers(0, 256, (th * TW, 4), dtype=np.uint8)
                    s_px[:rows * TW] = cmyk[i, :, y0:y0 + rows,
                                            x0:x0 + TW].reshape(4, -1).T
                    qs = [(r * threads + tid) * 4 for tid in range(threads)
                          for r in range(4)
                          if (r * threads + tid) * 4 // TW < rows]
                    rgb = lut(s_px[np.add.outer(qs, np.arange(4)).ravel()])
                    for k, q0 in enumerate(qs):
                        qy, qx = y0 + q0 // TW, x0 + q0 % TW
                        out[i, :, qy, qx:qx + 4] = rgb[4 * k:4 * k + 4].T
                    continue
                pad = i >= n
                for y in range(y0, y0 + rows):
                    inside = np.array(
                        PAD_VALUE[ycck] if pad and y < true_h else (0,) * 4,
                        np.uint8)
                    v = lut(inside[None])[0]
                    for x in range(x0, x0 + TW, 16):
                        keep = (x + np.arange(16)) < true_w
                        out[i, :, y, x:x + 16] = np.where(
                            keep, v[:, None], zero[:, None])
    return out


CASES = [(444, False, 16, 128, 1, 1), (444, True, 17, 129, 1, 1),
         (420, True, 33, 129, 1, 1), (444, False, 15, 17, 4, 3),
         (420, True, 7, 5, 4, 2)]


@pytest.mark.parametrize("subsamp,ycck,true_h,true_w,batch,n", CASES)
def test_fused_colour_stage_emulation(subsamp, ycck, true_h, true_w, batch,
                                      n):
    grids, q, geometry = _fused_args(subsamp, ycck, (true_h, true_w), batch,
                                     n, seed=true_w + n)
    (_, _, _, _, out_h, out_w, _) = geometry
    flat = _lut(0)
    packed = tlut.pack_lut(flat, 17)
    want = jk.jpeg_decode_cmyk_rgb_ref(*_tensors(grids, q),
                                       torch.from_numpy(flat), 17, *geometry)
    got = _emulate_fused(grids, q, subsamp, ycck, true_h, true_w, out_h,
                         out_w, n, packed)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("bad", ["lut_f32", "lut_n", "lut_device",
                                 "subsamp"])
def test_fused_wrapper_rejects_bad_arguments(bad):
    grids, q, geometry = _fused_args(444, False, (20, 20), 1, 1, seed=4)
    t = _tensors(grids, q)
    lut, lut_n = tlut.pack_lut(_lut(0, 5), 5), 5
    geometry = list(geometry)
    if bad == "lut_f32":
        lut = torch.from_numpy(_lut(0, 5))
    elif bad == "lut_n":
        lut_n = 17
    elif bad == "lut_device":
        lut = lut.to("meta")
    else:
        geometry[0] = 422
    with pytest.raises(ValueError):
        jk.jpeg_decode_cmyk_rgb(*t, lut, lut_n, *geometry)
