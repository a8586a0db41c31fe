"""The band walk and the split-TF32 products of the port's CUDA resample
kernel (fanlin_tpu_torch/csrc/resample.cu), emulated in torch on the CPU.

The kernel cannot run here, so these tests pin the two choices its
design rests on:

- `tile_k_ranges` / `band_ranges`: every weight outside a tile's range
  is exactly 0, so walking only the band gives the dense product. The
  ranges are checked on the padded matrices of every shape chip_smoke.py
  runs on the card, 12 MP included.
- The kernel's tile walk, emulated per tile over the band slice only,
  with f32 products and with the split-TF32 products the tensor cores
  make (2 in pass 1, whose pixel operand is exact in TF32; 3 in passes
  2-4). Both stay within the resample budget of the dense plain version
  and the Pallas kernel (interpret mode): at most 1 LSB anywhere and at
  most 0.5 % of bytes differing. Plain 1xTF32 does not, which is why the
  kernel splits.

The TF32 rounding emulated is cvt.rna.tf32.f32's: round to nearest,
ties away from zero, 10 explicit mantissa bits.
"""

import numpy as np
import pytest
import torch

from chip_smoke import SHAPES
from fanlin_tpu.ops import filters
from fanlin_tpu.ops import fused as jfused
from fanlin_tpu.ops import pallas_kernels
from fanlin_tpu.spec.query import parse_query
from fanlin_tpu_torch.ops import fused as tfused
from fanlin_tpu_torch.ops import plan as tplan
from fanlin_tpu_torch.ops import resample_kernels as rk
from fanlin_tpu_torch.ops.chain import _post_resample
from tests.conftest import make_test_image

CPU = torch.device("cpu")
MAX_LSB = 1
MAX_FRAC = 0.005
TM, TN, KS = rk.TILE_M, rk.TILE_N, rk.K_SLICE

PALLAS_CASES = ["w=100&h=48", "grayscale=true",
                "inverse=true&w=40&h=24&crop=true", "w=64&h=40&blur=1"]
README = (512, 512, "w=300&h=200")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _budget(a, b):
    """(max abs difference, share of bytes differing)."""
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    assert np.asarray(a).shape == np.asarray(b).shape
    return int(d.max()), float((d > 0).mean())


def _close(a, b):
    mx, frac = _budget(a, b)
    assert mx <= MAX_LSB, mx
    assert frac <= MAX_FRAC, frac


# --- (a) the ranges ------------------------------------------------------


def _check_ranges(mat, tile, ranges):
    """Aligned, outward-minimal, and exactly 0 outside: returns the
    indices of the empty tiles."""
    rows, k = mat.shape
    assert ranges.dtype == np.int32
    assert ranges.shape == (-(-rows // tile), 2)
    assert (ranges % KS == 0).all()
    empty = []
    for i, (lo, hi) in enumerate(ranges):
        blk = mat[i * tile:(i + 1) * tile]
        assert 0 <= lo <= hi <= -(-k // KS) * KS
        assert not blk[:, :lo].any() and not blk[:, hi:].any()
        if lo == hi:
            empty.append(i)
            continue
        # rounded outward by less than one slice on each side
        assert blk[:, lo:lo + KS].any() and blk[:, hi - KS:hi].any()
    return empty


def _tiles_outside(rows_from, rows_to, n_rows, tile):
    """Tiles of `tile` rows of an n_rows matrix with no row in
    [rows_from, rows_to)."""
    return [i for i in range(-(-n_rows // tile))
            if i * tile >= rows_to or (i + 1) * tile <= rows_from]


@pytest.mark.parametrize("name,src_w,src_h,qs,batch", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_ranges_on_every_chip_shape(name, src_w, src_h, qs, batch):
    plan = tplan.plan_image(src_w, src_h, parse_query(qs), opaque=True)
    av, ah, bv, bh = tplan._uniform_padded(plan)
    x0, y0, fw, fh = plan.box
    # Av/Ah rows are non-zero exactly on the foreground box: canvas
    # borders and bucket padding come out empty
    assert _check_ranges(av, TM, rk.tile_k_ranges(av, TM, KS)) == \
        _tiles_outside(y0, y0 + fh, av.shape[0], TM)
    assert _check_ranges(ah, TN, rk.tile_k_ranges(ah, TN, KS)) == \
        _tiles_outside(x0, x0 + fw, ah.shape[0], TN)
    if bv is not None:
        assert _check_ranges(bv, TM, rk.tile_k_ranges(bv, TM, KS)) == \
            _tiles_outside(0, plan.out_h, bv.shape[0], TM)
        assert _check_ranges(bh, TN, rk.tile_k_ranges(bh, TN, KS)) == \
            _tiles_outside(0, plan.out_w, bh.shape[0], TN)


def test_ranges_12mp_band_is_a_small_share():
    """The count behind the design: at 12 MP -> 1200x800 one M tile
    of Av spans at most 288 of 3072 source rows, and the canvas border
    and padding leave 1 of 14 row tiles and 6 of 40 column tiles
    empty."""
    plan = tplan.plan_image(4000, 3000, parse_query("w=1200&h=800"),
                            opaque=True)
    av, ah, _, _ = tplan._uniform_padded(plan)
    ra, rh = rk.tile_k_ranges(av, TM, KS), rk.tile_k_ranges(ah, TN, KS)
    assert (ra[:, 1] - ra[:, 0]).max() == 288
    assert (ra[:, 0] == ra[:, 1]).sum() == 1 and len(ra) == 14
    assert (rh[:, 0] == rh[:, 1]).sum() == 6 and len(rh) == 40


@pytest.mark.parametrize("filt", [filters.LANCZOS3, filters.NEAREST,
                                  filters.TRIANGLE, filters.CATMULLROM])
@pytest.mark.parametrize("qs", ["w=300&h=200", "w=100&h=100&crop=true",
                                "w=700&h=600&rgb=7,8,9", ""])
def test_ranges_hold_for_every_filter(filt, qs):
    plan = tplan.plan_image(512, 384, parse_query(qs), filt, opaque=True)
    av, ah, _, _ = tplan._uniform_padded(plan)
    _check_ranges(av, TM, rk.tile_k_ranges(av, TM, KS))
    _check_ranges(ah, TN, rk.tile_k_ranges(ah, TN, KS))


def test_ranges_by_hand():
    m = np.zeros((70, 100), np.float32)
    m[0, 33] = 1.0           # tile 0: one weight -> [32, 64)
    m[63, 95] = -0.5         # ... and one near the end -> [32, 96)
    m[64:70, 0] = 2.0        # tile 1 (6 rows): [0, 32)
    got = rk.tile_k_ranges(m, 64, 32)
    np.testing.assert_array_equal(got, [[32, 96], [0, 32]])
    m[:, 99] = 1.0           # k_hi rounds past K = 100 to 128
    np.testing.assert_array_equal(rk.tile_k_ranges(m, 64, 32),
                                  [[32, 128], [0, 128]])
    np.testing.assert_array_equal(
        rk.tile_k_ranges(np.zeros((10, 40), np.float32), 8, 16),
        [[0, 0], [0, 0]])


def test_band_ranges_layout():
    plan = tplan.plan_image(512, 512, parse_query("w=100&h=80&blur=1"),
                            opaque=True)
    av, ah, bv, bh = tplan._uniform_padded(plan)
    got = rk.band_ranges(av, ah, bv, bh)
    want = np.concatenate([rk.tile_k_ranges(av, TM, KS),
                           rk.tile_k_ranges(ah, TN, KS),
                           rk.tile_k_ranges(bv, TM, KS),
                           rk.tile_k_ranges(bh, TN, KS)])
    np.testing.assert_array_equal(got, want)
    assert rk.band_ranges(av, ah).shape == (-(-128 // TM) + -(-128 // TN), 2)


def test_bands_cached_beside_padded_matrices():
    plan = tplan.plan_image(512, 512, parse_query("w=300&h=200"),
                            opaque=True)
    bands = tplan._uniform_bands(plan)
    assert tplan._uniform_bands(plan) is bands
    np.testing.assert_array_equal(
        bands, rk.band_ranges(*tplan._uniform_padded(plan)))


@pytest.mark.parametrize("qs", ["w=300&h=200", "w=100&h=80&blur=1"])
def test_assembly_passes_the_cached_bands(monkeypatch, qs):
    plan = tplan.plan_image(64, 64, parse_query(qs), opaque=True)
    seen = {}
    real = rk.resample_uniform

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    monkeypatch.setattr(rk, "resample_uniform", spy)
    img = make_test_image(64, 64, seed=5)
    tfused.BatchAssembly([plan], [img], CPU).run()
    np.testing.assert_array_equal(seen["bands"].numpy(),
                                  tplan._uniform_bands(plan))
    assert seen["bands"].dtype == torch.int32


@pytest.mark.parametrize("bad", ["shape", "dtype", "blur_count"])
def test_wrapper_rejects_bad_bands(bad):
    plan = tplan.plan_image(64, 64, parse_query("w=64&h=40&blur=1"),
                            opaque=True)
    av, ah, bv, bh = tplan._uniform_padded(plan)
    asm = tfused.BatchAssembly([plan], [make_test_image(64, 64)], CPU)
    args = rk.params_from_numpy(asm.flags, asm.fill, asm.box, av, ah, bv, bh,
                                device=CPU)
    bands = torch.from_numpy(rk.band_ranges(av, ah, bv, bh))
    x = torch.from_numpy(asm.x)
    rk.resample_uniform(*args[:5], x, *args[5:], bands=bands)  # accepted
    if bad == "shape":
        bands = bands[:-1]
    elif bad == "dtype":
        bands = bands.long()
    else:
        bands = torch.from_numpy(rk.band_ranges(av, ah))
    with pytest.raises((ValueError, TypeError)):
        rk.resample_uniform(*args[:5], x, *args[5:], bands=bands)


# --- (b)-(d) the tile walk, emulated --------------------------------------


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round the f32 mantissa to 10 bits, to nearest,
    ties away from zero (on the magnitude, so the sign bit is kept)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def prod_f32(a, b, b_exact):
    return torch.matmul(a, b)


def prod_split(a, b, b_exact):
    """The kernel's split products: lo*hi (+ hi*lo unless b is exact in
    TF32) + hi*hi; lo*lo is dropped."""
    ahi, alo = _split(a)
    if b_exact:
        assert torch.equal(tf32(b), b)
        return torch.matmul(alo, b) + torch.matmul(ahi, b)
    bhi, blo = _split(b)
    return (torch.matmul(alo, bhi) + torch.matmul(ahi, blo)
            + torch.matmul(ahi, bhi))


def prod_tf32(a, b, b_exact):
    return torch.matmul(tf32(a), tf32(b))


def _masked_planes(x, flags):
    """The pixel operand: integers 0..255 (integer luma floor)."""
    xi = x.to(torch.int32)
    luma = torch.div(2126 * xi[:, 0] + 7152 * xi[:, 1] + 722 * xi[:, 2],
                     10000, rounding_mode="floor")
    gray = (flags[:, 0] > 0)[:, None, None, None]
    inv = ((flags[:, 1] > 0) & (flags[:, 0] == 0))[:, None, None, None]
    p = torch.where(gray, luma[:, None], xi)
    return torch.where(inv, 255 - p, p).to(torch.float32)


def _walk_rows(w, ranges, b, prod, b_exact):
    """Passes 1 and 3: out[rows of M tile i] = w[rows, band] @ b[band]."""
    out = torch.zeros(b.shape[:-2] + (w.shape[0], b.shape[-1]))
    for i, (lo, hi) in enumerate(ranges.tolist()):
        rows = slice(i * TM, (i + 1) * TM)
        if lo < hi:
            out[..., rows, :] = prod(w[rows, lo:hi], b[..., lo:hi, :], b_exact)
    return out


def _walk_cols(a, w, ranges, prod):
    """Passes 2 and 4: out[:, cols of N tile j] = a[:, band] @ w[cols,
    band]^T."""
    out = torch.zeros(a.shape[:-1] + (w.shape[0],))
    for j, (lo, hi) in enumerate(ranges.tolist()):
        cols = slice(j * TN, (j + 1) * TN)
        if lo < hi:
            out[..., cols] = prod(a[..., lo:hi], w[cols, lo:hi].T, False)
    return out


def banded_chain(flags, fill, box, av, ah, x, bv=None, bh=None, prod=prod_f32):
    """The kernel's four passes as it walks them: per tile, over the
    band slice only, then its epilogues."""
    n_av, n_ah = -(-av.shape[0] // TM), -(-ah.shape[0] // TN)
    bands = rk.band_ranges(*(m.numpy() if m is not None else None
                             for m in (av, ah, bv, bh)))
    r_av, r_ah = bands[:n_av], bands[n_av:n_av + n_ah]
    t = _walk_rows(av, r_av, _masked_planes(x, flags), prod, True)
    f = _walk_cols(t, ah, r_ah, prod)
    fg = torch.floor(torch.clamp(f, 0.0, 255.0) + 0.5)
    out = _post_resample(fg, flags, fill, box)  # composite, u8
    if bv is None:
        return out
    r_bv = bands[n_av + n_ah:2 * n_av + n_ah]
    r_bh = bands[2 * n_av + n_ah:]
    u = _walk_rows(bv, r_bv, out.to(torch.float32), prod, False)
    v = _walk_cols(u, bh, r_bh, prod)
    return torch.floor(torch.clamp(v, 0.0, 255.0) + 0.5).to(torch.uint8)


def _case(query, src=64, seeds=(0, 1)):
    plan = jfused.plan_image(src, src, parse_query(query), opaque=True)
    imgs = [make_test_image(src, src, seed=s) for s in seeds]
    asm = jfused.BatchAssembly([plan] * len(imgs), imgs)
    av, ah, bv, bh = jfused._uniform_padded(plan)
    args = rk.params_from_numpy(asm.flags, asm.fill, asm.box, av, ah, bv, bh,
                                device=CPU)
    return asm, av, ah, bv, bh, args, torch.from_numpy(asm.x)


def _readme_random(batch=2, seed=20261016):
    """The README shape (512x512 -> w=300&h=200) on random u8 sources."""
    w, h, qs = README
    plan = tplan.plan_image(w, h, parse_query(qs), opaque=True)
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for _ in range(batch)]
    asm = tfused.BatchAssembly([plan] * batch, imgs, CPU)
    av, ah, bv, bh = tplan._uniform_padded(plan)
    args = rk.params_from_numpy(asm.flags, asm.fill, asm.box, av, ah, bv, bh,
                                device=CPU)
    return args, torch.from_numpy(asm.x)


@pytest.mark.parametrize("query", PALLAS_CASES)
def test_band_walk_matches_dense_and_pallas(query):
    asm, av, ah, bv, bh, args, x = _case(query)
    got = banded_chain(*args[:5], x, *args[5:])
    _close(got.numpy(), rk.resample_uniform_ref(*args[:5], x, *args[5:]))
    pallas = np.asarray(pallas_kernels.resample_uniform(
        asm.flags, asm.fill, asm.box, av, ah, asm.x, interpret=True,
        bv=bv, bh=bh))
    _close(got.numpy(), pallas)


@pytest.mark.parametrize("query", PALLAS_CASES)
def test_split_tf32_walk_matches_dense(query):
    _, _, _, _, _, args, x = _case(query)
    got = banded_chain(*args[:5], x, *args[5:], prod=prod_split)
    _close(got.numpy(), rk.resample_uniform_ref(*args[:5], x, *args[5:]))


def test_split_tf32_walk_matches_dense_at_readme_shape():
    args, x = _readme_random()
    got = banded_chain(*args[:5], x, *args[5:], prod=prod_split)
    _close(got.numpy(), rk.resample_uniform_ref(*args[:5], x, *args[5:]))


def test_plain_tf32_breaks_the_budget_at_readme_shape():
    """Why the kernel splits: one TF32 product per pass moves more than
    0.5 % of the output bytes at the README shape."""
    args, x = _readme_random()
    got = banded_chain(*args[:5], x, *args[5:], prod=prod_tf32)
    mx, frac = _budget(got.numpy(),
                       rk.resample_uniform_ref(*args[:5], x, *args[5:]))
    assert mx > MAX_LSB or frac > MAX_FRAC, (mx, frac)


def test_tf32_rounding_is_rna():
    one_ulp = 2.0 ** -10  # of TF32 at 1.0
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, -(1.0 + one_ulp / 2),
                      1.0 + one_ulp / 2 - 2.0 ** -23, 1.0 + 1.5 * one_ulp,
                      255.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0,
                         1.0 + 2 * one_ulp, 255.0, 0.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    hi, lo = _split(torch.tensor([0.1234567], dtype=torch.float32))
    assert abs(float(hi + lo) - 0.1234567) < 2.0 ** -22
