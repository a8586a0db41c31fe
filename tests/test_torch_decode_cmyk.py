"""The 4-component decode K12a `jpeg_decode_cmyk` (csrc/jpeg_decode.cu) on
the CPU: its plain version against the JAX package's decode_cmyk, an
emulation of its work partition, and its wrapper's CPU path.

`_emulate` repeats what the kernel's CTAs do for a CMYK or YCCK batch,
as tests/test_torch_decode_rgb.py does for `jpeg_decode_rgb` (whose
helpers it reuses): the job table with the K blocks after the luma
blocks (a second luma-rate plane), the chroma halo rows and columns of
YCCK 4:2:0, the tile's shared buffers filled with noise first (so that a
read of a sample no job wrote shows), the four stored planes (plain CMYK
inverted; YCCK as jdcolor's RGB and an inverted K), the constant of
padded images and the vector masked at true_w. No tolerance: integer
work throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import DIVISORS
from fanlin_tpu.ops import jpeg_decode as J
from fanlin_tpu_torch.ops import jpeg_decode as tjd
from fanlin_tpu_torch.ops import jpeg_decode_kernels as jk
from fanlin_tpu_torch.ops.plan import bucket_h, bucket_h16, bucket_w
from tests.test_torch_decode_rgb import (COL0, COL7, FULL, PAD, PITCH, ROW0,
                                         ROW7, ROWS, TW, _chroma16,
                                         _decode_jobs)

# (subsamp, ycck): the layouts the reader gives for four components
LAYOUTS = [(444, False), (444, True), (420, True)]
PAD_VALUE = {False: (127, 127, 127, 127), True: (128, 128, 128, 127)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _grids(subsamp, true_h, true_w, batch, seed, wide=False):
    """Seeded y, cb, cr, k block grids at the bucket's block grid (k at
    y's) and quant tables. wide: coefficients far out of range (the
    saturation after the iDCT)."""
    rng = np.random.default_rng(seed)
    dv, dh = DIVISORS[subsamp]
    gh, gw = bucket_h16(true_h), bucket_w(true_w)
    luma, chroma = (gh // 8, gw // 8), (gh // (8 * dv), gw // (8 * dh))
    out = []
    for bh, bw in (luma, chroma, chroma, luma):
        g = np.zeros((batch, bh, bw, 64), np.int16)
        lim = 2000 if wide else 120
        g[..., 0] = rng.integers(-lim, lim, (batch, bh, bw))
        g[..., 1:12] = rng.integers(-25, 25, (batch, bh, bw, 11)) * (
            40 if wide else 1)
        g[..., 12:30] = rng.integers(-3, 3, (batch, bh, bw, 18))
        out.append(g)
    q = rng.integers(1, 40, (batch, 2, 64)).astype(np.int32)
    return out, q


def _tensors(grids, q):
    return [torch.from_numpy(a) for a in (*grids, q)]


def _split(g):
    b, bh, bw, _ = g.shape
    ac = g.copy()
    ac[..., 0] = 0
    planar = ac.reshape(b, bh, bw, 8, 8).transpose(0, 1, 3, 2, 4).reshape(
        b, bh * 8, bw * 8)
    return g[..., 0], planar.astype(np.int32)


def _jax_decode(grids, q, subsamp, ycck, true_h, true_w):
    args = []
    for g in grids:
        args += list(_split(g))
    qf = q.astype(np.float32)
    out = J.decode_cmyk(*map(jnp.asarray, args), jnp.asarray(qf[:, 0]),
                        jnp.asarray(qf[:, 1]), true_h, true_w,
                        bucket_h16(true_h), bucket_w(true_w), subsamp, ycck)
    return np.stack([np.asarray(p) for p in out], axis=1)


DIMS = [(5, 7), (16, 16), (33, 129), (479, 641)]


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("subsamp,ycck", LAYOUTS)
def test_plain_decode_cmyk_matches_jax(subsamp, ycck, dims, wide):
    """decode_cmyk (plain torch) against the JAX decode_cmyk on the same
    numpy coefficients: equal as int32 planes, padding included."""
    true_h, true_w = dims
    grids, q = _grids(subsamp, true_h, true_w, 2, seed=true_w + wide,
                      wide=wide)
    want = _jax_decode(grids, q, subsamp, ycck, true_h, true_w)
    args = []
    for g in _tensors(grids, q)[:4]:
        args += list(tjd.blocks_to_planar(g))
    qt = torch.from_numpy(q)
    got = tjd.decode_cmyk(*args, qt[:, 0], qt[:, 1], true_h, true_w,
                          bucket_h16(true_h), bucket_w(true_w), subsamp, ycck)
    got = np.stack([p.numpy() for p in got], axis=1)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if wide:  # the saturation is reached
        assert (got[:, :, :true_h, :true_w] == 0).any()
        assert (got[:, :, :true_h, :true_w] == 255).any()


@pytest.mark.parametrize("batch,n", [(1, 1), (8, 5)])
@pytest.mark.parametrize("dims", [(5, 7), (479, 641)])
@pytest.mark.parametrize("subsamp,ycck", LAYOUTS)
def test_wrapper_matches_jax(subsamp, ycck, dims, batch, n):
    """The wrapper's CPU path against the JAX decode_cmyk, the padded
    images staged as zero coefficients (as the assembly does)."""
    true_h, true_w = dims
    grids, q = _grids(subsamp, true_h, true_w, batch, seed=5)
    for g in grids:
        g[n:] = 0
    q[n:] = 0
    want = _jax_decode(grids, q, subsamp, ycck, true_h, true_w)
    out_h = bucket_h(true_h)
    got = jk.jpeg_decode_cmyk(*_tensors(grids, q), subsamp, ycck, true_h,
                              true_w, out_h, bucket_w(true_w), n)
    assert got.dtype == torch.uint8
    assert got.shape == (batch, 4, out_h, bucket_w(true_w))
    np.testing.assert_array_equal(got.numpy(),
                                  want[:, :, :out_h].astype(np.uint8))


def _tile_jobs(subsamp, y0, x0, true_h, true_w):
    """make_job<DV, DH, 2> over one tile's slots: [(plane, gby, gbx, kind,
    dst)] of the jobs that run, planes 0 y, 1 cb, 2 cr, 3 k."""
    dv, dh = DIVISORS[subsamp]
    th = jk.decode_tile(subsamp)[0]
    cth, ctw = th // dv, TW // dh
    ybw, cbh, cbw = TW // 8, cth // 8, ctw // 8
    n_y = (th // 8) * ybw
    n_row = cbw + (2 if dh == 2 else 0) if dv == 2 else 0
    n_col = cbh if dh == 2 else 0
    n_plane = cbh * cbw + 2 * n_col
    n_group = 2 * n_y + 2 * n_plane
    n_row_jobs = 2 * 2 * n_row
    ch, cw = -(-true_h // dv), -(-true_w // dh)
    cy0, cx0 = y0 // dv, x0 // dh
    jobs = []
    for idx in range(n_group + -(-n_row_jobs // 8)):
        for j in range(8 if idx >= n_group else 1):
            kind = FULL
            if idx < 2 * n_y:
                plane = 3 if idx >= n_y else 0
                e = idx - n_y if plane else idx
                gby, gbx = y0 // 8 + e // ybw, x0 // 8 + e % ybw
                if gby * 8 < true_h and gbx * 8 < true_w:
                    jobs.append((plane, gby, gbx, kind,
                                 (gby * 8 - y0) * TW + gbx * 8 - x0))
                continue
            if idx < n_group:
                k = idx - 2 * n_y
                plane = 1 if k < n_plane else 2
                k -= (plane - 1) * n_plane
                if k < cbh * cbw:
                    gby, gbx = cy0 // 8 + k // cbw, cx0 // 8 + k % cbw
                    on = True
                else:
                    k -= cbh * cbw
                    right = k >= n_col
                    gby = cy0 // 8 + (k - n_col if right else k)
                    gbx = cx0 // 8 + cbw if right else cx0 // 8 - 1
                    kind = COL0 if right else COL7
                    on = gbx >= 0
            else:
                k = (idx - n_group) * 8 + j
                if k >= n_row_jobs:
                    continue
                plane = 1 if k < 2 * n_row else 2
                k -= (plane - 1) * 2 * n_row
                below = k >= n_row
                gbx = cx0 // 8 - (1 if dh == 2 else 0) + (k - n_row if below
                                                          else k)
                gby = cy0 // 8 + cbh if below else cy0 // 8 - 1
                kind = ROW0 if below else ROW7
                on = gbx >= 0 and (cy0 + cth < ch if below else cy0 > 0)
            on = on and gby * 8 < ch and gbx * 8 < cw
            if on:
                jobs.append((plane, gby, gbx, kind,
                             (gby * 8 - cy0 + 1) * PITCH + gbx * 8 - cx0
                             + PAD))
    return jobs


def _emulate(grids, q, subsamp, ycck, true_h, true_w, out_h, out_w, n,
             seed=0):
    """The kernel's output, CTA by CTA. Returns (out, tiles that decoded,
    halo jobs run)."""
    rng = np.random.default_rng(seed)
    dv, dh = DIVISORS[subsamp]
    th = jk.decode_tile(subsamp)[0]
    ch, cw = -(-true_h // dv), -(-true_w // dh)
    b = grids[0].shape[0]
    out = np.full((b, 4, out_h, out_w), 77, np.uint8)  # every byte written
    decoded = halos = 0
    for i in range(b):
        for y0 in range(0, out_h, th):
            for x0 in range(0, out_w, TW):
                ly, lx = np.mgrid[0:th, 0:TW]
                gy, gx = y0 + ly, x0 + lx
                rows = gy < out_h
                inside = (gy < true_h) & (gx < true_w)
                if not (i < n and y0 < true_h and x0 < true_w):
                    for p in range(4):
                        v = PAD_VALUE[ycck][p] if i >= n else 0
                        out[i, p, gy[rows], gx[rows]] = np.where(
                            inside, v, 0)[rows]
                    continue
                decoded += 1
                s_l = rng.integers(0, 256, (2, th * TW), dtype=np.uint8)
                s_c = rng.integers(0, 256, (2, ROWS * PITCH), dtype=np.uint8)
                jobs = _tile_jobs(subsamp, y0, x0, true_h, true_w)
                halos += sum(kind != FULL for *_, kind, _ in jobs)
                blocks = np.stack([grids[p][i, gby, gbx]
                                   for p, gby, gbx, _, _ in jobs])
                qs = np.stack([q[i, 1 if p in (1, 2) else 0]
                               for p, *_ in jobs])
                kinds = np.array([job[3] for job in jobs])
                smp = _decode_jobs(blocks, qs, kinds)
                for (p, _, _, kind, dst), s in zip(jobs, smp):
                    if p in (0, 3):
                        buf, pitch = s_l[0 if p == 0 else 1], TW
                    else:
                        buf, pitch = s_c[p - 1], PITCH
                    if kind == FULL:
                        for r in range(8):
                            buf[dst + r * pitch:dst + r * pitch + 8] = s[r]
                    elif kind in (ROW0, ROW7):
                        r = 0 if kind == ROW0 else 7
                        buf[dst + r * pitch:dst + r * pitch + 8] = s[r]
                    else:
                        c = 0 if kind == COL0 else 7
                        for r in range(8):
                            buf[dst + r * pitch + c] = s[r, c]
                yy = s_l[0].reshape(th, TW).astype(np.int32)
                kk = s_l[1].reshape(th, TW).astype(np.int32)
                cy0, cx0 = y0 // dv, x0 // dh
                vy, vx = np.mgrid[0:th, 0:TW:16]
                live = (y0 + vy < true_h).ravel()
                gyv, gxv = (y0 + vy).ravel()[live], (x0 + vx).ravel()[live]
                chroma = []
                for p in range(2):
                    v = np.zeros((th * TW // 16, 16), np.int32)
                    v[live] = _chroma16(s_c[p], cy0, cx0, ch, cw, gyv, gxv,
                                        subsamp)
                    chroma.append(v.reshape(th, TW))
                if ycck:
                    cbz, crz = (c - 128 for c in chroma)
                    planes = (yy + ((91881 * crz + 32768) >> 16),
                              yy + ((-22554 * cbz + 32768 - 46802 * crz)
                                    >> 16),
                              yy + ((116130 * cbz + 32768) >> 16))
                else:
                    planes = (255 - yy, 255 - chroma[0], 255 - chroma[1])
                for p, v in enumerate((*planes, 255 - kk)):
                    px = np.where(inside, np.clip(v, 0, 255), 0)
                    out[i, p, gy[rows], gx[rows]] = px[rows]
    return out, decoded, halos


def _edges(subsamp):
    th = jk.decode_tile(subsamp)[0]
    return [(th, TW), (th - 1, TW - 1), (th + 1, TW + 1), (16, 16), (15, 17),
            (5, 7), (479, 641)]


CASES = ([(s, y, h, w, 1, 1) for s, y in LAYOUTS for h, w in _edges(s)]
         + [(s, y, 479, 641, 8, 5) for s, y in LAYOUTS])


@pytest.mark.parametrize("subsamp,ycck,true_h,true_w,batch,n", CASES)
def test_partition_matches_plain(subsamp, ycck, true_h, true_w, batch, n):
    grids, q = _grids(subsamp, true_h, true_w, batch, seed=true_h * 7 + n)
    out_h, out_w = bucket_h(true_h), bucket_w(true_w)
    want = jk.jpeg_decode_cmyk_ref(*_tensors(grids, q), subsamp, ycck,
                                   true_h, true_w, out_h, out_w, n)
    got, decoded, halos = _emulate(grids, q, subsamp, ycck, true_h, true_w,
                                   out_h, out_w, n)
    np.testing.assert_array_equal(got, want.numpy())
    th = jk.decode_tile(subsamp)[0]
    assert decoded == n * -(-true_h // th) * -(-true_w // TW)
    if subsamp == 444:
        assert halos == 0
    elif true_h > th or true_w > TW:
        assert halos > 0  # 4:2:0 across tiles: the halo is exercised


@pytest.mark.parametrize("bad", ["subsamp", "plain420", "k_shape", "k_dtype",
                                 "n", "width"])
def test_wrapper_rejects_bad_arguments(bad):
    grids, q = _grids(420, 37, 23, 2, seed=3)
    y, cb, cr, k, qt = _tensors(grids, q)
    args = dict(subsamp=420, ycck=True, true_h=37, true_w=23, out_h=40,
                out_w=128, n=2)
    if bad == "subsamp":
        args["subsamp"] = 422
    elif bad == "plain420":
        args["ycck"] = False
    elif bad == "k_shape":
        k = cb.clone()
    elif bad == "k_dtype":
        k = k.to(torch.int32)
    elif bad == "n":
        args["n"] = 3
    else:
        args["out_w"] = 120
    with pytest.raises(ValueError):
        jk.jpeg_decode_cmyk(y, cb, cr, k, qt, **args)


def test_cpu_launches_nothing():
    grids, q = _grids(444, 20, 20, 1, seed=1)
    jk.reset_launch_counts()
    jk.jpeg_decode_cmyk(*_tensors(grids, q), 444, False, 20, 20, 32, 128, 1)
    assert jk.launch_counts()["jpeg_decode_cmyk"] == 0
