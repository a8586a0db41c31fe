"""The fused decode kernel `jpeg_decode_rgb` (csrc/jpeg_decode.cu) on the
CPU: an emulation of its work partition, and its wrapper's CPU path.

The CUDA kernel cannot run here, so `_emulate` repeats what its CTAs do,
with each layout's tile (`decode_tile`, from the sizes ops/_build.py
passes to nvcc): which tiles decode and
which store a constant (padding, padded images), the jobs of a tile in
the kernel's order (blocks skipped outside the true rect, the halo rows
and columns each tile recomputes with the edge passes, the corners),
the tile's shared sample buffers (filled with noise first, so that a read
of a sample no job wrote shows), the clamps at the true chroma dims and
the vector masked at true_w. Its output must equal `jpeg_decode_rgb_ref`
byte for byte; the wrapper's CPU path must equal the JAX package's
decode{420,422,440,444}_rgb on the same coefficients. No tolerance: all
of it is integer work.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (BLOCK_OPS, COL_JOB_OPS, DIVISORS, EDGE_OPS,
                        PASS_OPS, ROW_JOB_OPS, halo_share)
from fanlin_tpu.ops import jpeg_decode as J
from fanlin_tpu_torch.ops import _build
from fanlin_tpu_torch.ops import jpeg_decode_kernels as jk
from fanlin_tpu_torch.ops.plan import bucket_h, bucket_h16, bucket_w

TW = _build.DEC_TILE_W
PAD = 16  # kCPad
# a tile's chroma buffer (kCPitch, kCRows)
PITCH, ROWS = TW + 2 * PAD, _build.DEC_TILE_H + 2
FULL, ROW0, ROW7, COL0, COL7 = range(5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pass(s, shift):
    """islow_pass on a list of 8 int32 arrays (wrapping)."""
    z2, z3 = s[2], s[6]
    z1 = (z2 + z3) * 4433
    t2 = z1 - z3 * 15137
    t3 = z1 + z2 * 6270
    t0 = (s[0] + s[4]) << 13
    t1 = (s[0] - s[4]) << 13
    e0, e3, e1, e2 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    o0, o1, o2, o3 = s[7], s[5], s[3], s[1]
    z5 = ((o0 + o2) + (o1 + o3)) * 9633
    z1 = (o0 + o3) * -7373
    z2 = (o1 + o2) * -20995
    z3 = (o0 + o2) * -16069 + z5
    z4 = (o1 + o3) * -3196 + z5
    o0 = o0 * 2446 + z1 + z3
    o1 = o1 * 16819 + z2 + z4
    o2 = o2 * 25172 + z2 + z3
    o3 = o3 * 12299 + z1 + z4
    rnd = np.int32(1 << (shift - 1))
    return [(v + rnd) >> shift for v in
            (e0 + o3, e1 + o2, e2 + o1, e3 + o0, e3 - o0, e2 - o1, e1 - o2,
             e0 - o3)]


# islow_edge's weights: a pass is linear before its rounding shift and
# int32 arithmetic wraps, so out[0] and out[7] are dot products
EDGE_K = [8192, 11363, 10703, 9633, 8192, 6437, 4433, 2260]


def _edge(s, shift, last):
    """islow_edge: out[7] (last) or out[0] of the pass, as the kernel
    computes it (a halo row accumulates the same products row by row;
    wrapping sums do not depend on the order)."""
    even = sum(np.int32(EDGE_K[u]) * s[u] for u in range(0, 8, 2))
    odd = sum(np.int32(EDGE_K[u]) * s[u] for u in range(1, 8, 2))
    return ((even - odd if last else even + odd)
            + np.int32(1 << (shift - 1))) >> shift


def _samples(v):
    return np.clip(v + 128, 0, 255).astype(np.uint8)


def _tile_jobs(subsamp, y0, x0, true_h, true_w):
    """make_job over one tile's slots and their 8 threads: [(plane, gby,
    gbx, kind, dst)] of the jobs that run, in the kernel's order (a job
    of 8 threads once, a halo row per thread)."""
    dv, dh = DIVISORS[subsamp]
    th = jk.decode_tile(subsamp)[0]
    cth, ctw = th // dv, TW // dh
    ybw, cbh, cbw = TW // 8, cth // 8, ctw // 8
    n_y = (th // 8) * ybw
    n_row = cbw + (2 if dh == 2 else 0) if dv == 2 else 0
    n_col = cbh if dh == 2 else 0
    n_plane = cbh * cbw + 2 * n_col
    n_group = n_y + 2 * n_plane
    n_row_jobs = 2 * 2 * n_row
    ch, cw = -(-true_h // dv), -(-true_w // dh)
    cy0, cx0 = y0 // dv, x0 // dh
    jobs = []
    for idx in range(n_group + -(-n_row_jobs // 8)):
        for j in range(8 if idx >= n_group else 1):
            kind = FULL
            if idx < n_y:
                plane = 0
                gby, gbx = y0 // 8 + idx // ybw, x0 // 8 + idx % ybw
                on = gby * 8 < true_h and gbx * 8 < true_w
                dst = (gby * 8 - y0) * TW + gbx * 8 - x0
                jobs += [(plane, gby, gbx, kind, dst)] if on else []
                continue
            if idx < n_group:
                k = idx - n_y
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
            dst = (gby * 8 - cy0 + 1) * PITCH + gbx * 8 - cx0 + PAD
            if on:
                jobs.append((plane, gby, gbx, kind, dst))
    return jobs


def _decode_jobs(blocks, q, kinds):
    """What each job leaves: blocks (N, 64) int16, q (N, 64) int32 ->
    (N, 8, 8) u8 samples (only the row or column a halo job makes is
    meaningful). A halo row takes edge column passes, then one row
    pass; a halo column full column passes, then edge row passes."""
    ws = (blocks.astype(np.int32) * q).reshape(-1, 8, 8)  # [u][v]
    cols = _pass([ws[:, u, :] for u in range(8)], 11)       # column passes
    full = np.stack(cols, axis=1)
    for kind, row, last in ((ROW0, 0, False), (ROW7, 7, True)):
        sel = kinds == kind  # the other rows stay as dequantized
        ws[sel, row, :] = _edge([w[sel] for w in
                                 [ws[:, u, :] for u in range(8)]], 11, last)
    keep = (kinds == FULL) | (kinds == COL0) | (kinds == COL7)
    ws[keep] = full[keep]
    out = np.stack(_pass([ws[:, :, v] for v in range(8)], 18), axis=2)
    for kind, col, last in ((COL0, 0, False), (COL7, 7, True)):
        sel = kinds == kind
        out[sel, :, col] = _edge([ws[sel, :, v] for v in range(8)], 18, last)
    return _samples(out)


def _chroma16(c, cy0, cx0, ch, cw, y, x, subsamp):
    """chroma16 over arrays of vectors: y, x (V,) the row and first pixel
    of each 16-pixel vector -> (V, 16) upsampled chroma, by the kernel's
    loads (8 or 16 samples and one beyond each side) and selects."""
    half_y = subsamp in (420, 440)
    cy = y >> 1 if half_y else y
    ny = np.where(y & 1, np.minimum(cy + 1, ch - 1), np.maximum(cy - 1, 0))

    def row(r, first, count):  # samples first-1 .. first+count of row r
        base = (r - cy0 + 1) * PITCH + first - cx0 + PAD
        idx = base[:, None] + np.arange(-1, count + 1)[None, :]
        return c[idx].astype(np.int32)

    if subsamp in (444, 440):
        near = row(cy, x, 16)[:, 1:17]
        if subsamp == 444:
            return near
        far = row(ny, x, 16)[:, 1:17]
        return (3 * near + far + np.where(y & 1, 2, 1)[:, None]) >> 2
    cxs = x >> 1
    col = row(cy, cxs, 8)
    if subsamp == 420:
        col = 3 * col + row(ny, cxs, 8)
    out = np.empty((len(x), 16), np.int32)
    for k in range(8):
        self = col[:, k + 1]
        left = col[:, k] if k > 0 else np.where(cxs > 0, col[:, 0], self)
        right = np.where(cxs + k + 1 <= cw - 1, col[:, k + 2], self)
        if subsamp == 420:
            out[:, 2 * k] = (3 * self + left + 8) >> 4
            out[:, 2 * k + 1] = (3 * self + right + 7) >> 4
        else:
            out[:, 2 * k] = (3 * self + left + 1) >> 2
            out[:, 2 * k + 1] = (3 * self + right + 2) >> 2
    return out


def _emulate(y, cb, cr, q, subsamp, true_h, true_w, out_h, out_w, n, seed=0):
    """The kernel's output, CTA by CTA. Returns (out, tiles that decoded,
    halo jobs run)."""
    rng = np.random.default_rng(seed)
    dv, dh = DIVISORS[subsamp]
    th = jk.decode_tile(subsamp)[0]
    ch, cw = -(-true_h // dv), -(-true_w // dh)
    b = y.shape[0]
    grids = (y, cb, cr)
    out = np.full((b, 3, out_h, out_w), 77, np.uint8)  # every byte written
    decoded = halos = 0
    for i in range(b):
        for y0 in range(0, out_h, th):
            for x0 in range(0, out_w, TW):
                ly, lx = np.mgrid[0:th, 0:TW]
                gy, gx = y0 + ly, x0 + lx
                rows = gy < out_h
                inside = (gy < true_h) & (gx < true_w)
                if not (i < n and y0 < true_h and x0 < true_w):
                    v = 128 if i >= n else 0
                    for p in range(3):
                        out[i, p, gy[rows], gx[rows]] = np.where(
                            inside, v, 0)[rows]
                    continue
                decoded += 1
                s_y = rng.integers(0, 256, th * TW, dtype=np.uint8)
                s_c = rng.integers(0, 256, (2, ROWS * PITCH), dtype=np.uint8)
                jobs = _tile_jobs(subsamp, y0, x0, true_h, true_w)
                halos += sum(kind != FULL for *_, kind, _ in jobs)
                blocks = np.stack([grids[p][i, gby, gbx]
                                   for p, gby, gbx, _, _ in jobs])
                qs = np.stack([q[i, min(p, 1)] for p, *_ in jobs])
                kinds = np.array([job[3] for job in jobs])
                smp = _decode_jobs(blocks, qs, kinds)
                for (p, _, _, kind, dst), s in zip(jobs, smp):
                    buf, pitch = (s_y, TW) if p == 0 else (s_c[p - 1], PITCH)
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
                yy = s_y.reshape(th, TW).astype(np.int32)
                cy0, cx0 = y0 // dv, x0 // dh
                # one 16-pixel vector per thread; the rows past true_h
                # read nothing (their vectors are zero)
                vy, vx = np.mgrid[0:th, 0:TW:16]
                live = (y0 + vy < true_h).ravel()
                gyv, gxv = (y0 + vy).ravel()[live], (x0 + vx).ravel()[live]
                chroma = []
                for p in range(2):
                    v = np.zeros((th * TW // 16, 16), np.int32)
                    v[live] = _chroma16(s_c[p], cy0, cx0, ch, cw, gyv, gxv,
                                        subsamp)
                    chroma.append(v.reshape(th, TW) - 128)
                cbz, crz = chroma
                r_ = yy + ((91881 * crz + 32768) >> 16)
                b_ = yy + ((116130 * cbz + 32768) >> 16)
                g_ = yy + ((-22554 * cbz + 32768 - 46802 * crz) >> 16)
                for p, v in enumerate((r_, g_, b_)):
                    px = np.where(inside, np.clip(v, 0, 255), 0)
                    out[i, p, gy[rows], gx[rows]] = px[rows]
    return out, decoded, halos


def _grids(subsamp, true_h, true_w, batch, n, seed, gray=False):
    """Seeded block grids at the bucket's block grid (int16, the
    assembly's wire) and quant tables; images i >= n hold noise, which
    the kernel must never read."""
    rng = np.random.default_rng(seed)
    dv, dh = DIVISORS[subsamp]
    gh, gw = bucket_h16(true_h), bucket_w(true_w)
    out = []
    for k, (bh, bw) in enumerate([(gh // 8, gw // 8)]
                                 + [(gh // (8 * dv), gw // (8 * dh))] * 2):
        g = np.zeros((batch, bh, bw, 64), np.int16)
        g[..., 0] = rng.integers(-120, 120, (batch, bh, bw))
        g[..., 1:12] = rng.integers(-25, 25, (batch, bh, bw, 11))
        g[..., 12:30] = rng.integers(-3, 3, (batch, bh, bw, 18))
        if gray and k:
            g[:] = 0
        out.append(g)
    q = rng.integers(1, 40, (batch, 2, 64)).astype(np.int32)
    return out, q


def _tensors(grids, q):
    return [torch.from_numpy(a) for a in (*grids, q)]


# (subsamp, true_h, true_w, batch, n): MCU and tile edges (at, one under,
# one over the layout's tile), 7x5, 641x479 and a padded batch; gray
# arrives as 4:4:4 with zero chroma.
LAYOUTS = (420, 422, 440, 444, "gray")


def _edges(subsamp):
    th = jk.decode_tile(444 if subsamp == "gray" else subsamp)[0]
    return [(th, TW), (th - 1, TW - 1), (th + 1, TW + 1), (16, 16), (15, 17),
            (17, 15), (5, 7), (479, 641)]


CASES = ([(s, h, w, 1, 1) for s in LAYOUTS for h, w in _edges(s)]
         + [(s, 479, 641, 8, 5) for s in LAYOUTS])


@pytest.mark.parametrize("subsamp,true_h,true_w,batch,n", CASES)
def test_partition_matches_plain(subsamp, true_h, true_w, batch, n):
    gray = subsamp == "gray"
    subsamp = 444 if gray else subsamp
    grids, q = _grids(subsamp, true_h, true_w, batch, n, seed=true_h * 7 + n,
                      gray=gray)
    out_h, out_w = bucket_h(true_h), bucket_w(true_w)
    want = jk.jpeg_decode_rgb_ref(*_tensors(grids, q), subsamp, true_h,
                                  true_w, out_h, out_w, n)
    got, decoded, halos = _emulate(*grids, q, subsamp, true_h, true_w,
                                   out_h, out_w, n)
    np.testing.assert_array_equal(got, want.numpy())
    # only tiles of real images that meet the true rect decode
    th = jk.decode_tile(subsamp)[0]
    assert decoded == n * -(-true_h // th) * -(-true_w // TW)
    dv, dh = DIVISORS[subsamp]
    ch, cw = -(-true_h // dv), -(-true_w // dh)
    if (dv == 1 or ch <= th // dv) and (dh == 1 or cw <= TW // dh):
        assert halos == 0  # one tile of chroma, or no upsample: no halo
    wrapper = jk.jpeg_decode_rgb(*_tensors(grids, q), subsamp, true_h,
                                 true_w, out_h, out_w, n)
    np.testing.assert_array_equal(wrapper.numpy(), want.numpy())


def _split(g):
    """JAX-side (dc, planar AC with DC zeroed) of a block grid."""
    b, bh, bw, _ = g.shape
    ac = g.copy()
    ac[..., 0] = 0
    planar = ac.reshape(b, bh, bw, 8, 8).transpose(0, 1, 3, 2, 4).reshape(
        b, bh * 8, bw * 8)
    return g[..., 0], planar.astype(np.int32)


@pytest.mark.parametrize("batch,n", [(1, 1), (8, 5)])
@pytest.mark.parametrize("dims", [(5, 7), (479, 641),
                                  (2 * _build.DEC_TILE_H + 1, TW - 1)])
@pytest.mark.parametrize("subsamp", LAYOUTS)
def test_wrapper_matches_jax_composition(subsamp, dims, batch, n):
    """The wrapper's CPU path against fanlin_tpu.ops.jpeg_decode's
    decode{420,422,440,444}_rgb on the same numpy coefficients, padded
    into the bucket (padded images as zero coefficients, as the
    assembly stages them)."""
    gray = subsamp == "gray"
    subsamp = 444 if gray else subsamp
    true_h, true_w = dims
    grids, q = _grids(subsamp, true_h, true_w, batch, n, seed=11, gray=gray)
    for g in grids:
        g[n:] = 0
    q[n:] = 0
    pad_h, pad_w = bucket_h16(true_h), bucket_w(true_w)
    args = []
    for g in grids:
        args += list(_split(g))
    qf = q.astype(np.float32)
    want = getattr(J, f"decode{subsamp}_rgb")(
        *map(jnp.asarray, args), jnp.asarray(qf[:, 0]), jnp.asarray(qf[:, 1]),
        true_h, true_w, pad_h, pad_w)
    out_h = bucket_h(true_h)
    want = np.stack([np.asarray(w) for w in want], axis=1)[:, :, :out_h]
    got = jk.jpeg_decode_rgb(*_tensors(grids, q), subsamp, true_h, true_w,
                             out_h, pad_w, n)
    assert got.dtype == torch.uint8 and got.shape == (batch, 3, out_h, pad_w)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))


@pytest.mark.parametrize("shift", [11, 18])
def test_edge_pass_is_the_full_pass_edge(shift):
    """islow_edge's out[0] and out[7] (dot products) equal the full
    pass's, on values whose int32 products overflow too (both wrap)."""
    rng = np.random.default_rng(shift)
    s = [rng.integers(-2**20, 2**20, 4096).astype(np.int32) for _ in range(8)]
    full = _pass(s, shift)
    np.testing.assert_array_equal(_edge(s, shift, False), full[0])
    np.testing.assert_array_equal(_edge(s, shift, True), full[7])


def test_halo_work_stays_under_a_fifth():
    """The integer work a tile recomputes for its chroma halo, against
    its own blocks' (the source note's figures): under the ~20 % at which
    a cluster exchange would pay; none for 4:4:4."""
    assert (PASS_OPS, EDGE_OPS, BLOCK_OPS) == (62, 18, 1248)
    assert (ROW_JOB_OPS, COL_JOB_OPS) == (294, 728)
    shares = {s: halo_share(s, *jk.decode_tile(s))
              for s in (420, 422, 440, 444)}
    assert shares[444] == 0
    assert all(v < 0.2 for v in shares.values()), shares


@pytest.mark.parametrize("bad", ["n", "width", "subsamp", "dims", "device",
                                 "q_shape"])
def test_wrapper_rejects_bad_arguments(bad):
    grids, q = _grids(420, 37, 23, 2, 2, seed=3)
    y, cb, cr, qt = _tensors(grids, q)
    args = dict(subsamp=420, true_h=37, true_w=23, out_h=40, out_w=128, n=2)
    if bad == "n":
        args["n"] = 3
    elif bad == "width":
        args["out_w"] = 120
    elif bad == "subsamp":
        args["subsamp"] = 411
    elif bad == "dims":
        args["out_h"] = 32
    elif bad == "q_shape":
        qt = qt[:, :1].contiguous()
    else:
        y, cb, cr, qt = (t.to("meta") for t in (y, cb, cr, qt))
    with pytest.raises(ValueError):
        jk.jpeg_decode_rgb(y, cb, cr, qt, **args)


def test_cpu_path_never_counts_launches():
    jk.reset_launch_counts()
    grids, q = _grids(420, 37, 23, 1, 1, seed=4)
    jk.jpeg_decode_rgb(*_tensors(grids, q), 420, 37, 23, 40, 128, 1)
    assert jk.launch_counts()["jpeg_decode_rgb"] == 0
