"""The coefficient decode back half in plain torch: dequant, the
bit-exact libjpeg islow iDCT, the fancy chroma upsample and the
jdcolor YCbCr->RGB conversion.

Port of fanlin_tpu/ops/jpeg_decode.py:88-361 and :645 with the same
names and the same int32 arithmetic (arithmetic right shifts, wrapping
products, saturation after the iDCT), on the device of the given
tensors. These are the plain versions of the two CUDA kernels in
`ops.jpeg_decode_kernels` (K3 `jpeg_islow`, K4 `jpeg_upsample_rgb`),
and the tests hold each against its JAX twin array for array.
"""

from __future__ import annotations

import torch

_I32 = torch.int32
_F32 = torch.float32

_ISLOW_PASS1_SHIFT = 11  # CONST_BITS - PASS1_BITS
_ISLOW_PASS2_SHIFT = 18  # CONST_BITS + PASS1_BITS + 3


def _islow_pass(s, shift):
    """One 8-point islow pass over 8 same-shaped int32 tensors
    (jidctint.c's column/row loop body, tensor-at-a-time), with the
    FIX_* constants at CONST_BITS=13."""
    z2, z3 = s[2], s[6]
    z1 = (z2 + z3) * 4433             # FIX_0_541196100
    t2 = z1 - z3 * 15137              # - FIX_1_847759065
    t3 = z1 + z2 * 6270               # + FIX_0_765366865
    z2, z3 = s[0], s[4]
    t0 = (z2 + z3) << 13
    t1 = (z2 - z3) << 13
    e0, e3 = t0 + t3, t0 - t3
    e1, e2 = t1 + t2, t1 - t2
    o0, o1, o2, o3 = s[7], s[5], s[3], s[1]
    z1 = o0 + o3
    z2 = o1 + o2
    z3 = o0 + o2
    z4 = o1 + o3
    z5 = (z3 + z4) * 9633             # FIX_1_175875602
    o0 = o0 * 2446                    # FIX_0_298631336
    o1 = o1 * 16819                   # FIX_2_053119869
    o2 = o2 * 25172                   # FIX_3_072711026
    o3 = o3 * 12299                   # FIX_1_501321110
    z1 = z1 * -7373                   # - FIX_0_899976223
    z2 = z2 * -20995                  # - FIX_2_562915447
    z3 = z3 * -16069 + z5             # - FIX_1_961570560
    z4 = z4 * -3196 + z5              # - FIX_0_390180644
    o0 = o0 + z1 + z3
    o1 = o1 + z2 + z4
    o2 = o2 + z2 + z3
    o3 = o3 + z1 + z4
    rnd = 1 << (shift - 1)

    def des(v):  # libjpeg DESCALE: round half up, arithmetic shift
        return (v + rnd) >> shift

    return [des(e0 + o3), des(e1 + o2), des(e2 + o1), des(e3 + o0),
            des(e3 - o0), des(e2 - o1), des(e1 - o2), des(e0 - o3)]


def islow_idct_planar(coef_i32: torch.Tensor) -> torch.Tensor:
    """(B, H, W) int32 dequantized planar coefficients (DC included)
    -> (B, H, W) int32 samples in [0, 255]: the column pass (shift 11),
    the row pass (shift 18), +128 and saturation."""
    b, h, w = coef_i32.shape
    v = coef_i32.reshape(b, h // 8, 8, w)
    ws = _islow_pass([v[:, :, u, :] for u in range(8)], _ISLOW_PASS1_SHIFT)
    t = torch.stack(ws, dim=2).reshape(b, h, w)
    v2 = t.reshape(b, h, w // 8, 8)
    out = _islow_pass([v2[:, :, :, u] for u in range(8)], _ISLOW_PASS2_SHIFT)
    o = torch.stack(out, dim=3).reshape(b, h, w)
    return torch.clamp(o + 128, 0, 255).to(_I32)


def islow_decode_plane(dc_i16, ac_planar, q, shape=None) -> torch.Tensor:
    """Dequantize and iDCT one plane.

    ac_planar: (B, H, W) planar AC with the DC slots zero, or None for
    a DC-only plane (`shape` then gives (H, W)); dc_i16: (B, H/8, W/8),
    injected into the DC slots before the butterfly; q: (B, 64)
    natural-order quant tables (integer-valued). Returns (B, H, W)
    int32 samples in [0, 255]."""
    if ac_planar is not None:
        b, h, w = ac_planar.shape
        dev = ac_planar.device
    else:
        b, (h, w) = dc_i16.shape[0], shape
        dev = dc_i16.device
    bh, bw = h // 8, w // 8
    qi = q.to(_I32)
    if ac_planar is not None:
        qtile = qi.reshape(b, 8, 8)[:, None, :, None, :].expand(
            b, bh, 8, bw, 8).reshape(b, h, w)
        coef = ac_planar.to(_I32) * qtile
    else:
        coef = torch.zeros((b, h, w), dtype=_I32, device=dev)
    dcq = dc_i16.to(_I32) * qi[:, 0][:, None, None]
    v = coef.reshape(b, bh, 8, bw, 8).clone()
    v[:, :, 0, :, 0] += dcq
    return islow_idct_planar(v.reshape(b, h, w))


def _clamp_prev(c, dim):
    """c shifted by one along `dim`, the first entry repeated."""
    first = c.narrow(dim, 0, 1)
    return torch.cat([first, c.narrow(dim, 0, c.shape[dim] - 1)], dim=dim)


def _clamp_next(c, dim):
    """c shifted back by one along `dim`, the last entry repeated."""
    n = c.shape[dim]
    return torch.cat([c.narrow(dim, 1, n - 1), c.narrow(dim, n - 1, 1)],
                     dim=dim)


def fancy_upsample_h2v2(c_i32: torch.Tensor) -> torch.Tensor:
    """libjpeg h2v2_fancy_upsample (jdsample.c), bit-exact. c_i32:
    (B, ch, cw) int32 at the TRUE chroma dims (the edge cases are the
    interior formulas with the neighbour clamped to the sample itself).
    Returns (B, 2*ch, 2*cw) int32."""
    b, ch, cw = c_i32.shape
    colsum_up = 3 * c_i32 + _clamp_prev(c_i32, 1)   # output row 2r
    colsum_dn = 3 * c_i32 + _clamp_next(c_i32, 1)   # output row 2r+1
    colsum = torch.stack([colsum_up, colsum_dn], dim=2).reshape(b, 2 * ch, cw)
    out_even = (3 * colsum + _clamp_prev(colsum, 2) + 8) >> 4
    out_odd = (3 * colsum + _clamp_next(colsum, 2) + 7) >> 4
    return torch.stack([out_even, out_odd], dim=3).reshape(b, 2 * ch, 2 * cw)


def fancy_upsample_h2v1(c_i32: torch.Tensor) -> torch.Tensor:
    """libjpeg h2v1_fancy_upsample, bit-exact: out[2c] = (3*in[c] +
    in[c-1] + 1) >> 2, out[2c+1] = (3*in[c] + in[c+1] + 2) >> 2,
    neighbours clamped."""
    b, h, cw = c_i32.shape
    even = (3 * c_i32 + _clamp_prev(c_i32, 2) + 1) >> 2
    odd = (3 * c_i32 + _clamp_next(c_i32, 2) + 2) >> 2
    return torch.stack([even, odd], dim=3).reshape(b, h, 2 * cw)


def fancy_upsample_v2h1(c_i32: torch.Tensor) -> torch.Tensor:
    """The vertical twin of fancy_upsample_h2v1 (4:4:0 chroma)."""
    b, ch, w = c_i32.shape
    even = (3 * c_i32 + _clamp_prev(c_i32, 1) + 1) >> 2
    odd = (3 * c_i32 + _clamp_next(c_i32, 1) + 2) >> 2
    return torch.stack([even, odd], dim=2).reshape(b, 2 * ch, w)


# libjpeg jdcolor.c fixed-point constants: FIX(x) = round(x * 2^16)
_FIX_1_40200 = 91881
_FIX_1_77200 = 116130
_FIX_0_71414 = 46802
_FIX_0_34414 = 22554
_ONE_HALF = 1 << 15


def ycbcr_to_rgb_int(y_i32, cb_i32, cr_i32):
    """jdcolor ycc_rgb_convert in int32; (r, g, b) int32 in [0, 255]."""
    cbz = cb_i32 - 128
    crz = cr_i32 - 128
    r = y_i32 + ((_FIX_1_40200 * crz + _ONE_HALF) >> 16)
    b = y_i32 + ((_FIX_1_77200 * cbz + _ONE_HALF) >> 16)
    g = y_i32 + ((-_FIX_0_34414 * cbz + _ONE_HALF - _FIX_0_71414 * crz) >> 16)
    return tuple(torch.clamp(v, 0, 255) for v in (r, g, b))


def ycbcr_to_rgb_libjpeg(y_i32, cb_i32, cr_i32):
    """Exact libjpeg ycc_rgb_convert; (r, g, b) f32 planes in [0, 255]
    (the JAX package's signature)."""
    return tuple(v.to(_F32) for v in ycbcr_to_rgb_int(y_i32, cb_i32, cr_i32))


def chroma_divisors(subsamp: int):
    """(vertical, horizontal) chroma downsampling divisors of a
    subsampling layout."""
    return {400: (1, 1), 420: (2, 2), 422: (1, 2), 440: (2, 1),
            444: (1, 1)}[subsamp]


def upsample_chroma(c_i32, subsamp: int, true_h: int, true_w: int):
    """A decoded chroma plane (B, >= true chroma dims) brought to
    (B, true_h, true_w) by the layout's fancy upsample, run at the TRUE
    chroma dims (where libjpeg's edge handling sits)."""
    dv, dh = chroma_divisors(subsamp)
    ch, cw = -(-true_h // dv), -(-true_w // dh)
    c = c_i32[:, :ch, :cw]
    if subsamp == 420:
        c = fancy_upsample_h2v2(c)
    elif subsamp == 422:
        c = fancy_upsample_h2v1(c)
    elif subsamp == 440:
        c = fancy_upsample_v2h1(c)
    return c[:, :true_h, :true_w]


def _decode_rgb(subsamp, ydc, yac, cbdc, cbac, crdc, crac, lq, cq,
                true_h, true_w, pad_h, pad_w):
    dv, dh = chroma_divisors(subsamp)
    yplane = islow_decode_plane(ydc, yac, lq, (pad_h, pad_w))
    cshape = (pad_h // dv, pad_w // dh)
    cb = islow_decode_plane(cbdc, cbac, cq, cshape)
    cr = islow_decode_plane(crdc, crac, cq, cshape)
    r, g, b = ycbcr_to_rgb_libjpeg(
        yplane[:, :true_h, :true_w],
        upsample_chroma(cb, subsamp, true_h, true_w),
        upsample_chroma(cr, subsamp, true_h, true_w))
    pad = (0, pad_w - true_w, 0, pad_h - true_h)
    return tuple(torch.nn.functional.pad(p, pad) for p in (r, g, b))


def decode420_rgb(ydc, yac, cbdc, cbac, crdc, crac, lq, cq,
                  true_h: int, true_w: int, pad_h: int, pad_w: int):
    """The decode back half of a 4:2:0 batch: grids block-padded to
    (pad_h/8, pad_w/8) luma and (pad_h/16, pad_w/16) chroma blocks.
    Returns (r, g, b) f32 planes (B, pad_h, pad_w), zero outside the
    true rect."""
    return _decode_rgb(420, ydc, yac, cbdc, cbac, crdc, crac, lq, cq,
                       true_h, true_w, pad_h, pad_w)


def decode422_rgb(ydc, yac, cbdc, cbac, crdc, crac, lq, cq,
                  true_h: int, true_w: int, pad_h: int, pad_w: int):
    """4:2:2: chroma at full height, half width."""
    return _decode_rgb(422, ydc, yac, cbdc, cbac, crdc, crac, lq, cq,
                       true_h, true_w, pad_h, pad_w)


def decode440_rgb(ydc, yac, cbdc, cbac, crdc, crac, lq, cq,
                  true_h: int, true_w: int, pad_h: int, pad_w: int):
    """4:4:0: chroma at half height, full width."""
    return _decode_rgb(440, ydc, yac, cbdc, cbac, crdc, crac, lq, cq,
                       true_h, true_w, pad_h, pad_w)


def decode444_rgb(ydc, yac, cbdc, cbac, crdc, crac, lq, cq,
                  true_h: int, true_w: int, pad_h: int, pad_w: int):
    """4:4:4: chroma at full resolution, no upsample."""
    return _decode_rgb(444, ydc, yac, cbdc, cbac, crdc, crac, lq, cq,
                       true_h, true_w, pad_h, pad_w)


def blocks_to_planar(blocks: torch.Tensor):
    """(B, bh, bw, 64) natural-order block grids -> (dc (B, bh, bw),
    planar AC (B, 8*bh, 8*bw) with the DC slots zero), the layout
    islow_decode_plane takes."""
    b, bh, bw, _ = blocks.shape
    dc = blocks[..., 0]
    ac = blocks.clone()
    ac[..., 0] = 0
    planar = ac.reshape(b, bh, bw, 8, 8).permute(0, 1, 3, 2, 4).reshape(
        b, bh * 8, bw * 8)
    return dc, planar
