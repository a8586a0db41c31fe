"""The coefficient decode back half in plain torch: dequant, the
bit-exact libjpeg islow iDCT, the fancy chroma upsample and the
jdcolor YCbCr->RGB conversion; and `orient_meta`, EXIF orientation
applied to the coefficient grids on the host.

Port of fanlin_tpu/ops/jpeg_decode.py:88-414, :645 and :925-1025 with
the same names and the same int32 arithmetic (arithmetic right shifts,
wrapping products, saturation after the iDCT), on the device of the
given tensors. These are the plain versions of the CUDA decode kernels
in `ops.jpeg_decode_kernels` (`jpeg_decode_rgb`, and K3/K4 before it;
`decode_cmyk` for `jpeg_decode_cmyk`), and the tests hold each against its JAX twin array for array.

Also the folded decode-resize of `tpu.fast_decode` (K11, from
fanlin_tpu/ops/jpeg_decode.py:436-642): `folded_matrices` composes the
decode's linear steps into the resample matrices on the host (numpy),
and `folded_decode_resample` runs them as full-f32 matrix products in
torch. It is an XLA program in the reference, not a Pallas kernel, and
stays torch code here.
"""

from __future__ import annotations

import numpy as np
import torch

from .chain import bf16_round
from .dct import _dct_matrix

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


def decode_cmyk(ydc, yac, cbdc, cbac, crdc, crac, kdc, kac, lq, cq,
                true_h: int, true_w: int, pad_h: int, pad_w: int,
                subsamp: int, ycck: bool):
    """The decode back half of a 4-component (CMYK / YCCK) batch: the
    plain version of the K12a kernel (fanlin_tpu/ops/jpeg_decode.py:364).
    Returns (c, m, y, k) int32 planes (B, pad_h, pad_w) in PIL's CMYK
    convention, zero outside the true rect:

    * plain CMYK (4:4:4): 255 - islow on each plane (PIL reads every
      CMYK JPEG as "CMYK;I", Adobe's inverted samples);
    * YCCK (4:4:4 or 4:2:0): libjpeg's ycck_cmyk_convert gives C = 255 -
      R'(y, cb, cr) and so on, which PIL's ;I inverts back, so C, M, Y
      are jdcolor's R', G', B'; K = 255 - k.

    K (comp3) is at comp0's rate and on comp0's table (lq)."""
    shape = (pad_h, pad_w)
    if ycck:
        yp = islow_decode_plane(ydc, yac, lq, shape)[:, :true_h, :true_w]
        csub = 2 if subsamp == 420 else 1
        cshape = (pad_h // csub, pad_w // csub)
        cb = islow_decode_plane(cbdc, cbac, cq, cshape)
        cr = islow_decode_plane(crdc, crac, cq, cshape)
        c_p, m_p, y_p = ycbcr_to_rgb_int(
            yp, upsample_chroma(cb, subsamp, true_h, true_w),
            upsample_chroma(cr, subsamp, true_h, true_w))
        k_p = 255 - islow_decode_plane(kdc, kac, lq,
                                       shape)[:, :true_h, :true_w]
    else:
        c_p, m_p, y_p, k_p = (
            255 - islow_decode_plane(dc, ac, q, shape)[:, :true_h, :true_w]
            for dc, ac, q in ((ydc, yac, lq), (cbdc, cbac, cq),
                              (crdc, crac, cq), (kdc, kac, lq)))
    pad = (0, pad_w - true_w, 0, pad_h - true_h)
    return tuple(torch.nn.functional.pad(p, pad)
                 for p in (c_p, m_p, y_p, k_p))


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


# ----------------------------------------------------------------------------
# The folded decode-resize (K11, `tpu.fast_decode`)
# ----------------------------------------------------------------------------
#
# Every step between the dequantised coefficients and the resampled
# pixels is linear (iDCT, triangle chroma upsample, YCbCr->RGB, Lanczos
# resample), so the decode composes into the resample matrices on the
# host:
#     Y_resampled  = (Av·Mv) · C_y · (Ah·Mh)^T
#     Cb_resampled = (Av·Uv·Mv½) · C_cb · (Ah·Uh·Mh½)^T   (half-res)
# and the colour conversion runs on the small resampled planes. The
# staged path's integer roundings (islow, upsample, jdcolor) are skipped,
# so the result is within a few LSB of it (>= 45 dB), not equal: the
# opt-in fast path. Port of fanlin_tpu/ops/jpeg_decode.py:436-642 (the
# dense planar form only).


def _upsample_triangle(n_out: int, n_in: int) -> np.ndarray:
    """The linear part of libjpeg's fancy upsample as an (n_out, n_in)
    matrix: out[2k] = (3c[k] + c[k-1])/4, out[2k+1] = (3c[k] + c[k+1])/4,
    neighbours clamped at the edges."""
    u = np.zeros((n_out, n_in), dtype=np.float32)
    for k in range(n_in):
        if 2 * k < n_out:
            u[2 * k, k] += 0.75
            u[2 * k, max(k - 1, 0)] += 0.25
        if 2 * k + 1 < n_out:
            u[2 * k + 1, k] += 0.75
            u[2 * k + 1, min(k + 1, n_in - 1)] += 0.25
    return u


def _repeat8(n: int) -> np.ndarray:
    """(n, n/8) block-broadcast matrix: R[8i+x, i] = 1."""
    r = np.zeros((n, n // 8), dtype=np.float32)
    for i in range(n // 8):
        r[8 * i : 8 * i + 8, i] = 1.0
    return r


def _fold_blockdiag(a: np.ndarray) -> np.ndarray:
    """a @ blockdiag(D^T) without building the block diagonal: each
    8-column block a[:, 8i:8i+8] @ D^T, D the (u, x) DCT matrix."""
    d = _dct_matrix()
    rows, cols = a.shape
    blocks = a.reshape(rows, cols // 8, 8)
    return np.einsum("rbk,kx->rbx", blocks, d.T.astype(np.float32),
                     dtype=np.float32).reshape(rows, cols)


def folded_matrices(av_pad: np.ndarray, ah_pad: np.ndarray, true_h: int,
                    true_w: int, subsamp: int = 420):
    """The resample matrices composed with the decode's linear prefix.

    av_pad (OH, GH), ah_pad (OW, SW): resample matrices padded to the
    coefficient grid's planar size (crop and canvas folded in, zero past
    the true source). Returns (ay, ahy, acv, ach, dyv, dyh, dcv, dch):
      ay (OH, GH), ahy (OW, SW)     luma: resample ∘ iDCT
      acv, ach                      chroma: resample ∘ upsample ∘ iDCT,
                                    at the chroma grid's planar size
      dyv (OH, GH/8), dyh (OW, SW/8) the luma DC (block-constant) path
      dcv, dch                      the chroma DC path
    4:4:4 (and gray) chroma uses the luma matrices themselves."""
    sh, sw = av_pad.shape[1], ah_pad.shape[1]
    ay = _fold_blockdiag(av_pad)
    ahy = _fold_blockdiag(ah_pad)
    dyv = av_pad @ _repeat8(sh)
    dyh = ah_pad @ _repeat8(sw)
    dv, dh = chroma_divisors(subsamp)

    def chroma(a_pad, n_true, n_pad, halved, fold, dc):
        if not halved:
            return fold, dc
        c = (n_true + 1) // 2
        u = a_pad[:, :n_true] @ _upsample_triangle(n_true, c)
        u_pad = np.zeros((u.shape[0], n_pad // 2), dtype=np.float32)
        u_pad[:, :c] = u
        return _fold_blockdiag(u_pad), u_pad @ _repeat8(n_pad // 2)

    acv, dcv = chroma(av_pad, true_h, sh, dv == 2, ay, dyv)
    ach, dch = chroma(ah_pad, true_w, sw, dh == 2, ahy, dyh)
    return (ay, ahy, acv, ach, dyv, dyh, dcv, dch)


# libjpeg's fixed-point colour ratios, as f32 multipliers
_CR_R = 91881.0 / 65536.0
_CB_B = 116130.0 / 65536.0
_CB_G = 22554.0 / 65536.0
_CR_G = 46802.0 / 65536.0


def folded_decode_resample(ydc, yac, cbdc, cbac, crdc, crac, lq, cq, mats,
                           fast=False):
    """The device side of the folded path (K11): dequantise, one matmul
    pair per plane (luma at the grid's size, chroma at its subsampled
    size) plus a block-constant DC pair, then the colour conversion on
    the resampled planes. All products in full f32, but with `fast`
    (`tpu.fast`, the reference's mm_dtype=bfloat16) the AC pairs': their
    operands and intermediate rounded to bf16, the sums in f32, as
    fanlin_tpu/ops/jpeg_decode.py:571-575. The DC pairs stay f32 there
    too (:594-597).

    ydc (B, GH/8, SW/8) DC grid and yac (B, GH, SW) planar AC with the DC
    slots zero (`blocks_to_planar`), chroma likewise at its grid's size;
    lq, cq (B, 64) natural-order quant tables; mats: `folded_matrices`'
    eight as f32 tensors on the inputs' device. Returns fg (B, 3, OH, OW)
    f32, rounded and clamped like the staged resample's output."""
    ay, ahy, acv, ach, dyv, dyh, dcv, dch = mats
    b = ydc.shape[0]

    def same(t):
        return t

    def pair(x, mv, mh, rnd=same):
        return torch.matmul(rnd(torch.matmul(rnd(mv), rnd(x))),
                            rnd(mh).transpose(0, 1))

    def plane(ac, q, mv, mh):
        _, h, w = ac.shape
        qt = q.to(_F32).reshape(b, 8, 8)[:, None, :, None, :].expand(
            b, h // 8, 8, w // 8, 8).reshape(b, h, w)
        return pair(ac.to(_F32) * qt, mv, mh, bf16_round if fast else same)

    def dc_plane(dc, q, mv, mh, shift):
        v = dc.to(_F32) * (q[:, 0].to(_F32) / 8.0)[:, None, None] + shift
        return pair(v, mv, mh)

    yr = plane(yac, lq, ay, ahy) + dc_plane(ydc, lq, dyv, dyh, 128.0)
    # chroma stays centred (no +128): the colour ratios take it so
    cbz = plane(cbac, cq, acv, ach) + dc_plane(cbdc, cq, dcv, dch, 0.0)
    crz = plane(crac, cq, acv, ach) + dc_plane(crdc, cq, dcv, dch, 0.0)
    r = yr + _CR_R * crz
    g = yr - _CB_G * cbz - _CR_G * crz
    bl = yr + _CB_B * cbz
    fg = torch.stack([r, g, bl], dim=1)
    return torch.floor(torch.clamp(fg, 0.0, 255.0) + 0.5)


# ----------------------------------------------------------------------------
# EXIF orientation in the coefficient domain (jpegtran's transform math)
# ----------------------------------------------------------------------------
#
# Flips and transposes are exact linear maps of the DCT basis, so the
# host rotates the quantized coefficient grids instead of decoded
# pixels, and rotated JPEGs keep the coefficient path:
#   flip-H: reverse block columns, negate odd-v coefficients
#   flip-V: reverse block rows,    negate odd-u coefficients
#   transpose: transpose the block grid AND each block's (u, v)
# Flips are exact only when the flipped axis has no partial MCU.
# Transposes are always grid-exact, turn 4:2:2 into 4:4:0 and back, and
# swap the chroma upsample's row and column rounding (jdsample's +8/+7),
# so an orientation 5-8 source decodes within 1 LSB of the rotated
# pixel decode on chroma, not byte-equal to it.

# natural-order index -> (u, v)
_NAT_U = np.arange(64) // 8
_NAT_V = np.arange(64) % 8
_TRANSPOSE_PERM = (np.arange(64) % 8) * 8 + np.arange(64) // 8  # (u,v)->(v,u)
_SIGN_V = np.where(_NAT_V % 2 == 1, -1, 1).astype(np.int16)  # flip-H signs
_SIGN_U = np.where(_NAT_U % 2 == 1, -1, 1).astype(np.int16)  # flip-V signs


def _grid_flip_h(g: np.ndarray) -> np.ndarray:
    return g[:, ::-1] * _SIGN_V


def _grid_flip_v(g: np.ndarray) -> np.ndarray:
    return g[::-1] * _SIGN_U


def _grid_transpose(g: np.ndarray) -> np.ndarray:
    return g.transpose(1, 0, 2)[:, :, _TRANSPOSE_PERM]


# ops per EXIF orientation, composed to match
# engine.codecs.apply_orientation (t = transpose, then h/v flips in the
# transposed grid)
_ORIENT_OPS = {
    2: "h", 3: "hv", 4: "v",
    5: "t", 6: "th", 7: "tvh", 8: "tv",
}


def orient_meta(meta: dict, orientation: int):
    """Rotate a read_jpeg_coeffs dict in the coefficient domain to
    match codecs.apply_orientation(pixels, orientation). Returns a new
    dict (the input is never mutated), the input itself for orientation
    1 or an out-of-range value, or None when the transform is not
    grid-exact: a flip needs the flipped image axis MCU-aligned."""
    ops = _ORIENT_OPS.get(orientation)
    if ops is None:
        return meta
    subsamp = meta.get("subsamp", 420)
    csv, csh = chroma_divisors(subsamp)
    w, h = meta["w"], meta["h"]
    new_subsamp = subsamp
    if "t" in ops:
        if csv != csh:
            new_subsamp = {422: 440, 440: 422}[subsamp]
        w, h = h, w
        csv, csh = csh, csv
    mcu_w, mcu_h = 8 * csh, 8 * csv
    # flips act on the geometry after the transpose
    if "h" in ops and w % mcu_w:
        return None
    if "v" in ops and h % mcu_h:
        return None

    def xform(g):
        if "t" in ops:
            g = _grid_transpose(g)
        if "v" in ops:
            g = _grid_flip_v(g)
        if "h" in ops:
            g = _grid_flip_h(g)
        return np.ascontiguousarray(g)

    # a shallow copy is the port's fork_meta: its metas carry no shared
    # memo, and every swapped array below is a new one
    out = dict(meta)
    out["y"] = xform(meta["y"])
    out["cb"] = xform(meta["cb"])
    out["cr"] = xform(meta["cr"])
    out["w"], out["h"] = w, h
    out["subsamp"] = new_subsamp
    if "t" in ops:
        # quant tables follow the (u, v) swap
        out["lq"] = np.ascontiguousarray(meta["lq"][_TRANSPOSE_PERM])
        out["cq"] = np.ascontiguousarray(meta["cq"][_TRANSPOSE_PERM])
    return out
