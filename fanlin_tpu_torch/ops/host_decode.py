"""The coefficient decode and the ICC LUT in numpy, for the host mirror.

Numpy copies of the JAX package's host twins (its `xp=np` paths):
the islow iDCT (fanlin_tpu/ops/jpeg_decode.py:88-192), the libjpeg fancy
upsamples and jdcolor's conversion (fanlin_tpu/ops/hostexec.py:196-226,
:396-399), the 4-component decode (hostexec.py:410-457) and the
quadrilinear LUT (fanlin_tpu/ops/cmyk_lut.py:63-92). The same int32
arithmetic as the kernels (arithmetic right shifts, wrapping products,
saturation after the iDCT) and the same f32 LUT steps, so the decoded
planes are the kernels' bytes. Numpy only: `ops.hostexec` serves batches
from it, and `ops.cmyk_lut.DeviceCmykTransform.convert_host` converts
pixels through it, without touching the device.
"""

from __future__ import annotations

import numpy as np

_ISLOW_PASS1_SHIFT = 11  # CONST_BITS - PASS1_BITS
_ISLOW_PASS2_SHIFT = 18  # CONST_BITS + PASS1_BITS + 3


def _islow_pass(s, shift):
    """One 8-point islow pass over 8 same-shaped int32 arrays
    (jidctint.c's column/row loop body), FIX_* at CONST_BITS=13."""
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


def islow_idct_planar(coef: np.ndarray) -> np.ndarray:
    """(B, H, W) int32 dequantized planar coefficients (DC included) ->
    (B, H, W) int32 samples in [0, 255]: the column pass, the row pass,
    +128 and saturation."""
    b, h, w = coef.shape
    v = coef.reshape(b, h // 8, 8, w)
    ws = _islow_pass([v[:, :, u, :] for u in range(8)], _ISLOW_PASS1_SHIFT)
    t = np.stack(ws, axis=2).reshape(b, h, w)
    v2 = t.reshape(b, h, w // 8, 8)
    out = _islow_pass([v2[:, :, :, u] for u in range(8)], _ISLOW_PASS2_SHIFT)
    o = np.stack(out, axis=3).reshape(b, h, w)
    return np.clip(o + 128, 0, 255).astype(np.int32)


def decode_plane(blocks: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Dequantize and iDCT one plane of block grids: blocks (B, bh, bw,
    64) int16 in natural order, q (B, 64) integer tables -> (B, 8 bh,
    8 bw) int32 samples."""
    b, bh, bw, _ = blocks.shape
    coef = blocks.astype(np.int32) * q.astype(np.int32)[:, None, None, :]
    planar = coef.reshape(b, bh, bw, 8, 8).transpose(0, 1, 3, 2, 4)
    return islow_idct_planar(
        np.ascontiguousarray(planar).reshape(b, 8 * bh, 8 * bw))


def h2v2_up(c: np.ndarray) -> np.ndarray:
    """libjpeg h2v2 fancy upsample of a (B, ch, cw) plane to
    (B, 2ch, 2cw)."""
    b, ch, cw = c.shape
    up = np.concatenate([c[:, :1], c[:, :-1]], axis=1)
    dn = np.concatenate([c[:, 1:], c[:, -1:]], axis=1)
    colsum = np.stack([3 * c + up, 3 * c + dn], axis=2).reshape(b, 2 * ch, cw)
    left = np.concatenate([colsum[:, :, :1], colsum[:, :, :-1]], axis=2)
    right = np.concatenate([colsum[:, :, 1:], colsum[:, :, -1:]], axis=2)
    even = (3 * colsum + left + 8) >> 4
    odd = (3 * colsum + right + 7) >> 4
    return np.stack([even, odd], axis=3).reshape(b, 2 * ch, 2 * cw)


def fancy_up1(c: np.ndarray, axis: int) -> np.ndarray:
    """libjpeg 'fancy' 2x upsample along one axis of a (B, h, w) plane:
    h2v1 (4:2:2) when axis=2, h1v2 (4:4:0) when axis=1."""
    if axis == 1:
        return fancy_up1(c.swapaxes(1, 2), 2).swapaxes(1, 2)
    near = np.concatenate([c[:, :, :1], c[:, :, :-1]], axis=2)
    far = np.concatenate([c[:, :, 1:], c[:, :, -1:]], axis=2)
    even = (3 * c + near + 1) >> 2
    odd = (3 * c + far + 2) >> 2
    return np.stack([even, odd], axis=3).reshape(
        c.shape[0], c.shape[1], 2 * c.shape[2])


# (vertical, horizontal) chroma divisors of a subsampling layout
CHROMA_DIVISORS = {420: (2, 2), 422: (1, 2), 440: (2, 1), 444: (1, 1)}


def upsample_chroma(c: np.ndarray, subsamp: int, true_h: int,
                    true_w: int) -> np.ndarray:
    """A decoded chroma plane brought to (B, true_h, true_w) by the
    layout's fancy upsample, run at the true chroma dims."""
    dv, dh = CHROMA_DIVISORS[subsamp]
    c = c[:, : -(-true_h // dv), : -(-true_w // dh)]
    if subsamp == 420:
        c = h2v2_up(c)
    elif subsamp == 422:
        c = fancy_up1(c, axis=2)
    elif subsamp == 440:
        c = fancy_up1(c, axis=1)
    return c[:, :true_h, :true_w]


def ycbcr_to_rgb(y, cb, cr):
    """jdcolor ycc_rgb_convert on int arrays; (r, g, b) in [0, 255]."""
    cbz, crz = cb - 128, cr - 128
    r = y + ((91881 * crz + 32768) >> 16)
    b = y + ((116130 * cbz + 32768) >> 16)
    g = y + ((-22554 * cbz + 32768 - 46802 * crz) >> 16)
    return tuple(np.clip(v, 0, 255) for v in (r, g, b))


def _pad(planes, out_h: int, out_w: int) -> np.ndarray:
    """(B, h, w) planes stacked to (B, C, out_h, out_w) u8, zero past
    (h, w)."""
    b, h, w = planes[0].shape
    out = np.zeros((b, len(planes), out_h, out_w), np.uint8)
    for i, p in enumerate(planes):
        out[:, i, :h, :w] = p
    return out


def decode_rgb(y, cb, cr, q, subsamp: int, true_h: int, true_w: int,
               out_h: int, out_w: int) -> np.ndarray:
    """The whole decode of a batch, jpeg_decode_rgb's result: block grids
    (B, bh, bw, 64) int16, q (B, 2, 64) -> (B, 3, out_h, out_w) u8 RGB,
    zero outside the true rect."""
    yp = decode_plane(y, q[:, 0])[:, :true_h, :true_w]
    cbp = upsample_chroma(decode_plane(cb, q[:, 1]), subsamp, true_h, true_w)
    crp = upsample_chroma(decode_plane(cr, q[:, 1]), subsamp, true_h, true_w)
    return _pad(ycbcr_to_rgb(yp, cbp, crp), out_h, out_w)


def decode_cmyk(y, cb, cr, k, q, subsamp: int, ycck: bool, true_h: int,
                true_w: int, out_h: int, out_w: int) -> np.ndarray:
    """The 4-component decode of a batch, jpeg_decode_cmyk's result:
    (B, 4, out_h, out_w) u8 CMYK in PIL's convention, zero outside the
    true rect. Plain CMYK is 255 - islow of each plane; YCCK's C, M, Y
    are jdcolor's R', G', B' of (y, cb, cr) and its K is 255 - islow(k).
    K is at comp0's rate and on comp0's table."""
    th, tw = true_h, true_w
    if ycck:
        yp = decode_plane(y, q[:, 0])[:, :th, :tw]
        cbp = upsample_chroma(decode_plane(cb, q[:, 1]), subsamp, th, tw)
        crp = upsample_chroma(decode_plane(cr, q[:, 1]), subsamp, th, tw)
        planes = list(ycbcr_to_rgb(yp, cbp, crp))
    else:
        planes = [255 - decode_plane(g, q[:, t])[:, :th, :tw]
                  for g, t in ((y, 0), (cb, 1), (cr, 1))]
    planes.append(255 - decode_plane(k, q[:, 0])[:, :th, :tw])
    return _pad(planes, out_h, out_w)


def lut_planes(c, m, y, k, lut_flat: np.ndarray, n: int):
    """Quadrilinear LUT evaluation on planes, the f32 operations of
    fanlin_tpu/ops/cmyk_lut.py:63-92 in their order: c, m, y, k integer
    arrays of one shape in [0, 255]; lut_flat (n^4, 3) f32. Returns
    (r, g, b) f32 planes of integers in [0, 255]."""
    scale = np.float32((n - 1) / 255.0)
    comps = [v.astype(np.float32) * scale for v in (c, m, y, k)]
    lo = [np.clip(np.floor(v).astype(np.int32), 0, n - 2) for v in comps]
    frac = [v - lv.astype(np.float32) for v, lv in zip(comps, lo)]
    one = np.float32(1.0)
    acc = [np.float32(0.0)] * 3
    for corner in range(16):
        bits = [(corner >> i) & 1 for i in range(4)]
        weight = one
        flat_idx = 0
        for i in range(4):
            flat_idx = flat_idx * n + (lo[i] + bits[i])
            weight = weight * (frac[i] if bits[i] else one - frac[i])
        sample = lut_flat[flat_idx]
        for ch in range(3):
            acc[ch] = acc[ch] + weight * sample[..., ch]
    return tuple(np.clip(np.floor(a + np.float32(0.5)), 0, 255)
                 .astype(np.float32) for a in acc)


def lut_rgb(cmyk: np.ndarray, lut_flat: np.ndarray, n: int) -> np.ndarray:
    """(B, 4, H, W) u8 CMYK planes through the LUT -> (B, 3, H, W) u8
    RGB (every pixel, as the kernels convert them)."""
    rgb = lut_planes(*(cmyk[:, i] for i in range(4)), lut_flat, n)
    return np.stack(rgb, axis=1).astype(np.uint8)
