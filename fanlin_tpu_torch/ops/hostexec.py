"""The host mirror: an assembled batch run in numpy, never on the device.

Port of fanlin_tpu/ops/hostexec.py. The micro-batcher serves a batch
from here only while the card does not answer: a device call that
stalled past `tpu.device_stall_s`, and every batch while the device is
wedged (`engine.batcher`); a device call that raises fails its batch
instead. Each such batch is counted in `/stats`, logged and answered
`X-Cache-Warmth: cold`. It is not a
plain version of any kernel: those are the torch `_ref` functions, which
only the tests run.

It reads the host arrays an assembly stages (`BatchAssembly.x`, flags,
fill, box and the per-image matrices; a coefficient batch's block grids
and tables, `CoefBatchAssembly.host_grids()`, copied from its pinned
wire slots), so a batch whose device call stalled is mirrored from the
same bytes it uploaded, and returns exactly what `collect()` returns.

Numerics: the decode of a coefficient batch (`ops.host_decode`) is the
kernels' integer arithmetic, so its planes equal `jpeg_decode_rgb`'s and
`jpeg_decode_cmyk_rgb`'s; the chain is f32 numpy with the reference's
op order, so the result is within 1 LSB of the card's (PARITY.md
known-diff #6): only the sums' order differs. The mirror has one form: a
`fast` (bf16) batch is served with f32 products, and a folded
(`fast_decode`) coefficient batch with the exact decode and the f32
resample, as fanlin_tpu/ops/hostexec.py:468 serves both; those bytes are
the default route's, a few LSB from the fast routes'.
"""

from __future__ import annotations

import numpy as np

from . import fused, host_decode
from .dct import _dct_matrix, ijg_quant_tables
from .plan import _uniform_padded


def _win_meta(m: np.ndarray):
    """(first, last, k): per-output-row support window bounds and the
    widest window. Every matrix the mirror applies (Lanczos/triangle
    resample rows, gaussian blur rows) has contiguous nonzeros."""
    o, s = m.shape
    nz = m != 0
    any_rows = nz.any(axis=1)
    first = np.where(any_rows, nz.argmax(axis=1), 0)
    last = np.where(any_rows, s - 1 - nz[:, ::-1].argmax(axis=1), 0)
    k = int((last - first + 1).max(initial=1))
    return first, last, k


def _win_step(k: int, o: int, s: int) -> int:
    """Output rows per windowed chunk: the column window a chunk of
    `step` rows touches is ~step*(s/o) + k, so big chunks go near-dense
    on downscales, while tiny ones starve BLAS. The reference measured
    its sweet spot at a window of ~56 columns."""
    return int(np.clip(round((56.0 - k) / (s / o)), 16, 192))


def _apply_rows(m: np.ndarray, x: np.ndarray) -> np.ndarray:
    """y[..., i, :] = sum_s m[i, s] * x[..., s, :]: contract x's
    second-to-last axis, windowed chunks as batched GEMMs."""
    o, s = m.shape
    mf = np.ascontiguousarray(m, dtype=np.float32)
    xf = x if x.dtype == np.float32 else x.astype(np.float32)
    first, last, k = _win_meta(m)
    if k * 4 >= s or s < 64:
        return np.matmul(mf, xf)
    out = np.empty(xf.shape[:-2] + (o, xf.shape[-1]), np.float32)
    step = _win_step(k, o, s)
    for i0 in range(0, o, step):
        i1 = min(i0 + step, o)
        c0 = int(first[i0:i1].min())
        c1 = int(last[i0:i1].max()) + 1
        np.matmul(mf[i0:i1, c0:c1], xf[..., c0:c1, :],
                  out=out[..., i0:i1, :])
    return out


def _apply_cols(m: np.ndarray, x: np.ndarray) -> np.ndarray:
    """y[..., i] = sum_s x[..., s] * m[i, s]: contract x's last axis
    (x @ m.T), windowed chunks as batched GEMMs."""
    o, s = m.shape
    mt = np.ascontiguousarray(m.T, dtype=np.float32)
    xf = x if x.dtype == np.float32 else x.astype(np.float32)
    first, last, k = _win_meta(m)
    if k * 4 >= s or s < 64:
        return np.matmul(xf, mt)
    out = np.empty(xf.shape[:-1] + (o,), np.float32)
    step = _win_step(k, o, s)
    for i0 in range(0, o, step):
        i1 = min(i0 + step, o)
        c0 = int(first[i0:i1].min())
        c1 = int(last[i0:i1].max()) + 1
        np.matmul(xf[..., c0:c1], mt[c0:c1, i0:i1],
                  out=out[..., i0:i1])
    return out


def _round_u8_range(t: np.ndarray) -> np.ndarray:
    """floor(clamp(t, 0, 255) + 0.5) in place (t is owned)."""
    np.clip(t, 0.0, 255.0, out=t)
    t += np.float32(0.5)
    return np.floor(t, out=t)


def _np_blur(bv: np.ndarray, bh: np.ndarray, out: np.ndarray,
             uniform: bool) -> np.ndarray:
    """The blur pair: one matrix pair for a uniform batch, per image
    otherwise."""
    if uniform:
        t = _apply_cols(bh, _apply_rows(bv, out))
    else:
        t = np.empty_like(out, dtype=np.float32)
        for i in range(out.shape[0]):
            t[i] = _apply_cols(bh[i], _apply_rows(bv[i], out[i]))
    return _round_u8_range(t)


def _np_chain(planes, av, ah, flags, fill, box, bv, bh, uniform):
    """The chain (ops.chain._chain) in numpy. planes: (r, g, b[, a]) f32
    (B, SH, SW); av/ah shared 2-D matrices or per-image stacks. Returns
    (B, 4, OH, OW) u8 (alpha 255 for opaque sources)."""
    f32 = np.float32
    r, g, b = planes[0], planes[1], planes[2]
    a = planes[3] if len(planes) == 4 else None
    if not (flags[:, 0].any() or flags[:, 1].any()):
        # no gray or invert in the batch: skip the luma pass
        y = np.stack(planes, axis=1)
    else:
        luma = np.floor(
            (2126.0 * r + 7152.0 * g + 722.0 * b).astype(f32) / f32(10000.0))
        grayf = flags[:, 0][:, None, None]
        invf = flags[:, 1][:, None, None]
        do_inv = (invf > 0) & (grayf == 0)
        chans = []
        for p in (r, g, b):
            p = np.where(grayf > 0, luma, p)
            chans.append(np.where(do_inv, 255.0 - p, p).astype(f32))
        y = np.stack(chans + ([a] if a is not None else []), axis=1)

    if uniform:
        t = _apply_cols(ah, _apply_rows(av, y))
    else:
        t = np.empty((y.shape[0], y.shape[1], av.shape[1], ah.shape[1]), f32)
        for i in range(y.shape[0]):
            t[i] = _apply_cols(ah[i], _apply_rows(av[i], y[i]))
    fg = _round_u8_range(t)

    opaque = np.full_like(fg[:, :1], 255.0)
    if not flags[:, 2].any():
        # no fill-canvas composite in the batch
        out = fg if a is not None else np.concatenate([fg, opaque], axis=1)
    else:
        bsz, c, oh, ow = fg.shape
        ii = np.arange(oh)[None, :, None]
        jj = np.arange(ow)[None, None, :]
        x0, y0, fw, fh = (box[:, i][:, None, None] for i in range(4))
        inrect = (ii >= y0) & (ii < y0 + fh) & (jj >= x0) & (jj < x0 + fw)
        fillc = fill[:, :, None, None].astype(f32)
        if a is None:
            comp_rgb = np.where(inrect[:, None], fg, fillc + np.zeros_like(fg))
            fg_full = np.concatenate([fg, opaque], axis=1)
        else:
            fga = fg[:, 3]
            af = (fga / f32(255.0)).astype(f32)
            blended = np.floor(fg[:, :3] * af[:, None]
                               + fillc * (f32(1.0) - af[:, None]))
            comp_rgb = np.where(fga[:, None] >= 255.0, fg[:, :3], blended)
            comp_rgb = np.where(inrect[:, None], comp_rgb,
                                fillc + np.zeros_like(fg[:, :3]))
            fg_full = fg
        comp = np.concatenate([comp_rgb, opaque], axis=1)
        usec = flags[:, 2][:, None, None, None] > 0
        out = np.where(usec, comp, fg_full).astype(f32)
    if bv is not None:
        out = _np_blur(bv, bh, out, uniform)
    return out.astype(np.uint8)


def _np_ycbcr420(out_u8):
    """fused._ycbcr420_tail in numpy."""
    f32 = np.float32
    f = out_u8[:, :3].astype(f32)
    r, g, b = f[:, 0], f[:, 1], f[:, 2]
    yy = (0.299 * r + 0.587 * g + 0.114 * b).astype(f32)
    cb = (128.0 - 0.168735892 * r - 0.331264108 * g + 0.5 * b).astype(f32)
    cr = (128.0 + 0.5 * r - 0.418687589 * g - 0.081312411 * b).astype(f32)

    def to_u8(v):
        return np.clip(np.floor(v + 0.5), 0, 255).astype(np.uint8)

    return (to_u8(yy), to_u8(_sum4(cb) * np.float32(0.25)),
            to_u8(_sum4(cr) * np.float32(0.25)))


def _sum4(c):
    """(B, H, W) -> (B, ceil(H/2), ceil(W/2)) 2x2 sums, odd edges
    replicated."""
    if c.shape[1] % 2:
        c = np.concatenate([c, c[:, -1:, :]], axis=1)
    if c.shape[2] % 2:
        c = np.concatenate([c, c[:, :, -1:]], axis=2)
    bsz, h, w = c.shape
    c = c.reshape(bsz, h // 2, 2, w // 2, 2)
    return c[:, :, 0, :, 0] + c[:, :, 0, :, 1] + c[:, :, 1, :, 0] + c[:, :, 1, :, 1]


def _np_webp420(out_u8):
    """fused._webp420_tail in numpy (libwebp-range YUV)."""
    p = out_u8[:, :3].astype(np.int64)
    r, g, b = p[:, 0], p[:, 1], p[:, 2]
    y = (16839 * r + 33059 * g + 6420 * b + 32768 + (16 << 16)) >> 16
    rs, gs, bs = ((_sum4(c) + 2) >> 2 for c in (r, g, b))
    u = (-9719 * rs - 19081 * gs + 28800 * bs + 32768 + (128 << 16)) >> 16
    v = (28800 * rs - 24116 * gs - 4684 * bs + 32768 + (128 << 16)) >> 16
    return tuple(np.clip(t, 0, 255).astype(np.uint8) for t in (y, u, v))


def _np_png_rows(out_u8, nch: int):
    """fused._png_tail in numpy (adaptive PNG filter rows)."""
    b, have, h, w = out_u8.shape
    if nch == 1:
        px = out_u8[:, :1]
    elif nch == 3:
        px = out_u8[:, :3]
    else:
        rgb = out_u8[:, :1] if nch == 2 else out_u8[:, :3]
        if have >= 4:
            alpha = out_u8[:, 3:4]
        else:
            alpha = np.full((b, 1, h, w), 255, np.uint8)
        px = np.concatenate([rgb, alpha], axis=1)
    c = px.shape[1]
    # int16 intermediates and a LUT for the abs-signed score (an int32
    # formulation is several times slower on large outputs)
    x = np.ascontiguousarray(px.transpose(0, 2, 3, 1)).reshape(b, h, w * c)
    xi = x.astype(np.int16)
    left = np.pad(xi, ((0, 0), (0, 0), (c, 0)))[:, :, : w * c]
    up = np.pad(xi, ((0, 0), (1, 0), (0, 0)))[:, :h]
    ul = np.pad(xi, ((0, 0), (1, 0), (c, 0)))[:, :h, : w * c]
    f1 = ((xi - left) & 255).astype(np.uint8)
    f2 = ((xi - up) & 255).astype(np.uint8)
    f3 = ((xi - ((left + up) >> 1)) & 255).astype(np.uint8)
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    f4 = ((xi - paeth) & 255).astype(np.uint8)
    lut = np.minimum(np.arange(256), 256 - np.arange(256)).astype(np.uint16)
    cands = np.stack([x, f1, f2, f3, f4], axis=2)  # (B, H, 5, L) u8
    score = lut[cands].sum(axis=3, dtype=np.int64)
    idx = np.argmin(score, axis=2)  # first minimum on ties
    sel = np.take_along_axis(cands, idx[:, :, None, None], axis=2)[:, :, 0]
    return np.concatenate([idx[:, :, None].astype(np.uint8), sel], axis=2)


def _np_dct_tail(y, cb, cr, quality):
    """The jpegdct tail (ops.dct.ycbcr420_to_planar) in numpy, returning
    (B, rows, cols, 64) int16 block grids. Its sums run in numpy's order,
    so a coefficient whose quotient lands on a .5 boundary can round the
    other way than the card's fixed order (the quantisation ties)."""
    lq, cq = ijg_quant_tables(quality)
    d = _dct_matrix()

    def pad_edge(p, mult):
        b, h, w = p.shape
        ph, pw = -(-h // mult) * mult, -(-w // mult) * mult
        if ph != h:
            p = np.concatenate([p, np.repeat(p[:, -1:, :], ph - h, axis=1)],
                               axis=1)
        if pw != w:
            p = np.concatenate([p, np.repeat(p[:, :, -1:], pw - w, axis=2)],
                               axis=2)
        return p

    def block_q(p, q):
        b, h, w = p.shape
        x = p.reshape(b, h // 8, 8, w // 8, 8)
        coef = np.einsum("ui,bricj,vj->brcuv", d, x, d, dtype=np.float32,
                         optimize=True)
        qq = coef / q.astype(np.float32)
        qq = np.sign(qq) * np.floor(np.abs(qq) + 0.5)
        return qq.reshape(b, h // 8, w // 8, 64).astype(np.int16)

    yp = pad_edge(y.astype(np.float32), 16) - 128.0
    cbp = pad_edge(cb.astype(np.float32), 8) - 128.0
    crp = pad_edge(cr.astype(np.float32), 8) - 128.0
    return block_q(yp, lq), block_q(cbp, cq), block_q(crp, cq)


def decode_coef(asm) -> np.ndarray:
    """The decode of a coefficient batch's real images from its staged
    wire: (n, 3, sh, sw) u8, what `jpeg_decode_rgb` (YCbCr) or
    `jpeg_decode_cmyk_rgb` (CMYK / YCCK, the LUT over every pixel)
    writes for them."""
    n = len(asm.plans)
    grids = [g[:n] for g in asm.host_grids()]
    q = asm.q[:n]
    dims = (asm.true_h, asm.true_w, asm.sh, asm.sw)
    if isinstance(asm, fused.CmykCoefBatchAssembly):
        cmyk = host_decode.decode_cmyk(*grids, q, asm.subsamp, asm.ycck,
                                       *dims)
        return host_decode.lut_rgb(cmyk, asm.lut_flat, asm.lut_n)
    return host_decode.decode_rgb(*grids, q, asm.subsamp, *dims)


def run_host(asm) -> list:
    """Run an assembled batch (any `fused.make_assembly` result) in
    numpy; returns what `asm.collect()` returns."""
    n = len(asm.plans)
    if isinstance(asm, fused.CoefBatchAssembly):
        x = decode_coef(asm)
    else:
        x = asm.x[:n]
    planes = tuple(x[:, i].astype(np.float32) for i in range(x.shape[1]))
    p0 = asm.plans[0]
    if asm.uniform:
        av, ah, bv, bh = _uniform_padded(p0)
    else:
        av, ah, bv, bh = (None if m is None else m[:n]
                          for m in (asm.av, asm.ah, asm.bv, asm.bh))
    if not asm.has_blur:
        bv = bh = None
    out = _np_chain(planes, av, ah, asm.flags[:n], asm.fill[:n],
                    asm.box[:n], bv, bh, asm.uniform)

    sink = asm.jpeg420
    if not sink:
        return [np.ascontiguousarray(
            out[i, : asm.c_out, : p.out_h, : p.out_w].transpose(1, 2, 0))
            for i, p in enumerate(asm.plans)]
    out = out[:, :, : p0.out_h, : p0.out_w]
    if isinstance(sink, tuple) and sink[0] == "png":
        rows = _np_png_rows(out, sink[1])
        return [("pngrows", rows[i], p0.out_w, p0.out_h, sink[1])
                for i in range(n)]
    if sink == "webp":
        y, u, v = _np_webp420(out)
        return [("webpyuv", y[i], u[i], v[i]) for i in range(n)]
    y, cb, cr = _np_ycbcr420(out)
    if isinstance(sink, tuple):  # ("jpegdct", quality)
        yc, cbc, crc = _np_dct_tail(y, cb, cr, sink[1])
        return [("coeffs", yc[i], cbc[i], crc[i], p0.out_w, p0.out_h,
                 sink[1]) for i in range(n)]
    return [("ycbcr420", y[i], cb[i], cr[i]) for i in range(n)]
