"""The coefficient decode kernels: wrappers, plain versions, launch counts.

`jpeg_decode_rgb` (`csrc/jpeg_decode.cu`; see the note at the top of
that file for what it replaces, what bounds it and its design) takes the
JAX package's coefficient decode (fanlin_tpu/ops/jpeg_decode.py, run as
an XLA prologue of get_coef_program) to the card as one tiled launch:
y (B, ybh, ybw, 64), cb and cr (B, cbh, cbw, 64) int16 natural-order
blocks and q (B, 2, 64) int32 quant tables (luma, chroma) -> (B, 3,
out_h, out_w) u8 RGB: dequant, islow iDCT, the layout's fancy upsample
at the true chroma dims and jdcolor's conversion inside the true
(true_h, true_w) rect, zeros outside it. Images i >= n are the batch's
bucket padding: they decode as zero coefficients do, 128 inside the true
rect, and their wire is never read.

`jpeg_decode_cmyk_rgb` (the same source) is the CMYK coefficient
route's kernel: y, cb, cr and k (B, bh, bw, 64) int16 blocks, k at y's
grid, and a LUT packed by `cmyk_lut.pack_lut` -> (B, 3, out_h, out_w) u8
RGB. It decodes four components to CMYK in PIL's convention (plain CMYK
inverted; YCCK as jdcolor's RGB and an inverted K) and converts each
pixel through the sampled ICC LUT in its colour stage: the XLA program
fanlin_tpu/ops/fused.py:908 get_cmyk_coef_program's decode_cmyk and
lut_planes in one launch. `jpeg_decode_cmyk` (K12a) is its decode alone,
(B, 4, out_h, out_w) u8 CMYK, which `cmyk_lut_kernels.cmyk_lut` (K12b)
converts; nothing on the serving path launches it any more, and it
stays as the yardstick the fused kernel is timed against. The plain
version of the fused kernel is the composition of theirs.

`jpeg_islow_ref` and `jpeg_upsample_rgb_ref` (the dequant + islow iDCT
of the three block grids to u8 planes, and those planes to RGB) compose
`jpeg_decode_rgb_ref`.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it
runs its plain torch version, built from `ops.jpeg_decode` (and, for the
LUT, the kernel's order of work, `cmyk_lut.lut_planes_packed`). There is
no fallback: a failed build or launch raises. The decodes are integer
work and the LUT's f32 operations are rounded one by one as the plain
version's, so every kernel is bit-exact against its plain version.
"""

from __future__ import annotations

import threading

import torch

from . import _build, cmyk_lut_kernels
from . import jpeg_decode as jd
from ._build import DEC_TILE_H, DEC_TILE_W
from .cmyk_lut import lut_scale

_U8 = torch.uint8
_I16 = torch.int16
_I32 = torch.int32

# Launches of each CUDA kernel. Incremented only where the kernel is
# launched; the CPU path and the plain versions never count.
_COUNT_LOCK = threading.Lock()
_LAUNCHES = {"jpeg_decode_rgb": 0, "jpeg_decode_cmyk": 0,
             "jpeg_decode_cmyk_rgb": 0}


def decode_tile(subsamp: int) -> tuple:
    """(rows, cols) of output pixels in one of jpeg_decode_rgb's CTAs:
    DEC_TILE_H chroma rows, so twice as many output rows where chroma is
    halved vertically."""
    return DEC_TILE_H * jd.chroma_divisors(subsamp)[0], DEC_TILE_W


def launch_counts() -> dict:
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _COUNT_LOCK:
        _LAUNCHES[name] += 1


def _check(t, name, dtype, ndim, device, align):
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-d {dtype} tensor")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % align:
        raise ValueError(f"{name}: must be {align}-byte aligned")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def jpeg_islow_ref(y, cb, cr, q):
    """Dequant + islow iDCT of the three (B, bh, bw, 64) block grids of a
    batch with q (B, 2, 64): their (B, 8 bh, 8 bw) u8 sample planes, on
    any device."""
    outs = []
    for plane, blocks in enumerate((y, cb, cr)):
        dc, ac = jd.blocks_to_planar(blocks)
        outs.append(jd.islow_decode_plane(dc, ac, q[:, min(plane, 1)])
                    .to(_U8))
    return tuple(outs)


def jpeg_upsample_rgb_ref(yp, cbp, crp, subsamp: int, true_h: int,
                          true_w: int, out_h: int, out_w: int):
    """The u8 planes of jpeg_islow_ref -> (B, 3, out_h, out_w) u8 RGB:
    the layout's fancy upsample at the true chroma dims and jdcolor's
    conversion inside the true rect, zero outside it. Any device."""
    y = yp[:, :true_h, :true_w].to(_I32)
    cb = jd.upsample_chroma(cbp.to(_I32), subsamp, true_h, true_w)
    cr = jd.upsample_chroma(crp.to(_I32), subsamp, true_h, true_w)
    rgb = torch.stack(jd.ycbcr_to_rgb_int(y, cb, cr), dim=1).to(_U8)
    return torch.nn.functional.pad(rgb, (0, out_w - true_w, 0, out_h - true_h))


def _decode_rgb_args(y, cb, cr, q, subsamp, true_h, true_w, out_h, out_w, n):
    dev = y.device
    for t, name in ((y, "y"), (cb, "cb"), (cr, "cr")):
        _check(t, name, _I16, 4, dev, 16)
    _check(q, "q", _I32, 3, dev, 16)
    b, ybh, ybw, k = y.shape
    _, cbh, cbw, _ = cb.shape
    if (k != 64 or tuple(cb.shape) != (b, cbh, cbw, 64)
            or cr.shape != cb.shape or tuple(q.shape) != (b, 2, 64)):
        raise ValueError("expected y (B, ybh, ybw, 64), cb and cr (B, cbh, "
                         "cbw, 64) and q (B, 2, 64)")
    if subsamp not in (420, 422, 440, 444):
        raise ValueError(f"subsamp {subsamp}: expected 420, 422, 440 or 444")
    dv, dh = jd.chroma_divisors(subsamp)
    if not (0 < true_h <= min(out_h, 8 * ybh)
            and 0 < true_w <= min(out_w, 8 * ybw)
            and -(-true_h // dv) <= 8 * cbh and -(-true_w // dh) <= 8 * cbw
            and out_w % DEC_TILE_W == 0 and 0 <= n <= b):
        raise ValueError(f"true dims {(true_h, true_w)} do not fit the grids "
                         f"{tuple(y.shape)}, {tuple(cb.shape)} or the output "
                         f"{(out_h, out_w)} (width a multiple of "
                         f"{DEC_TILE_W}), or n={n} is not in [0, {b}]")


def jpeg_decode_rgb(y, cb, cr, q, subsamp: int, true_h: int, true_w: int,
                    out_h: int, out_w: int, n: int):
    """The whole decode of a batch: block grids -> (B, 3, out_h, out_w)
    u8 RGB, zero outside the true rect; images i >= n decode as zero
    coefficients. One launch on CUDA."""
    _decode_rgb_args(y, cb, cr, q, subsamp, true_h, true_w, out_h, out_w, n)
    dev = y.device
    if dev.type == "cpu":
        return jpeg_decode_rgb_ref(y, cb, cr, q, subsamp, true_h, true_w,
                                   out_h, out_w, n)
    if dev.type != "cuda":
        raise ValueError(f"jpeg_decode_rgb: unsupported device {dev}")
    lib = _build.load()
    b, ybh, ybw, _ = y.shape
    _, cbh, cbw, _ = cb.shape
    out = torch.empty((b, 3, out_h, out_w), dtype=_U8, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fanlin_jpeg_decode_rgb(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), q.data_ptr(),
            out.data_ptr(), b, n, ybh, ybw, cbh, cbw, subsamp, true_h, true_w,
            out_h, out_w, *decode_tile(subsamp), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"jpeg_decode_rgb launch failed: CUDA error {rc}")
    _count("jpeg_decode_rgb")
    return out


def jpeg_decode_rgb_ref(y, cb, cr, q, subsamp: int, true_h: int, true_w: int,
                        out_h: int, out_w: int, n: int):
    """Plain torch version of jpeg_decode_rgb, on any device:
    jpeg_islow_ref and jpeg_upsample_rgb_ref composed, then images i >= n
    set to what zero coefficients decode to (128 inside the true rect, 0
    outside)."""
    rgb = jpeg_upsample_rgb_ref(*jpeg_islow_ref(y, cb, cr, q), subsamp,
                                true_h, true_w, out_h, out_w)
    if n < rgb.shape[0]:
        rgb[n:] = 0
        rgb[n:, :, :true_h, :true_w] = 128
    return rgb


# What zero coefficients decode to in a padded image's true rect, per
# stored plane: 128 samples, inverted for plain CMYK and for YCCK's K
_CMYK_PAD = {False: (127, 127, 127, 127), True: (128, 128, 128, 127)}


def _decode_cmyk_args(y, cb, cr, k, q, subsamp, ycck, true_h, true_w, out_h,
                      out_w, n):
    if not (subsamp == 444 or (subsamp == 420 and ycck)):
        raise ValueError(f"subsamp {subsamp}, ycck {ycck}: expected plain "
                         "CMYK 444 or YCCK 444/420")
    _decode_rgb_args(y, cb, cr, q, subsamp, true_h, true_w, out_h, out_w, n)
    _check(k, "k", _I16, 4, y.device, 16)
    if k.shape != y.shape:
        raise ValueError("k: expected y's shape (B, ybh, ybw, 64)")


def jpeg_decode_cmyk(y, cb, cr, k, q, subsamp: int, ycck: bool, true_h: int,
                     true_w: int, out_h: int, out_w: int, n: int):
    """K12a: the 4-component decode of a batch, block grids -> (B, 4,
    out_h, out_w) u8 CMYK, zero outside the true rect; images i >= n
    decode as zero coefficients. One launch on CUDA."""
    _decode_cmyk_args(y, cb, cr, k, q, subsamp, ycck, true_h, true_w, out_h,
                      out_w, n)
    dev = y.device
    if dev.type == "cpu":
        return jpeg_decode_cmyk_ref(y, cb, cr, k, q, subsamp, ycck, true_h,
                                    true_w, out_h, out_w, n)
    if dev.type != "cuda":
        raise ValueError(f"jpeg_decode_cmyk: unsupported device {dev}")
    lib = _build.load()
    b, ybh, ybw, _ = y.shape
    _, cbh, cbw, _ = cb.shape
    out = torch.empty((b, 4, out_h, out_w), dtype=_U8, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fanlin_jpeg_decode_cmyk(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), k.data_ptr(),
            q.data_ptr(), out.data_ptr(), b, n, ybh, ybw, cbh, cbw, subsamp,
            int(bool(ycck)), true_h, true_w, out_h, out_w,
            *decode_tile(subsamp), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"jpeg_decode_cmyk launch failed: CUDA error {rc}")
    _count("jpeg_decode_cmyk")
    return out


def jpeg_decode_cmyk_ref(y, cb, cr, k, q, subsamp: int, ycck: bool,
                         true_h: int, true_w: int, out_h: int, out_w: int,
                         n: int):
    """Plain torch version of jpeg_decode_cmyk, on any device:
    `jpeg_decode.decode_cmyk` on the grids' planar form, cut or padded to
    (out_h, out_w), then images i >= n set to what zero coefficients
    decode to inside the true rect."""
    dcs = [jd.blocks_to_planar(g) for g in (y, cb, cr, k)]
    pad_h, pad_w = 8 * y.shape[1], 8 * y.shape[2]
    planes = jd.decode_cmyk(*dcs[0], *dcs[1], *dcs[2], *dcs[3], q[:, 0],
                            q[:, 1], true_h, true_w, pad_h, pad_w, subsamp,
                            ycck)
    out = torch.stack(planes, dim=1).to(_U8)[:, :, :out_h, :out_w]
    out = torch.nn.functional.pad(
        out, (0, out_w - out.shape[3], 0, out_h - out.shape[2]))
    if n < out.shape[0]:
        out[n:] = 0
        for p, v in enumerate(_CMYK_PAD[bool(ycck)]):
            out[n:, p, :true_h, :true_w] = v
    return out


def jpeg_decode_cmyk_rgb(y, cb, cr, k, q, lut, lut_n: int, subsamp: int,
                         ycck: bool, true_h: int, true_w: int, out_h: int,
                         out_w: int, n: int):
    """The 4-component decode of a batch converted through the packed ICC
    LUT (lut: pack_lut's (lut_n^4, 4) int32 on the grids' device): block
    grids -> (B, 3, out_h, out_w) u8 RGB, every pixel converted (LUT(0)
    outside the true rect); images i >= n decode as zero coefficients.
    One launch on CUDA."""
    _decode_cmyk_args(y, cb, cr, k, q, subsamp, ycck, true_h, true_w, out_h,
                      out_w, n)
    dev = y.device
    cmyk_lut_kernels.check_packed(lut, lut_n, dev)
    if dev.type == "cpu":
        return cmyk_lut_kernels.cmyk_lut_packed_ref(
            jpeg_decode_cmyk_ref(y, cb, cr, k, q, subsamp, ycck, true_h,
                                 true_w, out_h, out_w, n), lut, lut_n)
    if dev.type != "cuda":
        raise ValueError(f"jpeg_decode_cmyk_rgb: unsupported device {dev}")
    lib = _build.load()
    b, ybh, ybw, _ = y.shape
    _, cbh, cbw, _ = cb.shape
    out = torch.empty((b, 3, out_h, out_w), dtype=_U8, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fanlin_jpeg_decode_cmyk_rgb(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), k.data_ptr(),
            q.data_ptr(), out.data_ptr(), b, n, ybh, ybw, cbh, cbw, subsamp,
            int(bool(ycck)), true_h, true_w, out_h, out_w,
            *decode_tile(subsamp), lut.data_ptr(), lut_n,
            float(lut_scale(lut_n)), _stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"jpeg_decode_cmyk_rgb launch failed: CUDA error {rc}")
    _count("jpeg_decode_cmyk_rgb")
    return out


def jpeg_decode_cmyk_rgb_ref(y, cb, cr, k, q, lut, lut_n: int, subsamp: int,
                             ycck: bool, true_h: int, true_w: int, out_h: int,
                             out_w: int, n: int):
    """Plain torch version of jpeg_decode_cmyk_rgb, on any device, on the
    f32 LUT ((lut_n^4, 3) on the grids' device): cmyk_lut_ref of
    jpeg_decode_cmyk_ref."""
    return cmyk_lut_kernels.cmyk_lut_ref(
        jpeg_decode_cmyk_ref(y, cb, cr, k, q, subsamp, ycck, true_h, true_w,
                             out_h, out_w, n), lut, lut_n)
