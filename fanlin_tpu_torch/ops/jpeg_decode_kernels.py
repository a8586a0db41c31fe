"""The coefficient decode kernels: wrappers, plain versions, launch counts.

K3 `jpeg_islow` and K4 `jpeg_upsample_rgb` (`csrc/jpeg_decode.cu`; see
the note at the top of that file for what they replace and what bounds
them) take the JAX package's coefficient decode (fanlin_tpu/ops/
jpeg_decode.py, run as an XLA prologue of get_coef_program) to the
card as two launches. On a CUDA tensor each wrapper launches its
kernel; on a CPU tensor it runs its plain torch version, built from
`ops.jpeg_decode`. There is no fallback: a failed build or launch
raises. Both are integer work, bit-exact against the plain versions.

K3: y (B, ybh, ybw, 64), cb and cr (B, cbh, cbw, 64) int16 natural-order
blocks; q (B, 2, 64) int32 quant tables (luma, chroma) -> the three u8
sample planes (B, 8*bh, 8*bw).

K4: the three planes -> (B, 3, out_h, out_w) u8 RGB, the layout's fancy
upsample at the true chroma dims and jdcolor's conversion inside the
true (true_h, true_w) rect, zeros outside it.
"""

from __future__ import annotations

import threading

import torch

from . import _build
from . import jpeg_decode as jd

_U8 = torch.uint8
_I16 = torch.int16
_I32 = torch.int32

# Launches of each CUDA kernel. Incremented only where the kernel is
# launched; the CPU path and the plain versions never count.
_COUNT_LOCK = threading.Lock()
_LAUNCHES = {"jpeg_islow": 0, "jpeg_upsample_rgb": 0}


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


def jpeg_islow(y, cb, cr, q):
    """K3: dequant + islow iDCT of the three block grids of a batch, in
    one launch on CUDA. Returns (y, cb, cr) u8 planes."""
    dev = y.device
    for t, name in ((y, "y"), (cb, "cb"), (cr, "cr")):
        _check(t, name, _I16, 4, dev, 16)
        if t.shape[-1] != 64 or t.shape[0] != y.shape[0]:
            raise ValueError(f"{name}: expected (B, bh, bw, 64)")
    if cb.shape != cr.shape:
        raise ValueError("cb and cr: shapes differ")
    b = y.shape[0]
    _check(q, "q", _I32, 3, dev, 4)
    if tuple(q.shape) != (b, 2, 64):
        raise ValueError(f"q: expected {(b, 2, 64)}, got {tuple(q.shape)}")
    if dev.type == "cpu":
        return jpeg_islow_ref(y, cb, cr, q)
    if dev.type != "cuda":
        raise ValueError(f"jpeg_islow: unsupported device {dev}")
    lib = _build.load()
    _, ybh, ybw, _ = y.shape
    _, cbh, cbw, _ = cb.shape
    outs = [torch.empty((b, 8 * bh, 8 * bw), dtype=_U8, device=dev)
            for bh, bw in ((ybh, ybw), (cbh, cbw), (cbh, cbw))]
    with torch.cuda.device(dev):
        rc = lib.fanlin_jpeg_islow(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), q.data_ptr(),
            *(o.data_ptr() for o in outs), b, ybh, ybw, cbh, cbw,
            _stream(dev))
    if rc != 0:
        raise RuntimeError(f"jpeg_islow launch failed: CUDA error {rc}")
    _count("jpeg_islow")
    return tuple(outs)


def jpeg_islow_ref(y, cb, cr, q):
    """Plain torch version of K3, on any device."""
    outs = []
    for plane, blocks in enumerate((y, cb, cr)):
        dc, ac = jd.blocks_to_planar(blocks)
        outs.append(jd.islow_decode_plane(dc, ac, q[:, min(plane, 1)])
                    .to(_U8))
    return tuple(outs)


def _upsample_args(yp, cbp, crp, subsamp, true_h, true_w, out_h, out_w):
    dev = yp.device
    for t, name in ((yp, "y"), (cbp, "cb"), (crp, "cr")):
        _check(t, name, _U8, 3, dev, 1)
    if cbp.shape != crp.shape or cbp.shape[0] != yp.shape[0]:
        raise ValueError("cb and cr: expected one (B, ch, cw) shape")
    if subsamp not in (420, 422, 440, 444):
        raise ValueError(f"subsamp {subsamp}: expected 420, 422, 440 or 444")
    dv, dh = jd.chroma_divisors(subsamp)
    if not (0 < true_h <= min(out_h, yp.shape[1])
            and 0 < true_w <= min(out_w, yp.shape[2])
            and -(-true_h // dv) <= cbp.shape[1]
            and -(-true_w // dh) <= cbp.shape[2]):
        raise ValueError(f"true dims {(true_h, true_w)} do not fit the planes "
                         f"{tuple(yp.shape)}, {tuple(cbp.shape)} or the "
                         f"output {(out_h, out_w)}")


def jpeg_upsample_rgb(yp, cbp, crp, subsamp: int, true_h: int, true_w: int,
                      out_h: int, out_w: int):
    """K4: the u8 planes of jpeg_islow -> (B, 3, out_h, out_w) u8 RGB,
    zero outside the true rect."""
    _upsample_args(yp, cbp, crp, subsamp, true_h, true_w, out_h, out_w)
    dev = yp.device
    if dev.type == "cpu":
        return jpeg_upsample_rgb_ref(yp, cbp, crp, subsamp, true_h, true_w,
                                     out_h, out_w)
    if dev.type != "cuda":
        raise ValueError(f"jpeg_upsample_rgb: unsupported device {dev}")
    lib = _build.load()
    b = yp.shape[0]
    out = torch.empty((b, 3, out_h, out_w), dtype=_U8, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fanlin_jpeg_upsample_rgb(
            yp.data_ptr(), cbp.data_ptr(), crp.data_ptr(), out.data_ptr(), b,
            yp.shape[1], yp.shape[2], cbp.shape[1], cbp.shape[2], subsamp,
            true_h, true_w, out_h, out_w, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"jpeg_upsample_rgb launch failed: CUDA error {rc}")
    _count("jpeg_upsample_rgb")
    return out


def jpeg_upsample_rgb_ref(yp, cbp, crp, subsamp: int, true_h: int,
                          true_w: int, out_h: int, out_w: int):
    """Plain torch version of K4, on any device."""
    y = yp[:, :true_h, :true_w].to(_I32)
    cb = jd.upsample_chroma(cbp.to(_I32), subsamp, true_h, true_w)
    cr = jd.upsample_chroma(crp.to(_I32), subsamp, true_h, true_w)
    rgb = torch.stack(jd.ycbcr_to_rgb_int(y, cb, cr), dim=1).to(_U8)
    return torch.nn.functional.pad(rgb, (0, out_w - true_w, 0, out_h - true_h))
