"""The sampled ICC LUT kernel K12b: wrappers, plain version, launch count.

`cmyk_lut` (`csrc/cmyk_lut.cu`; the note at its top says what it
replaces, what bounds it and its design) evaluates an (n^4, 3) f32 LUT
on (B, 4, H, W) u8 CMYK planes -> (B, 3, H, W) u8 RGB: the CMYK
coefficient route runs it after the 4-component decode
(`jpeg_decode_kernels.jpeg_decode_cmyk`). `cmyk_lut_pixels` runs the same
kernel on (H, W, 4) u8 pixels -> (H, W, 3) u8, the pixel route of
`cmyk_lut.DeviceCmykTransform`.

On a CUDA tensor each wrapper launches the kernel; on a CPU tensor it
runs the plain version (`cmyk_lut.lut_planes`). There is no fallback: a
failed build or launch raises. The kernel is bit-exact against the plain
version (the same f32 operations, none fused).
"""

from __future__ import annotations

import threading

import torch

from . import _build
from .cmyk_lut import lut_planes, lut_scale

_U8 = torch.uint8
_F32 = torch.float32

_COUNT_LOCK = threading.Lock()
_LAUNCHES = {"cmyk_lut": 0}


def launch_counts() -> dict:
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0


def _check_lut(lut: torch.Tensor, n: int, device: torch.device) -> None:
    if (not isinstance(lut, torch.Tensor) or lut.dtype != _F32
            or tuple(lut.shape) != (n ** 4, 3) or not lut.is_contiguous()):
        raise ValueError(f"lut: expected a contiguous ({n ** 4}, 3) float32 "
                         "tensor")
    if lut.device != device:
        raise ValueError(f"lut: on {lut.device}, expected {device}")
    if n < 2:
        raise ValueError(f"n={n}: a LUT grid has at least 2 levels")


def _launch(x, lut, out, n, batch, npix, in_strides, out_strides) -> None:
    lib = _build.load()
    dev = x.device
    with torch.cuda.device(dev):
        rc = lib.fanlin_cmyk_lut(
            x.data_ptr(), lut.data_ptr(), out.data_ptr(), batch, npix,
            *in_strides, *out_strides, n, float(lut_scale(n)),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cmyk_lut launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        _LAUNCHES["cmyk_lut"] += 1


def cmyk_lut(x: torch.Tensor, lut: torch.Tensor, n: int) -> torch.Tensor:
    """K12b on planes: x (B, 4, H, W) u8 CMYK (PIL's convention) -> (B, 3,
    H, W) u8 RGB, every pixel converted. One launch on CUDA."""
    if (not isinstance(x, torch.Tensor) or x.dtype != _U8 or x.dim() != 4
            or x.shape[1] != 4 or not x.is_contiguous()):
        raise ValueError("x: expected a contiguous (B, 4, H, W) uint8 tensor")
    dev = x.device
    _check_lut(lut, n, dev)
    if dev.type == "cpu":
        return cmyk_lut_ref(x, lut, n)
    if dev.type != "cuda":
        raise ValueError(f"cmyk_lut: unsupported device {dev}")
    b, _, h, w = x.shape
    out = torch.empty((b, 3, h, w), dtype=_U8, device=dev)
    if x.numel():
        _launch(x, lut, out, n, b, h * w, (4 * h * w, h * w, 1),
                (3 * h * w, h * w, 1))
    return out


def cmyk_lut_ref(x: torch.Tensor, lut: torch.Tensor, n: int) -> torch.Tensor:
    """Plain torch version of cmyk_lut, on any device."""
    r, g, b = lut_planes(x[:, 0], x[:, 1], x[:, 2], x[:, 3], lut, n)
    return torch.stack([r, g, b], dim=1).to(_U8)


def cmyk_lut_pixels(px: torch.Tensor, lut: torch.Tensor,
                    n: int) -> torch.Tensor:
    """K12b on pixels: px (H, W, 4) u8 CMYK -> (H, W, 3) u8 RGB. One
    launch on CUDA."""
    if (not isinstance(px, torch.Tensor) or px.dtype != _U8 or px.dim() != 3
            or px.shape[2] != 4 or not px.is_contiguous()):
        raise ValueError("px: expected a contiguous (H, W, 4) uint8 tensor")
    dev = px.device
    _check_lut(lut, n, dev)
    if dev.type == "cpu":
        return cmyk_lut_ref(px.permute(2, 0, 1)[None], lut, n)[0].permute(
            1, 2, 0).contiguous()
    if dev.type != "cuda":
        raise ValueError(f"cmyk_lut_pixels: unsupported device {dev}")
    h, w, _ = px.shape
    out = torch.empty((h, w, 3), dtype=_U8, device=dev)
    if px.numel():
        _launch(px, lut, out, n, 1, h * w, (4 * h * w, 1, 4),
                (3 * h * w, 1, 3))
    return out
