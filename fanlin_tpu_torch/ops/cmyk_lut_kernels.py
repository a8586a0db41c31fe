"""The sampled ICC LUT kernel K12b: wrappers, plain version, launch count.

`cmyk_lut` (`csrc/cmyk_lut.cu`; the note at its top says what it
replaces, what bounds it and its design) evaluates a LUT packed by
`cmyk_lut.pack_lut` ((n^4, 4) int32) on (B, 4, H, W) u8 CMYK planes ->
(B, 3, H, W) u8 RGB. `cmyk_lut_pixels` runs the same kernel on (H, W, 4)
u8 pixels -> (H, W, 3) u8: the pixel route of
`cmyk_lut.DeviceCmykTransform`, which serves EXIF-rotated CMYK JPEGs.
The coefficient route converts inside the decode kernel instead
(`jpeg_decode_kernels.jpeg_decode_cmyk_rgb`).

On a CUDA tensor each wrapper launches the kernel; on a CPU tensor it
runs the kernel's order of work in torch (`cmyk_lut.lut_planes_packed`).
`cmyk_lut_ref` is the plain version on the f32 LUT (`cmyk_lut.
lut_planes`, the JAX function's order); both give the same bits. There
is no fallback: a failed build or launch raises.
"""

from __future__ import annotations

import threading

import torch

from . import _build
from .cmyk_lut import lut_planes, lut_planes_packed, lut_scale

_U8 = torch.uint8
_I32 = torch.int32

_COUNT_LOCK = threading.Lock()
_LAUNCHES = {"cmyk_lut": 0}


def launch_counts() -> dict:
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0


def check_packed(packed: torch.Tensor, n: int, device: torch.device) -> None:
    """Raise ValueError unless `packed` is a pack_lut LUT of n levels on
    `device`: contiguous (n^4, 4) int32, 16-byte aligned on CUDA."""
    if n < 2:
        raise ValueError(f"n={n}: a LUT grid has at least 2 levels")
    if (not isinstance(packed, torch.Tensor) or packed.dtype != _I32
            or tuple(packed.shape) != (n ** 4, 4)
            or not packed.is_contiguous()):
        raise ValueError(f"lut: expected a contiguous ({n ** 4}, 4) int32 "
                         "packed LUT (cmyk_lut.pack_lut)")
    if packed.device != device:
        raise ValueError(f"lut: on {packed.device}, expected {device}")
    if device.type == "cuda" and packed.data_ptr() % 16:
        raise ValueError("lut: must be 16-byte aligned")


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
    H, W) u8 RGB, every pixel converted; lut: pack_lut's (n^4, 4) int32
    on x's device. One launch on CUDA."""
    if (not isinstance(x, torch.Tensor) or x.dtype != _U8 or x.dim() != 4
            or x.shape[1] != 4 or not x.is_contiguous()):
        raise ValueError("x: expected a contiguous (B, 4, H, W) uint8 tensor")
    dev = x.device
    check_packed(lut, n, dev)
    if dev.type == "cpu":
        return cmyk_lut_packed_ref(x, lut, n)
    if dev.type != "cuda":
        raise ValueError(f"cmyk_lut: unsupported device {dev}")
    b, _, h, w = x.shape
    out = torch.empty((b, 3, h, w), dtype=_U8, device=dev)
    if x.numel():
        _launch(x, lut, out, n, b, h * w, (4 * h * w, h * w, 1),
                (3 * h * w, h * w, 1))
    return out


def cmyk_lut_ref(x: torch.Tensor, lut: torch.Tensor, n: int) -> torch.Tensor:
    """Plain torch version of cmyk_lut on the f32 LUT ((n^4, 3), on x's
    device): lut_planes, the JAX function's order. Any device."""
    r, g, b = lut_planes(x[:, 0], x[:, 1], x[:, 2], x[:, 3], lut, n)
    return torch.stack([r, g, b], dim=1).to(_U8)


def cmyk_lut_packed_ref(x: torch.Tensor, packed: torch.Tensor,
                        n: int) -> torch.Tensor:
    """cmyk_lut in the kernel's order of work on the packed LUT
    (lut_planes_packed), on any device: cmyk_lut_ref's bits."""
    r, g, b = lut_planes_packed(x[:, 0], x[:, 1], x[:, 2], x[:, 3], packed, n)
    return torch.stack([r, g, b], dim=1).to(_U8)


def cmyk_lut_pixels(px: torch.Tensor, lut: torch.Tensor,
                    n: int) -> torch.Tensor:
    """K12b on pixels: px (H, W, 4) u8 CMYK -> (H, W, 3) u8 RGB; lut as
    for cmyk_lut. One launch on CUDA."""
    if (not isinstance(px, torch.Tensor) or px.dtype != _U8 or px.dim() != 3
            or px.shape[2] != 4 or not px.is_contiguous()):
        raise ValueError("px: expected a contiguous (H, W, 4) uint8 tensor")
    dev = px.device
    check_packed(lut, n, dev)
    if dev.type == "cpu":
        return cmyk_lut_packed_ref(px.permute(2, 0, 1)[None], lut,
                                   n)[0].permute(1, 2, 0).contiguous()
    if dev.type != "cuda":
        raise ValueError(f"cmyk_lut_pixels: unsupported device {dev}")
    h, w, _ = px.shape
    out = torch.empty((h, w, 3), dtype=_U8, device=dev)
    if px.numel():
        _launch(px, lut, out, n, 1, h * w, (4 * h * w, 1, 4),
                (3 * h * w, 1, 3))
    return out
