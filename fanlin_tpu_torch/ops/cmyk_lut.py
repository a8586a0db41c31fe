"""Device ICC colour management through a sampled 4-D LUT.

Port of fanlin_tpu/ops/cmyk_lut.py. A CMYK ICC profile is CLUT-based,
so the lcms2 transform is sampled once onto an n^4 grid (n = 17: 83,521
entries, 1.0 MB as f32) and pixels are evaluated by quadrilinear
interpolation, 16 corners each. `lut_planes` is the plain torch version
of the K12b kernel (`ops.cmyk_lut_kernels`, `csrc/cmyk_lut.cu`), with the
JAX function's f32 operations in its order; `DeviceCmykTransform` holds
one sampled LUT for a device and converts pixels through the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

_F32 = torch.float32


def sample_lut(convert_fn, n: int = 17) -> np.ndarray:
    """Sample a CMYK->RGB converter onto an (n, n, n, n, 3) u8 grid.

    convert_fn: PIL CMYK image -> (H, W, 3) u8 (engine.icc.CMYK2RGB.convert).
    """
    from PIL import Image

    levels = np.linspace(0, 255, n).round().astype(np.uint8)
    c, m, y, k = np.meshgrid(levels, levels, levels, levels, indexing="ij")
    flat = np.stack([c, m, y, k], axis=-1).reshape(-1, 4)
    side = int(np.ceil(np.sqrt(flat.shape[0])))
    padded = np.zeros((side * side, 4), dtype=np.uint8)
    padded[: flat.shape[0]] = flat
    img = Image.fromarray(padded.reshape(side, side, 4), "CMYK")
    rgb = convert_fn(img).reshape(-1, 3)[: flat.shape[0]]
    return rgb.reshape(n, n, n, n, 3)


def lut_scale(n: int) -> torch.Tensor:
    """The grid coordinate per sample step, f32((n - 1) / 255), as the
    JAX function's weakly typed Python float becomes in f32."""
    return torch.tensor((n - 1) / 255.0, dtype=_F32)


def lut_planes(c, m, y, k, lut_flat: torch.Tensor, n: int):
    """Quadrilinear LUT evaluation on planes: c, m, y, k integer tensors
    of one shape with samples in [0, 255]; lut_flat (n^4, 3) f32 on their
    device. Returns (r, g, b) f32 planes of integers in [0, 255].

    The operations of fanlin_tpu/ops/cmyk_lut.py:63-92, one torch op each
    (no fused multiply-add): x = v * scale, lo = clamp(floor(x), 0, n - 2),
    frac = x - lo; per corner 0..15 (bit i selects component i) the weight
    1 * f0 * f1 * f2 * f3 left to right with f = frac or 1 - frac, the
    index ((i0 n + i1) n + i2) n + i3, acc = acc + w * sample; the result
    clamp(floor(acc + 0.5), 0, 255)."""
    scale = lut_scale(n).to(c.device)
    comps = [v.to(_F32) * scale for v in (c, m, y, k)]
    lo = [torch.clamp(torch.floor(v).to(torch.int32), 0, n - 2) for v in comps]
    frac = [v - lv.to(_F32) for v, lv in zip(comps, lo)]
    acc = [0.0, 0.0, 0.0]
    for corner in range(16):
        bits = [(corner >> i) & 1 for i in range(4)]
        weight = 1.0
        flat_idx = 0
        for i in range(4):
            flat_idx = flat_idx * n + (lo[i] + bits[i])
            weight = weight * (frac[i] if bits[i] else 1.0 - frac[i])
        sample = lut_flat[flat_idx.to(torch.int64)]
        for ch in range(3):
            acc[ch] = acc[ch] + weight * sample[..., ch]
    return tuple(torch.clamp(torch.floor(a + 0.5), 0, 255) for a in acc)


class DeviceCmykTransform:
    """One sampled ICC LUT for a device: `convert` evaluates (H, W, 4) u8
    CMYK pixels through the K12b kernel on CUDA (its plain version on
    the CPU).

    `lut` is the (n, n, n, n, 3) grid of `sample_lut` or its (n^4, 3) f32
    form; `lut_np` keeps the latter, the very array when it is given so.
    The LUT's one device copy is the one `fused._device_cached` holds for
    `lut_np`: the coefficient route, whose metas carry the same array,
    reads that copy too. It is made here, so a failed upload raises at
    once. The JAX package uploads lazily under a lock, because a direct
    device_put there can hang on a wedged accelerator link; the port has
    no such link."""

    def __init__(self, lut: np.ndarray, device: torch.device):
        flat = lut.reshape(-1, 3)
        self.n = int(round(flat.shape[0] ** 0.25))
        if self.n ** 4 != flat.shape[0]:
            raise ValueError(f"lut: {flat.shape[0]} entries is not n^4")
        self.device = device
        self.lut_np = (lut if lut.ndim == 2 and lut.dtype == np.float32
                       and lut.flags.c_contiguous
                       else np.ascontiguousarray(flat, np.float32))
        self._lut()

    def _lut(self) -> torch.Tensor:
        from .fused import _device_cached

        return _device_cached(self.lut_np, self.device)

    def convert(self, cmyk: np.ndarray) -> np.ndarray:
        """(H, W, 4) u8 CMYK -> (H, W, 3) u8 RGB on the transform's
        device."""
        from . import cmyk_lut_kernels

        out = cmyk_lut_kernels.cmyk_lut_pixels(
            _pixels(cmyk).to(self.device), self._lut(), self.n)
        return out.cpu().numpy()


def _pixels(cmyk: np.ndarray) -> torch.Tensor:
    """(H, W, 4) u8 pixels as a CPU tensor (a read-only array, such as
    np.asarray of a PIL image, is copied first)."""
    a = np.ascontiguousarray(cmyk, np.uint8)
    return torch.from_numpy(a if a.flags.writeable else a.copy())
