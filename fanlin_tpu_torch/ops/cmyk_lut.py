"""Device ICC colour management through a sampled 4-D LUT.

Port of fanlin_tpu/ops/cmyk_lut.py. A CMYK ICC profile is CLUT-based,
so the lcms2 transform is sampled once onto an n^4 grid (n = 17: 83,521
entries, 1.0 MB as f32) and pixels are evaluated by quadrilinear
interpolation, 16 corners each. `lut_planes` is the plain torch version,
the JAX function's f32 operations in its order. The kernels
(`ops.cmyk_lut_kernels`, `csrc/cmyk_lut.cu`, and the CMYK decode that
converts in its colour stage) read the LUT packed by `pack_lut`, u8
samples four entries to a 16 B row; `lut_planes_packed` is their order
of work in torch, bit-equal to `lut_planes`. `DeviceCmykTransform` holds
one sampled LUT for a device and converts pixels through the kernel, or
through the host mirror's numpy LUT (`convert_host`) while the device is
wedged.
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


def pack_lut(lut_flat, n: int) -> torch.Tensor:
    """The (n^4, 3) LUT as the kernels read it: a contiguous (n^4, 4)
    int32 tensor, row e holding the words of entries e, e + 1, e + n and
    e + n + 1 (the corners the K and Y bits select), each word R | G << 8
    | B << 16. Rows whose Y or K level is n - 1 are never a base (lo
    clamps to n - 2) and hold zeros. lut_flat: a float32 array or tensor
    of integers in [0, 255], as `sample_lut` gives; anything else raises
    ValueError (the kernels have no f32 form to fall back on)."""
    t = torch.as_tensor(lut_flat)
    if t.dtype != _F32 or tuple(t.shape) != (n ** 4, 3) or n < 2:
        raise ValueError(f"lut: expected an ({n ** 4}, 3) float32 LUT with "
                         f"n >= 2, got {tuple(t.shape)} {t.dtype}, n={n}")
    t = t.cpu()
    if not (torch.equal(t, torch.floor(t)) and bool((t >= 0).all())
            and bool((t <= 255).all())):
        raise ValueError("lut: samples must be integers in [0, 255]")
    v = t.to(torch.int32)
    words = v[:, 0] | (v[:, 1] << 8) | (v[:, 2] << 16)
    grid = torch.nn.functional.pad(words.reshape(n, n, n, n), (0, 1, 0, 1))
    rows = torch.stack([grid[:, :, :n, :n], grid[:, :, :n, 1:],
                        grid[:, :, 1:, :n], grid[:, :, 1:, 1:]], dim=-1)
    rows[:, :, n - 1] = 0
    rows[:, :, :, n - 1] = 0
    return rows.reshape(n ** 4, 4).contiguous()


def lut_planes_packed(c, m, y, k, packed: torch.Tensor, n: int):
    """`lut_planes` in the kernels' order of work, on the packed LUT:
    the same f32 operations, each rounded on its own, so the same bits.
    The four rows of the C and M corners (bases base, + n^3, + n^2, + n^3
    + n^2) are gathered first; the weights are built as shared prefixes,
    f0 * f1 (4 products), then * f2 (8) and * f3 (16), each the same left
    to right product as lut_planes's; corners 0..15 accumulate in order,
    corner c's sample the word 2 * (bit 2) + (bit 3) of row c & 3."""
    scale = lut_scale(n).to(c.device)
    comps = [v.to(_F32) * scale for v in (c, m, y, k)]
    lo = [torch.clamp(torch.floor(v).to(torch.int32), 0, n - 2) for v in comps]
    frac = [v - lv.to(_F32) for v, lv in zip(comps, lo)]
    f = [(1.0 - fr, fr) for fr in frac]  # f[i][bit]
    base = ((lo[0] * n + lo[1]) * n + lo[2]) * n + lo[3]
    rows = [packed[(base + n ** 3 * (r & 1) + n ** 2 * (r >> 1)).to(
        torch.int64)] for r in range(4)]
    p01 = [f[0][j & 1] * f[1][j >> 1] for j in range(4)]
    p012 = [p01[j & 3] * f[2][j >> 2] for j in range(8)]
    w = [p012[j & 7] * f[3][j >> 3] for j in range(16)]
    acc = [0.0, 0.0, 0.0]
    for corner in range(16):
        word = rows[corner & 3][..., 2 * ((corner >> 2) & 1) + (corner >> 3)]
        for ch in range(3):
            sample = ((word >> (8 * ch)) & 0xFF).to(_F32)
            acc[ch] = acc[ch] + w[corner] * sample
    return tuple(torch.clamp(torch.floor(a + 0.5), 0, 255) for a in acc)


class DeviceCmykTransform:
    """One sampled ICC LUT for a device: `convert` evaluates (H, W, 4) u8
    CMYK pixels through the K12b kernel on CUDA (its plain version on
    the CPU).

    `lut` is the (n, n, n, n, 3) grid of `sample_lut` or its (n^4, 3) f32
    form; `lut_np` keeps the latter, the very array when it is given so.
    The LUT's one device copy is the packed one `fused._device_packed_lut`
    holds for `lut_np`: the coefficient route, whose metas carry the same
    array, reads that copy too. It is made here, so a LUT that does not
    pack (not integers in [0, 255]) or a failed upload raises at once.
    The JAX package uploads lazily under a lock, because a direct
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
        from .fused import _device_packed_lut

        return _device_packed_lut(self.lut_np, self.n, self.device)

    def convert(self, cmyk: np.ndarray) -> np.ndarray:
        """(H, W, 4) u8 CMYK -> (H, W, 3) u8 RGB on the transform's
        device."""
        from . import cmyk_lut_kernels

        out = cmyk_lut_kernels.cmyk_lut_pixels(
            _pixels(cmyk).to(self.device), self._lut(), self.n)
        return out.cpu().numpy()

    def convert_host(self, cmyk: np.ndarray) -> np.ndarray:
        """(H, W, 4) u8 CMYK -> (H, W, 3) u8 RGB in numpy, touching no
        device (`convert_host` of the module), for serving while the
        device is wedged."""
        return convert_host(cmyk, self.lut_np, self.n)


def convert_host(cmyk: np.ndarray, lut_flat: np.ndarray, n: int) -> np.ndarray:
    """(H, W, 4) u8 CMYK pixels through an (n^4, 3) f32 LUT in numpy: the
    host mirror's LUT (`host_decode.lut_planes`), the kernel's bytes."""
    from .host_decode import lut_planes

    c, m, y, k = (cmyk[..., i] for i in range(4))
    r, g, b = lut_planes(c, m, y, k, lut_flat, n)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def _pixels(cmyk: np.ndarray) -> torch.Tensor:
    """(H, W, 4) u8 pixels as a CPU tensor (a read-only array, such as
    np.asarray of a PIL image, is copied first)."""
    a = np.ascontiguousarray(cmyk, np.uint8)
    return torch.from_numpy(a if a.flags.writeable else a.copy())
