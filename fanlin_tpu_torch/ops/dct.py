"""The device JPEG back half (K9): edge pad, level shift, 8x8 forward
DCT and IJG quantisation, in plain torch on the device of the tensors.

Port of fanlin_tpu/ops/dct.py: `ijg_quant_tables` and `_dct_matrix`
are copies (:57-74); `_pad_edge`, `planar_dct_quant` and
`ycbcr420_to_planar` (:77-91, :141-174) are ported to torch;
`blocks_from_planar` (:231-239) is host numpy. The host then does
entropy coding only (`engine.jpeg_encode`).

The transform runs per 8x8 block on the planar layout (position
(8i+u, 8j+v) holds F(u, v) of block (i, j)) instead of the reference's
H x H block-diagonal matrices, which were a TPU layout device and cost
O(H) more multiply-adds for the same sums. Each of the two 8-term sums
is spelled out in a fixed order, as an f32 fused multiply-add chain
(the product is exact in f64, so f64 add + one rounding to f32 is the
fused step): a library GEMM sums in an order of its own choosing, which
differs between the CPU and the card, and a coefficient whose quotient
lands on a .5 boundary (a flat block at a table value of 16, say) then
rounds either way. With the order fixed, the card and the CPU give the
same coefficients bit for bit; against the reference (XLA's CPU GEMM,
whose order is its own) they differ only at such ties.
After the transform the reference's order of operations is kept:
divide by the table as f32, then sign(r) * floor(|r| + 0.5).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_F32 = torch.float32
_F64 = torch.float64

# JPEG Annex K base tables (the same constants libjpeg ships)
_BASE_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.int32)
_BASE_CHROMA = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], dtype=np.int32)


def ijg_quant_tables(quality: int):
    """(luma, chroma) uint16 8x8 tables — jpeg_set_quality's scaling."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - q * 2
    luma = np.clip((_BASE_LUMA * scale + 50) // 100, 1, 255).astype(np.uint16)
    chroma = np.clip((_BASE_CHROMA * scale + 50) // 100, 1, 255).astype(np.uint16)
    return luma, chroma


@functools.lru_cache(maxsize=1)
def _dct_matrix() -> np.ndarray:
    """Orthonormal 8x8 DCT-II matrix (f32)."""
    d = np.zeros((8, 8), dtype=np.float64)
    for u in range(8):
        s = np.sqrt(1.0 / 8.0) if u == 0 else np.sqrt(2.0 / 8.0)
        for x in range(8):
            d[u, x] = s * np.cos((2 * x + 1) * u * np.pi / 16.0)
    return d.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _device_dct_matrix(device: torch.device) -> torch.Tensor:
    """`_dct_matrix()` as f64 (exactly its f32 values) on `device`, copied
    once (a blocking copy, done before any stream reads it)."""
    return torch.from_numpy(_dct_matrix().astype(np.float64)).to(device)


@functools.lru_cache(maxsize=256)
def device_quant_tables(quality: int, device: torch.device):
    """`ijg_quant_tables(quality)` as (8, 8) f32 tensors on `device`,
    copied once per quality."""
    return tuple(torch.from_numpy(t.astype(np.float32)).to(device)
                 for t in ijg_quant_tables(quality))


def _pad_edge(plane: torch.Tensor, mult: int) -> torch.Tensor:
    """(B, H, W) -> edge-replicated to multiples of `mult` (libjpeg's
    MCU edge expansion)."""
    b, h, w = plane.shape
    ph = -(-h // mult) * mult
    pw = -(-w // mult) * mult
    if ph != h:
        plane = torch.cat([plane, plane[:, -1:, :].expand(b, ph - h, w)], 1)
    if pw != w:
        plane = torch.cat([plane, plane[:, :, -1:].expand(b, ph, pw - w)], 2)
    return plane


def _fma_chain(terms, coeffs: torch.Tensor, shape) -> torch.Tensor:
    """sum_s coeffs[:, s] * terms[s] as a sequential f32 FMA chain in
    s order. terms: 8 f64 views (of f32 values) broadcasting with
    `coeffs[:, s]` viewed as `shape`; coeffs: (8, 8) f64 (of f32 values)
    on their device. A product of two f32 values is exact in f64 (24-bit
    mantissas), so each step, an f64 multiply-add of the f32 sum rounded
    once to f32, is an f32 fused multiply-add."""
    acc = (coeffs[:, 0].view(shape) * terms[0]).to(_F32)
    for s in range(1, 8):
        acc = torch.addcmul(acc, coeffs[:, s].view(shape), terms[s]).to(_F32)
    return acc


def planar_dct_quant(plane_f32: torch.Tensor,
                     qtable_f32: torch.Tensor) -> torch.Tensor:
    """(B, H, W) f32 (level-shifted, 8-aligned) -> (B, H, W) int16
    quantized coefficients in PLANAR layout: position (8i+u, 8j+v)
    holds F(u, v) of block (i, j). qtable_f32: (8, 8) or (64,) f32 on
    the plane's device."""
    b, h, w = plane_f32.shape
    d = _device_dct_matrix(plane_f32.device)
    # columns: t[8i+u, x] = sum_s D[u, s] f[8i+s, x]
    x5 = plane_f32.to(_F64).reshape(b, h // 8, 8, w)
    t = _fma_chain([x5[:, :, s:s + 1, :] for s in range(8)], d,
                   (1, 1, 8, 1))
    # rows: F[r, 8j+v] = sum_x D[v, x] t[r, 8j+x]
    t5 = t.to(_F64).reshape(b, h, w // 8, 8)
    coef = _fma_chain([t5[..., s:s + 1] for s in range(8)], d,
                      (1, 1, 1, 8)).reshape(b, h, w)
    qt = qtable_f32.to(_F32).reshape(1, 8, 1, 8)
    r = (coef.reshape(b, h // 8, 8, w // 8, 8) / qt).reshape(b, h, w)
    # round half away from zero (libjpeg's DESCALE rounding)
    r = torch.sign(r) * torch.floor(torch.abs(r) + 0.5)
    return r.to(torch.int16)


def ycbcr420_to_planar(y, cb, cr, luma_q, chroma_q):
    """Device JPEG back half, planar: (B, H, W) u8 planes (Y, and the
    (B, ceil(H/2), ceil(W/2)) chroma) -> three (B, padded H, padded W)
    int16 planar coefficient planes, luma padded to 16, chroma to 8.
    luma_q/chroma_q: the encoder's 8x8 tables, numpy arrays or f32
    tensors on the planes' device (`device_quant_tables`)."""
    lq, cq = (torch.as_tensor(np.asarray(q, np.float32)
                              if isinstance(q, np.ndarray) else q,
                              dtype=_F32, device=y.device)
              for q in (luma_q, chroma_q))
    yp = _pad_edge(y.to(_F32), 16) - 128.0
    cbp = _pad_edge(cb.to(_F32), 8) - 128.0
    crp = _pad_edge(cr.to(_F32), 8) - 128.0
    return (
        planar_dct_quant(yp, lq),
        planar_dct_quant(cbp, cq),
        planar_dct_quant(crp, cq),
    )


def blocks_from_planar(planar: np.ndarray) -> np.ndarray:
    """Host: (..., H, W) int16 planar -> (..., H/8, W/8, 64) block
    grids (the entropy encoder's layout) — one cheap numpy shuffle into
    a new array (never a view of `planar`, which may be a pinned
    download buffer that is reused once the batch is collected)."""
    *lead, h, w = planar.shape
    blocks = np.empty((*lead, h // 8, w // 8, 8, 8), planar.dtype)
    blocks[...] = planar.reshape(*lead, h // 8, 8, w // 8, 8).swapaxes(-3, -2)
    return blocks.reshape(*lead, h // 8, w // 8, 64)
