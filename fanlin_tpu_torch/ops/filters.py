"""Resampling-filter weight matrices.

TPU-first design: instead of translating the reference's per-pixel
separable-convolution loops (the `image` crate's horizontal_sample /
vertical_sample, used by handler.rs:229-255 for Lanczos3 resize and
gaussian blur), we express every 1-D resample as a dense
(dst × src) weight matrix. A full 2-D resize is then two batched
matmuls that run on the TPU MXU:

    out[b] = Av[b] @ img[b] @ Ah[b]^T        (per channel)

The weight construction replicates the `image` crate's sampling
semantics exactly (same window placement, edge clamping by
renormalization over the clipped window, ratio-scaled support for
downsampling), so outputs match the reference bit-for-bit up to f32
accumulation order:

* window center for output x is (x + 0.5) * src/dst; support is
  filter.support * max(ratio, 1); taps span
  [floor(c - s), ceil(c + s)) clamped to [0, src); weights
  kernel((i - (c - 0.5)) / sratio) normalized to sum 1.
* Lanczos3: sinc(x) * sinc(x/3), support 3.0.
* Gaussian blur sigma: pdf kernel, support 2*sigma
  (image crate blur()).
* Nearest: one-hot at floor((x + 0.5) * ratio), clamped.

Matrices are cached by (src, dst, filter, crop window) — the same
amortization trick the reference applies to its 40 ms lcms2 transform
(handler.rs:483), here applied to resampling weights and, one level
up, to compiled XLA programs.
"""

from __future__ import annotations

import math

import numpy as np

LANCZOS3 = "lanczos3"
GAUSSIAN = "gaussian"
NEAREST = "nearest"
TRIANGLE = "triangle"
CATMULLROM = "catmullrom"

_SRGB_LUMA = (2126, 7152, 722)  # image crate's fixed-point Rec.709 luma
_SRGB_LUMA_DIV = 10000


def resize_dimensions(width: int, height: int, nwidth: int, nheight: int, fill: bool):
    """Aspect-preserving target dimensions.

    Mirrors the `image` crate's resize_dimensions (used by
    DynamicImage::resize / resize_to_fill): ratio = min (fit) or max
    (fill) of per-axis ratios, rounded, floor 1.
    """
    wratio = nwidth / width
    hratio = nheight / height
    ratio = max(wratio, hratio) if fill else min(wratio, hratio)
    # Rust f64::round = round half away from zero; inputs positive.
    nw = max(int(math.floor(width * ratio + 0.5)), 1)
    nh = max(int(math.floor(height * ratio + 0.5)), 1)
    u32max = 2**32 - 1
    if nw > u32max:
        ratio = u32max / width
        return u32max, max(int(math.floor(height * ratio + 0.5)), 1)
    if nh > u32max:
        ratio = u32max / height
        return max(int(math.floor(width * ratio + 0.5)), 1), u32max
    return nw, nh


def fill_crop_window(src_w: int, src_h: int, nwidth: int, nheight: int):
    """resize_to_fill's intermediate size + center-crop offsets.

    Mirrors DynamicImage::resize_to_fill (reference handler.rs:232-234
    relies on it): resize with fill=True then center-crop the
    overflowing axis (integer /2 offsets).
    """
    w2, h2 = resize_dimensions(src_w, src_h, nwidth, nheight, True)
    ratio = w2 * nheight
    nratio = nwidth * h2
    if nratio > ratio:
        x0, y0 = 0, (h2 - nheight) // 2
    else:
        x0, y0 = (w2 - nwidth) // 2, 0
    return w2, h2, x0, y0


def _lanczos3(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    with np.errstate(invalid="ignore", divide="ignore"):
        px = np.pi * x
        s1 = np.where(x == 0.0, 1.0, np.sin(px) / px)
        px3 = px / 3.0
        s2 = np.where(x == 0.0, 1.0, np.sin(px3) / px3)
    return np.where(ax < 3.0, s1 * s2, 0.0).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax < 1.0, 1.0 - ax, 0.0).astype(np.float32)


def _catmullrom(x: np.ndarray) -> np.ndarray:
    a = np.abs(x)
    a2 = a * a
    a3 = a2 * a
    out = np.where(
        a < 1.0,
        (9.0 * a3 - 15.0 * a2 + 6.0) / 6.0,
        np.where(a < 2.0, (-3.0 * a3 + 15.0 * a2 - 24.0 * a + 12.0) / 6.0, 0.0),
    )
    return out.astype(np.float32)


_KERNELS = {
    LANCZOS3: (_lanczos3, 3.0),
    TRIANGLE: (_triangle, 1.0),
    CATMULLROM: (_catmullrom, 2.0),
}


def _sample_weights(src: int, dst: int, kernel, support: float,
                    row0: int = 0, row1: int = None) -> np.ndarray:
    """(row1-row0, src) float32 weight matrix rows [row0, row1) of the
    full (dst, src) matrix, with image-crate sampling rules. Rows are
    independent, so a crop window never materializes the rows it
    throws away — resize_to_fill's intermediate `dst` scales with the
    source ASPECT RATIO (a 10000x200 panorama at w=2000&h=1000&crop
    puts the full matrix at 50000x10000 f32 = 2 GB; the 2000 kept
    rows are 80 MB)."""
    if row1 is None:
        row1 = dst
    w = np.zeros((row1 - row0, src), dtype=np.float32)
    ratio = np.float32(src) / np.float32(dst)
    sratio = max(ratio, np.float32(1.0))
    src_support = np.float32(support) * sratio

    outx = np.arange(row0, row1, dtype=np.float32)
    center = (outx + np.float32(0.5)) * ratio
    left = np.floor(center - src_support).astype(np.int64)
    left = np.clip(left, 0, src - 1)
    right = np.ceil(center + src_support).astype(np.int64)
    right = np.clip(right, left + 1, src)
    inputx = center - np.float32(0.5)

    for o in range(row1 - row0):
        taps = np.arange(left[o], right[o], dtype=np.float32)
        ws = kernel((taps - inputx[o]) / sratio).astype(np.float32)
        total = np.float32(ws.sum(dtype=np.float32))
        w[o, left[o] : right[o]] = ws / total
    return w


def _nearest_weights(src: int, dst: int, row0: int = 0,
                     row1: int = None) -> np.ndarray:
    """One-hot selection rows [row0, row1) for FilterType::Nearest."""
    if row1 is None:
        row1 = dst
    w = np.zeros((row1 - row0, src), dtype=np.float32)
    ratio = np.float32(src) / np.float32(dst)
    outx = np.arange(row0, row1, dtype=np.float32)
    idx = np.floor((outx + np.float32(0.5)) * ratio).astype(np.int64)
    idx = np.clip(idx, 0, src - 1)
    w[np.arange(row1 - row0), idx] = 1.0
    return w


# Byte-budgeted like every other matrix cache (ops.fused's ByteLRUs):
# a count-bounded lru_cache admits adversarial memory — matrices scale
# with SOURCE dims (bounded only by the 512 MiB decode gate), so 4096
# of them is an OOM, and entries here outliving their evicted plans
# would defeat _PLAN_CACHE's budget.
from ..utils.bytelru import ByteLRU  # noqa: E402

_MATRIX_CACHE = ByteLRU(max_bytes=256 * 1024 * 1024)


def resample_matrix(
    src: int, dst: int, filter_name: str, crop_off: int = 0, crop_len: int = 0
) -> np.ndarray:
    """1-D resample matrix; optionally only the cropped output window.

    crop_len > 0 folds resize_to_fill's center crop into the matrix:
    rows [crop_off, crop_off+crop_len) of the full (dst, src) matrix
    (built directly — the discarded rows are never allocated).
    A same-size resample is the identity (DynamicImage::resize's
    nothing-to-do fast path).
    """
    key = ("r", src, dst, filter_name, crop_off, crop_len)
    hit = _MATRIX_CACHE.get(key)
    if hit is not None:
        return hit
    row0, row1 = (crop_off, crop_off + crop_len) if crop_len > 0 else (0, dst)
    if dst == src:
        if crop_len == 0:
            m = np.eye(src, dtype=np.float32)
        else:
            m = np.zeros((crop_len, src), dtype=np.float32)
            m[np.arange(crop_len), np.arange(row0, row1)] = 1.0
    elif filter_name == NEAREST:
        m = _nearest_weights(src, dst, row0, row1)
    else:
        kernel, support = _KERNELS[filter_name]
        m = _sample_weights(src, dst, kernel, support, row0, row1)
    _MATRIX_CACHE.put(key, m, m.nbytes)
    return m


def gaussian_matrix(size: int, sigma: float) -> np.ndarray:
    """(size, size) same-size gaussian resample matrix (image crate blur).

    blur() uses kernel gaussian pdf(sigma) with support 2*sigma and the
    same sampling rules at ratio 1 (reference handler.rs:250-255 via
    image::imageops::blur; sigma pre-clamped to [10, 20] by
    query.rs:59-62).
    """
    sigma = float(sigma) if sigma > 0 else 1.0
    key = ("g", size, sigma)
    hit = _MATRIX_CACHE.get(key)
    if hit is not None:
        return hit

    def kernel(x: np.ndarray) -> np.ndarray:
        s = np.float32(sigma)
        return (
            np.float32(1.0)
            / (np.sqrt(np.float32(2.0) * np.float32(np.pi)) * s)
            * np.exp(-(x.astype(np.float32) ** 2) / (np.float32(2.0) * s * s))
        ).astype(np.float32)

    m = _sample_weights(size, size, kernel, 2.0 * sigma)
    _MATRIX_CACHE.put(key, m, m.nbytes)
    return m


def luma_u8(rgb: np.ndarray) -> np.ndarray:
    """image crate's fixed-point Rec.709 luma: floor((2126r+7152g+722b)/1e4)."""
    r = rgb[..., 0].astype(np.uint32)
    g = rgb[..., 1].astype(np.uint32)
    b = rgb[..., 2].astype(np.uint32)
    return (
        (_SRGB_LUMA[0] * r + _SRGB_LUMA[1] * g + _SRGB_LUMA[2] * b) // _SRGB_LUMA_DIV
    ).astype(np.uint8)
