"""Host-side planning: shape buckets, per-image plans, padded matrices
and their band ranges for the CUDA kernel.

Port of fanlin_tpu/ops/fused.py:47-183 and 1026-1093 (numpy only,
built on the shared `fanlin_tpu.ops.filters`). The bucket tables are
kept as they are: batch grouping and the uniform-matrix caches key on
them, and the tests hold every plan equal to the reference's.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Tuple

import numpy as np

from fanlin_tpu.ops import filters
from fanlin_tpu.utils.bytelru import ByteLRU

from .resample_kernels import band_ranges

# Shape buckets: H padded to a multiple of 8, W to a multiple of 128.
# Coarser steps above 512 cap the number of distinct batch shapes.
_H_STEPS = (8, 16, 32, 64, 128, 192, 256, 320, 384, 448, 512, 640, 768, 896, 1024, 1280, 1536, 1792, 2048)
_W_STEPS = (128, 256, 384, 512, 640, 768, 896, 1024, 1280, 1536, 1792, 2048)
_B_STEPS = (1, 2, 4, 8, 16, 32)


def bucket_h(h: int) -> int:
    for s in _H_STEPS:
        if h <= s:
            return s
    return -(-h // 128) * 128


def bucket_w(w: int) -> int:
    for s in _W_STEPS:
        if w <= s:
            return s
    return -(-w // 128) * 128


def bucket_h16(h: int) -> int:
    """bucket_h rounded up to a multiple of 16: a coefficient batch's
    block grids need whole 4:2:0 MCU rows (every _H_STEPS entry above 8
    is a multiple of 16 already, so only h <= 8 differs)."""
    b = bucket_h(h)
    return b + 8 if b % 16 else b


def bucket_b(b: int) -> int:
    for s in _B_STEPS:
        if b <= s:
            return s
    return -(-b // 32) * 32


@dataclasses.dataclass(eq=False)
class ImagePlan:
    """Per-image plan for one trip through the device program: the
    true (unpadded) geometry plus the per-image weight matrices."""

    src_h: int
    src_w: int
    out_h: int
    out_w: int
    av: np.ndarray  # (out_h, src_h) f32 — vertical resample (crop/canvas folded)
    ah: np.ndarray  # (out_w, src_w) f32
    gray: bool
    invert: bool
    fill: Tuple[int, int, int]
    box: Tuple[int, int, int, int]  # x0, y0, fw, fh of fg rect in output
    use_canvas: bool
    blur_sigma: float
    # False when the output alpha is constant 255 (opaque source or
    # fill canvas): the alpha plane is then never downloaded.
    want_alpha: bool = True


# Plans hold dense (out x src) f32 matrices, so the cache is
# byte-budgeted rather than count-bounded.
_PLAN_CACHE = ByteLRU(max_bytes=192 * 1024 * 1024)
# Misses are single-flight per key: concurrent first requests for one
# (source, query) wait for one build and share its plan object, so
# their batch is uniform. A hit takes no lock beyond the LRU's own.
_PLAN_BUILDS: dict = {}
_PLAN_BUILDS_LOCK = threading.Lock()


def plan_image(src_w: int, src_h: int, params, filter_name: str = filters.LANCZOS3,
               opaque: bool = False) -> ImagePlan:
    """Compute (or fetch) the transform plan. Identical queries share
    ONE plan object: a batch whose images all share a plan is uniform
    and runs on one shared matrix set.

    Mirrors reference src/handler.rs:229-255: resize only when both
    dims are set and differ from the source; crop=true -> cover +
    center crop; else aspect-preserving fit; fill-canvas overlay only
    when the fit result is smaller than requested.
    """
    key = (src_w, src_h, params, filter_name, opaque)
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit
    with _PLAN_BUILDS_LOCK:
        build = _PLAN_BUILDS.setdefault(key, threading.Lock())
    with build:
        plan = _PLAN_CACHE.get(key)
        if plan is None:
            plan = _plan_image_uncached(src_w, src_h, params, filter_name,
                                        opaque)
            _PLAN_CACHE.put(key, plan, plan.av.nbytes + plan.ah.nbytes)
    with _PLAN_BUILDS_LOCK:
        if _PLAN_BUILDS.get(key) is build:
            del _PLAN_BUILDS[key]
    return plan


def _plan_image_uncached(src_w: int, src_h: int, params, filter_name: str,
                         opaque: bool) -> ImagePlan:
    gray = params.grayscale()
    inv = params.inverse()
    fill = params.fill_color()
    sigma = params.blur()
    dims = params.dimensions()

    if dims is not None and (dims[0] != src_w or dims[1] != src_h):
        w, h = dims
        if params.cropping():
            w2, h2, x0, y0 = filters.fill_crop_window(src_w, src_h, w, h)
            av = filters.resample_matrix(src_h, h2, filter_name, y0, h)
            ah = filters.resample_matrix(src_w, w2, filter_name, x0, w)
            return ImagePlan(src_h, src_w, h, w, av, ah, gray, inv, fill,
                             (0, 0, w, h), False, sigma, not opaque)
        rw, rh = filters.resize_dimensions(src_w, src_h, w, h, False)
        if w > rw or h > rh:
            # fill-canvas overlay, centered (handler.rs:238-248)
            x0 = abs(w - rw) // 2
            y0 = abs(h - rh) // 2
            av_r = filters.resample_matrix(src_h, rh, filter_name)
            ah_r = filters.resample_matrix(src_w, rw, filter_name)
            av = np.zeros((h, src_h), dtype=np.float32)
            av[y0 : y0 + rh] = av_r
            ah = np.zeros((w, src_w), dtype=np.float32)
            ah[x0 : x0 + rw] = ah_r
            return ImagePlan(src_h, src_w, h, w, av, ah, gray, inv, fill,
                             (x0, y0, rw, rh), True, sigma, False)
        av = filters.resample_matrix(src_h, rh, filter_name)
        ah = filters.resample_matrix(src_w, rw, filter_name)
        return ImagePlan(src_h, src_w, rh, rw, av, ah, gray, inv, fill,
                         (0, 0, rw, rh), False, sigma, not opaque)

    # no resize: output at source dims
    av = filters.resample_matrix(src_h, src_h, filter_name)
    ah = filters.resample_matrix(src_w, src_w, filter_name)
    return ImagePlan(src_h, src_w, src_h, src_w, av, ah, gray, inv, fill,
                     (0, 0, src_w, src_h), False, sigma, not opaque)


# Padded shared-matrix cache for uniform batches, keyed by plan
# identity (the plan is kept in the value so a live id cannot collide).
# Each entry also holds the matrices' band ranges for the CUDA kernel.
_UNIFORM_CACHE = ByteLRU(max_bytes=96 * 1024 * 1024)


def _uniform_padded(plan: ImagePlan):
    """(av, ah, bv, bh) padded to the plan's buckets, cached; bv/bh are
    None without blur."""
    return _uniform_entry(plan)[0]


def _uniform_bands(plan: ImagePlan) -> np.ndarray:
    """resample_kernels.band_ranges of _uniform_padded(plan), cached
    beside it."""
    return _uniform_entry(plan)[1]


def _uniform_entry(plan: ImagePlan):
    # Coefficient batches use these entries unchanged: the decode
    # kernel K4 writes the same (bucket_h, bucket_w) source layout as a
    # pixel upload, with rows and columns past the true dims zero (and
    # the matrices' columns there zero too).
    key = id(plan)
    hit = _UNIFORM_CACHE.get(key)
    if hit is not None and hit[0] is plan:
        return hit[1:]
    sh, sw = bucket_h(plan.src_h), bucket_w(plan.src_w)
    oh, ow = bucket_h(plan.out_h), bucket_w(plan.out_w)
    av = np.zeros((oh, sh), dtype=np.float32)
    av[: plan.out_h, : plan.src_h] = plan.av
    ah = np.zeros((ow, sw), dtype=np.float32)
    ah[: plan.out_w, : plan.src_w] = plan.ah
    bv = bh = None
    if plan.blur_sigma > 0:
        bv = np.zeros((oh, oh), dtype=np.float32)
        bv[: plan.out_h, : plan.out_h] = filters.gaussian_matrix(
            plan.out_h, plan.blur_sigma
        )
        bh = np.zeros((ow, ow), dtype=np.float32)
        bh[: plan.out_w, : plan.out_w] = filters.gaussian_matrix(
            plan.out_w, plan.blur_sigma
        )
    value = (av, ah, bv, bh)
    bands = band_ranges(*value)
    nbytes = sum(a.nbytes for a in value if a is not None) + bands.nbytes
    _UNIFORM_CACHE.put(key, (plan, value, bands), nbytes)
    return value, bands


def _pack_params(plans, b: int, sh: int, sw: int, oh: int, ow: int,
                 uniform: bool, has_blur: bool, zeros=np.zeros):
    """The per-image parameter arrays: (flags, fill, box) always;
    padded per-image (av, ah) and blur (bv, bh) stacks when the batch
    isn't uniform (identity blur for images without one). `zeros`
    allocates each zeroed array (the batch's upload staging)."""
    flags = zeros((b, 3), dtype=np.float32)
    fill = zeros((b, 3), dtype=np.float32)
    box = zeros((b, 4), dtype=np.int32)
    av = ah = bv = bh = None
    if not uniform:
        av = zeros((b, oh, sh), dtype=np.float32)
        ah = zeros((b, ow, sw), dtype=np.float32)
        if has_blur:
            bv = zeros((b, oh, oh), dtype=np.float32)
            bh = zeros((b, ow, ow), dtype=np.float32)
    for i, p in enumerate(plans):
        flags[i] = (float(p.gray), float(p.invert), float(p.use_canvas))
        fill[i] = p.fill
        box[i] = p.box
        if uniform:
            continue
        av[i, : p.out_h, : p.src_h] = p.av
        ah[i, : p.out_w, : p.src_w] = p.ah
        if has_blur:
            if p.blur_sigma > 0:
                bv[i, : p.out_h, : p.out_h] = filters.gaussian_matrix(
                    p.out_h, p.blur_sigma
                )
                bh[i, : p.out_w, : p.out_w] = filters.gaussian_matrix(
                    p.out_w, p.blur_sigma
                )
            else:
                bv[i, : p.out_h, : p.out_h] = np.eye(p.out_h, dtype=np.float32)
                bh[i, : p.out_w, : p.out_w] = np.eye(p.out_w, dtype=np.float32)
    return flags, fill, box, av, ah, bv, bh
