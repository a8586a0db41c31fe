"""Startup warmup (`tpu.warmup`, `tpu.warmup_shapes`).

Port of fanlin_tpu/engine/warmup.py. The reference pays its one-time
setup at startup (the lcms2 transform, reference src/handler.rs:483,
main.rs:74-76); the JAX package precompiles its XLA programs there. On
the card nothing compiles per shape, but a fresh process is still cold
where a first request would pay: the kernels' lazily loaded modules
(one per kernel function), the plan cache and its device matrices, and
the pinned host staging pool that a first batch of a size grows. So
`warm` runs each shape once at B=1 and once at B=max_batch on every
kind the Engine routes that shape to: pixel and coefficient sources
(4:2:0 and 4:4:4), each with the device encode front-ends that are on
(`jpeg420` and `webp420` with the native codec core, `jpegdct` with
`tpu.device_dct`); with `tpu.fast_decode` the coefficient kinds are the
folded ones (their matrices and device copies, as the JAX package
compiles its folded programs at startup, fanlin_tpu/engine/warmup.py:202).
A batcher made with `tpu.fast` runs every warm batch in its bf16 form,
so the resample kernel's fast instances are the ones loaded.

The host side of a first request is cold too: PIL loads its format
plugins at the first open (tens of ms), the host JPEG reader's library
loads, the plans are built. `warm_host` pays those in the process that
serves HTTP; in worker mode the parent runs it before the fork, so
every worker starts with them (the JAX package warms the device side
only).

Every batch runs through `MicroBatcher.warm_batch`: on the batcher's
device thread and stream, where the port touches device tensors, one
batch at a time, so served batches interleave with warmup.

Every device touch is gated on `device_ok` (the batcher's
`device_available`), as fanlin_tpu/engine/warmup.py:110-130 gates its
compiles: while the batcher has the device wedged, warmup defers,
polling every _DEFER_POLL_S, and resumes where it stopped once a probe
recovers the device; a batch that failed while the device went down is
run again after the recovery (at most _WARM_ATTEMPTS times). A warm
batch is never served from the host mirror.

Left out of the JAX package's warmup, having no counterpart in the
port: the spectral-thinning flavours and the jpegdct pack-rung ladder
(the narrow-link wire rungs, not ported) and the eight compile threads
(there is nothing to compile in parallel).
"""

from __future__ import annotations

import io
import logging
import time
from typing import Tuple

import numpy as np

from ..ops import filters, fused
from ..ops.plan import plan_image
from ..spec.query import parse_query
from . import jpeg_coeffs, native_codecs

log = logging.getLogger("fanlin.warmup")

# (src_w, src_h, query) shapes warmed by default: the README request and
# its blur variant.
DEFAULT_SHAPES: Tuple[Tuple[int, int, str], ...] = (
    (512, 512, "w=300&h=200"),
    (512, 512, "w=300&h=200&blur=10"),
)

# cap on the geometries derived from a deployment's fallback images
MAX_DERIVED_GEOMETRIES = 4

# the coefficient kinds warmed, by read_jpeg_coeffs subsampling: 4:2:0
# (camera and web JPEGs) and 4:4:4 (the README source)
_COEF_KINDS = ((2, "coef"), (0, "coef444"))

# how often deferred warmup checks device_ok while the device is wedged,
# and how often one batch is tried when the device goes down under it
_DEFER_POLL_S = 5.0
_WARM_ATTEMPTS = 3


def shapes_from_state(state, configured: Tuple = ()) -> Tuple:
    """The warmup shapes of a deployment. Configured shapes
    (tpu.warmup_shapes) are added to the defaults; without them the
    source geometries of the preloaded fallback images (the only ones a
    config implies) are, under the default query, at most
    MAX_DERIVED_GEOMETRIES of them."""
    if configured:
        return DEFAULT_SHAPES + tuple(configured)
    shapes = list(DEFAULT_SHAPES)
    seen = {(w, h) for w, h, _ in DEFAULT_SHAPES}
    derived = 0
    for data in getattr(state, "fallback_images", {}).values():
        if derived >= MAX_DERIVED_GEOMETRIES:
            break
        try:
            from PIL import Image

            with Image.open(io.BytesIO(data)) as im:
                w, h = im.size
        except Exception:
            continue
        if (w, h) in seen:
            continue
        seen.add((w, h))
        shapes.append((w, h, "w=300&h=200"))
        derived += 1
    return tuple(shapes)


def _coef_meta(src_w: int, src_h: int, subsampling: int) -> dict:
    """A read_jpeg_coeffs dict at the shape's true block grids: the
    port's reader on a flat JPEG that PIL writes."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.full((src_h, src_w, 3), 128, np.uint8)).save(
        buf, format="JPEG", quality=92, subsampling=subsampling)
    return jpeg_coeffs.read_jpeg_coeffs(buf.getvalue())


def _kinds(device_decode: bool, device_dct: bool, fold: bool = False):
    """(source, kind) pairs: source is "pix" or a PIL subsampling; with
    `fold` the coefficient kinds are the folded ones (fast_decode)."""
    sinks = ["rgb"]
    if native_codecs.available():
        sinks.append("jpeg420")
    if native_codecs.has_webp_yuv420():
        sinks.append("webp420")
    if device_dct:
        sinks.append("jpegdct:75")
    out = [("pix", sink) for sink in sinks]
    if device_decode:
        for subsampling, base in _COEF_KINDS:
            if fold:
                base += fused.FOLD_SUFFIX
            out += [(subsampling, base if sink == "rgb" else f"{base}+{sink}")
                    for sink in sinks]
    return out


def warm_host(shapes=DEFAULT_SHAPES) -> None:
    """The host side of a first request, for `shapes`: PIL's plugins, the
    host JPEG reader's library and the plans. Touches no device."""
    from PIL import Image

    from ..ops import _build

    Image.init()
    _build.load_host()
    for src_w, src_h, qs in shapes:
        plan_image(src_w, src_h, parse_query(qs), filters.LANCZOS3,
                   opaque=True)


class _Closed(Exception):
    """The batcher closed: warmup ends."""


def _await_device(batcher, device_ok) -> None:
    """Return once device_ok() holds; raise _Closed if the batcher
    closes meanwhile."""
    if device_ok():
        return
    log.warning("device wedged: deferring warmup until it recovers")
    while not device_ok():
        if batcher.closed:
            raise _Closed()
        time.sleep(_DEFER_POLL_S)
    log.info("device recovered: resuming warmup")


def _warm_one(batcher, device_ok, plans, payloads, kinds) -> bool:
    """One warm batch, deferred while the device is wedged and run again
    (up to _WARM_ATTEMPTS) when it failed as the device went down; True
    when it ran. Raises _Closed once the batcher is closed."""
    for attempt in range(_WARM_ATTEMPTS):
        _await_device(batcher, device_ok)
        try:
            fut = batcher.warm_batch(plans, payloads, kinds)
        except RuntimeError:
            raise _Closed() from None
        try:
            fut.result()
            return True
        except Exception as e:
            log.warning("warmup batch %s %dx%d B=%d failed: %r", kinds[0],
                        plans[0].src_w, plans[0].src_h, len(plans), e)
            if device_ok() or attempt + 1 == _WARM_ATTEMPTS:
                return False
    return False


def warm(batcher, shapes=DEFAULT_SHAPES, device_decode: bool = True,
         device_dct: bool = False, fast_decode: bool = False,
         device_ok=None) -> int:
    """Run every (src_w, src_h, query) shape through `batcher` at B=1
    and B=max_batch on each kind it may take (with `fast_decode`, the
    folded kinds where the Engine would fold the shape's plan). Returns
    the number of batches run; a failed batch is logged and skipped, and
    a closed batcher ends the warmup. device_ok (default: the batcher's
    device_available) gates every batch: warmup defers while it is
    False."""
    if device_ok is None:
        device_ok = batcher.device_available
    t0 = time.perf_counter()
    done = total = 0
    try:
        for src_w, src_h, qs in shapes:
            plan = plan_image(src_w, src_h, parse_query(qs),
                              filters.LANCZOS3, opaque=True)
            kinds = _kinds(device_decode, device_dct,
                           fast_decode and not (plan.gray or plan.invert))
            payloads = {"pix": np.zeros((src_h, src_w, 3), np.uint8)}
            for b in sorted({1, batcher.max_batch}):
                for src, kind in kinds:
                    if src not in payloads:
                        payloads[src] = _coef_meta(src_w, src_h, src)
                    total += 1
                    done += _warm_one(batcher, device_ok, [plan] * b,
                                      [payloads[src]] * b, [kind] * b)
    except _Closed:
        log.info("warmup stopped: the batcher closed")
        return done
    log.info("warmed %d of %d batches in %.3f s", done, total,
             time.perf_counter() - t0)
    return done
