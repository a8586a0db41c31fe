"""Minimal PNG bitstream writer for device-filtered scanlines.

The device PNG front-end (ops.fused._png_tail) performs the adaptive
per-row filter selection; the host's remaining work is zlib (stdlib —
C, releases the GIL) plus chunk framing here. The compression-level
tiers mirror the reference's quality mapping
(reference src/handler.rs:264-273): q<50 Best, q<85 Default, else
Fast; filtering is Adaptive like the image crate's
FilterType::Adaptive.

Carried over from fanlin_tpu/engine/png_writer.py: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# PNG color types by channel count (8-bit depth)
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def level_for_quality(quality: int) -> int:
    """reference handler.rs:264-273 tier mapping (zlib levels)."""
    if quality < 50:
        return 9   # CompressionType::Best
    if quality < 85:
        return 6   # Default
    return 1       # Fast


def _libdeflate_level(quality: int) -> int:
    """libdeflate levels (1-12) for the same tiers: a deep search for
    Best, low levels for Default and Fast (filtered photographic rows
    compress nearly as well at low libdeflate levels)."""
    if quality < 50:
        return 9
    if quality < 85:
        return 2
    return 1


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def write_png(rows: np.ndarray, w: int, h: int, nch: int,
              quality: int) -> bytes:
    """(H, 1 + W*nch) uint8 filtered scanlines -> a complete PNG."""
    assert rows.shape == (h, 1 + w * nch), (rows.shape, w, h, nch)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[nch], 0, 0, 0)
    payload = np.ascontiguousarray(rows).tobytes()
    from . import native_codecs

    idat = native_codecs.deflate_zlib(payload, _libdeflate_level(quality))
    if idat is None:
        # stdlib fallback; Z_FILTERED is the deflate strategy tuned
        # for filter-predicted byte streams (what libpng uses)
        co = zlib.compressobj(level_for_quality(quality), zlib.DEFLATED,
                              15, 8, zlib.Z_FILTERED)
        idat = co.compress(payload) + co.flush()
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", idat) + _chunk(b"IEND", b""))
