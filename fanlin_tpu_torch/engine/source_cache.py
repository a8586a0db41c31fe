"""Decoded-source cache (`tpu.source_cache_mb`).

Port of fanlin_tpu/engine/source_cache.py. CDN-miss traffic for one
image commonly arrives as several variants (srcset widths,
quality/format splits) within seconds; the reference re-decodes the
source bytes for every one of them (handler.rs:185-309). A
byte-budgeted LRU of DECODED sources (coefficient metas and pixel
arrays, keyed by a content hash) makes every variant of a hot source
after the first skip the host decode. Additive over the reference, like
`response_cache_mb`; 0 = off, the parity default.

Sharing discipline (why handing one decode to many requests is safe):

* Coefficient metas are never mutated downstream: `orient_meta` returns
  a new dict, the assemblies only read them, and the Engine attaches a
  CMYK LUT to a copy (`Engine._try_cmyk_coef`). EXIF-oriented sources
  are cached after the rotation (the Engine's kind string carries the
  orientation), so the rotation runs once per hot source.
* Pixel entries are copied on BOTH sides of the cache (a ~0.1 ms memcpy
  against the multi-ms decode) and stored read-only: the stored array
  can never alias bytes a caller later writes, and a hit can never leak
  writes back.

The JAX package also seeds each meta's `_nc_counts` memo (its nested-
corner upload rung); the port has no nc rung, so there is no memo.

In worker mode (`tpu.workers`) each gateway process holds its own
cache, as in the JAX package: N workers hold up to N x source_cache_mb.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

import numpy as np

from ..utils.bytelru import ByteLRU


def content_key(data: bytes) -> bytes:
    """16-byte content hash of the source bytes (blake2b, ~1 GB/s)."""
    return hashlib.blake2b(data, digest_size=16).digest()


# Charged per entry on top of array bytes: the key tuple, the digest,
# the dict and LRU-node overhead. Without it a 0-array entry (the
# `_pixel_only` sentinel cached for non-grid-exact rotations) prices at
# 0 bytes, and ByteLRU only evicts while over its byte budget, so a
# crawl of distinct such sources would grow the table without bound.
_ENTRY_OVERHEAD = 512


def _meta_nbytes(meta: dict) -> int:
    return _ENTRY_OVERHEAD + sum(
        v.nbytes for v in meta.values() if isinstance(v, np.ndarray)
    )


class SourceCache:
    """Byte-budgeted cache of decode results, shared across requests
    and threads (ByteLRU locks internally)."""

    def __init__(self, max_mb: int):
        self._lru = ByteLRU(max_bytes=int(max_mb) * 1024 * 1024)

    # -- coefficient metas (read_jpeg_coeffs / read_jpeg_coeffs4) ----------

    def get_meta(self, kind: str, key: bytes) -> Optional[dict]:
        return self._lru.get((kind, key))

    def put_meta(self, kind: str, key: bytes, meta: dict) -> None:
        self._lru.put((kind, key), meta, _meta_nbytes(meta))

    # -- pixel decodes (codecs.decode / the host ICC transform) ------------

    def get_pixels(
        self, kind: str, key: bytes
    ) -> Optional[Tuple[np.ndarray, bool, bool]]:
        hit = self._lru.get((kind, key))
        if hit is None:
            return None
        img, has_alpha, is_gray = hit
        return img.copy(), has_alpha, is_gray

    def put_pixels(self, kind: str, key: bytes, img: np.ndarray,
                   has_alpha: bool, is_gray: bool) -> None:
        stored = np.array(img, order="C")  # one C-ordered copy
        stored.setflags(write=False)
        self._lru.put((kind, key), (stored, has_alpha, is_gray),
                      stored.nbytes + _ENTRY_OVERHEAD)

    # -- animated-GIF frame sets (codecs.decode_gif_frames) ----------------

    def get_frames(self, key: bytes):
        hit = self._lru.get(("gif", key))
        if hit is None:
            return None
        return [f.copy() for f in hit]

    def put_frames(self, key: bytes, frames) -> None:
        stored = []
        for f in frames:
            c = np.array(f, order="C")
            c.setflags(write=False)
            stored.append(c)
        self._lru.put(("gif", key), tuple(stored),
                      sum(c.nbytes for c in stored) + _ENTRY_OVERHEAD)

    def stats(self) -> dict:
        return self._lru.stats()
