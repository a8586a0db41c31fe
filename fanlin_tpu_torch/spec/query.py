"""Request-spec query parameters.

Re-implements the semantics of the reference's query type
(reference src/query.rs:3-94) including its quirks:

* ``dimensions()`` is only Some when BOTH w and h are present
  (src/query.rs:28-33) — a lone w or h never triggers a resize.
* ``fill_color()`` parses "r,g,b"; any malformed component falls back to
  32 per-component, wrong arity falls back to (32,32,32)
  (src/query.rs:35-49).
* ``blur()``: when the parameter is present the sigma is
  ``clamp(v, 10.0, 20.0)`` — so blur=1 means sigma 10.0 — and 0.0 when
  absent (src/query.rs:59-62).
* ``as_is()`` is True when there are no dims, no blur, no
  grayscale/inverse/avif/webp; quality, crop and rgb alone do NOT
  trigger processing (src/query.rs:80-87).
* ``unsupported_scale_size()``: missing w/h default to 100; w must be
  in 20..=2000 and h in 20..=1000 (src/query.rs:17-21, 89-93).

Parsing is strict in the same way serde_urlencoded is strict
(axum rejects with 400 on a type error; reference tests
src/query.rs:130-136, 187-193): integers must parse and fit their
integer width, booleans must be exactly "true"/"false".
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple
from urllib.parse import parse_qsl

DEFAULT_COLOR = 32
DEFAULT_QUALITY = 75
DEFAULT_BLUR_SIGMA = 0.0
WIDTH_RANGE = (20, 2000)
HEIGHT_RANGE = (20, 1000)

_U32_MAX = 2**32 - 1
_U8_MAX = 255


def size_range_info() -> str:
    # Mirrors the Rust Debug formatting of RangeInclusive (src/query.rs:23-25).
    return (
        f"{WIDTH_RANGE[0]}..={WIDTH_RANGE[1]} x {HEIGHT_RANGE[0]}..={HEIGHT_RANGE[1]}"
    )


class QueryError(ValueError):
    """Raised when the query string fails strict deserialization (-> HTTP 400)."""


def _parse_uint(name: str, text: str, max_value: int) -> int:
    t = text
    if t.startswith("+"):
        t = t[1:]
    if not t or not t.isascii() or not t.isdigit():
        raise QueryError(f"invalid digit found in `{name}`")
    v = int(t)
    if v > max_value:
        raise QueryError(f"`{name}` out of range")
    return v


def _parse_bool(name: str, text: str) -> bool:
    if text == "true":
        return True
    if text == "false":
        return False
    raise QueryError(f"`{name}` must be `true` or `false`")


@dataclasses.dataclass(frozen=True)
class Query:
    w: Optional[int] = None
    h: Optional[int] = None
    rgb: Optional[str] = None
    quality_raw: Optional[int] = None
    crop: Optional[bool] = None
    blur_raw: Optional[int] = None
    grayscale_raw: Optional[bool] = None
    inverse_raw: Optional[bool] = None
    avif: Optional[bool] = None
    webp: Optional[bool] = None

    # -- accessors mirroring src/query.rs:27-93 --------------------------

    def dimensions(self) -> Optional[Tuple[int, int]]:
        if self.w is not None and self.h is not None:
            return (self.w, self.h)
        return None

    def fill_color(self) -> Tuple[int, int, int]:
        if self.rgb is None:
            return (DEFAULT_COLOR, DEFAULT_COLOR, DEFAULT_COLOR)
        parts = self.rgb.split(",")[:3]
        rgb = []
        for p in parts:
            try:
                v = int(p)
                if not (0 <= v <= _U8_MAX) or (p and not p.lstrip("+").isdigit()):
                    v = DEFAULT_COLOR
            except ValueError:
                v = DEFAULT_COLOR
            rgb.append(v)
        if len(rgb) != 3:
            return (DEFAULT_COLOR, DEFAULT_COLOR, DEFAULT_COLOR)
        return (rgb[0], rgb[1], rgb[2])

    def quality(self) -> int:
        return DEFAULT_QUALITY if self.quality_raw is None else self.quality_raw

    def cropping(self) -> bool:
        return bool(self.crop)

    def blur(self) -> float:
        if self.blur_raw is None:
            return DEFAULT_BLUR_SIGMA
        return min(max(float(self.blur_raw), 10.0), 20.0)

    def grayscale(self) -> bool:
        return bool(self.grayscale_raw)

    def inverse(self) -> bool:
        return bool(self.inverse_raw)

    def use_avif(self) -> bool:
        return bool(self.avif)

    def use_webp(self) -> bool:
        return bool(self.webp)

    def as_is(self) -> bool:
        return (
            self.dimensions() is None
            and self.blur() == DEFAULT_BLUR_SIGMA
            and not self.grayscale()
            and not self.inverse()
            and not self.use_avif()
            and not self.use_webp()
        )

    def unsupported_scale_size(self) -> bool:
        w = 100 if self.w is None else self.w
        h = 100 if self.h is None else self.h
        return not (WIDTH_RANGE[0] <= w <= WIDTH_RANGE[1]) or not (
            HEIGHT_RANGE[0] <= h <= HEIGHT_RANGE[1]
        )


def parse_query(query_string: str) -> Query:
    """Parse a raw query string into a Query, strictly.

    Raises QueryError on any type error, which the gateway maps to a
    400 response — same contract as axum's Query extractor over the
    reference struct (src/query.rs:3-15).
    """
    fields: dict = {}
    seen = set()
    for key, value in parse_qsl(query_string, keep_blank_values=True):
        if key in ("w", "h", "quality", "blur", "crop", "avif", "webp",
                   "grayscale", "inverse", "rgb"):
            # serde_urlencoded rejects duplicate struct fields -> 400
            if key in seen:
                raise QueryError(f"duplicate field `{key}`")
            seen.add(key)
        if key in ("w", "h"):
            fields[key] = _parse_uint(key, value, _U32_MAX)
        elif key in ("quality", "blur"):
            fields[key + "_raw"] = _parse_uint(key, value, _U8_MAX)
        elif key in ("crop", "avif", "webp"):
            fields[key] = _parse_bool(key, value)
        elif key in ("grayscale", "inverse"):
            fields[key + "_raw"] = _parse_bool(key, value)
        elif key == "rgb":
            fields[key] = value
        # unknown keys are ignored (serde's default behavior)
    return Query(**fields)
