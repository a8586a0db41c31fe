"""The plain reference of a served image: the benchmark's own copy of
the resize semantics, independent of the program under test.

fanlin (livesense-inc/fanlin-rs, src/handler.rs:229-255) resizes with
the `image` crate's Lanczos3 filter when both `w` and `h` are given and
differ from the source: an aspect-preserving fit, then, when the fit is
smaller than asked, a centred overlay on a canvas of the fill colour.
The `image` crate builds its sampling weights in f32; they are built
here the same way, and the products are summed in float64 with plain
torch operations. The result is rounded half up after clamping to
[0, 255] and encoded as the server encodes a JPEG (quality from the
query, 4:2:0).

Only the query keys the benchmark's traffic uses are supported (`w`,
`h`, `quality`); any other key raises, so a mix that needs more fails
loudly instead of being compared against the wrong image.
"""

from __future__ import annotations

import dataclasses
import io
import math
from functools import lru_cache
from typing import Tuple
from urllib.parse import parse_qsl

import numpy as np

DEFAULT_QUALITY = 75
DEFAULT_FILL = (32, 32, 32)  # fanlin's default canvas colour
LANCZOS_SUPPORT = 3.0
_KEYS = {"w", "h", "quality"}


def _lanczos3(x: np.ndarray) -> np.ndarray:
    with np.errstate(invalid="ignore", divide="ignore"):
        px = np.pi * x
        s1 = np.where(x == 0.0, 1.0, np.sin(px) / px)
        px3 = px / 3.0
        s2 = np.where(x == 0.0, 1.0, np.sin(px3) / px3)
    return np.where(np.abs(x) < 3.0, s1 * s2, 0.0).astype(np.float32)


@lru_cache(maxsize=64)
def lanczos_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) f32 Lanczos3 weights with the `image` crate's sampling:
    the window of output x is centred at (x + 0.5) * src / dst, its
    support scaled by the ratio when shrinking, clipped to the source,
    and its weights normalised to sum 1. A same-size resample is the
    identity. The array is shared: do not write to it."""
    if src == dst:
        return np.eye(src, dtype=np.float32)
    w = np.zeros((dst, src), dtype=np.float32)
    ratio = np.float32(src) / np.float32(dst)
    sratio = max(ratio, np.float32(1.0))
    support = np.float32(LANCZOS_SUPPORT) * sratio
    outx = np.arange(dst, dtype=np.float32)
    center = (outx + np.float32(0.5)) * ratio
    left = np.clip(np.floor(center - support).astype(np.int64), 0, src - 1)
    right = np.clip(np.ceil(center + support).astype(np.int64), left + 1, src)
    inputx = center - np.float32(0.5)
    for o in range(dst):
        taps = np.arange(left[o], right[o], dtype=np.float32)
        ws = _lanczos3((taps - inputx[o]) / sratio)
        w[o, left[o]:right[o]] = ws / np.float32(ws.sum(dtype=np.float32))
    return w


def fit(src_w: int, src_h: int, w: int, h: int) -> Tuple[int, int]:
    """The `image` crate's resize_dimensions without fill: the smaller
    of the two ratios, rounded half away from zero, at least 1."""
    ratio = min(w / src_w, h / src_h)
    return (max(int(math.floor(src_w * ratio + 0.5)), 1),
            max(int(math.floor(src_h * ratio + 0.5)), 1))


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Where the resized source lands: the output is out_w x out_h; the
    resized source, rw x rh, sits at (x0, y0) on a canvas of `fill`
    when `canvas`."""

    src_w: int
    src_h: int
    out_w: int
    out_h: int
    rw: int
    rh: int
    x0: int
    y0: int
    canvas: bool
    quality: int
    fill: Tuple[int, int, int] = DEFAULT_FILL

    def weights(self) -> Tuple[np.ndarray, np.ndarray]:
        """(av, ah): (out_h, src_h) and (out_w, src_w) f32, the resized
        rows and columns placed where the canvas puts them, zero
        elsewhere."""
        av = np.zeros((self.out_h, self.src_h), np.float32)
        av[self.y0:self.y0 + self.rh] = lanczos_weights(self.src_h, self.rh)
        ah = np.zeros((self.out_w, self.src_w), np.float32)
        ah[self.x0:self.x0 + self.rw] = lanczos_weights(self.src_w, self.rw)
        return av, ah


def geometry(src_w: int, src_h: int, query: str) -> Geometry:
    params = dict(parse_qsl(query, keep_blank_values=True))
    unknown = set(params) - _KEYS
    if unknown:
        raise ValueError(f"the reference does not implement {sorted(unknown)}")
    quality = min(max(int(params.get("quality", DEFAULT_QUALITY)), 1), 100)
    if "w" not in params or "h" not in params:
        return Geometry(src_w, src_h, src_w, src_h, src_w, src_h, 0, 0,
                        False, quality)
    w, h = int(params["w"]), int(params["h"])
    if (w, h) == (src_w, src_h):
        return Geometry(src_w, src_h, w, h, w, h, 0, 0, False, quality)
    rw, rh = fit(src_w, src_h, w, h)
    if w > rw or h > rh:
        return Geometry(src_w, src_h, w, h, rw, rh, abs(w - rw) // 2,
                        abs(h - rh) // 2, True, quality)
    return Geometry(src_w, src_h, rw, rh, rw, rh, 0, 0, False, quality)


def decode_rgb(data: bytes) -> np.ndarray:
    """(H, W, 3) u8: a JPEG decoded by PIL (libjpeg's integer iDCT and
    fancy upsampling, its defaults)."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def encode_jpeg(rgb: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb, "RGB").save(buf, format="JPEG", quality=quality,
                                     subsampling=2)
    return buf.getvalue()


def source_planes(src: np.ndarray, device, dtype=None):
    """(3, H, W) float64 (or `dtype`) planes of an (H, W, 3) u8 image on
    `device`, made once for all the queries of a source."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(src.transpose(2, 0, 1)))
    return t.to(device=device).to(dtype or torch.float64)


def resample(planes, geo: Geometry) -> np.ndarray:
    """(out_h, out_w, 3) u8: the source `planes` (source_planes) resized
    as `geo` says, in their dtype on their device, one plane at a
    time."""
    import torch

    dtype, device = planes.dtype, planes.device
    av, ah = (torch.from_numpy(m).to(device=device, dtype=dtype)
              for m in geo.weights())
    out = np.empty((geo.out_h, geo.out_w, 3), np.uint8)
    inside = torch.zeros((geo.out_h, geo.out_w), dtype=torch.bool,
                         device=device)
    inside[geo.y0:geo.y0 + geo.rh, geo.x0:geo.x0 + geo.rw] = True
    for c in range(3):
        f = (av @ planes[c]) @ ah.T
        f = torch.floor(torch.clamp(f, 0.0, 255.0) + 0.5)
        f = torch.where(inside, f, torch.full_like(f, geo.fill[c]))
        out[:, :, c] = f.to(torch.uint8).cpu().numpy()
    return out


def reference_image(planes, query: str) -> np.ndarray:
    """The decoded pixels of the JPEG the reference chain serves for
    `query` on a source's `planes` (source_planes)."""
    h, w = planes.shape[1:]
    geo = geometry(w, h, query)
    return decode_rgb(encode_jpeg(resample(planes, geo), geo.quality))
