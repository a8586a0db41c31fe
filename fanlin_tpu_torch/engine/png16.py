"""Raw 16-bit PNG decode.

PIL reads 16-bit color PNGs through high-byte raw modes (``RGB;16B``
keeps only the most significant byte of each sample), where the image
crate decodes Rgb16/Rgba16/LumaA16 and converts to u8 with the
round(v*255/65535) scaling (reference handler.rs:185's DynamicImage
conversions; same policy as PARITY.md known-diff #11's Luma16 rows).
This reader closes that last <=1 LSB gap by decoding the container
directly: chunk walk with CRC checks, one bounded zlib inflate,
scanline unfilter (native fc_png_unfilter when the C core is built --
the per-byte Paeth recurrence can't vectorize in numpy, and a
gate-passing RGB16 source is up to 256M samples -- with a pure-numpy
fallback), and the shared slabbed u16->u8 scaler.

Covers bit-depth-16 color types 0/2/4/6, Adam7 interlace, and the
16-bit tRNS transparency key (the crate expands tRNS to an alpha
plane; PIL's RGB path drops it). Everything else -- 8-bit depths,
palette -- stays on the PIL path in codecs.decode, and any container
or stream damage raises Png16Error so codecs falls back to PIL, whose
damage tolerance defines the pinned corrupt-input statuses.
"""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np

from .codecs import MAX_DECODE_ALLOC, CodecError


class Png16Error(Exception):
    """Container/stream damage; the caller falls back to PIL."""


# color type -> channel count (bit depth 16 legal for these four;
# type 3 palette is 8-bit indices and never reaches this reader)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}

# Adam7 pass origins/strides: (x0, y0, dx, dy)
_ADAM7 = (
    (0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
    (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2),
)


def is_png16(data: bytes) -> bool:
    """True when the IHDR declares a 16-bit image this reader covers."""
    if len(data) < 34 or data[:8] != b"\x89PNG\r\n\x1a\n":
        return False
    if data[8:16] != b"\x00\x00\x00\x0dIHDR":
        return False
    return data[24] == 16 and data[25] in _CHANNELS


def _chunks(data: bytes):
    """Walk chunks, verifying CRC on the ones we consume (the png
    crate errors on CRC damage; PIL does too, so a Png16Error here and
    the PIL fallback agree on the status)."""
    pos = 8
    n = len(data)
    while pos + 12 <= n:
        ln = int.from_bytes(data[pos:pos + 4], "big")
        typ = data[pos + 4:pos + 8]
        end = pos + 8 + ln
        if ln > n or end + 4 > n:
            raise Png16Error("truncated chunk")
        body = data[pos + 8:end]
        if typ in (b"IHDR", b"IDAT", b"tRNS"):
            crc = int.from_bytes(data[end:end + 4], "big")
            if zlib.crc32(typ + body) & 0xFFFFFFFF != crc:
                raise Png16Error(f"crc mismatch in {typ!r}")
        yield typ, body
        if typ == b"IEND":
            return
        pos = end + 4
    raise Png16Error("no IEND")


def _unfilter(raw: bytes, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """(h, rowbytes) reconstructed filter output; native when built."""
    from . import native_codecs

    out = native_codecs.png_unfilter(raw, h, rowbytes, bpp)
    if out is not None:
        return out
    return _unfilter_py(raw, h, rowbytes, bpp)


# the per-byte Average/Paeth recurrence runs ~1.1 MB/s in python;
# past this an unbuilt/old native core falls back to PIL's fast
# high-byte read instead of burning seconds of GIL inside a request
# (<=1 LSB precision cost — the same bounded-mirror contract as
# tiff16's _PY_LZW_MAX / _PY_PACKBITS_MAX)
_PY_UNFILTER_MAX = 2 << 20


def _unfilter_py(raw: bytes, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Pure-numpy fallback. None/Sub/Up vectorize (Sub is a per-lane
    prefix sum mod 256); Average/Paeth are inherently sequential and
    loop per byte -- correctness path only, the native core carries
    the hot case (and anything big when that core is missing falls
    back to PIL instead of riding this loop)."""
    if h * rowbytes > _PY_UNFILTER_MAX:
        raise Png16Error("stream too large for the python unfilter")
    out = np.empty((h, rowbytes), np.uint8)
    stride = 1 + rowbytes
    prev: Optional[np.ndarray] = None
    for y in range(h):
        base = y * stride
        ft = raw[base]
        line = np.frombuffer(raw, np.uint8, rowbytes, base + 1)
        row = out[y]
        if ft == 0:
            row[:] = line
        elif ft == 1:  # Sub
            for o in range(bpp):
                lane = line[o::bpp].astype(np.int64).cumsum()
                row[o::bpp] = (lane & 255).astype(np.uint8)
        elif ft == 2:  # Up
            row[:] = line + prev if prev is not None else line
        elif ft == 3:  # Average
            for i in range(rowbytes):
                a = int(row[i - bpp]) if i >= bpp else 0
                b = int(prev[i]) if prev is not None else 0
                row[i] = (int(line[i]) + ((a + b) >> 1)) & 255
        elif ft == 4:  # Paeth
            for i in range(rowbytes):
                a = int(row[i - bpp]) if i >= bpp else 0
                b = int(prev[i]) if prev is not None else 0
                c = int(prev[i - bpp]) if prev is not None and i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row[i] = (int(line[i]) + pred) & 255
        else:
            raise Png16Error(f"bad filter type {ft}")
        prev = row
    return out


def decode_png16(data: bytes) -> Tuple[np.ndarray, bool, bool]:
    """16-bit PNG -> ((H, W, 3|4) u8, has_alpha, is_gray), the same
    contract as codecs.decode. Raises CodecError past the 512 MiB
    decode-buffer gate (metering the real 2 B/sample buffer, like the
    crate's Limits::default()), Png16Error on damage."""
    ihdr = None
    idat = []
    trns: Optional[bytes] = None
    for typ, body in _chunks(data):
        if typ == b"IHDR":
            ihdr = body
        elif typ == b"IDAT":
            idat.append(body)
        elif typ == b"tRNS":
            trns = body
    if ihdr is None or len(ihdr) != 13 or not idat:
        raise Png16Error("missing IHDR/IDAT")
    w = int.from_bytes(ihdr[0:4], "big")
    h = int.from_bytes(ihdr[4:8], "big")
    depth, ctype, comp, filt, interlace = ihdr[8:13]
    if depth != 16 or ctype not in _CHANNELS:
        raise Png16Error("not a 16-bit image")
    if comp != 0 or filt != 0 or interlace not in (0, 1):
        raise Png16Error("bad IHDR methods")
    if w <= 0 or h <= 0:
        raise Png16Error("zero-dimension image")
    ch = _CHANNELS[ctype]
    if w * h * ch * 2 > MAX_DECODE_ALLOC:
        raise CodecError(
            f"image decode allocation {w}x{h} 16-bit/{ch}ch exceeds "
            f"the 512 MiB limit"
        )
    bpp = ch * 2

    if interlace == 0:
        passes = [(0, 0, 1, 1, w, h)]
    else:
        passes = []
        for x0, y0, dx, dy in _ADAM7:
            pw = (w - x0 + dx - 1) // dx
            ph = (h - y0 + dy - 1) // dy
            if pw > 0 and ph > 0:
                passes.append((x0, y0, dx, dy, pw, ph))
    expected = sum(ph * (1 + pw * bpp) for *_xy, pw, ph in passes)

    try:
        raw = zlib.decompressobj().decompress(b"".join(idat), expected)
    except zlib.error as e:
        raise Png16Error(f"bad IDAT stream: {e}") from e
    if len(raw) < expected:
        raise Png16Error("truncated IDAT stream")

    if interlace == 0:
        flat = _unfilter(raw, h, w * bpp, bpp)
        a16 = flat.view(">u2").reshape(h, w, ch)
    else:
        a16 = np.empty((h, w, ch), dtype=">u2")
        pos = 0
        for x0, y0, dx, dy, pw, ph in passes:
            take = ph * (1 + pw * bpp)
            flat = _unfilter(raw[pos:pos + take], ph, pw * bpp, bpp)
            pos += take
            a16[y0::dy, x0::dx] = flat.view(">u2").reshape(ph, pw, ch)

    from .extra_codecs import _scale_to_u8

    u8 = _scale_to_u8(np.ravel(a16), 65535).reshape(a16.shape)

    if ctype == 0:
        rgb = np.repeat(u8, 3, axis=2)
        if trns is not None:
            if len(trns) != 2:
                raise Png16Error("bad tRNS length")
            key = int.from_bytes(trns, "big")
            alpha = np.where(a16[:, :, 0] == key, 0, 255).astype(np.uint8)
            return (np.ascontiguousarray(
                np.concatenate([rgb, alpha[:, :, None]], axis=2)),
                True, True)
        return np.ascontiguousarray(rgb), False, True
    if ctype == 2:
        if trns is not None:
            if len(trns) != 6:
                raise Png16Error("bad tRNS length")
            key = np.frombuffer(trns, ">u2")
            alpha = np.where((a16 == key).all(axis=2), 0, 255).astype(
                np.uint8)
            return (np.ascontiguousarray(
                np.concatenate([u8, alpha[:, :, None]], axis=2)),
                True, False)
        return np.ascontiguousarray(u8), False, False
    if ctype == 4:
        y = u8[:, :, :1]
        return (np.ascontiguousarray(
            np.concatenate([y, y, y, u8[:, :, 1:]], axis=2)),
            True, True)
    return np.ascontiguousarray(u8), True, False  # ctype 6: RGBA
