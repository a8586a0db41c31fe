"""Raw 16-bit-per-sample TIFF decode (RGB/RGBA/LA/gray).

PIL reads 16-bit *color* TIFFs through high-byte raw modes
(``RGB;16L`` keeps only the most significant byte), where the image
crate's tiff decoder yields Rgb16/Rgba16 and converts to u8 with
round(v*255/65535) — the same class of gap engine/png16.py closed for
PNG (PARITY known-diff #11). This reader covers the layout matrix:
classic TIFF AND BigTIFF (version 43) containers, both byte orders,
first IFD, strip AND tile organization, chunky and planar (config 2)
sample layout, compressions none(1) / LZW(5, with the TIFF
early-change variant) / deflate(8, 32946) / packbits(32773),
horizontal-differencing + floating-point predictors(2, 3),
photometric 0/1/2, 1-4 samples per pixel, and u16 as well as f32
(the crate's Rgb32F class) sample formats. Anything else (other
compressions / sample formats, later IFDs) raises Tiff16Error and
the caller falls back to PIL's high-byte read — behavior never
regresses, only precision improves where the raw path applies.

16-bit *grayscale* TIFF was already exact through the PIL I;16
branch (codecs.decode); it stays there. This module handles spp>=2
(and gray sources it happens to receive are decoded identically).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from .codecs import MAX_DECODE_ALLOC, CodecError


class Tiff16Error(Exception):
    """Unsupported layout or stream damage; the caller falls back."""


_TAG_WIDTH = 256
_TAG_HEIGHT = 257
_TAG_BPS = 258
_TAG_COMPRESSION = 259
_TAG_PHOTOMETRIC = 262
_TAG_STRIP_OFFSETS = 273
_TAG_SPP = 277
_TAG_ROWS_PER_STRIP = 278
_TAG_STRIP_COUNTS = 279
_TAG_PLANAR = 284
_TAG_PREDICTOR = 317
_TAG_TILE_WIDTH = 322
_TAG_TILE_LENGTH = 323
_TAG_TILE_OFFSETS = 324
_TAG_TILE_COUNTS = 325
_TAG_SAMPLE_FORMAT = 339

# field type -> (numpy dtype code, size)
_TYPES = {1: ("u1", 1), 3: ("u2", 2), 4: ("u4", 4), 6: ("i1", 1),
          8: ("i2", 2), 9: ("i4", 4),
          # BigTIFF additions: LONG8 / SLONG8 / IFD8
          16: ("u8", 8), 17: ("i8", 8), 18: ("u8", 8)}

# only these tags are ever consulted; everything else is skipped
# UNREAD, so a hostile tag claiming millions of entries costs nothing
# (struct-unpacking every tag used to build multi-hundred-MB tuples of
# Python ints from a crafted ~64 MB file, before any decode gate ran)
_NEEDED_TAGS = frozenset((
    _TAG_WIDTH, _TAG_HEIGHT, _TAG_BPS, _TAG_COMPRESSION,
    _TAG_PHOTOMETRIC, _TAG_STRIP_OFFSETS, _TAG_SPP,
    _TAG_ROWS_PER_STRIP, _TAG_STRIP_COUNTS, _TAG_PLANAR,
    _TAG_PREDICTOR, _TAG_TILE_WIDTH, _TAG_TILE_LENGTH,
    _TAG_TILE_OFFSETS, _TAG_TILE_COUNTS, _TAG_SAMPLE_FORMAT,
))
# only the strip/tile tables may legitimately carry many values;
# scalar tags (dims, spp, compression, ...) are capped so crafted
# counts on them can't allocate either. BPS carries one entry per
# sample.
_WIDE_TAGS = frozenset((_TAG_STRIP_OFFSETS, _TAG_STRIP_COUNTS,
                        _TAG_TILE_OFFSETS, _TAG_TILE_COUNTS))
_SCALAR_MAX = 64
# Hard cap on strip/tile table length — and therefore on the
# per-chunk python loop below (the decode gate bounds BYTES, but a
# crafted 1-row-per-strip table drives up to 2^24 loop iterations of
# pure-python chunk assembly — ~45 s of GIL and GBs of tiny-ndarray
# overhead from a ~134 MB file — before any pixel math runs). Real
# writers target ~8 KB+ per strip, so gate-passing images sit far
# under this; anything over it falls back to PIL, whose libtiff walks
# the table at C speed (<=1 LSB precision cost, the standard
# fallback contract).
_CHUNK_MAX = 1 << 18


def _read_ifd(data: bytes, bo: str,
              big: bool = False) -> Dict[int, Tuple[int, ...]]:
    """First-IFD tag walk. big=True reads the BigTIFF (version 43)
    shape: 8-byte IFD offset at byte 8, u8 entry count, 20-byte
    entries with u8 value counts and 8 inline value bytes."""
    if len(data) < (16 if big else 8):
        raise Tiff16Error("short header")
    if big:
        off = struct.unpack(bo + "Q", data[8:16])[0]
        if off + 8 > len(data):
            raise Tiff16Error("bad IFD offset")
        n = struct.unpack(bo + "Q", data[off:off + 8])[0]
        pos = off + 8
        esize, inline = 20, 8
        head_fmt, off_fmt = bo + "HHQ", bo + "Q"
    else:
        off = struct.unpack(bo + "I", data[4:8])[0]
        if off + 2 > len(data):
            raise Tiff16Error("bad IFD offset")
        n = struct.unpack(bo + "H", data[off:off + 2])[0]
        pos = off + 2
        esize, inline = 12, 4
        head_fmt, off_fmt = bo + "HHI", bo + "I"
    head = esize - inline
    tags: Dict[int, Tuple[int, ...]] = {}
    if n > 1 << 16 or pos + esize * n > len(data):
        raise Tiff16Error("truncated IFD")
    for _ in range(n):
        tid, typ, cnt = struct.unpack(head_fmt, data[pos:pos + head])
        # cnt == 0 is treated as absent (indexing an empty value tuple
        # raised IndexError past the Tiff16Error fallback contract);
        # required-tag KeyErrors below become Tiff16Error -> PIL
        if (tid in _NEEDED_TAGS and typ in _TYPES
                and 0 < cnt <= (_CHUNK_MAX if tid in _WIDE_TAGS
                                else _SCALAR_MAX)):
            code, size = _TYPES[typ]
            total = size * cnt
            if total <= inline:
                raw = data[pos + head:pos + head + total]
            else:
                voff = struct.unpack(
                    off_fmt, data[pos + head:pos + esize])[0]
                if voff + total > len(data):
                    raise Tiff16Error("tag value out of range")
                raw = data[voff:voff + total]
            if cnt > _SCALAR_MAX:
                # strip tables: decode at C speed into an int64 array
                # (a struct-unpack tuple prices ~30 B per Python int);
                # int64 keeps the downstream gate/range math exact
                tags[tid] = np.frombuffer(raw, bo + code).astype(
                    np.int64)
            else:
                tags[tid] = tuple(
                    int(v) for v in np.frombuffer(raw, bo + code)
                )
        pos += esize
    return tags


def _container(data: bytes):
    """(byte order, is_bigtiff) or None when not a TIFF container we
    read (classic version 42, BigTIFF version 43 with 8-byte
    offsets)."""
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return ("<" if data[:2] == b"II" else ">"), False
    if data[:2] in (b"II", b"MM") and len(data) >= 16:
        bo = "<" if data[:2] == b"II" else ">"
        ver, osz, pad = struct.unpack(bo + "HHH", data[2:8])
        if ver == 43 and osz == 8 and pad == 0:
            return bo, True
    return None


def sniff16_parsed(data: bytes):
    """(byte order, is_bigtiff, first-IFD tags) when this is a TIFF
    (classic or BigTIFF) whose first IFD declares samples this reader
    covers and PIL mangles: 16-bit unsigned with spp >= 2 (PIL keeps
    only the high byte), or 32-bit IEEE float color (spp >= 3 — PIL
    cannot open float color at all, where the image crate decodes
    Rgb32F/Rgba32F, handler.rs:306). None otherwise; never raises.
    Layout support is checked later; this gate only decides routing —
    a non-None here with an unsupported layout falls back to PIL
    inside decode_tiff16, which reuses this parse (the strip tables
    alone can be MBs; walking the IFD twice per request doubled the
    transient)."""
    con = _container(data)
    if con is None:
        return None
    bo, big = con
    try:
        tags = _read_ifd(data, bo, big)
    except Tiff16Error:
        return None
    bps = tags.get(_TAG_BPS, ())
    spp = tags.get(_TAG_SPP, (1,))[0]
    fmt = tags.get(_TAG_SAMPLE_FORMAT, (1,))
    if not bps:
        return None
    if all(b == 16 for b in bps) and all(f == 1 for f in fmt):
        return (bo, big, tags) if spp >= 2 else None
    if all(b == 32 for b in bps) and all(f == 3 for f in fmt):
        return (bo, big, tags) if spp >= 3 else None
    return None


def sniff16(data: bytes) -> bool:
    """Routing predicate form of sniff16_parsed."""
    return sniff16_parsed(data) is not None


# the python packbits loop iterates once per control byte (cost is
# bounded by the COMPRESSED strip size, unlike LZW's output-bound
# table walk); past this it falls back to PIL's fast high-byte read
# instead of burning seconds of GIL inside a request (<=1 LSB
# precision cost, same contract as _PY_LZW_MAX)
_PY_PACKBITS_MAX = 16 << 20


def _unpackbits(src: bytes, out_len: int) -> bytes:
    if len(src) > _PY_PACKBITS_MAX:
        raise Tiff16Error("packbits strip too large for the python loop")
    out = bytearray()
    i, n = 0, len(src)
    while i < n and len(out) < out_len:
        c = src[i]
        i += 1
        if c < 128:
            out += src[i:i + c + 1]
            i += c + 1
        elif c > 128:
            if i >= n:
                break
            out += src[i:i + 1] * (257 - c)
            i += 1
        # 128 = no-op
    if len(out) < out_len:
        raise Tiff16Error("short packbits stream")
    return bytes(out[:out_len])


# python-mirror LZW runs ~0.8 MB/s; past this strip size, an unbuilt
# native core falls back to PIL's fast high-byte read instead of
# burning seconds per strip (precision degrades <=1 LSB, never hangs)
_PY_LZW_MAX = 4 << 20


def _lzw(src: bytes, out_len: int) -> bytes:
    """Native fc_tiff_lzw when built (validated against the python
    mirror, which is pinned to real libtiff streams); bounded python
    mirror otherwise."""
    from . import native_codecs

    out = native_codecs.tiff_lzw(src, out_len)
    if out is not None:
        return out.tobytes()
    if out_len > _PY_LZW_MAX:
        raise Tiff16Error("lzw strip too large for the python mirror")
    return _lzw_decode(src, out_len)


def _lzw_decode(src: bytes, out_len: int) -> bytes:
    """TIFF LZW (msb-first, 9->12 bit codes, early change): the
    spec's decoder loop. Pure python — the validated mirror of
    fc_tiff_lzw; decode_tiff16 reaches it through _lzw."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: list = []

    def reset():
        nonlocal table, width, nxt
        table = [bytes([i]) for i in range(256)] + [b"", b""]
        width, nxt = 9, 258

    width, nxt = 9, 258
    reset()
    bitbuf = bitcnt = 0
    prev: Optional[bytes] = None
    i, n = 0, len(src)
    while len(out) < out_len:
        while bitcnt < width:
            if i >= n:
                raise Tiff16Error("short lzw stream")
            bitbuf = (bitbuf << 8) | src[i]
            i += 1
            bitcnt += 8
        code = (bitbuf >> (bitcnt - width)) & ((1 << width) - 1)
        bitcnt -= width
        if code == CLEAR:
            reset()
            prev = None
            continue
        if code == EOI:
            break
        if prev is None:
            if code >= len(table):
                raise Tiff16Error("bad lzw code")
            entry = table[code]
        elif code < nxt:
            entry = table[code]
            table.append(prev + entry[:1])
            nxt += 1
        elif code == nxt:
            entry = prev + prev[:1]
            table.append(entry)
            nxt += 1
        else:
            raise Tiff16Error("bad lzw code")
        out += entry
        prev = entry
        # early change: widen one code before the table fills
        if nxt + 1 >= (1 << width) and width < 12:
            width += 1
    if len(out) < out_len:
        raise Tiff16Error("short lzw stream")
    return bytes(out[:out_len])


def _chunk_u16(data: bytes, off: int, cnt: int, want: int, comp: int,
               bo: str, shape, dt: str = "u2",
               pred: int = 1) -> np.ndarray:
    """One strip/tile: slice, decompress to exactly `want` bytes,
    apply the predictor, view as `dt` samples with `shape`."""
    if off + cnt > len(data):
        raise Tiff16Error("strip out of range")
    raw = data[off:off + cnt]
    if comp == 1:
        if len(raw) < want:
            raise Tiff16Error("short strip")
        raw = raw[:want]
    elif comp in (8, 32946):
        try:
            raw = zlib.decompressobj().decompress(raw, want)
        except zlib.error as e:
            raise Tiff16Error(f"bad deflate strip: {e}") from e
        if len(raw) < want:
            raise Tiff16Error("short deflate strip")
    elif comp == 32773:
        raw = _unpackbits(raw, want)
    else:  # 5: LZW
        raw = _lzw(raw, want)
    if pred == 3:
        return _fp_undiff(raw, shape)
    out = np.frombuffer(raw, dtype=bo + dt).reshape(shape)
    if pred == 2:
        out = _undiff(out)
    return out


def _undiff(chunk: np.ndarray) -> np.ndarray:
    """Predictor 2: horizontal differencing per channel, mod 2^16
    (uint32 cumsum wraps mod 2^32; the final uint16 cast is the
    mod-2^16 view of it)."""
    return np.cumsum(
        chunk.astype(np.uint32), axis=1, dtype=np.uint32
    ).astype(np.uint16)


def _fp_undiff(raw: bytes, shape) -> np.ndarray:
    """Predictor 3 (TIFF TechNote 3, libtiff tif_predict.c fpAcc):
    each row's f32 samples travel as 4 byte planes in significance
    order (MSB plane first, regardless of container byte order),
    horizontally byte-differenced with stride = samples-per-pixel.
    Decode = byte cumsum mod 256 per lane, regather planes, read
    big-endian f32."""
    rows, w, cpp = shape
    rb = w * cpp * 4
    a = np.frombuffer(raw, np.uint8).reshape(rows, rb)
    # cumsum per byte lane (stride = cpp): lane k holds bytes
    # k, k+cpp, k+2*cpp, ... of the row
    acc = np.empty((rows, rb), np.uint8)
    for k in range(cpp):
        lane = a[:, k::cpp].astype(np.uint32).cumsum(
            axis=1, dtype=np.uint32)
        acc[:, k::cpp] = (lane & 255).astype(np.uint8)
    # regather: plane p (of 4, MSB first) is acc[:, p*w*cpp:(p+1)*w*cpp]
    planes = acc.reshape(rows, 4, w * cpp)
    be = np.empty((rows, w * cpp, 4), np.uint8)
    for p in range(4):
        be[:, :, p] = planes[:, p]
    return be.reshape(rows, -1).view(">f4").reshape(shape)


def _decode_strips(data, bo, w, h, spp, comp, pred, rps, offsets,
                   counts, ssz, dt) -> np.ndarray:
    """Chunky (planar=1) strips -> (h, w, spp) samples."""
    rowbytes = w * spp * ssz
    parts = []
    row = 0
    for off, cnt in zip(offsets, counts):
        if row >= h:
            break
        rows = min(rps, h - row)
        parts.append(_chunk_u16(data, off, cnt, rows * rowbytes, comp,
                                bo, (rows, w, spp), dt, pred))
        row += rows
    if row < h:
        raise Tiff16Error("missing strips")
    return np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]


def _decode_strips_planar(data, bo, w, h, spp, comp, pred, rps,
                          offsets, counts, ssz, dt) -> np.ndarray:
    """Planar (config 2) strips -> (h, w, spp) samples: each
    channel's strips are stored consecutively (TIFF6 §IFD
    PlanarConfiguration), one channel per strip, so the strip count
    is spp x strips-per-plane and the predictor differences within
    the single channel."""
    spl = (h + rps - 1) // rps
    if len(offsets) < spl * spp:
        raise Tiff16Error("planar strip table too short")
    planes = []
    for s in range(spp):
        parts = []
        row = 0
        for i in range(spl):
            rows = min(rps, h - row)
            off, cnt = offsets[s * spl + i], counts[s * spl + i]
            parts.append(_chunk_u16(data, off, cnt, rows * w * ssz,
                                    comp, bo, (rows, w, 1), dt, pred))
            row += rows
        planes.append(
            np.concatenate(parts, axis=0) if len(parts) > 1
            else parts[0]
        )
    return np.concatenate(planes, axis=2)


def _decode_tiles(data, tags, bo, w, h, spp, comp, planar, pred,
                  offsets, counts, ssz, dt) -> np.ndarray:
    """Tiled organization (TIFF6 §15) -> (h, w, spp) samples. Tiles
    are th x tw, edge tiles padded to full size, ordered left-to-
    right / top-to-bottom (then per channel plane when planar=2)."""
    try:
        tw = tags[_TAG_TILE_WIDTH][0]
        th = tags[_TAG_TILE_LENGTH][0]
    except KeyError as e:
        raise Tiff16Error(f"missing tile tag {e}") from e
    if tw <= 0 or th <= 0:
        raise Tiff16Error("bad tile geometry")
    across = (w + tw - 1) // tw
    down = (h + th - 1) // th
    # the padded assembly buffer is what actually allocates — gate it
    # (edge padding can exceed the w*h gate; hostile tw/th vastly so)
    if across * tw * down * th * spp * ssz > MAX_DECODE_ALLOC:
        raise CodecError(
            f"tiled decode allocation {across * tw}x{down * th} "
            f"{8 * ssz}-bit/{spp}ch exceeds the 512 MiB limit"
        )
    cpp = spp if planar == 1 else 1
    per_plane = across * down
    need = per_plane * (1 if planar == 1 else spp)
    if len(offsets) < need:
        raise Tiff16Error("tile table too short")
    pad = np.zeros((down * th, across * tw, spp),
                   np.uint16 if ssz == 2 else np.float32)
    want = th * tw * cpp * ssz
    for idx in range(need):
        plane, pos = divmod(idx, per_plane)
        ty, tx = divmod(pos, across)
        tile = _chunk_u16(data, offsets[idx], counts[idx], want, comp,
                          bo, (th, tw, cpp), dt, pred)
        dst = pad[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
        if planar == 1:
            dst[:] = tile
        else:
            dst[:, :, plane:plane + 1] = tile
    return pad[:h, :w]


def decode_tiff16(data: bytes, parsed=None) -> Tuple[np.ndarray, bool, bool]:
    """16-bit TIFF -> ((H, W, 3|4) u8, has_alpha, is_gray), the
    codecs.decode contract. CodecError past the 512 MiB gate,
    Tiff16Error on unsupported layout / damage (caller falls back).
    `parsed` is sniff16_parsed's result, reused so the routing sniff
    and the decode share one IFD walk."""
    if parsed is not None:
        bo, _big, tags = parsed
    else:
        con = _container(data)
        if con is None:
            raise Tiff16Error("not a TIFF container")
        bo, big = con
        tags = _read_ifd(data, bo, big)
    tiled = _TAG_TILE_WIDTH in tags
    try:
        w = tags[_TAG_WIDTH][0]
        h = tags[_TAG_HEIGHT][0]
        if tiled:
            offsets = tags[_TAG_TILE_OFFSETS]
            counts = tags[_TAG_TILE_COUNTS]
        else:
            offsets = tags[_TAG_STRIP_OFFSETS]
            counts = tags[_TAG_STRIP_COUNTS]
    except KeyError as e:
        raise Tiff16Error(f"missing tag {e}") from e
    spp = tags.get(_TAG_SPP, (1,))[0]
    comp = tags.get(_TAG_COMPRESSION, (1,))[0]
    photo = tags.get(_TAG_PHOTOMETRIC, (1,))[0]
    planar = tags.get(_TAG_PLANAR, (1,))[0]
    pred = tags.get(_TAG_PREDICTOR, (1,))[0]
    rps = tags.get(_TAG_ROWS_PER_STRIP, (h,))[0] or h
    bps = tags.get(_TAG_BPS, ())
    fmt = tags.get(_TAG_SAMPLE_FORMAT, (1,))
    if bps and all(b == 32 for b in bps) and all(f == 3 for f in fmt):
        is_float = True  # IEEE f32 (the crate's Rgb32F/Rgba32F class)
    elif bps and all(b == 16 for b in bps) and all(f == 1 for f in fmt):
        is_float = False
    else:
        raise Tiff16Error("unsupported sample layout")
    ssz, dt = (4, "f4") if is_float else (2, "u2")
    if planar not in (1, 2):
        raise Tiff16Error(f"planar config {planar}")
    if comp not in (1, 5, 8, 32946, 32773):
        raise Tiff16Error(f"compression {comp}")
    if photo not in (0, 1, 2) or (is_float and photo == 0):
        raise Tiff16Error(f"photometric {photo}")
    if pred not in ((1, 3) if is_float else (1, 2)):
        raise Tiff16Error(f"predictor {pred}")
    if not 1 <= spp <= 4:
        raise Tiff16Error(f"spp {spp}")
    if w <= 0 or h <= 0:
        raise Tiff16Error("zero-dimension image")
    if len(offsets) != len(counts) or len(offsets) == 0:
        raise Tiff16Error("strip table mismatch")
    if rps < 0 or bool(np.any(np.asarray(offsets) < 0)) or bool(
            np.any(np.asarray(counts) < 0)):
        # signed tag types (SLONG etc.) are legal containers; negative
        # values would slice from the buffer END below
        raise Tiff16Error("negative strip geometry")
    if w * h * spp * ssz > MAX_DECODE_ALLOC:
        raise CodecError(
            f"image decode allocation {w}x{h} {8 * ssz}-bit/{spp}ch "
            f"exceeds the 512 MiB limit"
        )

    if tiled:
        arr = _decode_tiles(data, tags, bo, w, h, spp, comp, planar,
                            pred, offsets, counts, ssz, dt)
    elif planar == 2:
        arr = _decode_strips_planar(data, bo, w, h, spp, comp, pred,
                                    rps, offsets, counts, ssz, dt)
    else:
        arr = _decode_strips(data, bo, w, h, spp, comp, pred, rps,
                             offsets, counts, ssz, dt)
    if is_float:
        # round(clamp(v, 0, 1) * 255): the image crate's Rgb32F ->
        # Rgb8 conversion (same mapping as the HDR/EXR float paths).
        # NaN -> 0 like Rust's saturating float->int cast; +-inf ride
        # the clamp.
        u8 = np.round(
            np.clip(np.nan_to_num(arr.astype(np.float32), nan=0.0),
                    0.0, 1.0) * 255.0
        ).astype(np.uint8)
    else:
        a16 = np.ascontiguousarray(arr.astype(np.uint16))
        if photo == 0:  # WhiteIsZero: invert the gray samples
            if spp == 1:
                a16 = (65535 - a16.astype(np.uint32)).astype(np.uint16)
            elif spp == 2:
                g = (65535 - a16[:, :, :1].astype(np.uint32)).astype(
                    np.uint16)
                a16 = np.concatenate([g, a16[:, :, 1:]], axis=2)

        from .extra_codecs import _scale_to_u8

        u8 = _scale_to_u8(np.ravel(a16), 65535).reshape(a16.shape)

    if spp == 1:
        return np.ascontiguousarray(np.repeat(u8, 3, axis=2)), False, True
    if spp == 2:
        y = u8[:, :, :1]
        return (np.ascontiguousarray(
            np.concatenate([y, y, y, u8[:, :, 1:]], axis=2)),
            True, True)
    if spp == 3:
        if photo != 2:
            raise Tiff16Error("3-sample non-RGB")
        return np.ascontiguousarray(u8), False, False
    if photo != 2:
        raise Tiff16Error("4-sample non-RGB")
    return np.ascontiguousarray(u8), True, False  # RGBA
