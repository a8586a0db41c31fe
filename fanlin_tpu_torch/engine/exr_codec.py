"""Minimal OpenEXR scanline codec (pure numpy).

Closes the last `image`-crate format row (reference handler.rs:306
processes EXR sources end to end — the crate decodes to Rgb32F, the
transform chain stays f32, and write_to(OpenExr) re-encodes; DDS by
contrast has no encoder in the crate, so DDS transforms 500 on BOTH
sides). Scope:

* decode: scanline (either line order) and tiled images including
  mip/ripmapped pyramids (level (0,0) is returned, the image crate's
  largest_resolution_level choice) and multi-part files (first
  RGB-carrying part, its first_valid_layer choice); compression
  NONE / RLE / ZIPS / ZIP (OpenEXR's byte reorder + delta predictor
  implemented here) / PIZ (bitmap LUT + 2D wavelet + canonical
  Huffman, ImfPizCompressor/ImfWav/ImfHuf re-implemented; entropy
  stage also in the native core) / PXR24 (delta-coded byte planes
  under zlib; FLOAT mantissas truncated to 24-bit by the WRITER, so
  reading is exact) / B44+B44A (fixed-rate 4x4 half blocks) / DWAA+DWAB (8x8 float
  DCT over a perceptual nonlinearity with Rec.709 CSC; both AC
  entropy variants; the reference's exr crate can NOT read these —
  this decoder goes beyond it). HALF, FLOAT and UINT channels (UINT
  converts by value, the crate's u32 -> f32 cast), R/G/B(/A) or
  luminance-style single channel. All
  decode paths are byte-exact against fixtures written by real
  libOpenEXR 3.1 (tests/golden/exr/, tools/make_exr_fixtures.cpp).
  Only deep data raises — which the reference's exr crate (1.73,
  its Cargo.lock) cannot decode either, so both sides error there.
* encode: ZIP-compressed HALF scanlines (the serving default;
  NONE/RLE/ZIPS/PXR24 selectable) — decodable everywhere, including
  the reference's exr crate.

Float -> u8 matches the image crate's Rgb32F -> Rgb8 conversion:
round(clamp(v, 0, 1) * 255); u8 -> float is v / 255. No transfer
curve is applied (the crate applies none either).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

MAGIC = b"\x76\x2f\x31\x01"

# compression enum (ImfCompression.h) and scanlines per chunk
_NONE, _RLE, _ZIPS, _ZIP, _PIZ, _PXR24 = 0, 1, 2, 3, 4, 5
_B44, _B44A, _DWAA, _DWAB = 6, 7, 8, 9
_BLOCK = {_NONE: 1, _RLE: 1, _ZIPS: 1, _ZIP: 16, _PIZ: 32, _PXR24: 16,
          _B44: 32, _B44A: 32, _DWAA: 32, _DWAB: 256}

_HALF, _FLOAT, _UINT = 1, 2, 0


class ExrError(ValueError):
    pass


# -- OpenEXR's zip predictor (ImfZip.cpp) -------------------------------------


def _zip_unfilter(data: bytes) -> bytes:
    """Inverse of OpenEXR's pre-zlib transform: integrate the delta
    predictor, then de-interleave the two halves."""
    t = np.frombuffer(data, np.uint8).astype(np.int32)
    if t.size:
        # t[i] += t[i-1] - 128 (cumulative)
        t = (np.cumsum(t - 128) + 128) % 256
    n = t.size
    h1 = t[: (n + 1) // 2]
    h2 = t[(n + 1) // 2 :]
    out = np.zeros(n, np.uint8)
    out[0::2] = h1.astype(np.uint8)
    out[1::2] = h2.astype(np.uint8)
    return out.tobytes()


def _zip_filter(data: bytes) -> bytes:
    """OpenEXR's pre-zlib transform (for the test-support compressor):
    interleave split, then delta-encode."""
    raw = np.frombuffer(data, np.uint8)
    n = raw.size
    tmp = np.concatenate([raw[0::2], raw[1::2]]).astype(np.int32)
    if n:
        d = np.empty(n, np.int32)
        d[0] = tmp[0]
        d[1:] = tmp[1:] - tmp[:-1] + 128
        tmp = d % 256
    return tmp.astype(np.uint8).tobytes()


# -- OpenEXR's RLE codec (ImfRle.cpp): byte runs over the SAME
# reorder+delta transform the zip family uses (ImfRleCompressor.cpp
# applies Zip's predictor before rleCompress) -------------------------------


def _rle_uncompress(src: bytes, max_out: int) -> bytes:
    """rleUncompress: control byte as signed char — negative = -n
    literal bytes follow, non-negative = next byte repeats n+1 times."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        i += 1
        if c > 127:  # signed char < 0: literal run
            cnt = 256 - c
            if i + cnt > n:
                raise ExrError("truncated exr rle literal")
            out += src[i : i + cnt]
            i += cnt
        else:
            if i >= n:
                raise ExrError("truncated exr rle run")
            out += src[i : i + 1] * (c + 1)
            i += 1
        if len(out) > max_out:
            raise ExrError("exr rle overrun")
    return bytes(out)


def _rle_compress(raw: bytes) -> bytes:
    """Valid-stream encoder (test support for the decode path); runs
    >= 3 bytes are emitted as repeats, bounded at 127 like ImfRle.cpp."""
    out = bytearray()
    i, n = 0, len(raw)
    while i < n:
        run = 1
        while i + run < n and raw[i + run] == raw[i] and run < 127:
            run += 1
        if run >= 3:
            out.append(run - 1)
            out.append(raw[i])
            i += run
            continue
        j = i
        while j < n and j - i < 127:
            if j + 2 < n and raw[j] == raw[j + 1] == raw[j + 2]:
                break
            j += 1
        out.append(256 - (j - i))
        out += raw[i:j]
        i = j
    return bytes(out)


# -- PXR24 (ImfPxr24Compressor.cpp): per row x channel, pixels are
# delta-coded integers split into big-endian byte planes, then the
# whole chunk rides zlib. HALF keeps its exact 16 bits; FLOAT is
# truncated to 24 bits (sign+exp+15 mantissa) BY THE WRITER — reading
# reconstructs bits<<8 exactly as ImfPxr24Compressor::uncompress ----------


def _pxr24_line_bytes(chans, w: int) -> int:
    # filtered bytes per value: HALF 2, FLOAT 3 (24-bit), UINT 4
    return sum(
        (2 if c[1] == _HALF else 3 if c[1] == _FLOAT else 4) * w
        for c in chans
    )


def _pxr24_expand(raw: bytes, chans, w: int, rows: int) -> dict:
    """Filtered pxr24 chunk bytes -> {channel: (rows, w) float32}."""
    out = {c[0]: np.zeros((rows, w), np.float32) for c in chans}
    u8 = np.frombuffer(raw, np.uint8)
    pos = 0
    for r in range(rows):
        for name, ptype, _xs, _ys in chans:
            if ptype == _HALF:
                b0 = u8[pos : pos + w].astype(np.uint32)
                b1 = u8[pos + w : pos + 2 * w]
                pos += 2 * w
                diffs = (b0 << 8) | b1
                bits = (np.cumsum(diffs, dtype=np.uint32) & 0xFFFF).astype(
                    np.uint16
                )
                out[name][r] = bits.view(np.float16).astype(np.float32)
            elif ptype == _FLOAT:  # 3 byte planes, 24-bit wraparound
                b0 = u8[pos : pos + w].astype(np.uint32)
                b1 = u8[pos + w : pos + 2 * w].astype(np.uint32)
                b2 = u8[pos + 2 * w : pos + 3 * w]
                pos += 3 * w
                diffs = (b0 << 16) | (b1 << 8) | b2
                vals = np.cumsum(diffs, dtype=np.uint32) & 0xFFFFFF
                out[name][r] = (vals << 8).view(np.float32)
            else:  # _UINT: 4 byte planes, full 32 bits, value semantics
                b = [u8[pos + j * w : pos + (j + 1) * w].astype(np.uint64)
                     for j in range(4)]
                pos += 4 * w
                diffs = (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]
                vals = np.cumsum(diffs, dtype=np.uint64) & 0xFFFFFFFF
                out[name][r] = vals.astype(np.float32)
    return out


def _pxr24_filter(half_rows: list) -> bytes:
    """[(rows in chlist order of (w,) '<f2' arrays)] -> filtered chunk
    bytes (encode test support; HALF channels only)."""
    parts = []
    for row in half_rows:
        bits = np.ascontiguousarray(row).view(np.uint16).astype(np.uint32)
        diffs = np.empty_like(bits)
        diffs[0] = bits[0]
        diffs[1:] = (bits[1:] - bits[:-1]) & 0xFFFF
        parts.append(((diffs >> 8) & 0xFF).astype(np.uint8).tobytes())
        parts.append((diffs & 0xFF).astype(np.uint8).tobytes())
    return b"".join(parts)


# -- PIZ (ImfPizCompressor.cpp): bitmap-packed LUT -> 2D Haar-style
# wavelet (ImfWav.cpp) -> canonical Huffman (ImfHuf.cpp). Decode-only;
# validated byte-exact against files written by real libOpenEXR
# (tests/golden/exr/*piz*). ----------------------------------------------------


def _huf_canonical_codes(lengths: np.ndarray):
    """Code-length table -> per-symbol code values (hufCanonicalCodeTable:
    codes assigned from the longest length down, increasing symbol order
    within a length)."""
    counts = np.bincount(lengths, minlength=59)
    base = np.zeros(59, np.int64)
    c = 0
    for ln in range(58, 0, -1):
        nc = (c + int(counts[ln])) >> 1
        base[ln] = c
        c = nc
    codes = np.zeros(lengths.size, np.int64)
    for ln in range(1, 59):
        syms = np.nonzero(lengths == ln)[0]
        if syms.size:
            codes[syms] = base[ln] + np.arange(syms.size)
    return codes


_NATIVE_HUF = True  # tests flip this to pin the pure-python decoder


def _huf_uncompress(src: bytes, n_out: int) -> np.ndarray:
    """OpenEXR's Huffman entropy coder (hufUncompress): 20-byte header
    (im, iM, tableLength, nBits, room), 6-bit-packed code-length table
    with zero-run escapes, then an MSB-first bitstream where the symbol
    iM is the 8-bit-count run-length escape. The native core carries
    the same decoder (fc_exr_huf, ~200x the per-symbol Python loop);
    this pure path is the validated reference and the fallback."""
    if n_out == 0:
        return np.zeros(0, np.uint16)
    if _NATIVE_HUF:
        from . import native_codecs

        got = native_codecs.exr_huf_uncompress(src, n_out)
        if got is not None:
            return got
    if len(src) < 20:
        raise ExrError("truncated exr huf header")
    im, iM, _tlen, nbits, _room = struct.unpack_from("<5i", src, 0)
    if not (0 <= im <= iM < 65537) or nbits < 0:
        raise ExrError("bad exr huf header")
    pos, c, lc = 20, 0, 0

    def getbits(n: int) -> int:
        nonlocal pos, c, lc
        while lc < n:
            if pos >= len(src):
                raise ExrError("truncated exr huf table")
            c = (c << 8) | src[pos]
            pos += 1
            lc += 8
        lc -= n
        return (c >> lc) & ((1 << n) - 1)

    lengths = np.zeros(iM + 1, np.int32)
    i = im
    while i <= iM:
        ln = getbits(6)
        if ln == 63:  # LONG_ZEROCODE_RUN
            zerun = getbits(8) + 6
            if i + zerun > iM + 1:
                raise ExrError("exr huf table overrun")
            i += zerun
        elif ln >= 59:  # SHORT_ZEROCODE_RUN
            zerun = ln - 59 + 2
            if i + zerun > iM + 1:
                raise ExrError("exr huf table overrun")
            i += zerun
        else:
            lengths[i] = ln
            i += 1
    codes = _huf_canonical_codes(lengths)

    # 14-bit fast decode table + dict for longer codes (hufBuildDecTable)
    DECBITS = 14
    fast_len = np.zeros(1 << DECBITS, np.uint8)
    fast_sym = np.zeros(1 << DECBITS, np.uint32)
    long_codes = {}
    for s in np.nonzero(lengths)[0]:
        ln = int(lengths[s])
        code = int(codes[s])
        if code >= 1 << ln:
            # non-Kraft table: the canonical counter overflowed its
            # length's code space
            raise ExrError("invalid exr huf code table")
        if ln <= DECBITS:
            start = code << (DECBITS - ln)
            span = 1 << (DECBITS - ln)
            if fast_len[start : start + span].any():
                raise ExrError("invalid exr huf code table")
            fast_len[start : start + span] = ln
            fast_sym[start : start + span] = s
        else:
            long_codes[(ln, code)] = int(s)

    # data bitstream starts at the next unread byte; residual table
    # bits are discarded (hufUnpackEncTable consumes whole bytes)
    data_start = pos
    nbytes = (nbits + 7) >> 3
    if data_start + nbytes > len(src):
        raise ExrError("truncated exr huf data")
    rlc = iM
    out = np.empty(n_out, np.uint16)
    oi = 0
    c, lc = 0, 0
    pos = data_start
    ie = data_start + nbytes

    def emit(sym: int) -> None:
        nonlocal oi, c, lc, pos
        if sym == rlc:
            while lc < 8:
                if pos >= ie:
                    raise ExrError("truncated exr huf run")
                c = (c << 8) | src[pos]
                pos += 1
                lc += 8
            lc -= 8
            cs = (c >> lc) & 0xFF
            if oi == 0 or oi + cs > n_out:
                raise ExrError("exr huf run overrun")
            out[oi : oi + cs] = out[oi - 1]
            oi += cs
        else:
            if oi >= n_out:
                raise ExrError("exr huf output overrun")
            out[oi] = sym
            oi += 1

    while pos < ie:
        c = (c << 8) | src[pos]
        pos += 1
        lc += 8
        while lc >= DECBITS:
            idx = (c >> (lc - DECBITS)) & ((1 << DECBITS) - 1)
            ln = int(fast_len[idx])
            if ln:
                lc -= ln
                emit(int(fast_sym[idx]))
            else:
                # >14-bit code: prefix-freedom means at most one
                # (length, code) can match, so scan lengths upward
                matched = False
                for ln2 in range(DECBITS + 1, 59):
                    while lc < ln2 and pos < ie:
                        c = (c << 8) | src[pos]
                        pos += 1
                        lc += 8
                    if lc < ln2:
                        break
                    sym = long_codes.get((ln2, (c >> (lc - ln2))
                                          & ((1 << ln2) - 1)))
                    if sym is not None:
                        lc -= ln2
                        emit(sym)
                        matched = True
                        break
                if not matched:
                    raise ExrError("invalid exr huf code")
    # trailing bits of the final partial byte (hufDecode's tail loop):
    # drop the zero padding from the bottom of the accumulator first
    pad = (8 - nbits) & 7
    c >>= pad
    lc -= pad
    while lc > 0:
        idx = (c << (DECBITS - lc)) & ((1 << DECBITS) - 1)
        ln = int(fast_len[idx])
        if ln and ln <= lc:
            lc -= ln
            emit(int(fast_sym[idx]))
        else:
            raise ExrError("invalid exr huf tail")
    if oi != n_out:
        raise ExrError("exr huf output short")
    return out


def _wdec14(lv: np.ndarray, hv: np.ndarray):
    """ImfWav.cpp wdec14 (exact int16 semantics), vectorized."""
    ls = lv.astype(np.int16).astype(np.int32)
    hs = hv.astype(np.int16).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    a16 = ai.astype(np.int16)
    b16 = (a16.astype(np.int32) - hs).astype(np.int16)
    return a16.view(np.uint16), b16.view(np.uint16)


def _wdec16(lv: np.ndarray, hv: np.ndarray):
    """ImfWav.cpp wdec16: mod-2^16 arithmetic with the A_OFFSET bias."""
    m = lv.astype(np.int32)
    d = hv.astype(np.int32)
    bb = (m - (d >> 1)) & 0xFFFF
    aa = (d + bb - 0x8000) & 0xFFFF
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav2_decode(buf: np.ndarray, base: int, nx: int, ox: int, ny: int,
                 oy: int, mx: int) -> None:
    """In-place 2D wavelet decode of one ushort slice (wav2Decode);
    vectorized over each level's block grid."""
    wdec = _wdec14 if mx < (1 << 14) else _wdec16
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        ys = np.arange(0, ny - p2 + 1, p2, dtype=np.int64)
        xs = np.arange(0, nx - p2 + 1, p2, dtype=np.int64)
        if ys.size and xs.size:
            i00 = (base + ys[:, None] * oy + xs[None, :] * ox).ravel()
            i01 = i00 + ox * p
            i10 = i00 + oy * p
            i11 = i10 + ox * p
            v00, v10 = wdec(buf[i00], buf[i10])
            v01, v11 = wdec(buf[i01], buf[i11])
            a, b = wdec(v00, v01)
            buf[i00], buf[i01] = a, b
            a, b = wdec(v10, v11)
            buf[i10], buf[i11] = a, b
        if (nx & p) and ys.size:  # odd column (vertical 1D pairs)
            i0 = base + ys * oy + xs.size * p2 * ox
            i1 = i0 + oy * p
            a, b = wdec(buf[i0], buf[i1])
            buf[i0], buf[i1] = a, b
        if (ny & p) and xs.size:  # odd line (horizontal 1D pairs)
            i0 = base + ys.size * p2 * oy + xs * ox
            i1 = i0 + ox * p
            a, b = wdec(buf[i0], buf[i1])
            buf[i0], buf[i1] = a, b
        p2 = p
        p >>= 1


def _piz_reverse_lut(bitmap: np.ndarray):
    """reverseLutFromBitmap: dense code -> ushort value (zero always
    implicitly present)."""
    bits = np.unpackbits(bitmap, bitorder="little")
    bits[0] = 1
    vals = np.nonzero(bits)[0].astype(np.uint16)
    lut = np.zeros(65536, np.uint16)
    lut[: vals.size] = vals
    return lut, vals.size - 1


def _piz_expand(payload: bytes, chans, w: int, rows: int) -> bytes:
    """One PIZ chunk -> raw scanline-layout bytes."""
    if len(payload) < 8:
        raise ExrError("truncated exr piz chunk")
    minnz, maxnz = struct.unpack_from("<HH", payload, 0)
    pos = 4
    if maxnz >= 8192:
        raise ExrError("bad exr piz bitmap range")
    bitmap = np.zeros(8192, np.uint8)
    if minnz <= maxnz:
        nb = maxnz - minnz + 1
        if pos + nb > len(payload):
            raise ExrError("truncated exr piz bitmap")
        bitmap[minnz : maxnz + 1] = np.frombuffer(payload, np.uint8, nb, pos)
        pos += nb
    lut, maxval = _piz_reverse_lut(bitmap)
    (length,) = struct.unpack_from("<i", payload, pos)
    pos += 4
    if length < 0 or pos + length > len(payload):
        raise ExrError("truncated exr piz data")
    sizes = [1 if c[1] == _HALF else 2 for c in chans]
    total = rows * w * sum(sizes)
    data = _huf_uncompress(payload[pos : pos + length], total)
    off = 0
    for sz in sizes:
        n = rows * w * sz
        for j in range(sz):
            _wav2_decode(data, off + j, w, sz, rows, w * sz, maxval)
        off += n
    data = lut[data]
    # planar channel blocks -> interleaved scanlines
    out = np.empty(total, np.uint16)
    pos_out = 0
    starts = np.cumsum([0] + [rows * w * s for s in sizes])
    for r in range(rows):
        for ci, sz in enumerate(sizes):
            n = w * sz
            src_off = starts[ci] + r * n
            out[pos_out : pos_out + n] = data[src_off : src_off + n]
            pos_out += n
    return out.astype("<u2").tobytes()


# -- B44 / B44A (ImfB44Compressor.cpp): fixed-rate 4x4 blocks of HALF
# data — 14 bytes each (16-bit base + 6-bit shift + 15 6-bit deltas in
# a column-then-row prediction chain); B44A adds 3-byte flat blocks
# (b[2] == 0xfc). Non-HALF channels ride the chunk verbatim. Lossy by
# design — the expected answer is what libOpenEXR reads back. ------------------


def _b44_undo_sign(t: np.ndarray) -> np.ndarray:
    """Invert pack()'s monotonic-order transform: sign bit set -> clear
    it, else bitwise-complement."""
    return np.where(t & 0x8000, t & 0x7FFF, ~t & 0xFFFF).astype(np.uint16)


def _b44_unpack14(blocks: np.ndarray) -> np.ndarray:
    """(n, 14) uint8 -> (n, 16) uint16 half bits (vectorized unpack14;
    mod-2^16 chain arithmetic)."""
    b = blocks.astype(np.uint32)
    shift = b[:, 2] >> 2
    bias = (np.uint32(0x20) << shift).astype(np.uint32)

    def fld(hi, lo, sh_hi, sh_lo):
        return ((b[:, hi] << sh_hi) | (b[:, lo] >> sh_lo)) & 0x3F

    d = [
        fld(2, 3, 4, 4), fld(3, 4, 2, 6), b[:, 4] & 0x3F,      # s4 s8 s12
        b[:, 5] >> 2, fld(5, 6, 4, 4), fld(6, 7, 2, 6),        # s1 s5 s9
        b[:, 7] & 0x3F,                                        # s13
        b[:, 8] >> 2, fld(8, 9, 4, 4), fld(9, 10, 2, 6),       # s2 s6 s10
        b[:, 10] & 0x3F,                                       # s14
        b[:, 11] >> 2, fld(11, 12, 4, 4), fld(12, 13, 2, 6),   # s3 s7 s11
        b[:, 13] & 0x3F,                                       # s15
    ]
    d = [(x << shift) - bias for x in d]
    s = np.zeros((b.shape[0], 16), np.uint32)
    s[:, 0] = (b[:, 0] << 8) | b[:, 1]
    s[:, 4] = s[:, 0] + d[0]
    s[:, 8] = s[:, 4] + d[1]
    s[:, 12] = s[:, 8] + d[2]
    s[:, 1] = s[:, 0] + d[3]
    s[:, 5] = s[:, 4] + d[4]
    s[:, 9] = s[:, 8] + d[5]
    s[:, 13] = s[:, 12] + d[6]
    s[:, 2] = s[:, 1] + d[7]
    s[:, 6] = s[:, 5] + d[8]
    s[:, 10] = s[:, 9] + d[9]
    s[:, 14] = s[:, 13] + d[10]
    s[:, 3] = s[:, 2] + d[11]
    s[:, 7] = s[:, 6] + d[12]
    s[:, 11] = s[:, 10] + d[13]
    s[:, 15] = s[:, 14] + d[14]
    return _b44_undo_sign((s & 0xFFFF).astype(np.uint16))


def _b44_expand(payload: bytes, chans, w: int, rows: int) -> bytes:
    """One B44/B44A chunk -> raw scanline-layout bytes."""
    pos = 0
    planes = []  # per channel: (rows, w*units) uint16 rows
    for _name, ptype, _xs, _ys in chans:
        if ptype != _HALF:
            # UINT/FLOAT channels are stored verbatim (planar)
            nb = rows * w * 4
            if pos + nb > len(payload):
                raise ExrError("truncated exr b44 chunk")
            planes.append(
                np.frombuffer(payload, "<u2", rows * w * 2, pos)
                .reshape(rows, w * 2))
            pos += nb
            continue
        bx = (w + 3) // 4
        by = (rows + 3) // 4
        offs = np.empty(bx * by, np.int64)
        sizes14 = np.empty(bx * by, bool)
        for i in range(bx * by):
            if pos + 3 > len(payload):
                raise ExrError("truncated exr b44 chunk")
            flat = payload[pos + 2] == 0xFC
            offs[i] = pos
            sizes14[i] = not flat
            pos += 3 if flat else 14
        if pos > len(payload):
            raise ExrError("truncated exr b44 chunk")
        u8 = np.frombuffer(payload, np.uint8)
        svals = np.empty((bx * by, 16), np.uint16)
        full = np.nonzero(sizes14)[0]
        if full.size:
            idx = offs[full, None] + np.arange(14)
            svals[full] = _b44_unpack14(u8[idx])
        flat_ix = np.nonzero(~sizes14)[0]
        if flat_ix.size:
            base = (u8[offs[flat_ix]].astype(np.uint16) << 8) \
                | u8[offs[flat_ix] + 1]
            svals[flat_ix] = _b44_undo_sign(base)[:, None]
        # scatter 4x4 blocks (row-major) into the padded plane, then
        # crop edge padding
        grid = svals.reshape(by, bx, 4, 4)
        plane = grid.transpose(0, 2, 1, 3).reshape(by * 4, bx * 4)
        planes.append(np.ascontiguousarray(plane[:rows, :w]))
    # planar -> interleaved scanlines
    parts = []
    for r in range(rows):
        for plane in planes:
            parts.append(plane[r].astype("<u2").tobytes())
    return b"".join(parts)


# -- DWAA / DWAB (ImfDwaCompressor.cpp): channels classify into
# LOSSY_DCT (8x8 float DCT over a perceptual nonlinearity, optional
# Rec.709 CSC for R/G/B sets; DC plane zip'd, AC plane huf'd with a
# zero-run scheme), RLE (byte-planar + ImfRle + zlib) and UNKNOWN
# (zlib verbatim). Decode-only; the format was mapped empirically
# against real libOpenEXR output (the 11-int64 chunk header, the
# cstr+u16 rule table, planar DC order, the 63-slot AC walk all
# verified stream-exact) and the pixel path is validated against
# libOpenEXR's own read-back. DWA is lossy at ENCODE time; decoding
# stored coefficients is exact up to float rounding. --------------------------

_DWA_UNKNOWN, _DWA_LOSSY, _DWA_RLE = 0, 1, 2


def _dwa_tolinear():
    """DWA's sample-space nonlinearity inverse, as a half-bits ->
    half-bits table: |x| < 1 -> |x|^2.2, else e^(2.2(|x|-1)),
    sign-preserving (dwaLookups' generated table)."""
    bits = np.arange(65536, dtype=np.uint16)
    x = bits.view(np.float16).astype(np.float32)
    ax = np.abs(x)
    with np.errstate(invalid="ignore", over="ignore"):
        lin = np.where(ax < 1.0, ax ** 2.2,
                       np.exp(2.2 * (ax - 1.0), dtype=np.float32))
        # large halfs map to f16 inf by design — the cast may warn
        out = np.copysign(lin, x).astype(np.float16)
        out = np.where(np.isnan(x), x.astype(np.float16), out)
    return out.view(np.uint16)


_DWA_TOLINEAR = None


def _dwa_idct_mat():
    u = np.arange(8, dtype=np.float64)
    x = np.arange(8, dtype=np.float64)
    a = 0.5 * np.cos((2 * x[None, :] + 1) * u[:, None] * np.pi / 16.0)
    a[0] *= 1.0 / np.sqrt(2.0)
    return a.astype(np.float32)


_ZIGZAG = None


def _dwa_zigzag():
    order = np.zeros(64, np.int64)
    i = j = 0
    for k in range(64):
        order[k] = i * 8 + j
        if (i + j) % 2 == 0:  # moving up-right
            if j == 7:
                i += 1
            elif i == 0:
                j += 1
            else:
                i -= 1
                j += 1
        else:
            if i == 7:
                j += 1
            elif j == 0:
                i += 1
            else:
                i += 1
                j -= 1
    return order


def _dwa_unrle_ac(ac: np.ndarray, n_blocks: int) -> np.ndarray:
    """AC stream -> (n_blocks, 63) half-bits. Per block 63 zigzag
    slots: 0xff00 ends the block, 0xffNN skips NN zeros, anything
    else is a literal half."""
    out = np.zeros((n_blocks, 63), np.uint16)
    i, n = 0, ac.size
    for b in range(n_blocks):
        fill = 0
        while fill < 63:
            if i >= n:
                raise ExrError("truncated exr dwa ac stream")
            v = int(ac[i])
            i += 1
            if v == 0xFF00:
                break
            if (v >> 8) == 0xFF:
                fill += v & 0xFF
            else:
                out[b, fill] = v
                fill += 1
        if fill > 63:
            raise ExrError("corrupt exr dwa ac block")
    if i != n:
        raise ExrError("corrupt exr dwa ac stream")
    return out


def _dwa_lossy_planes(dc: np.ndarray, acb: np.ndarray, n_comp: int,
                      pw: int, ph: int):
    """Planar DC halfs + per-block ACs -> list of (ph, pw) float32
    planes (still in nonlinear space). Stream orders differ (verified
    against real libOpenEXR output): the DC stream is PLANAR per
    component, the AC stream INTERLEAVES components per block."""
    global _ZIGZAG
    if _ZIGZAG is None:
        _ZIGZAG = _dwa_zigzag()
    bx, by = pw // 8, ph // 8
    nb = bx * by
    a = _dwa_idct_mat()
    planes = []
    for c in range(n_comp):
        zig = np.zeros((nb, 64), np.uint16)
        zig[:, 0] = dc[c * nb : (c + 1) * nb]
        zig[:, 1:] = acb[c::n_comp]
        blocks = np.zeros((nb, 64), np.float32)
        blocks[:, _ZIGZAG] = zig.view(np.float16).astype(np.float32)
        f = blocks.reshape(nb, 8, 8)
        s = np.einsum("ux,buv,vy->bxy", a, f, a).astype(np.float32)
        plane = (s.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3)
                 .reshape(ph, pw))
        planes.append(plane)
    return planes


def _dwa_expand(payload: bytes, chans, w: int, rows: int) -> bytes:
    """One DWAA/DWAB chunk -> raw scanline-layout bytes."""
    global _DWA_TOLINEAR
    if len(payload) < 90:
        raise ExrError("truncated exr dwa chunk")
    (version, unk_unc, unk_cmp, ac_cmp, dc_cmp, rle_cmp, rle_unc,
     rle_raw, ac_cnt, dc_cnt, _ac_compression) = struct.unpack_from(
        "<11q", payload, 0)
    if version > 2:
        raise ExrError("unsupported exr dwa version")
    for v in (unk_unc, unk_cmp, ac_cmp, dc_cmp, rle_cmp, rle_unc,
              rle_raw, ac_cnt, dc_cnt):
        if v < 0:
            raise ExrError("bad exr dwa sizes")
    pos = 88
    rules = []
    if version >= 2:
        (rs,) = struct.unpack_from("<H", payload, pos)
        end = pos + rs
        q = pos + 2
        while q < end:
            e = payload.index(b"\0", q)
            name = payload[q:e].decode("latin-1")
            q = e + 1
            (v,) = struct.unpack_from("<H", payload, q)
            q += 2
            # cstr + u16: type<<8 | (cscIdx+1)<<4 | scheme<<2 | flags
            rules.append((name, (v >> 2) & 3, ((v >> 4) & 0xF) - 1,
                          (v >> 8) & 3))
        pos = end
    streams = {}
    for key, n in (("unknown", unk_cmp), ("ac", ac_cmp), ("dc", dc_cmp),
                   ("rle", rle_cmp)):
        if pos + n > len(payload):
            raise ExrError("truncated exr dwa chunk")
        streams[key] = payload[pos : pos + n]
        pos += n

    def classify(name: str, ptype: int):
        suffix = name.rsplit(".", 1)[-1]
        for rname, scheme, csc, rtype in rules:
            if ptype == rtype and (suffix == rname
                                   or suffix.lower() == rname.lower()):
                return scheme, csc
        return _DWA_UNKNOWN, -1

    schemes = [classify(c[0], c[1]) for c in chans]
    pw, ph = (w + 7) // 8 * 8, (rows + 7) // 8 * 8
    nb = (pw // 8) * (ph // 8)
    lossy = [i for i, s in enumerate(schemes) if s[0] == _DWA_LOSSY]
    if dc_cnt != nb * len(lossy):
        raise ExrError("exr dwa dc count mismatch")
    # ac_cnt sizes the entropy decoder's OUTPUT allocation and comes
    # straight from the chunk — bound it by the most a real packer can
    # emit (<= 63 AC + 1 EOB token per 8x8 block per lossy channel)
    # before np.empty sees it (the 512 MiB header gate can't help:
    # these counts are per chunk, not per image)
    if ac_cnt > nb * 64 * len(lossy):
        raise ExrError("exr dwa ac count mismatch")
    if not ac_cnt:
        ac = np.zeros(0, np.uint16)
    elif _ac_compression == 0:  # STATIC_HUFFMAN
        ac = _huf_uncompress(streams["ac"], ac_cnt)
    elif _ac_compression == 1:  # DEFLATE (small chunks, e.g. tiles)
        # bounded inflate, see _unpack_chunk's pxr24 branch
        raw = zlib.decompressobj().decompress(
            streams["ac"], ac_cnt * 2 + 1)
        if len(raw) != ac_cnt * 2:
            raise ExrError("exr dwa ac size mismatch")
        ac = np.frombuffer(raw, "<u2")
    else:
        raise ExrError("unsupported exr dwa ac compression")
    acb = _dwa_unrle_ac(ac, nb * len(lossy))
    # dc_cnt is exact-checked against geometry above; bound the
    # inflate to it so a deflate bomb can't allocate first
    dcraw = (_zip_unfilter(zlib.decompressobj().decompress(
        streams["dc"], dc_cnt * 2 + 1)) if dc_cmp else b"")
    if len(dcraw) != dc_cnt * 2:
        raise ExrError("exr dwa dc size mismatch")
    dc = np.frombuffer(dcraw, "<u2")

    # LOSSY planes decode in libOpenEXR's DECODER-UNIT order, not flat
    # channel order: each complete csc set (channels carrying csc
    # indices 0/1/2 under one name prefix) is ONE 3-component decoder,
    # every remaining LOSSY_DCT channel is a 1-component decoder, csc
    # sets first (by first-member channel index), then singles in
    # channel order. The AC and DC streams are consumed SEQUENTIALLY
    # per unit; within a unit the AC interleaves components per block
    # and the DC is planar per component (verified against real
    # libOpenEXR on R/G/B + a standalone lossy "BY" channel — a flat
    # interleave over all lossy channels decodes that file to
    # garbage). CSC units store (Y, BY, RY) in csc-index slots.
    csc_groups: dict = {}
    for i in lossy:
        if schemes[i][1] >= 0:
            name = chans[i][0]
            prefix = name.rsplit(".", 1)[0] if "." in name else ""
            csc_groups.setdefault(prefix, {})[schemes[i][1]] = i
    in_set: set = set()
    units = []
    for m in csc_groups.values():
        # a complete set means csc indices exactly {0, 1, 2} — crafted
        # rules can carry any 4-bit index (a {0, 1, 3} group would
        # KeyError below); incomplete/bogus sets decode as singles
        if sorted(m) == [0, 1, 2]:
            units.append((min(m.values()), [m[0], m[1], m[2]]))
            in_set.update(m.values())
    units.sort()
    unit_idxs = [idxs for _, idxs in units]
    unit_idxs += [[i] for i in lossy if i not in in_set]
    chan_plane = {}
    pos = 0  # consumed blocks, shared by the AC and DC streams
    for idxs in unit_idxs:
        k = len(idxs)
        planes_nl = _dwa_lossy_planes(
            dc[pos * nb : (pos + k) * nb],
            acb[pos * nb : (pos + k) * nb], k, pw, ph,
        )
        pos += k
        if k == 3:
            yy, by, ry = planes_nl
            chan_plane[idxs[0]] = yy + 1.5747 * ry
            chan_plane[idxs[1]] = yy - 0.1873 * by - 0.4682 * ry
            chan_plane[idxs[2]] = yy + 1.8556 * by
        else:
            chan_plane[idxs[0]] = planes_nl[0]
    if _DWA_TOLINEAR is None:
        _DWA_TOLINEAR = _dwa_tolinear()
    for i in list(chan_plane):
        halves = chan_plane[i][:rows, :w].astype(np.float16)
        chan_plane[i] = _DWA_TOLINEAR[halves.view(np.uint16)]

    # RLE channels: zlib -> ImfRle -> byte planes (all byte-0 of every
    # sample, then all byte-1, ...), samples channel-planar row-major
    rle_chans = [i for i, s in enumerate(schemes) if s[0] == _DWA_RLE]
    rle_bytes = {}
    if rle_chans:
        itemsizes = [2 if chans[i][1] == _HALF else 4 for i in rle_chans]
        total = rows * w * len(rle_chans)
        # validate the chunk-supplied size against geometry BEFORE it
        # sizes any buffer, and bound the inflate by ImfRle's worst
        # case (literal runs cost 1 control byte per <=127 literals)
        if rle_raw != sum(rows * w * it for it in itemsizes):
            raise ExrError("exr dwa rle raw mismatch")
        plain = zlib.decompressobj().decompress(
            streams["rle"], rle_raw + rle_raw // 127 + 4)
        raw = _rle_uncompress(plain, rle_raw)
        if len(raw) != rle_raw:
            raise ExrError("exr dwa rle size mismatch")
        u8 = np.frombuffer(raw, np.uint8)
        off = 0
        for i, it in zip(rle_chans, itemsizes):
            n = rows * w
            sample_bytes = np.empty((n, it), np.uint8)
            for j in range(it):
                plane_off = j * total + off
                sample_bytes[:, j] = u8[plane_off : plane_off + n]
            rle_bytes[i] = sample_bytes.reshape(rows, w * it)
            off += n

    # UNKNOWN channels: zlib verbatim, channel-planar rows
    unk_chans = [i for i, s in enumerate(schemes) if s[0] == _DWA_UNKNOWN]
    unk_rows = {}
    if unk_chans:
        dtypes = {_HALF: 2, _FLOAT: 4, _UINT: 4}
        # geometry check before the chunk-supplied size can allocate
        if unk_unc != sum(rows * w * dtypes[chans[i][1]]
                          for i in unk_chans):
            raise ExrError("exr dwa unknown size mismatch")
        raw = (zlib.decompressobj().decompress(
            streams["unknown"], unk_unc + 1) if unk_cmp else b"")
        if len(raw) != unk_unc:
            raise ExrError("exr dwa unknown size mismatch")
        off = 0
        for i in unk_chans:
            nbytes = rows * w * dtypes[chans[i][1]]
            unk_rows[i] = np.frombuffer(
                raw, np.uint8, nbytes, off).reshape(rows, -1)
            off += nbytes

    # assemble interleaved scanlines
    parts = []
    for r in range(rows):
        for i, (name, ptype, _xs, _ys) in enumerate(chans):
            if i in chan_plane:
                bits = chan_plane[i][r]
                if ptype == _HALF:
                    parts.append(bits.astype("<u2").tobytes())
                else:  # FLOAT channel through the lossy half path
                    parts.append(bits.view(np.float16)
                                 .astype("<f4").tobytes())
            elif i in rle_bytes:
                parts.append(rle_bytes[i][r].tobytes())
            elif i in unk_rows:
                parts.append(unk_rows[i][r].tobytes())
            else:
                raise ExrError("exr dwa channel not decoded")
    return b"".join(parts)


# -- header parsing ------------------------------------------------------------


def _read_cstr(data: bytes, pos: int):
    end = data.index(b"\0", pos)
    return data[pos:end].decode("latin-1"), end + 1


def _parse_chlist(raw: bytes):
    """[(name, pixel_type, x_samp, y_samp)] in file order."""
    chans = []
    pos = 0
    while pos < len(raw) and raw[pos] != 0:
        name, pos = _read_cstr(raw, pos)
        ptype, _plin = struct.unpack_from("<iB", raw, pos)
        xs, ys = struct.unpack_from("<ii", raw, pos + 8)
        pos += 16
        chans.append((name, ptype, xs, ys))
    return chans


def decode_exr(data: bytes) -> np.ndarray:
    """OpenEXR bytes -> (H, W, 3) uint8 RGB. Malformed input raises
    ExrError (never raw struct/zlib/index errors — the engine maps
    ExrError to its decode-failure path, matching the reference's
    image-crate decode errors)."""
    try:
        return _decode_exr(data)
    except ExrError:
        raise
    except (struct.error, zlib.error, ValueError, IndexError, KeyError,
            OverflowError, MemoryError) as e:
        raise ExrError(f"corrupt exr: {e}") from e


def _unpack_chunk(payload: bytes, comp: int, chans, w: int, rows: int,
                  dtypes) -> dict:
    """One scanline block or tile -> {channel: (rows, w) float32}.
    OpenEXR stores a chunk RAW (original scanline layout) whenever
    compression didn't shrink it, for every codec family."""
    line_bytes = sum(dtypes[c[1]].itemsize * w for c in chans)
    raw_len = line_bytes * rows
    size = len(payload)
    if comp == _PXR24 and size < raw_len:
        # bounded inflate (max_length): a crafted chunk can otherwise
        # deflate-bomb gigabytes before the length check runs. The
        # +1 keeps overlong plaintexts detectable (len != expected).
        want = _pxr24_line_bytes(chans, w) * rows
        raw = zlib.decompressobj().decompress(payload, want + 1)
        if len(raw) != want:
            raise ExrError("corrupt exr pxr24 chunk")
        return _pxr24_expand(raw, chans, w, rows)
    if comp == _PIZ and size < raw_len:
        raw = _piz_expand(payload, chans, w, rows)
    elif comp in (_DWAA, _DWAB) and size < raw_len:
        raw = _dwa_expand(payload, chans, w, rows)
    elif comp in (_B44, _B44A) and size < raw_len:
        raw = _b44_expand(payload, chans, w, rows)
    elif comp == _RLE and size < raw_len:
        raw = _zip_unfilter(_rle_uncompress(payload, raw_len))
    elif comp in (_ZIPS, _ZIP) and size < raw_len:
        # bounded inflate, see the pxr24 branch
        raw = _zip_unfilter(
            zlib.decompressobj().decompress(payload, raw_len + 1))
    else:
        raw = payload
    if len(raw) != raw_len:
        raise ExrError("corrupt exr chunk")
    out = {c[0]: np.zeros((rows, w), np.float32) for c in chans}
    bpos = 0
    for r in range(rows):
        for name, ptype, _xs, _ys in chans:
            dt = dtypes[ptype]
            out[name][r] = np.frombuffer(raw, dt, w, bpos).astype(np.float32)
            bpos += dt.itemsize * w
    return out


def _parse_header(data: bytes, pos: int):
    """One header (attribute list up to its null terminator)."""
    attrs = {}
    while True:
        if data[pos] == 0:
            pos += 1
            break
        name, pos = _read_cstr(data, pos)
        _type, pos = _read_cstr(data, pos)
        size, = struct.unpack_from("<i", data, pos)
        pos += 4
        if size < 0:
            # a negative size would move pos BACKWARD — crafted headers
            # can make the attribute loop a fixpoint (infinite loop)
            raise ExrError("bad exr attribute size")
        attrs[name] = data[pos : pos + size]
        pos += size
    return attrs, pos


_PART_TYPES = (b"scanlineimage", b"tiledimage")


def _select_part(headers):
    """Multi-part selection, mirroring the image crate's
    first_valid_layer: the first non-deep part carrying R/G/B (else
    the first non-deep part at all)."""
    fallback = None
    for k, hdr in enumerate(headers):
        typ = hdr.get("type", b"").rstrip(b"\0")
        if typ not in _PART_TYPES:
            continue  # deepscanline / deeptile
        if fallback is None:
            fallback = k
        names = {c[0].upper() for c in _parse_chlist(hdr.get("channels",
                                                             b""))}
        if {"R", "G", "B"} <= names:
            return k
    if fallback is None:
        raise ExrError("no decodable exr part (deep-only multi-part)")
    return fallback


def _decode_exr(data: bytes) -> np.ndarray:
    if data[:4] != MAGIC:
        raise ExrError("not an exr file")
    version, = struct.unpack_from("<i", data, 4)
    tiled = bool(version & 0x200)
    multi = bool(version & 0x1000)
    if (version & 0x800) and not multi:
        raise ExrError("deep exr not supported")
    pos = 8
    if multi:
        # multi-part (OpenEXR 2): concatenated headers, a null
        # terminator, per-part chunk-offset tables, and chunks carrying
        # a leading part number. Decode ONE part (the image crate's
        # first_valid_layer choice); other parts' tables are skipped
        # via their required chunkCount attributes.
        headers = []
        while data[pos] != 0:
            hdr, pos = _parse_header(data, pos)
            headers.append(hdr)
        pos += 1
        if not headers:
            raise ExrError("multi-part exr with no parts")
        counts = []
        for hdr in headers:
            try:
                (cc,) = struct.unpack("<i", hdr["chunkCount"])
            except (KeyError, struct.error) as e:
                raise ExrError(f"bad multi-part exr header: {e}") from e
            if cc < 0 or cc > 10_000_000:
                raise ExrError("bad exr chunkCount")
            counts.append(cc)
        sel = _select_part(headers)
        attrs = headers[sel]
        tiled = attrs.get("type", b"").rstrip(b"\0") == b"tiledimage"
        pos = pos + 8 * sum(counts[:sel])  # this part's offset table
        n_off_part = counts[sel]
        chunk_pre = 4  # chunks start with the part number
    else:
        attrs, pos = _parse_header(data, pos)
        n_off_part = None
        chunk_pre = 0
    try:
        x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"])
        comp = attrs["compression"][0]
        line_order = attrs["lineOrder"][0]
        chans = _parse_chlist(attrs["channels"])
    except (KeyError, struct.error) as e:
        raise ExrError(f"bad exr header: {e}") from e
    w, h = x1 - x0 + 1, y1 - y0 + 1
    if w <= 0 or h <= 0 or w * h > 100_000_000:
        raise ExrError("bad exr dimensions")
    # the decode buffers are f32 planes per channel, and the chunk
    # expanders size scratch by w*rows*channels — gate the TOTAL like
    # every other decode surface (the crate's Limits::default() class,
    # codecs.MAX_DECODE_ALLOC). Without this a crafted channel list
    # multiplies the gated w*h into the hundreds of GB: np.zeros
    # overcommits lazily and the fill kills the host instead of
    # raising (an ASan fuzz run found it as a 721 GB malloc).
    if len(chans) > 1024:
        raise ExrError("bad exr channel count")
    from .codecs import MAX_DECODE_ALLOC

    if w * h * 4 * max(1, len(chans)) > MAX_DECODE_ALLOC:
        raise ExrError(
            f"exr decode allocation {w}x{h}x{len(chans)} f32 exceeds "
            f"the 512 MiB limit"
        )
    if comp not in _BLOCK:
        raise ExrError(f"unsupported exr compression {comp}")
    for name, ptype, xs, ys in chans:
        if ptype not in (_HALF, _FLOAT, _UINT):
            raise ExrError(f"unsupported exr pixel type {ptype}")
        if xs != 1 or ys != 1:
            raise ExrError("subsampled exr channels not supported")
    # UINT converts by VALUE (the exr crate casts u32 samples to f32
    # the same way), so its dtype yields numbers, not reinterpreted
    # bits, under the shared .astype(float32) in _unpack_chunk
    dtypes = {_HALF: np.dtype("<f2"), _FLOAT: np.dtype("<f4"),
              _UINT: np.dtype("<u4")}
    planes = {c[0]: np.zeros((h, w), np.float32) for c in chans}
    if tiled:
        # tile chunks carry their own coordinates, so any lineOrder
        # (including RANDOM_Y) is fine. Mip/ripmapped pyramids: decode
        # level (0, 0) — full resolution — and skip the rest, matching
        # the image crate's largest_resolution_level() read
        try:
            txs, tys, tmode = struct.unpack("<IIB", attrs["tiles"])
        except (KeyError, struct.error) as e:
            raise ExrError(f"bad tiled exr header: {e}") from e
        lev_mode = tmode & 0xF  # 0 ONE_LEVEL / 1 MIPMAP / 2 RIPMAP
        round_up = (tmode >> 4) & 0xF == 1
        if lev_mode > 2:
            raise ExrError("bad exr tile level mode")
        if not (0 < txs <= 65536 and 0 < tys <= 65536):
            raise ExrError("bad exr tile size")

        def _nlev(s: int) -> int:
            n = 1
            while s > 1:
                s = (s + 1) // 2 if round_up else s // 2
                n += 1
            return n

        def _lsize(s: int, lev: int) -> int:
            for _ in range(lev):
                s = (s + 1) // 2 if round_up else s // 2
            return max(1, s)

        def _ntiles(s: int, ts: int) -> int:
            return (s + ts - 1) // ts

        nx = _ntiles(w, txs)
        ny = _ntiles(h, tys)
        if n_off_part is not None:
            n_off = n_off_part
        elif lev_mode == 0:
            n_off = nx * ny
        elif lev_mode == 1:  # MIPMAP_LEVELS
            n_off = sum(
                _ntiles(_lsize(w, lv), txs) * _ntiles(_lsize(h, lv), tys)
                for lv in range(_nlev(max(w, h)))
            )
        else:  # RIPMAP_LEVELS
            n_off = sum(
                _ntiles(_lsize(w, lx), txs) * _ntiles(_lsize(h, ly), tys)
                for lx in range(_nlev(w))
                for ly in range(_nlev(h))
            )
        offsets = struct.unpack_from(f"<{n_off}Q", data, pos)
        for off in offsets:
            off += chunk_pre
            dx, dy, lx, ly, size = struct.unpack_from("<5i", data, off)
            if size < 0:
                raise ExrError("bad exr tile chunk")
            if lx != 0 or ly != 0:
                continue  # smaller pyramid level
            if not (0 <= dx < nx and 0 <= dy < ny):
                raise ExrError("exr tile outside the data window")
            tw = min(txs, w - dx * txs)
            th = min(tys, h - dy * tys)
            got = _unpack_chunk(
                data[off + 20 : off + 20 + size], comp, chans, tw, th, dtypes
            )
            xa, ya = dx * txs, dy * tys
            for name, rowsarr in got.items():
                planes[name][ya : ya + th, xa : xa + tw] = rowsarr
    else:
        if line_order not in (0, 1):
            # INCREASING_Y and DECREASING_Y both work (each chunk
            # carries its own y); RANDOM_Y is tile-only
            raise ExrError("unsupported exr line order")
        block = _BLOCK[comp]
        n_blocks = (h + block - 1) // block
        if n_off_part is not None:
            n_blocks = n_off_part
        # line offset table
        offsets = struct.unpack_from(f"<{n_blocks}Q", data, pos)
        for off in offsets:
            off += chunk_pre
            y, size = struct.unpack_from("<ii", data, off)
            if not (y0 <= y <= y1) or size < 0:
                raise ExrError("exr chunk y outside the data window")
            rows = min(block, y1 - y + 1)
            got = _unpack_chunk(
                data[off + 8 : off + 8 + size], comp, chans, w, rows, dtypes
            )
            yy = y - y0
            for name, rowsarr in got.items():
                planes[name][yy : yy + rows] = rowsarr
    names = {n.upper(): n for n in planes}
    if all(k in names for k in ("R", "G", "B")):
        rgb = np.stack([planes[names["R"]], planes[names["G"]],
                        planes[names["B"]]], axis=-1)
    elif "Y" in names:
        rgb = np.repeat(planes[names["Y"]][:, :, None], 3, axis=2)
    else:
        first = next(iter(planes.values()))
        rgb = np.repeat(first[:, :, None], 3, axis=2)
    rgb = np.nan_to_num(rgb, nan=0.0, posinf=1.0, neginf=0.0)
    return np.round(np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.uint8)


# -- encode --------------------------------------------------------------------


def _attr(name: bytes, typ: bytes, val: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + struct.pack("<i", len(val)) + val


def _bgr_half(img: np.ndarray) -> np.ndarray:
    rgb = img[:, :, :3].astype(np.float32) / 255.0
    return rgb.astype("<f2")


def _half_header(w: int, h: int, compression: int, extra: bytes = b"") -> bytes:
    """Common header with HALF channels B/G/R (alphabetical, as the
    chlist must be sorted)."""
    chlist = b""
    for name in (b"B", b"G", b"R"):
        chlist += (name + b"\0" + struct.pack("<iB3x", _HALF, 0)
                   + struct.pack("<ii", 1, 1))
    chlist += b"\0"
    dw = struct.pack("<4i", 0, 0, w - 1, h - 1)
    return (
        _attr(b"channels", b"chlist", chlist)
        + _attr(b"compression", b"compression", bytes([compression]))
        + _attr(b"dataWindow", b"box2i", dw)
        + _attr(b"displayWindow", b"box2i", dw)
        + _attr(b"lineOrder", b"lineOrder", b"\0")
        + _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        + _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0, 0))
        + _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        + extra
        + b"\0"
    )


def _compress_rows(half: np.ndarray, r0: int, rows: int, x0: int, tw: int,
                   compression: int) -> bytes:
    """HALF rows [r0, r0+rows) x cols [x0, x0+tw) -> chunk payload
    (channels in chlist order B, G, R; raw wins when compression
    doesn't shrink, matching the readers' size-based dispatch)."""
    lines = []
    for r in range(r0, r0 + rows):
        lines += [half[r, x0 : x0 + tw, 2], half[r, x0 : x0 + tw, 1],
                  half[r, x0 : x0 + tw, 0]]
    raw = b"".join(ln.tobytes() for ln in lines)
    if compression == _NONE:
        return raw
    if compression == _PXR24:
        z = zlib.compress(_pxr24_filter(lines))
    elif compression == _RLE:
        z = _rle_compress(_zip_filter(raw))
    else:
        z = zlib.compress(_zip_filter(raw))
    return z if len(z) < len(raw) else raw


def encode_exr(img: np.ndarray, compression: int = _NONE) -> bytes:
    """(H, W, 3|4) uint8 -> single-part scanline EXR, HALF channels.
    compression: _NONE (default output) or _RLE/_ZIPS/_ZIP/_PXR24
    (test-support for the decode paths)."""
    h, w = img.shape[:2]
    half = _bgr_half(img)
    header = _half_header(w, h, compression)
    block = _BLOCK[compression]
    n_blocks = (h + block - 1) // block
    head_len = 8 + len(header) + 8 * n_blocks
    blocks = []
    offsets = []
    off = head_len
    for b0 in range(0, h, block):
        rows = min(block, h - b0)
        payload = _compress_rows(half, b0, rows, 0, w, compression)
        chunk = struct.pack("<ii", b0, len(payload)) + payload
        offsets.append(off)
        off += len(chunk)
        blocks.append(chunk)
    return (MAGIC + struct.pack("<i", 2) + header
            + struct.pack(f"<{n_blocks}Q", *offsets) + b"".join(blocks))


def encode_exr_tiled(img: np.ndarray, tile=(32, 32),
                     compression: int = _NONE) -> bytes:
    """Single-level (ONE_LEVEL) tiled writer — test support for the
    tiled decode path (the serving encoder stays scanline)."""
    h, w = img.shape[:2]
    txs, tys = tile
    half = _bgr_half(img)
    tiles_attr = struct.pack("<IIB", txs, tys, 0)  # ONE_LEVEL, round down
    header = _half_header(
        w, h, compression, _attr(b"tiles", b"tiledesc", tiles_attr)
    )
    nx = (w + txs - 1) // txs
    ny = (h + tys - 1) // tys
    head_len = 8 + len(header) + 8 * nx * ny
    blocks = []
    offsets = []
    off = head_len
    for dy in range(ny):
        for dx in range(nx):
            tw = min(txs, w - dx * txs)
            th = min(tys, h - dy * tys)
            payload = _compress_rows(
                half, dy * tys, th, dx * txs, tw, compression
            )
            chunk = struct.pack("<5i", dx, dy, 0, 0, len(payload)) + payload
            offsets.append(off)
            off += len(chunk)
            blocks.append(chunk)
    return (MAGIC + struct.pack("<i", 2 | 0x200) + header
            + struct.pack(f"<{nx * ny}Q", *offsets) + b"".join(blocks))


def sniff(data: bytes) -> bool:
    return data[:4] == MAGIC


__all__ = ["decode_exr", "encode_exr", "encode_exr_tiled", "ExrError",
           "sniff"]
