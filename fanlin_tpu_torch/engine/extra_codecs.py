"""Pure-Python codecs for formats the image crate decodes but PIL
does not: QOI and farbfeld.

The reference reaches these through image::ImageReader::
with_guessed_format (reference src/handler.rs:192-196) — any format
the crate's content sniffer recognizes is decoded, processed, and
re-encoded in the same format via the generic write_to branch
(handler.rs:306). Both formats are trivial enough to implement
directly; hot use would go through the device pipeline like any
other source.

QOI spec: https://qoiformat.org/qoi-specification.pdf (public domain).
farbfeld spec: tools.suckless.org/farbfeld — magic "farbfeld",
u32-BE width/height, then RGBA u16-BE pixels.
"""

from __future__ import annotations

import struct

import numpy as np


class ExtraCodecError(ValueError):
    pass


# ----------------------------------------------------------------------------
# QOI
# ----------------------------------------------------------------------------

_QOI_OP_INDEX = 0x00
_QOI_OP_DIFF = 0x40
_QOI_OP_LUMA = 0x80
_QOI_OP_RUN = 0xC0
_QOI_OP_RGB = 0xFE
_QOI_OP_RGBA = 0xFF


def decode_qoi(data: bytes) -> np.ndarray:
    """QOI bytes -> (H, W, 4) uint8 RGBA."""
    if len(data) < 22 or data[:4] != b"qoif":
        raise ExtraCodecError("not a qoi file")
    w, h = struct.unpack(">II", data[4:12])
    channels = data[12]
    if w == 0 or h == 0 or channels not in (3, 4) or data[13] > 1:
        raise ExtraCodecError("invalid qoi header")
    n = w * h
    if n > 100_000_000:
        # same pixel cap as decode_hdr / exr: a 22-byte file must not
        # be able to force a multi-GB allocation from header dims alone
        raise ExtraCodecError("qoi dimensions too large")
    out = np.empty((n, 4), dtype=np.uint8)
    index = [(0, 0, 0, 0)] * 64
    r, g, b, a = 0, 0, 0, 255
    pos = 14
    i = 0
    end = len(data) - 8  # 8-byte end marker
    while i < n and pos < end:
        b1 = data[pos]
        pos += 1
        if b1 == _QOI_OP_RGB:
            r, g, b = data[pos], data[pos + 1], data[pos + 2]
            pos += 3
        elif b1 == _QOI_OP_RGBA:
            r, g, b, a = data[pos], data[pos + 1], data[pos + 2], data[pos + 3]
            pos += 4
        else:
            tag = b1 & 0xC0
            if tag == _QOI_OP_INDEX:
                r, g, b, a = index[b1 & 0x3F]
            elif tag == _QOI_OP_DIFF:
                r = (r + ((b1 >> 4) & 0x03) - 2) & 0xFF
                g = (g + ((b1 >> 2) & 0x03) - 2) & 0xFF
                b = (b + (b1 & 0x03) - 2) & 0xFF
            elif tag == _QOI_OP_LUMA:
                b2 = data[pos]
                pos += 1
                vg = (b1 & 0x3F) - 32
                r = (r + vg - 8 + ((b2 >> 4) & 0x0F)) & 0xFF
                g = (g + vg) & 0xFF
                b = (b + vg - 8 + (b2 & 0x0F)) & 0xFF
            else:  # RUN
                run = (b1 & 0x3F) + 1
                out[i : i + run] = (r, g, b, a)
                i += run
                continue
        index[(r * 3 + g * 5 + b * 7 + a * 11) % 64] = (r, g, b, a)
        out[i] = (r, g, b, a)
        i += 1
    if i < n:
        raise ExtraCodecError("truncated qoi stream")
    return out.reshape(h, w, 4)


def encode_qoi(img: np.ndarray) -> bytes:
    """(H, W, 3|4) uint8 -> QOI bytes."""
    h, w = img.shape[:2]
    channels = img.shape[2]
    if channels == 3:
        rgba = np.concatenate(
            [img, np.full((h, w, 1), 255, dtype=np.uint8)], axis=2
        )
    else:
        rgba = img
    px = rgba.reshape(-1, 4)
    out = bytearray()
    out += b"qoif" + struct.pack(">II", w, h) + bytes([channels, 0])
    index = [(0, 0, 0, 0)] * 64
    prev = (0, 0, 0, 255)
    run = 0
    for p in map(tuple, px.tolist()):  # Python ints (no u8 wraparound)
        if p == prev:
            run += 1
            if run == 62:
                out.append(_QOI_OP_RUN | (run - 1))
                run = 0
            continue
        if run:
            out.append(_QOI_OP_RUN | (run - 1))
            run = 0
        r, g, b, a = p
        idx = (r * 3 + g * 5 + b * 7 + a * 11) % 64
        if index[idx] == p:
            out.append(_QOI_OP_INDEX | idx)
        elif a == prev[3]:
            dr = (r - prev[0] + 128) % 256 - 128
            dg = (g - prev[1] + 128) % 256 - 128
            db = (b - prev[2] + 128) % 256 - 128
            if -2 <= dr <= 1 and -2 <= dg <= 1 and -2 <= db <= 1:
                out.append(_QOI_OP_DIFF | ((dr + 2) << 4) | ((dg + 2) << 2) | (db + 2))
            elif -32 <= dg <= 31 and -8 <= dr - dg <= 7 and -8 <= db - dg <= 7:
                out.append(_QOI_OP_LUMA | (dg + 32))
                out.append(((dr - dg + 8) << 4) | (db - dg + 8))
            else:
                out += bytes([_QOI_OP_RGB, r, g, b])
        else:
            out += bytes([_QOI_OP_RGBA, r, g, b, a])
        index[idx] = p
        prev = p
    if run:
        out.append(_QOI_OP_RUN | (run - 1))
    out += b"\x00" * 7 + b"\x01"
    return bytes(out)


# ----------------------------------------------------------------------------
# farbfeld
# ----------------------------------------------------------------------------


def decode_farbfeld(data: bytes) -> np.ndarray:
    """farbfeld bytes -> (H, W, 4) uint8 RGBA (16 -> 8 bit: high byte)."""
    if len(data) < 16 or data[:8] != b"farbfeld":
        raise ExtraCodecError("not a farbfeld file")
    w, h = struct.unpack(">II", data[8:16])
    if w == 0 or h == 0:
        # zero-dim images break downstream geometry planning; the
        # image crate's ImageBuffer::from_raw rejects them too
        raise ExtraCodecError("invalid farbfeld dimensions")
    need = 16 + w * h * 8
    if len(data) < need:
        raise ExtraCodecError("truncated farbfeld stream")
    px = np.frombuffer(data, dtype=">u2", count=w * h * 4, offset=16)
    # image crate converts 16 -> 8 bit by taking the high byte
    return (px.reshape(h, w, 4) >> 8).astype(np.uint8)


def encode_farbfeld(img: np.ndarray) -> bytes:
    """(H, W, 3|4) uint8 -> farbfeld bytes (8 -> 16 bit: v * 257)."""
    h, w = img.shape[:2]
    if img.shape[2] == 3:
        img = np.concatenate(
            [img, np.full((h, w, 1), 255, dtype=np.uint8)], axis=2
        )
    px = (img.astype(np.uint16) * 257).astype(">u2")
    return b"farbfeld" + struct.pack(">II", w, h) + px.tobytes()


# ----------------------------------------------------------------------------
# PNM corners PIL gets wrong: P7 PAM (PIL cannot
# open it at all — the image crate's pnm decoder accepts it,
# reference handler.rs:192-196 sniffs it like any source) and 16-bit
# P5/P6 (maxval > 255: PIL yields clipped mode-I for P5 and byte
# garbage for P6, where the crate scales to 8-bit). 8-bit P1-P6 stay
# on PIL (it matches). 16->8 bit uses round(v * 255 / maxval) — the
# DynamicImage NumCast scaling convention.
# ----------------------------------------------------------------------------


def _pnm_tokens(data: bytes, pos: int, n: int):
    """Read n whitespace-separated ASCII tokens (with # comments)
    starting at pos; -> (values, next_pos)."""
    vals = []
    while len(vals) < n:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if pos < len(data) and data[pos : pos + 1] == b"#":
            nl = data.find(b"\n", pos)
            if nl < 0:
                raise ExtraCodecError("truncated pnm header")
            pos = nl + 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        if pos == start:
            raise ExtraCodecError("truncated pnm header")
        try:
            vals.append(int(data[start:pos]))
        except ValueError as e:
            raise ExtraCodecError(f"bad pnm header token: {e}") from e
    return vals, pos


def pnm_wide_header(data: bytes):
    """(w, h, maxval, sample_pos) for a P5/P6 whose maxval > 255,
    else None (PIL handles 8-bit PNM correctly)."""
    if data[:2] not in (b"P5", b"P6"):
        return None
    try:
        (w, h, maxval), pos = _pnm_tokens(data, 2, 3)
    except ExtraCodecError:
        return None  # let PIL produce the parity error message
    if maxval <= 255:
        return None
    return w, h, maxval, pos + 1  # single whitespace after maxval


def decode_pnm_wide(data: bytes, hdr=None) -> np.ndarray:
    """16-bit P5/P6 -> (H, W, 1|3) uint8, scaled from maxval.
    hdr: an already-parsed pnm_wide_header result (the dispatcher in
    codecs.decode parses it to pick the branch — no need to tokenize
    the header twice)."""
    if hdr is None:
        hdr = pnm_wide_header(data)
    if hdr is None:
        raise ExtraCodecError("not a wide pnm")
    w, h, maxval, pos = hdr
    ch = 1 if data[:2] == b"P5" else 3
    if w <= 0 or h <= 0 or maxval > 65535:
        raise ExtraCodecError("bad pnm dimensions")
    n = w * h * ch
    if 2 * n > _MAX_DECODE_BYTES:
        raise ExtraCodecError("pnm decode exceeds the 512 MiB limit")
    if len(data) < pos + 2 * n:
        raise ExtraCodecError("truncated pnm stream")
    px = np.frombuffer(data, dtype=">u2", count=n, offset=pos)
    return _scale_to_u8(px, maxval).reshape(h, w, ch)


_PAM_DEPTH_OK = {1, 2, 3, 4}

# decode-buffer cap: codecs.MAX_DECODE_ALLOC (the image crate's
# Limits::default() 512 MiB). Importing codecs here is cycle-free —
# codecs imports this module only lazily inside functions.
from .codecs import MAX_DECODE_ALLOC as _MAX_DECODE_BYTES  # noqa: E402


def _scale_to_u8(px: np.ndarray, maxval: int) -> np.ndarray:
    """Scale integer samples to u8 by round(v * 255 / maxval), in
    slabs so the float32 temporaries stay bounded (a gate-passing
    16-bit stream can hold 256M samples — a 1 GiB f32 copy if done
    in one shot). Samples ABOVE the declared maxval (sloppy or
    hostile writers) clamp to 255 — the unclamped float->u8
    assignment would WRAP them (e.g. maxval=256, sample=257 -> 0)."""
    out = np.empty(px.shape[0], dtype=np.uint8)
    scale = 255.0 / maxval
    step = 1 << 22
    for s in range(0, px.shape[0], step):
        e = min(s + step, px.shape[0])
        out[s:e] = np.clip(
            (px[s:e].astype(np.float32) * scale).round(), 0.0, 255.0
        )
    return out


def gray_to_rgb_u8(a: np.ndarray, maxval: int) -> np.ndarray:
    """2-D wide-integer/float grayscale -> (H, W, 3) u8 through the
    slabbed scaler (the shared policy for every scaled-gray decode
    branch: I;16 / mode-I / F in codecs.decode and the PNM paths)."""
    y = _scale_to_u8(np.ravel(a), maxval).reshape(a.shape)
    return np.repeat(y[:, :, None], 3, axis=2)


def decode_pam(data: bytes) -> tuple:
    """P7 PAM -> ((H, W, C) uint8, has_alpha, is_gray). Header is
    KEY [value] lines up to ENDHDR; samples are raw, big-endian u16
    when maxval > 255."""
    if data[:3] != b"P7\n":
        raise ExtraCodecError("not a pam file")
    pos = 3
    fields = {}
    for _ in range(256):  # header lines are few; bound crafted input
        nl = data.find(b"\n", pos)
        if nl < 0:
            raise ExtraCodecError("truncated pam header")
        line = data[pos:nl].strip()
        pos = nl + 1
        if not line or line.startswith(b"#"):
            continue
        parts = line.split(None, 1)
        key = parts[0].upper()
        if key == b"ENDHDR":
            break
        fields[key] = parts[1] if len(parts) > 1 else b""
    else:
        raise ExtraCodecError("oversized pam header")
    try:
        w = int(fields[b"WIDTH"])
        h = int(fields[b"HEIGHT"])
        depth = int(fields[b"DEPTH"])
        maxval = int(fields[b"MAXVAL"])
    except (KeyError, ValueError) as e:
        raise ExtraCodecError(f"bad pam header: {e}") from e
    if (w <= 0 or h <= 0 or depth not in _PAM_DEPTH_OK
            or not 1 <= maxval <= 65535):
        raise ExtraCodecError("bad pam geometry")
    n = w * h * depth
    sample_bytes = 2 if maxval > 255 else 1
    if n * sample_bytes > _MAX_DECODE_BYTES:
        raise ExtraCodecError("pam decode exceeds the 512 MiB limit")
    if len(data) < pos + sample_bytes * n:
        raise ExtraCodecError("truncated pam stream")
    if maxval > 255:
        px = np.frombuffer(data, dtype=">u2", count=n, offset=pos)
    else:
        px = np.frombuffer(data, dtype=np.uint8, count=n, offset=pos)
    arr = _scale_to_u8(px, maxval).reshape(h, w, depth)
    has_alpha = depth in (2, 4)
    is_gray = depth in (1, 2)
    if depth == 1:
        arr = np.repeat(arr, 3, axis=2)
    elif depth == 2:
        y, a = arr[:, :, :1], arr[:, :, 1:]
        arr = np.concatenate([np.repeat(y, 3, axis=2), a], axis=2)
    return arr, has_alpha, is_gray


def encode_pam(img: np.ndarray, gray_alpha: bool = False) -> bytes:
    """(H, W, 4) uint8 RGBA -> P7 PAM bytes. The image crate's pnm
    encoder emits PAM for alpha-bearing pixel types (PNM proper has no
    alpha); gray_alpha collapses to GRAYSCALE_ALPHA like LumaA8."""
    h, w = img.shape[:2]
    if gray_alpha:
        samples = np.ascontiguousarray(img[:, :, (0, 3)])
        depth, tupl = 2, b"GRAYSCALE_ALPHA"
    else:
        samples = np.ascontiguousarray(img)
        depth, tupl = 4, b"RGB_ALPHA"
    return (b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL 255\n"
            b"TUPLTYPE %s\nENDHDR\n" % (w, h, depth, tupl)
            ) + samples.tobytes()


# ----------------------------------------------------------------------------
# Radiance HDR (.hdr / RGBE): the reference
# decodes HDR via the image crate and re-encodes through the generic
# write_to branch (reference src/handler.rs:306); transform requests
# here used to 500. Decode handles both new-style (per-component RLE)
# and flat/old-style scanlines; encode writes flat RGBE (valid
# everywhere; bitstreams differ from the image crate's RLE, pixels
# agree — PARITY.md known-diff).
# ----------------------------------------------------------------------------


def decode_hdr(data: bytes) -> np.ndarray:
    """Radiance RGBE bytes -> (H, W, 3) uint8 RGB.

    Float recovery is the standard ldexp(mantissa, e-136); the u8
    mapping is round(clamp(v, 0, 1) * 255) — the image crate's
    Rgb32F -> Rgb8 conversion (linear clamp, no tone mapping)."""
    if not (data[:10] == b"#?RADIANCE" or data[:6] == b"#?RGBE"):
        raise ExtraCodecError("not a radiance file")
    # -- header ---------------------------------------------------------
    pos = 0
    lines = []
    while True:
        nl = data.find(b"\n", pos)
        if nl < 0:
            raise ExtraCodecError("truncated radiance header")
        lines.append(data[pos:nl])
        pos = nl + 1
        if lines[-1] == b"":
            break
        if len(lines) > 100:
            raise ExtraCodecError("oversized radiance header")
    for ln in lines:
        if ln.startswith(b"FORMAT=") and b"32-bit_rle_rgbe" not in ln:
            raise ExtraCodecError(f"unsupported radiance format {ln!r}")
    nl = data.find(b"\n", pos)
    if nl < 0:
        raise ExtraCodecError("missing radiance resolution line")
    res = data[pos:nl].split()
    pos = nl + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        # other orientations are legal but unseen in practice; the
        # image crate's hdr decoder is -Y +X only as well
        raise ExtraCodecError(f"unsupported radiance orientation {res!r}")
    try:
        h, w = int(res[1]), int(res[3])
    except ValueError as e:
        raise ExtraCodecError(f"bad radiance resolution {res!r}") from e
    if h <= 0 or w <= 0 or h * w > 100_000_000:
        raise ExtraCodecError("bad radiance dimensions")
    rgbe = np.zeros((h, w, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8, len(data) - pos, pos)
    bp = 0  # cursor into buf

    def need(n):
        if bp + n > buf.shape[0]:
            raise ExtraCodecError("truncated radiance pixels")

    y = 0
    while y < h:
        need(4)
        if 8 <= w <= 32767 and buf[bp] == 2 and buf[bp + 1] == 2 and (
            (int(buf[bp + 2]) << 8) | int(buf[bp + 3])
        ) == w:
            bp += 4  # new-style: 4 per-component RLE streams
            for c in range(4):
                x = 0
                while x < w:
                    need(1)
                    count = int(buf[bp]); bp += 1
                    if count > 128:  # run
                        count -= 128
                        need(1)
                        if x + count > w:
                            raise ExtraCodecError("radiance rle overrun")
                        rgbe[y, x : x + count, c] = buf[bp]
                        bp += 1
                    else:  # literals
                        need(count)
                        if count == 0 or x + count > w:
                            raise ExtraCodecError("radiance rle overrun")
                        rgbe[y, x : x + count, c] = buf[bp : bp + count]
                        bp += count
                    x += count
            y += 1
        else:
            # flat / old-style scanline with (1,1,1,n) repeat markers.
            # Fast path first: a row with no marker anywhere (the
            # common case — encode_hdr below emits only these, and
            # its mantissa mapping cannot produce a (1,1,1,*) pixel)
            # is one bulk copy instead of a per-pixel Python loop
            # (4M iterations for a 2000x2000 source on the 1-core
            # host). Marker rows fall through to the exact scalar
            # parse; per-row prev/shift state makes the split safe.
            if bp + 4 * w <= buf.shape[0]:
                row = buf[bp : bp + 4 * w].reshape(w, 4)
                if not ((row[:, 0] == 1) & (row[:, 1] == 1)
                        & (row[:, 2] == 1)).any():
                    rgbe[y] = row
                    bp += 4 * w
                    y += 1
                    continue
            x = 0
            shift = 0
            prev = None
            while x < w:
                need(4)
                px = buf[bp : bp + 4]; bp += 4
                if px[0] == 1 and px[1] == 1 and px[2] == 1:
                    if prev is None:
                        raise ExtraCodecError("radiance old-rle underrun")
                    count = int(px[3]) << shift
                    if x + count > w:
                        raise ExtraCodecError("radiance old-rle overrun")
                    rgbe[y, x : x + count] = prev
                    x += count
                    shift += 8
                else:
                    rgbe[y, x] = px
                    prev = px
                    x += 1
                    shift = 0
            y += 1
    mant = rgbe[:, :, :3].astype(np.float32)
    e = rgbe[:, :, 3].astype(np.int32)
    scale = np.where(e == 0, 0.0, np.ldexp(1.0, e - 136)).astype(np.float32)
    rgb = mant * scale[:, :, None]
    return np.round(np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.uint8)


def _hdr_rle_component(comp: np.ndarray) -> bytes:
    """New-style Radiance RLE for one (w,) uint8 component row: runs
    >= 4 as (128+len, value) with len <= 127, literals in <=128-byte
    chunks. Segment-level loop (run boundaries found vectorized), so
    noisy rows cost ~w/128 iterations, not w."""
    n = comp.size
    change = np.nonzero(np.diff(comp))[0] + 1
    starts = np.concatenate([[0], change, [n]])
    lens = np.diff(starts)
    run_ix = np.nonzero(lens >= 4)[0]  # loop RUNS only, not every segment
    out = bytearray()
    lit_start = 0  # pending literal span [lit_start, run start)

    def flush_literals(end: int) -> None:
        nonlocal lit_start
        while lit_start < end:
            k = min(128, end - lit_start)
            out.append(k)
            out.extend(comp[lit_start : lit_start + k].tobytes())
            lit_start += k

    for si in run_ix:
        s, e = int(starts[si]), int(starts[si + 1])
        flush_literals(s)
        v = int(comp[s])
        run = e - s
        while run > 0:
            k = min(127, run)
            out += bytes((128 + k, v))
            run -= k
        lit_start = e
    flush_literals(n)
    return bytes(out)


def encode_hdr(img: np.ndarray) -> bytes:
    """(H, W, 3|4) uint8 -> Radiance RGBE bytes. New-style RLE
    scanlines (what the image crate's hdr encoder writes) when the
    width allows (8..32767), flat RGBE otherwise. Inverse of
    decode_hdr's u8 mapping: v/255 -> float -> rgbe."""
    rgb = img[:, :, :3].astype(np.float32) / 255.0
    h, w = rgb.shape[:2]
    maxv = rgb.max(axis=2)
    mant, expo = np.frexp(maxv)  # maxv = mant * 2^expo, mant in [0.5, 1)
    # rgbe mantissas: round(v * 2^(8 - expo)); e byte = expo + 128
    factor = np.where(maxv < 1e-32, 0.0, np.ldexp(1.0, 8 - expo)).astype(
        np.float32  # keep the round in f32 (ldexp promotes to f64)
    )
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[:, :, :3] = np.minimum(
        np.round(rgb * factor[:, :, None]), 255
    ).astype(np.uint8)
    rgbe[:, :, 3] = np.where(maxv < 1e-32, 0, expo + 128).astype(np.uint8)
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + (
        b"-Y %d +X %d\n" % (h, w)
    )
    if not (8 <= w <= 32767):
        return header + rgbe.tobytes()
    parts = [header]
    marker = bytes((2, 2, w >> 8, w & 0xFF))
    planar = np.ascontiguousarray(rgbe.transpose(0, 2, 1))  # (h, 4, w)
    for r in range(h):
        parts.append(marker)
        for c in range(4):
            parts.append(_hdr_rle_component(planar[r, c]))
    return b"".join(parts)
