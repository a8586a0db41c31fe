"""`read_jpeg_coeffs` and `read_jpeg_coeffs4`: a JPEG's quantized DCT
coefficients, read on the host with the port's own entropy reader
(`csrc/jpeg_coeffs.cpp`, no libjpeg), for the coefficient decode on the
device.

The port of fanlin_tpu/engine/native_codecs.py::read_jpeg_coeffs and
::read_jpeg_coeffs4, returning the same dicts: the port's assemblies
take those functions' dicts unchanged. The reader is built with the host compiler at first
use (`ops._build.load_host`); a failed build raises.

The reader writes each coefficient once, into planes its caller owns:
`read_header` gives a stream's geometry and coding process, `read_into`
decodes it into planes of that geometry and counts the scans it
decoded. The dict readers own numpy planes (`read_dict` gives the
header and the scan count beside the dict); `read_into_slot` writes
into an image's own wire (`fused.WireSlot`), so that no plane is copied
on its way to the device.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from ..ops import _build


class Header(NamedTuple):
    """A stream's geometry, from the reader's header call."""

    w: int
    h: int
    subsamp: int  # 420, 422, 440, 444 (a gray source: 444, as its dict says)
    gray: bool
    ycck: bool  # the Adobe transform of a 4-component stream
    # each component's true block grid (rows, cols), in plane order:
    # y, cb, cr (and k for four components); y alone for gray
    grids: Tuple[Tuple[int, int], ...]
    four: bool
    progressive: bool  # the coding process: SOF2 (SOF0 and SOF1: False)


class Decoded(NamedTuple):
    """What `read_dict` gives: the dict, the stream's header and the
    number of scans the reader decoded."""

    meta: dict
    head: Header
    scans: int


def read_header(data: bytes, four: bool = False) -> Optional[Header]:
    """Parse a JPEG's markers up to its first scan: its Header, or None
    when the stream takes the pixel path (what `read_jpeg_coeffs`, or
    with `four` `read_jpeg_coeffs4`, refuses from its header alone)."""
    buf = bytes(data)
    info = (ctypes.c_int * 9)()
    if _build.load_host().fanlin_jpeg_coeffs_header(buf, len(buf), int(four),
                                                   info) != 0:
        return None
    w, h, ybw, ybh, cbw, cbh, subsamp, ycck, progressive = info
    gray = subsamp == 400
    grids = ((ybh, ybw),) if gray else ((ybh, ybw), (cbh, cbw), (cbh, cbw))
    if four:
        grids += ((ybh, ybw),)
    return Header(w, h, 444 if gray else subsamp, gray, bool(ycck), grids,
                  four, bool(progressive))


def read_into(data: bytes, head: Header, planes: List[np.ndarray]
              ) -> Optional[Tuple[np.ndarray, int]]:
    """Entropy-decode `data`, whose header is `head`, into `planes`: one
    writable (rows, cols, 64) int16 view per grid of head.grids, blocks
    contiguous (a row of a larger grid will do). Every block of them is
    written, zeros included, whatever they held. Returns the (128,)
    uint16 quant tables in natural order (luma then chroma; comp0's then
    comp1's for four components) and the number of scans decoded (1 for
    an interleaved sequential stream, 10 for libjpeg's standard
    progressive script of a YCbCr stream), or None when the reader
    refuses the stream inside its scans (the planes then hold nothing to
    read)."""
    if len(planes) != len(head.grids):
        raise ValueError(f"{len(head.grids)} planes expected")
    for p, grid in zip(planes, head.grids):
        if (p.dtype != np.int16 or p.shape != (*grid, 64)
                or p.strides[1:] != (128, 2) or p.strides[0] % 128
                or not p.flags.writeable):
            raise ValueError(f"a plane of {grid} int16 blocks expected, got "
                             f"{p.shape} {p.dtype} strides {p.strides}")
    n = len(planes)
    qt = np.empty(128, np.uint16)
    scans = ctypes.c_int(0)
    buf = bytes(data)
    rc = _build.load_host().fanlin_jpeg_coeffs_decode(
        buf, len(buf), int(head.four),
        (ctypes.c_void_p * n)(*(p.ctypes.data for p in planes)),
        (ctypes.c_int * n)(*(p.strides[0] // 128 for p in planes)),
        (ctypes.c_int * n)(*(r for r, _ in head.grids)),
        (ctypes.c_int * n)(*(c for _, c in head.grids)), qt.ctypes.data,
        ctypes.byref(scans))
    return (qt, scans.value) if rc == 0 else None


def read_into_slot(data: bytes, head: Header, slot) -> Optional[int]:
    """Entropy-decode `data`, whose header is `head`, straight into
    `slot`, a `fused.WireSlot.empty` made for head: its true grids, its
    tables and its meta (the dict `read_jpeg_coeffs` gives, with views of
    the slot's grids). Returns the number of scans decoded, or None when
    the reader refuses the stream: the slot is then to be dropped."""
    got = read_into(data, head, slot.true_grids)
    if got is None:
        return None
    tables, scans = got
    slot.hold(tables[:64], tables[64:], head.gray)
    return scans


def read_dict(data: bytes, four: bool = False) -> Optional[Decoded]:
    """The dict `read_jpeg_coeffs` (with `four`, `read_jpeg_coeffs4`)
    gives, with the stream's header and its scan count, or None where
    that function gives None."""
    head = read_header(data, four)
    if head is None:
        return None
    planes = [np.empty((r, c, 64), np.int16) for r, c in head.grids]
    got = read_into(data, head, planes)
    if got is None:
        return None
    tables, scans = got
    lq, cq = tables[:64], tables[64:]
    if four:
        y, cb, cr, k = planes
        meta = {"y": y, "cb": cb, "cr": cr, "k": k, "lq": lq, "cq": cq,
                "w": head.w, "h": head.h, "subsamp": head.subsamp,
                "ycck": head.ycck, "cmyk": True}
    else:
        if head.gray:
            planes += [np.zeros_like(planes[0]), np.zeros_like(planes[0])]
        y, cb, cr = planes
        meta = {"y": y, "cb": cb, "cr": cr, "lq": lq, "cq": cq,
                "w": head.w, "h": head.h, "subsamp": head.subsamp,
                "gray": head.gray}
    return Decoded(meta, head, scans)


def read_jpeg_coeffs(data: bytes) -> Optional[dict]:
    """Entropy-decode only (baseline, extended-sequential and
    progressive Huffman streams). Returns None when the stream should
    take the pixel path (arithmetic coding, 12-bit, no DHT segment,
    CMYK/RGB colour, a sampling layout outside 4:2:0/4:2:2/4:4:0/4:4:4,
    separate chroma quant tables, coefficient planes over 512 MiB, or
    bytes it cannot parse).

    Returns {y, cb, cr: (bh, bw, 64) int16 natural-order blocks;
    lq, cq: (64,) uint16 natural-order quant tables; w, h: true dims;
    subsamp: 420, 422, 440 or 444; gray: bool}. A gray source gets
    all-zero chroma at the luma grid's dims and subsamp 444 (zero
    coefficients decode to 128, and YCbCr(y, 128, 128) is r = g = b = y).
    """
    got = read_dict(data)
    return None if got is None else got.meta


def read_jpeg_coeffs4(data: bytes) -> Optional[dict]:
    """The 4-component (CMYK / YCCK) twin of read_jpeg_coeffs. Returns
    None for streams of 1 or 3 components, for layouts other than plain
    CMYK 4:4:4 and YCCK 4:4:4 or 4:2:0 (K at comp0's rate, comp2 on
    comp1's quant table, comp3 on comp0's), for planes over 512 MiB and
    for bytes it cannot parse.

    Returns {y, cb, cr: (bh, bw, 64) int16 natural-order blocks of comps
    0-2; k: (ybh, ybw, 64) int16 of comp3; lq, cq: (64,) uint16, comp0's
    and comp1's tables; w, h; subsamp: 444 or 420; ycck: bool (the Adobe
    transform); cmyk: True}."""
    got = read_dict(data, True)
    return None if got is None else got.meta
