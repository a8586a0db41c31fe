"""`read_jpeg_coeffs`: a JPEG's quantized DCT coefficients, read on the
host with the port's own entropy reader (`csrc/jpeg_coeffs.cpp`, no
libjpeg), for the coefficient decode on the device.

The port of fanlin_tpu/engine/native_codecs.py::read_jpeg_coeffs,
returning the same dict: the port's assembly takes that function's
dicts unchanged. The reader is built with the host compiler at first
use (`ops._build.load_host`); a failed build raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..ops import _build


def read_jpeg_coeffs(data: bytes) -> Optional[dict]:
    """Entropy-decode only (baseline, extended-sequential and
    progressive Huffman streams). Returns None when the stream should
    take the pixel path (arithmetic coding, 12-bit, no DHT segment,
    CMYK/RGB colour, a sampling layout outside 4:2:0/4:2:2/4:4:0/4:4:4,
    separate chroma quant tables, a coefficient blob over 512 MiB, or
    bytes it cannot parse).

    Returns {y, cb, cr: (bh, bw, 64) int16 natural-order blocks;
    lq, cq: (64,) uint16 natural-order quant tables; w, h: true dims;
    subsamp: 420, 422, 440 or 444; gray: bool}. A gray source gets
    all-zero chroma at the luma grid's dims and subsamp 444 (zero
    coefficients decode to 128, and YCbCr(y, 128, 128) is r = g = b = y).
    """
    lib = _build.load_host()
    out = ctypes.POINTER(ctypes.c_int16)()
    info = (ctypes.c_int * 7)()
    qt = (ctypes.c_uint16 * 128)()
    buf = bytes(data)
    rc = lib.fanlin_read_jpeg_coeffs(buf, len(buf), ctypes.byref(out), info,
                                     qt)
    if rc != 0:
        return None
    w, h, ybw, ybh, cbw, cbh, subsamp = info
    try:
        ny = ybh * ybw * 64
        nc = cbh * cbw * 64
        flat = np.ctypeslib.as_array(out, shape=(ny + 2 * nc,))
        y = flat[:ny].reshape(ybh, ybw, 64).copy()
        cb = flat[ny:ny + nc].reshape(cbh, cbw, 64).copy()
        cr = flat[ny + nc:].reshape(cbh, cbw, 64).copy()
    finally:
        lib.fanlin_free(out)
    tables = np.ctypeslib.as_array(qt)
    gray = subsamp == 400
    if gray:
        cb = np.zeros((ybh, ybw, 64), np.int16)
        cr = np.zeros((ybh, ybw, 64), np.int16)
    return {
        "y": y, "cb": cb, "cr": cr,
        "lq": tables[:64].copy(), "cq": tables[64:].copy(),
        "w": w, "h": h,
        "subsamp": 444 if gray else subsamp,
        "gray": gray,
    }
