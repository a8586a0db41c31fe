"""`encode_jpeg_coeffs`: a baseline JPEG from device-quantized DCT
coefficients, written on the host by the port's own entropy encoder
(`csrc/jpeg_encode.cpp`, no libjpeg) — the host half of the `jpegdct`
sink.

The port of fanlin_tpu/engine/native_codecs.py::encode_jpeg_coeffs, with
its signature and shape checks and the same bytes. The encoder is built
with the host compiler at first use (`ops._build.load_host`); a failed
build raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..ops import _build


def encode_jpeg_coeffs(y_coef: np.ndarray, cb_coef: np.ndarray,
                       cr_coef: np.ndarray, width: int, height: int,
                       quality: int) -> Optional[bytes]:
    """Entropy-encode quantized DCT coefficient blocks. Shapes (rows,
    cols, 64) int16 in natural order over the MCU-padded 4:2:0 planes;
    quality must equal the device's quantization quality. None when the
    shapes do not fit (width, height) or a coefficient is out of
    baseline range (a DC difference over 11 bits, an AC over 10)."""
    yw, yh = ((width + 15) // 16) * 2, ((height + 15) // 16) * 2
    cw, ch = (width + 15) // 16, (height + 15) // 16
    if (y_coef.shape != (yh, yw, 64) or cb_coef.shape != (ch, cw, 64)
            or cr_coef.shape != (ch, cw, 64)):
        return None
    lib = _build.load_host()
    planes = [np.ascontiguousarray(c, dtype=np.int16)
              for c in (y_coef, cb_coef, cr_coef)]
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    rc = lib.fanlin_encode_jpeg_coeffs(
        *(p.ctypes.data for p in planes), int(width), int(height),
        int(quality), ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        return None
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.fanlin_free(out)
