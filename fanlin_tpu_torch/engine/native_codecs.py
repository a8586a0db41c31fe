"""ctypes binding for the native codec core (native/libfanlincodec.so).

Carried over from fanlin_tpu/engine/native_codecs.py (the port
imports nothing of the JAX package). It loads the
same `native/` build the same way; only the encoders and the pixel
decoder are bound here. The coefficient path reads JPEGs with the
port's own reader (`engine.jpeg_coeffs`), which needs no libjpeg.

Loads lazily; every entry point returns None when the library isn't
built or rejects the input, and the caller falls back to the PIL path.
Set FANLIN_NATIVE=0 to disable, FANLIN_NATIVE_LIB to load another
build of the same library."""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

_LIB = None
_TRIED = False
# Held while the library loads: a caller that finds the load started
# waits for its result instead of reading "not built" meanwhile (under
# the micro-batcher, concurrent first requests would otherwise pick
# different encode paths and answer different bytes).
_LOAD_LOCK = threading.Lock()


def _load():
    with _LOAD_LOCK:
        return _load_once()


def _load_once():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("FANLIN_NATIVE", "1") == "0":
        return None
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    override = os.environ.get("FANLIN_NATIVE_LIB")
    built = os.path.join(here, "native", "libfanlincodec.so")
    if override is None and not os.path.exists(built):
        # best-effort on-demand build (source ships, binary doesn't)
        import subprocess

        try:
            subprocess.run(
                ["make", "-C", os.path.join(here, "native")],
                capture_output=True, timeout=120, check=False,
            )
        except Exception:
            pass
    cands = ((override,) if override is not None
             else (built, "libfanlincodec.so"))
    for cand in cands:
        try:
            lib = ctypes.CDLL(cand)
        except OSError:
            continue
        try:
            if lib.fc_abi_version() != 1:
                continue
        except AttributeError:
            continue
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.fc_decode_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.fc_decode_jpeg.restype = ctypes.c_int
        lib.fc_encode_jpeg.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.fc_encode_jpeg.restype = ctypes.c_int
        lib.fc_encode_webp.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.fc_encode_webp.restype = ctypes.c_int
        lib.fc_encode_jpeg_raw420.argtypes = [
            u8p, u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.fc_encode_jpeg_raw420.restype = ctypes.c_int
        try:
            lib.fc_encode_webp_yuv420.argtypes = [
                u8p, u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.fc_encode_webp_yuv420.restype = ctypes.c_int
        except AttributeError:
            pass  # older .so without the YUV WebP encoder
        try:
            lib.fc_encode_webp_m.argtypes = [
                u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.fc_encode_webp_m.restype = ctypes.c_int
            lib.fc_encode_webp_yuv420_m.argtypes = [
                u8p, u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.fc_encode_webp_yuv420_m.restype = ctypes.c_int
        except AttributeError:
            pass  # older .so without the webp effort knob
        try:
            lib.fc_deflate_zlib.argtypes = [
                u8p, ctypes.c_size_t, ctypes.c_int,
                ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.fc_deflate_zlib.restype = ctypes.c_int
        except AttributeError:
            pass  # older .so without libdeflate
        lib.fc_free.argtypes = [u8p]
        _LIB = lib
        break
    return _LIB


def available() -> bool:
    return _load() is not None


def has_webp_yuv420() -> bool:
    """True when the built lib carries the device-YUV WebP front-end
    (the processor gates the webp420 sink on this)."""
    lib = _load()
    return lib is not None and hasattr(lib, "fc_encode_webp_yuv420")


def decode_jpeg(data: bytes) -> Optional[Tuple[np.ndarray, bool]]:
    """-> ((H, W, 3) RGB or (H, W, 1) luma array, is_gray), or None to
    fall back (unbuilt lib, CMYK/YCCK input, or decode error)."""
    lib = _load()
    if lib is None:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    out = u8p()
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    rc = lib.fc_decode_jpeg(
        data, len(data), 0, ctypes.byref(out), ctypes.byref(w),
        ctypes.byref(h), ctypes.byref(c),
    )
    if rc != 0:
        return None
    try:
        n = w.value * h.value * c.value
        arr = np.ctypeslib.as_array(out, shape=(n,)).reshape(
            h.value, w.value, c.value
        ).copy()
    finally:
        lib.fc_free(out)
    return arr, c.value == 1


def encode_jpeg(pixels: np.ndarray, quality: int) -> Optional[bytes]:
    """(H, W, 3) RGB or (H, W, 1)/(H, W) luma -> JPEG bytes, or None."""
    lib = _load()
    if lib is None:
        return None
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    if pixels.shape[2] not in (1, 3):
        return None
    pixels = np.ascontiguousarray(pixels)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    out = u8p()
    out_len = ctypes.c_size_t()
    rc = lib.fc_encode_jpeg(
        pixels.ctypes.data_as(u8p), pixels.shape[1], pixels.shape[0],
        pixels.shape[2], int(quality), ctypes.byref(out),
        ctypes.byref(out_len),
    )
    if rc != 0:
        return None
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.fc_free(out)


def encode_jpeg_raw420(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                       quality: int) -> Optional[bytes]:
    """Entropy-encode device-produced YCbCr 4:2:0 planes into a JPEG.
    y: (H, W); cb/cr: (ceil(H/2), ceil(W/2)). None -> fall back."""
    lib = _load()
    if lib is None:
        return None
    h, w = y.shape
    if cb.shape != ((h + 1) // 2, (w + 1) // 2) or cr.shape != cb.shape:
        return None
    y = np.ascontiguousarray(y)
    cb = np.ascontiguousarray(cb)
    cr = np.ascontiguousarray(cr)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    out = u8p()
    out_len = ctypes.c_size_t()
    rc = lib.fc_encode_jpeg_raw420(
        y.ctypes.data_as(u8p), cb.ctypes.data_as(u8p), cr.ctypes.data_as(u8p),
        w, h, int(quality), ctypes.byref(out), ctypes.byref(out_len),
    )
    if rc != 0:
        return None
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.fc_free(out)


def deflate_zlib(data: bytes, level: int) -> Optional[bytes]:
    """zlib-format deflate via libdeflate (levels 1-12) for the device
    PNG front-end's filtered scanlines. None -> unbuilt/old lib (caller
    falls back to stdlib zlib)."""
    lib = _load()
    if lib is None or not hasattr(lib, "fc_deflate_zlib"):
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    out = u8p()
    out_len = ctypes.c_size_t()
    buf = ctypes.cast(ctypes.c_char_p(data), u8p)
    rc = lib.fc_deflate_zlib(buf, len(data), int(level),
                             ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        return None
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.fc_free(out)


# VP8 effort (WebPConfig.method 0-6; libwebp default 4), set once at
# startup from `tpu.webp_method`. 4 keeps the exact simple-API default
# path (byte-stable vs the reference's webp crate, reference
# handler.rs:286-305); other values need a current .so and fall back
# to 4 on an older build.
_WEBP_METHOD = 4


def set_webp_method(method: int) -> None:
    global _WEBP_METHOD
    _WEBP_METHOD = min(6, max(0, int(method)))


def encode_webp_yuv420(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                       quality: int) -> Optional[bytes]:
    """Lossy-encode device-produced WebP-range YUV 4:2:0 planes via the
    advanced WebPPicture API (no host RGB->YUV import). q 1-99;
    y: (H, W); u/v: (ceil(H/2), ceil(W/2)). None -> fall back."""
    lib = _load()
    if lib is None or not hasattr(lib, "fc_encode_webp_yuv420"):
        return None
    h, w = y.shape
    if u.shape != ((h + 1) // 2, (w + 1) // 2) or v.shape != u.shape:
        return None
    y = np.ascontiguousarray(y)
    u = np.ascontiguousarray(u)
    v = np.ascontiguousarray(v)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    out = u8p()
    out_len = ctypes.c_size_t()
    if _WEBP_METHOD != 4 and hasattr(lib, "fc_encode_webp_yuv420_m"):
        rc = lib.fc_encode_webp_yuv420_m(
            y.ctypes.data_as(u8p), u.ctypes.data_as(u8p),
            v.ctypes.data_as(u8p), w, h, int(quality), _WEBP_METHOD,
            ctypes.byref(out), ctypes.byref(out_len),
        )
    else:
        rc = lib.fc_encode_webp_yuv420(
            y.ctypes.data_as(u8p), u.ctypes.data_as(u8p),
            v.ctypes.data_as(u8p), w, h, int(quality),
            ctypes.byref(out), ctypes.byref(out_len),
        )
    if rc != 0:
        return None
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.fc_free(out)


def encode_webp(pixels: np.ndarray, quality: int) -> Optional[bytes]:
    """(H, W, 3|4) -> WebP bytes (q>=100 lossless), or None."""
    lib = _load()
    if lib is None:
        return None
    if pixels.ndim != 3 or pixels.shape[2] not in (3, 4):
        return None
    pixels = np.ascontiguousarray(pixels)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    out = u8p()
    out_len = ctypes.c_size_t()
    if (_WEBP_METHOD != 4 and int(quality) < 100
            and hasattr(lib, "fc_encode_webp_m")):
        # q>=100 (lossless) stays on the legacy path: the knob tunes
        # VP8's lossy RD effort, not the lossless encoder
        rc = lib.fc_encode_webp_m(
            pixels.ctypes.data_as(u8p), pixels.shape[1], pixels.shape[0],
            pixels.shape[2], int(quality), _WEBP_METHOD,
            ctypes.byref(out), ctypes.byref(out_len),
        )
    else:
        rc = lib.fc_encode_webp(
            pixels.ctypes.data_as(u8p), pixels.shape[1], pixels.shape[0],
            pixels.shape[2], int(quality), ctypes.byref(out),
            ctypes.byref(out_len),
        )
    if rc != 0:
        return None
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.fc_free(out)
