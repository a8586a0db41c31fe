"""Color management: CMYK / YCCK JPEG -> sRGB.

The port's copy of fanlin_tpu/engine/icc.py:1-245, the counterpart of
the reference's zune-jpeg + lcms2 path (reference src/handler.rs:31-34,
85-101, 398-493), with the device LUT evaluated by the port's
`ops.cmyk_lut.DeviceCmykTransform` (the K12b kernel on CUDA):

* JPEG header probe (SOF component count + Adobe APP14 transform +
  APP2 ICC chunks) decides whether color management applies — only
  4-component (CMYK / YCCK) JPEGs proceed (handler.rs:409-413).
* The pixel transform runs through liblcms2 (the same C library the
  reference links) via PIL.ImageCms, CMYK_8 -> sRGB, Perceptual
  intent, NO_CACHE — handler.rs:477-487. libjpeg handles the
  YCCK->CMYK stage (the reference hand-rolls the fixed-point YCbCr
  constants at handler.rs:420-439; libjpeg applies the same Rec.601
  math internally, plus the Adobe inversion convention).
* The default-profile transform is built ONCE at startup and reused
  (transform creation costs ~40 ms — handler.rs:483); embedded
  profiles are preferred over the default when use_embedded_profile
  is set, falling back to the default on a broken profile
  (handler.rs:446-459).
"""

from __future__ import annotations

import io
from typing import Optional

import numpy as np
from PIL import Image, ImageCms

from . import codecs

_NOCACHE = 0x0040  # cmsFLAGS_NOCACHE, reference handler.rs:480


class CMYK2RGB:
    """A prebuilt lcms2 CMYK->sRGB transform (reference handler.rs:469-493)."""

    def __init__(self, transform):
        self._t = transform

    @classmethod
    def with_icc_profile(cls, profile_bytes: bytes) -> Optional["CMYK2RGB"]:
        try:
            src = ImageCms.ImageCmsProfile(io.BytesIO(profile_bytes))
            dst = ImageCms.createProfile("sRGB")
            t = ImageCms.buildTransform(
                src,
                dst,
                "CMYK",
                "RGB",
                renderingIntent=ImageCms.Intent.PERCEPTUAL,
                flags=_NOCACHE,
            )
            return cls(t)
        except Exception:
            return None

    @classmethod
    def from_file(cls, path) -> Optional["CMYK2RGB"]:
        try:
            with open(path, "rb") as f:
                return cls.with_icc_profile(f.read())
        except OSError:
            return None

    def convert(self, cmyk_image: Image.Image) -> np.ndarray:
        """CMYK PIL image -> (H, W, 3) uint8 sRGB array."""
        rgb = ImageCms.applyTransform(cmyk_image, self._t)
        return np.asarray(rgb, dtype=np.uint8)


def jpeg_embedded_profile_bytes(data: bytes) -> Optional[bytes]:
    """The embedded ICC profile bytes, or None (header-only open)."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            prof = im.info.get("icc_profile")
            return prof if prof else None
    except Exception:
        return None


# sampled per-profile device LUTs, keyed by profile-bytes hash (the
# reference PREFERS the embedded profile, handler.rs:446-459). Each 17^4
# LUT is 1.0 MB as f32; a few dozen distinct profiles cover real
# traffic.
from ..utils.bytelru import ByteLRU  # noqa: E402

_PROFILE_LUTS = ByteLRU(max_bytes=32 * 1024 * 1024)
# broken profiles are negative-cached IN the same ByteLRU (a (None,)
# sentinel with a nominal size) so a stream of distinct garbage
# profiles cannot grow memory unboundedly

import logging  # noqa: E402

_log = logging.getLogger("fanlin_tpu_torch.engine.icc")


def embedded_device_lut(profile_bytes: bytes, n: int = 17):
    """(lut_flat (n^4, 3) f32, n, key) for an embedded ICC profile,
    building + caching the sampled LUT on first sight (~40 ms for the
    lcms2 transform + the 83k-sample evaluation — amortized exactly
    like the reference's prebuilt default transform, handler.rs:483).
    None for profiles lcms2 rejects (callers fall back to the default
    profile, matching handler.rs:446-459's fallback)."""
    import hashlib
    import time as _time

    key = hashlib.sha1(profile_bytes).hexdigest()[:16]
    hit = _PROFILE_LUTS.get((key, n))
    if hit is not None:
        return (hit[0], n, key) if hit[0] is not None else None
    conv = CMYK2RGB.with_icc_profile(profile_bytes)
    if conv is None:
        _PROFILE_LUTS.put((key, n), (None,), 256)  # bounded negative cache
        return None
    from ..ops import cmyk_lut

    t0 = _time.perf_counter()
    flat = cmyk_lut.sample_lut(conv.convert, n).reshape(-1, 3).astype(
        np.float32
    )
    _log.info(
        "sampled embedded ICC profile %s into a %d^4 device LUT "
        "(%.1f ms)", key, n, (_time.perf_counter() - t0) * 1000.0,
    )
    _PROFILE_LUTS.put((key, n), (flat,), flat.nbytes)
    return flat, n, key


def jpeg_num_components(data: bytes) -> Optional[int]:
    """Component count from the SOF marker, header-only scan
    (the reference's zune-jpeg decode_headers probe, handler.rs:403-407)."""
    i = 2
    n = len(data)
    if data[:2] != b"\xff\xd8":
        return None
    while i + 4 <= n:
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        if marker == 0xFF:
            # T.81 B.1.1.2: any marker may be preceded by extra 0xFF
            # fill bytes — treating the fill byte as a marker read a
            # bogus segment length and skipped straight past the SOF
            i += 1
            continue
        if marker in (0x01,) or 0xD0 <= marker <= 0xD9:
            i += 2
            continue
        seglen = int.from_bytes(data[i + 2 : i + 4], "big")
        # SOF0..SOF15 except DHT(C4)/JPG(C8)/DAC(CC)
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if i + 9 < n:
                return data[i + 9]
            return None
        i += 2 + seglen
    return None


def convert_jpeg_color_if_needed(
    data: bytes, default: Optional[CMYK2RGB], use_embedded_profile: bool,
    device_transform=None, device_up: bool = True,
) -> Optional[np.ndarray]:
    """(H, W, 3) uint8 RGB when the JPEG is CMYK/YCCK and a transform
    applies; None otherwise (falls back to the normal decode path).
    Mirrors reference handler.rs:398-466.

    device_transform (ops.cmyk_lut.DeviceCmykTransform of the default
    profile) evaluates the transform on its device instead of host
    lcms2. When it is set (tpu.device_icc deployments), embedded
    profiles ALSO evaluate through their own sampled per-profile LUTs
    (embedded_device_lut), on the default transform's device, keeping
    the pixel path byte-identical to the CMYK coefficient path, which
    carries the same LUT. Without device_icc, embedded profiles run
    exact host lcms2.

    device_up=False (the micro-batcher has wedged the device): the
    LUT-bearing conversions do not touch the card; the same LUT is
    evaluated by its host twin (`DeviceCmykTransform.convert_host`, the
    host mirror's numpy LUT, the kernel's bytes), and the request's batch
    is mirror-served, which tags the response cold.

    Only the open and load of the stream are guarded: a stream that
    Pillow cannot open or decode gives None, and the normal decode path
    reports it. A failure of the transform itself (the K12b kernel, the
    LUT upload, lcms2) raises: it is never answered with Pillow's plain
    CMYK->RGB, which gives other bytes."""
    if not use_embedded_profile and default is None:
        return None
    if jpeg_num_components(data) != 4:
        return None
    try:
        im = Image.open(io.BytesIO(data))
        # reference-parity decode alloc limit (codecs.MAX_DECODE_ALLOC;
        # image crate Limits::default(), handler.rs:205). CodecError
        # must NOT be swallowed into the None fallback below — the
        # normal decode path would just re-hit the same gate.
        codecs._check_decode_alloc(im.size, im.mode)
        im.load()
    except codecs.CodecError:
        raise
    except Exception:
        # Pillow's errors for a damaged stream (OSError, SyntaxError,
        # ValueError, struct.error, ...)
        return None
    with im:
        if im.mode != "CMYK":
            return None
        embedded = im.info.get("icc_profile")
        conv: Optional[CMYK2RGB] = None
        if use_embedded_profile and embedded:
            if device_transform is not None:
                lut = embedded_device_lut(embedded)
                if lut is not None:
                    px = np.asarray(im, dtype=np.uint8)
                    if not device_up:
                        # no transform: making one uploads its LUT
                        from ..ops.cmyk_lut import convert_host

                        return convert_host(px, lut[0], lut[1])
                    t = _device_transform_for(lut, device_transform.device)
                    return t.convert(px)
            conv = CMYK2RGB.with_icc_profile(embedded)
        if conv is None:
            conv = default
            if conv is not None and device_transform is not None:
                px = np.asarray(im, dtype=np.uint8)
                return (device_transform.convert(px) if device_up
                        else device_transform.convert_host(px))
        if conv is None:
            return None
        return conv.convert(im)


def _device_transform_for(lut, device):
    """DeviceCmykTransform for a sampled per-profile LUT on `device`. It
    holds the array that `embedded_device_lut` caches, so every transform
    of one profile shares that array's one cached device copy."""
    from ..ops.cmyk_lut import DeviceCmykTransform

    return DeviceCmykTransform(lut[0], device)
