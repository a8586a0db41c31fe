"""Host-side codec stages: format sniffing, decode to RGBA tensors,
and bitstream encoders.

Carried over from fanlin_tpu/engine/codecs.py: the port imports
nothing of the JAX package. The decoders and encoders it reaches lazily
(exr_codec, extra_codecs, png16, tiff16) are the port's copies.

These are the host bookends around the device transform program —
entropy-coded bitstreams don't vectorize, so (like the reference,
which delegates to the image/webp crates, SURVEY.md §2.2) decode and
encode run on CPU via libjpeg-turbo / libpng / libwebp / libavif
through PIL, all of which release the GIL so the codec thread pool
scales.

Behavioral parity targets (reference src/handler.rs:185-309):

* format sniffing by magic bytes, like image::ImageReader::
  with_guessed_format (handler.rs:192-196);
* EXIF orientation read pre-decode, applied post-decode
  (handler.rs:205-222);
* PNG quality tiers: q<50 Best, q<85 Default, else Fast compression,
  adaptive filtering (handler.rs:264-273);
* JPEG quality clamped 1-100, 4:2:0 subsampling (handler.rs:274-278);
* AVIF speed 10 + quality, sRGB (handler.rs:279-285);
* WebP q==100 lossless, else libwebp lossy from RGBA
  (handler.rs:286-305).
"""

from __future__ import annotations

import io
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

Image.MAX_IMAGE_PIXELS = None  # replaced by the reference-parity alloc gate

# Decode allocation cap, mirroring the reference's image-crate limits:
# ImageReader::into_decoder applies Limits::default() — max_alloc
# 512 MiB (image 0.25, reference src/handler.rs:205) — so a corrupt or
# malicious source whose header claims enormous dimensions errors
# (-> 500 + fallback) instead of forcing a multi-GB host allocation.
# GIF is the one deliberate exemption: the reference decodes GIF with
# Limits::no_limits() (handler.rs:319), so decode_gif_frames stays
# uncapped.
MAX_DECODE_ALLOC = 512 * 1024 * 1024

# bytes/px of the DECODE buffer per PIL mode (the crate's limit meters
# the decoder's output buffer, not later conversions)
_MODE_BPP = {
    "1": 1, "L": 1, "P": 1, "LA": 2, "La": 2, "PA": 2,
    "I;16": 2, "I;16B": 2, "I;16L": 2, "I;16N": 2,
    "RGB": 3, "YCbCr": 3, "LAB": 3, "HSV": 3,
}


def _check_decode_alloc(size, mode: str) -> None:
    """Raise CodecError when decoding would allocate more than the
    reference's 512 MiB limit (image crate Limits::default())."""
    w, h = size
    bpp = _MODE_BPP.get(mode, 4)  # RGBA/CMYK/I/F and unknown: 4
    if w * h * bpp > MAX_DECODE_ALLOC:
        raise CodecError(
            f"image decode allocation {w}x{h} {mode} exceeds the "
            f"512 MiB limit"
        )

JPEG = "jpeg"
PNG = "png"
GIF = "gif"
WEBP = "webp"
AVIF = "avif"
BMP = "bmp"
TIFF = "tiff"
ICO = "ico"
PNM = "pnm"
QOI = "qoi"
DDS = "dds"
FARBFELD = "farbfeld"
HDR = "hdr"
OPENEXR = "openexr"

# MIME values match image::ImageFormat::to_mime_type (the reference
# serves format.to_mime_type() for every sniffed source).
MIME = {
    JPEG: "image/jpeg",
    PNG: "image/png",
    GIF: "image/gif",
    WEBP: "image/webp",
    AVIF: "image/avif",
    BMP: "image/bmp",
    TIFF: "image/tiff",
    ICO: "image/x-icon",
    PNM: "image/x-portable-anymap",
    QOI: "image/x-qoi",
    DDS: "image/vnd-ms.dds",
    FARBFELD: "image/farbfeld",
    HDR: "image/vnd.radiance",
    OPENEXR: "image/x-exr",
}

MIME_SVG = "image/svg+xml"


class CodecError(Exception):
    pass


def _native():
    from . import native_codecs

    return native_codecs


def sniff_format(data: bytes) -> Optional[str]:
    """Magic-byte format sniffing (image::ImageFormat guessing rules)."""
    if data[:3] == b"\xff\xd8\xff":
        return JPEG
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return PNG
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return GIF
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return WEBP
    if data[4:8] == b"ftyp" and data[8:12] in (b"avif", b"avis"):
        return AVIF
    if data[:2] == b"BM":
        return BMP
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return TIFF
    if data[:4] == b"\x00\x00\x01\x00":
        return ICO
    # remaining formats image::ImageReader::with_guessed_format
    # recognizes by content (PNM/QOI/DDS/farbfeld parity)
    if (
        len(data) >= 3
        and data[0:1] == b"P"
        and data[1:2] in b"1234567"
        and data[2:3] in b" \t\n\r"
    ):
        return PNM
    if data[:4] == b"qoif":
        return QOI
    if data[:4] == b"DDS ":
        return DDS
    if data[:8] == b"farbfeld":
        return FARBFELD
    if data[:10] == b"#?RADIANCE" or data[:6] == b"#?RGBE":
        return HDR
    if data[:4] == b"\x76\x2f\x31\x01":
        return OPENEXR
    # last resort: a PIL sniff for anything else PIL can open (the
    # image crate's sniffer is broader than the table above); text or
    # garbage still falls through to the SVG/unknown path
    try:
        with Image.open(io.BytesIO(data)) as im:
            fmt = (im.format or "").lower()
    except Exception:
        return None
    if fmt in MIME:
        return fmt
    if fmt == "ppm":
        return PNM
    return None


def read_orientation(data: bytes) -> int:
    """EXIF orientation tag (1-8), 1 when absent/unreadable."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            o = im.getexif().get(0x0112, 1)
            return int(o) if o in range(1, 9) else 1
    except Exception:
        return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """Apply an EXIF orientation to an (H, W, C) array.

    Mirrors image::DynamicImage::apply_orientation
    (reference handler.rs:221-222). Cheap on host: numpy views.
    """
    if orientation == 2:
        return img[:, ::-1]
    if orientation == 3:
        return img[::-1, ::-1]
    if orientation == 4:
        return img[::-1]
    if orientation == 5:
        return img.transpose(1, 0, 2)
    if orientation == 6:
        return np.rot90(img, k=-1)
    if orientation == 7:
        # transverse: mirror horizontal then rotate 90 CW
        # == anti-diagonal transpose
        return np.rot90(img, k=1)[:, ::-1]
    if orientation == 8:
        return np.rot90(img, k=1)
    return img


def decode(data: bytes) -> Tuple[np.ndarray, bool, bool]:
    """Decode bytes -> ((H, W, 3|4) uint8, has_alpha, is_gray).

    Opaque sources come back as 3-channel RGB (the device pipeline
    synthesizes the constant alpha plane); sources with transparency
    come back RGBA. has_alpha / is_gray describe the *source* color
    model so the encoder can preserve the reference's output pixel
    type (Luma stays Luma, RGB stays RGB, handler.rs:224-228 notes).
    """
    if data[:3] == b"\xff\xd8\xff":
        native = _native().decode_jpeg(data)
        if native is not None:
            arr, is_gray = native
            if arr.shape[2] == 1:
                arr = np.repeat(arr, 3, axis=2)
            return arr, False, is_gray
    if data[:4] == b"\x76\x2f\x31\x01":
        from . import exr_codec

        try:
            return exr_codec.decode_exr(data), False, False
        except exr_codec.ExrError as e:
            raise CodecError(str(e)) from e
    if (data[:4] == b"qoif" or data[:8] == b"farbfeld"
            or data[:10] == b"#?RADIANCE" or data[:6] == b"#?RGBE"):
        # formats PIL can't read; image-crate parity via extra_codecs
        from . import extra_codecs

        try:
            if data[:4] == b"qoif":
                arr = extra_codecs.decode_qoi(data)
                has_alpha = len(data) > 12 and data[12] == 4
            elif data[:8] == b"farbfeld":
                arr = extra_codecs.decode_farbfeld(data)
                has_alpha = True
            else:
                arr = extra_codecs.decode_hdr(data)
                has_alpha = False
        except extra_codecs.ExtraCodecError as e:
            raise CodecError(str(e)) from e
        if not has_alpha:
            arr = np.ascontiguousarray(arr[:, :, :3])
        return arr, has_alpha, False
    if data[:2] in (b"P7", b"P5", b"P6"):
        # PNM corners PIL gets wrong: PAM (P7, unsupported) and 16-bit
        # P5/P6 (maxval > 255: clipped/garbage) — the image crate
        # decodes both (extra_codecs); 8-bit PNM falls through to PIL
        from . import extra_codecs

        try:
            if data[:2] == b"P7":
                arr, has_alpha, is_gray = extra_codecs.decode_pam(data)
                return np.ascontiguousarray(arr), has_alpha, is_gray
            hdr = extra_codecs.pnm_wide_header(data)
            if hdr is not None:
                arr = extra_codecs.decode_pnm_wide(data, hdr)
                is_gray = arr.shape[2] == 1
                if is_gray:
                    arr = np.repeat(arr, 3, axis=2)
                return np.ascontiguousarray(arr), False, is_gray
        except extra_codecs.ExtraCodecError as e:
            raise CodecError(str(e)) from e
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        # 16-bit PNGs decode raw: PIL's RGB;16B raw modes keep only
        # the high byte and drop color-key tRNS, where the image
        # crate scales round(v*255/65535) and expands the alpha
        # plane (PARITY known-diff #11, now closed). Damage falls
        # back to PIL so corrupt-input statuses stay PIL-defined.
        from . import png16

        if png16.is_png16(data):
            try:
                return png16.decode_png16(data)
            except png16.Png16Error:
                pass
    if data[:2] in (b"II", b"MM"):
        # 16-bit color TIFFs (classic or BigTIFF): same high-byte
        # story as PNG (PIL's RGB;16 raw modes), same fix — raw
        # decode with the crate's round scaling; unsupported layouts
        # fall back to PIL's high-byte read (tiff16._container
        # rejects non-TIFF II/MM prefixes before any IFD walk)
        from . import tiff16

        parsed = tiff16.sniff16_parsed(data)
        if parsed is not None:
            try:
                return tiff16.decode_tiff16(data, parsed)
            except tiff16.Tiff16Error:
                pass
    try:
        with Image.open(io.BytesIO(data)) as im:
            _check_decode_alloc(im.size, im.mode)
            if 0 in im.size:
                # zero-dim sources break geometry planning downstream;
                # checked pre-load so every mode branch below is covered
                raise CodecError("zero-dimension image")
            im.load()
            mode = im.mode
            # tRNS color keys on non-palette modes count too: the
            # crate's png EXPAND turns RGB/L + tRNS into an alpha
            # plane, and PIL's convert("RGBA") applies the key from
            # im.info (16-bit keys route through png16 above; 1-bit
            # grayscale opens as mode "1" and carries the same key)
            has_alpha = mode in ("RGBA", "LA", "PA") or (
                mode in ("P", "RGB", "L", "1")
                and "transparency" in im.info
            )
            is_gray = mode in ("L", "LA", "I", "I;16", "1")
            # Wide-grayscale modes PIL mangles (clips I;16/I at 255,
            # int-truncates F) scale through extra_codecs' shared
            # slabbed scaler — one-shot float32 copies of a
            # gate-passing I;16 source are ~1 GiB, the allocation
            # class the 512 MiB gate exists to stop. The scaler's u8
            # clamp maps out-of-range samples to 0/255, so mode I
            # (32-bit container, real content is 16-bit) is exactly
            # clip(v, 0, 65535) scaled, and mode F is
            # round(clamp(v, 0, 1)*255) like the HDR/EXR float paths.
            # The image crate scales Luma16 the same way and has no
            # 32-bit-integer pixel type either (known-diff #11).
            _wide_gray = {"I;16": (np.uint16, 65535),
                          "I": (np.int32, 65535),
                          "F": (np.float32, 1)}.get(
                "I;16" if mode.startswith("I;16") else mode)
            if _wide_gray is not None:
                from . import extra_codecs

                dt, maxval = _wide_gray
                rgb = extra_codecs.gray_to_rgb_u8(
                    np.asarray(im, dtype=dt), maxval)
                return rgb, False, True
            out = im.convert("RGBA") if has_alpha else im.convert("RGB")
            arr = np.asarray(out, dtype=np.uint8)
            if arr.ndim != 3 or arr.shape[2] not in (3, 4):
                raise CodecError(f"unexpected decode shape {arr.shape}")
            return arr, has_alpha, is_gray
    except CodecError:
        raise
    except Exception as e:
        raise CodecError(f"failed to decode image: {e}") from e


def decode_gif_frames(data: bytes) -> List[np.ndarray]:
    """Decode all GIF frames to full-canvas RGBA arrays.

    Per-frame decode errors yield a 1x1 (32,32,32) placeholder, the
    reference's corrupt-frame behavior (handler.rs:325-327). No
    decode limits, mirroring Limits::no_limits() (handler.rs:318-319).
    """
    placeholder = np.full((1, 1, 4), (32, 32, 32, 255), dtype=np.uint8)
    frames: List[np.ndarray] = []
    try:
        im = Image.open(io.BytesIO(data))
    except Exception as e:
        raise CodecError(f"failed to decode gif: {e}") from e
    try:
        n = getattr(im, "n_frames", 1)
    except Exception:
        n = 1
    for idx in range(n):
        try:
            im.seek(idx)
            frames.append(np.asarray(im.convert("RGBA"), dtype=np.uint8))
        except Exception:
            frames.append(placeholder.copy())
    if not frames:
        frames.append(placeholder.copy())
    return frames


def _to_pil(img: np.ndarray, mode: str) -> Image.Image:
    """(H, W, 3|4) array -> PIL image in the requested output mode.
    3-channel inputs are opaque (the device dropped a known-255 alpha
    plane); converting RGB->RGBA re-synthesizes it."""
    base = "RGBA" if img.shape[2] == 4 else "RGB"
    pil = Image.fromarray(img, base)
    if mode == base:
        return pil
    return pil.convert(mode)


def encode(img: np.ndarray, fmt: str, quality: int, mode: str) -> bytes:
    """Encode an (H, W, 4) RGBA array as `fmt` with reference-parity
    encoder settings. `mode` is the output pixel type ('L', 'LA',
    'RGB', 'RGBA') tracked by the processor."""
    buf = io.BytesIO()
    if fmt == PNG:
        # quality -> compression tier: ONE definition shared with the
        # device PNG sink (png_writer), so the PIL fallback and the
        # sink path can never desynchronize
        from .png_writer import level_for_quality

        _to_pil(img, mode).save(
            buf, format="PNG", compress_level=level_for_quality(quality)
        )
    elif fmt == JPEG:
        q = min(max(quality, 1), 100)
        m = {"LA": "L", "RGBA": "RGB", "PA": "RGB"}.get(mode, mode)
        if m == "RGB":
            native = _native().encode_jpeg(img[:, :, :3], q)
            if native is not None:
                return native
        elif m == "L":
            # device grayscale output has r==g==b; plane 0 IS the luma
            native = _native().encode_jpeg(img[:, :, 0], q)
            if native is not None:
                return native
        _to_pil(img, m).save(buf, format="JPEG", quality=q, subsampling=2)
    elif fmt == WEBP:
        # handler.rs:286-305: q==100 -> lossless; else libwebp lossy RGBA
        q = min(max(quality, 1), 100)
        native = _native().encode_webp(img, q)
        if native is not None:
            return native
        pil = _to_pil(img, "RGBA")
        if q == 100:
            pil.save(buf, format="WEBP", lossless=True)
        else:
            pil.save(buf, format="WEBP", quality=q, method=4)
    elif fmt == AVIF:
        q = min(max(quality, 1), 100)
        _to_pil(img, mode).save(buf, format="AVIF", quality=q, speed=10)
    elif fmt == GIF:
        _to_pil(img, "RGBA").save(buf, format="GIF")
    elif fmt == ICO:
        if img.shape[0] > 256 or img.shape[1] > 256:
            raise CodecError("ico output limited to 256x256")
        _to_pil(img, "RGBA").save(buf, format="ICO")
    elif fmt == BMP:
        m = {"LA": "L", "PA": "RGB"}.get(mode, mode)
        _to_pil(img, m).save(buf, format="BMP")
    elif fmt == TIFF:
        _to_pil(img, mode).save(buf, format="TIFF")
    elif fmt == PNM:
        # image's generic write_to(Pnm) emits binary PGM/PPM — and
        # P7 PAM for alpha-bearing pixel types (PNM has no alpha)
        if mode in ("RGBA", "LA", "PA"):
            from . import extra_codecs

            # a transport-pruned (3-plane, known-255-alpha) array is
            # re-expanded so the PAM carries the alpha channel the
            # output pixel type declares (known-diff #4 invariant)
            rgba = np.asarray(_to_pil(img, "RGBA"), dtype=np.uint8)
            return extra_codecs.encode_pam(rgba, gray_alpha=mode == "LA")
        m = "L" if mode in ("L", "LA") else "RGB"
        _to_pil(img, m).save(buf, format="PPM")
    elif fmt == QOI:
        from . import extra_codecs

        return extra_codecs.encode_qoi(img)
    elif fmt == FARBFELD:
        from . import extra_codecs

        return extra_codecs.encode_farbfeld(img)
    elif fmt == HDR:
        from . import extra_codecs

        return extra_codecs.encode_hdr(img)
    elif fmt == OPENEXR:
        from . import exr_codec

        # ZIP-compressed HALF scanlines: ~60x smaller than
        # the uncompressed writer on photographic content for a little
        # host zlib; every reader (incl. the reference's exr crate)
        # decodes ZIP. Bitstream differs from the crate's RLE+f32
        # output either way — pixel parity is what's pinned.
        return exr_codec.encode_exr(img, compression=exr_codec._ZIP)
    else:
        # DDS: the image crate has no DDS encoder either, so the
        # reference's write_to(Dds) errors exactly the same way (-> 500)
        raise CodecError(f"no encoder for format {fmt}")
    return buf.getvalue()


def encode_gif_frames(frames: List[np.ndarray]) -> bytes:
    """Re-encode RGBA frames as an infinitely-looping GIF.

    Frame delays are dropped (duration 0) — the reference's
    Frame::new drops per-frame delay (handler.rs:355) — and loop is
    infinite (handler.rs:362). Fully-opaque animations use fast
    octree quantization (the reference encodes at speed 10, its
    fastest setting, handler.rs:361); frames with transparency take
    the slower alpha-preserving path.
    """
    buf = io.BytesIO()
    opaque = all(
        f.shape[2] == 3 or bool((f[..., 3] == 255).all()) for f in frames
    )
    if opaque:
        pils = [
            Image.fromarray(f[..., :3], "RGB").quantize(
                colors=256, method=Image.FASTOCTREE
            )
            for f in frames
        ]
    else:
        pils = [Image.fromarray(f, "RGBA") for f in frames]
    pils[0].save(
        buf,
        format="GIF",
        save_all=True,
        append_images=pils[1:],
        loop=0,
        duration=0,
        disposal=2,
    )
    return buf.getvalue()
