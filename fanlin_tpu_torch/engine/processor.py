"""The processing core: `Engine.process_image`, pixel and coefficient sources.

Port of fanlin_tpu/engine/processor.py (SyncDeviceRunner, process_image,
_encode, _output_mode, process_gif) with the reference's decision
chain (reference src/handler.rs:185-309):

 1. sniff format; unknown -> SVG validate + passthrough
 2. as_is -> raw passthrough with the sniffed mime
 3. GIF -> per-frame chain with Nearest filtering, re-encode GIF
 4. EXIF orientation (pre-read, applied post-decode)
 6-11. grayscale else-if invert -> resize (fit / fill+crop) ->
    centered fill-canvas overlay -> gaussian blur   [DEVICE]
 12. output format negotiation (webp/avif only when requested AND
    accepted)
 13. encode, with the JPEG / WebP / PNG front-ends on the device when
    the native codec core can finish them

With `device_decode` (the default, as in the reference) a plain
YCbCr JPEG, baseline or progressive, is only entropy-decoded on the
host (`jpeg_coeffs.read_jpeg_coeffs`); the device decodes its
coefficients as a prologue to the transform (`fused.CoefBatchAssembly`).
An EXIF-rotated JPEG is rotated on its coefficient grids
(`jpeg_decode.orient_meta`, jpegtran's lossless transforms); only a
flip that is not MCU-aligned sends it to the pixel path. Every other
source, and every JPEG the reader refuses, is decoded on the host
(`codecs.decode`); the bytes are the same either way, except for a
rotated source: libjpeg's iDCT and upsample rounding are not symmetric
under a flip or transpose, so the rotated decode differs from the
decoded-then-rotated pixels by a few LSB at source size (within 1 LSB
after a downscale in the tests). Not in the port yet: the device
DCT (`device_dct`) and the CMYK/ICC hooks — a CMYK JPEG is converted by
the decoder, as the reference does without an ICC profile configured.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import filters, fused, jpeg_decode, plan as plan_mod
from ..spec import content as content_mod
from ..spec import query as query_mod
from . import codecs, jpeg_coeffs, native_codecs, png_writer, svg

# read_jpeg_coeffs' subsampling layout -> the coefficient batch kind
_COEF_KIND = {420: "coef", 422: "coef422", 440: "coef440", 444: "coef444"}


class ProcessError(Exception):
    pass


class SyncDeviceRunner:
    """The Engine's default runner: one device batch per call, on the
    caller's thread, a lock serializing the device work. The server
    serves through batcher.BatchingRunner instead."""

    def __init__(self, device: torch.device):
        self.device = device
        self._lock = threading.Lock()

    def run(self, plans: List[plan_mod.ImagePlan], images: List[np.ndarray],
            kinds: List[str] = None):
        asm = fused.make_assembly(plans, images, kinds or ["rgb"], self.device)
        with self._lock:
            return asm.run()


class Engine:
    def __init__(self, device: torch.device, runner=None,
                 device_decode: bool = True, device_dct: bool = False):
        """device: where the transform runs (torch.device("cuda") to
        serve, torch.device("cpu") for the plain versions).
        runner: runs the device batches; SyncDeviceRunner(device) when
        None, the server passes a batcher.BatchingRunner.
        device_decode: JPEGs take the coefficient path. The device DCT
        is not ported yet."""
        if device_dct:
            raise NotImplementedError(
                "device_dct: the device DCT sink is not yet in the PyTorch "
                "port"
            )
        self.runner = runner if runner is not None else SyncDeviceRunner(device)
        self.device_decode = device_decode
        # observability: requests served by source kind (/stats)
        self.stats = {"pixel_src": 0, "coef_src": 0}

    def process_image(
        self, data: bytes, params: query_mod.Query, accepted: content_mod.Format,
        marks: Optional[list] = None,
    ) -> Tuple[str, bytes]:
        """marks, when given, collects (name, duration_ms) sub-stage
        timings (f_decode / f_device / f_encode) for Server-Timing."""
        fmt = codecs.sniff_format(data)
        if fmt is None:
            try:
                return svg.process_unknown_format(data)
            except svg.SvgError as e:
                raise ProcessError(str(e)) from e
        if params.as_is():
            return (codecs.MIME[fmt], data)
        if fmt == codecs.GIF:
            return self.process_gif(data, params)

        t0 = time.perf_counter()
        orientation = codecs.read_orientation(data)
        meta = None
        if self.device_decode and fmt == codecs.JPEG:
            meta = jpeg_coeffs.read_jpeg_coeffs(data)
            if meta is not None and orientation != 1:
                # rotate the coefficient grids; a flip that is not
                # MCU-aligned gives None and the pixel path
                meta = jpeg_decode.orient_meta(meta, orientation)
        if meta is not None:
            # a gray JPEG decodes through zero chroma (r = g = b = y);
            # is_gray keeps the output pixel type of the host decode
            has_alpha, is_gray = False, bool(meta["gray"])
            h, w = meta["h"], meta["w"]
            self.stats["coef_src"] += 1
        else:
            try:
                img, has_alpha, is_gray = codecs.decode(data)
            except codecs.CodecError as e:
                raise ProcessError(str(e)) from e
            img = np.ascontiguousarray(
                codecs.apply_orientation(img, orientation))
            h, w = img.shape[:2]
            self.stats["pixel_src"] += 1
        if marks is not None:
            marks.append(("f_decode", (time.perf_counter() - t0) * 1000.0))

        plan = plan_mod.plan_image(w, h, params, filters.LANCZOS3,
                                   opaque=not has_alpha)
        mode = self._output_mode(params, plan, has_alpha, is_gray)
        out_fmt = fmt
        if params.use_webp() and accepted.webp_accepted():
            out_fmt = codecs.WEBP
        elif params.use_avif() and accepted.avif_accepted():
            out_fmt = codecs.AVIF
        kind = self._sink(params, plan, out_fmt, mode)
        if meta is None:
            src = img
        else:
            src = meta
            base = _COEF_KIND[meta["subsamp"]]
            kind = base if kind == "rgb" else f"{base}+{kind}"

        t1 = time.perf_counter()
        out = self.runner.run([plan], [src], [kind])[0]
        t2 = time.perf_counter()
        if marks is not None:
            marks.append(("f_device", (t2 - t1) * 1000.0))
        try:
            payload = self._encode(out, out_fmt, params.quality(), mode)
        except codecs.CodecError as e:
            raise ProcessError(str(e)) from e
        if marks is not None:
            marks.append(("f_encode", (time.perf_counter() - t2) * 1000.0))
        return (codecs.MIME[out_fmt], payload)

    @staticmethod
    def _sink(params, plan, out_fmt: str, mode: str) -> str:
        """The batch kind: which encode front-end runs on the device
        (the host then finishes with entropy coding only)."""
        if out_fmt == codecs.JPEG and mode in ("RGB", "RGBA"):
            return "jpeg420" if native_codecs.available() else "rgb"
        if out_fmt == codecs.PNG and mode in ("L", "LA", "RGB", "RGBA"):
            # adaptive filter choice on the device; the host runs zlib
            # and chunk framing only (no native core needed)
            return "png:%d" % {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        if (
            out_fmt == codecs.WEBP
            # alpha must be provably constant 255 (YUV drops it)
            and (mode == "RGB" or (mode == "RGBA" and not plan.want_alpha))
            and 1 <= params.quality() < 100  # q==100 is lossless (RGB path)
            and native_codecs.has_webp_yuv420()
        ):
            return "webp420"
        return "rgb"

    @staticmethod
    def _encode(out, out_fmt: str, quality: int, mode: str) -> bytes:
        if isinstance(out, tuple) and out[0] == "ycbcr420":
            q = min(max(quality, 1), 100)
            payload = native_codecs.encode_jpeg_raw420(out[1], out[2], out[3], q)
            if payload is None:
                raise codecs.CodecError("raw jpeg encode failed")
            return payload
        if isinstance(out, tuple) and out[0] == "webpyuv":
            q = min(max(quality, 1), 99)
            payload = native_codecs.encode_webp_yuv420(out[1], out[2], out[3], q)
            if payload is None:
                raise codecs.CodecError("yuv webp encode failed")
            return payload
        if isinstance(out, tuple) and out[0] == "pngrows":
            _, rows, w, h, nch = out
            return png_writer.write_png(rows, w, h, nch, quality)
        return codecs.encode(out, out_fmt, quality, mode)

    @staticmethod
    def _output_mode(params, plan, has_alpha: bool, is_gray: bool) -> str:
        """Track the reference's output pixel type through the chain:
        fill-canvas overlay -> Rgba8 (handler.rs:247); grayscale ->
        Luma/LumaA (handler.rs:224-225); otherwise the source model."""
        if plan.use_canvas:
            return "RGBA"
        if params.grayscale():
            return "LA" if has_alpha else "L"
        if has_alpha:
            # a gray+alpha source stays LumaA through the chain
            return "LA" if is_gray else "RGBA"
        if is_gray:
            return "L"
        return "RGB"

    def process_gif(self, data: bytes, params: query_mod.Query) -> Tuple[str, bytes]:
        """Animated-GIF chain (reference src/handler.rs:311-366): frames
        become the device batch dimension; resampling uses the Nearest
        filter; corrupt frames stay as 1x1 placeholders untouched by
        the transforms; frame delays are dropped and the result loops
        forever. webp/avif flags are ignored."""
        try:
            frames = codecs.decode_gif_frames(data)
        except codecs.CodecError as e:
            raise ProcessError(str(e)) from e

        placeholder_shape = (1, 1, 4)
        work_idx = [
            i for i, f in enumerate(frames) if f.shape != placeholder_shape
        ]
        outs: List[Optional[np.ndarray]] = [None] * len(frames)
        if work_idx:
            plans = []
            imgs = []
            for i in work_idx:
                h, w = frames[i].shape[:2]
                plans.append(plan_mod.plan_image(w, h, params, filters.NEAREST))
                imgs.append(frames[i])
            # chunk long animations so a single GIF can't demand an
            # oversized device batch
            results = []
            for s in range(0, len(plans), 32):
                results.extend(self.runner.run(plans[s : s + 32], imgs[s : s + 32]))
            for i, r in zip(work_idx, results):
                outs[i] = r
        for i, f in enumerate(frames):
            if outs[i] is None:
                outs[i] = f  # placeholder frames pass through untouched
        try:
            payload = codecs.encode_gif_frames(outs)
        except Exception as e:
            raise ProcessError(f"failed to encode gif: {e}") from e
        return (codecs.MIME[codecs.GIF], payload)
