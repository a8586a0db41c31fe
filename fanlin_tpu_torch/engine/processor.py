"""The processing core: `Engine.process_image`, pixel and coefficient sources.

Port of fanlin_tpu/engine/processor.py (SyncDeviceRunner, process_image,
_encode, _output_mode, process_gif) with the reference's decision
chain (reference src/handler.rs:185-309):

 1. sniff format; unknown -> SVG validate + passthrough
 2. as_is -> raw passthrough with the sniffed mime
 3. GIF -> per-frame chain with Nearest filtering, re-encode GIF
 4. EXIF orientation (pre-read, applied post-decode)
 5. JPEG CMYK/YCCK -> RGB colour management (engine.icc)
 6-11. grayscale else-if invert -> resize (fit / fill+crop) ->
    centered fill-canvas overlay -> gaussian blur   [DEVICE]
 12. output format negotiation (webp/avif only when requested AND
    accepted)
 13. encode, with the JPEG / WebP / PNG front-ends on the device when
    the native codec core can finish them

With `device_decode` (the default, as in the reference) a plain
YCbCr JPEG, baseline or progressive, is only entropy-decoded on the
host; the device decodes its coefficients as a prologue to the
transform (`fused.CoefBatchAssembly`). Under a runner that stages
(the server's batcher) an upright JPEG, with no source cache, is read
straight into its own pinned wire slot (`jpeg_coeffs.read_into_slot`);
every other one is read into a dict (`jpeg_coeffs.read_jpeg_coeffs`).
An EXIF-rotated JPEG is rotated on its coefficient grids
(`jpeg_decode.orient_meta`, jpegtran's lossless transforms); only a
flip that is not MCU-aligned sends it to the pixel path. Every other
source, and every JPEG the reader refuses, is decoded on the host
(`codecs.decode`); the bytes are the same either way, except for a
rotated source: libjpeg's iDCT and upsample rounding are not symmetric
under a flip or transpose, so the rotated decode differs from the
decoded-then-rotated pixels by a few LSB at source size (within 1 LSB
after a downscale in the tests). With `device_dct`, a JPEG output in
RGB/RGBA mode takes the `jpegdct:Q` sink: the device also runs the 8x8
DCT and quantisation (`ops.dct`) and the host only entropy-codes the
coefficients with the port's own encoder (`jpeg_encode`). With
`fast_decode` a YCbCr coefficient source without grayscale or invert
takes the folded decode-resize (`jpeg_decode.folded_decode_resample`)
in place of the decode and resample kernels: a few LSB from the exact
decode (>= 45 dB), the opt-in fast path of the reference. With `fast`
the runner's batches take the resample products in bf16 with f32 sums
(the reference's `tpu.fast`: the resample kernel's bf16 form, the torch
chain's and K11's AC pairs), >= 48 dB from the exact route.

A CMYK or YCCK JPEG takes the reference's colour management when a
profile is configured (`cmyk2rgb`) or embedded profiles are used: host
lcms2 on the decoded pixels (`icc.convert_jpeg_color_if_needed`). After
`enable_device_icc()` the default profile is sampled into an ICC LUT
that travels with the source: a 4-component JPEG the reader takes
(`jpeg_coeffs.read_jpeg_coeffs4`, not EXIF-rotated) is entropy-decoded
on the host and decoded and converted on the device
(`fused.CmykCoefBatchAssembly`: the K12a and K12b kernels) as the
prologue to the transform; an embedded profile rides its own sampled
LUT (`icc.embedded_device_lut`, kind "...@<hash>"). Every other CMYK
source converts its pixels through the same LUT
(`ops.cmyk_lut.DeviceCmykTransform`).

Under the micro-batcher a batch may be served by the host mirror
(`ops.hostexec`, within 1 LSB of the card) while the device is stalled
or wedged (`engine.batcher`). The runner flags such a request and
`process_image` appends `COLD_MARK` to its marks, which the gateway
answers with `X-Cache-Warmth: cold` and `Cache-Control: no-store` and
keeps out of its response cache. While the runner reports its device
unavailable (wedged), a YCbCr JPEG takes the pixel path: the same bytes
at a lower host cost. CMYK keeps its coefficient route (the mirror
decodes it from the staged grids); a CMYK source on the pixel route
converts through the LUT's host twin while the device is wedged
(`icc.convert_jpeg_color_if_needed(device_up=False)`).

With a `source_cache.SourceCache` (`tpu.source_cache_mb`) every decode
result (coefficient metas after their EXIF rotation, decoded and
colour-managed pixels, GIF frames) is kept by the source's content hash,
as in fanlin_tpu/engine/processor.py:140-235, so the variants of a hot
source read it once; a gateway worker's Engine has no device and sends
its batches to the device service (`server.workers.RemoteRunner`).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import cmyk_lut, filters, fused, jpeg_decode, plan as plan_mod
from ..spec import content as content_mod
from ..spec import query as query_mod
from ..utils import profiling
from . import (codecs, icc, jpeg_coeffs, jpeg_encode, native_codecs,
               png_writer, source_cache, svg)

# read_jpeg_coeffs' subsampling layout -> the coefficient batch kind
_COEF_KIND = {420: "coef", 422: "coef422", 440: "coef440", 444: "coef444"}

# The mark appended to a request's Server-Timing marks when a batch of
# it was served by the host mirror: the gateway strips it and answers
# X-Cache-Warmth: cold and Cache-Control: no-store, so no cache keeps
# bytes that may differ from the card's by 1 LSB.
COLD_MARK = "__host_mirror__"


class ProcessError(Exception):
    pass


class SyncDeviceRunner:
    """The Engine's default runner: one device batch per call, on the
    caller's thread, a lock serializing the device work. The server
    serves through batcher.BatchingRunner instead."""

    def __init__(self, device: torch.device, fast: bool = False):
        """fast: every batch's resample products in bf16 (`tpu.fast`)."""
        self.device = device
        self.fast = bool(fast)
        self._lock = threading.Lock()

    def run(self, plans: List[plan_mod.ImagePlan], images: List[np.ndarray],
            kinds: List[str] = None):
        asm = fused.make_assembly(plans, images, kinds or ["rgb"], self.device,
                                  fast=self.fast)
        with self._lock:
            return asm.run()


class Engine:
    def __init__(self, device: Optional[torch.device] = None, runner=None,
                 device_decode: bool = True, device_dct: bool = False,
                 cmyk2rgb=None, use_embedded_profile: bool = False,
                 fast_decode: bool = False, fast: bool = False):
        """device: where the transform runs (torch.device("cuda") to
        serve, torch.device("cpu") for the plain versions); None only
        with a runner that owns its device elsewhere (a gateway
        worker's server.workers.RemoteRunner: that process never
        touches a device).
        runner: runs the device batches; SyncDeviceRunner(device) when
        None, the server passes a batcher.BatchingRunner.
        device_decode: JPEGs take the coefficient path.
        device_dct: JPEG outputs take the jpegdct sink (device DCT and
        quantisation, host entropy coding only).
        fast_decode: YCbCr coefficient sources without grayscale or
        invert take the folded decode-resize (their kind gains
        fused.FOLD_SUFFIX): within a few LSB of the exact decode, not
        equal to it.
        fast: the resample products in bf16 (`tpu.fast`). The runner
        computes the batches, so it holds the switch: SyncDeviceRunner(
        device, fast) when no runner is given; a given runner must have
        been made with the same `fast` (a ValueError otherwise).
        cmyk2rgb: the default profile's icc.CMYK2RGB, or None
        (reference handler.rs:19-20); use_embedded_profile: prefer a
        CMYK JPEG's own profile."""
        if runner is None and device is None:
            raise ValueError("Engine needs a device or a runner")
        self.device = device
        if runner is None:
            runner = SyncDeviceRunner(device, fast=fast)
        elif getattr(runner, "fast", False) != fast:
            raise ValueError(f"Engine(fast={fast}) given a runner made with "
                             f"fast={getattr(runner, 'fast', False)}")
        self.runner = runner
        self.fast = fast
        self.device_decode = device_decode
        self.device_dct = device_dct
        self.fast_decode = fast_decode
        self.cmyk2rgb = cmyk2rgb
        self.use_embedded_profile = use_embedded_profile
        # the default profile sampled into a device LUT
        # (enable_device_icc); None keeps CMYK on host lcms2
        self.device_cmyk = None
        # observability (/stats "engine"): requests served by source
        # kind (the JAX Engine's `stats`); the entropy reader's work
        # (`_note_read`, under _read_lock): the JPEGs it decoded on
        # either route, its ms in its own calls, the progressive ones,
        # the scans decoded, and those it wrote straight into their slot
        # (`slot_reads`); and the requests the gateway handed to a codec
        # thread, with their summed wait for one (`note_pool_wait`, under
        # _pool_lock)
        self.stats = {"pixel_src": 0, "coef_src": 0}
        self.read_stats = {"slot_reads": 0, "reads": 0, "read_ms_total": 0.0,
                           "progressive_reads": 0, "read_scans_total": 0}
        self._read_lock = threading.Lock()
        self.pool_stats = {"requests": 0, "pool_wait_ms_total": 0.0}
        self._pool_lock = threading.Lock()
        # decoded-source cache (source_cache.SourceCache, wired from
        # tpu.source_cache_mb): hot sources served as several variants
        # pay the host decode once
        self.source_cache = None

    def enable_device_icc(self, n: int = 17) -> None:
        """Sample the default lcms2 transform into an n^4 LUT on the
        Engine's device (fanlin_tpu/engine/processor.py:82-106). CMYK
        pixels then convert through it, and 4-component JPEGs take the
        coefficient path with the LUT attached to their metas. A no-op
        without a default profile. The upload raises on failure: there
        is no host lcms2 fallback that would serve other bytes."""
        if self.cmyk2rgb is None:
            return
        lut = cmyk_lut.sample_lut(self.cmyk2rgb.convert, n)
        self.device_cmyk = cmyk_lut.DeviceCmykTransform(lut, self.device)

    def _try_cmyk_coef(self, data: bytes, orientation: int, skey=None):
        """The coefficient meta of a 4-component (CMYK / YCCK) JPEG bound
        for the device decode and LUT, with its LUT attached, else None
        (the pixel path). EXIF-rotated CMYK stays on pixels (the grids'
        rotation is for 3-component sources), as in the reference
        (fanlin_tpu/engine/processor.py:108-153).

        Profile precedence is the reference's (handler.rs:446-459): with
        use_embedded_profile set, an embedded profile that lcms2 accepts
        rides its own sampled LUT (kind "...@<key>"); a broken one falls
        back to the default profile's LUT (key "").

        skey: the source's content key when the source cache is on."""
        if (not self.device_decode or self.device_cmyk is None
                or orientation != 1):
            return None
        if icc.jpeg_num_components(data) != 4:
            return None
        scache = self.source_cache
        meta = scache.get_meta("coef4", skey) if scache is not None else None
        if meta is None:
            meta = self._read_dict(data, four=True)
            if meta is None:
                return None
            if scache is not None:
                scache.put_meta("coef4", skey, meta)
        lut = None
        if self.use_embedded_profile:
            prof = icc.jpeg_embedded_profile_bytes(data)
            if prof:
                lut = icc.embedded_device_lut(prof)
        if lut is None:
            t = self.device_cmyk
            lut = (t.lut_np, t.n, "")
        # the LUT is per request (profile) state: attach it to a copy,
        # never to a meta the source cache shares
        meta = dict(meta)
        meta["lut_flat"], meta["lut_n"], meta["lut_key"] = lut
        return meta

    def _convert_jpeg_color_if_needed(self, data: bytes,
                                      device_up: bool = True
                                      ) -> Optional[np.ndarray]:
        """CMYK/YCCK JPEG -> (H, W, 3) u8 RGB through ICC (reference
        handler.rs:398-466), or None when it does not apply. device_up
        False (a wedged device) converts through the LUT's host twin."""
        if not self.use_embedded_profile and self.cmyk2rgb is None:
            return None
        return icc.convert_jpeg_color_if_needed(
            data, self.cmyk2rgb, self.use_embedded_profile, self.device_cmyk,
            device_up)

    def _consume_cold(self) -> bool:
        fn = getattr(self.runner, "consume_host_mirror_flag", None)
        return bool(fn()) if fn is not None else False

    def _mark_cold(self, marks) -> None:
        if self._consume_cold() and marks is not None:
            marks.append((COLD_MARK, 0.0))

    def _device_up(self) -> bool:
        """Whether the runner's device is serving. False while it is
        wedged: its batches then ride the host mirror, whose numpy
        coefficient decode costs 2.6-5.9x a pixel batch's host time at
        README B=8 on an H100's host (chip_smoke.py phase 11 (e)), so a
        YCbCr JPEG decodes to pixels instead (the same bytes)."""
        avail = getattr(self.runner, "device_available", None)
        return avail() if avail is not None else True

    def process_image(
        self, data: bytes, params: query_mod.Query, accepted: content_mod.Format,
        marks: Optional[list] = None,
    ) -> Tuple[str, bytes]:
        """marks, when given, collects (name, duration_ms) sub-stage
        timings (f_decode / f_device / f_encode) for Server-Timing; each
        stage is also a span of a capture (`fanlin.engine.decode` /
        `.device` / `.encode`, on this thread, `utils.profiling`).
        f_decode ends once a coefficient source's wire is staged for the
        device, where the runner stages it (`BatchingRunner.prestage`)."""
        fmt = codecs.sniff_format(data)
        if fmt is None:
            try:
                return svg.process_unknown_format(data)
            except svg.SvgError as e:
                raise ProcessError(str(e)) from e
        if params.as_is():
            return (codecs.MIME[fmt], data)
        self._consume_cold()  # a stale flag of this thread
        if fmt == codecs.GIF:
            result = self.process_gif(data, params)
            self._mark_cold(marks)
            return result

        t0 = time.perf_counter_ns()
        orientation = codecs.read_orientation(data)
        meta = converted = src = None
        scache = self.source_cache
        prestage = getattr(self.runner, "prestage", None)
        skey = source_cache.content_key(data) if scache is not None else None
        device_up = True
        if fmt == codecs.JPEG:
            device_up = self._device_up()
            # 4-component sources: the device decode and LUT, else the
            # colour-managed pixels (handler.rs:398-466)
            meta = self._try_cmyk_coef(data, orientation, skey)
            if meta is None:
                # "icc" entries exist only for an Engine with colour
                # management (the conversion is a no-op otherwise)
                icc_on = self.use_embedded_profile or self.cmyk2rgb is not None
                hit = (scache.get_pixels("icc", skey)
                       if scache is not None and icc_on else None)
                if hit is not None:
                    converted = hit[0]
                else:
                    try:
                        converted = self._convert_jpeg_color_if_needed(
                            data, device_up)
                    except codecs.CodecError as e:
                        # the decode-alloc gate fires inside the ICC load
                        raise ProcessError(str(e)) from e
                    if converted is not None and scache is not None:
                        scache.put_pixels("icc", skey, converted, False,
                                          False)
        if (meta is None and converted is None and self.device_decode
                and device_up and fmt == codecs.JPEG):
            if prestage is not None and orientation == 1 and scache is None:
                # the slot route: the reader writes the coefficients into
                # the image's own pinned slot. A rotation reads a dict to
                # rotate, the source cache keeps one, and a runner that
                # does not stage (worker mode) sends one.
                src = self._read_into_slot(data, prestage)
                meta = src.meta if isinstance(src, fused.WireSlot) else src
            else:
                meta = self._read_meta(data, orientation, skey)
        if meta is not None:
            # a gray JPEG decodes through zero chroma (r = g = b = y);
            # is_gray keeps the output pixel type of the host decode
            has_alpha, is_gray = False, bool(meta.get("gray"))
            h, w = meta["h"], meta["w"]
            self.stats["coef_src"] += 1
        else:
            try:
                if converted is not None:
                    img, has_alpha, is_gray = converted, False, False
                else:
                    hit = (scache.get_pixels("pix", skey)
                           if scache is not None else None)
                    if hit is not None:
                        img, has_alpha, is_gray = hit
                    else:
                        img, has_alpha, is_gray = codecs.decode(data)
                        if scache is not None:
                            scache.put_pixels("pix", skey, img, has_alpha,
                                              is_gray)
            except codecs.CodecError as e:
                raise ProcessError(str(e)) from e
            img = np.ascontiguousarray(
                codecs.apply_orientation(img, orientation))
            h, w = img.shape[:2]
            self.stats["pixel_src"] += 1
        # a coefficient source's wire staged here, on this thread (inside
        # f_decode), where the runner stages it
        if meta is None:
            src = img
        elif src is None:
            src = meta if prestage is None else prestage(meta)
        self._stage("f_decode", "fanlin.engine.decode", t0,
                    time.perf_counter_ns(), marks)
        plan, kind, out_fmt, mode = self._route(
            params, accepted, fmt, w, h, has_alpha, is_gray, meta)

        t1 = time.perf_counter_ns()
        out = self.runner.run([plan], [src], [kind])[0]
        t2 = time.perf_counter_ns()
        self._stage("f_device", "fanlin.engine.device", t1, t2, marks)
        try:
            payload = self._encode(out, out_fmt, params.quality(), mode)
        except codecs.CodecError as e:
            raise ProcessError(str(e)) from e
        self._stage("f_encode", "fanlin.engine.encode", t2,
                    time.perf_counter_ns(), marks)
        self._mark_cold(marks)
        return (codecs.MIME[out_fmt], payload)

    def _read_meta(self, data: bytes, orientation: int, skey):
        """The dict route of a JPEG: its read_jpeg_coeffs dict, rotated
        to its EXIF orientation, from the source cache where it has one;
        None for the pixel path."""
        scache = self.source_cache
        # the kind carries the orientation: a hot EXIF-rotated source is
        # cached after its rotation. A rotation that is not grid-exact
        # caches a pixel-only sentinel, so the reader does not run again
        # per variant only to find the pixel path.
        ckind = "coef" if orientation == 1 else "coef.o%d" % orientation
        cached = scache.get_meta(ckind, skey) if scache is not None else None
        if cached is not None:
            return None if cached.get("_pixel_only") else cached
        meta = self._read_dict(data)
        if meta is not None and orientation != 1:
            # rotate the coefficient grids; a flip that is not MCU-aligned
            # gives None and the pixel path
            meta = jpeg_decode.orient_meta(meta, orientation)
        if scache is not None:
            scache.put_meta(ckind, skey, meta if meta is not None
                            else {"_pixel_only": True})
        return meta

    def _read_dict(self, data: bytes, four: bool = False, spent_ns: int = 0):
        """The reader's dict of a JPEG (`read_jpeg_coeffs`, with `four`
        `read_jpeg_coeffs4`), or None; counted in `read_stats` with
        `spent_ns` of the reader's calls made before it."""
        t0 = time.perf_counter_ns()
        got = jpeg_coeffs.read_dict(data, four)
        if got is None:
            return None
        self._note_read(got.head, got.scans,
                        spent_ns + time.perf_counter_ns() - t0)
        return got.meta

    def _note_read(self, head, scans: int, ns: int, slot: bool = False):
        """A JPEG the reader decoded: `head` its header, `scans` the
        scans decoded, `ns` the time of the reader's calls alone; `slot`
        where it wrote straight into the image's slot."""
        with self._read_lock:
            s = self.read_stats
            s["reads"] += 1
            s["read_ms_total"] += ns / 1e6
            s["progressive_reads"] += int(head.progressive)
            s["read_scans_total"] += scans
            s["slot_reads"] += int(slot)

    def _read_into_slot(self, data: bytes, prestage):
        """The slot route of a JPEG: the reader writes its coefficients
        once, straight into the image's own pinned `fused.WireSlot`
        (`prestage` of its header), counted in `read_stats` (the time of
        the header and decode calls, not the slot's making between them)
        and, while a capture runs, the span `fanlin.engine.read` (its two
        calls and the slot's making; the bytes written, whether the
        stream is progressive, its scans). Returns the slot; the
        read_jpeg_coeffs dict when no pinned memory is to be had (the
        device thread then stages it); None when the reader refuses the
        stream (the pixel path; a slot is dropped)."""
        t0 = time.perf_counter_ns()
        head = jpeg_coeffs.read_header(data)
        t1 = time.perf_counter_ns()
        if head is None:
            return None
        slot = prestage(head)
        if not isinstance(slot, fused.WireSlot):
            return self._read_dict(data, spent_ns=t1 - t0)
        t2 = time.perf_counter_ns()
        scans = jpeg_coeffs.read_into_slot(data, head, slot)
        t3 = time.perf_counter_ns()
        if scans is None:
            return None
        self._note_read(head, scans, t1 - t0 + t3 - t2, slot=True)
        if profiling.on():
            profiling.record("fanlin.engine.read", t0, t3,
                             rid=profiling.REQUEST_ID.get(),
                             bytes=sum(g.nbytes for g in slot.true_grids),
                             progressive=head.progressive, scans=scans)
        return slot

    def _route(self, params, accepted, fmt, w, h, has_alpha, is_gray, meta):
        """The plan, the batch kind, the output format and mode of a
        decoded source (`meta`: its coefficient meta, None for pixels)."""
        plan = plan_mod.plan_image(w, h, params, filters.LANCZOS3,
                                   opaque=not has_alpha)
        mode = self._output_mode(params, plan, has_alpha, is_gray)
        out_fmt = fmt
        if params.use_webp() and accepted.webp_accepted():
            out_fmt = codecs.WEBP
        elif params.use_avif() and accepted.avif_accepted():
            out_fmt = codecs.AVIF
        kind = self._sink(params, plan, out_fmt, mode)
        if meta is not None:
            if meta.get("cmyk"):
                # plain CMYK and YCCK never share a batch, nor do two
                # profiles' LUTs
                base = "cmyk%d%s" % (meta["subsamp"],
                                     "y" if meta["ycck"] else "")
                if meta["lut_key"]:
                    base += "@" + meta["lut_key"]
            else:
                base = _COEF_KIND[meta["subsamp"]]
                # the decision travels in the kind: folded and staged
                # requests never share a batch
                if self.fast_decode and not (plan.gray or plan.invert):
                    base += fused.FOLD_SUFFIX
            kind = base if kind == "rgb" else f"{base}+{kind}"
        return plan, kind, out_fmt, mode

    @staticmethod
    def _stage(mark: str, span: str, t0_ns: int, t1_ns: int, marks) -> None:
        """One stage of process_image from one pair of clock reads: its
        Server-Timing mark (when `marks` is given) and its span."""
        if marks is not None:
            marks.append((mark, (t1_ns - t0_ns) / 1e6))
        if profiling.on():
            profiling.record(span, t0_ns, t1_ns,
                             rid=profiling.REQUEST_ID.get())

    def note_pool_wait(self, t_submit_ns: int, t_start_ns: int) -> None:
        """A request handed to a codec thread at `t_submit_ns` started
        there at `t_start_ns` (`server.state`): counted in `pool_stats`
        (`requests`, `pool_wait_ms_total`) and its
        `fanlin.engine.pool_wait` span."""
        with self._pool_lock:
            self.pool_stats["requests"] += 1
            self.pool_stats["pool_wait_ms_total"] += (t_start_ns
                                                      - t_submit_ns) / 1e6
        if profiling.on():
            profiling.record("fanlin.engine.pool_wait", t_submit_ns,
                             t_start_ns, profiling.REQUEST_ID.get())

    def _sink(self, params, plan, out_fmt: str, mode: str) -> str:
        """The batch kind: which encode front-end runs on the device
        (the host then finishes with entropy coding only). The reference
        gates jpegdct on its native libjpeg build; the port's encoder
        needs no libjpeg and builds wherever a C++ compiler does."""
        if out_fmt == codecs.JPEG and mode in ("RGB", "RGBA"):
            if self.device_dct:
                return f"jpegdct:{min(max(params.quality(), 1), 100)}"
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
        if isinstance(out, tuple) and out[0] == "coeffs":
            _, yc, cbc, crc, w, h, q = out
            payload = jpeg_encode.encode_jpeg_coeffs(yc, cbc, crc, w, h, q)
            if payload is None:
                raise codecs.CodecError("coefficient jpeg encode failed")
            return payload
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
        scache = self.source_cache
        frames = skey = None
        if scache is not None:
            skey = source_cache.content_key(data)
            frames = scache.get_frames(skey)
        if frames is None:
            try:
                frames = codecs.decode_gif_frames(data)
            except codecs.CodecError as e:
                raise ProcessError(str(e)) from e
            if scache is not None:
                scache.put_frames(skey, frames)

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
