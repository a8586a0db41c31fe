"""The encode tails and the batch assembly.

Port of fanlin_tpu/ops/fused.py: the encode front-ends
(`_ycbcr420_tail`, `_png_tail`, `_webp420_tail`, fused.py:431-596, and
the jpegdct tail of `_make_tail`, :521-547, with the DCT in `ops.dct`),
`BatchAssembly` for pixel sources (fused.py:1112-1525),
`CoefBatchAssembly` for JPEG coefficient sources (fused.py:1695-1829,
2065-2166) and `CmykCoefBatchAssembly` for 4-component ones
(fused.py:2169-2366). The chain itself (fused.py:307-430) is in `ops.chain`. The
reference runs each batch as one jitted XLA program; here the same
steps run eagerly on the assembly's device.

Transfers: on CUDA a batch is staged straight into pinned host buffers,
and `submit()` issues the uploads, the kernels and
the downloads as non-blocking work on the caller's current stream,
then records an event; `collect()` only waits on that event and copies
each image's result out of the pinned buffers, so the batcher's collect
thread never touches a device tensor. On the CPU (tests) the same code
runs on plain host arrays with no event. Each coefficient image has
one host wire, a pinned `WireSlot` of its own, written by the entropy
reader on the thread that read the image, or made from a dict by that
thread or by the assembly; a batch uploads its real images' slots
alone. The padded matrices of a uniform batch's plan stay
on the device, keyed by the plan's content (`_uniform_device`).

Routing: a coefficient batch is decoded on the device by the decode
kernel (`jpeg_decode_kernels.jpeg_decode_rgb`), which writes the same
(B, 3, SH, SW) u8 batch a pixel upload would give; a CMYK one by
`jpeg_decode_cmyk_rgb`, the 4-component decode that converts through the
packed ICC LUT in its colour stage, which writes the same batch. Every
uniform batch of opaque (3-channel) sources then goes through the hand-
written CUDA resample kernel (`resample_kernels.resample_uniform`),
whatever its encode tail; the kernel writes 3 channels and a constant
255 alpha plane is appended where the batch downloads 4. Alpha sources,
GIF frames and non-uniform batches run the torch chain of `ops.chain`.
A uniform coefficient batch without grayscale or invert whose kind asks
for the fold (`tpu.fast_decode`) takes neither kernel: its decode and
resample run as the folded matrix products of
`jpeg_decode.folded_decode_resample` (K11, fanlin_tpu/ops/fused.py
:759-828), then the chain's composite and blur.

`fast` (`tpu.fast`): every assembly made with it runs the resample
products in bf16 with f32 sums, the reference's `_mm_dtype` (fused.py
:298, :343-349): the resample kernel's bf16 form, the chain's, and K11's
AC pairs. The Engine's runner holds it; nothing here is process-wide.
"""

from __future__ import annotations

import copy
import re

import numpy as np
import torch

from ..utils import profiling
from ..utils.bytelru import ByteLRU
from . import (cmyk_lut, dct, filters, jpeg_decode, jpeg_decode_kernels,
               resample_kernels)
from .chain import (_post_resample, _transform_kernel,
                    _transform_kernel_uniform)
from .plan import (_folded_padded, _pack_params, _uniform_entry, bucket_b,
                   bucket_h, bucket_h16, bucket_w, plan_image, uniform_key)

_F32 = torch.float32
_I32 = torch.int32


def _sub2(c: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, ceil(H/2), ceil(W/2)) 2x2 sums, odd edges
    replicated."""
    if c.shape[1] % 2:
        c = torch.cat([c, c[:, -1:, :]], dim=1)
    if c.shape[2] % 2:
        c = torch.cat([c, c[:, :, -1:]], dim=2)
    bsz, h, w = c.shape
    c = c.reshape(bsz, h // 2, 2, w // 2, 2)
    return c[:, :, 0, :, 0] + c[:, :, 0, :, 1] + c[:, :, 1, :, 0] + c[:, :, 1, :, 1]


def _ycbcr420_tail(out_u8):
    """JPEG encode front-end: RGB -> full-range BT.601 YCbCr + 2x2
    chroma box subsampling. The host finishes with entropy coding only.

    out_u8: (B, C>=3, OH, OW) u8, cropped to the true dims.
    Returns (Y (B,OH,OW), Cb (B,ceil(OH/2),ceil(OW/2)), Cr) u8.
    """
    f = out_u8[:, :3].to(_F32)
    r, g, b = f[:, 0], f[:, 1], f[:, 2]
    yy = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168735892 * r - 0.331264108 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418687589 * g - 0.081312411 * b

    def to_u8(v):
        return torch.clamp(torch.floor(v + 0.5), 0, 255).to(torch.uint8)

    return to_u8(yy), to_u8(_sub2(cb) * 0.25), to_u8(_sub2(cr) * 0.25)


def _png_tail(out_u8, nch: int):
    """PNG encode front-end: per-scanline adaptive filter choice. All
    five PNG filters are computed mod 256 and scored by the minimum sum
    of absolute differences (ties -> lowest index, like the image
    crate's FilterType::Adaptive); the host runs zlib only.

    out_u8: (B, C, OH, OW) u8, cropped to the true dims. nch: PNG
    channels (1 L / 2 LA / 3 RGB / 4 RGBA); a missing alpha plane is
    synthesized. Returns (B, OH, 1 + OW*nch) u8 scanline rows.
    """
    b, have, h, w = out_u8.shape
    if nch == 1:
        px = out_u8[:, :1]
    elif nch == 3:
        px = out_u8[:, :3]
    else:
        rgb = out_u8[:, :1] if nch == 2 else out_u8[:, :3]
        if have >= 4:
            alpha = out_u8[:, 3:4]
        else:
            alpha = torch.full((b, 1, h, w), 255, dtype=torch.uint8,
                               device=out_u8.device)
        px = torch.cat([rgb, alpha], dim=1)
    c = px.shape[1]
    x = px.permute(0, 2, 3, 1).reshape(b, h, w * c).to(_I32)
    left = torch.nn.functional.pad(x, (c, 0))[:, :, : w * c]
    up = torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :h]
    ul = torch.nn.functional.pad(x, (c, 0, 1, 0))[:, :h, : w * c]
    f1 = (x - left) & 255
    f2 = (x - up) & 255
    f3 = (x - ((left + up) >> 1)) & 255
    p = left + up - ul
    pa = torch.abs(p - left)
    pb = torch.abs(p - up)
    pc = torch.abs(p - ul)
    paeth = torch.where((pa <= pb) & (pa <= pc), left,
                        torch.where(pb <= pc, up, ul))
    f4 = (x - paeth) & 255
    cands = torch.stack([x, f1, f2, f3, f4], dim=2)  # (B, H, 5, L)
    score = torch.minimum(cands, 256 - cands).sum(dim=3)  # (B, H, 5)
    idx = torch.argmin(score, dim=2)  # first minimum on ties
    sel = torch.gather(
        cands, 2, idx[:, :, None, None].expand(b, h, 1, w * c)
    )[:, :, 0]
    return torch.cat([idx[:, :, None].to(torch.uint8), sel.to(torch.uint8)],
                     dim=2)


def _webp420_tail(out_u8):
    """WebP encode front-end: RGB -> libwebp's limited-range BT.601 YUV
    (the fixed-point VP8RGBToY/U/V of src/dsp/yuv.h) + 2x2 chroma with
    libwebp's SUM4 rounding. The host encodes via the YUV import path.

    out_u8: (B, C>=3, OH, OW) u8, cropped to the true dims.
    Returns (Y (B,OH,OW), U (B,ceil/2,ceil/2), V) u8.
    """
    p = out_u8[:, :3].to(_I32)
    r, g, b = p[:, 0], p[:, 1], p[:, 2]
    y = (16839 * r + 33059 * g + 6420 * b + 32768 + (16 << 16)) >> 16
    rs, gs, bs = ((_sub2(c) + 2) >> 2 for c in (r, g, b))
    u = (-9719 * rs - 19081 * gs + 28800 * bs + 32768 + (128 << 16)) >> 16
    v = (28800 * rs - 24116 * gs - 4684 * bs + 32768 + (128 << 16)) >> 16

    def to_u8(t):
        return torch.clamp(t, 0, 255).to(torch.uint8)

    return to_u8(y), to_u8(u), to_u8(v)


def _jpegdct_tail(out_u8, quality: int):
    """The device JPEG back half (K9): the YCbCr 4:2:0 front-end, then
    edge pad, level shift, 8x8 DCT and quantisation with the encoder's
    tables at `quality`. Returns the three (B, padded H, padded W) int16
    planar coefficient planes (the reference's pack level 2)."""
    return dct.ycbcr420_to_planar(
        *_ycbcr420_tail(out_u8),
        *dct.device_quant_tables(quality, out_u8.device))


def _tail(out, c_out: int, sink):
    """The encode front-end selected by `sink` (False = pixels), or the
    pixel batch trimmed/extended to `c_out` channels."""
    if isinstance(sink, tuple):
        if sink[0] == "jpegdct":
            return _jpegdct_tail(out, sink[1])
        return _png_tail(out, sink[1])
    if sink == "webp":
        return _webp420_tail(out)
    if sink:
        return _ycbcr420_tail(out)
    if out.shape[1] < c_out:
        alpha = torch.full_like(out[:, :1], 255)
        out = torch.cat([out, alpha], dim=1)
    return out[:, :c_out]


def _upload_pageable(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A blocking copy of a host array to the device: complete before any
    stream reads it (batches of several runners, each on its own stream,
    share the caches); from pageable memory, counted in the batcher's
    tally."""
    with profiling.span("fanlin.assembly.pageable_upload", bytes=arr.nbytes):
        dev = torch.from_numpy(arr).to(device)
    profiling.note("pageable_uploads")
    profiling.note("pageable_bytes", arr.nbytes)
    return dev


def _keep_for_stream(dev: torch.Tensor, device: torch.device) -> None:
    if device.type == "cuda":
        # an eviction must not free it under another stream's reads
        dev.record_stream(torch.cuda.current_stream(device))


# Device copies of the folded matrices and packed LUTs, keyed by the
# host array's identity (the array is kept in the value so a live id
# cannot collide).
_DEVICE_MATRIX_CACHE = ByteLRU(max_bytes=256 * 1024 * 1024)


def _device_cached(arr, device: torch.device):
    if arr is None:
        return None
    key = (id(arr), str(device))
    hit = _DEVICE_MATRIX_CACHE.get(key)
    if hit is not None and hit[0] is arr:
        dev = hit[1]
    else:
        dev = _upload_pageable(arr, device)
        _DEVICE_MATRIX_CACHE.put(key, (arr, dev), arr.nbytes)
    _keep_for_stream(dev, device)
    return dev


# The padded matrices of uniform batches (plan._uniform_padded and their
# band ranges) resident on the device, keyed by the plan's content
# (`plan.uniform_key`), so a plan object rebuilt with equal content, or
# evicted from the host caches, finds its copy still there. The budget
# holds the warmed plans of any configuration with room to spare: the
# five camera srcset plans (4032x3024 -> 640..1200) take 119.5 MiB of
# an 80 GB card.
_RESIDENT = ByteLRU(max_bytes=1024 * 1024 * 1024)


def _uniform_device(plan, device: torch.device):
    """(av, ah, bv, bh, bands) of a uniform batch's plan on `device` (bv,
    bh None without blur). A miss builds the host matrices (counted as a
    plan rebuild when the host cache misses too) and uploads each once
    from pageable memory."""
    key = (uniform_key(plan), str(device))
    mats = _RESIDENT.get(key)
    if mats is None:
        value, bands = _uniform_entry(plan)
        host = (*value, bands)
        mats = tuple(None if a is None else _upload_pageable(a, device)
                     for a in host)
        _RESIDENT.put(key, mats,
                      sum(a.nbytes for a in host if a is not None))
    for m in mats:
        if m is not None:
            _keep_for_stream(m, device)
    return mats


# The packed form (cmyk_lut.pack_lut) of each f32 LUT array the metas and
# DeviceCmykTransform carry, on the host, keyed like _device_cached by
# the array's identity; its device copy is _device_cached's.
_PACKED_LUT_CACHE = ByteLRU(max_bytes=64 * 1024 * 1024)


def _device_packed_lut(arr: np.ndarray, n: int, device: torch.device):
    key = id(arr)
    hit = _PACKED_LUT_CACHE.get(key)
    if hit is not None and hit[0] is arr:
        packed = hit[1]
    else:
        packed = cmyk_lut.pack_lut(arr, n).numpy()
        _PACKED_LUT_CACHE.put(key, (arr, packed), packed.nbytes)
    return _device_cached(packed, device)


class _Transfer:
    """The host side of one batch: the arrays it uploads and the host
    copies of its result. On CUDA every array lives in a pinned buffer
    (torch's caching host allocator, which reuses a freed block only
    after the copies recorded on it have finished); uploads and
    downloads are non-blocking copies on the current stream, ordered by
    an event recorded after the downloads. A download's numpy view keeps
    its buffer alive until collect() has copied each image out. On the
    CPU (tests) the arrays are plain numpy, the device tensors share
    their memory and there is no event."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        # id(array) -> (array, its pinned buffer); holding the array
        # keeps its id from being reused
        self._staged = {}
        self.event = None

    def zeros(self, shape, dtype=np.float32) -> np.ndarray:
        """A zeroed host array to stage into (numpy.zeros' signature)."""
        if not self.pinned:
            return np.zeros(shape, dtype)
        dtype = np.dtype(dtype)
        buf = torch.empty(int(np.prod(shape)) * dtype.itemsize,
                          dtype=torch.uint8, pin_memory=True)
        arr = buf.numpy().view(dtype).reshape(shape)
        arr.fill(0)
        self._staged[id(arr)] = (arr, buf)
        return arr

    def upload(self, arr):
        """A staged array on the device."""
        if arr is None:
            return None
        if not self.pinned:
            return torch.from_numpy(arr).to(self.device)
        _, buf = self._staged[id(arr)]
        dev = buf.to(self.device, non_blocking=True)
        # the flat bytes, viewed as the array's dtype and shape
        return dev.view(torch.from_numpy(arr[:0]).dtype).view(arr.shape)

    def download(self, out):
        """Start copying the device result (a tensor or a tuple of them)
        to the host; returns the host arrays, readable after wait()."""
        outs = out if isinstance(out, tuple) else (out,)
        if not self.pinned:
            host = tuple(o.cpu().numpy() for o in outs)
        else:
            host = []
            for o in outs:
                buf = torch.empty(o.numel() * o.element_size(),
                                  dtype=torch.uint8, pin_memory=True)
                h = buf.view(o.dtype).view(o.shape)
                h.copy_(o, non_blocking=True)
                host.append(h.numpy())
            host = tuple(host)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(self.device))
        return host if isinstance(out, tuple) else host[0]

    def wait(self) -> None:
        """Block until the batch's copies are done (touches no device
        tensor, so any thread may call it)."""
        if self.event is not None:
            self.event.synchronize()


class BatchAssembly:
    """Host staging for one device batch of pixel sources.

    `submit()` uploads the staged arrays, runs the batch on the device
    and starts the download, all asynchronously on the caller's current
    CUDA stream; `collect()` waits on the batch's event and returns
    per-image host arrays that own their memory. The device thread of
    the batcher submits the next batch while another thread collects
    this one."""

    def __init__(self, plans, images, device: torch.device, jpeg420=False,
                 fast=False):
        """plans: list[ImagePlan]; images: list[(H, W, 3|4) uint8].

        jpeg420: False (pixels out), True (JPEG YCbCr 4:2:0 front-end),
        "webp" (WebP-range YUV 4:2:0), ("png", N) (PNG filter
        front-end, N channels) or ("jpegdct", Q) (the front-end, DCT and
        quantisation at quality Q: coefficient planes out). The sinks
        need one true output geometry per batch; a batch without it
        downloads pixels. fast: the resample products in bf16."""
        if len(plans) != len(images) or not plans:
            raise ValueError("one plan per image, at least one image")
        self.plans = plans
        self.device = device
        self.fast = bool(fast)
        self._io = _Transfer(device)
        n = len(plans)
        self.b = bucket_b(n)
        self.sh = bucket_h(max(p.src_h for p in plans))
        self.sw = bucket_w(max(p.src_w for p in plans))
        self.oh = bucket_h(max(p.out_h for p in plans))
        self.ow = bucket_w(max(p.out_w for p in plans))
        self.has_blur = any(p.blur_sigma > 0 for p in plans)
        # uniform batch: every image shares one (cached) plan object
        self.uniform = all(p is plans[0] for p in plans)
        p0 = plans[0]
        geometry_uniform = all(
            p.out_h == p0.out_h and p.out_w == p0.out_w for p in plans
        )
        self.jpeg420 = jpeg420 if geometry_uniform else False
        # alpha plane is downloaded only when some image needs it ...
        self.c_out = 4 if any(p.want_alpha for p in plans) else 3
        # ... and uploaded only when some source actually has one
        self.c_in = 4 if any(im.shape[2] == 4 for im in images) else 3

        self.x = self._io.zeros((self.b, self.c_in, self.sh, self.sw),
                                np.uint8)
        (self.flags, self.fill, self.box,
         self.av, self.ah, self.bv, self.bh) = _pack_params(
            plans, self.b, self.sh, self.sw, self.oh, self.ow,
            self.uniform, self.has_blur, zeros=self._io.zeros,
        )
        for i, (p, img) in enumerate(zip(plans, images)):
            c = img.shape[2]
            self.x[i, :c, : p.src_h, : p.src_w] = img.transpose(2, 0, 1)
            if c == 3 and self.c_in == 4:
                self.x[i, 3, : p.src_h, : p.src_w] = 255

    def uses_kernel(self) -> bool:
        """True when this batch runs the CUDA resample kernel (on a CUDA
        device; the CPU runs its plain version)."""
        return self.uniform and self.c_in == 3

    @property
    def upload_bytes(self) -> int:
        """Host->device bytes of the pixel wire."""
        return self.x.nbytes

    def uniform_matrices(self):
        """(av, ah, bv, bh, bands) of a uniform batch's plan on the device
        (`_uniform_device`)."""
        return _uniform_device(self.plans[0], self.device)

    def _device_x(self):
        """The (B, c_in, sh, sw) u8 source batch on the device."""
        return self._io.upload(self.x)

    def submit(self):
        """Upload the batch, run the chain and tail on the device and
        start the download, on the current stream (asynchronously on
        CUDA). Returns the pending host result for collect()."""
        dev = self.device
        x = self._device_x()
        flags, fill, box = (self._io.upload(a)
                            for a in (self.flags, self.fill, self.box))
        p0 = self.plans[0]
        if self.uniform:
            av, ah, bv, bh, bands = self.uniform_matrices()
            if self.uses_kernel():
                out = resample_kernels.resample_uniform(
                    flags, fill, box, av, ah, x, bv, bh,
                    crop=(p0.out_h, p0.out_w), bands=bands, fast=self.fast,
                )
            else:
                out = _transform_kernel_uniform(x, av, ah, flags, fill, box,
                                                bv, bh, fast=self.fast)
                out = out[:, :, : p0.out_h, : p0.out_w]
        else:
            up = self._io.upload
            out = _transform_kernel(x, up(self.av), up(self.ah), flags, fill,
                                    box, up(self.bv), up(self.bh),
                                    fast=self.fast)
            if self.jpeg420:
                out = out[:, :, : p0.out_h, : p0.out_w]
        return self._io.download(_tail(out, self.c_out, self.jpeg420))

    def collect(self, out):
        """Wait for the batch and return per-image results that own
        their memory: (out_h, out_w, c_out) u8 arrays, or
        ("ycbcr420"|"webpyuv", y, cb, cr) / ("pngrows", rows, w, h, nch)
        / ("coeffs", y, cb, cr, w, h, q) tuples for the host encoders
        (coefficients as (rows, cols, 64) int16 block grids). Touches no
        device tensor."""
        self._io.wait()
        n = len(self.plans)
        p0 = self.plans[0]
        if isinstance(self.jpeg420, tuple) and self.jpeg420[0] == "jpegdct":
            # out: three (B, PH, PW) int16 planar planes
            res = [("coeffs",
                    *(dct.blocks_from_planar(o[i]) for o in out),
                    p0.out_w, p0.out_h, self.jpeg420[1]) for i in range(n)]
        elif isinstance(self.jpeg420, tuple):
            # out: (B, OH, 1 + OW*nch) rows
            res = [("pngrows", out[i].copy(), p0.out_w, p0.out_h,
                    self.jpeg420[1]) for i in range(n)]
        elif self.jpeg420:
            tag = "webpyuv" if self.jpeg420 == "webp" else "ycbcr420"
            y, cb, cr = out
            res = [(tag, y[i].copy(), cb[i].copy(), cr[i].copy())
                   for i in range(n)]
        else:
            # out: (B, C, OH|true_oh, OW|true_ow)
            res = [out[i, :, : p.out_h, : p.out_w].transpose(1, 2, 0).copy()
                   for i, p in enumerate(self.plans)]
        return res

    def wait(self) -> None:
        """Block until the submitted batch's copies are done (collect()
        waits too; touches no device tensor)."""
        self._io.wait()

    def run(self):
        return self.collect(self.submit())

    def replica(self):
        """A copy that shares this batch's staged host arrays and has a
        transfer state of its own: running it again (the batcher's
        recovery probe) leaves an earlier run's pending download and
        event to whoever still waits on them."""
        twin = copy.copy(self)
        twin._io = copy.copy(self._io)
        twin._io.event = None
        return twin


def _wire_shapes(h: int, w: int, subsamp: int, planes) -> list:
    """(rows, cols) of each plane's block grid in a coefficient wire: the
    bucket's block grid (luma bucket_h16 / 8 by bucket_w / 8, chroma
    divided by chroma_divisors; a CMYK K plane at luma's)."""
    dv, dh = jpeg_decode.chroma_divisors(subsamp)
    gh, sw = bucket_h16(h), bucket_w(w)
    luma = (gh // 8, sw // 8)
    chroma = (gh // (8 * dv), sw // (8 * dh))
    return [chroma if key in ("cb", "cr") else luma for key in planes]


_Q_BYTES = 2 * 64 * 4  # an image's quant tables: (2, 64) int32
_PLANES = ("y", "cb", "cr")  # a meta's block grids, in wire order
_CMYK_PLANES = _PLANES + ("k",)


def _meta(payload) -> dict:
    """The read_jpeg_coeffs dict of a coefficient payload (a dict or a
    WireSlot)."""
    return payload.meta if isinstance(payload, WireSlot) else payload


class WireSlot:
    """One image's coefficient wire in one host buffer of its own (pinned
    on CUDA, from torch's caching host allocator, which hands a block out
    again only after the copies recorded on it have finished): each plane
    of its assembly's PLANES (K too for a CMYK meta) at the bucket's block
    grid, then the quant tables (luma, chroma). The blocks past the
    image's true grids are zeroed: a reused block holds an earlier
    image's bytes, and the folded route and the CPU's plain decode read
    the padding. A dict's true grids and tables are copied in
    (`WireSlot(meta, pinned)`); an `empty` slot's are written by the
    entropy reader itself (`engine.jpeg_coeffs.read_into_slot`). The slot
    lives as long as something holds it: its batch, a stalled batch's
    mirror."""

    def __init__(self, meta, pinned: bool):
        """A slot holding a read_jpeg_coeffs (or read_jpeg_coeffs4) dict."""
        keys = _CMYK_PLANES if meta.get("cmyk") else _PLANES
        self._layout(meta["h"], meta["w"], meta["subsamp"], keys,
                     [meta[key].shape[:2] for key in keys], pinned)
        for grid, key in zip(self.true_grids, keys):
            grid[...] = meta[key]
        self.q[0] = meta["lq"]
        self.q[1] = meta["cq"]
        self.meta = meta

    @classmethod
    def empty(cls, h: int, w: int, subsamp: int, grids, pinned: bool):
        """A YCbCr image's slot made before its coefficients are read:
        `grids` gives the true (rows, cols) of each plane the reader
        writes, y, cb and cr, or y alone for a gray source (whose chroma
        planes stay zero). The reader writes `true_grids`, then `hold`
        adds the tables and the meta."""
        slot = cls.__new__(cls)
        slot._layout(h, w, subsamp, _PLANES, grids, pinned)
        slot.meta = None
        return slot

    def _layout(self, h, w, subsamp, keys, grids, pinned):
        shapes = _wire_shapes(h, w, subsamp, keys)
        sizes = [r * c * 64 * 2 for r, c in shapes]
        self.buf = torch.empty(sum(sizes) + _Q_BYTES, dtype=torch.uint8,
                               pin_memory=pinned)
        arr = self.buf.numpy()
        words = self.buf.view(torch.int16)
        # each plane as a numpy grid and as flat int16 words (what the
        # upload copies), its true grid as a view, then the tables' words
        self.grids, self.planes, self.true_grids = [], [], []
        at = 0
        for i, (key, (r, c), n) in enumerate(zip(keys, shapes, sizes)):
            grid = arr[at:at + n].view(np.int16).reshape(r, c, 64)
            gr, gc = grids[i] if i < len(grids) else (0, 0)
            if gr > r or gc > c:
                raise ValueError(f"{key} grid {gr}x{gc} exceeds the "
                                 f"bucket's {r}x{c}")
            grid[gr:] = 0
            grid[:gr, gc:] = 0
            self.grids.append(grid)
            self.planes.append(words[at // 2:(at + n) // 2])
            if i < len(grids):
                self.true_grids.append(grid[:gr, :gc])
            at += n
        self.q = arr[at:].view(np.int32).reshape(2, 64)
        self.q_words = words[at // 2:]
        self.h, self.w, self.subsamp = h, w, subsamp

    def hold(self, lq, cq, gray: bool) -> None:
        """The reader has written an `empty` slot's true grids: its
        tables go in, and its meta is the read_jpeg_coeffs dict, with
        views of the slot's grids (a gray source's chroma: the zero
        planes at the luma grid)."""
        self.q[0] = lq
        self.q[1] = cq
        y = self.true_grids[0]
        if gray:
            cb, cr = (g[:y.shape[0], :y.shape[1]] for g in self.grids[1:])
        else:
            cb, cr = self.true_grids[1:]
        self.meta = {"y": y, "cb": cb, "cr": cr, "lq": lq, "cq": cq,
                     "w": self.w, "h": self.h, "subsamp": self.subsamp,
                     "gray": gray}

    @property
    def nbytes(self) -> int:
        return self.buf.numel()


class CoefBatchAssembly(BatchAssembly):
    """Host staging for one device batch of JPEG coefficient sources:
    the host half of fanlin_tpu/ops/fused.py CoefBatchAssembly
    (:1695-1829, :2065-2166). The device `x` comes from the decode
    kernel (`jpeg_decode_rgb`) instead of an upload of pixels;
    everything after it is BatchAssembly's.

    The wire is the simplest lossless one: int16 natural-order block
    grids, zero-padded to the bucket's block grid (luma bucket_h16 / 8
    by bucket_w / 8, chroma divided by chroma_divisors), and the quant
    tables as (B, 2, 64) int32. Each real image's share of it is a
    WireSlot of its own, which the batch uploads alone; the kernel reads
    only the blocks of the true rect of the batch's real images."""

    PLANES = _PLANES

    def __init__(self, plans, payloads, device: torch.device, jpeg420=False,
                 fold=False, fast=False):
        """payloads: read_jpeg_coeffs dicts (either package's), all of one
        (w, h) and subsamp, or WireSlots made from such dicts (the
        batcher's `prestage`); each dict is staged here into a slot of
        its own. jpeg420: as for BatchAssembly. fold: take the folded
        decode-resize (`tpu.fast_decode`) where the batch allows it:
        uniform, with no grayscale or invert, which need the decoded
        pixels (the gate of fanlin_tpu/ops/fused.py:1737-1744). fast: as
        for BatchAssembly, K11's AC pairs included."""
        if len(plans) != len(payloads) or not plans:
            raise ValueError("one plan per source, at least one source")
        metas = [_meta(p) for p in payloads]
        m0 = metas[0]
        self.true_h, self.true_w, self.subsamp = m0["h"], m0["w"], m0["subsamp"]
        if any((m["h"], m["w"], m["subsamp"]) !=
               (self.true_h, self.true_w, self.subsamp) for m in metas):
            raise ValueError("a coefficient batch holds one source geometry "
                             "and subsampling layout")
        self.plans = plans
        self.device = device
        self.fast = bool(fast)
        self._io = _Transfer(device)
        self.b = bucket_b(len(plans))
        # the decode writes the pixel batch's layout, so the resample
        # sees what a pixel batch of this source would upload
        self.sh = bucket_h(self.true_h)
        self.sw = bucket_w(self.true_w)
        self.oh = bucket_h(max(p.out_h for p in plans))
        self.ow = bucket_w(max(p.out_w for p in plans))
        self.has_blur = any(p.blur_sigma > 0 for p in plans)
        p0 = plans[0]
        self.uniform = all(p is p0 for p in plans)
        geometry_uniform = all(
            p.out_h == p0.out_h and p.out_w == p0.out_w for p in plans
        )
        self.jpeg420 = jpeg420 if geometry_uniform else False
        self.c_out = 4 if any(p.want_alpha for p in plans) else 3
        self.c_in = 3
        self.fold = bool(fold) and self.uniform and not (p0.gray or
                                                         p0.invert)
        self._shapes = _wire_shapes(self.true_h, self.true_w, self.subsamp,
                                    self.PLANES)
        # the real images' wires, in batch order: the given slots, and a
        # slot staged here for each dict
        pinned = device.type == "cuda"
        self.wires = [p if isinstance(p, WireSlot) else WireSlot(p, pinned)
                      for p in payloads]
        self.q = np.zeros((self.b, 2, 64), np.int32)
        for i, wire in enumerate(self.wires):
            self.q[i] = wire.q
        (self.flags, self.fill, self.box,
         self.av, self.ah, self.bv, self.bh) = _pack_params(
            plans, self.b, self.sh, self.sw, self.oh, self.ow,
            self.uniform, self.has_blur, zeros=self._io.zeros,
        )

    def uses_kernel(self) -> bool:
        """A folded batch launches neither the decode kernel nor the
        resample kernel: its decode and resample are matrix products."""
        return not self.fold and super().uses_kernel()

    @property
    def upload_bytes(self) -> int:
        """Host->device bytes of the coefficient wire: the real images'
        slots (blocks + tables)."""
        return sum(w.nbytes for w in self.wires)

    def host_grids(self):
        """The staged block grids of PLANES, (B, rows, cols, 64) int16
        copies of the slots' (the host mirror decodes them)."""
        grids = [np.zeros((self.b, h, w, 64), np.int16)
                 for h, w in self._shapes]
        for i, wire in enumerate(self.wires):
            for grid, g in zip(grids, wire.grids):
                grid[i] = g
        return grids

    def _wire_zeroed(self) -> bool:
        """Whether the device wire must be zeroed before the slots are
        copied in: the decode kernels read the blocks of the real images'
        true rects alone, which the slots hold, so on CUDA it is not; the
        folded route and the CPU's plain decode read the bucket's padding
        images too."""
        return self.fold or self.device.type != "cuda"

    def device_wire(self):
        """Upload the wire: the block grids of PLANES, then q, on the
        device, views of one buffer in the bucket's layout, each real
        image's slot copied in (one non-blocking copy a plane, and one of
        its tables)."""
        b = self.b
        sizes = [h * w * 64 for h, w in self._shapes]  # int16 words
        q_words = _Q_BYTES // 2
        make = torch.zeros if self._wire_zeroed() else torch.empty
        flat = make(b * (sum(sizes) + q_words), dtype=torch.int16,
                    device=self.device)
        out, at = [], 0
        for p, ((h, w), n) in enumerate(zip(self._shapes, sizes)):
            for i, wire in enumerate(self.wires):
                flat[at + i * n: at + (i + 1) * n].copy_(wire.planes[p],
                                                         non_blocking=True)
            out.append(flat[at: at + b * n].view(b, h, w, 64))
            at += b * n
        for i, wire in enumerate(self.wires):
            flat[at + i * q_words: at + (i + 1) * q_words].copy_(
                wire.q_words, non_blocking=True)
        out.append(flat[at:].view(torch.int32).view(b, 2, 64))
        return tuple(out)

    def _device_x(self):
        """Upload the block grids and decode them on the device in one
        launch: (B, 3, sh, sw) u8."""
        return jpeg_decode_kernels.jpeg_decode_rgb(
            *self.device_wire(), self.subsamp, self.true_h, self.true_w,
            self.sh, self.sw, len(self.plans))

    def folded(self, wire):
        """The folded decode-resize of the uploaded wire (`device_wire()`):
        (B, 3, OH, OW) f32 resampled pixels (K11)."""
        y, cb, cr, q = wire
        mats = [_device_cached(m, self.device)
                for m in _folded_padded(self.plans[0], self.subsamp)]
        (ydc, yac), (cbdc, cbac), (crdc, crac) = (
            jpeg_decode.blocks_to_planar(g) for g in (y, cb, cr))
        return jpeg_decode.folded_decode_resample(
            ydc, yac, cbdc, cbac, crdc, crac, q[:, 0], q[:, 1], mats,
            fast=self.fast)

    def folded_pixels(self, wire, flags, fill, box):
        """The folded route on the device: K11 on the uploaded wire, then
        the pixel path's composite and blur, cropped to the true output
        dims (as fanlin_tpu/ops/fused.py:2071-2076 does): (B, 3, out_h,
        out_w) u8."""
        p0 = self.plans[0]
        _, _, bv, bh, _ = self.uniform_matrices()
        out = _post_resample(self.folded(wire), flags, fill, box, bv, bh,
                             uniform=True, opaque_in=True)
        return out[:, :, : p0.out_h, : p0.out_w]

    def submit(self):
        if not self.fold:
            return super().submit()
        params = (self._io.upload(a) for a in (self.flags, self.fill,
                                                self.box))
        out = self.folded_pixels(self.device_wire(), *params)
        return self._io.download(_tail(out, self.c_out, self.jpeg420))


class CmykCoefBatchAssembly(CoefBatchAssembly):
    """Host staging for one device batch of 4-component (CMYK / YCCK)
    JPEG coefficient sources: the host half of fanlin_tpu/ops/fused.py
    CmykCoefBatchAssembly (:2169-2366). The wire adds comp3's (K) block
    grid at the luma grid; on the device one kernel
    (`jpeg_decode_cmyk_rgb`: the 4-component decode with the sampled ICC
    LUT in its colour stage) makes the (B, 3, sh, sw) u8 batch that every
    sink of CoefBatchAssembly then takes.

    The LUT travels with the metas (`lut_flat` (n^4, 3) f32, `lut_n`,
    `lut_key`: "" for the Engine's default profile, the profile's hash
    for an embedded one), so the port keeps no process-wide LUT; a batch
    holds one LUT, and its packed device copy is cached by the array's
    identity.
    As in the reference there is no folded variant (the LUT is not
    linear)."""

    PLANES = _CMYK_PLANES

    def __init__(self, plans, payloads, device: torch.device, jpeg420=False,
                 fast=False):
        """payloads: read_jpeg_coeffs4 dicts (either package's) with a LUT
        attached, all of one geometry, layout and colour transform, or
        WireSlots made from such dicts."""
        metas = [_meta(p) for p in payloads]
        if not metas or not all(isinstance(m, dict) and m.get("cmyk")
                                for m in metas):
            raise ValueError("a CMYK batch takes read_jpeg_coeffs4 dicts")
        m0 = metas[0]
        if m0.get("lut_flat") is None:
            raise ValueError("a CMYK batch needs a sampled LUT on its metas "
                             "(Engine.enable_device_icc)")
        self.lut_flat, self.lut_n = m0["lut_flat"], int(m0["lut_n"])
        self.lut_key = m0.get("lut_key", "")
        if any(m.get("lut_key", "") != self.lut_key for m in metas):
            raise ValueError("mixed-profile CMYK batch")
        self.ycck = bool(m0["ycck"])
        if any(bool(m["ycck"]) != self.ycck for m in metas):
            raise ValueError("a CMYK batch holds one colour transform")
        super().__init__(plans, payloads, device, jpeg420, fast=fast)

    def _device_x(self):
        """Upload the block grids, then decode them and convert them
        through the packed LUT on the device in one launch: (B, 3, sh, sw)
        u8."""
        return jpeg_decode_kernels.jpeg_decode_cmyk_rgb(
            *self.device_wire(),
            _device_packed_lut(self.lut_flat, self.lut_n, self.device),
            self.lut_n, self.subsamp, self.ycck, self.true_h, self.true_w,
            self.sh, self.sw, len(self.plans))


_COEF_KINDS = ("coef", "coef444", "coef422", "coef440")
# a coefficient kind with this suffix asks for the folded decode-resize
# (tpu.fast_decode): "coef444-fold", "coef-fold+jpeg420", ...
FOLD_SUFFIX = "-fold"
# "cmyk444" / "cmyk420", "y" for YCCK, "@<profile hash>" for an embedded
# profile's LUT (the JAX Engine's kind strings)
_CMYK_KIND = re.compile(r"cmyk(444|420)(y?)(?:@[0-9a-f]+)?")


def _sink_arg(sink: str):
    """The BatchAssembly `jpeg420` argument of a sink name.

    A jpegdct batch downloads its coefficients as full int16 planar
    planes: the reference's pack level 2. Its narrower levels (-1/0/1:
    DC + low corner, int4 nibbles + residual, int8) and the overflow
    ladder that re-runs a saturating batch one level wider are the
    narrow-link download rungs, not ported here: they are lossless, so
    every level serves the same bytes, and the ladder's re-run would
    touch device tensors from the collect thread, which the batcher's
    design forbids. tpu.dct_pack_floor is accepted and does nothing."""
    if sink.startswith("png:"):
        return ("png", int(sink.split(":", 1)[1]))
    if sink.startswith("jpegdct:"):
        return ("jpegdct", int(sink.split(":", 1)[1]))
    if sink not in ("rgb", "jpeg420", "webp420"):
        raise NotImplementedError(
            f"sink {sink!r} is not yet in the PyTorch port")
    return "webp" if sink == "webp420" else (sink == "jpeg420")


def make_assembly(plans, payloads, kinds, device: torch.device, *,
                  fast: bool = False):
    """The assembly for a homogeneous batch. Kinds: "rgb" (pixels out),
    "jpeg420", "webp420", "png:N", "jpegdct:Q" for pixel sources
    (payloads are (H, W, C) u8 arrays); "coef", "coef444", "coef422",
    "coef440", each optionally with FOLD_SUFFIX (the folded
    decode-resize) and with "+jpeg420", "+webp420", "+png:N" or
    "+jpegdct:Q", for coefficient sources (payloads are read_jpeg_coeffs
    dicts or their WireSlots); "cmyk444", "cmyk420" (+ "y" for YCCK, +
    "@<key>" for an embedded profile's LUT), with the same sinks, for
    4-component sources (read_jpeg_coeffs4 dicts carrying their LUT, or
    their WireSlots). fast: the resample
    products in bf16 (`tpu.fast`), whatever the kind."""
    k0 = kinds[0] if kinds else "rgb"
    base, _, sink = k0.partition("+")
    cmyk = _CMYK_KIND.fullmatch(base)
    if cmyk:
        subsamp, ycck = int(cmyk.group(1)), bool(cmyk.group(2))
        if not all(isinstance(m, dict) and m.get("cmyk")
                   and (m["subsamp"], bool(m["ycck"])) == (subsamp, ycck)
                   for m in map(_meta, payloads)):
            raise ValueError(f"batch kind {k0!r} takes read_jpeg_coeffs4 "
                             f"dicts of subsamp {subsamp}, ycck {ycck}")
        return CmykCoefBatchAssembly(plans, payloads, device,
                                     _sink_arg(sink or "rgb"), fast=fast)
    fold = base.endswith(FOLD_SUFFIX)
    if fold:
        base = base[: -len(FOLD_SUFFIX)]
    if base in _COEF_KINDS:
        return CoefBatchAssembly(plans, payloads, device,
                                 _sink_arg(sink or "rgb"), fold=fold,
                                 fast=fast)
    if fold:
        raise ValueError(f"batch kind {k0!r}: only coefficient kinds fold")
    if sink:
        raise NotImplementedError(
            f"batch kind {k0!r} is not yet in the PyTorch port")
    return BatchAssembly(plans, payloads, device, _sink_arg(k0), fast=fast)


def transform_single(image: np.ndarray, params, device: torch.device,
                     filter_name: str = filters.LANCZOS3) -> np.ndarray:
    """Convenience: run one image through the device pipeline."""
    h, w = image.shape[:2]
    plan = plan_image(w, h, params, filter_name)
    return BatchAssembly([plan], [image], device).run()[0]
