"""The encode tails and the batch assembly.

Port of fanlin_tpu/ops/fused.py: the encode front-ends
(`_ycbcr420_tail`, `_png_tail`, `_webp420_tail`, fused.py:431-596),
`BatchAssembly` for pixel sources (fused.py:1112-1525) and
`CoefBatchAssembly` for JPEG coefficient sources (fused.py:1695-1829,
2065-2166). The chain itself (fused.py:307-430) is in `ops.chain`. The
reference runs each batch as one jitted XLA program; here the same
steps run eagerly on the assembly's device.

Transfers: on CUDA a batch is staged straight into pinned host buffers,
and `submit()` issues the uploads, the kernels and
the downloads as non-blocking work on the caller's current stream,
then records an event; `collect()` only waits on that event and copies
each image's result out of the pinned buffers, so the batcher's collect
thread never touches a device tensor. On the CPU (tests) the same code
runs on plain host arrays with no event.

Routing: a coefficient batch is decoded on the device by the decode
kernel (`jpeg_decode_kernels.jpeg_decode_rgb`), which writes the same
(B, 3, SH, SW) u8 batch a pixel upload would give. Every uniform batch
of opaque (3-channel) sources then goes through the hand-written CUDA
resample kernel (`resample_kernels.resample_uniform`), whatever its
encode tail; the kernel writes 3 channels and a constant 255 alpha
plane is appended where the batch downloads 4. Alpha sources, GIF
frames and non-uniform batches run the torch chain of `ops.chain`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.bytelru import ByteLRU
from . import filters, jpeg_decode, jpeg_decode_kernels, resample_kernels
from .chain import _transform_kernel, _transform_kernel_uniform
from .plan import (_pack_params, _uniform_bands, _uniform_padded, bucket_b,
                   bucket_h, bucket_h16, bucket_w, plan_image)

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


def _tail(out, c_out: int, sink):
    """The encode front-end selected by `sink` (False = pixels), or the
    pixel batch trimmed/extended to `c_out` channels."""
    if isinstance(sink, tuple):
        return _png_tail(out, sink[1])
    if sink == "webp":
        return _webp420_tail(out)
    if sink:
        return _ycbcr420_tail(out)
    if out.shape[1] < c_out:
        alpha = torch.full_like(out[:, :1], 255)
        out = torch.cat([out, alpha], dim=1)
    return out[:, :c_out]


# Device copies of the shared (uniform) matrices, keyed by the host
# array's identity (the array is kept in the value so a live id cannot
# collide).
_DEVICE_MATRIX_CACHE = ByteLRU(max_bytes=256 * 1024 * 1024)


def _device_cached(arr, device: torch.device):
    if arr is None:
        return None
    key = (id(arr), str(device))
    hit = _DEVICE_MATRIX_CACHE.get(key)
    if hit is not None and hit[0] is arr:
        dev = hit[1]
    else:
        # a blocking copy: complete before any stream reads it (batches
        # of several runners, each on its own stream, share the cache)
        dev = torch.from_numpy(arr).to(device)
        _DEVICE_MATRIX_CACHE.put(key, (arr, dev), arr.nbytes)
    if device.type == "cuda":
        # an eviction must not free it under another stream's reads
        dev.record_stream(torch.cuda.current_stream(device))
    return dev


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

    def __init__(self, plans, images, device: torch.device, jpeg420=False):
        """plans: list[ImagePlan]; images: list[(H, W, 3|4) uint8].

        jpeg420: False (pixels out), True (JPEG YCbCr 4:2:0 front-end),
        "webp" (WebP-range YUV 4:2:0) or ("png", N) (PNG filter
        front-end, N channels). The front-ends need one true output
        geometry per batch; a batch without it downloads pixels."""
        if len(plans) != len(images) or not plans:
            raise ValueError("one plan per image, at least one image")
        self.plans = plans
        self.device = device
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
            av, ah, bv, bh = (_device_cached(a, dev)
                              for a in _uniform_padded(p0))
            if self.uses_kernel():
                out = resample_kernels.resample_uniform(
                    flags, fill, box, av, ah, x, bv, bh,
                    crop=(p0.out_h, p0.out_w),
                    bands=_device_cached(_uniform_bands(p0), dev),
                )
            else:
                out = _transform_kernel_uniform(x, av, ah, flags, fill, box,
                                                bv, bh)
                out = out[:, :, : p0.out_h, : p0.out_w]
        else:
            up = self._io.upload
            out = _transform_kernel(x, up(self.av), up(self.ah), flags, fill,
                                    box, up(self.bv), up(self.bh))
            if self.jpeg420:
                out = out[:, :, : p0.out_h, : p0.out_w]
        return self._io.download(_tail(out, self.c_out, self.jpeg420))

    def collect(self, out):
        """Wait for the batch and return per-image results that own
        their memory: (out_h, out_w, c_out) u8 arrays, or
        ("ycbcr420"|"webpyuv", y, cb, cr) / ("pngrows", rows, w, h, nch)
        tuples for the native encoders. Touches no device tensor."""
        self._io.wait()
        n = len(self.plans)
        p0 = self.plans[0]
        if isinstance(self.jpeg420, tuple):
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

    def run(self):
        return self.collect(self.submit())


class CoefBatchAssembly(BatchAssembly):
    """Host staging for one device batch of JPEG coefficient sources:
    the host half of fanlin_tpu/ops/fused.py CoefBatchAssembly
    (:1695-1829, :2065-2166). The device `x` comes from the decode
    kernel (`jpeg_decode_rgb`) instead of an upload of pixels;
    everything after it is BatchAssembly's.

    The wire is the simplest lossless one: int16 natural-order block
    grids, zero-padded to the bucket's block grid (luma bucket_h16 / 8
    by bucket_w / 8, chroma divided by chroma_divisors), uploaded as one
    buffer, and the quant tables as (B, 2, 64) int32. The kernel reads
    only the blocks of the true rect of the batch's real images."""

    def __init__(self, plans, metas, device: torch.device, jpeg420=False):
        """metas: read_jpeg_coeffs dicts (either package's), all of one
        (w, h) and subsamp. jpeg420: as for BatchAssembly."""
        if len(plans) != len(metas) or not plans:
            raise ValueError("one plan per source, at least one source")
        m0 = metas[0]
        self.true_h, self.true_w, self.subsamp = m0["h"], m0["w"], m0["subsamp"]
        if any((m["h"], m["w"], m["subsamp"]) !=
               (self.true_h, self.true_w, self.subsamp) for m in metas):
            raise ValueError("a coefficient batch holds one source geometry "
                             "and subsampling layout")
        self.plans = plans
        self.device = device
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

        dv, dh = jpeg_decode.chroma_divisors(self.subsamp)
        gh = bucket_h16(self.true_h)  # whole 4:2:0 MCU rows
        shapes = ((gh // 8, self.sw // 8),
                  (gh // (8 * dv), self.sw // (8 * dh)),
                  (gh // (8 * dv), self.sw // (8 * dh)))
        self.coef = self._io.zeros(
            self.b * sum(h * w for h, w in shapes) * 64, np.int16)
        self._spans = []
        at = 0
        grids = []
        for h, w in shapes:
            n = self.b * h * w * 64
            self._spans.append((at, at + n, (self.b, h, w, 64)))
            grids.append(self.coef[at:at + n].reshape(self.b, h, w, 64))
            at += n
        self.q = self._io.zeros((self.b, 2, 64), np.int32)
        for i, m in enumerate(metas):
            for grid, key in zip(grids, ("y", "cb", "cr")):
                g = m[key]
                grid[i, : g.shape[0], : g.shape[1]] = g
            self.q[i, 0] = m["lq"]
            self.q[i, 1] = m["cq"]
        (self.flags, self.fill, self.box,
         self.av, self.ah, self.bv, self.bh) = _pack_params(
            plans, self.b, self.sh, self.sw, self.oh, self.ow,
            self.uniform, self.has_blur, zeros=self._io.zeros,
        )

    @property
    def upload_bytes(self) -> int:
        """Host->device bytes of the coefficient wire (blocks + tables)."""
        return self.coef.nbytes + self.q.nbytes

    def device_wire(self):
        """Upload the wire: (y, cb, cr, q) on the device, the block
        grids as views of one uploaded buffer."""
        flat = self._io.upload(self.coef)
        q = self._io.upload(self.q)
        y, cb, cr = (flat[a:b].view(shape) for a, b, shape in self._spans)
        return y, cb, cr, q

    def _device_x(self):
        """Upload the block grids and decode them on the device in one
        launch: (B, 3, sh, sw) u8."""
        return jpeg_decode_kernels.jpeg_decode_rgb(
            *self.device_wire(), self.subsamp, self.true_h, self.true_w,
            self.sh, self.sw, len(self.plans))


_COEF_KINDS = ("coef", "coef444", "coef422", "coef440")


def _sink_arg(sink: str):
    """The BatchAssembly `jpeg420` argument of a sink name."""
    if sink.startswith("png:"):
        return ("png", int(sink.split(":", 1)[1]))
    if sink not in ("rgb", "jpeg420", "webp420"):
        raise NotImplementedError(
            f"sink {sink!r} is not yet in the PyTorch port")
    return "webp" if sink == "webp420" else (sink == "jpeg420")


def make_assembly(plans, payloads, kinds, device: torch.device):
    """The assembly for a homogeneous batch. Kinds: "rgb" (pixels out),
    "jpeg420", "webp420", "png:N" for pixel sources (payloads are
    (H, W, C) u8 arrays); "coef", "coef444", "coef422", "coef440", each
    optionally with "+jpeg420", "+webp420" or "+png:N", for coefficient
    sources (payloads are read_jpeg_coeffs dicts). The jpegdct sinks
    and the CMYK kinds are not in the port yet."""
    k0 = kinds[0] if kinds else "rgb"
    base, _, sink = k0.partition("+")
    if base in _COEF_KINDS:
        return CoefBatchAssembly(plans, payloads, device,
                                 _sink_arg(sink or "rgb"))
    if sink:
        raise NotImplementedError(
            f"batch kind {k0!r} is not yet in the PyTorch port")
    return BatchAssembly(plans, payloads, device, _sink_arg(k0))


def transform_single(image: np.ndarray, params, device: torch.device,
                     filter_name: str = filters.LANCZOS3) -> np.ndarray:
    """Convenience: run one image through the device pipeline."""
    h, w = image.shape[:2]
    plan = plan_image(w, h, params, filter_name)
    return BatchAssembly([plan], [image], device).run()[0]
