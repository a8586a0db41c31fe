"""The encode tails and the batch assembly.

Port of fanlin_tpu/ops/fused.py for pixel sources: the encode
front-ends (`_ycbcr420_tail`, `_png_tail`, `_webp420_tail`,
fused.py:431-596) and `BatchAssembly` (fused.py:1112-1525). The chain
itself (fused.py:307-430) is in `ops.chain`. The reference runs each
batch as one jitted XLA program; here the same steps run eagerly on the
assembly's device.

Routing: every uniform batch of opaque (3-channel) sources goes through
the hand-written CUDA kernel (`resample_kernels.resample_uniform`),
whatever its encode tail; the kernel writes 3 channels and a constant
255 alpha plane is appended where the batch downloads 4. Alpha
sources, GIF frames and non-uniform batches run the torch chain of
`ops.chain`.
"""

from __future__ import annotations

import numpy as np
import torch

from fanlin_tpu.ops import filters
from fanlin_tpu.utils.bytelru import ByteLRU

from . import resample_kernels
from .chain import _transform_kernel, _transform_kernel_uniform
from .plan import (_pack_params, _uniform_padded, bucket_b, bucket_h,
                   bucket_w, plan_image)

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
        return hit[1]
    dev = torch.from_numpy(arr).to(device)
    _DEVICE_MATRIX_CACHE.put(key, (arr, dev), arr.nbytes)
    return dev


def _to_device(arr, device: torch.device):
    return None if arr is None else torch.from_numpy(arr).to(device)


class BatchAssembly:
    """Host staging for one device batch of pixel sources."""

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

        self.x = np.zeros((self.b, self.c_in, self.sh, self.sw), dtype=np.uint8)
        (self.flags, self.fill, self.box,
         self.av, self.ah, self.bv, self.bh) = _pack_params(
            plans, self.b, self.sh, self.sw, self.oh, self.ow,
            self.uniform, self.has_blur,
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

    def submit(self):
        """Upload the batch and run the chain and tail on the device
        (asynchronously on CUDA); returns the device output."""
        dev = self.device
        x = torch.from_numpy(self.x).to(dev)
        flags = torch.from_numpy(self.flags).to(dev)
        fill = torch.from_numpy(self.fill).to(dev)
        box = torch.from_numpy(self.box).to(dev)
        p0 = self.plans[0]
        if self.uniform:
            av, ah, bv, bh = (_device_cached(a, dev)
                              for a in _uniform_padded(p0))
            if self.uses_kernel():
                out = resample_kernels.resample_uniform(
                    flags, fill, box, av, ah, x, bv, bh,
                    crop=(p0.out_h, p0.out_w),
                )
            else:
                out = _transform_kernel_uniform(x, av, ah, flags, fill, box,
                                                bv, bh)
                out = out[:, :, : p0.out_h, : p0.out_w]
        else:
            out = _transform_kernel(
                x, _to_device(self.av, dev), _to_device(self.ah, dev), flags,
                fill, box, _to_device(self.bv, dev), _to_device(self.bh, dev),
            )
            if self.jpeg420:
                out = out[:, :, : p0.out_h, : p0.out_w]
        return _tail(out, self.c_out, self.jpeg420)

    def collect(self, out):
        """Copy the device result to the host: per-image (out_h, out_w,
        c_out) u8 arrays, or ("ycbcr420"|"webpyuv", y, cb, cr) /
        ("pngrows", rows, w, h, nch) tuples for the native encoders."""
        n = len(self.plans)
        p0 = self.plans[0]
        if isinstance(self.jpeg420, tuple):
            rows = out.cpu().numpy()  # (B, OH, 1 + OW*nch)
            return [("pngrows", rows[i], p0.out_w, p0.out_h, self.jpeg420[1])
                    for i in range(n)]
        if self.jpeg420:
            tag = "webpyuv" if self.jpeg420 == "webp" else "ycbcr420"
            y, cb, cr = (o.cpu().numpy() for o in out)
            return [(tag, y[i], cb[i], cr[i]) for i in range(n)]
        host = out.cpu().numpy()  # (B, C, OH|true_oh, OW|true_ow)
        return [
            np.ascontiguousarray(host[i, :, : p.out_h, : p.out_w].transpose(1, 2, 0))
            for i, p in enumerate(self.plans)
        ]

    def run(self):
        return self.collect(self.submit())


def make_assembly(plans, payloads, kinds, device: torch.device):
    """The assembly for a homogeneous batch of pixel sources. Kinds:
    "rgb" (pixels out), "jpeg420", "webp420", "png:N". Coefficient
    sources and the jpegdct sink are not in the port yet."""
    k0 = kinds[0] if kinds else "rgb"
    if k0.startswith("png:"):
        return BatchAssembly(plans, payloads, device,
                             jpeg420=("png", int(k0.split(":", 1)[1])))
    if k0 not in ("rgb", "jpeg420", "webp420"):
        raise NotImplementedError(
            f"batch kind {k0!r} is not yet in the PyTorch port"
        )
    yuv = "webp" if k0 == "webp420" else (k0 == "jpeg420")
    return BatchAssembly(plans, payloads, device, yuv)


def transform_single(image: np.ndarray, params, device: torch.device,
                     filter_name: str = filters.LANCZOS3) -> np.ndarray:
    """Convenience: run one image through the device pipeline."""
    h, w = image.shape[:2]
    plan = plan_image(w, h, params, filter_name)
    return BatchAssembly([plan], [image], device).run()[0]
