"""The transform chain in plain torch.

Port of fanlin_tpu/ops/fused.py:307-430 (`_chain`, `_post_resample`,
`_transform_kernel(_uniform)`). `ops.fused` runs it for the batches the
CUDA kernel does not take (alpha sources, GIF frames, non-uniform
batches), and `ops.resample_kernels` uses its uniform form as the
kernel's plain version. The reference runs it inside one jitted XLA
program; here the steps run eagerly on the inputs' device.

Rounding semantics match the `image` crate: resize and blur outputs
round half away from zero after clamping to [0, 255]; the fixed-point
Rec.709 luma floors; alpha blending truncates.

`fast=True` is the reference's bf16 resample (`tpu.fast`,
fanlin_tpu/ops/fused.py:186-194, :343-349): the weights and the
intermediate of the resample pair are rounded to bf16 (round to nearest
even) before each product, which sums in f32 (`bf16_round`); the pixel
operand holds integers 0..255, exact in bf16. The blur pair stays f32.
"""

from __future__ import annotations

import torch

_F32 = torch.float32
_I32 = torch.int32


def _true_div(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d as an IEEE division on every device (a Python-scalar
    divisor lets CUDA multiply by the reciprocal instead)."""
    return a / a.new_full((), d)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to bf16 (nearest even), as f32: the operand of
    a bf16 product whose f32 products are exact."""
    return t.to(torch.bfloat16).to(_F32)


def _chain(x_u8, av, ah, flags, fill, box, bv=None, bh=None, uniform=False,
           fast=False):
    """The transform chain over a (B, C, SH, SW) u8 batch (C == 3 means
    opaque). uniform=True: one matrix set for the whole batch, av
    (OH, SH); else per-image stacks, av (B, OH, SH). fast: the resample
    pair's weights and intermediate rounded to bf16.

    Op order == reference src/handler.rs steps 8-11: grayscale ELSE-IF
    invert -> separable resample (crop/canvas folded into the
    matrices) -> centered fill composite -> gaussian blur.
    """
    xi = x_u8.to(_I32)
    # fixed-point Rec.709 luma with floor division (image crate
    # rgb_to_luma); in int32 it is exactly the f32 floor((..) / 10000)
    luma = torch.div(2126 * xi[:, 0] + 7152 * xi[:, 1] + 722 * xi[:, 2],
                     10000, rounding_mode="floor").to(_F32)
    x = x_u8.to(_F32)
    gray = (flags[:, 0] > 0)[:, None, None]
    do_inv = ((flags[:, 1] > 0) & (flags[:, 0] == 0))[:, None, None]
    planes = []
    for c in range(3):
        p = torch.where(gray, luma, x[:, c])
        planes.append(torch.where(do_inv, 255.0 - p, p))
    opaque_in = x.shape[1] == 3
    if not opaque_in:
        planes.append(x[:, 3])
    y = torch.stack(planes, dim=1)  # (B, C, SH, SW)

    # vertical first, as the reference: rounding the intermediate of the
    # other order gives other bytes
    rnd = bf16_round if fast else (lambda t: t)
    if uniform:
        t = torch.matmul(rnd(torch.matmul(rnd(av), y)),
                         rnd(ah).transpose(0, 1))
    else:
        t = torch.matmul(rnd(torch.matmul(rnd(av)[:, None], y)),
                         rnd(ah).transpose(1, 2)[:, None])
    fg = torch.floor(torch.clamp(t, 0.0, 255.0) + 0.5)  # (B, C, OH, OW)
    return _post_resample(fg, flags, fill, box, bv, bh, uniform, opaque_in)


def _post_resample(fg, flags, fill, box, bv=None, bh=None, uniform=False,
                   opaque_in=True):
    """Centered fill composite, blur, u8 cast. Opaque inputs return 3
    channels (their alpha is constant 255: the tail appends it where
    the batch downloads 4); alpha inputs return 4, alpha 255 where
    blended onto the canvas."""
    oh, ow = fg.shape[2], fg.shape[3]
    ii = torch.arange(oh, device=fg.device)[None, :, None]
    jj = torch.arange(ow, device=fg.device)[None, None, :]
    x0 = box[:, 0][:, None, None]
    y0 = box[:, 1][:, None, None]
    fw = box[:, 2][:, None, None]
    fh = box[:, 3][:, None, None]
    inrect = (ii >= y0) & (ii < y0 + fh) & (jj >= x0) & (jj < x0 + fw)

    fillc = fill[:, :, None, None]  # (B, 3, 1, 1)
    if opaque_in:
        comp = torch.where(inrect[:, None], fg, fillc)
    else:
        # alpha blend onto the opaque fill canvas
        fga = fg[:, 3:4]
        af = _true_div(fga, 255.0)
        blended = torch.floor(fg[:, :3] * af + fillc * (1.0 - af))
        comp_rgb = torch.where(fga >= 255.0, fg[:, :3], blended)
        comp_rgb = torch.where(inrect[:, None], comp_rgb, fillc)
        comp = torch.cat([comp_rgb, torch.full_like(fga, 255.0)], dim=1)
    usec = (flags[:, 2] > 0)[:, None, None, None]
    out = torch.where(usec, comp, fg)

    if bv is not None:
        if uniform:
            t = torch.matmul(torch.matmul(bv, out), bh.transpose(0, 1))
        else:
            t = torch.matmul(torch.matmul(bv[:, None], out),
                             bh.transpose(1, 2)[:, None])
        out = torch.floor(torch.clamp(t, 0.0, 255.0) + 0.5)

    return out.to(torch.uint8)


def _transform_kernel(x_u8, av, ah, flags, fill, box, bv=None, bh=None,
                      fast=False):
    """Per-image matrices: x (B, C, SH, SW) u8, av (B, OH, SH), ah
    (B, OW, SW), flags (B, 3), fill (B, 3), box (B, 4) int32, bv
    (B, OH, OH) | None, bh (B, OW, OW) | None."""
    return _chain(x_u8, av, ah, flags, fill, box, bv, bh, uniform=False,
                  fast=fast)


def _transform_kernel_uniform(x_u8, av, ah, flags, fill, box, bv=None,
                              bh=None, fast=False):
    """Shared matrices: av (OH, SH), ah (OW, SW), bv (OH, OH), bh
    (OW, OW) — the common production batch (one site, one target)."""
    return _chain(x_u8, av, ah, flags, fill, box, bv, bh, uniform=True,
                  fast=fast)
