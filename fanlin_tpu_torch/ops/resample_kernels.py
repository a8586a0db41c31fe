"""The uniform-batch resample kernel: wrapper, plain version, launch count.

`resample_uniform` is the port of fanlin_tpu/ops/pallas_kernels.py::
resample_uniform (the Pallas kernels `_resample_kernel` and
`_resample_blur_kernel`). On a CUDA tensor it launches the hand-written
kernel of `csrc/resample.cu` (see the note at the top of that file for
what bounds it on the card and how it is laid out); on a CPU tensor it
runs `resample_uniform_ref`, the plain torch version of the same chain.
There is no fallback: a failed build or launch raises.

Inputs mirror the Pallas wrapper: x (B, 3, SH, SW) u8 opaque, av
(OH, SH) f32, ah (OW, SW) f32, flags (B, 3) f32 [gray, invert,
use_canvas], fill (B, 3) f32, box (B, 4) int32 [x0, y0, fw, fh],
optional blur matrices bv (OH, OH), bh (OW, OW). The output is
(B, 3, OH, OW) u8, or only its top-left `crop=(h, w)` rect.

The kernel walks only the band of each weight matrix: `band_ranges`
gives, per output tile, the K range that holds the tile's non-zero
weights. The caller computes it once per matrix set (ops.plan caches
it beside the padded matrices) and passes it as `bands`; a CUDA call
without it raises.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import _build
from ._build import K_SLICE, TILE_M, TILE_N
from .chain import _transform_kernel_uniform

_F32 = torch.float32
_I32 = torch.int32
_U8 = torch.uint8

# Launches of the CUDA kernel, by variant (K1 without blur, K2 with).
# Incremented only where the kernel is launched; the CPU path and the
# plain version never count.
_COUNT_LOCK = threading.Lock()
_LAUNCHES = {"resample": 0, "resample_blur": 0}


def launch_counts() -> dict:
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0


def tile_k_ranges(mat: np.ndarray, tile: int, kslice: int) -> np.ndarray:
    """Per tile of `tile` rows of `mat` (R, K): the union [k_lo, k_hi)
    of the tile's non-zero columns, rounded outward to multiples of
    `kslice` (k_hi may pass K; the kernel reads zeros there). A tile
    without non-zeros gets the empty range (0, 0). Taken from the
    matrix itself, so it holds for every filter, crop and canvas.
    Returns (ceil(R / tile), 2) int32."""
    rows, k = mat.shape
    n = -(-rows // tile)
    nz = np.zeros((n * tile, k), dtype=bool)
    nz[:rows] = mat != 0
    cols = nz.reshape(n, tile, k).any(axis=1)  # (n, K)
    has = cols.any(axis=1)
    first = cols.argmax(axis=1)
    last = k - 1 - cols[:, ::-1].argmax(axis=1)
    lo = first // kslice * kslice
    hi = -(-(last + 1) // kslice) * kslice
    return np.where(has[:, None], np.stack([lo, hi], axis=1),
                    0).astype(np.int32)


def band_ranges(av, ah, bv=None, bh=None) -> np.ndarray:
    """The kernel's `bands` argument for one padded matrix set: the
    tile_k_ranges of Av and Bv over TILE_M-row tiles (the M tiles of
    passes 1 and 3) and of Ah and Bh over TILE_N-row tiles (the N tiles
    of passes 2 and 4), stacked in the order av, ah[, bv, bh]."""
    parts = [tile_k_ranges(av, TILE_M, K_SLICE),
             tile_k_ranges(ah, TILE_N, K_SLICE)]
    if bv is not None:
        parts += [tile_k_ranges(bv, TILE_M, K_SLICE),
                  tile_k_ranges(bh, TILE_N, K_SLICE)]
    return np.concatenate(parts)


def params_from_numpy(flags, fill, box, av, ah, bv=None, bh=None, *,
                      device: torch.device):
    """The JAX package's numpy parameter arrays (BatchAssembly.flags/
    fill/box, _uniform_padded's matrices) as the kernel's tensors on
    `device`: (flags, fill, box, av, ah, bv, bh), bv/bh None without
    blur."""

    def put(a, dtype):
        if a is None:
            return None
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                             dtype=dtype)

    return (put(flags, _F32), put(fill, _F32), put(box, _I32), put(av, _F32),
            put(ah, _F32), put(bv, _F32), put(bh, _F32))


def _expect(t, name: str, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _validate(flags, fill, box, av, ah, x, bv, bh, crop, bands):
    """Check every argument; returns (oh, ow, store_h, store_w)."""
    if not isinstance(x, torch.Tensor) or x.dim() != 4 or x.shape[1] != 3:
        raise ValueError("x: expected a (B, 3, SH, SW) tensor")
    b, _, sh, sw = x.shape
    dev = x.device
    _expect(x, "x", _U8, (b, 3, sh, sw), dev)
    if not isinstance(av, torch.Tensor) or av.dim() != 2:
        raise ValueError("av: expected an (OH, SH) tensor")
    if not isinstance(ah, torch.Tensor) or ah.dim() != 2:
        raise ValueError("ah: expected an (OW, SW) tensor")
    oh, ow = av.shape[0], ah.shape[0]
    _expect(av, "av", _F32, (oh, sh), dev)
    _expect(ah, "ah", _F32, (ow, sw), dev)
    _expect(flags, "flags", _F32, (b, 3), dev)
    _expect(fill, "fill", _F32, (b, 3), dev)
    _expect(box, "box", _I32, (b, 4), dev)
    if (bv is None) != (bh is None):
        raise ValueError("bv and bh: give both or neither")
    if bv is not None:
        _expect(bv, "bv", _F32, (oh, oh), dev)
        _expect(bh, "bh", _F32, (ow, ow), dev)
    if bands is not None:
        n = -(-oh // TILE_M) + -(-ow // TILE_N)  # tiles of av and ah
        _expect(bands, "bands", _I32, (2 * n if bv is not None else n, 2),
                dev)
    store_h, store_w = (oh, ow) if crop is None else crop
    if not (0 < store_h <= oh and 0 < store_w <= ow):
        raise ValueError(f"crop {crop}: must lie within ({oh}, {ow})")
    return oh, ow, int(store_h), int(store_w)


def resample_uniform(flags, fill, box, av, ah, x, bv=None, bh=None,
                     crop=None, bands=None) -> torch.Tensor:
    """Run the uniform resample chain; (B, 3, h, w) u8 on x's device.
    `bands`: band_ranges(av, ah, bv, bh) as an int32 tensor on x's
    device; required on CUDA."""
    oh, ow, store_h, store_w = _validate(flags, fill, box, av, ah, x, bv,
                                         bh, crop, bands)
    if x.device.type == "cpu":
        return resample_uniform_ref(flags, fill, box, av, ah, x, bv, bh, crop)
    if x.device.type != "cuda":
        raise ValueError(f"resample_uniform: unsupported device {x.device}")
    if bands is None:
        raise ValueError("resample_uniform: the CUDA kernel needs `bands` "
                         "(band_ranges of the matrices)")
    b, _, sh, sw = x.shape
    if sh % 4 or oh % 4 or ow % 4 or sw % 16:
        raise ValueError(f"resample_uniform: SH, OH, OW must be multiples of "
                         f"4 and SW of 16, got {(sh, sw, oh, ow)}")
    args = (x, av, ah, bv, bh, flags, fill, box, bands)
    if any(t is not None and t.data_ptr() % 16 for t in args):
        raise ValueError("resample_uniform: every tensor must be 16-byte "
                         "aligned")
    lib = _build.load()
    dev = x.device
    out = torch.empty((b, 3, store_h, store_w), dtype=_U8, device=dev)
    t_buf = torch.empty((b * 3, oh, sw), dtype=_F32, device=dev)
    g_buf = u_buf = None
    if bv is not None:
        g_buf = torch.empty((b * 3, oh, ow), dtype=_F32, device=dev)
        u_buf = torch.empty((b * 3, oh, ow), dtype=_F32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fanlin_resample_uniform(
            *map(ptr, args), ptr(out), ptr(t_buf), ptr(g_buf), ptr(u_buf),
            b, sh, sw, oh, ow, store_h, store_w, TILE_M, TILE_N, K_SLICE,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"resample kernel launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        _LAUNCHES["resample_blur" if bv is not None else "resample"] += 1
    return out


def resample_uniform_ref(flags, fill, box, av, ah, x, bv=None, bh=None,
                         crop=None) -> torch.Tensor:
    """Plain torch version of the kernel, on any device: the port's
    uniform transform chain (ops.chain) for opaque sources, cropped."""
    out = _transform_kernel_uniform(x, av, ah, flags, fill, box, bv, bh)
    h, w = (out.shape[2], out.shape[3]) if crop is None else crop
    return out[:, :, :h, :w].contiguous()
