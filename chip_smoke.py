#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fanlin_tpu_torch) on one CUDA card.

Usage, from the repository root:  python3 chip_smoke.py

Phases (each failure exits non-zero; nothing is caught):
  0. versions, card name and power limit (nvidia-smi), host codecs;
     exits non-zero when CUDA is absent
  1. build the CUDA kernels (csrc/resample.cu, csrc/jpeg_decode.cu, one
     nvcc each, started together) and the host JPEG entropy reader
     (csrc/jpeg_coeffs.cpp, the host C++ compiler)
  2. the resample kernel against its plain torch version on the card at
     the main path's shapes (the README request at every batch size the
     batcher forms, B = 1, 2, 4, 8 for max_batch 8, and at B=16) and at
     bucket edges (<= 1 LSB, <= 0.5 % of bytes differing), with median
     times (CUDA events, plain/kernel/kernel/plain turns), the GFLOP the
     weights need and the TFLOP/s they give, the bound (bytes, or the
     split-TF32 products at the TF32 rate), and at README and blur B=16
     one full-f32 torch.einsum of the same products (library ms)
  2b. the fused decode kernel jpeg_decode_rgb, and K3 jpeg_islow + K4
     jpeg_upsample_rgb (its first form, kept as the yardstick), against
     their plain versions, 0 differing bytes, on lenna (4:4:4) at B = 1,
     2, 4, 8, synth (4:2:0) at B = 8, 16 and 5 real of B=8, a 12 MP 4:2:0
     q90 JPEG B=2, a 4:2:2 JPEG B=4, 4:4:0 and gray batches from seeded
     coefficient grids, the crafted out-of-range grid, and odd true dims
     (641x479, 7x5) in 4:2:0, 4:2:2 and 4:4:0; at lenna B=1 and B=8,
     synth B=16 and 12 MP B=2 the fused kernel against the pair in turns
     (CUDA event ms over many launches, device ms from torch.profiler,
     host enqueue ms over 50 calls without a synchronize), the bytes and
     int32 operations each shape needs, its bound and the share reached;
     the reader's host ms per image and the wire's bytes per image
  3. the golden floors of tests/test_golden_parity.py on tests/golden
     through both source paths: the pre-encode floor through the pixel
     and the coefficient assemblies, then the encoded floor through
     Engine(dev, device_decode=False), each request of which launches
     one resample kernel, and through Engine(dev), each request of
     which must take the coefficient path and launch one resample and one
     jpeg_decode_rgb (no K3, no K4); the README request's stage times on
     both paths
  4. the port's HTTP server in-process on 127.0.0.1 over a file origin,
     default config (device_decode on, served through the micro-batcher):
     /stats must count coef_src
  5. the micro-batcher through build_state with the default config
     (max_batch 8, window 2 ms): (a) 16 concurrent README requests from
     16 threads through the server's engine must ride <= 4 batches, one
     resample and one jpeg_decode_rgb launch per batch, every batch uniform
     and on the kernel, every body byte-equal to the serial Engine(dev)'s;
     over HTTP in-process, (b) a mixed burst (two sources, two queries,
     one blur) must keep its groups apart with the same checks and (c)
     an EXIF orientation 6 JPEG and a progressive JPEG must take the
     coefficient path; (d) wall time and
     img/s of 16 README requests serial, through the locked serial
     runner (from 16 threads, and over HTTP with the server's runner
     swapped for it), and batched (threads and HTTP), and the
     device-busy share of the batched HTTP burst (torch.profiler)
Launch counts are set to 0 just before each main-path run (the pixel
Engine, the coefficient Engine, the server, each phase-5 burst) and read
just after it; every kernel of the serving path (resample,
resample_blur, jpeg_decode_rgb) must have been launched by the
coefficient engine, the server and phase 5 (b).

The second-to-last line is {"kernels": [...]}: each kernel's main-path
launches (K3/K4: 0, with phase 2b's as checked_launches), worst error,
event and plain ms, bound and library ms; the last line is {"ok": true,
"device": {...}}. The port
imports torch, and nothing of jax or of fanlin_tpu.
"""

from __future__ import annotations

import asyncio
import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
MAX_LSB = 1
MAX_FRAC = 0.005  # share of output bytes allowed to differ

# (name, src_w, src_h, query, batch): the README workload (lenna 512x512
# -> w=300&h=200) at each batch the micro-batcher forms (bucket_b of 1-8
# requests) and at 16, its variants, crop, blur (the K2 kernel), an
# upscale (narrow bands, empty canvas tiles) and a 12 MP camera source
# with and without blur.
SHAPES = [
    ("readme_b1", 512, 512, "w=300&h=200", 1),
    ("readme_b2", 512, 512, "w=300&h=200", 2),
    ("readme_b4", 512, 512, "w=300&h=200", 4),
    ("readme_b8", 512, 512, "w=300&h=200", 8),
    ("readme_b16", 512, 512, "w=300&h=200", 16),
    ("grayscale_b16", 512, 512, "w=300&h=200&grayscale=true", 16),
    ("inverse_b16", 512, 512, "w=300&h=200&inverse=true", 16),
    ("canvas_b16", 512, 512, "w=300&h=200&rgb=32,32,32", 16),
    ("crop_b16", 512, 512, "w=100&h=100&crop=true", 16),
    ("blur_b8", 512, 512, "w=100&h=80&blur=1", 8),
    ("blur_b16", 512, 512, "w=100&h=80&blur=1", 16),
    ("upscale_b16", 512, 512, "w=700&h=600&rgb=7,8,9", 16),
    ("12mp_b2", 4000, 3000, "w=1200&h=800", 2),
    ("12mp_blur_b2", 4000, 3000, "w=1200&h=800&blur=1", 2),
]

# Checked against the plain version but not timed: bucket edges the
# main path's shapes miss (K and M below one tile, K below one slice,
# prime output dims, crop + gray + blur, invert on a canvas, upscale
# past the source, no resize).
EDGE_SHAPES = [
    ("edge_7x5", 7, 5, "w=3&h=2", 1),
    ("edge_crop_gray_blur", 640, 480,
     "w=131&h=61&crop=true&grayscale=true&blur=2", 3),
    ("edge_prime", 640, 480, "w=97&h=89", 2),
    ("edge_up_inv_canvas", 100, 60, "w=400&h=400&rgb=1,2,3&inverse=true", 2),
    ("edge_upscale", 100, 60, "w=997&h=613", 1),
    ("edge_no_resize", 333, 777, "", 2),
]

# tests/test_golden_parity.py CASES
GOLDEN_CASES = [
    ("r300x200", "w=300&h=200"),
    ("r300x200_rgb32", "w=300&h=200&rgb=32,32,32"),
    ("crop100", "w=100&h=100&crop=true"),
    ("gray300x200", "w=300&h=200&grayscale=true"),
    ("inv150", "w=150&h=150&inverse=true"),
    ("blur100x80", "w=100&h=80&blur=1"),
    ("upscale700x600", "w=700&h=600&rgb=7,8,9"),
]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {what}")


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0**2 / mse)


def phase0() -> str:
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        print("CUDA is not available: nothing to run", flush=True)
        raise SystemExit(2)
    print(f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    for mod in ("PIL", "aiohttp"):
        print(f"{mod} importable: {importlib.util.find_spec(mod) is not None}")
    from fanlin_tpu_torch.engine import native_codecs

    print(f"native codec core available: {native_codecs.available()}",
          flush=True)
    return smi


def phase1() -> None:
    from fanlin_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    t1 = time.perf_counter()
    host = _build.build_host()
    _build.load_host()
    print(f"phase1 built {os.path.relpath(lib, ROOT)} in {t1 - t0:.2f} s, "
          f"{os.path.relpath(host, ROOT)} in {time.perf_counter() - t1:.2f} s",
          flush=True)


def _time_pair(plain, kernel, reps: int):
    """Median ms of each, in turns plain/kernel/kernel/plain."""
    for fn in (plain, kernel, plain, kernel):  # warm-up
        fn()
    torch.cuda.synchronize()
    times = {"plain": [], "kernel": []}
    for _ in range(reps):
        for name, fn in (("plain", plain), ("kernel", kernel),
                         ("kernel", kernel), ("plain", plain)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return statistics.median(times["kernel"]), statistics.median(times["plain"])


def resample_work(av, ah, bv, bh, crop, planes: int) -> dict:
    """The least work of one resample call on these weights, not the
    tile-rounded bands the kernel walks: the multiply-adds of each pass
    over its non-zero weights, for just the rows and columns the next
    pass (or the stored crop) reads; the bytes of the source pixels those
    weights reach, of the non-zero weights (f32) and of the u8 output.
    `tf32_flop` counts them as csrc/resample.cu's split-TF32 tensor-core
    products: 2 per multiply-add in pass 1, 3 in passes 2-4. `dense` is
    the dense chain's FLOP."""
    oh, ow = crop
    big_oh, sh = av.shape
    big_ow, sw = ah.shape
    if bv is None:  # the intermediate F's rows and columns that are read
        need_r, need_c = np.arange(big_oh) < oh, np.arange(big_ow) < ow
    else:
        bv, bh = bv[:oh], bh[:ow]
        need_r, need_c = bv.any(0), bh.any(0)
    av, ah = av[need_r], ah[need_c]
    t_cols = ah.any(0)  # columns of T = Av P that pass 2 reads
    macs = [np.count_nonzero(av) * int(t_cols.sum()),
            np.count_nonzero(ah) * int(av.any(1).sum())]
    weights = np.count_nonzero(av) + np.count_nonzero(ah)
    dense = 2 * big_oh * sw * (sh + big_ow)
    if bv is not None:
        macs += [np.count_nonzero(bv) * int(need_c.sum()),
                 np.count_nonzero(bh) * int(bv.any(1).sum())]
        weights += np.count_nonzero(bv) + np.count_nonzero(bh)
        dense += 2 * big_oh * big_ow * (big_oh + big_ow)
    src = int(av.any(0).sum()) * int(t_cols.sum())
    products = 2 * macs[0] + 3 * sum(macs[1:])
    return {"flop": 2 * sum(macs) * planes, "tf32_flop": 2 * products * planes,
            "dense": dense * planes,
            "nbytes": planes * (src + oh * ow) + 4 * weights}


def _checked_call(dev, name, sw, sh, qs, batch, rng):
    """Build one uniform batch of random sources, run the kernel once and
    hold it against its plain version; returns what timing needs."""
    from fanlin_tpu_torch.spec.query import parse_query
    from fanlin_tpu_torch.ops import fused, plan as plan_mod
    from fanlin_tpu_torch.ops import resample_kernels as rk

    plan = plan_mod.plan_image(sw, sh, parse_query(qs), opaque=True)
    imgs = [rng.integers(0, 256, (sh, sw, 3), dtype=np.uint8)
            for _ in range(batch)]
    asm = fused.BatchAssembly([plan] * batch, imgs, dev)
    check(asm.uses_kernel(), f"{name}: batch does not take the kernel")
    av, ah, bv, bh = plan_mod._uniform_padded(plan)
    flags, fill, box, tav, tah, tbv, tbh = rk.params_from_numpy(
        asm.flags, asm.fill, asm.box, av, ah, bv, bh, device=dev)
    bands = torch.from_numpy(rk.band_ranges(av, ah, bv, bh)).to(dev)
    x = torch.from_numpy(asm.x).to(dev)
    args = (flags, fill, box, tav, tah, x, tbv, tbh)
    crop = (plan.out_h, plan.out_w)

    got = rk.resample_uniform(*args, crop=crop, bands=bands)
    torch.cuda.synchronize()
    want = rk.resample_uniform_ref(*args, crop=crop)
    check(got.shape == want.shape == (asm.b, 3) + crop,
          f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    max_err = int(diff.max())
    frac = float((diff > 0).float().mean())
    print(f"phase2 {name} B={asm.b} src={asm.sh}x{asm.sw} "
          f"out={asm.oh}x{asm.ow} max_abs_err={max_err} frac_diff={frac:.2e}",
          flush=True)
    check(max_err <= MAX_LSB, f"{name}: max abs err {max_err} LSB")
    check(frac <= MAX_FRAC, f"{name}: {frac:.6f} of bytes differ")
    return {"args": args, "crop": crop, "bands": bands,
            "work": resample_work(av, ah, bv, bh, crop, 3 * asm.b),
            "result": {"batch": asm.b, "blur": bv is not None,
                       "max_abs_err": max_err, "frac_diff": frac}}


def phase2(dev: torch.device) -> dict:
    from fanlin_tpu_torch.ops import resample_kernels as rk

    rng = np.random.default_rng(20261016)
    for shape in EDGE_SHAPES:
        _checked_call(dev, *shape, rng)
    results = {}
    for name, sw, sh, qs, batch in SHAPES:
        c = _checked_call(dev, name, sw, sh, qs, batch, rng)
        args, crop, bands = c["args"], c["crop"], c["bands"]
        reps = 5 if name.startswith("12mp") else 20
        ms, plain_ms = _time_pair(
            lambda: rk.resample_uniform_ref(*args, crop=crop),
            lambda: rk.resample_uniform(*args, crop=crop, bands=bands), reps)
        work = c["work"]
        # the least time: the bytes it needs moved once, or its split-TF32
        # products at the tensor cores' TF32 rate
        t_bytes = work["nbytes"] / HBM_BYTES_PER_S * 1e3
        t_flop = work["tf32_flop"] / TF32_FLOP_PER_S * 1e3
        results[name] = dict(c["result"], ms=ms, plain_ms=plain_ms,
                             bound_ms=max(t_bytes, t_flop),
                             bound_by="bytes" if t_bytes >= t_flop
                             else "operations")
        print(f"phase2 {name} needs {work['flop'] / 1e9:.3f} GFLOP of f32 "
              f"multiply-adds ({work['tf32_flop'] / 1e9:.3f} split-TF32 "
              f"GFLOP) of {work['dense'] / 1e9:.3f} dense, "
              f"{work['flop'] / 1e9 / ms:.2f} TFLOP/s on them", flush=True)
        print(f"phase2 {name} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={results[name]['bound_ms']:.4f} "
              f"({results[name]['bound_by']}, {work['nbytes']} B)",
              flush=True)
        if name in ("readme_b16", "blur_b16"):
            results[name]["library_ms"] = _library_ms(rk, args, crop, bands)
    return results


def _library_ms(rk, args, crop, bands) -> float:
    """One torch.einsum at full f32 for the resample's products (the
    gray/invert mask, rounding and canvas epilogue left out), timed in
    turns with the kernel; a yardstick the port never calls."""
    flags, fill, box, av, ah, x, bv, bh = args
    xf = x.to(torch.float32)
    oh, ow = crop
    av, ah = av[:oh], ah[:ow]
    if bv is None:
        lib = lambda: torch.einsum("oh,bchw,vw->bcov", av, xf, ah)
    else:
        bv, bh = bv[:oh, :oh], bh[:ow, :ow]
        lib = lambda: torch.einsum("po,oh,bchw,vw,qv->bcpq", bv, av, xf, ah,
                                   bh)
    t = _time_turns({"library": lib, "kernel": lambda: rk.resample_uniform(
        *args, crop=crop, bands=bands)}, reps=10, launches=1)
    print(f"phase2 library einsum {'with' if bv is not None else 'without'} "
          f"blur: library_ms={t['library']:.4f} kernel_ms={t['kernel']:.4f}",
          flush=True)
    return t["library"]


# (name, source, images, timed): the decode kernels' shapes, lenna at
# each batch the micro-batcher forms. Sources are golden files, PIL
# encodes of seeded images, or coefficient grids made from a seed (PIL
# cannot write 4:4:0). A batch of 5 images runs as B=8 (bucket_b), the
# last three padding.
DECODE_SHAPES = [
    ("lenna444_b1", "lenna", 1, True),
    ("lenna444_b2", "lenna", 2, False),
    ("lenna444_b4", "lenna", 4, False),
    ("lenna444_b8", "lenna", 8, True),
    ("synth420_b8", "synth", 8, False),
    ("synth420_b16", "synth", 16, True),
    ("synth420_n5_b8", "synth", 5, False),
    ("12mp420_b2", "12mp", 2, True),
    ("pil422_b4", "pil422", 4, False),
    ("grid440_b2", "grid440", 2, False),
    ("gridgray_b2", "gridgray", 2, False),
    ("crafted444_b1", "crafted", 1, False),
    ("odd420_641x479_b2", "odd420", 2, False),
    ("odd422_641x479_b2", "odd422", 2, False),
    ("odd440_641x479_n3_b4", "odd440", 3, False),
    ("tiny420_7x5_b1", "tiny420", 1, False),
    ("tiny422_7x5_b1", "tiny422", 1, False),
    ("tiny440_7x5_n3_b4", "tiny440", 3, False),
]
COEF_KIND = {420: "coef", 422: "coef422", 440: "coef440", 444: "coef444"}
# The kernels the serving path launches (K3/K4 are phase 2b's yardstick)
MAIN_PATH_KERNELS = ("resample", "resample_blur", "jpeg_decode_rgb")

# The decode kernel's integer work (csrc/jpeg_decode.cu) in int32
# operations (a multiply-add counts two): a full 8-point islow pass, an
# edge pass (out[0] or out[7] only: 8 multiply-adds, round, shift), one
# 8x8 block (dequant, 16 passes,
# +128 and clamp), a halo row job (8 edge column passes, 1 row pass) and
# a halo column job (8 column passes, 8 edge row passes); and per output
# pixel the upsample (column sums shared by pixel pairs) and jdcolor.
PASS_OPS, EDGE_OPS = 62, 18
BLOCK_OPS = 64 + 16 * PASS_OPS + 3 * 64
ROW_JOB_OPS = 64 + 8 * EDGE_OPS + PASS_OPS + 3 * 8
COL_JOB_OPS = 64 + 8 * PASS_OPS + 8 * EDGE_OPS + 3 * 8
PIXEL_OPS = {444: 22, 422: 30, 440: 30, 420: 34}
# One H100 SXM: 3.35 TB/s of HBM; 495 TFLOP/s of TF32 on the tensor
# cores (dense); int32 at 64 lanes per SM per clock (half the 128 FP32
# lanes behind the 67 TFLOP/s f32 peak), a multiply-add as two
# operations, 132 SMs, 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
INT32_OPS_PER_S = 64 * 2 * 132 * 1.98e9
# (vertical, horizontal) chroma divisors of each layout
DIVISORS = {420: (2, 2), 422: (1, 2), 440: (2, 1), 444: (1, 1)}


def _bound(nbytes: int, ops: int) -> dict:
    """The least time for `nbytes` moved and `ops` int32 operations: the
    larger of the two times, and which it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "int32_ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def halo_share(subsamp: int, tile_h: int, tile_w: int) -> float:
    """The integer work an interior tile recomputes for its chroma halo,
    as a share of its own blocks' work."""
    dv, dh = DIVISORS[subsamp]
    cth, ctw = tile_h // dv, tile_w // dh
    blocks = (tile_h // 8) * (tile_w // 8) + 2 * (cth // 8) * (ctw // 8)
    rows = ctw // 8 + (2 if dh == 2 else 0) if dv == 2 else 0
    cols = cth // 8 if dh == 2 else 0
    halo = 2 * (2 * rows * ROW_JOB_OPS + 2 * cols * COL_JOB_OPS)
    return halo / (blocks * BLOCK_OPS)


def decode_bound(w: int, h: int, subsamp: int, n: int, b: int, sh: int,
                 sw: int) -> dict:
    """The least work of one decode call: the wire of the true MCU grid
    of the n real images read once (and their quant tables), the (b, 3,
    sh, sw) output written once, the integer operations of those blocks
    and of the true rect's pixels; the bound is the larger time."""
    dv, dh = DIVISORS[subsamp]
    ch, cw = -(-h // dv), -(-w // dh)
    blocks = -(-h // 8) * -(-w // 8) + 2 * -(-ch // 8) * -(-cw // 8)
    return _bound(n * (blocks * 128 + 2 * 64 * 4) + b * 3 * sh * sw,
                  n * (blocks * BLOCK_OPS + h * w * PIXEL_OPS[subsamp]))


def _jpeg(img: np.ndarray, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _photo(w: int, h: int, rng) -> np.ndarray:
    """A seeded photo-like image: upsampled low-resolution noise plus
    fine grain."""
    from PIL import Image

    small = rng.integers(0, 256, (max(h // 16, 2), max(w // 16, 2), 3),
                         dtype=np.uint8)
    img = np.asarray(Image.fromarray(small).resize((w, h), Image.BICUBIC),
                     dtype=np.int16)
    img = img + rng.integers(-6, 7, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _grid_meta(w: int, h: int, subsamp: int, rng, gray=False,
               crafted=False) -> dict:
    """A read_jpeg_coeffs dict from seeded coefficient grids of any
    layout, or the crafted out-of-range grid of
    tests/test_jpeg_device_decode.py."""
    dv, dh = DIVISORS[subsamp]
    cshape = (-(-h // (8 * dv)), -(-w // (8 * dh)))
    shapes = [(cshape[0] * dv, cshape[1] * dh), cshape, cshape]
    grids = []
    for bh, bw in shapes:
        g = np.zeros((bh, bw, 64), np.int16)
        g[..., 0] = rng.integers(-60, 60, (bh, bw))
        g[..., 1:12] = rng.integers(-20, 20, (bh, bw, 11))
        grids.append(g)
    q = rng.integers(1, 30, 128).astype(np.uint16)
    if gray:
        grids[1][:] = 0
        grids[2][:] = 0
    if crafted:
        y = grids[0]
        y[0, 0, 0], y[1, 1, 0], y[2, 2, 0] = 1600, -1600, 900
        y[2, 2, 5], y[3, 0, 0], y[3, 0, 3] = 800, -900, -700
        q[:] = 25
    return {"y": grids[0], "cb": grids[1], "cr": grids[2], "lq": q[:64],
            "cq": q[64:], "w": w, "h": h, "subsamp": subsamp, "gray": gray}


def _decode_source(kind: str, rng):
    """(meta, jpeg bytes or None) for a DECODE_SHAPES source."""
    from fanlin_tpu_torch.engine.jpeg_coeffs import read_jpeg_coeffs

    if kind in ("lenna", "synth"):
        with open(os.path.join(GOLDEN, f"{kind}_src.jpg"), "rb") as f:
            data = f.read()
    elif kind == "12mp":
        data = _jpeg(_photo(4000, 3000, rng), quality=90, subsampling=2)
    elif kind == "pil422":
        data = _jpeg(_photo(1001, 667, rng), quality=85, subsampling=1)
    elif kind == "grid440":
        return _grid_meta(999, 661, 440, rng), None
    elif kind.startswith(("odd", "tiny")):
        w, h = (641, 479) if kind.startswith("odd") else (7, 5)
        return _grid_meta(w, h, int(kind[-3:]), rng), None
    elif kind == "gridgray":
        return _grid_meta(640, 479, 444, rng, gray=True), None
    else:
        return _grid_meta(32, 32, 444, rng, crafted=True), None
    meta = read_jpeg_coeffs(data)
    check(meta is not None, f"{kind}: the reader refused the stream")
    return meta, data


def _bytes_differing(a, b) -> tuple:
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"shape {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    return int((d > 0).sum()), int(d.max())


def _time_turns(fns: dict, reps: int, launches: int) -> dict:
    """Median ms per launch of each function: CUDA events around
    `launches` back-to-back calls, in turns a, b, ..., b, a after a
    warm-up."""
    order = list(fns) + list(fns)[::-1]
    for name in order:  # warm-up
        fns[name]()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / launches)
    return {name: statistics.median(t) for name, t in times.items()}


def _device_ms(fn, launches: int, kernels) -> float:
    """Device ms per call of `fn`, which launches one kernel whose name
    contains one of `kernels`: the mean duration of those kernels as
    torch.profiler saw them over `launches` calls. A trace that misses
    some launches (the profiler drops records now and then) is taken
    again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and any(k in e.name for k in kernels)]
        if len(us) == launches:
            return sum(us) / 1000.0 / launches
        print(f"the profiler saw {len(us)} kernels of {kernels} for "
              f"{launches} launches: tracing again", flush=True)
    check(False, f"the profiler missed launches of {kernels} three times")


def _enqueue_ms(fn, calls: int = 50) -> float:
    """Host ms per call over `calls` calls with no synchronize (the
    wrapper's host enqueue), after one warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1000.0 / calls
    torch.cuda.synchronize()
    return ms


def pair_bounds(w: int, h: int, subsamp: int, n: int, b: int, sh: int,
                sw: int, grid_blocks: int) -> tuple:
    """decode_bound's terms for the superseded pair: K3 reads and decodes
    every block of the bucket's grids (grid_blocks per image) and writes
    their u8 planes; K4 reads the true rect's planes and writes the
    output."""
    dv, dh = DIVISORS[subsamp]
    ch, cw = -(-h // dv), -(-w // dh)
    k3 = _bound(b * (grid_blocks * (128 + 64) + 2 * 64 * 4),
                b * grid_blocks * BLOCK_OPS)
    k4 = _bound(n * (h * w + 2 * ch * cw) + b * 3 * sh * sw,
                n * h * w * PIXEL_OPS[subsamp])
    return k3, k4


def phase2b(dev: torch.device) -> dict:
    """The fused decode kernel jpeg_decode_rgb, and K3 + K4 (its first
    form, kept as the yardstick), against their plain versions on the
    same inputs; at the timed shapes, the fused kernel against the pair
    in turns: event ms, device ms, host enqueue, bound and share."""
    from fanlin_tpu_torch.spec.query import parse_query
    from fanlin_tpu_torch.engine.jpeg_coeffs import read_jpeg_coeffs
    from fanlin_tpu_torch.ops import fused, plan as plan_mod
    from fanlin_tpu_torch.ops import jpeg_decode_kernels as jk

    rng = np.random.default_rng(20261017)
    results = {}
    for name, kind, images, timed in DECODE_SHAPES:
        meta, data = _decode_source(kind, rng)
        plan = plan_mod.plan_image(meta["w"], meta["h"],
                                   parse_query("w=300&h=200"), opaque=True)
        asm = fused.CoefBatchAssembly([plan] * images, [meta] * images, dev)
        wire = asm.device_wire()
        up = (asm.subsamp, asm.true_h, asm.true_w, asm.sh, asm.sw)
        dec = up + (images,)
        rgb = jk.jpeg_decode_rgb(*wire, *dec)
        torch.cuda.synchronize()
        fused_diff = _bytes_differing(rgb, jk.jpeg_decode_rgb_ref(*wire, *dec))
        planes = jk.jpeg_islow(*wire)
        torch.cuda.synchronize()
        want = jk.jpeg_islow_ref(*wire)
        k3 = [_bytes_differing(g, w) for g, w in zip(planes, want)]
        pair = jk.jpeg_upsample_rgb(*planes, *up)
        torch.cuda.synchronize()
        k4 = _bytes_differing(pair, jk.jpeg_upsample_rgb_ref(*planes, *up))
        # the staged wire of padded images is zero, so the pair decodes
        # them to the fused kernel's constant
        vs_pair = _bytes_differing(rgb, pair)
        n3 = sum(d for d, _ in k3)
        print(f"phase2b {name} {meta['w']}x{meta['h']} {asm.subsamp} "
              f"B={asm.b} n={images} jpeg_decode_rgb bytes differing "
              f"{fused_diff[0]} (max {fused_diff[1]}), from K3+K4 "
              f"{vs_pair[0]}; K3 bytes differing {n3} (max "
              f"{max(m for _, m in k3)}), K4 {k4[0]} (max {k4[1]}); wire "
              f"{asm.upload_bytes // asm.b} B/img, pixel upload "
              f"{3 * asm.sh * asm.sw} B/img", flush=True)
        check(fused_diff[0] == 0 and vs_pair[0] == 0,
              f"{name}: jpeg_decode_rgb differs from its plain version or "
              "from K3+K4")
        check(n3 == 0 and k4[0] == 0, f"{name}: K3/K4 differ from their "
                                      "plain versions")
        res = {"err": fused_diff[1], "k3_err": max(m for _, m in k3),
               "k4_err": k4[1]}
        if timed:
            big = kind == "12mp"
            ev = _time_turns({
                "fused": lambda: jk.jpeg_decode_rgb(*wire, *dec),
                "pair": lambda: jk.jpeg_upsample_rgb(*jk.jpeg_islow(*wire),
                                                     *up),
                "k3": lambda: jk.jpeg_islow(*wire),
                "k4": lambda: jk.jpeg_upsample_rgb(*planes, *up),
            }, reps=5 if big else 10, launches=20 if big else 100)
            plain = _time_turns({
                "plain": lambda: jk.jpeg_decode_rgb_ref(*wire, *dec),
                "k3": lambda: jk.jpeg_islow_ref(*wire),
                "k4": lambda: jk.jpeg_upsample_rgb_ref(*planes, *up),
            }, reps=3, launches=1)
            dev_ms = {
                "fused": _device_ms(lambda: jk.jpeg_decode_rgb(*wire, *dec),
                                    20, ("decode_rgb_kernel",)),
                "k3": _device_ms(lambda: jk.jpeg_islow(*wire), 20,
                                 ("islow_kernel",)),
                "k4": _device_ms(lambda: jk.jpeg_upsample_rgb(*planes, *up),
                                 20, ("upsample_rgb_kernel",)),
            }
            enq = {"fused": _enqueue_ms(lambda: jk.jpeg_decode_rgb(*wire,
                                                                    *dec)),
                   "pair": _enqueue_ms(lambda: jk.jpeg_upsample_rgb(
                       *jk.jpeg_islow(*wire), *up))}
            bnd = decode_bound(meta["w"], meta["h"], asm.subsamp, images,
                               asm.b, asm.sh, asm.sw)
            grid_blocks = sum(t.shape[1] * t.shape[2] for t in wire[:3])
            b3, b4 = pair_bounds(meta["w"], meta["h"], asm.subsamp, images,
                                 asm.b, asm.sh, asm.sw, grid_blocks)
            res.update(ms=ev["fused"], plain_ms=plain["plain"],
                       device_ms=dev_ms["fused"], enqueue_ms=enq["fused"],
                       pair_ms=ev["pair"],
                       pair_device_ms=dev_ms["k3"] + dev_ms["k4"],
                       pair_enqueue_ms=enq["pair"], k3_ms=ev["k3"],
                       k4_ms=ev["k4"], k3_plain_ms=plain["k3"],
                       k4_plain_ms=plain["k4"], k3_device_ms=dev_ms["k3"],
                       k4_device_ms=dev_ms["k4"], bound=bnd, k3_bound=b3,
                       k4_bound=b4)
            print(f"phase2b {name} jpeg_decode_rgb event_ms={ev['fused']:.4f}"
                  f" device_ms={dev_ms['fused']:.4f} enqueue_ms="
                  f"{enq['fused']:.4f} plain_ms={plain['plain']:.4f}; K3+K4 "
                  f"event_ms={ev['pair']:.4f} device_ms="
                  f"{dev_ms['k3'] + dev_ms['k4']:.4f} (K3 {dev_ms['k3']:.4f}"
                  f" + K4 {dev_ms['k4']:.4f}) enqueue_ms={enq['pair']:.4f}; "
                  f"K3 event_ms={ev['k3']:.4f} plain_ms={plain['k3']:.4f}, "
                  f"K4 event_ms={ev['k4']:.4f} plain_ms={plain['k4']:.4f}",
                  flush=True)
            print(f"phase2b {name} jpeg_decode_rgb needs {bnd['bytes']} B "
                  f"and {bnd['int32_ops']} int32 ops: bound "
                  f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']}, "
                  f"{bnd['bound_ms'] / dev_ms['fused'] * 100:.1f} % of it "
                  f"on device time, "
                  f"{bnd['bound_ms'] / ev['fused'] * 100:.1f} % on event "
                  f"time; K3 bound {b3['bound_ms']:.4f} ms by "
                  f"{b3['bound_by']}, K4 {b4['bound_ms']:.4f} ms by "
                  f"{b4['bound_by']}", flush=True)
        if name in ("lenna444_b1", "12mp420_b2"):
            reps = 20 if kind == "lenna" else 5
            host = []
            for _ in range(reps + 1):
                t0 = time.perf_counter()
                read_jpeg_coeffs(data)
                host.append((time.perf_counter() - t0) * 1000.0)
            print(f"phase2b {name} reader host ms per image (median of "
                  f"{reps}): {statistics.median(host[1:]):.4f}, "
                  f"{len(data)} B of JPEG", flush=True)
        results[name] = res
    for s in (420, 422, 440, 444):
        share = halo_share(s, *jk.decode_tile(s))
        print(f"phase2b halo work of an interior tile, {s}: "
              f"{share * 100:.2f} % of its blocks'", flush=True)
    return results


def _golden_sources():
    from fanlin_tpu_torch.spec.query import parse_query

    for src in ("synth", "lenna"):
        with open(os.path.join(GOLDEN, f"{src}_src.jpg"), "rb") as f:
            data = f.read()
        for cfg, qs in GOLDEN_CASES:
            yield src, data, cfg, parse_query(qs)


def _golden_rgb(name: str) -> np.ndarray:
    from PIL import Image

    with Image.open(os.path.join(GOLDEN, name)) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _counts() -> dict:
    from fanlin_tpu_torch.ops import jpeg_decode_kernels as jk
    from fanlin_tpu_torch.ops import resample_kernels as rk

    return {**rk.launch_counts(), **jk.launch_counts()}


def _reset_counts() -> None:
    from fanlin_tpu_torch.ops import jpeg_decode_kernels as jk
    from fanlin_tpu_torch.ops import resample_kernels as rk

    rk.reset_launch_counts()
    jk.reset_launch_counts()


def phase3_pre_encode(dev: torch.device) -> None:
    """The pre-encode golden floor through the pixel and the coefficient
    assemblies on the card, and the two equal byte for byte (the decode
    is libjpeg's). Runs outside the launch-count windows."""
    from fanlin_tpu_torch.engine import codecs
    from fanlin_tpu_torch.engine.jpeg_coeffs import read_jpeg_coeffs
    from fanlin_tpu_torch.ops import fused, plan as plan_mod

    for src, data, cfg, q in _golden_sources():
        img, has_alpha, _ = codecs.decode(data)
        meta = read_jpeg_coeffs(data)
        check(meta is not None, f"{src}: the reader refused a golden source")
        plan = plan_mod.plan_image(img.shape[1], img.shape[0], q,
                                   opaque=not has_alpha)
        pixel = fused.make_assembly([plan], [img], ["rgb"], dev).run()[0]
        coef = fused.make_assembly([plan], [meta], [COEF_KIND[meta["subsamp"]]],
                                   dev).run()[0]
        golden = _golden_rgb(f"{src}_{cfg}.png")
        d_px, d_coef = psnr(pixel[:, :, :3], golden), psnr(coef[:, :, :3], golden)
        differ = int((pixel != coef).sum())
        print(f"phase3 {src}/{cfg} pre-encode pixel {d_px:.2f} dB, coef "
              f"{d_coef:.2f} dB, {differ} bytes differ", flush=True)
        check(min(d_px, d_coef) >= 50.0, f"{src}/{cfg}: pre-encode < 50 dB")
        check(differ == 0, f"{src}/{cfg}: coefficient and pixel paths differ")


def phase3_engine(dev: torch.device, device_decode: bool):
    """The port's Engine on the golden corpus: the encoded floor, and
    per request one resample launch, plus one jpeg_decode_rgb launch (and
    none of K3/K4) and a coef_src count on the coefficient path. Returns
    (engine, requests)."""
    from PIL import Image

    from fanlin_tpu_torch.spec.content import Format
    from fanlin_tpu_torch.engine import Engine

    engine = Engine(dev, device_decode=device_decode)
    path = "coef" if device_decode else "pixel"
    n = 0
    for src, data, cfg, q in _golden_sources():
        before = _counts()
        mime, payload = engine.process_image(data, q, Format())
        added = {k: v - before[k] for k, v in _counts().items()}
        n += 1
        resample = added["resample"] + added["resample_blur"]
        decode = (added["jpeg_decode_rgb"], added["jpeg_islow"],
                  added["jpeg_upsample_rgb"])
        check(resample == 1
              and decode == ((1, 0, 0) if device_decode else (0, 0, 0)),
              f"{path} {src}/{cfg}: launches {added}")
        check(mime == "image/jpeg", f"{src}/{cfg}: mime {mime}")
        with Image.open(io.BytesIO(payload)) as im:
            got = np.asarray(im.convert("RGB"), dtype=np.uint8)
        golden_enc = _golden_rgb(f"{src}_{cfg}.jpg")
        check(got.shape == golden_enc.shape, f"{src}/{cfg}: shape")
        d_enc = psnr(got, golden_enc)
        print(f"phase3 {path} {src}/{cfg} encoded {d_enc:.2f} dB, "
              f"launches {added}", flush=True)
        check(d_enc >= 45.0, f"{src}/{cfg}: encoded {d_enc:.2f} dB < 45")
    want = {"pixel_src": 0, "coef_src": n} if device_decode else \
        {"pixel_src": n, "coef_src": 0}
    check(engine.stats == want, f"{path} engine stats {engine.stats}")
    return engine, n


def readme_stage_times(engine, label: str) -> dict:
    """Median Server-Timing marks of the README request (lenna_src.jpg
    -> w=300&h=200 JPEG) over 30 requests after 5 warm-up requests."""
    from fanlin_tpu_torch.spec.content import Format
    from fanlin_tpu_torch.spec.query import parse_query

    with open(os.path.join(GOLDEN, "lenna_src.jpg"), "rb") as f:
        data = f.read()
    q = parse_query("w=300&h=200")
    for _ in range(5):
        engine.process_image(data, q, Format())
    rows = []
    for _ in range(30):
        marks = []
        t0 = time.perf_counter()
        engine.process_image(data, q, Format(), marks)
        rows.append(dict(marks, total=(time.perf_counter() - t0) * 1000.0))
    med = {k: statistics.median(r[k] for r in rows)
           for k in ("f_decode", "f_device", "f_encode", "total")}
    print(f"phase3 README {label} path stage ms (median of 30): "
          + ", ".join(f"{k} {v:.4f}" for k, v in med.items()), flush=True)
    return med


def _server_config(extra_providers=()):
    from fanlin_tpu_torch.config import Config

    return Config.from_obj({
        "port": 0, "bind_addr": "127.0.0.1", "max_clients": 8,
        "client": {"s3": {"aws_region": "x"},
                   "web": {"user_agent": "chip-smoke", "timeout": 2}},
        "providers": [{"path": "baz", "src": "file://localhost" + GOLDEN},
                      *extra_providers],
    })


async def _phase4(dev: torch.device) -> None:
    import aiohttp
    from aiohttp import web
    from PIL import Image

    from fanlin_tpu_torch.server.app import build_state, create_app

    cfg = _server_config()
    state = await build_state(cfg)
    check(state.engine.runner.device.type == "cuda", "server not on CUDA")
    runner = web.AppRunner(create_app(cfg, state), access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = runner.addresses[0][1]
    base = f"http://127.0.0.1:{port}"
    try:
        async with aiohttp.ClientSession() as s:
            async with s.get(base + "/ping") as r:
                check(r.status == 200 and await r.text() == "pong", "ping")
            async with s.get(base + "/baz/lenna_src.jpg?w=300&h=200") as r:
                body = await r.read()
                check(r.status == 200, f"transform status {r.status}")
                check(r.headers["Content-Type"] == "image/jpeg", "jpeg mime")
                with Image.open(io.BytesIO(body)) as im:
                    check(im.size == (300, 200), f"size {im.size}")
            async with s.get(base + "/baz/lenna_src.jpg?w=300&h=200"
                             "&webp=true&quality=20",
                             headers={"Accept": "image/webp"}) as r:
                await r.read()
                check(r.status == 200 and
                      r.headers["Content-Type"] == "image/webp", "webp")
            async with s.get(base + "/baz/lenna_src.jpg?w=100&h=80&blur=1") as r:
                await r.read()
                check(r.status == 200, f"blur status {r.status}")
            async with s.get(base + "/baz/missing.jpg?w=300&h=200") as r:
                check(r.status == 404, f"missing status {r.status}")
            async with s.get(base + "/stats") as r:
                stats = await r.text()
                print("phase4 /stats", stats, flush=True)
                check(json.loads(stats)["engine"]["coef_src"] > 0,
                      "the server served no JPEG through the coefficient "
                      "path")
    finally:
        await runner.cleanup()
    print("phase4 ping, jpeg 300x200, webp, blur, 404, coef_src: ok",
          flush=True)


def _gen_sources() -> str:
    """Phase 5 (c)'s sources, made from a seed into build/chip_smoke/
    (git-ignored): an EXIF orientation 6 JPEG (4:2:0, MCU-aligned) and
    a progressive one. Returns the directory."""
    from PIL import Image

    rng = np.random.default_rng(20261018)
    exif = Image.Exif()
    exif[0x0112] = 6
    files = {
        "rot6.jpg": _jpeg(_photo(640, 480, rng), quality=90, subsampling=2,
                          exif=exif),
        "progressive.jpg": _jpeg(_photo(800, 600, rng), quality=85,
                                 subsampling=2, progressive=True),
    }
    out = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out, exist_ok=True)
    for name, data in files.items():
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
    return out


class _BatchLog:
    """While active, records each batch the batcher assembles:
    (images, distinct plans, distinct kinds, uses_kernel())."""

    def __init__(self):
        from fanlin_tpu_torch.ops import fused

        self.rows = []
        self._fused = fused
        self._real = fused.make_assembly

    def __enter__(self):
        def make(plans, payloads, kinds, device):
            asm = self._real(plans, payloads, kinds, device)
            self.rows.append((len(plans), len({id(p) for p in plans}),
                              len(set(kinds)), asm.uses_kernel()))
            return asm

        self._fused.make_assembly = make
        return self

    def __exit__(self, *exc):
        self._fused.make_assembly = self._real


def _thread_burst(engine, data: bytes, qs: str, n: int):
    """n concurrent requests from n threads released together through
    `engine`; returns (bodies, wall seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    from fanlin_tpu_torch.spec.content import Format
    from fanlin_tpu_torch.spec.query import parse_query

    q = parse_query(qs)
    gate = threading.Barrier(n)

    def one():
        gate.wait()
        return engine.process_image(data, q, Format())[1]

    with ThreadPoolExecutor(n) as ex:
        t0 = time.perf_counter()
        bodies = [f.result() for f in [ex.submit(one) for _ in range(n)]]
        return bodies, time.perf_counter() - t0


async def _burst(session, base, urls):
    """All of `urls` at once; returns (bodies, wall seconds)."""
    async def one(url):
        async with session.get(base + url) as r:
            body = await r.read()
            check(r.status == 200, f"{url}: status {r.status}")
            return body

    t0 = time.perf_counter()
    bodies = await asyncio.gather(*(one(u) for u in urls))
    return bodies, time.perf_counter() - t0


def _serial_body(engine, url: str, folder: str) -> bytes:
    from fanlin_tpu_torch.spec.content import Format
    from fanlin_tpu_torch.spec.query import parse_query

    path, _, qs = url.partition("?")
    with open(os.path.join(folder, os.path.basename(path)), "rb") as f:
        return engine.process_image(f.read(), parse_query(qs), Format())[1]


def _busy_share(prof, wall_s: float) -> tuple:
    """(device ms, busy share): the union of the CUDA activity
    intervals (kernels, copies) the profiler saw, over the wall time."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    return busy_us / 1000.0, busy_us / 1e6 / wall_s


async def _phase5(dev: torch.device) -> dict:
    """The micro-batcher on the card: launch-count windows for bursts
    (a), (b) and (c), and the timings of (d). Returns the windows."""
    import aiohttp
    from aiohttp import web
    from torch.profiler import ProfilerActivity, profile

    from fanlin_tpu_torch.spec.content import Format
    from fanlin_tpu_torch.spec.query import parse_query
    from fanlin_tpu_torch.engine import Engine
    from fanlin_tpu_torch.server.app import build_state, create_app

    gen = _gen_sources()
    cfg = _server_config([{"path": "gen", "src": "file://localhost" + gen}])
    check((cfg.tpu.max_batch, cfg.tpu.batch_window_ms) == (8, 2.0),
          "phase 5 runs the default batcher config")
    state = await build_state(cfg, device=dev)
    batcher = state.engine.runner.batcher
    serial = Engine(dev)
    runner = web.AppRunner(create_app(cfg, state), access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    base = f"http://127.0.0.1:{runner.addresses[0][1]}"
    readme = "/baz/lenna_src.jpg?w=300&h=200"
    with open(os.path.join(GOLDEN, "lenna_src.jpg"), "rb") as f:
        lenna = f.read()
    mixed = [f"/baz/{src}_src.jpg?{qs}" for src in ("lenna", "synth")
             for qs in ("w=300&h=200", "w=120&h=90", "w=100&h=80&blur=1")]
    oriented = ["/gen/rot6.jpg?w=300&h=200", "/gen/progressive.jpg?w=300&h=200"]
    want = {u: _serial_body(serial, u, gen if u.startswith("/gen") else GOLDEN)
            for u in [readme, *mixed, *oriented]}
    windows = {}
    try:
        async with aiohttp.ClientSession() as s:
            # warm-up: every request once (plans, cached matrices)
            await _burst(s, base, [readme, *mixed, *oriented])
            for name, urls in (("phase5a", [readme] * 16),
                               ("phase5b", mixed * 3),
                               ("phase5c", oriented * 2)):
                before = dict(batcher.stats)
                engine_before = dict(state.engine.stats)
                with _BatchLog() as log:
                    _reset_counts()
                    if name == "phase5a":
                        bodies, wall = await asyncio.to_thread(
                            _thread_burst, state.engine, lenna, "w=300&h=200",
                            16)
                    else:
                        bodies, wall = await _burst(s, base, urls)
                    windows[name] = _counts()
                images = batcher.stats["images"] - before["images"]
                batches = batcher.stats["batches"] - before["batches"]
                w = windows[name]
                print(f"{name} {len(urls)} requests: {batches} batches "
                      f"{[r[0] for r in log.rows]}, launches {w}, "
                      f"wall {wall * 1000:.3f} ms", flush=True)
                check(images == len(urls), f"{name}: {images} images")
                check(len(log.rows) == batches
                      and all(r[1] == r[2] == 1 and r[3] for r in log.rows),
                      f"{name}: a batch mixed groups or skipped the kernel: "
                      f"{log.rows}")
                check(w["resample"] + w["resample_blur"] == batches
                      and w["jpeg_decode_rgb"] == batches
                      and w["jpeg_islow"] == w["jpeg_upsample_rgb"] == 0,
                      f"{name}: launches {w} for {batches} batches")
                check(all(b == want[u] for u, b in zip(urls, bodies)),
                      f"{name}: a batched body differs from the serial one")
                if name == "phase5a":
                    check(batches <= 4 and batches < 16,
                          f"phase5a: 16 requests in {batches} batches")
                if name == "phase5c":
                    added = {k: v - engine_before[k]
                             for k, v in state.engine.stats.items()}
                    check(added == {"pixel_src": 0, "coef_src": len(urls)},
                          f"phase5c: engine counted {added}")

            # (d) 16 README requests: serial, the locked runner from 16
            # threads and over HTTP, and batched from 16 threads and over
            # HTTP; median of 5 each
            q = parse_query("w=300&h=200")
            batching = state.engine.runner
            walls = {"serial": [], "locked_16_threads": [],
                     "batched_16_threads": [], "locked_http": [],
                     "batched_http": []}
            for _ in range(5):
                t0 = time.perf_counter()
                for _ in range(16):
                    serial.process_image(lenna, q, Format())
                walls["serial"].append(time.perf_counter() - t0)
                for mode, engine in (("locked_16_threads", serial),
                                     ("batched_16_threads", state.engine)):
                    walls[mode].append((await asyncio.to_thread(
                        _thread_burst, engine, lenna, "w=300&h=200", 16))[1])
                state.engine.runner = serial.runner
                try:
                    walls["locked_http"].append(
                        (await _burst(s, base, [readme] * 16))[1])
                finally:
                    state.engine.runner = batching
                walls["batched_http"].append(
                    (await _burst(s, base, [readme] * 16))[1])
            for mode, ws in walls.items():
                med = statistics.median(ws)
                print(f"phase5d {mode}: 16 README requests in "
                      f"{med * 1000:.3f} ms (median of 5), "
                      f"{16 / med:.2f} img/s", flush=True)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _, wall = await _burst(s, base, [readme] * 16)
                torch.cuda.synchronize()
            dev_ms, share = _busy_share(prof, wall)
            check(dev_ms > 0, "the profiler saw no device activity")
            print(f"phase5d batched_http under torch.profiler: wall "
                  f"{wall * 1000:.3f} ms, device busy {dev_ms:.4f} ms, "
                  f"busy share {share * 100:.2f} %", flush=True)
            async with s.get(base + "/stats") as r:
                print("phase5 /stats batcher",
                      json.dumps(json.loads(await r.text())["batcher"]),
                      flush=True)
    finally:
        await runner.cleanup()
    check(batcher._closed, "cleanup did not close the batcher")
    return windows


def main() -> int:
    smi = phase0()
    from fanlin_tpu_torch import device as device_mod

    device_mod.configure()
    dev = device_mod.cuda_device()
    phase1()
    bench = phase2(dev)
    _reset_counts()
    decode = phase2b(dev)
    checked = _counts()  # phase 2b's launches: checks and timing only
    phase3_pre_encode(dev)

    # the main path's launch-count windows: each run is driven with the
    # counts set to 0 just before it and read just after it
    windows = {}
    _reset_counts()
    pixel_engine, n_pixel = phase3_engine(dev, device_decode=False)
    windows["pixel engine"] = _counts()
    _reset_counts()
    coef_engine, n_coef = phase3_engine(dev, device_decode=True)
    windows["coef engine"] = _counts()
    _reset_counts()
    asyncio.run(_phase4(dev))
    windows["server"] = _counts()
    windows.update(asyncio.run(_phase5(dev)))
    for name, c in windows.items():
        print(f"launch counts ({name}): {c}", flush=True)
    w = windows["coef engine"]
    check(w["resample"] + w["resample_blur"] == n_coef
          and w["jpeg_decode_rgb"] == n_coef
          and w["jpeg_islow"] == w["jpeg_upsample_rgb"] == 0,
          f"coefficient engine launched {w} for {n_coef} requests")
    w = windows["pixel engine"]
    check(w["resample"] + w["resample_blur"] == n_pixel
          and w["jpeg_decode_rgb"] == w["jpeg_islow"]
          == w["jpeg_upsample_rgb"] == 0,
          f"pixel engine launched {w} for {n_pixel} requests")
    for name in MAIN_PATH_KERNELS:
        for path in ("coef engine", "server", "phase5b"):
            check(windows[path][name] > 0,
                  f"kernel {name} was never launched by the {path} run")
    launches = {k: sum(c[k] for c in windows.values())
                for k in windows["server"]}
    readme_stage_times(pixel_engine, "pixel")
    readme_stage_times(coef_engine, "coefficient")
    check("jax" not in sys.modules, "jax was imported")
    check("fanlin_tpu" not in sys.modules, "fanlin_tpu was imported")

    k1 = [r for r in bench.values() if not r["blur"]]
    k2 = bench["blur_b16"]
    k34 = decode["synth420_b16"]
    src = "fanlin_tpu_torch/csrc/jpeg_decode.cu"
    kernels = [
        {"name": "resample_uniform", "route": "cuda",
         "source": "fanlin_tpu_torch/csrc/resample.cu",
         "replaces": "fanlin_tpu/ops/pallas_kernels.py:86",
         "launches": launches["resample"],
         "max_abs_err": max(r["max_abs_err"] for r in k1),
         "ms": bench["readme_b16"]["ms"],
         "plain_ms": bench["readme_b16"]["plain_ms"],
         "bound_ms": bench["readme_b16"]["bound_ms"],
         "bound_by": bench["readme_b16"]["bound_by"],
         "library_ms": bench["readme_b16"]["library_ms"]},
        {"name": "resample_uniform_blur", "route": "cuda",
         "source": "fanlin_tpu_torch/csrc/resample.cu",
         "replaces": "fanlin_tpu/ops/pallas_kernels.py:91",
         "launches": launches["resample_blur"],
         "max_abs_err": max(r["max_abs_err"] for r in bench.values()
                            if r["blur"]),
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"]},
        {"name": "jpeg_decode_rgb", "route": "cuda", "source": src,
         "replaces": "fanlin_tpu/ops/jpeg_decode.py:158, "
                     "fanlin_tpu/ops/jpeg_decode.py:243",
         "launches": launches["jpeg_decode_rgb"],
         "max_abs_err": max(r["err"] for r in decode.values()),
         "ms": k34["ms"], "plain_ms": k34["plain_ms"],
         "bound_ms": k34["bound"]["bound_ms"],
         "bound_by": k34["bound"]["bound_by"], "library_ms": None},
        # superseded by jpeg_decode_rgb, off the main path (0 launches
        # there), kept as its yardstick: checked_launches are phase 2b's
        {"name": "jpeg_islow", "route": "cuda", "source": src,
         "replaces": "fanlin_tpu/ops/jpeg_decode.py:158",
         "launches": launches["jpeg_islow"],
         "checked_launches": checked["jpeg_islow"],
         "max_abs_err": max(r["k3_err"] for r in decode.values()),
         "ms": k34["k3_ms"], "plain_ms": k34["k3_plain_ms"],
         "bound_ms": k34["k3_bound"]["bound_ms"],
         "bound_by": k34["k3_bound"]["bound_by"], "library_ms": None},
        {"name": "jpeg_upsample_rgb", "route": "cuda", "source": src,
         "replaces": "fanlin_tpu/ops/jpeg_decode.py:243",
         "launches": launches["jpeg_upsample_rgb"],
         "checked_launches": checked["jpeg_upsample_rgb"],
         "max_abs_err": max(r["k4_err"] for r in decode.values()),
         "ms": k34["k4_ms"], "plain_ms": k34["k4_plain_ms"],
         "bound_ms": k34["k4_bound"]["bound_ms"],
         "bound_by": k34["k4_bound"]["bound_by"], "library_ms": None},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
