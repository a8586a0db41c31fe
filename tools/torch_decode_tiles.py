#!/usr/bin/env python3
"""Tile heights of the port's fused decode kernel
(fanlin_tpu_torch/csrc/jpeg_decode.cu, jpeg_decode_rgb) on one CUDA card.

Usage, from the repository root:  python3 tools/torch_decode_tiles.py

Builds the kernel library once per tile height (ops/_build.py's
`nvcc_flags`, the chroma rows per CTA: 4:2:0 and 4:4:0 tiles are twice
as many output rows high; threads and the register cap follow from the
tile), checks each against the plain version (0 bytes differing) on
chip_smoke.py's timed decode shapes, and prints each variant's device ms
per call (torch.profiler, 50 calls) in turns over the variants, median
of 6. The height ops/_build.py compiles in is the first.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# chroma rows per tile (_build.DEC_TILE_H first); tile_w is DEC_TILE_W
VARIANTS = [16, 8, 32]
SHAPES = [("lenna444_b1", "lenna", 1), ("lenna444_b8", "lenna", 8),
          ("synth420_b16", "synth", 16), ("12mp420_b2", "12mp", 2),
          ("pil422_b4", "pil422", 4), ("grid440_b2", "grid440", 2)]


def main() -> int:
    if not torch.cuda.is_available():
        print("CUDA is not available", flush=True)
        return 2
    import chip_smoke
    from fanlin_tpu_torch import device as device_mod
    from fanlin_tpu_torch.ops import _build, fused, plan as plan_mod
    from fanlin_tpu_torch.ops import jpeg_decode as jd
    from fanlin_tpu_torch.ops import jpeg_decode_kernels as jk
    from fanlin_tpu_torch.spec.query import parse_query

    device_mod.configure()
    dev = device_mod.cuda_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = list(pool.map(
            lambda h: _build.load(_build.nvcc_flags(h)).fanlin_jpeg_decode_rgb,
            VARIANTS))
    rng = np.random.default_rng(20261017)
    for name, kind, images in SHAPES:
        meta, _ = chip_smoke._decode_source(kind, rng)
        plan = plan_mod.plan_image(meta["w"], meta["h"],
                                   parse_query("w=300&h=200"), opaque=True)
        asm = fused.CoefBatchAssembly([plan] * images, [meta] * images, dev)
        y, cb, cr, q = asm.device_wire()
        dec = (asm.subsamp, asm.true_h, asm.true_w, asm.sh, asm.sw, images)
        want = jk.jpeg_decode_rgb_ref(y, cb, cr, q, *dec)
        out = torch.empty_like(want)
        stream = torch.cuda.current_stream(dev).cuda_stream

        dv = jd.chroma_divisors(asm.subsamp)[0]  # tile rows per chroma row

        def call(fn, h):
            rc = fn(y.data_ptr(), cb.data_ptr(), cr.data_ptr(), q.data_ptr(),
                    out.data_ptr(), asm.b, images, y.shape[1], y.shape[2],
                    cb.shape[1], cb.shape[2], asm.subsamp, asm.true_h,
                    asm.true_w, asm.sh, asm.sw, h * dv, _build.DEC_TILE_W,
                    stream)
            if rc:
                raise SystemExit(f"launch failed: CUDA error {rc}")

        for v, fn in zip(VARIANTS, libs):
            out.zero_()
            call(fn, v)
            torch.cuda.synchronize()
            diff = int((out != want).sum())
            chip_smoke.check(diff == 0, f"{name} variant {v}: {diff} bytes "
                                        "differ from the plain version")
        times = {v: [] for v in VARIANTS}
        order = list(zip(VARIANTS, libs))
        for _ in range(3):
            for v, fn in order + order[::-1]:
                times[v].append(chip_smoke._device_ms(
                    lambda: call(fn, v), 50, ("decode_rgb_kernel",)))
        print(f"{name} B={asm.b} n={images}: device ms, median of 6 "
              "(0 bytes differing in every variant): " + ", ".join(
                  f"{v * dv}x{_build.DEC_TILE_W} {statistics.median(t):.4f}"
                  for v, t in times.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
