#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fanlin_tpu_torch) on one CUDA card.

Usage, from the repository root:  python3 chip_smoke.py

Phases (each failure exits non-zero; nothing is caught):
  0. versions, card name and power limit (nvidia-smi), host codecs and
     PIL's littlecms2 (required: the host ICC route); exits non-zero
     when CUDA is absent
  1. build the CUDA kernels (csrc/resample.cu, csrc/jpeg_decode.cu,
     csrc/cmyk_lut.cu, one nvcc each, started together) and the host
     JPEG entropy reader and
     encoder (csrc/jpeg_coeffs.cpp, csrc/jpeg_encode.cpp, the host C++
     compiler)
  2. the resample kernel against its plain torch version on the card at
     the main path's shapes (the README request at every batch size the
     batcher forms, B = 1, 2, 4, 8 for max_batch 8, and at B=16) and at
     bucket edges (<= 1 LSB, <= 0.5 % of bytes differing), with median
     times (CUDA events, plain/kernel/kernel/plain turns), the GFLOP the
     weights need and the TFLOP/s they give, the bound (bytes, or the
     split-TF32 products at the TF32 rate), and at README and blur B=16
     one full-f32 torch.einsum of the same products (library ms)
  2b. the fused decode kernel jpeg_decode_rgb against its plain
     version, 0 differing bytes, on lenna (4:4:4) at B = 1, 2, 4, 8,
     synth (4:2:0) at B = 8, 16 and 5 real of B=8, a 12 MP 4:2:0 q90
     JPEG B=2, a 4:2:2 JPEG B=4, 4:4:0 and gray batches from seeded
     coefficient grids, the crafted out-of-range grid, and odd true dims
     (641x479, 7x5) in 4:2:0, 4:2:2 and 4:4:0; each batch again from
     prestaged pinned wire slots (the unzeroed device wire, its padding
     images poisoned): 0 differing decode bytes against the plain
     version of a zeroed wire and the same served images as the
     dict-staged batch; each batch again read by the serving engine's
     slot route (the entropy reader writing each image straight into a
     pinned slot; a JPEG of the shape's geometry where the shape has
     none), 0 differing decode bytes against the dict route of the same
     JPEG, the 12 MP slots' first in the block of a dropped camera slot
     filled with 0x7F; a slot dropped while its upload waits behind a
     long kernel is not reused before the copy (torch's caching host
     allocator), 0 differing decode bytes; at lenna B=1 and B=8,
     synth B=16 and 12 MP B=2 its CUDA event ms over many launches,
     device ms from torch.profiler, host enqueue ms over 50 calls without
     a synchronize and plain ms, the bytes and int32 operations each
     shape needs, its bound and the share reached; the host ms per image
     of the reader, the dict route and the slot route, in turns, and the
     wire's bytes per image
  2c. a progressive 12 MP original (4032x3024 q90 4:2:0, PIL's
     progressive script) and its baseline twin of the same pixels: the
     header reports each coding process and the reader 10 and 1 scans;
     the progressive stream read by the slot route (a pinned slot) and by
     the dict route, and its baseline twin, give planes and tables with 0
     differing bytes, and jpeg_decode_rgb on the card 0 differing bytes
     and the same served image for the slot and the baseline twin; the
     host ms per image of the baseline and the progressive reader, and of
     each slot route, alone, in turns
  3. the golden floors of tests/test_golden_parity.py on tests/golden
     through both source paths: the pre-encode floor through the pixel
     and the coefficient assemblies, then the encoded floor through
     Engine(dev, device_decode=False), each request of which launches
     one resample kernel, and through Engine(dev), each request of
     which must take the coefficient path and launch one resample and one
     jpeg_decode_rgb; the README request's stage times on both paths
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
  6. the jpegdct sink (tpu.device_dct): (a) the K9 tail
     (ops/dct.ycbcr420_to_planar, torch code) on the card against the
     same function on the CPU, 0 coefficients differing, at README B=1
     and 8, 301x199 B=4 (q 50/75/100 each) and 12 MP B=2; (b) the port's
     encoder on the card's tail output: read back by the port's reader
     it gives the tail's blocks within the true block counts, noise in
     the padded blocks past them leaves the bytes unchanged (libjpeg's
     dummy blocks), PIL opens it; (c) the golden corpus through
     Engine(dev, device_dct=True) and Engine(dev, device_decode=False,
     device_dct=True): >= 44 dB against the golden JPEGs (the JAX
     package's own jpegdct route scores 44.09 dB at worst there; the
     45 dB floor is for libjpeg's integer DCT), one resample (plus one
     jpeg_decode_rgb on the coefficient route) per request, every
     request on a jpegdct batch; (d) the server with "tpu":
     {"device_dct": true}: the README request 200 image/jpeg, and 16
     README requests from 16 threads in <= 4 batches with the bodies of
     a serial Engine(dev, device_dct=True);
     (e) README stage times of the jpegdct and the default route in
     turns, the tail's device ms (torch.profiler, all its kernels) and
     event ms at README B=8 and 12 MP B=2 beside its bound (bytes at
     3.35 TB/s), the encoder's host ms per README image; (f) one small
     source per format decoded outside PIL (QOI, farbfeld, HDR, PAM,
     16-bit PNM/PNG/TIFF, float TIFF, 16-bit gray TIFF, OpenEXR), made
     from a seed into build/chip_smoke/, through Engine(dev): served
     with its format's mime type
  7. the CMYK / ICC path, from two synthetic ICC profiles and sources
     written from a seed into build/chip_smoke/: (a) the fused kernel
     jpeg_decode_cmyk_rgb (the 4-component decode converting through the
     packed ICC LUT in its colour stage) against its plain version (K12b's
     plain version of K12a's) over the whole output, and K12a
     jpeg_decode_cmyk (its yardstick) against its own, the fused kernel
     again on prestaged pinned wire slots (the unzeroed device wire, its
     padding images poisoned) against the plain version of a zeroed
     wire, and (b) K12b
     cmyk_lut (planar and pixel forms) against its plain version, 0 bytes
     differing, on CMYK and YCCK 4:4:4 (PIL streams and their Adobe
     flips), YCCK 4:2:0 grids, odd dims (641x479, 7x5), B = 1, 8, a
     padded batch and 12 MP CMYK q95 B=2; (c) 2048x2048 CMYK 4:4:4 q95
     print assets (plain, the YCCK flip, one with an embedded profile)
     through Engine(dev, cmyk2rgb, use_embedded_profile=True) with
     enable_device_icc(): each request on the coefficient path with one
     jpeg_decode_cmyk_rgb and one resample, its batch kind (cmyk444,
     cmyk444y, cmyk444@<key>); an EXIF-rotated one on the pixel route
     with one K12b and one resample; each >= 40 dB against the host lcms2
     route; and the stage times of both routes in turns; (d) the server
     with profile_path and tpu.device_icc: a print asset over HTTP, then
     16 README-size CMYK requests from 16 threads in <= 4 batches with
     the serial Engine's bodies, one jpeg_decode_cmyk_rgb per batch; (e)
     in turns, event ms of the fused kernel, the pair (K12a then K12b)
     and each alone, their device ms, plain ms, bound and share at
     README-like B=8 (lenna as CMYK) and 12 MP B=2
  8. worker mode (tpu.workers): `python -m fanlin_tpu_torch.cli` in
     subprocesses on the card, over the golden files and phase 5's and
     7's folder, every wait bounded: (a) boot with "workers": 4, one
     device-service banner and four worker banners (their pids); (b) the
     README request, its WebP and blur variants, synth (4:2:0), the
     EXIF-6 and the progressive JPEG, a PNG and a CMYK print asset, each
     on its own connection, byte-equal to the single-process server's
     (build_state on the card in this process, CMYK on host lcms2 as in
     worker mode); (c) a worker's /stats shows the service's launches of
     resample, resample_blur and jpeg_decode_rgb, and a 16-request README
     burst rides uniform batches (one resample and one jpeg_decode_rgb
     launch per batch); (d) the card has one client: the service holds
     the CUDA device files and no worker does, and no worker pid is among
     nvidia-smi's compute apps; (e) 16 and 64 concurrent README requests
     over HTTP against workers 1, 2 and 4 in turns, median of 5: img/s,
     batches/images and the median f_device; (f) spawn to the first 200
     and the first request's latency against the tenth's, warmup on and
     off, beside phase 1's build seconds; (g) "source_cache_mb": 64 and
     three variants of lenna on one connection: bodies of the uncached
     server, 2 hits; (h) SIGTERM: exit 0 within 15 s, no worker left
  9. the folded fast path (tpu.fast_decode: K11, torch code) and
     tpu.data_parallel on one card: (a) K11
     (jpeg_decode.folded_decode_resample) on the card against the same
     code on the CPU at full f32, <= 1 LSB and <= 0.5 % differing, over
     its f32 output and the folded route's pixels, on README 4:4:4 B=1,
     8, 16, synth 4:2:0 B=16, 4:2:2, 4:4:0 and gray sources, odd dims
     (641x479, 7x5), 12 MP 4:2:0 B=2 and blur; (b) the golden corpus
     through Engine(dev, fast_decode=True) against Engine(dev), >= 45 dB
     each: a folded request counts coef_src and launches neither
     jpeg_decode_rgb nor the resample kernel, a grayscale or invert one
     one of each; (c) the server with "tpu": {"fast_decode": true}: the
     README request, its WebP and blur variants and synth answer 200
     with a serial Engine's bodies, 16 README requests from 16 threads
     ride <= 4 folded batches with no decode or resample launch, and at
     workers 4 every body equals the single process's (the service
     launching neither kernel); (d) "tpu": {"data_parallel": true} in
     one process and at workers 4: the default config's bodies, only the
     service holding the card; (e) at README B=1, 8, 16, synth B=16 and
     12 MP B=2, in turns, the folded route (K11, composite, crop) against
     the staged one (jpeg_decode_rgb, then the resample kernel) from the
     same uploaded wire, and K11 alone: event ms, device ms and kernels
     per call (torch.profiler), K11's bound (FLOP of its products at the
     f32 rate, bytes at 3.35 TB/s) and its CPU ms; the README request's
     stage times with fast_decode and the default route in turns
 10. tpu.fast (the bf16 resample: the resample kernel's bf16 form, the
     torch chain's, K11's AC pairs) and tpu.profile_dir: (a) the fast
     kernel against its plain version (resample_uniform_ref(fast=True))
     at README B=1/8/16, gray, invert, canvas, blur B=16 and 12 MP B=2
     with and without blur, <= 1 LSB and <= 0.5 % differing; (b) the
     golden corpus through Engine(dev, fast=True) against Engine(dev),
     >= 48 dB on the device result before the encode, one
     jpeg_decode_rgb and one fast resample launch a request; (c) the
     server with "tpu": {"fast": true} over phase 8's requests and an
     alpha PNG in one process and at workers 4, byte-equal between the
     two, every kernel batch on resample_fast / resample_blur_fast and
     none on the split keys (at workers 4 over the service's life,
     warmup included); with device_icc the print asset rides
     jpeg_decode_cmyk_rgb and the fast kernel; with fast_decode the
     README and synth requests fold, launching no kernel, with a serial
     Engine's bytes; (d) at each shape of (a), fast and split forms in
     turns: event, device (torch.profiler) and enqueue ms, the bound
     (bf16 products at 989 TFLOP/s, bytes at 3.35 TB/s) and share, the
     plain fast form's ms, and at README and blur B=16 a bf16
     torch.einsum (library ms); K11's bf16 form against its f32 one
     (event and device ms, dB; card against CPU within 1 LSB) at README
     B=16 and 12 MP B=2; the README stage times of the fast and the
     default route in turns; (e) GET /profile?seconds=2 during 16 README
     requests on the one-process server: the trace holds gemm_kernel and
     decode_rgb_kernel records (its host ops counted by thread), a
     second GET meanwhile answers 409, and so does one while another
     capture of the port (utils.profiling.exclusive) runs; at workers 4
     a worker answers /profile and no worker opens the card
     After phase 10, on a healthy card: every micro-batcher this process
     made and every CLI server (its /stats read before the SIGTERM: the
     device service's in worker mode) counted no host-mirror batch, stall,
     device error or wedge (host_fallbacks, device_stalls, device_errors,
     device_wedged, probe_threads all 0), and no HTTP response of phases
     4-10 carried
     X-Cache-Warmth: cold (an aiohttp trace on every client session)
 11. the host mirror and device failover (P7), faults injected in-process
     by wrapping BatchAssembly.submit: (a) the mirror (ops.hostexec)
     against the card's path on the same staged batches (README 4:4:4
     coefficients B=8 with the default, PNG, WebP and jpegdct sinks,
     synth 4:2:0 B=8, README pixels B=8, the alpha PNG on a fill canvas
     B=4, the 2048x2048 CMYK print asset with the device ICC LUT B=1):
     <= 1 LSB and <= 0.5 % of bytes differing (jpegdct coefficients <= 2
     steps), the decoded planes of the coefficient and CMYK batches
     equal to jpeg_decode_rgb's / jpeg_decode_cmyk_rgb's; (b) the server
     in-process with "tpu": {"device_stall_s": 1.5}: a real stall (a
     torch.cuda._sleep enqueued on the batch's stream until 5 s after
     its start, probes included) wedges the batcher, the README request
     and its PNG form are answered cold (Cache-Control: no-store) from
     the mirror, the PNG within 1 LSB of the card's pixels, the counters
     rise with one WARNING per mirror batch, the stall's end recovers it
     and resample and jpeg_decode_rgb launch again; (c) one RuntimeError
     from submit: the request fails (500, not cold, device_errors 1, no
     mirror, no wedge), then the kernels again; one KernelBuildError:
     the same; (d) tpu.workers
     2 with the stall in the device service (the CLI started through a
     wrapper that sleeps while a file names a time to come): cold bodies
     through both gateways, byte-equal to (b)'s, the service wedged and
     a worker's engine on the pixel source, then recovery, the card's
     bodies, and resample and jpeg_decode_rgb launched again (the
     workers back on the coefficient source); (e) the mirror's host ms per batch (README B=1/8/16
     coefficients and pixels, synth B=8, the print asset), the time from
     a stall's start to its first mirror-served response and from its
     end to the first device-served one. They print as the
     {"failover": ...} line before the kernels line.
Launch counts are set to 0 just before each main-path run (the pixel
Engine, the coefficient Engine, the server, each phase-5 burst, the two
jpegdct engines and the jpegdct server burst of phase 6, the CMYK engine
and the CMYK server burst of phase 7, the fast_decode engine and the
fast_decode server burst of phase 9, the fast engine and the three
one-process fast servers of phase 10, the post-recovery and post-error
requests of phase 11) and read just after it; phase 8's,
9's and 10's worker-mode counts live in the device service, and their
windows are the differences of a worker's /stats read just before and
just after each. The fast keys (resample_fast, resample_blur_fast) must
be launched by phase 10's runs and by no earlier one, the split keys by
none of phase 10's.
Every kernel of the serving path (resample, resample_blur,
jpeg_decode_rgb) must have been launched by the coefficient engine, the
server, phase 5 (b) and phase 8 (b), jpeg_decode_cmyk_rgb by both CMYK
runs and K12b by the CMYK engine (its EXIF-rotated request), and neither
by an earlier run; K12a by no run.

Before them a {"torch_programs": [...]} line gives K11's figures (torch
code, not a kernel): its folded batches on the main path, worst error,
event, device and CPU ms, kernels per call and bound at README B=16;
and its bf16 form's (phase 10 (d)).
The second-to-last line is {"kernels": [...]}: each kernel's main-path
launches (K12a: 0, with phase 7's as checked_launches), worst error,
event and plain ms, bound and library ms (the CMYK kernels at
README-like B=8; the fast forms of the resample kernel at README and
blur B=16, with their device ms and the split form's event ms beside);
the last line is {"ok": true,
"device": {...}}. The port
imports torch, and nothing of jax or of fanlin_tpu.
"""

from __future__ import annotations

import asyncio
import importlib.util
import io
import json
import logging
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
    from PIL import features

    lcms = features.version("littlecms2")
    print(f"littlecms2 {lcms}", flush=True)
    check(lcms is not None, "PIL has no littlecms2: the host ICC route "
                            "cannot run")
    from fanlin_tpu_torch.engine import native_codecs

    print(f"native codec core available: {native_codecs.available()}",
          flush=True)
    return smi


def phase1() -> float:
    from fanlin_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    t1 = time.perf_counter()
    host = _build.build_host()
    _build.load_host()
    print(f"phase1 built {os.path.relpath(lib, ROOT)} in {t1 - t0:.2f} s, "
          "the host reader and encoder "
          f"{os.path.relpath(host, ROOT)} in {time.perf_counter() - t1:.2f} s",
          flush=True)
    return t1 - t0


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
    products: 2 per multiply-add in pass 1, 3 in passes 2-4. The fast
    form's work (`tpu.fast`): `bf16_flop`, one bf16 product per
    multiply-add of passes 1-2, and `blur_tf32_flop`, the blur pair's
    split products. `dense` is the dense chain's FLOP."""
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
            "bf16_flop": 2 * sum(macs[:2]) * planes,
            "blur_tf32_flop": 2 * 3 * sum(macs[2:]) * planes,
            "dense": dense * planes,
            "nbytes": planes * (src + oh * ow) + 4 * weights}


def resample_bound(work: dict, fast: bool = False) -> tuple:
    """(bound ms, "bytes" or "operations") of one resample call: the
    bytes at the HBM rate, or its tensor-core products (split TF32; with
    `fast` the bf16 products at the bf16 rate and the blur pair's split
    TF32), whichever takes longer."""
    t_bytes = work["nbytes"] / HBM_BYTES_PER_S * 1e3
    if fast:
        t_ops = (work["bf16_flop"] / BF16_FLOP_PER_S
                 + work["blur_tf32_flop"] / TF32_FLOP_PER_S) * 1e3
    else:
        t_ops = work["tf32_flop"] / TF32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _checked_call(dev, name, sw, sh, qs, batch, rng, fast=False):
    """Build one uniform batch of random sources, run the kernel once
    (its bf16 form with `fast`) and hold it against its plain version;
    returns what timing needs."""
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

    got = rk.resample_uniform(*args, crop=crop, bands=bands, fast=fast)
    torch.cuda.synchronize()
    want = rk.resample_uniform_ref(*args, crop=crop, fast=fast)
    check(got.shape == want.shape == (asm.b, 3) + crop,
          f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    max_err = int(diff.max())
    frac = float((diff > 0).float().mean())
    print(f"{'phase10a fast' if fast else 'phase2'} {name} B={asm.b} "
          f"src={asm.sh}x{asm.sw} "
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
# The kernels the serving path launches for YCbCr and pixel sources
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
BF16_FLOP_PER_S = 989e12  # dense bf16 on the tensor cores
INT32_OPS_PER_S = 64 * 2 * 132 * 1.98e9
# Single-rounded f32 instructions (the LUT's __fmul_rn, __fadd_rn; an
# FMA that stands for one rounded multiply counts one): one per FP32
# lane per clock, 128 lanes on each of 132 SMs at 1.98 GHz, which is
# also the rate at which the four schedulers of an SM issue
# thread-instructions (INT32_OPS_PER_S is the same 33.45 T/s). The 67
# TFLOP/s f32 peak counts a multiply-add as two, twice this ceiling for
# unfused work.
F32_UNFUSED_OPS_PER_S = 128 * 132 * 1.98e9
# (vertical, horizontal) chroma divisors of each layout
DIVISORS = {420: (2, 2), 422: (1, 2), 440: (2, 1), 444: (1, 1)}


def _bound(nbytes: int, int32_ops: int, f32_ops: int = 0) -> dict:
    """The least time for `nbytes` moved and the operations issued, the
    larger of the two times, and which it is. int32 and unfused f32
    operations share the schedulers' dispatch, so their times add."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (int32_ops / INT32_OPS_PER_S
             + f32_ops / F32_UNFUSED_OPS_PER_S) * 1e3
    return {"bytes": nbytes, "int32_ops": int32_ops, "f32_ops": f32_ops,
            "bound_ms": max(t_bytes, t_ops),
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


def _route_jpeg(meta, data, rng) -> bytes:
    """A JPEG of a DECODE_SHAPES source's geometry: its own stream, else
    a seeded photo at its dims and layout (4:4:0: a 4:2:2 stream of the
    transposed dims whose SOF is rewritten to the 4:4:0 dims and factors,
    the same count of 2-luma-block MCUs)."""
    from PIL import Image

    if data is not None:
        return data
    w, h, subsamp = meta["w"], meta["h"], meta["subsamp"]
    if meta["gray"]:
        buf = io.BytesIO()
        Image.fromarray(_photo(w, h, rng)).convert("L").save(
            buf, format="JPEG", quality=85)
        return buf.getvalue()
    if subsamp != 440:
        return _jpeg(_photo(w, h, rng), quality=85,
                     subsampling={444: 0, 422: 1, 420: 2}[subsamp])
    out = bytearray(_jpeg(_photo(h, w, rng), quality=85, subsampling=1))
    sof = out.index(b"\xff\xc0")
    out[sof + 5:sof + 9] = h.to_bytes(2, "big") + w.to_bytes(2, "big")
    check(out[sof + 11] == 0x21, "a 4:2:2 stream expected")
    out[sof + 11] = 0x12
    return bytes(out)


def _slot_read(data, pinned=True):
    """The serving engine's slot route: a pinned slot of the stream's
    geometry, the reader writing straight into it."""
    from fanlin_tpu_torch.engine import jpeg_coeffs
    from fanlin_tpu_torch.ops import fused

    head = jpeg_coeffs.read_header(data)
    check(head is not None, "the reader refused a header")
    slot = fused.WireSlot.empty(head.h, head.w, head.subsamp, head.grids,
                                pinned)
    check(jpeg_coeffs.read_into_slot(data, head, slot),
          "the reader refused a stream it read as a dict")
    return slot


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


# uncounted calls that open each profiler trace (`_traced`)
OPENING_CALLS = 5


def _traced(fn, calls: int) -> tuple:
    """torch.profiler's records of `calls` calls of `fn`: (kernel
    records, the number of kernel launches) of those calls, each kernel
    matched to its launch by correlation id. The profiler loses the
    kernel records of the first launches of a trace (on the H100 they
    were missing there and nowhere else: up to 7 of them, more than a
    call of a 3-kernel function launches), so each trace opens with
    OPENING_CALLS calls, a synchronize and a 20 ms pause, none of them
    counted; a line says how many of their records were lost."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(OPENING_CALLS):
            fn()
        torch.cuda.synchronize()
        # the profiler's clock counts ns since the epoch; the mark sits
        # 10 ms from either side's launches
        time.sleep(0.01)
        mark = time.time_ns()
        time.sleep(0.01)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    launches = [e for e in events if e.device_type() != cuda
                and e.name().startswith(("cudaLaunchKernel",
                                         "cuLaunchKernel"))]
    seen = {e.correlation_id() for e in events if e.device_type() == cuda}
    opening = {e.correlation_id() for e in launches if e.start_ns() < mark}
    if opening - seen:
        print(f"the profiler lost {len(opening - seen)} of {len(opening)} "
              "kernel records of the trace's opening calls (not measured)",
              flush=True)
    launched = {e.correlation_id() for e in launches} - opening
    kernels = [e for e in events if e.device_type() == cuda
               and e.correlation_id() in launched]
    return kernels, len(launched)


def _device_ms(fn, launches: int, kernels) -> float:
    """Device ms per call of `fn`, which launches one kernel whose name
    contains one of `kernels`: the mean duration of those kernels as
    torch.profiler saw them over `launches` calls (`_traced`). Every
    launch must have its kernel record; a trace that misses one is taken
    again, up to three times."""
    for _ in range(3):
        recs, n = _traced(fn, launches)
        ns = [e.duration_ns() for e in recs
              if any(k in e.name() for k in kernels)]
        if n == len(ns) == launches:
            return sum(ns) / 1e6 / launches
        print(f"the profiler saw {len(ns)} kernels of {kernels} for {n} of "
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


def _poisoned_wire(wire, n: int) -> tuple:
    """(wire with its padding images, i >= n, set to noise, a copy with
    them zeroed): what a kernel that never reads the padding decodes
    alike."""
    gen = torch.Generator(device=wire[0].device).manual_seed(n)
    clean = tuple(t.clone() for t in wire)
    for t, c in zip(wire, clean):
        c[n:] = 0
        t[n:] = torch.randint(-2048, 2048, t[n:].shape, generator=gen,
                              device=t.device, dtype=t.dtype)
    return wire, clean


def phase2b_reuse(dev: torch.device) -> None:
    """A pinned slot dropped while its upload still waits behind a long
    kernel: torch's caching host allocator must not hand its block out
    again before the copy has run. The slot's batch is queued behind
    ~1 s of torch.cuda._sleep, the slot dropped, the same size
    allocated again and overwritten; the first batch must then decode as
    the plain version of a clean wire of the same image."""
    import gc

    from fanlin_tpu_torch.spec.query import parse_query
    from fanlin_tpu_torch.ops import fused, plan as plan_mod
    from fanlin_tpu_torch.ops import jpeg_decode_kernels as jk

    meta, _ = _decode_source("12mp", np.random.default_rng(20261018))
    plan = plan_mod.plan_image(meta["w"], meta["h"],
                               parse_query("w=640&h=480"), opaque=True)
    slot = fused.WireSlot(meta, pinned=True)
    ptr, size = slot.buf.data_ptr(), slot.nbytes
    asm = fused.CoefBatchAssembly([plan], [slot], dev)
    dec = (asm.subsamp, asm.true_h, asm.true_w, asm.sh, asm.sw, 1)
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 31)
    rgb = jk.jpeg_decode_rgb(*asm.device_wire(), *dec)
    del asm, slot
    gc.collect()
    again = [torch.empty(size, dtype=torch.uint8, pin_memory=True)
             for _ in range(4)]
    for buf in again:
        buf.fill_(0x5A)
    reused = any(b.data_ptr() == ptr for b in again)
    pending = not torch.cuda.current_stream(dev).query()
    torch.cuda.synchronize()
    want = fused.CoefBatchAssembly([plan], [meta], dev)
    diff = _bytes_differing(rgb, jk.jpeg_decode_rgb_ref(*want.device_wire(),
                                                        *dec))
    del again
    gc.collect()
    after = torch.empty(size, dtype=torch.uint8, pin_memory=True)
    print(f"phase2b reuse: {size} B slot dropped with its upload queued "
          f"(stream still busy: {pending}); its block handed out again "
          f"before the copy: {reused}; after it: "
          f"{after.data_ptr() == ptr}; decode bytes differing {diff[0]}",
          flush=True)
    check(pending, "the long kernel ended before the slot was dropped")
    check(not reused and diff[0] == 0,
          "a dropped pinned slot was reused before its upload had run")


def phase2b(dev: torch.device) -> dict:
    """The fused decode kernel jpeg_decode_rgb against its plain version
    on the same inputs; at the timed shapes, event ms, device ms, host
    enqueue, plain ms, bound and share."""
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
        dec = (asm.subsamp, asm.true_h, asm.true_w, asm.sh, asm.sw, images)
        rgb = jk.jpeg_decode_rgb(*wire, *dec)
        torch.cuda.synchronize()
        fused_diff = _bytes_differing(rgb, jk.jpeg_decode_rgb_ref(*wire, *dec))
        print(f"phase2b {name} {meta['w']}x{meta['h']} {asm.subsamp} "
              f"B={asm.b} n={images} jpeg_decode_rgb bytes differing "
              f"{fused_diff[0]} (max {fused_diff[1]}); wire "
              f"{asm.upload_bytes // asm.b} B/img, pixel upload "
              f"{3 * asm.sh * asm.sw} B/img", flush=True)
        check(fused_diff[0] == 0,
              f"{name}: jpeg_decode_rgb differs from its plain version")
        # the same images prestaged into pinned wire slots, as a codec
        # thread stages them: the kernel reads the real images' slots
        # alone, so their unzeroed device wire, its padding images
        # poisoned, decodes as the plain version of a zeroed one, and the
        # batch serves the dict-staged batch's images
        slots = [fused.WireSlot(meta, pinned=True) for _ in range(images)]
        sasm = fused.CoefBatchAssembly([plan] * images, slots, dev)
        swire, clean = _poisoned_wire(sasm.device_wire(), images)
        slot_diff = _bytes_differing(jk.jpeg_decode_rgb(*swire, *dec),
                                     jk.jpeg_decode_rgb_ref(*clean, *dec))
        served = all(np.array_equal(a, b)
                     for a, b in zip(sasm.run(), asm.run()))
        print(f"phase2b {name} slot wire: decode bytes differing "
              f"{slot_diff[0]} ({sasm.b - images} padding images poisoned), "
              f"served images equal {served}", flush=True)
        check(slot_diff[0] == 0 and served,
              f"{name}: a slot batch differs from the plain decode or from "
              "the dict-staged batch")
        # the same geometry read by the slot route and by the dict route
        jpeg = _route_jpeg(meta, data, rng)
        rmeta = read_jpeg_coeffs(jpeg)
        dasm = fused.CoefBatchAssembly([plan] * images, [rmeta] * images, dev)
        reused = None
        if kind == "12mp":
            # a dropped camera slot's block, poisoned, handed to the first
            # slot read: the reader alone must clear what it held
            old = _slot_read(jpeg)
            old.buf.fill_(0x7F)
            ptr = old.buf.data_ptr()
            del old
            first = _slot_read(jpeg)
            reused = first.buf.data_ptr() == ptr
            rslots = [first] + [_slot_read(jpeg) for _ in range(images - 1)]
        else:
            rslots = [_slot_read(jpeg) for _ in range(images)]
        rasm = fused.CoefBatchAssembly([plan] * images, rslots, dev)
        route_diff = _bytes_differing(
            jk.jpeg_decode_rgb(*rasm.device_wire(), *dec),
            jk.jpeg_decode_rgb(*dasm.device_wire(), *dec))
        print(f"phase2b {name} slot route: decode bytes differing "
              f"{route_diff[0]} from the dict route ({len(jpeg)} B JPEG"
              + ("" if reused is None else
                 f", a dropped camera slot's block reused: {reused}")
              + ")", flush=True)
        check(route_diff[0] == 0 and reused is not False,
              f"{name}: the slot route differs from the dict route, or the "
              "camera slot's block was not reused")
        res = {"err": fused_diff[1]}
        if timed:
            big = kind == "12mp"
            ev = _time_turns({
                "fused": lambda: jk.jpeg_decode_rgb(*wire, *dec),
            }, reps=5 if big else 10, launches=20 if big else 100)
            plain = _time_turns({
                "plain": lambda: jk.jpeg_decode_rgb_ref(*wire, *dec),
            }, reps=3, launches=1)
            dev_ms = _device_ms(lambda: jk.jpeg_decode_rgb(*wire, *dec), 20,
                                ("decode_rgb_kernel",))
            enq = _enqueue_ms(lambda: jk.jpeg_decode_rgb(*wire, *dec))
            bnd = decode_bound(meta["w"], meta["h"], asm.subsamp, images,
                               asm.b, asm.sh, asm.sw)
            res.update(ms=ev["fused"], plain_ms=plain["plain"],
                       device_ms=dev_ms, enqueue_ms=enq, bound=bnd)
            print(f"phase2b {name} jpeg_decode_rgb event_ms={ev['fused']:.4f}"
                  f" device_ms={dev_ms:.4f} enqueue_ms={enq:.4f} plain_ms="
                  f"{plain['plain']:.4f}", flush=True)
            print(f"phase2b {name} jpeg_decode_rgb needs {bnd['bytes']} B "
                  f"and {bnd['int32_ops']} int32 ops: bound "
                  f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']}, "
                  f"{bnd['bound_ms'] / dev_ms * 100:.1f} % of it on device "
                  f"time, {bnd['bound_ms'] / ev['fused'] * 100:.1f} % on "
                  "event time", flush=True)
        if name in ("lenna444_b1", "12mp420_b2"):
            reps = 20 if kind == "lenna" else 5
            routes = {
                "reader": lambda: read_jpeg_coeffs(data),
                "dict route": lambda: fused.WireSlot(read_jpeg_coeffs(data),
                                                     pinned=True),
                "slot route": lambda: _slot_read(data),
            }
            host = {r: [] for r in routes}
            order = list(routes) + list(routes)[::-1]
            for _ in range(reps + 1):
                for r in order:
                    t0 = time.perf_counter()
                    routes[r]()
                    host[r].append((time.perf_counter() - t0) * 1000.0)
            print(f"phase2b {name} host ms per image (median of "
                  f"{2 * reps}, in turns): " + ", ".join(
                      f"{r} {statistics.median(t[2:]):.4f}"
                      for r, t in host.items())
                  + f"; {len(data)} B of JPEG", flush=True)
        results[name] = res
    for s in (420, 422, 440, 444):
        share = halo_share(s, *jk.decode_tile(s))
        print(f"phase2b halo work of an interior tile, {s}: "
              f"{share * 100:.2f} % of its blocks'", flush=True)
    return results


def phase2c(dev: torch.device) -> dict:
    """A progressive 12 MP original against its baseline twin of the same
    pixels: the same coefficients by either route, the same decode on the
    card, and the reader's host ms on each coding, in turns."""
    from fanlin_tpu_torch.engine import jpeg_coeffs
    from fanlin_tpu_torch.ops import fused, plan as plan_mod
    from fanlin_tpu_torch.ops import jpeg_decode_kernels as jk
    from fanlin_tpu_torch.spec.query import parse_query

    img = _photo(4032, 3024, np.random.default_rng(20261019))
    streams = {"baseline": _jpeg(img, quality=90, subsampling=2),
               "progressive": _jpeg(img, quality=90, subsampling=2,
                                    progressive=True)}
    reads = {}
    for coding, data in streams.items():
        got = jpeg_coeffs.read_dict(data)
        check(got is not None, f"phase2c: the reader refused the {coding} "
              "stream")
        reads[coding] = got
        print(f"phase2c {coding} {got.head.w}x{got.head.h} "
              f"{got.head.subsamp}: progressive {got.head.progressive}, "
              f"{got.scans} scans, {len(data)} B of JPEG", flush=True)
    check(not reads["baseline"].head.progressive
          and reads["progressive"].head.progressive
          and reads["baseline"].scans == 1
          and reads["progressive"].scans == 10,
          "phase2c: the header's coding process or the scan count is wrong")
    slot = _slot_read(streams["progressive"])
    keys = ("y", "cb", "cr", "lq", "cq")
    base = reads["baseline"].meta
    differing = {}
    for route, meta in (("slot route", slot.meta),
                        ("dict route", reads["progressive"].meta)):
        differing[route] = sum(
            int(np.count_nonzero(np.asarray(meta[k]).view(np.uint8)
                                 != np.asarray(base[k]).view(np.uint8)))
            for k in keys)
    # on the card: the progressive slot and the baseline dict decode alike
    plan = plan_mod.plan_image(4032, 3024, parse_query("w=1200&h=900"),
                               opaque=True)
    sasm = fused.CoefBatchAssembly([plan], [slot], dev)
    basm = fused.CoefBatchAssembly([plan], [base], dev)
    dec = (sasm.subsamp, sasm.true_h, sasm.true_w, sasm.sh, sasm.sw, 1)
    decode_diff = _bytes_differing(
        jk.jpeg_decode_rgb(*sasm.device_wire(), *dec),
        jk.jpeg_decode_rgb(*basm.device_wire(), *dec))
    served = all(np.array_equal(a, b) for a, b in zip(sasm.run(), basm.run()))
    print(f"phase2c progressive against its baseline twin: plane and table "
          f"bytes differing {differing}; jpeg_decode_rgb bytes differing "
          f"{decode_diff[0]}; served image equal {served}", flush=True)
    check(all(v == 0 for v in differing.values()) and decode_diff[0] == 0
          and served, "phase2c: the progressive original differs from its "
          "baseline twin")
    reps = 5
    routes = {}
    for coding, data in streams.items():
        routes[f"{coding} reader"] = (
            lambda d=data: jpeg_coeffs.read_jpeg_coeffs(d))
        routes[f"{coding} slot route"] = lambda d=data: _slot_read(d)
    host = {r: [] for r in routes}
    order = list(routes) + list(routes)[::-1]
    for _ in range(reps + 1):
        for r in order:
            t0 = time.perf_counter()
            routes[r]()
            host[r].append((time.perf_counter() - t0) * 1000.0)
    ms = {r: statistics.median(t[2:]) for r, t in host.items()}
    print(f"phase2c host ms per 12 MP image (median of {2 * reps}, in "
          "turns): " + ", ".join(f"{r} {v:.4f}" for r, v in ms.items()),
          flush=True)
    return {"differing": differing, "decode_differing": decode_diff[0],
            "host_ms": ms}


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
    from fanlin_tpu_torch.ops import cmyk_lut_kernels as lk
    from fanlin_tpu_torch.ops import jpeg_decode_kernels as jk
    from fanlin_tpu_torch.ops import resample_kernels as rk

    return {**rk.launch_counts(), **jk.launch_counts(), **lk.launch_counts()}


def _reset_counts() -> None:
    from fanlin_tpu_torch.ops import cmyk_lut_kernels as lk
    from fanlin_tpu_torch.ops import jpeg_decode_kernels as jk
    from fanlin_tpu_torch.ops import resample_kernels as rk

    rk.reset_launch_counts()
    jk.reset_launch_counts()
    lk.reset_launch_counts()


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


# The jpegdct route's floor against the golden JPEGs. Those were encoded
# with libjpeg's integer DCT; a float DCT quantises some coefficients the
# other way, and the JAX package's own jpegdct route scores 44.09 dB at
# worst against them (lenna/crop100; tests/test_torch_dct.py
# test_jpegdct_golden_floor, on the CPU).
DCT_GOLDEN_FLOOR_DB = 44.0


def phase3_engine(dev: torch.device, device_decode: bool,
                  device_dct: bool = False):
    """The port's Engine on the golden corpus: the encoded floor (with
    device_dct, DCT_GOLDEN_FLOOR_DB, and every request on a jpegdct
    batch), and per request one resample launch, plus one
    jpeg_decode_rgb launch and a coef_src count on the coefficient path.
    Returns (engine, requests)."""
    from PIL import Image

    from fanlin_tpu_torch.spec.content import Format
    from fanlin_tpu_torch.engine import Engine

    engine = Engine(dev, device_decode=device_decode, device_dct=device_dct)
    path = ("coef" if device_decode else "pixel") + (
        " jpegdct" if device_dct else "")
    phase = "phase6c" if device_dct else "phase3"
    n = 0
    for src, data, cfg, q in _golden_sources():
        before = _counts()
        with _BatchLog() as log:
            mime, payload = engine.process_image(data, q, Format())
        added = {k: v - before[k] for k, v in _counts().items()}
        dct_sink = any(k.split("+")[-1].startswith("jpegdct:")
                       for k in log.kinds)
        # every golden case has an RGB or RGBA output (a grayscale one
        # is on a fill canvas), so every one takes jpegdct when asked
        check(dct_sink == device_dct,
              f"{path} {src}/{cfg}: batch kinds {log.kinds}")
        n += 1
        resample = added["resample"] + added["resample_blur"]
        check(resample == 1 and added["jpeg_decode_rgb"]
              == (1 if device_decode else 0),
              f"{path} {src}/{cfg}: launches {added}")
        check(mime == "image/jpeg", f"{src}/{cfg}: mime {mime}")
        with Image.open(io.BytesIO(payload)) as im:
            got = np.asarray(im.convert("RGB"), dtype=np.uint8)
        golden_enc = _golden_rgb(f"{src}_{cfg}.jpg")
        check(got.shape == golden_enc.shape, f"{src}/{cfg}: shape")
        d_enc = psnr(got, golden_enc)
        print(f"{phase} {path} {src}/{cfg} encoded {d_enc:.2f} dB, "
              f"launches {added}, kinds {log.kinds}", flush=True)
        floor = DCT_GOLDEN_FLOOR_DB if device_dct else 45.0
        check(d_enc >= floor, f"{src}/{cfg}: encoded {d_enc:.2f} dB < {floor}")
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
                engine = json.loads(stats)["engine"]
                check(engine["coef_src"] > 0,
                      "the server served no JPEG through the coefficient "
                      "path")
                check(engine["slot_reads"] == engine["coef_src"],
                      "a JPEG of the batching server took the dict route")
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
    """While active, records each batch assembled (by the batcher or an
    Engine's serial runner): (images, distinct plans, distinct kinds,
    uses_kernel()), and the kinds of every batch."""

    def __init__(self):
        from fanlin_tpu_torch.ops import fused

        self.rows = []
        self.kinds = []
        self.folded = 0  # batches on the folded route (K11)
        self._fused = fused
        self._real = fused.make_assembly

    def __enter__(self):
        def make(plans, payloads, kinds, device, **kw):
            asm = self._real(plans, payloads, kinds, device, **kw)
            self.rows.append((len(plans), len({id(p) for p in plans}),
                              len(set(kinds)), asm.uses_kernel()))
            self.kinds.extend(kinds)
            self.folded += bool(getattr(asm, "fold", False))
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
                      and w["jpeg_decode_rgb"] == batches,
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


# Phase 6 (a)'s K9 shapes: (name, w, h, batch) of the tail's input
# planes, the qualities each is checked at, and whether (e) times it
K9_SHAPES = [
    ("readme_b1", 300, 200, 1, (50, 75, 100), False),
    ("readme_b8", 300, 200, 8, (50, 75, 100), True),
    ("odd_301x199_b4", 301, 199, 4, (50, 75, 100), False),
    ("12mp_b2", 4000, 3000, 2, (75,), True),
]
# f32 outside the tensor cores, one H100 SXM (NVIDIA's data sheet)
F32_FLOP_PER_S = 67e12


def k9_bound(w: int, h: int, b: int) -> dict:
    """The least work of the K9 tail on b images of (h, w) Y and
    (ceil(h/2), ceil(w/2)) chroma u8 planes: the planes read once, the
    padded int16 coefficient planes written once; per coefficient two
    8-term f32 dot products (a multiply-add as two), the divide and the
    round half away from zero (4 more)."""
    ch, cw = -(-h // 2), -(-w // 2)
    coefs = (-(-h // 16) * 16 * (-(-w // 16) * 16)
             + 2 * (-(-ch // 8) * 8) * (-(-cw // 8) * 8))
    nbytes = b * (h * w + 2 * ch * cw + 2 * coefs)
    flop = b * coefs * (2 * 2 * 8 + 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / F32_FLOP_PER_S * 1e3
    return {"bytes": nbytes, "f32_flop": flop, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _device_ms_all(fn, calls: int) -> tuple:
    """(device ms per call, kernels per call) of `fn`: every kernel
    torch.profiler saw over `calls` calls (K9 and K11 are torch code:
    many small kernels), summed; every launch must have its kernel record
    (`_traced`), or the trace is taken again, up to three times."""
    for _ in range(3):
        recs, n = _traced(fn, calls)
        if n > 0 and len(recs) == n:
            return (sum(e.duration_ns() for e in recs) / 1e6 / calls,
                    n / calls)
        print(f"the profiler saw {len(recs)} kernels for {n} launches: "
              "tracing again", flush=True)
    check(False, "the profiler missed launches three times")


def phase6_tail(dev: torch.device) -> dict:
    """(a) K9 on the card against K9 on the CPU, (b) the encoder round
    trip on the card's coefficients, (e) the tail's device and event ms
    and bound, and the encoder's host ms per README image."""
    from PIL import Image

    from fanlin_tpu_torch.engine.jpeg_coeffs import read_jpeg_coeffs
    from fanlin_tpu_torch.engine.jpeg_encode import encode_jpeg_coeffs
    from fanlin_tpu_torch.ops import dct, fused

    rng = np.random.default_rng(20261016)
    timed = {}
    for name, w, h, b, qualities, time_it in K9_SHAPES:
        rgb = torch.from_numpy(np.stack([_photo(w, h, rng) for _ in range(b)]))
        planes = [p.contiguous()
                  for p in fused._ycbcr420_tail(rgb.permute(0, 3, 1, 2))]
        variants = [("photo", planes)]
        if name == "readme_b1":  # flat planes: every DC a tie at q50
            variants.append(("flat", [torch.full_like(p, v) for p, v in
                                      zip(planes, (137, 77, 200))]))
        for content, host in variants:
            on_card = [p.to(dev) for p in host]
            for q in qualities:
                cpu = dct.ycbcr420_to_planar(*host, *dct.ijg_quant_tables(q))
                card = dct.ycbcr420_to_planar(*on_card,
                                              *dct.device_quant_tables(q, dev))
                torch.cuda.synchronize()
                differ = sum(_bytes_differing(c.cpu(), p)[0]
                             for c, p in zip(card, cpu))
                total = sum(p.numel() for p in cpu)
                print(f"phase6a K9 {name} {content} {w}x{h} B={b} q{q}: "
                      f"{differ} of {total} coefficients differ, card against "
                      f"CPU", flush=True)
                check(differ == 0, f"phase6a {name} {content} q{q}: {differ} "
                      f"coefficients differ")
        card_planes = [p.to(dev) for p in planes]
        card = dct.ycbcr420_to_planar(*card_planes,
                                      *dct.device_quant_tables(q, dev))
        if name in ("readme_b1", "odd_301x199_b4"):
            # (b) the card's coefficients through the port's encoder
            for i in range(b):
                blocks = [dct.blocks_from_planar(c[i].cpu().numpy())
                          for c in card]
                out = encode_jpeg_coeffs(*blocks, w, h, q)
                check(out is not None, f"phase6b {name}: encoder refused")
                meta = read_jpeg_coeffs(out)
                bh, bw = -(-h // 8), -(-w // 8)
                check(meta is not None and (meta["w"], meta["h"]) == (w, h)
                      and np.array_equal(meta["y"], blocks[0][:bh, :bw])
                      and np.array_equal(meta["cb"], blocks[1])
                      and np.array_equal(meta["cr"], blocks[2]),
                      f"phase6b {name}: read-back differs")
                noisy = blocks[0].copy()
                noisy[bh:] = rng.integers(-999, 999, noisy[bh:].shape)
                noisy[:, bw:] = rng.integers(-999, 999, noisy[:, bw:].shape)
                check(encode_jpeg_coeffs(noisy, blocks[1], blocks[2], w, h,
                                         q) == out,
                      f"phase6b {name}: a padded block reached the stream")
                with Image.open(io.BytesIO(out)) as im:
                    im.load()
                    check(im.size == (w, h), f"phase6b {name}: PIL {im.size}")
            print(f"phase6b encoder round trip {name} q{q}: exact, padded "
                  f"blocks unread, PIL opens it ({len(out)} B)", flush=True)
        if not time_it:
            continue
        tables = dct.device_quant_tables(75, dev)

        def tail(card_planes=card_planes, tables=tables):
            return dct.ycbcr420_to_planar(*card_planes, *tables)

        dev_ms = _device_ms_all(tail, 10)[0]
        ev_ms = _time_turns({"k9": tail}, 10, 5)["k9"]
        t0 = time.perf_counter()
        dct.ycbcr420_to_planar(*planes, *dct.ijg_quant_tables(75))
        plain_ms = (time.perf_counter() - t0) * 1000.0
        bnd = k9_bound(w, h, b)
        timed[name] = {"device_ms": dev_ms, "ms": ev_ms, "plain_ms": plain_ms,
                       **bnd}
        print(f"phase6e K9 {name}: device_ms={dev_ms:.4f} (torch.profiler, "
              f"all kernels) event_ms={ev_ms:.4f} cpu_plain_ms={plain_ms:.4f} "
              f"needs {bnd['bytes']} B and {bnd['f32_flop'] / 1e9:.4f} f32 "
              f"GFLOP: bound_ms={bnd['bound_ms']:.4f} by {bnd['bound_by']} "
              f"({bnd['bound_ms'] / dev_ms * 100:.1f} % of device time)",
              flush=True)
    # the encoder's host ms on a README image's coefficients (lenna)
    from fanlin_tpu_torch.spec.query import parse_query
    from fanlin_tpu_torch.engine import codecs
    from fanlin_tpu_torch.ops import plan as plan_mod

    with open(os.path.join(GOLDEN, "lenna_src.jpg"), "rb") as f:
        img, _, _ = codecs.decode(f.read())
    plan = plan_mod.plan_image(512, 512, parse_query("w=300&h=200"),
                               opaque=True)
    res = fused.make_assembly([plan], [img], ["jpegdct:75"], dev).run()[0]
    ts = []
    for _ in range(50):
        t0 = time.perf_counter()
        encode_jpeg_coeffs(*res[1:])
        ts.append((time.perf_counter() - t0) * 1000.0)
    timed["encode_ms"] = statistics.median(ts)
    print(f"phase6e encoder host ms per README image (median of 50): "
          f"{timed['encode_ms']:.4f}", flush=True)
    return timed


def _png16_bytes(a16: np.ndarray, ctype: int) -> bytes:
    """A 16-bit PNG (filter 0 rows) of an (h, w, c) uint16 array."""
    import struct
    import zlib

    def chunk(typ, body):
        return (struct.pack(">I", len(body)) + typ + body
                + struct.pack(">I", zlib.crc32(typ + body) & 0xFFFFFFFF))

    h, w, _ = a16.shape
    rows = b"".join(b"\x00" + a16[y].astype(">u2").tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows, 6)) + chunk(b"IEND", b""))


def _tiff_bytes(a: np.ndarray) -> bytes:
    """A little-endian, uncompressed, one-strip TIFF of an (h, w, spp)
    uint16 or float32 array."""
    import struct

    h, w, spp = a.shape
    fl = a.dtype == np.float32
    data = a.astype("<f4" if fl else "<u2").tobytes()
    tags = [(256, 3, [w]), (257, 3, [h]), (258, 3, [32 if fl else 16] * spp),
            (259, 3, [1]), (262, 3, [2 if spp >= 3 else 1]), (273, 4, [0]),
            (277, 3, [spp]), (278, 3, [h]), (279, 4, [len(data)]),
            (284, 3, [1])] + ([(339, 3, [3] * spp)] if fl else [])
    over_at = 8 + 2 + 12 * len(tags) + 4
    over = bytearray()
    entries = []
    data_at = over_at + sum(2 * len(v) for _, t, v in tags
                            if t == 3 and len(v) > 2)
    for tag, typ, vals in tags:
        if tag == 273:
            vals = [data_at]
        fmt = "H" if typ == 3 else "I"
        packed = struct.pack("<" + fmt * len(vals), *vals)
        if len(packed) <= 4:
            entries.append(struct.pack("<HHI", tag, typ, len(vals))
                           + packed.ljust(4, b"\x00"))
        else:
            entries.append(struct.pack("<HHII", tag, typ, len(vals),
                                       over_at + len(over)))
            over += packed
    return (b"II*\x00" + struct.pack("<IH", 8, len(tags)) + b"".join(entries)
            + struct.pack("<I", 0) + bytes(over) + data)


def phase6_formats(dev: torch.device) -> None:
    """(f) One small source per format the port decodes outside PIL,
    made from a seed into build/chip_smoke/, through Engine(dev)."""
    from fanlin_tpu_torch.spec.content import Format
    from fanlin_tpu_torch.spec.query import parse_query
    from fanlin_tpu_torch.engine import Engine, codecs, exr_codec, extra_codecs

    rng = np.random.default_rng(20261019)
    img = _photo(48, 40, rng)
    rgba = np.dstack([img, rng.integers(0, 256, (40, 48), dtype=np.uint8)])
    a16 = rng.integers(0, 65536, (40, 48, 3), dtype=np.uint16)
    g16 = rng.integers(0, 65536, (40, 48, 1), dtype=np.uint16)
    f32 = rng.uniform(-0.2, 1.2, (40, 48, 3)).astype(np.float32)
    files = {
        "f1.qoi": extra_codecs.encode_qoi(rgba),
        "f1.ff": extra_codecs.encode_farbfeld(rgba),
        "f1.hdr": extra_codecs.encode_hdr(img),
        "f1.pam": extra_codecs.encode_pam(rgba),
        "f1_16.ppm": b"P6\n48 40\n65535\n" + a16.astype(">u2").tobytes(),
        "f1_16.png": _png16_bytes(a16, 2),
        "f1_16_gray.png": _png16_bytes(g16, 0),
        "f1_16.tif": _tiff_bytes(a16),
        "f1_float.tif": _tiff_bytes(f32),
        "f1_16_gray.tif": _tiff_bytes(g16),
        "f1.exr": exr_codec.encode_exr(img, compression=exr_codec._ZIP),
    }
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    engine = Engine(dev)
    q = parse_query("w=40&h=30")
    for name, data in files.items():
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
        with open(os.path.join(out_dir, name), "rb") as f:
            data = f.read()
        fmt = codecs.sniff_format(data)
        mime, body = engine.process_image(data, q, Format())
        arr = codecs.decode(body)[0]
        print(f"phase6f {name}: {fmt} -> {mime}, {len(body)} B, "
              f"{arr.shape[1]}x{arr.shape[0]}", flush=True)
        check(mime == codecs.MIME[fmt] and arr.shape[:2] == (30, 40),
              f"phase6f {name}: {mime} {arr.shape}")
    check(engine.stats == {"pixel_src": len(files), "coef_src": 0},
          f"phase6f engine stats {engine.stats}")


async def _phase6_server(dev: torch.device) -> dict:
    """(d) The server with tpu.device_dct: the README request over HTTP,
    then 16 README requests from 16 threads through its engine. Returns
    the burst's launch-count window."""
    import aiohttp
    from aiohttp import web

    from fanlin_tpu_torch.config import Config
    from fanlin_tpu_torch.engine import Engine
    from fanlin_tpu_torch.server.app import build_state, create_app

    cfg = Config.from_obj({
        "port": 0, "bind_addr": "127.0.0.1", "max_clients": 8,
        "client": {"s3": {"aws_region": "x"},
                   "web": {"user_agent": "chip-smoke", "timeout": 2}},
        "providers": [{"path": "baz", "src": "file://localhost" + GOLDEN}],
        "tpu": {"device_dct": True},
    })
    state = await build_state(cfg)
    check(state.engine.device_dct, "the server's engine ignores device_dct")
    batcher = state.engine.runner.batcher
    runner = web.AppRunner(create_app(cfg, state), access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    base = f"http://127.0.0.1:{runner.addresses[0][1]}"
    with open(os.path.join(GOLDEN, "lenna_src.jpg"), "rb") as f:
        lenna = f.read()
    want = _serial_body(Engine(dev, device_dct=True),
                        "/baz/lenna_src.jpg?w=300&h=200", GOLDEN)
    try:
        async with aiohttp.ClientSession() as s:
            async with s.get(base + "/baz/lenna_src.jpg?w=300&h=200") as r:
                body = await r.read()
                check(r.status == 200
                      and r.headers["Content-Type"] == "image/jpeg",
                      f"phase6d README status {r.status}")
                check(body == want, "phase6d: the HTTP body differs from "
                      "the serial Engine's")
        before = dict(batcher.stats)
        with _BatchLog() as log:
            _reset_counts()
            bodies, wall = await asyncio.to_thread(
                _thread_burst, state.engine, lenna, "w=300&h=200", 16)
            window = _counts()
        batches = batcher.stats["batches"] - before["batches"]
        print(f"phase6d jpegdct server: 16 README requests from 16 threads "
              f"in {batches} batches {[r[0] for r in log.rows]}, kinds "
              f"{sorted(set(log.kinds))}, launches {window}, wall "
              f"{wall * 1000:.3f} ms", flush=True)
        check(batches <= 4 and len(log.rows) == batches
              and all(r[1] == r[2] == 1 and r[3] for r in log.rows)
              and set(log.kinds) == {"coef444+jpegdct:75"},
              f"phase6d: {batches} batches, {log.rows}, {set(log.kinds)}")
        check(window["resample"] == window["jpeg_decode_rgb"] == batches,
              f"phase6d: launches {window} for {batches} batches")
        check(all(b == want for b in bodies),
              "phase6d: a batched body differs from the serial one")
    finally:
        await runner.cleanup()
    return window


# ---------------------------------------------------------------------------
# Phase 7: the CMYK / ICC path (P9): jpeg_decode_cmyk_rgb (K12a and K12b
# in one launch), K12b cmyk_lut, and K12a jpeg_decode_cmyk as yardstick

# The LUT's f32 work per pixel (csrc/cmyk_lut.cuh), the fewest operations
# that give the plain version's bits: per component the scale multiply,
# the floor and two subtracts; 28 weight products (shared prefixes);
# per corner 3 multiplies and 3 adds; per channel the rounding add and
# the floor
LUT_OPS = 4 * 4 + 28 + 16 * (3 + 3) + 3 * 2
# K12a's int32 work per output pixel besides its blocks': plain CMYK
# inverts 4 samples; YCCK adds jdcolor (and the upsample) and inverts K
CMYK_PIXEL_OPS = {(444, False): 4, (444, True): PIXEL_OPS[444] + 1,
                  (420, True): PIXEL_OPS[420] + 1}
# The JAX package's floor for its device ICC LUT against host lcms2
# (tests/test_cmyk_lut.py:57)
ICC_FLOOR_DB = 40.0
# One row of the packed LUT (cmyk_lut.pack_lut): four u8 RGB words
PACKED_ROW_BYTES = 16


def _cmyk_work(w: int, h: int, subsamp: int, ycck: bool, n: int) -> tuple:
    """(bytes, int32 operations) of K12a's decode of n real images: the
    wire of the true MCU grid of four planes (K at the luma grid) and the
    quant tables read once; the operations of those blocks and of the
    true rect's pixels."""
    dv, dh = DIVISORS[subsamp]
    ch, cw = -(-h // dv), -(-w // dh)
    blocks = 2 * -(-h // 8) * -(-w // 8) + 2 * -(-ch // 8) * -(-cw // 8)
    return (n * (blocks * 128 + 2 * 64 * 4),
            n * (blocks * BLOCK_OPS + h * w * CMYK_PIXEL_OPS[(subsamp, ycck)]))


def cmyk_decode_bound(w: int, h: int, subsamp: int, ycck: bool, n: int,
                      b: int, sh: int, sw: int) -> dict:
    """decode_bound for K12a: _cmyk_work and the (b, 4, sh, sw) output
    written once."""
    nbytes, ops = _cmyk_work(w, h, subsamp, ycck, n)
    return _bound(nbytes + b * 4 * sh * sw, ops)


def lut_bound(pixels: int, lut_entries: int) -> dict:
    """The least work of K12b on `pixels` pixels: 4 bytes read and 3
    written each, the packed LUT read once, LUT_OPS unfused f32
    operations each."""
    return _bound(7 * pixels + PACKED_ROW_BYTES * lut_entries, 0,
                        LUT_OPS * pixels)


def cmyk_rgb_bound(w: int, h: int, subsamp: int, ycck: bool, n: int, b: int,
                   sh: int, sw: int, lut_entries: int) -> dict:
    """The least work of jpeg_decode_cmyk_rgb (and of K12a then K12b,
    the same function): K12a's wire and operations, the packed LUT read
    once, 3 output bytes per pixel written once, and LUT_OPS for each
    pixel of the real images' true rects (the rest is one constant per
    image)."""
    nbytes, ops = _cmyk_work(w, h, subsamp, ycck, n)
    return _bound(nbytes + PACKED_ROW_BYTES * lut_entries
                        + b * 3 * sh * sw, ops, LUT_OPS * n * h * w)


def _cmyk_profile(seed: int, grid: int = 5) -> bytes:
    """A synthetic ICC v2 output profile (class prtr, CMYK -> Lab) with
    one lut16 (mft2) A2B0 tag: a grid^4 CLUT of a seeded under-colour
    formula, identity curves; plus wtpt and desc. lcms2 accepts it."""
    import struct

    rng = np.random.default_rng(seed)
    gain = rng.uniform(0.85, 1.0, 3)
    lv = np.linspace(0.0, 1.0, grid)
    c, m, y, k = np.meshgrid(lv, lv, lv, lv, indexing="ij")
    rgb = np.stack([(1 - c) * gain[0], (1 - m) * gain[1],
                    (1 - y) * gain[2]], -1) * (1 - k)[..., None]
    lum = 100.0 * (rgb @ np.array([0.3, 0.59, 0.11]))
    a = np.clip(90.0 * (rgb[..., 0] - rgb[..., 1]), -127, 127)
    b = np.clip(90.0 * (rgb[..., 1] - rgb[..., 2]), -127, 127)
    # ICC v2 16-bit Lab: L 0..100 -> 0..0xFF00, a and b + 128, times 256
    lab = np.stack([lum / 100.0 * 0xFF00, (a + 128.0) * 256.0,
                    (b + 128.0) * 256.0], -1)
    clut = np.clip(np.round(lab), 0, 0xFFFF).astype(">u2").tobytes()
    ident = struct.pack(">2H", 0, 0xFFFF)
    mft2 = (b"mft2" + bytes(4) + struct.pack(">4B", 4, 3, grid, 0)
            + struct.pack(">9i", 65536, 0, 0, 0, 65536, 0, 0, 0, 65536)
            + struct.pack(">2H", 2, 2) + ident * 4 + clut + ident * 3)
    text = b"synthetic CMYK %d\0" % seed
    desc = (b"desc" + bytes(4) + struct.pack(">I", len(text)) + text
            + struct.pack(">II", 0, 0) + struct.pack(">HB", 0, 0) + bytes(67))
    d50 = struct.pack(">3i", 63190, 65536, 54061)
    tags = [(b"desc", desc), (b"wtpt", b"XYZ " + bytes(4) + d50),
            (b"A2B0", mft2)]
    at = 128 + 4 + 12 * len(tags)
    table, body = b"", b""
    for sig, data in tags:
        data += bytes(-len(data) % 4)
        table += sig + struct.pack(">II", at + len(body), len(data))
        body += data
    header = (struct.pack(">I", at + len(body)) + b"lcms"
              + struct.pack(">I", 0x02100000) + b"prtrCMYKLab "
              + struct.pack(">6H", 2026, 1, 1, 0, 0, 0) + b"acsp"
              + bytes(24) + struct.pack(">I", 0) + d50 + bytes(48))
    return header + struct.pack(">I", len(tags)) + table + body


def _adobe_ycck(data: bytes) -> bytes:
    """The stream with its Adobe APP14 transform byte set to 2: libjpeg
    (and the port's reader) then read it as YCCK."""
    i = data.find(b"\xff\xee")
    check(i > 0 and data[i + 4:i + 9] == b"Adobe", "no Adobe APP14 marker")
    out = bytearray(data)
    out[i + 15] = 2
    return bytes(out)


def _cmyk_jpeg(rgb: np.ndarray, quality: int, icc: bytes = None,
               orientation: int = 1) -> bytes:
    """PIL's CMYK JPEG (4:4:4, Adobe transform 0) of an RGB image, with
    an EXIF orientation when it is not 1."""
    from PIL import Image

    buf = io.BytesIO()
    kw = {"icc_profile": icc} if icc else {}
    if orientation != 1:
        exif = Image.Exif()
        exif[0x0112] = orientation
        kw["exif"] = exif
    Image.fromarray(rgb).convert("CMYK").save(buf, format="JPEG",
                                              quality=quality, **kw)
    return buf.getvalue()


def _ycck420_meta(w: int, h: int, rng) -> dict:
    """A read_jpeg_coeffs4 dict of a YCCK 4:2:0 source from seeded
    grids (the card's machine has no libjpeg to write one)."""
    cshape = (-(-h // 16), -(-w // 16))
    lshape = (2 * cshape[0], 2 * cshape[1])
    grids = []
    for bh, bw in (lshape, cshape, cshape, lshape):
        g = np.zeros((bh, bw, 64), np.int16)
        g[..., 0] = rng.integers(-60, 60, (bh, bw))
        g[..., 1:12] = rng.integers(-20, 20, (bh, bw, 11))
        grids.append(g)
    q = rng.integers(1, 30, 128).astype(np.uint16)
    return {"y": grids[0], "cb": grids[1], "cr": grids[2], "k": grids[3],
            "lq": q[:64], "cq": q[64:], "w": w, "h": h, "subsamp": 420,
            "ycck": True, "cmyk": True}


def _gen_cmyk_sources() -> str:
    """Phase 7's files, made from a seed into build/chip_smoke/: the
    default and the embedded profile, 2048x2048 CMYK 4:4:4 q95 print
    assets (the golden lenna upscaled and converted): plain, its YCCK
    flip, one carrying the embedded profile and one EXIF-rotated
    (orientation 6); and the README source
    as CMYK 4:4:4 q92 (lenna_cmyk.jpg). Returns the directory."""
    from PIL import Image

    with Image.open(os.path.join(GOLDEN, "lenna_src.jpg")) as im:
        rgb = np.asarray(im.convert("RGB"))
        big = np.asarray(im.convert("RGB").resize((2048, 2048),
                                                  Image.LANCZOS))
    embedded = _cmyk_profile(1)
    files = {"default.icc": _cmyk_profile(0), "embedded.icc": embedded,
             "print_cmyk.jpg": _cmyk_jpeg(big, 95),
             "lenna_cmyk.jpg": _cmyk_jpeg(rgb, 92)}
    files["print_ycck.jpg"] = _adobe_ycck(files["print_cmyk.jpg"])
    files["print_embedded.jpg"] = _cmyk_jpeg(big, 95, icc=embedded)
    files["print_rotated.jpg"] = _cmyk_jpeg(big, 95, orientation=6)
    out = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out, exist_ok=True)
    for name, data in files.items():
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
    return out


# (name, source, images, timed): K12a's and K12b's shapes. Sources are
# PIL CMYK JPEGs (lenna 512x512 q92, a seeded photo at odd dims, 12 MP
# q95), their Adobe YCCK flips, or YCCK 4:2:0 grids from a seed. A batch
# of 5 images runs as B=8, the last three padding.
CMYK_SHAPES = [
    ("lenna_cmyk444_b1", "lenna_cmyk", 1, False),
    ("lenna_cmyk444_b8", "lenna_cmyk", 8, True),
    ("lenna_ycck444_b8", "lenna_ycck", 8, False),
    ("grid_ycck420_512_b8", "grid420_512", 8, False),
    ("odd_cmyk444_641x479_b1", "odd_cmyk", 1, False),
    ("odd_ycck420_641x479_5of8", "grid420_641", 5, False),
    ("tiny_ycck444_7x5_b1", "tiny_ycck", 1, False),
    ("tiny_ycck420_7x5_b1", "grid420_7", 1, False),
    ("12mp_cmyk444_b2", "12mp_cmyk", 2, True),
]


def _cmyk_source(kind: str, rng) -> dict:
    from fanlin_tpu_torch.engine.jpeg_coeffs import read_jpeg_coeffs4

    if kind.startswith("grid420_"):
        w = {"512": 512, "641": 641, "7": 7}[kind.split("_")[1]]
        h = {512: 512, 641: 479, 7: 5}[w]
        return _ycck420_meta(w, h, rng)
    if kind.startswith("lenna"):
        with open(os.path.join(GOLDEN, "lenna_src.jpg"), "rb") as f:
            from PIL import Image

            rgb = np.asarray(Image.open(io.BytesIO(f.read())).convert("RGB"))
        data = _cmyk_jpeg(rgb, 92)
    elif kind == "odd_cmyk":
        data = _cmyk_jpeg(_photo(641, 479, rng), 90)
    elif kind == "tiny_ycck":
        data = _cmyk_jpeg(_photo(7, 5, rng), 90)
    else:
        data = _cmyk_jpeg(_photo(4000, 3000, rng), 95)
    if kind.endswith("ycck"):
        data = _adobe_ycck(data)
    meta = read_jpeg_coeffs4(data)
    check(meta is not None and meta["ycck"] == kind.endswith("ycck"),
          f"{kind}: the reader refused the stream or read the wrong "
          "transform")
    return meta


def phase7_kernels(dev: torch.device, lut: np.ndarray) -> dict:
    """(a) The fused kernel jpeg_decode_cmyk_rgb against its plain version
    (K12b's plain version of K12a's) over the whole output, and on a slot
    wire with poisoned padding images, and K12a against its own; (b) K12b, planar on K12a's output and in pixel form
    on its first image, against its plain version: 0 bytes differing at
    every shape. (e) At the timed shapes, in turns: event ms of the fused
    kernel, the pair (K12a then K12b) and each alone; device ms and plain
    ms; bounds and shares."""
    from fanlin_tpu_torch.spec.query import parse_query
    from fanlin_tpu_torch.ops import cmyk_lut
    from fanlin_tpu_torch.ops import cmyk_lut_kernels as lk
    from fanlin_tpu_torch.ops import fused, plan as plan_mod
    from fanlin_tpu_torch.ops import jpeg_decode_kernels as jk

    rng = np.random.default_rng(20261019)
    flat = np.ascontiguousarray(lut.reshape(-1, 3).astype(np.float32))
    n = lut.shape[0]
    lut_dev = torch.from_numpy(flat).to(dev)
    packed = cmyk_lut.pack_lut(flat, n).to(dev)
    results = {}
    for name, kind, images, timed in CMYK_SHAPES:
        meta = _cmyk_source(kind, rng)
        meta.update(lut_flat=flat, lut_n=n, lut_key="")
        plan = plan_mod.plan_image(meta["w"], meta["h"],
                                   parse_query("w=300&h=200"), opaque=True)
        asm = fused.CmykCoefBatchAssembly([plan] * images, [meta] * images,
                                          dev)
        wire = asm.device_wire()
        args = (asm.subsamp, asm.ycck, asm.true_h, asm.true_w, asm.sh, asm.sw,
                images)
        rgb = jk.jpeg_decode_cmyk_rgb(*wire, packed, n, *args)
        torch.cuda.synchronize()
        f_diff = _bytes_differing(
            rgb, jk.jpeg_decode_cmyk_rgb_ref(*wire, lut_dev, n, *args))
        cmyk = jk.jpeg_decode_cmyk(*wire, *args)
        torch.cuda.synchronize()
        a_diff = _bytes_differing(cmyk, jk.jpeg_decode_cmyk_ref(*wire, *args))
        pair = lk.cmyk_lut(cmyk, packed, n)
        torch.cuda.synchronize()
        b_diff = _bytes_differing(pair, lk.cmyk_lut_ref(cmyk, lut_dev, n))
        px = cmyk[0].permute(1, 2, 0).contiguous()
        pix = lk.cmyk_lut_pixels(px, packed, n)
        torch.cuda.synchronize()
        p_diff = _bytes_differing(
            pix, lk.cmyk_lut_ref(cmyk[:1], lut_dev, n)[0].permute(1, 2, 0))
        vs_pair = _bytes_differing(rgb, pair)
        # the same images prestaged into pinned wire slots: the unzeroed
        # device wire, its padding images poisoned, decodes as the plain
        # version of a zeroed one
        sasm = fused.CmykCoefBatchAssembly(
            [plan] * images,
            [fused.WireSlot(meta, pinned=True) for _ in range(images)], dev)
        swire, clean = _poisoned_wire(sasm.device_wire(), images)
        s_diff = _bytes_differing(
            jk.jpeg_decode_cmyk_rgb(*swire, packed, n, *args),
            jk.jpeg_decode_cmyk_rgb_ref(*clean, lut_dev, n, *args))
        print(f"phase7a {name} slot wire: jpeg_decode_cmyk_rgb bytes "
              f"differing {s_diff[0]} ({sasm.b - images} padding images "
              "poisoned)", flush=True)
        check(s_diff[0] == 0, f"{name}: jpeg_decode_cmyk_rgb on a slot wire "
                              "differs from its plain version")
        print(f"phase7a {name} {meta['w']}x{meta['h']} {asm.subsamp}"
              f"{' ycck' if asm.ycck else ''} B={asm.b} n={images} "
              f"jpeg_decode_cmyk_rgb bytes differing {f_diff[0]} of "
              f"{rgb.numel()} (max {f_diff[1]}), from K12a+K12b "
              f"{vs_pair[0]}; jpeg_decode_cmyk {a_diff[0]} (max "
              f"{a_diff[1]}); phase7b cmyk_lut {b_diff[0]} (max {b_diff[1]}),"
              f" pixel form {p_diff[0]} (max {p_diff[1]}); wire "
              f"{asm.upload_bytes // asm.b} B/img", flush=True)
        check(f_diff[0] == 0 and vs_pair[0] == 0,
              f"{name}: jpeg_decode_cmyk_rgb differs from its plain version "
              "or from K12a + K12b")
        check(a_diff[0] == 0, f"{name}: jpeg_decode_cmyk differs from its "
                              "plain version")
        check(b_diff[0] == 0 and p_diff[0] == 0,
              f"{name}: cmyk_lut differs from its plain version")
        res = {"err": f_diff[1], "a_err": a_diff[1],
               "b_err": max(b_diff[1], p_diff[1])}
        if timed:
            big = kind == "12mp_cmyk"
            fns = {
                "fused": lambda: jk.jpeg_decode_cmyk_rgb(*wire, packed, n,
                                                         *args),
                "pair": lambda: lk.cmyk_lut(jk.jpeg_decode_cmyk(*wire, *args),
                                            packed, n),
                "k12a": lambda: jk.jpeg_decode_cmyk(*wire, *args),
                "k12b": lambda: lk.cmyk_lut(cmyk, packed, n),
            }
            ev = _time_turns(fns, reps=5 if big else 10,
                             launches=20 if big else 100)
            plain = _time_turns({
                "fused": lambda: jk.jpeg_decode_cmyk_rgb_ref(
                    *wire, lut_dev, n, *args),
                "k12a": lambda: jk.jpeg_decode_cmyk_ref(*wire, *args),
                "k12b": lambda: lk.cmyk_lut_ref(cmyk, lut_dev, n),
            }, reps=3, launches=1)
            plain["pair"] = plain["fused"]  # one plain version of both
            dev_ms = {
                "fused": _device_ms(fns["fused"], 20,
                                    ("decode_cmyk_rgb_kernel",)),
                "k12a": _device_ms(fns["k12a"], 20,
                                   ("decode_cmyk_kernel",)),
                "k12b": _device_ms(fns["k12b"], 20, ("cmyk_lut_kernel",)),
            }
            dev_ms["pair"] = dev_ms["k12a"] + dev_ms["k12b"]
            geo = (meta["w"], meta["h"], asm.subsamp, asm.ycck, images, asm.b,
                   asm.sh, asm.sw)
            fused_bound = cmyk_rgb_bound(*geo, n ** 4)
            bnd = {"fused": fused_bound, "pair": fused_bound,
                   "k12a": cmyk_decode_bound(*geo),
                   "k12b": lut_bound(asm.b * asm.sh * asm.sw, n ** 4)}
            for k in ("fused", "pair", "k12a", "k12b"):
                res[k] = {"ms": ev[k], "device_ms": dev_ms[k],
                          "plain_ms": plain[k], **bnd[k]}
                print(f"phase7e {name} {k}: event_ms={ev[k]:.4f} device_ms="
                      f"{dev_ms[k]:.4f} plain_ms={plain[k]:.4f}; bound "
                      f"{bnd[k]['bound_ms']:.4f} ms by {bnd[k]['bound_by']} "
                      f"({bnd[k]['bytes']} B, {bnd[k]['int32_ops']} int32 + "
                      f"{bnd[k]['f32_ops']} f32 ops), "
                      f"{bnd[k]['bound_ms'] / dev_ms[k] * 100:.1f} % of it on "
                      f"device time, {bnd[k]['bound_ms'] / ev[k] * 100:.1f} "
                      "% on event time", flush=True)
        results[name] = res
    return results


def _decoded(body: bytes) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(body)) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def phase7_engine(dev: torch.device, folder: str):
    """(c) The print assets through Engine(dev, cmyk2rgb, embedded
    profiles) with enable_device_icc(): every request on the coefficient
    path with one jpeg_decode_cmyk_rgb and one resample launch and the
    batch kind of its colour transform and profile, but the EXIF-rotated
    one, which takes the pixel route (one K12b on its pixels, one
    resample); none launches K12a. Each >= ICC_FLOOR_DB against the host
    lcms2 route (the same Engine without the device LUT). Returns
    (engine, host route engine, coefficient requests, pixel requests)."""
    from fanlin_tpu_torch.engine import Engine
    from fanlin_tpu_torch.engine.icc import CMYK2RGB
    from fanlin_tpu_torch.spec.content import Format
    from fanlin_tpu_torch.spec.query import parse_query

    conv = CMYK2RGB.from_file(os.path.join(folder, "default.icc"))
    check(conv is not None, "lcms2 refused the synthetic profile")
    engine = Engine(dev, cmyk2rgb=conv, use_embedded_profile=True)
    engine.enable_device_icc()
    host = Engine(dev, cmyk2rgb=conv, use_embedded_profile=True)
    q = parse_query("w=300&h=200")
    n = {"coef": 0, "pixels": 0}
    for name, kind in (("print_cmyk.jpg", "cmyk444"),
                       ("print_ycck.jpg", "cmyk444y"),
                       ("print_embedded.jpg", "cmyk444@"),
                       ("print_rotated.jpg", None)):
        with open(os.path.join(folder, name), "rb") as f:
            data = f.read()
        before = _counts()
        with _BatchLog() as log:
            mime, body = engine.process_image(data, q, Format())
        added = {k: v - before[k] for k, v in _counts().items()}
        pixels = kind is None
        n["pixels" if pixels else "coef"] += 1
        want = {k: 0 for k in added}
        want.update(resample=1, jpeg_decode_cmyk_rgb=0 if pixels else 1,
                    cmyk_lut=1 if pixels else 0)
        check(added == want, f"phase7c {name}: launches {added}")
        # the source kind, before the sink ("+jpeg420" with libjpeg)
        k0 = log.kinds[0].split("+")[0] if log.kinds else ""
        if pixels:  # the sink's kind: "rgb", or "jpeg420" with libjpeg
            ok = k0 in ("rgb", "jpeg420")
        else:
            ok = k0.startswith(kind) if kind.endswith("@") else k0 == kind
        check(len(log.kinds) == 1 and ok,
              f"phase7c {name}: batch kinds {log.kinds}")
        hmime, hbody = host.process_image(data, q, Format())
        got, ref = _decoded(body), _decoded(hbody)
        check(mime == hmime == "image/jpeg" and got.shape == ref.shape
              == (200, 300, 3), f"phase7c {name}: {mime} {got.shape}")
        db = psnr(got, ref)
        print(f"phase7c {name}: kind {k0}, launches {added}, {db:.2f} dB "
              "against host lcms2", flush=True)
        check(db >= ICC_FLOOR_DB, f"phase7c {name}: {db:.2f} dB < "
                                  f"{ICC_FLOOR_DB} against host lcms2")
    check(engine.stats == {"pixel_src": n["pixels"], "coef_src": n["coef"]},
          f"phase7c engine stats {engine.stats}")
    check(host.stats == {"pixel_src": sum(n.values()), "coef_src": 0},
          f"phase7c host route stats {host.stats}")
    return engine, host, n["coef"], n["pixels"]


def phase7_stage_times(engine, host, folder: str) -> None:
    """(c) The stage times of the print asset on the device ICC route
    and the host lcms2 route, in turns (outside the launch windows)."""
    from fanlin_tpu_torch.spec.content import Format
    from fanlin_tpu_torch.spec.query import parse_query

    q = parse_query("w=300&h=200")
    with open(os.path.join(folder, "print_cmyk.jpg"), "rb") as f:
        data = f.read()
    for label, e in (("device ICC", engine), ("host lcms2", host),
                     ("host lcms2", host), ("device ICC", engine)):
        for _ in range(2):
            e.process_image(data, q, Format())
        rows = []
        for _ in range(10):
            marks = []
            t0 = time.perf_counter()
            e.process_image(data, q, Format(), marks)
            rows.append(dict(marks, total=(time.perf_counter() - t0) * 1e3))
        med = {k: statistics.median(r[k] for r in rows)
               for k in ("f_decode", "f_device", "f_encode", "total")}
        print(f"phase7c 2048x2048 CMYK {label} route stage ms (median of "
              "10): " + ", ".join(f"{k} {v:.4f}" for k, v in med.items()),
              flush=True)


async def _phase7_server(dev: torch.device, folder: str) -> dict:
    """(d) The server with profile_path and tpu.device_icc: one print
    asset request over HTTP, then 16 README-size CMYK requests
    (lenna_cmyk.jpg) from 16 threads through its engine in <= 4 batches
    with the serial Engine's bodies. Returns the burst's launch-count
    window."""
    import aiohttp
    from aiohttp import web

    from fanlin_tpu_torch.config import Config
    from fanlin_tpu_torch.engine import Engine
    from fanlin_tpu_torch.engine.icc import CMYK2RGB
    from fanlin_tpu_torch.server.app import build_state, create_app

    cfg = Config.from_obj({
        "port": 0, "bind_addr": "127.0.0.1", "max_clients": 8,
        "client": {"s3": {"aws_region": "x"},
                   "web": {"user_agent": "chip-smoke", "timeout": 2}},
        "providers": [{"path": "gen", "src": "file://localhost" + folder}],
        "profile_path": os.path.join(folder, "default.icc"),
        "tpu": {"device_icc": True},
    })
    state = await build_state(cfg)
    check(state.engine.device_cmyk is not None,
          "the server's engine has no device LUT")
    batcher = state.engine.runner.batcher
    runner = web.AppRunner(create_app(cfg, state), access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    base = f"http://127.0.0.1:{runner.addresses[0][1]}"
    with open(os.path.join(folder, "lenna_cmyk.jpg"), "rb") as f:
        data = f.read()
    serial = Engine(dev, cmyk2rgb=CMYK2RGB.from_file(cfg.profile_path))
    serial.enable_device_icc()
    want_print = _serial_body(serial, "/gen/print_cmyk.jpg?w=300&h=200",
                              folder)
    want = _serial_body(serial, "/gen/lenna_cmyk.jpg?w=300&h=200", folder)
    try:
        async with aiohttp.ClientSession() as s:
            async with s.get(base + "/gen/print_cmyk.jpg?w=300&h=200") as r:
                body = await r.read()
                check(r.status == 200
                      and r.headers["Content-Type"] == "image/jpeg",
                      f"phase7d CMYK status {r.status}")
                check(body == want_print, "phase7d: the HTTP body differs "
                      "from the serial Engine's")
        # warm-up, as phase 5's: a first burst grows the pinned host
        # pool to the CMYK wire of a full batch
        await asyncio.to_thread(_thread_burst, state.engine, data,
                                "w=300&h=200", 16)
        before = dict(batcher.stats)
        with _BatchLog() as log:
            _reset_counts()
            bodies, wall = await asyncio.to_thread(
                _thread_burst, state.engine, data, "w=300&h=200", 16)
            window = _counts()
        batches = batcher.stats["batches"] - before["batches"]
        print(f"phase7d CMYK server: 16 README-size CMYK requests from 16 "
              f"threads in "
              f"{batches} batches {[r[0] for r in log.rows]}, kinds "
              f"{sorted(set(log.kinds))}, launches {window}, wall "
              f"{wall * 1000:.3f} ms", flush=True)
        check(batches <= 4 and len(log.rows) == batches
              and all(r[1] == r[2] == 1 and r[3] for r in log.rows)
              and {k.split("+")[0] for k in log.kinds} == {"cmyk444"},
              f"phase7d: {batches} batches, {log.rows}, {set(log.kinds)}")
        check(window["resample"] == window["jpeg_decode_cmyk_rgb"]
              == batches and window["jpeg_decode_cmyk"]
              == window["cmyk_lut"] == window["jpeg_decode_rgb"] == 0,
              f"phase7d: launches {window} for {batches} batches")
        check(all(b == want for b in bodies),
              "phase7d: a batched body differs from the serial one")
    finally:
        await runner.cleanup()
    return window


def _phase7_lut(folder: str) -> np.ndarray:
    from fanlin_tpu_torch.engine.icc import CMYK2RGB
    from fanlin_tpu_torch.ops import cmyk_lut

    conv = CMYK2RGB.from_file(os.path.join(folder, "default.icc"))
    check(conv is not None, "lcms2 refused the synthetic profile")
    return cmyk_lut.sample_lut(conv.convert, 17)


# ---------------------------------------------------------------------------
# Phase 8: worker mode (tpu.workers, P10): `python -m fanlin_tpu_torch.cli`
# in subprocesses, N gateway workers around one CUDA device service

# every wait of phase 8 is bounded by one of these (seconds)
BOOT_S = 180.0
REQUEST_S = 60.0
DRAIN_S = 15.0
WARMUP_S = 120.0
README = "/baz/lenna_src.jpg?w=300&h=200"
# (b)'s requests: the README request, its WebP and blur variants, 4:2:0,
# EXIF orientation 6, progressive, PNG and a CMYK print asset (host lcms2
# in worker mode)
WORKER_URLS = [
    (README, None),
    (README + "&webp=true&quality=20", {"Accept": "image/webp"}),
    (README + "&blur=10", None),
    ("/baz/synth_src.jpg?w=300&h=200", None),
    ("/gen/rot6.jpg?w=300&h=200", None),
    ("/gen/progressive.jpg?w=300&h=200", None),
    ("/baz/lenna_src.png?w=300&h=200", None),
    ("/gen/print_cmyk.jpg?w=300&h=200", None),
]
# (g)'s three variants of one source
VARIANTS = [README, "/baz/lenna_src.jpg?w=200&h=150",
            "/baz/lenna_src.jpg?w=120&h=90&blur=1"]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_config(folder: str, port: int, **tpu) -> dict:
    """Phase 8's deployment: the golden files and build/chip_smoke/
    (phases 5 and 7) over file origins, the synthetic default profile,
    max_clients 64 (no admission cap below the largest burst)."""
    return {
        "port": port, "bind_addr": "127.0.0.1", "max_clients": 64,
        "suppress_logging": True,
        "client": {"s3": {"aws_region": "x"},
                   "web": {"user_agent": "chip-smoke", "timeout": 2}},
        "providers": [{"path": "baz", "src": "file://localhost" + GOLDEN},
                      {"path": "gen", "src": "file://localhost" + folder}],
        "profile_path": os.path.join(folder, "default.icc"),
        "tpu": tpu,
    }


class _CliServer:
    """`python -m fanlin_tpu_torch.cli -j <config>` in a process group of
    its own (on CUDA: the CLI is given no device); a thread keeps reading
    its output."""

    # a server of phase 11's faults: its failover counters are not held
    # at 0 when it stops
    faults = False

    def __init__(self, folder: str, **tpu):
        self.workers = tpu.get("workers", 0)
        self.port = _free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        cfg = _cli_config(folder, self.port, **tpu)
        self.t_spawn = time.perf_counter()
        self.proc = subprocess.Popen(
            self.command(json.dumps(cfg)), cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, start_new_session=True)
        self.lines = []
        self._eof = False
        self._cond = threading.Condition()
        threading.Thread(target=self._read, daemon=True).start()

    def command(self, cfg_json: str) -> list:
        return [sys.executable, "-m", "fanlin_tpu_torch.cli", "-j", cfg_json]

    def _read(self) -> None:
        for raw in iter(self.proc.stdout.readline, b""):
            with self._cond:
                self.lines.append(raw.decode("utf-8", "replace").rstrip())
                self._cond.notify_all()
        with self._cond:
            self._eof = True
            self._cond.notify_all()

    def worker_pids(self) -> list:
        return [int(line.split()[2]) for line in list(self.lines)
                if line.startswith("fanlin-tpu-torch worker ")]

    def service_pid(self):
        for line in list(self.lines):
            if line.startswith("fanlin-tpu-torch device service "):
                return int(line.split()[3])
        return None

    def _up(self) -> bool:
        if self.workers > 1:
            return (len(self.worker_pids()) == self.workers
                    and self.service_pid() is not None)
        return any("listening on" in line for line in self.lines)

    def wait_banners(self) -> float:
        """Seconds from spawn to the last banner."""
        deadline = time.monotonic() + BOOT_S
        with self._cond:
            while not self._up():
                check(not self._eof, "phase8: the server died during "
                      "startup:\n" + "\n".join(self.lines[-30:]))
                left = deadline - time.monotonic()
                check(left > 0, "phase8: the server did not come up:\n"
                      + "\n".join(self.lines[-30:]))
                self._cond.wait(timeout=min(left, 1.0))
        return time.perf_counter() - self.t_spawn

    def terminate(self) -> float:
        """(h) SIGTERM: exit 0 within DRAIN_S, no worker left. Before it,
        the batcher's failover counters (the device service's in worker
        mode) must be 0 (not for a server of phase 11's faults)."""
        if not self.faults:
            import urllib.request

            with urllib.request.urlopen(self.base + "/stats",
                                        timeout=REQUEST_S) as r:
                stats = json.loads(r.read())
            _check_failover_zero(stats["batcher"], f"CLI server workers "
                                 f"{self.workers} {self.proc.args[-1][:80]}")
            _CLI_CHECKED.append(self.base)
        pids = self.worker_pids()
        t0 = time.perf_counter()
        self.proc.send_signal(15)
        code = self.proc.wait(timeout=DRAIN_S)
        took = time.perf_counter() - t0
        check(code == 0, f"phase8h: the server exited {code}")
        alive = [p for p in pids if _pid_alive(p)]
        check(not alive, f"phase8h: workers {alive} outlived the drain")
        return took

    def kill(self) -> None:
        try:
            os.killpg(self.proc.pid, 9)
        except ProcessLookupError:
            pass
        self.proc.wait(timeout=30)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _server_timing(header: str) -> dict:
    out = {}
    for part in header.split(","):
        name, _, dur = part.strip().partition(";dur=")
        if dur:
            out[name] = float(dur)
    return out


async def _get(session, base: str, url: str, headers=None) -> tuple:
    """(status, body, Server-Timing marks, seconds)."""
    import aiohttp

    t0 = time.perf_counter()
    async with session.get(base + url, headers=headers,
                           timeout=aiohttp.ClientTimeout(
                               total=REQUEST_S)) as r:
        body = await r.read()
        return (r.status, body, _server_timing(r.headers.get(
            "Server-Timing", "")), time.perf_counter() - t0)


async def _get_stats(session, base: str) -> dict:
    status, body, _, _ = await _get(session, base, "/stats")
    check(status == 200, f"phase8: /stats status {status}")
    return json.loads(body)


def _fresh_session():
    """A client whose every request opens a connection of its own, so
    SO_REUSEPORT spreads them over the workers."""
    import aiohttp

    return aiohttp.ClientSession(
        connector=aiohttp.TCPConnector(force_close=True, limit=0))


async def _cold_start(srv: _CliServer, label: str) -> dict:
    """(f) Spawn to the first 200 of the README request, polled on fresh
    connections, then nine more: the first's latency against the
    tenth's."""
    import aiohttp

    deadline = time.monotonic() + BOOT_S
    async with _fresh_session() as s:
        while True:
            check(srv.proc.poll() is None, f"phase8f {label}: server died:\n"
                  + "\n".join(srv.lines[-30:]))
            check(time.monotonic() < deadline,
                  f"phase8f {label}: no 200 within {BOOT_S} s")
            try:
                status, _, marks, first = await _get(s, srv.base, README)
            except aiohttp.ClientConnectionError:
                await asyncio.sleep(0.01)
                continue
            if status == 200:
                break
            await asyncio.sleep(0.01)
        to_first = time.perf_counter() - srv.t_spawn
        lat = [first]
        timings = [marks]
        for _ in range(9):
            status, _, marks, t = await _get(s, srv.base, README)
            check(status == 200, f"phase8f {label}: status {status}")
            lat.append(t)
            timings.append(marks)
    out = {"spawn_to_first_200_s": to_first, "first_ms": lat[0] * 1e3,
           "tenth_ms": lat[9] * 1e3, "first_server_timing": timings[0],
           "tenth_server_timing": timings[9]}
    print(f"phase8f cold start, workers {srv.workers}, {label}: spawn to "
          f"first 200 {to_first:.3f} s, first request {lat[0] * 1e3:.3f} ms "
          f"{timings[0]}, tenth {lat[9] * 1e3:.3f} ms {timings[9]}",
          flush=True)
    return out


async def _wait_warm(srv: _CliServer, want: int) -> None:
    """Wait (bounded) until the server's batcher ran `want` warm batches,
    and check it runs no more."""
    deadline = time.monotonic() + WARMUP_S
    async with _fresh_session() as s:
        while True:
            got = (await _get_stats(s, srv.base))["batcher"]["warm_batches"]
            if got >= want:
                break
            check(time.monotonic() < deadline,
                  f"phase8: {got} of {want} warm batches in {WARMUP_S} s")
            await asyncio.sleep(0.05)
        await asyncio.sleep(0.3)
        got = (await _get_stats(s, srv.base))["batcher"]["warm_batches"]
    check(got == want, f"phase8: {got} warm batches, expected {want}")


def _cpu_s(pids) -> dict:
    """pid -> CPU seconds (user + system) so far."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for pid in pids:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        out[pid] = (int(fields[11]) + int(fields[12])) / tick
    return out


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _card_clients(srv: _CliServer) -> None:
    """(d) The card has one client: the service holds the CUDA device
    files open and no worker does; nvidia-smi's compute apps list the
    service and no worker (where it reports this machine's pids)."""
    def device_files(pid):
        fds = os.path.join("/proc", str(pid), "fd")
        out = set()
        for fd in os.listdir(fds):
            try:
                target = os.readlink(os.path.join(fds, fd))
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                out.add(target)
        return sorted(out)

    svc, workers = srv.service_pid(), srv.worker_pids()
    check(svc == srv.proc.pid, f"phase8d: service pid {svc} is not the "
          f"CLI's {srv.proc.pid}")
    svc_files = device_files(svc)
    worker_files = {p: device_files(p) for p in workers}
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    listed = {int(x) for x in apps.split() if x.strip().isdigit()}
    print(f"phase8d service {svc} device files {svc_files}; workers "
          f"{worker_files}; nvidia-smi compute apps {sorted(listed)} "
          f"(this script {os.getpid()})", flush=True)
    check(svc_files, "phase8d: the service holds no CUDA device file")
    check(not any(worker_files.values()),
          f"phase8d: a worker opened the card: {worker_files}")
    check(not listed & set(workers),
          f"phase8d: worker pids among the compute apps: {listed}")
    if os.getpid() in listed:  # nvidia-smi reports this pid namespace
        check(svc in listed, f"phase8d: service {svc} not among {listed}")
    else:
        print("phase8d nvidia-smi lists no pid of this pid namespace: the "
              "device-file check stands alone", flush=True)


async def _phase8_reference(dev: torch.device, folder: str) -> dict:
    """(b)'s reference: the same requests through the single-process
    server in this process (build_state on the card, the same config
    without workers: CMYK on host lcms2 as in worker mode)."""
    from aiohttp import web

    from fanlin_tpu_torch.config import Config
    from fanlin_tpu_torch.server.app import build_state, create_app

    cfg = Config.from_obj(_cli_config(folder, 0))
    state = await build_state(cfg, device=dev)
    check(state.engine.device_cmyk is None, "phase8: device ICC is on")
    runner = web.AppRunner(create_app(cfg, state), access_log=None)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", 0).start()
    base = f"http://127.0.0.1:{runner.addresses[0][1]}"
    out = {}
    try:
        async with _fresh_session() as s:
            for url, headers in WORKER_URLS + [(u, None) for u in VARIANTS]:
                status, body, _, _ = await _get(s, base, url, headers)
                check(status == 200, f"phase8 reference {url}: {status}")
                out[url] = body
    finally:
        await runner.cleanup()
    return out


async def _bursts(servers: dict, n_reps: int = 5) -> None:
    """(e) 16 and 64 concurrent README requests, each on a connection of
    its own, against each server in turns (workers 1, 2, 4, then 4, 2,
    1, ...); median of n_reps. Prints img/s, batches/images from /stats,
    the median f_device of the responses, the CPU seconds of the
    service (or single process), of the workers and of this client over
    the bursts' walls (cores busy), and the service's mean socket
    receive, batcher and send ms per request."""
    rows = {(w, n): {"walls": [], "f_device": [], "batches": 0,
                     "images": 0, "cpu": {"service": 0.0, "workers": 0.0,
                                          "client": 0.0},
                     "sock": {"runs": 0, "recv_ms_total": 0.0,
                              "run_ms_total": 0.0, "send_ms_total": 0.0}}
            for w in servers for n in (16, 64)}
    async with _fresh_session() as s:
        for rep in range(n_reps):
            order = sorted(servers) if rep % 2 == 0 else sorted(servers)[::-1]
            for w in order:
                base = servers[w].base
                srv = servers[w]
                for n in (16, 64):
                    stats0 = await _get_stats(s, base)
                    before = stats0["batcher"]
                    cpu0 = _cpu_s([srv.proc.pid] + srv.worker_pids())
                    me0 = sum(os.times()[:2])
                    t0 = time.perf_counter()
                    got = await asyncio.gather(
                        *(_get(s, base, README) for _ in range(n)))
                    wall = time.perf_counter() - t0
                    me1 = sum(os.times()[:2])
                    cpu1 = _cpu_s([srv.proc.pid] + srv.worker_pids())
                    stats1 = await _get_stats(s, base)
                    after = stats1["batcher"]
                    check(all(g[0] == 200 for g in got),
                          f"phase8e workers {w}: statuses "
                          f"{sorted({g[0] for g in got})}")
                    row = rows[(w, n)]
                    row["walls"].append(wall)
                    row["f_device"] += [g[2]["f_device"] for g in got]
                    row["batches"] += after["batches"] - before["batches"]
                    row["images"] += after["images"] - before["images"]
                    used = _diff(cpu1, cpu0)
                    row["cpu"]["service"] += used.pop(srv.proc.pid)
                    row["cpu"]["workers"] += sum(used.values())
                    row["cpu"]["client"] += me1 - me0
                    if stats1.get("service"):
                        for k, v in _diff(stats1["service"],
                                          stats0["service"]).items():
                            row["sock"][k] += v
    for (w, n), row in sorted(rows.items()):
        med = statistics.median(row["walls"])
        walls = sum(row["walls"])
        cores = {k: round(v / walls, 3) for k, v in row["cpu"].items()}
        runs = max(row["sock"]["runs"], 1)
        sock = {k[:-9] + "_ms": round(v / runs, 3)
                for k, v in row["sock"].items() if k != "runs"}
        print(f"phase8e workers {w}, {n} concurrent README requests over "
              f"HTTP: {med * 1e3:.3f} ms (median of {n_reps}), "
              f"{n / med:.2f} img/s, {row['batches']} batches / "
              f"{row['images']} images, f_device median "
              f"{statistics.median(row['f_device']):.1f} ms; cores busy "
              f"{cores}; service per request {sock if row['sock']['runs'] else None}",
              flush=True)
        check(row["images"] == n * n_reps,
              f"phase8e workers {w}: {row['images']} images")


async def _phase8(dev: torch.device, folder: str, build_s: float) -> dict:
    """Phase 8; returns the launch-count windows of (b) and (c), read
    from a worker's /stats (the service's counters) just before and just
    after each."""
    from fanlin_tpu_torch.engine import warmup

    windows = {}
    servers = []
    kinds = len(warmup._kinds(device_decode=True, device_dct=False))
    want_warm = len(warmup.DEFAULT_SHAPES) * 2 * kinds  # B = 1 and 8
    try:
        reference = await _phase8_reference(dev, folder)
        # (a) boot tpu.workers 4; its spawn to first 200 is (f)'s
        # warmup-on sample
        main = _CliServer(folder, workers=4)
        servers.append(main)
        cold = {"on": await _cold_start(main, "warmup on")}
        boot = main.wait_banners()
        print(f"phase8a workers {main.worker_pids()} and device service "
              f"{main.service_pid()} up in {boot:.3f} s", flush=True)
        await _wait_warm(main, want_warm)
        async with _fresh_session() as s:
            # (b) bytes, each request on its own connection
            before = await _get_stats(s, main.base)
            for url, headers in WORKER_URLS:
                status, body, _, _ = await _get(s, main.base, url, headers)
                check(status == 200, f"phase8b {url}: status {status}")
                check(body == reference[url], f"phase8b {url}: the worker's "
                      "body differs from the single-process server's")
            after = await _get_stats(s, main.base)
            windows["worker requests"] = _diff(after["kernel_launches"],
                                               before["kernel_launches"])
            w = windows["worker requests"]
            print(f"phase8b {len(WORKER_URLS)} requests byte-equal to the "
                  f"single-process server; service launches {w}", flush=True)
            for name in MAIN_PATH_KERNELS:
                check(w[name] > 0, f"phase8c: {name} not launched in the "
                      "service, or not counted in a worker's /stats")
            # (c) a 16-request README burst rides uniform batches
            before = after
            got = await asyncio.gather(
                *(_get(s, main.base, README) for _ in range(16)))
            after = await _get_stats(s, main.base)
            check(all(g[0] == 200 and g[1] == reference[README]
                      for g in got), "phase8c: a burst body differs")
            w = windows["worker burst"] = _diff(after["kernel_launches"],
                                                before["kernel_launches"])
            b = _diff(after["batcher"], before["batcher"])
            print(f"phase8c 16 README requests over HTTP: {b['batches']} "
                  f"batches, {b['images']} images, launches {w}", flush=True)
            check(b["images"] == 16 and w["resample"] + w["resample_blur"]
                  == b["batches"] == w["jpeg_decode_rgb"],
                  f"phase8c: launches {w} for {b['batches']} batches: a "
                  "batch left the kernel (plans lost their identity?)")
        # (d) the card has one client
        _card_clients(main)
        # (f) the warmup-off sample
        off = _CliServer(folder, workers=4, warmup=False)
        servers.append(off)
        cold["off"] = await _cold_start(off, "warmup off")
        off.wait_banners()
        print(f"phase8f drain {off.terminate():.3f} s; nvcc build of "
              f"phase 1 {build_s:.2f} s", flush=True)
        # (e) workers 1 and 2 beside the 4 of (a), and (g)'s server
        one = _CliServer(folder, workers=1)
        two = _CliServer(folder, workers=2)
        cached = _CliServer(folder, workers=4, warmup=False,
                            source_cache_mb=64)
        servers += [one, two, cached]
        for srv in (one, two, cached):
            srv.wait_banners()
        for srv in (one, two):
            await _wait_warm(srv, want_warm)
        await _bursts({1: one, 2: two, 4: main})
        # (g) three variants of one source on one kept-alive connection
        # (one worker, one cache)
        import aiohttp

        async with aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(limit=1)) as s:
            marks = []
            for url in VARIANTS:
                status, body, t, _ = await _get(s, cached.base, url)
                check(status == 200 and body == reference[url],
                      f"phase8g {url}: {status}, or a body that differs "
                      "from the uncached server's")
                marks.append(t["f_decode"])
            st = (await _get_stats(s, cached.base))["caches"]["sources"]
        print(f"phase8g source cache {st}; f_decode {marks} ms (first, "
              "then the cached variants)", flush=True)
        # one entry, read once and hit twice (with a profile configured
        # each JPEG also misses once on the host-ICC pixels' key)
        check(st["hits"] == 2 and st["entries"] == 1,
              f"phase8g: source cache {st}")
        # (h) drain every server
        for srv in (one, two, cached, main):
            took = srv.terminate()
            print(f"phase8h workers {srv.workers}: SIGTERM to exit 0 in "
                  f"{took:.3f} s", flush=True)
    finally:
        for srv in servers:
            srv.kill()
    print("phase8 cold start " + json.dumps(cold), flush=True)
    return windows


# ---------------------------------------------------------------------------
# Phase 9: the folded fast path (P8, tpu.fast_decode; K11 as torch code)
# and tpu.data_parallel on one card (F2)

# (name, _decode_source kind, query, images, timed): K11's shapes. The
# README request at B = 1, 8, 16, synth 4:2:0 at 16, 4:2:2, 4:4:0 and
# gray sources, odd dims, a 12 MP camera source and blur.
FOLD_SHAPES = [
    ("lenna444_b1", "lenna", "w=300&h=200", 1, True),
    ("lenna444_b8", "lenna", "w=300&h=200", 8, True),
    ("lenna444_b16", "lenna", "w=300&h=200", 16, True),
    ("synth420_b16", "synth", "w=300&h=200", 16, True),
    ("pil422_b4", "pil422", "w=300&h=200", 4, False),
    ("grid440_b4", "grid440", "w=300&h=200", 4, False),
    ("gridgray_b4", "gridgray", "w=300&h=200", 4, False),
    ("odd420_641x479_b2", "odd420", "w=300&h=200", 2, False),
    ("odd422_641x479_n3_b4", "odd422", "w=97&h=89", 3, False),
    ("tiny420_7x5_b1", "tiny420", "w=3&h=2", 1, False),
    ("12mp420_b2", "12mp", "w=1200&h=800", 2, True),
    ("lenna444_blur_b8", "lenna", "w=100&h=80&blur=1", 8, False),
]
# (c)'s requests: the README request, its WebP and blur variants, and a
# 4:2:0 source
FOLD_URLS = [
    (README, None),
    (README + "&webp=true&quality=20", {"Accept": "image/webp"}),
    (README + "&blur=1", None),
    ("/baz/synth_src.jpg?w=300&h=200", None),
]
FOLD_GOLDEN_FLOOR_DB = 45.0  # tests/test_folded_decode.py's parity bar


def k11_bound(asm) -> dict:
    """The least work of one K11 call on `asm`'s batch: the int16 block
    wire and quant tables read once, the folded matrices read once, the
    (B, 3, OH, OW) f32 result written once; the FLOP of the matrix
    products (a multiply-add as two): per plane the AC pair over the
    grid's planar size and the DC pair over its block grid. The bound is
    the larger time, f32 at the card's rate outside the tensor cores."""
    from fanlin_tpu_torch.ops import plan as plan_mod

    mats = plan_mod._folded_padded(asm.plans[0], asm.subsamp)
    (oh, gh), (ow, sw) = mats[0].shape, mats[1].shape
    dv, dh = DIVISORS[asm.subsamp]
    flop = 0
    for h, w in ((gh, sw),) + ((gh // dv, sw // dh),) * 2:
        flop += 2 * oh * h * w + 2 * oh * w * ow
        flop += 2 * oh * (h // 8) * (w // 8) + 2 * oh * (w // 8) * ow
    flop *= asm.b
    nbytes = (asm.upload_bytes + 4 * asm.b * 3 * oh * ow
              + sum(m.nbytes for m in {id(m): m for m in mats}.values()))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / F32_FLOP_PER_S * 1e3
    return {"bytes": nbytes, "f32_flop": flop,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase9_kernels(dev: torch.device) -> dict:
    """(a) K11 on the card against the same torch code on the CPU, at
    full f32 (<= 1 LSB, <= 0.5 % of bytes differing) on FOLD_SHAPES, over
    K11's f32 output and over the folded route's u8 pixels (composite,
    blur, crop); (e) at the timed shapes, in turns, the folded route
    against the staged one (jpeg_decode_rgb then the resample kernel),
    both from the uploaded wire: event ms, device ms and kernels per
    call (torch.profiler), K11's bound and share, and K11's CPU ms."""
    from fanlin_tpu_torch.ops import fused, plan as plan_mod
    from fanlin_tpu_torch.ops import jpeg_decode_kernels as jk
    from fanlin_tpu_torch.ops import resample_kernels as rk
    from fanlin_tpu_torch.spec.query import parse_query

    cpu = torch.device("cpu")
    rng = np.random.default_rng(20261019)
    results = {}
    for name, kind, qs, images, timed in FOLD_SHAPES:
        meta, _ = _decode_source(kind, rng)
        plan = plan_mod.plan_image(meta["w"], meta["h"], parse_query(qs),
                                   opaque=True)
        asm = fused.CoefBatchAssembly([plan] * images, [meta] * images, dev,
                                      fold=True)
        ref = fused.CoefBatchAssembly([plan] * images, [meta] * images, cpu,
                                      fold=True)
        check(asm.fold and not asm.uses_kernel(),
              f"phase9a {name}: the batch does not fold")
        wire = asm.device_wire()
        ref_wire = ref.device_wire()
        fg = asm.folded(wire)
        torch.cuda.synchronize()
        want = ref.folded(ref_wire)
        d = (fg[:images].cpu() - want[:images]).abs()
        err, frac = int(d.max()), float((d > 0).float().mean())
        got_px, want_px = asm.run(), ref.run()
        dp = np.concatenate([np.abs(g.astype(np.int32) - w.astype(np.int32))
                             .ravel() for g, w in zip(got_px, want_px)])
        px_err, px_frac = int(dp.max()), float((dp > 0).mean())
        print(f"phase9a {name} {meta['w']}x{meta['h']} {asm.subsamp} "
              f"B={asm.b} n={images} grid {plan_mod.bucket_h16(asm.true_h)}"
              f"x{asm.sw} out "
              f"{tuple(fg.shape[2:])}: K11 card vs CPU max {err} "
              f"frac {frac:.2e}; route pixels max {px_err} frac "
              f"{px_frac:.2e}", flush=True)
        check(err <= MAX_LSB and frac <= MAX_FRAC and px_err <= MAX_LSB
              and px_frac <= MAX_FRAC,
              f"phase9a {name}: the card's K11 differs from the CPU's")
        res = {"err": max(err, px_err)}
        if timed:
            av, ah, bv, bh = (fused._device_cached(a, dev)
                              for a in plan_mod._uniform_padded(plan))
            bands = fused._device_cached(plan_mod._uniform_bands(plan), dev)
            flags, fill, box = (torch.from_numpy(a).to(dev)
                                for a in (asm.flags, asm.fill, asm.box))
            dec = (asm.subsamp, asm.true_h, asm.true_w, asm.sh, asm.sw,
                   images)

            def staged():
                x = jk.jpeg_decode_rgb(*wire, *dec)
                return rk.resample_uniform(flags, fill, box, av, ah, x, bv,
                                           bh, crop=(plan.out_h, plan.out_w),
                                           bands=bands)

            def folded():
                return asm.folded_pixels(wire, flags, fill, box)

            def k11():
                return asm.folded(wire)

            big = kind == "12mp"
            ev = _time_turns({"staged": staged, "folded": folded,
                              "k11": k11}, reps=5 if big else 10,
                             launches=10 if big else 50)
            dms = {n: _device_ms_all(f, 5 if big else 20)
                   for n, f in (("staged", staged), ("folded", folded),
                                ("k11", k11))}
            cpu_ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                ref.folded(ref_wire)
                cpu_ms.append((time.perf_counter() - t0) * 1e3)
            bnd = k11_bound(asm)
            res.update(ms=ev["k11"], device_ms=dms["k11"][0],
                       kernels_per_call=dms["k11"][1],
                       plain_ms=statistics.median(cpu_ms), bound=bnd)
            for n in ("staged", "folded", "k11"):
                print(f"phase9e {name} {n}: event_ms={ev[n]:.4f} "
                      f"device_ms={dms[n][0]:.4f} kernels per call "
                      f"{dms[n][1]:.1f}", flush=True)
            print(f"phase9e {name} K11 needs {bnd['bytes']} B and "
                  f"{bnd['f32_flop']} f32 FLOP: bound {bnd['bound_ms']:.4f} "
                  f"ms by {bnd['bound_by']}, {bnd['bound_ms'] / dms['k11'][0] * 100:.1f} "
                  f"% of it on device time, {bnd['bound_ms'] / ev['k11'] * 100:.1f} "
                  f"% on event time; CPU (plain) "
                  f"{res['plain_ms']:.4f} ms", flush=True)
        results[name] = res
    return results


class _Captured:
    """An Engine runner that keeps the device result of each call (the
    pixels, or the encode front-end's planes, before the host encode)."""

    def __init__(self, runner):
        self.runner = runner
        self.device = runner.device
        self.last = None

    def run(self, plans, images, kinds=None):
        out = self.runner.run(plans, images, kinds)
        self.last = out[0]
        return out


def _result_arrays(res) -> np.ndarray:
    """One device result (pixels, or a ("ycbcr420", y, cb, cr)-style
    tuple) as one flat int32 array."""
    parts = res[1:] if isinstance(res, tuple) else (res,)
    return np.concatenate([np.asarray(p, np.int32).ravel() for p in parts
                           if isinstance(p, np.ndarray)])


def phase9_engine(dev: torch.device):
    """(b) The golden corpus through Engine(dev, fast_decode=True) against
    Engine(dev), held to the JAX package's budget for the fold
    (tests/test_folded_decode.py): >= 45 dB and max |diff| <= 16 on the
    device result before the host encode; the encoded bodies' dB is
    printed beside it (two JPEG encodes at q75 turn the fold's few LSB
    into more: the JAX package's own folded and exact routes read 43.1-
    43.7 dB apart there on lenna crop100 and synth upscale700x600). A
    folded request counts coef_src and launches neither jpeg_decode_rgb
    nor the resample kernel; a grayscale or invert one (staged) launches
    one of each. Returns (engine, folded batches, launch window)."""
    from PIL import Image

    from fanlin_tpu_torch.engine import Engine
    from fanlin_tpu_torch.ops import fused
    from fanlin_tpu_torch.spec.content import Format

    fold = Engine(dev, fast_decode=True)
    fold.runner = _Captured(fold.runner)
    folded = 0
    runs = []
    _reset_counts()
    for src, data, cfg, q in _golden_sources():
        before = _counts()
        with _BatchLog() as log:
            _, body = fold.process_image(data, q, Format())
        added = {k: v - before[k] for k, v in _counts().items()}
        want_fold = not (q.grayscale() or q.inverse())
        check(log.folded == int(want_fold) and all(
            k.split("+")[0].endswith(fused.FOLD_SUFFIX) == want_fold
            for k in log.kinds), f"phase9b {src}/{cfg}: kinds {log.kinds}")
        resample = added["resample"] + added["resample_blur"]
        check(resample == added["jpeg_decode_rgb"] == (0 if want_fold else 1),
              f"phase9b {src}/{cfg}: launches {added}")
        folded += log.folded
        runs.append((src, data, cfg, q, body,
                     _result_arrays(fold.runner.last), added, log.kinds))
    window = _counts()
    check(fold.stats == {"pixel_src": 0, "coef_src": len(runs)},
          f"phase9b engine stats {fold.stats}")
    # the default route after the window, on the same requests
    staged = Engine(dev)
    staged.runner = _Captured(staged.runner)
    for src, data, cfg, q, body, got_px, added, kinds in runs:
        want = staged.process_image(data, q, Format())[1]
        ref_px = _result_arrays(staged.runner.last)
        d_px = psnr(got_px, ref_px)
        max_px = int(np.abs(got_px - ref_px).max())
        with Image.open(io.BytesIO(body)) as im:
            got = np.asarray(im.convert("RGB"), dtype=np.int32)
        with Image.open(io.BytesIO(want)) as im:
            ref = np.asarray(im.convert("RGB"), dtype=np.int32)
        print(f"phase9b {src}/{cfg} fast_decode vs default: device result "
              f"{d_px:.2f} dB, max |diff| {max_px}; encoded bodies "
              f"{psnr(got, ref):.2f} dB, max |diff| "
              f"{int(np.abs(got - ref).max())}; launches {added}, kinds "
              f"{kinds}", flush=True)
        check(d_px >= FOLD_GOLDEN_FLOOR_DB and max_px <= 16,
              f"phase9b {src}/{cfg}: {d_px:.2f} dB, max {max_px}")
    return fold, folded, window


async def _phase9_inproc(dev: torch.device, folder: str, burst: bool = False,
                         **tpu) -> dict:
    """FOLD_URLS through the single-process server (build_state on the
    card in this process) with phase 8's deployment and `tpu`; with
    `burst`, (c)'s 16 README requests from 16 threads through its engine
    too. Returns {"bodies": {url: body}} and, with burst, the burst's
    launch window and folded batches."""
    from aiohttp import web

    from fanlin_tpu_torch.config import Config
    from fanlin_tpu_torch.engine import Engine
    from fanlin_tpu_torch.server.app import build_state, create_app
    from fanlin_tpu_torch.spec.content import Format
    from fanlin_tpu_torch.spec.query import parse_query

    cfg = Config.from_obj(_cli_config(folder, 0, **tpu))
    state = await build_state(cfg, device=dev)
    check(state.engine.fast_decode == bool(tpu.get("fast_decode")),
          f"phase9: the engine's fast_decode with {tpu}")
    batcher = state.engine.runner.batcher
    runner = web.AppRunner(create_app(cfg, state), access_log=None)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", 0).start()
    base = f"http://127.0.0.1:{runner.addresses[0][1]}"
    serial = Engine(dev, fast_decode=bool(tpu.get("fast_decode")))
    out = {"bodies": {}}
    try:
        async with _fresh_session() as s:
            for url, headers in FOLD_URLS:
                status, body, _, _ = await _get(s, base, url, headers)
                check(status == 200, f"phase9 {tpu} {url}: status {status}")
                path, _, qs = url.partition("?")
                accepted = Format()
                if headers:
                    accepted.accept_webp()
                with open(os.path.join(GOLDEN, os.path.basename(path)),
                          "rb") as f:
                    want = serial.process_image(f.read(), parse_query(qs),
                                                accepted)[1]
                check(body == want, f"phase9 {tpu} {url}: the HTTP body "
                      "differs from the serial Engine's")
                out["bodies"][url] = body
        if burst:
            with open(os.path.join(GOLDEN, "lenna_src.jpg"), "rb") as f:
                lenna = f.read()
            before = dict(batcher.stats)
            with _BatchLog() as log:
                _reset_counts()
                bodies, wall = await asyncio.to_thread(
                    _thread_burst, state.engine, lenna, "w=300&h=200", 16)
                window = _counts()
            batches = batcher.stats["batches"] - before["batches"]
            print(f"phase9c fast_decode server: 16 README requests from 16 "
                  f"threads in {batches} batches {[r[0] for r in log.rows]}, "
                  f"kinds {sorted(set(log.kinds))}, {log.folded} folded, "
                  f"launches {window}, wall {wall * 1000:.3f} ms", flush=True)
            check(batches <= 4 and len(log.rows) == batches == log.folded
                  and all(r[1] == r[2] == 1 and not r[3] for r in log.rows),
                  f"phase9c: {batches} batches, {log.rows}, {log.folded} "
                  "folded")
            check(window["resample"] == window["resample_blur"]
                  == window["jpeg_decode_rgb"] == 0,
                  f"phase9c: a folded batch launched {window}")
            check(all(b == out["bodies"][README] for b in bodies),
                  "phase9c: a batched body differs from the serial one")
            out.update(window=window, folded=log.folded)
    finally:
        await runner.cleanup()
    return out


async def _phase9_workers(dev: torch.device, folder: str) -> dict:
    """(c) fast_decode and (d) data_parallel (one card) in one process and
    at workers 4. Returns the launch windows of the in-process burst and
    of the worker-mode requests (from a worker's /stats), and the folded
    batches of the burst."""
    from fanlin_tpu_torch.engine import warmup

    fold = await _phase9_inproc(dev, folder, burst=True, fast_decode=True)
    default = await _phase9_inproc(dev, folder)
    dp = await _phase9_inproc(dev, folder, data_parallel=True)
    check(dp["bodies"] == default["bodies"], "phase9d: data_parallel's "
          "bodies differ from the default config's")
    print("phase9d data_parallel in one process: the default config's "
          f"{len(dp['bodies'])} bodies", flush=True)
    windows = {"phase9c": fold["window"]}
    servers = []
    kinds = len(warmup._kinds(True, False, True))
    try:
        srv = _CliServer(folder, workers=4, fast_decode=True)
        servers.append(srv)
        srv.wait_banners()
        await _wait_warm(srv, len(warmup.DEFAULT_SHAPES) * 2 * kinds)
        dps = _CliServer(folder, workers=4, data_parallel=True, warmup=False)
        servers.append(dps)
        dps.wait_banners()
        async with _fresh_session() as s:
            for label, server, want in (
                    ("phase9c fast_decode", srv, fold["bodies"]),
                    ("phase9d data_parallel", dps, default["bodies"])):
                before = await _get_stats(s, server.base)
                for url, headers in FOLD_URLS:
                    status, body, _, _ = await _get(s, server.base, url,
                                                    headers)
                    check(status == 200 and body == want[url],
                          f"{label} workers 4 {url}: status {status}, or a "
                          "body that differs from the single process's")
                after = await _get_stats(s, server.base)
                w = _diff(after["kernel_launches"], before["kernel_launches"])
                print(f"{label} workers 4: {len(FOLD_URLS)} bodies "
                      f"byte-equal to the single process's; service "
                      f"launches {w}", flush=True)
                if server is srv:
                    check(w["resample"] == w["resample_blur"]
                          == w["jpeg_decode_rgb"] == 0,
                          f"phase9c workers 4: the service launched {w}")
                    windows["phase9c workers"] = w
                else:
                    check(w["jpeg_decode_rgb"] == len(FOLD_URLS),
                          f"phase9d workers 4: the service launched {w}")
                    windows["phase9d workers"] = w
        _card_clients(dps)
        for label, server in (("fast_decode", srv), ("data_parallel", dps)):
            print(f"phase9 workers 4 {label}: SIGTERM to exit 0 in "
                  f"{server.terminate():.3f} s", flush=True)
    finally:
        for server in servers:
            server.kill()
    return windows, fold["folded"]


# ---------------------------------------------------------------------------
# Phase 10: tpu.fast (the bf16 resample: the resample kernel's bf16 form,
# the torch chain's, K11's AC pairs) and tpu.profile_dir (GET /profile)

# (name, src_w, src_h, query, batch): phase 2's shapes the fast form is
# checked on; all are timed against the split form in turns
FAST_SHAPES = [s for s in SHAPES if s[0] in (
    "readme_b1", "readme_b8", "readme_b16", "grayscale_b16", "inverse_b16",
    "canvas_b16", "blur_b16", "12mp_b2", "12mp_blur_b2")]
FAST_DB = 48.0  # tests/test_fused.py::test_fast_mode_close_to_exact
FAST_KEYS = ("resample_fast", "resample_blur_fast")
SPLIT_KEYS = ("resample", "resample_blur")
# (c)'s requests: phase 8's (the README request, its WebP and blur
# variants, 4:2:0, EXIF 6, progressive, PNG, a CMYK print asset on host
# lcms2) and an alpha PNG (the torch chain)
FAST_URLS = WORKER_URLS + [("/gen/alpha.png?w=300&h=200&rgb=9,8,7", None)]


def _library_bf16_ms(rk, args, crop, bands) -> float:
    """One bf16 torch.einsum of the resample's products (and the blur's
    with blur), operands converted outside the timing, in turns with the
    fast kernel; a yardstick the port never calls."""
    flags, fill, box, av, ah, x, bv, bh = args
    bf = torch.bfloat16
    xb = x.to(bf)
    oh, ow = crop
    avb, ahb = av[:oh].to(bf), ah[:ow].to(bf)
    if bv is None:
        lib = lambda: torch.einsum("oh,bchw,vw->bcov", avb, xb, ahb)
    else:
        bvb, bhb = bv[:oh, :oh].to(bf), bh[:ow, :ow].to(bf)
        lib = lambda: torch.einsum("po,oh,bchw,vw,qv->bcpq", bvb, avb, xb,
                                   ahb, bhb)
    t = _time_turns({"library": lib, "kernel": lambda: rk.resample_uniform(
        *args, crop=crop, bands=bands, fast=True)}, reps=10, launches=1)
    blur = "with" if bv is not None else "without"
    print(f"phase10d library bf16 einsum {blur} blur: library_ms="
          f"{t['library']:.4f} kernel_ms={t['kernel']:.4f}", flush=True)
    return t["library"]


def phase10_kernels(dev: torch.device) -> dict:
    """(a) the fast form of the resample kernel against its plain version
    (resample_uniform_ref(fast=True)) on FAST_SHAPES, within 1 LSB and
    0.5 % (tests/test_torch_fast.py's tolerance); (d) at each, in turns
    with the split form: event ms, device ms and kernels per call
    (torch.profiler), host enqueue ms, the bound and share, the plain
    fast form's ms, and at README and blur B=16 a bf16 torch.einsum of
    the same products (library ms)."""
    from fanlin_tpu_torch.ops import resample_kernels as rk

    rng = np.random.default_rng(20261020)
    results = {}
    for name, sw, sh, qs, batch in FAST_SHAPES:
        c = _checked_call(dev, name, sw, sh, qs, batch, rng, fast=True)
        args, crop, bands = c["args"], c["crop"], c["bands"]
        fns = {"split": lambda: rk.resample_uniform(*args, crop=crop,
                                                    bands=bands),
               "fast": lambda: rk.resample_uniform(*args, crop=crop,
                                                   bands=bands, fast=True)}
        big = name.startswith("12mp")
        ev = _time_turns(fns, reps=5 if big else 10,
                         launches=10 if big else 50)
        dms = {k: _device_ms_all(f, 10 if big else 20)
               for k, f in fns.items()}
        enq = {k: _enqueue_ms(f) for k, f in fns.items()}
        plain = _time_turns({"plain": lambda: rk.resample_uniform_ref(
            *args, crop=crop, fast=True)}, reps=3, launches=1)["plain"]
        work = c["work"]
        bound = {k: resample_bound(work, fast=k == "fast") for k in fns}
        res = dict(c["result"], ms=ev["fast"], split_ms=ev["split"],
                   plain_ms=plain, device_ms=dms["fast"][0],
                   split_device_ms=dms["split"][0], enqueue_ms=enq["fast"],
                   bound_ms=bound["fast"][0], bound_by=bound["fast"][1])
        for k in fns:
            print(f"phase10d {name} {k}: event_ms={ev[k]:.4f} device_ms="
                  f"{dms[k][0]:.4f} kernels per call {dms[k][1]:.1f} "
                  f"enqueue_ms={enq[k]:.4f} bound_ms={bound[k][0]:.4f} "
                  f"({bound[k][1]}), {bound[k][0] / dms[k][0] * 100:.1f} % "
                  f"of it on device time, {bound[k][0] / ev[k] * 100:.1f} % "
                  "on event time", flush=True)
        print(f"phase10d {name}: fast/split event {ev['fast'] / ev['split']:.3f}"
              f", device {dms['fast'][0] / dms['split'][0]:.3f}; plain fast "
              f"form {plain:.4f} ms; {work['bf16_flop'] / 1e9:.3f} bf16 "
              f"GFLOP + {work['blur_tf32_flop'] / 1e9:.3f} split-TF32 GFLOP "
              f"(blur), {work['nbytes']} B", flush=True)
        if name in ("readme_b16", "blur_b16"):
            res["library_ms"] = _library_bf16_ms(rk, args, crop, bands)
        results[name] = res
    return results


def phase10_k11(dev: torch.device) -> dict:
    """(d) K11 with its AC pairs in bf16 (tpu.fast with fast_decode)
    against its f32 form from the same wire, in turns: event and device
    ms, and the two outputs' dB; the bf16 form on the card against the
    same code on the CPU (<= 1 LSB, <= 0.5 %)."""
    from fanlin_tpu_torch.ops import fused, plan as plan_mod
    from fanlin_tpu_torch.spec.query import parse_query

    cpu = torch.device("cpu")
    rng = np.random.default_rng(20261021)
    out = {}
    for name, kind, images in (("lenna444_b16", "lenna", 16),
                               ("12mp420_b2", "12mp", 2)):
        meta, _ = _decode_source(kind, rng)
        plan = plan_mod.plan_image(meta["w"], meta["h"],
                                   parse_query("w=1200&h=800" if kind == "12mp"
                                               else "w=300&h=200"),
                                   opaque=True)
        mk = lambda d, fast: fused.CoefBatchAssembly(
            [plan] * images, [meta] * images, d, fold=True, fast=fast)
        f32, bf = mk(dev, False), mk(dev, True)
        wire = f32.device_wire()
        got = bf.folded(wire)
        torch.cuda.synchronize()
        ref = mk(cpu, True)
        want = ref.folded(ref.device_wire())
        d = (got[:images].cpu() - want[:images]).abs()
        err, frac = int(d.max()), float((d > 0).float().mean())
        check(err <= MAX_LSB and frac <= MAX_FRAC,
              f"phase10d K11 {name}: bf16 form card vs CPU max {err} "
              f"frac {frac}")
        exact = f32.folded(wire)
        db = psnr(got[:images].cpu().numpy(), exact[:images].cpu().numpy())
        fns = {"f32": lambda: f32.folded(wire), "bf16": lambda: bf.folded(wire)}
        big = kind == "12mp"
        ev = _time_turns(fns, reps=5 if big else 10, launches=10)
        dms = {k: _device_ms_all(f, 5 if big else 20) for k, f in fns.items()}
        print(f"phase10d K11 {name}: bf16 card vs CPU max {err} frac "
              f"{frac:.2e}; bf16 vs f32 {db:.2f} dB; event_ms f32 "
              f"{ev['f32']:.4f} bf16 {ev['bf16']:.4f}; device_ms f32 "
              f"{dms['f32'][0]:.4f} bf16 {dms['bf16'][0]:.4f}; kernels per "
              f"call {dms['f32'][1]:.1f} / {dms['bf16'][1]:.1f}", flush=True)
        out[name] = {"err": err, "ms": ev["bf16"], "f32_ms": ev["f32"],
                     "device_ms": dms["bf16"][0], "db": db}
    return out


def phase10_engine(dev: torch.device):
    """(b) The golden corpus through Engine(dev, fast=True) against
    Engine(dev): >= 48 dB on the device result before the host encode
    (the encoded bodies' dB printed beside it); each request launches one
    jpeg_decode_rgb and one fast resample, no split one. Returns (engine,
    launch window)."""
    from PIL import Image

    from fanlin_tpu_torch.engine import Engine
    from fanlin_tpu_torch.spec.content import Format

    fast = Engine(dev, fast=True)
    fast.runner = _Captured(fast.runner)
    runs = []
    _reset_counts()
    for src, data, cfg, q in _golden_sources():
        before = _counts()
        _, body = fast.process_image(data, q, Format())
        added = {k: v - before[k] for k, v in _counts().items()}
        check(sum(added[k] for k in FAST_KEYS) == 1
              and sum(added[k] for k in SPLIT_KEYS) == 0
              and added["jpeg_decode_rgb"] == 1,
              f"phase10b {src}/{cfg}: launches {added}")
        runs.append((src, cfg, q, data, body,
                     _result_arrays(fast.runner.last), added))
    window = _counts()
    exact = Engine(dev)
    exact.runner = _Captured(exact.runner)
    for src, cfg, q, data, body, got_px, added in runs:
        want = exact.process_image(data, q, Format())[1]
        ref_px = _result_arrays(exact.runner.last)
        d_px = psnr(got_px, ref_px)
        with Image.open(io.BytesIO(body)) as im:
            got = np.asarray(im.convert("RGB"), dtype=np.int32)
        with Image.open(io.BytesIO(want)) as im:
            ref = np.asarray(im.convert("RGB"), dtype=np.int32)
        print(f"phase10b {src}/{cfg} fast vs exact: device result "
              f"{d_px:.2f} dB, max |diff| {int(np.abs(got_px - ref_px).max())}"
              f"; encoded bodies {psnr(got, ref):.2f} dB; launches {added}",
              flush=True)
        check(d_px >= FAST_DB, f"phase10b {src}/{cfg}: {d_px:.2f} dB")
    return fast, window


def _gen_alpha_png(folder: str) -> None:
    """(c)'s alpha source, from a seed: a 400x300 RGBA PNG."""
    from PIL import Image

    rng = np.random.default_rng(20261022)
    rgba = np.dstack([_photo(400, 300, rng),
                      np.linspace(0, 255, 400 * 300).reshape(300, 400)
                      .astype(np.uint8)])
    Image.fromarray(rgba, "RGBA").save(os.path.join(folder, "alpha.png"))


async def _phase10_inproc(dev: torch.device, folder: str, urls, trace_dir=None,
                          **tpu) -> dict:
    """`urls` through the single-process server (build_state on the card
    in this process) with phase 8's deployment and "fast": true plus
    `tpu`: every body 200, the launch window of the requests, the batches
    that took the kernel and those that folded; with `trace_dir`
    (tpu.profile_dir), (e): GET /profile?seconds=2 during 16 README
    requests, a second GET answering 409, and one answering 409 while
    another capture of the port runs. Returns {"bodies", "window",
    "kernel_batches", "folded", "kinds", "trace"}."""
    from aiohttp import web

    from fanlin_tpu_torch.config import Config
    from fanlin_tpu_torch.server.app import build_state, create_app

    raw = _cli_config(folder, 0, fast=True, **tpu)
    if trace_dir:
        raw["tpu"]["profile_dir"] = trace_dir
    cfg = Config.from_obj(raw)
    state = await build_state(cfg, device=dev)
    check(state.engine.fast and state.engine.runner.fast,
          "phase10: the server's engine is not fast")
    runner = web.AppRunner(create_app(cfg, state), access_log=None)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", 0).start()
    base = f"http://127.0.0.1:{runner.addresses[0][1]}"
    out = {"bodies": {}}
    try:
        async with _fresh_session() as s:
            with _BatchLog() as log:
                _reset_counts()
                for url, headers in urls:
                    status, body, _, _ = await _get(s, base, url, headers)
                    check(status == 200, f"phase10 {tpu} {url}: {status}")
                    out["bodies"][url] = body
                out["window"] = _counts()
            out.update(kernel_batches=sum(r[3] for r in log.rows),
                       folded=log.folded, kinds=log.kinds)
            if trace_dir:
                out["trace"] = await _phase10_profile(s, base, trace_dir)
    finally:
        await runner.cleanup()
    return out


async def _phase10_profile(s, base: str, trace_dir: str) -> dict:
    """(e) on a server with tpu.profile_dir: a 2 s capture during 16
    README requests, a second GET meanwhile (409), then a GET while a
    capture of the port held by another thread runs (409). The trace
    must hold gemm_kernel and decode_rgb_kernel records; counts its
    host ops by thread."""
    from fanlin_tpu_torch.utils import profiling

    cap = asyncio.ensure_future(_get(s, base, "/profile?seconds=2"))
    await asyncio.sleep(0.3)
    status2, text2, _, _ = await _get(s, base, "/profile?seconds=0.1")
    before = (await _get_stats(s, base))["batcher"]["batches"]
    _, wall = await _burst(s, base, [README] * 16)
    batches = (await _get_stats(s, base))["batcher"]["batches"] - before
    status, body, _, _ = await cap
    check(status == 200 and status2 == 409,
          f"phase10e: /profile {status}, the concurrent one {status2} "
          f"{text2!r}")
    res = json.loads(body)
    with open(res["trace_file"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = {e["name"] for e in kernels}
    gemm = sum("gemm_kernel" in e["name"] for e in kernels)
    dec = sum("decode_rgb_kernel" in e["name"] for e in kernels)
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    threads = {}
    for e in ops:
        threads[e.get("tid")] = threads.get(e.get("tid"), 0) + 1
    print(f"phase10e /profile 2 s during 16 README requests ({wall * 1000:.1f}"
          f" ms, {batches} batches): {os.path.getsize(res['trace_file'])} "
          "B trace, "
          f"{len(kernels)} kernel records ({gemm} gemm_kernel, {dec} "
          f"decode_rgb_kernel; {sorted(names)[:6]}), host ops by thread "
          f"{threads}; the concurrent GET: {status2} {text2!r}", flush=True)
    check(gemm >= 2 and dec >= 1, "phase10e: the trace lacks the port's "
          f"kernels: {sorted(names)}")
    opened, release = threading.Event(), threading.Event()

    def hold():
        with profiling.exclusive(cuda=True):
            opened.set()
            release.wait(REQUEST_S)

    holder = threading.Thread(target=hold)
    holder.start()
    try:
        check(opened.wait(REQUEST_S), "phase10e: no capture opened")
        status3, text3, _, _ = await _get(s, base, "/profile?seconds=0.1")
    finally:
        release.set()
        holder.join(REQUEST_S)
    print(f"phase10e /profile while another capture runs: {status3} "
          f"{text3!r}", flush=True)
    check(status3 == 409, f"phase10e: /profile during a capture {status3}")
    return {"burst_batches": batches, "kernel_records": len(kernels),
            "gemm": gemm, "decode": dec, "host_ops_by_thread": threads}


async def _phase10_servers(dev: torch.device, folder: str) -> dict:
    """(c) the fast server over FAST_URLS in one process and at workers
    4: every body 200 and byte-equal between the two; every batch that
    took the kernel launched a fast key and none a split one (at workers
    4 over the service's life, warmup included); with device_icc the
    print asset rides jpeg_decode_cmyk_rgb then the fast kernel; with
    fast_decode the README request folds (no kernel) with a serial
    Engine's bytes. (e) profile_dir in one process (the card's kernels
    in the trace, 409s) and at workers 4 (the route answers, no worker
    opens the card). Returns the launch windows and the folded
    batches."""
    from fanlin_tpu_torch.engine import Engine, warmup
    from fanlin_tpu_torch.engine.icc import CMYK2RGB
    from fanlin_tpu_torch.spec.content import Format
    from fanlin_tpu_torch.spec.query import parse_query

    _gen_alpha_png(folder)
    trace_dir = os.path.join(folder, "traces")
    one = await _phase10_inproc(dev, folder, FAST_URLS, trace_dir=trace_dir)
    w = one["window"]
    print(f"phase10c fast server, one process: {len(FAST_URLS)} requests, "
          f"{one['kernel_batches']} kernel batches, launches {w}, kinds "
          f"{one['kinds']}", flush=True)
    check(sum(w[k] for k in FAST_KEYS) == one["kernel_batches"] > 0
          and sum(w[k] for k in SPLIT_KEYS) == 0,
          f"phase10c: launches {w} for {one['kernel_batches']} kernel "
          "batches")
    windows = {"fast server": w}
    icc = await _phase10_inproc(
        dev, folder, [("/gen/print_cmyk.jpg?w=300&h=200", None)],
        device_icc=True)
    w = icc["window"]
    print(f"phase10c fast server with device_icc: the print asset, kinds "
          f"{icc['kinds']}, launches {w}", flush=True)
    check(w["jpeg_decode_cmyk_rgb"] == 1 and w["resample_fast"] == 1
          and sum(w[k] for k in SPLIT_KEYS) == 0
          and icc["kinds"][0].startswith("cmyk444"),
          f"phase10c device_icc: {icc['kinds']}, launches {w}")
    windows["fast icc server"] = w
    fold_urls = [(README, None), ("/baz/synth_src.jpg?w=300&h=200", None)]
    fold = await _phase10_inproc(dev, folder, fold_urls, fast_decode=True)
    w = fold["window"]
    serial = Engine(dev, fast=True, fast_decode=True,
                    cmyk2rgb=CMYK2RGB.with_icc_profile(
                        open(os.path.join(folder, "default.icc"),
                             "rb").read()))
    for url, _ in fold_urls:
        path, _, qs = url.partition("?")
        with open(os.path.join(GOLDEN, os.path.basename(path)), "rb") as f:
            want = serial.process_image(f.read(), parse_query(qs),
                                        Format())[1]
        check(fold["bodies"][url] == want,
              f"phase10c fast_decode {url}: the body differs from the "
              "serial Engine's")
    print(f"phase10c fast + fast_decode server: {fold['folded']} folded "
          f"batches, kinds {fold['kinds']}, launches {w}", flush=True)
    check(fold["folded"] == len(fold_urls) and not any(w.values()),
          f"phase10c fast_decode: {fold['folded']} folded, launches {w}")
    windows["fast fold server"] = w
    kinds = len(warmup._kinds(True, False, False))
    srv = _CliServer(folder, workers=4, fast=True, profile_dir=trace_dir)
    try:
        srv.wait_banners()
        await _wait_warm(srv, len(warmup.DEFAULT_SHAPES) * 2 * kinds)
        async with _fresh_session() as s:
            before = await _get_stats(s, srv.base)
            for url, headers in FAST_URLS:
                status, body, _, _ = await _get(s, srv.base, url, headers)
                check(status == 200 and body == one["bodies"][url],
                      f"phase10c workers 4 {url}: status {status}, or a "
                      "body that differs from the single process's")
            after = await _get_stats(s, srv.base)
            w = _diff(after["kernel_launches"], before["kernel_launches"])
            life = after["kernel_launches"]
            print(f"phase10c fast workers 4: {len(FAST_URLS)} bodies "
                  f"byte-equal to the single process's; service launches "
                  f"{w}; over its life (warmup included) {life}", flush=True)
            check(sum(life[k] for k in FAST_KEYS) > 0
                  and sum(life[k] for k in SPLIT_KEYS) == 0,
                  f"phase10c workers 4: the service launched {life}")
            windows["phase10c workers"] = w
            status, body, _, _ = await _get(s, srv.base,
                                            "/profile?seconds=0.5")
            check(status == 200, f"phase10e workers 4: /profile {status}")
            res = json.loads(body)
            check(os.path.isfile(res["trace_file"]),
                  f"phase10e workers 4: no trace file {res}")
            print(f"phase10e workers 4: /profile 200, a worker's trace "
                  f"{os.path.getsize(res['trace_file'])} B", flush=True)
        _card_clients(srv)
        print(f"phase10 workers 4 fast: SIGTERM to exit 0 in "
              f"{srv.terminate():.3f} s", flush=True)
    finally:
        srv.kill()
    return windows, fold["folded"], one["trace"]


# ---------------------------------------------------------------------------
# The failover counters on a healthy card, and phase 11: the host mirror
# and device failover (P7), with faults injected in-process

# the batcher's counters of mirror-served work and of a failing device:
# all 0 on a healthy card
FAILOVER_KEYS = ("host_fallbacks", "device_stalls", "device_errors",
                 "device_wedged", "probe_threads")
_BATCHERS = []  # every MicroBatcher made in this process
_COLD = []  # every HTTP response this process read marked cold
_CLI_CHECKED = []  # the CLI servers whose batcher counters were read


def _watch_failover() -> None:
    """Register every MicroBatcher this process makes, and every HTTP
    response it reads that carries X-Cache-Warmth: cold (an aiohttp trace
    on every client session)."""
    import aiohttp

    from fanlin_tpu_torch.engine import batcher as batcher_mod

    real_init = batcher_mod.MicroBatcher.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        _BATCHERS.append(self)

    batcher_mod.MicroBatcher.__init__ = init
    trace = aiohttp.TraceConfig()

    async def on_end(session, ctx, params):
        if params.response.headers.get("X-Cache-Warmth") == "cold":
            _COLD.append(str(params.url))

    trace.on_request_end.append(on_end)
    real_session = aiohttp.ClientSession.__init__

    def session(self, *a, **kw):
        kw["trace_configs"] = [*(kw.get("trace_configs") or ()), trace]
        real_session(self, *a, **kw)

    aiohttp.ClientSession.__init__ = session


def _check_failover_zero(stats: dict, where: str) -> None:
    bad = {k: stats.get(k) for k in FAILOVER_KEYS if stats.get(k)}
    check(not bad, f"{where}: failover counters on a healthy card: {bad}")


def check_healthy_phases() -> dict:
    """Every batcher of phases 4-10 and every CLI server (read before its
    SIGTERM) counted no host-served batch, no stall, no device error
    and no wedge; no response was marked cold."""
    for i, b in enumerate(_BATCHERS):
        _check_failover_zero(b.stats, f"in-process batcher {i}")
    check(not _COLD, f"responses marked cold on a healthy card: {_COLD[:5]}")
    out = {"batchers": len(_BATCHERS), "cli_servers": len(_CLI_CHECKED),
           "cold_responses": len(_COLD)}
    print("healthy phases: failover counters 0 " + json.dumps(out),
          flush=True)
    check(_BATCHERS and _CLI_CHECKED, "no batcher was checked")
    return out


def _sleep_rate() -> float:
    """torch.cuda._sleep cycles per second on this card (CUDA events)."""
    torch.cuda._sleep(int(1e6))  # load the kernel
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(int(2e8))
    end.record()
    end.synchronize()
    return 2e8 / (start.elapsed_time(end) / 1000.0)


class _Stall:
    """While active, every device submit of a batch first enqueues a
    sleep kernel on its stream lasting until `until` (time.monotonic()),
    so the batch's event completes only after it: a stalled device for
    everything submitted before `until`, probes included."""

    def __init__(self, rate: float):
        from fanlin_tpu_torch.ops import fused

        self.rate = rate
        self.until = 0.0
        self._fused = fused
        self._real = fused.BatchAssembly.submit

    def __enter__(self):
        real, stall = self._real, self

        def submit(asm):
            left = stall.until - time.monotonic()
            if left > 0 and asm.device.type == "cuda":
                torch.cuda._sleep(int(left * stall.rate))
            return real(asm)

        self._fused.BatchAssembly.submit = submit
        return self

    def __exit__(self, *exc):
        self._fused.BatchAssembly.submit = self._real


class _RaiseOnce:
    """The next device submit raises `exc` (then submits are real)."""

    def __init__(self, exc: Exception):
        from fanlin_tpu_torch.ops import fused

        self.exc = exc
        self.left = 1
        self._fused = fused
        self._real = fused.BatchAssembly.submit

    def __enter__(self):
        real, fault = self._real, self

        def submit(asm):
            if fault.left > 0:
                fault.left -= 1
                raise fault.exc
            return real(asm)

        self._fused.BatchAssembly.submit = submit
        return self

    def __exit__(self, *exc):
        self._fused.BatchAssembly.submit = self._real


class _MirrorLog(logging.Handler):
    """The fanlin.batcher records of the WARNING level and above."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []
        self._logger = logging.getLogger("fanlin.batcher")

    def emit(self, record):
        self.records.append(record)

    def __enter__(self):
        self._logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self)

    async def __aenter__(self):
        return self.__enter__()

    async def __aexit__(self, *exc):
        self.__exit__(*exc)

    def mirror_warnings(self) -> int:
        return sum(r.levelno == logging.WARNING
                   and "host mirror serving" in r.getMessage()
                   for r in self.records)


def _diff_stats(a: np.ndarray, b: np.ndarray) -> tuple:
    """(max |a - b|, share of differing bytes) of two u8/int arrays."""
    check(a.shape == b.shape, f"shapes {a.shape} and {b.shape}")
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(d.max(initial=0)), float((d > 0).mean())


def _mirror_arrays(res) -> list:
    """The arrays of one collect() result; PNG filter rows as the pixels
    they encode (a pixel 1 LSB apart changes its filtered byte by 255 mod
    256, and may change its row's filter)."""
    if not isinstance(res, tuple):
        return [res]
    if res[0] == "pngrows":
        from fanlin_tpu_torch.engine.png_writer import write_png

        return [_decoded(write_png(res[1], res[2], res[3], res[4], 75))]
    return [x for x in res[1:] if isinstance(x, np.ndarray)]


def _result_diffs(card: list, mirror: list) -> tuple:
    """Worst max |diff| and share over every array of two collect()
    results."""
    worst, share = 0, 0.0
    for c, m in zip(card, mirror):
        for a, b in zip(_mirror_arrays(c), _mirror_arrays(m)):
            mx, sh = _diff_stats(a, b)
            worst, share = max(worst, mx), max(share, sh)
    return worst, share


def _phase11_sources(folder: str) -> dict:
    """name -> (plan, payload, kind) of phase 11 (a)'s batches: the
    README request (lenna, 4:4:4 coefficients) with the default, PNG,
    WebP and jpegdct sinks, synth 4:2:0, the README source as pixels,
    the alpha PNG of phase 10 on a fill canvas, and the 2048x2048 CMYK
    print asset with the device ICC LUT."""
    from fanlin_tpu_torch.engine import codecs
    from fanlin_tpu_torch.engine.jpeg_coeffs import (read_jpeg_coeffs,
                                                     read_jpeg_coeffs4)
    from fanlin_tpu_torch.ops import plan as plan_mod
    from fanlin_tpu_torch.spec.query import parse_query

    q = parse_query("w=300&h=200")

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    lenna = read(os.path.join(GOLDEN, "lenna_src.jpg"))
    meta = read_jpeg_coeffs(lenna)
    plan = plan_mod.plan_image(meta["w"], meta["h"], q, opaque=True)
    base = COEF_KIND[meta["subsamp"]]
    out = {name: (plan, meta, base + sink)
           for name, sink in (("readme444", ""), ("readme444_png", "+png:3"),
                              ("readme444_webp", "+webp420"),
                              ("readme444_jpegdct", "+jpegdct:75"))}
    smeta = read_jpeg_coeffs(read(os.path.join(GOLDEN, "synth_src.jpg")))
    out["synth420"] = (plan_mod.plan_image(smeta["w"], smeta["h"], q,
                                           opaque=True),
                       smeta, COEF_KIND[smeta["subsamp"]])
    img, _, _ = codecs.decode(lenna)
    out["readme_pixels"] = (plan, img, "rgb")
    img, has_alpha, _ = codecs.decode(read(os.path.join(folder, "alpha.png")))
    check(has_alpha, "phase11a: the alpha PNG decoded opaque")
    out["alpha_canvas"] = (plan_mod.plan_image(
        img.shape[1], img.shape[0], parse_query("w=300&h=200&rgb=9,8,7")),
        img, "rgb")
    cmeta = read_jpeg_coeffs4(read(os.path.join(folder, "print_cmyk.jpg")))
    lut = _phase7_lut(folder)
    cmeta["lut_flat"] = np.ascontiguousarray(
        lut.reshape(-1, 3).astype(np.float32))
    cmeta["lut_n"], cmeta["lut_key"] = lut.shape[0], ""
    out["print_cmyk444"] = (plan_mod.plan_image(cmeta["w"], cmeta["h"], q,
                                                opaque=True),
                            cmeta, "cmyk444")
    return out


# (name, images) of phase 11 (a)
MIRROR_CHECKS = [("readme444", 8), ("readme444_png", 8),
                 ("readme444_webp", 8), ("readme444_jpegdct", 8),
                 ("synth420", 8), ("readme_pixels", 8), ("alpha_canvas", 4),
                 ("print_cmyk444", 1)]
# (name, images) timed in phase 11 (e), beside (a)'s batches (the print
# asset's one mirror run of (a), seconds of host work, is its time)
MIRROR_TIMED = [("readme444", 1), ("readme444", 8), ("readme444", 16),
                ("readme_pixels", 1), ("readme_pixels", 8),
                ("readme_pixels", 16), ("synth420", 8)]


def phase11_mirror(dev: torch.device, folder: str) -> dict:
    """(a) The mirror (ops.hostexec) against the card's path on the same
    staged assemblies: max |diff| and share of differing bytes (<= 1 LSB
    and <= 0.5 % for pixels and encode planes; jpegdct coefficients <= 2
    steps and <= 0.5 %: a plane 1 LSB apart moves a coefficient by about
    one step at most, and the mirror's DCT rounds quantisation ties in
    numpy's order); the decoded planes of the coefficient and CMYK
    batches equal to jpeg_decode_rgb's / jpeg_decode_cmyk_rgb's on the
    card. (e) The mirror's host ms per batch (median of 3 after one
    run) and per output megapixel."""
    from fanlin_tpu_torch.ops import fused, hostexec

    sources = _phase11_sources(folder)

    def assembly(name, b):
        plan, payload, kind = sources[name]
        return fused.make_assembly([plan] * b, [payload] * b, [kind] * b, dev)

    rows = {}
    for name, b in MIRROR_CHECKS:
        asm = assembly(name, b)
        card = asm.run()
        t0 = time.perf_counter()
        mirror = hostexec.run_host(asm)
        ms = (time.perf_counter() - t0) * 1000.0
        worst, share = _result_diffs(card, mirror)
        row = {"images": b, "max_abs_err": worst, "share_differing": share,
               "mirror_ms_first_run": ms}
        if isinstance(asm, fused.CoefBatchAssembly) and not asm.fold:
            planes = asm._device_x()[:b].cpu().numpy()
            row["decode_bytes_differing"] = int(
                (planes != hostexec.decode_coef(asm)).sum())
            check(row["decode_bytes_differing"] == 0,
                  f"phase11a {name}: the mirror's decode differs from the "
                  "card's kernel")
        lsb = 2 if "jpegdct" in name else MAX_LSB
        check(worst <= lsb and share <= MAX_FRAC,
              f"phase11a {name}: mirror against the card {row}")
        rows[name] = row
        print(f"phase11a {name}: mirror vs card {row}", flush=True)
    timings = {}
    for name, b in MIRROR_TIMED:
        asm = assembly(name, b)
        hostexec.run_host(asm)
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            hostexec.run_host(asm)
            runs.append((time.perf_counter() - t0) * 1000.0)
        ms = statistics.median(runs)
        mpx = sum(p.out_h * p.out_w for p in asm.plans) / 1e6
        timings[f"{name}_b{b}"] = {"ms": ms, "ms_per_mpx": ms / mpx}
    p = sources["print_cmyk444"][0]
    timings["print_cmyk444_b1"] = {
        "ms": rows["print_cmyk444"]["mirror_ms_first_run"],
        "ms_per_mpx": rows["print_cmyk444"]["mirror_ms_first_run"]
        / (p.out_h * p.out_w / 1e6), "runs": 1}
    timings["coef_over_pixel_b8"] = (timings["readme444_b8"]["ms"]
                                     / timings["readme_pixels_b8"]["ms"])
    print("phase11e mirror host ms per batch " + json.dumps(timings),
          flush=True)
    return {"mirror_vs_card": rows, "mirror_ms": timings}


# the stall bound of phase 11's servers (tpu.device_stall_s, seconds) and
# how long each injected stall lasts
STALL_BOUND_S = 1.5
STALL_S = 5.0
PNG_README = "/gen/lenna.png?w=300&h=200"


def _phase11_config(folder: str):
    from fanlin_tpu_torch.config import Config

    return Config.from_obj(_cli_config(folder, 0,
                                       device_stall_s=STALL_BOUND_S))


async def _fetch(s, base: str, url: str) -> tuple:
    """(status, body, cold?) of one GET, checking the cold headers go
    together."""
    async with s.get(base + url) as r:
        body = await r.read()
        cold = r.headers.get("X-Cache-Warmth") == "cold"
        check(cold == (r.headers.get("Cache-Control") == "no-store"),
              f"{url}: X-Cache-Warmth without Cache-Control: no-store")
        return r.status, body, cold


async def _phase11_inproc(dev: torch.device, folder: str,
                          rate: float) -> dict:
    """(b) A real device stall and (c) a raised device error, on the
    server in-process (build_state, tpu.device_stall_s STALL_BOUND_S):
    (b) README and README-as-PNG requests answered from the mirror with
    the cold headers (the PNG within 1 LSB of the card's pixels), the
    counters and a WARNING per mirror batch, recovery, and the kernels
    launched again after it; (c) a RuntimeError, then a KernelBuildError,
    from submit: each fails its request (500, not cold), counted in
    device_errors, never mirrored, no wedge, and the kernels launch
    again. Returns the timings, the launch windows and the mirror's
    README body."""
    import aiohttp
    from aiohttp import web

    from fanlin_tpu_torch.ops._build import KernelBuildError
    from fanlin_tpu_torch.server.app import build_state, create_app

    cfg = _phase11_config(folder)
    state = await build_state(cfg)
    batcher = state.engine.runner.batcher
    runner = web.AppRunner(create_app(cfg, state), access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    base = f"http://127.0.0.1:{runner.addresses[0][1]}"
    out, windows = {}, {}
    try:
        async with aiohttp.ClientSession() as s, _MirrorLog() as log:
            healthy = {}
            for url in (README, PNG_README):
                status, body, cold = await _fetch(s, base, url)
                check(status == 200 and not cold, f"phase11b healthy {url}")
                healthy[url] = body
            # (b) the stall: every batch submitted before its end sleeps
            # on its stream until then
            with _Stall(rate) as stall:
                t0 = time.monotonic()
                stall.until = t0 + STALL_S
                status, mirror_readme, cold = await _fetch(s, base, README)
                out["stall_to_first_mirror_s"] = time.monotonic() - t0
                check(status == 200 and cold, "phase11b: the stalled README "
                      f"request answered {status}, cold {cold}")
                st = dict(batcher.stats)
                check(st["device_wedged"] == 1 and st["device_stalls"] >= 1,
                      f"phase11b: not wedged after the stall: {st}")
                status, png, cold = await _fetch(s, base, PNG_README)
                check(status == 200 and cold, "phase11b: README PNG while "
                      "wedged was not served cold")
                mx, share = _diff_stats(_decoded(png),
                                        _decoded(healthy[PNG_README]))
                check(mx <= MAX_LSB, f"phase11b: PNG body {mx} LSB from "
                      "the card's")
                out["png_max_abs_err"], out["png_share_differing"] = mx, share
                status, again, cold = await _fetch(s, base, README)
                check(status == 200 and cold and again == mirror_readme,
                      "phase11b: the README request while wedged (pixel "
                      "source) differs from the stalled one's mirror body")
                out["readme_db"] = psnr(_decoded(mirror_readme),
                                        _decoded(healthy[README]))
                check(out["readme_db"] >= 45.0, "phase11b: mirror README "
                      f"{out['readme_db']:.2f} dB from the card's")
                st = dict(batcher.stats)
                check(st["host_fallbacks"] >= 3 and log.mirror_warnings()
                      >= st["host_fallbacks"],
                      f"phase11b: counters {st}, {log.mirror_warnings()} "
                      "mirror warnings")
                out["wedged_stats"] = {k: st[k] for k in FAILOVER_KEYS}
                # the end of the stall: the first device-served batch
                await asyncio.sleep(max(stall.until - time.monotonic(), 0.0))
                t_end = stall.until
                while True:
                    status, body, cold = await _fetch(s, base, README)
                    if not cold:
                        break
                    check(time.monotonic() - t_end < 30.0,
                          "phase11b: no recovery 30 s after the stall")
                    await asyncio.sleep(0.02)
                out["stall_end_to_device_s"] = time.monotonic() - t_end
            check(body == healthy[README], "phase11b: the README body after "
                  "recovery differs from the card's before the stall")
            check(batcher.stats["device_wedged"] == 0, "phase11b: still "
                  "wedged")
            _reset_counts()
            for url in (README, PNG_README):
                status, body, cold = await _fetch(s, base, url)
                check(status == 200 and not cold and body == healthy[url],
                      f"phase11b: {url} after recovery")
            windows["phase11b recovered"] = _counts()
            # (c) a raised device error, then a kernel build failure:
            # each fails its request, never reaches the mirror
            for label, exc in (
                    ("error", RuntimeError("injected device error")),
                    ("build failure",
                     KernelBuildError("injected build failure"))):
                before = dict(batcher.stats)
                warned = log.mirror_warnings()
                with _RaiseOnce(exc):
                    status, body, cold = await _fetch(s, base, README)
                st = dict(batcher.stats)
                check(status == 500 and not cold,
                      f"phase11c: a device {label} answered {status}, cold "
                      f"{cold}")
                check(st["device_errors"] == before["device_errors"] + 1
                      and st["host_fallbacks"] == before["host_fallbacks"]
                      and log.mirror_warnings() == warned
                      and st["device_wedged"] == 0,
                      f"phase11c: a device {label}: counters {before} -> "
                      f"{st}")
                _reset_counts()
                status, body, cold = await _fetch(s, base, README)
                check(status == 200 and not cold and body == healthy[README],
                      f"phase11c: README after the device {label}")
                windows[f"phase11c after {label}"] = _counts()
            after = dict(batcher.stats)
            out["mirror_warnings"] = log.mirror_warnings()
            out["stats"] = {k: after[k] for k in FAILOVER_KEYS}
    finally:
        await runner.cleanup()
    for name, w in windows.items():
        check(w["resample"] > 0 and w["jpeg_decode_rgb"] > 0,
              f"{name}: launches {w}")
    print("phase11b/c in-process " + json.dumps(out), flush=True)
    return out, windows, mirror_readme


# the device service of phase 11 (d): the CLI with BatchAssembly.submit
# wrapped to sleep on the batch's stream while a file names a wall-clock
# time still to come (time.time() and sleep cycles per second)
FAULT_BOOT = r"""
import sys, time
import torch
from fanlin_tpu_torch import cli
from fanlin_tpu_torch.ops import fused
_real = fused.BatchAssembly.submit
def submit(self):
    try:
        with open(%r) as f:
            until, rate = map(float, f.read().split())
    except (OSError, ValueError):
        until = 0.0
    left = until - time.time()
    if left > 0 and self.device.type == "cuda":
        torch.cuda._sleep(int(left * rate))
    return _real(self)
fused.BatchAssembly.submit = submit
sys.exit(cli.main(sys.argv[1:]))
"""


class _FaultCliServer(_CliServer):
    """The CLI whose device service stalls while `trigger` names a time
    to come; its counters are not held at 0."""

    def __init__(self, folder: str, trigger: str, **tpu):
        self.trigger = trigger
        self.faults = True
        super().__init__(folder, **tpu)

    def command(self, cfg_json: str) -> list:
        return [sys.executable, "-c", FAULT_BOOT % self.trigger, "-j",
                cfg_json]


async def _phase11_workers(dev: torch.device, folder: str, rate: float,
                           mirror_readme: bytes) -> dict:
    """(d) Worker mode, tpu.workers 2: a stall injected in the device
    service gives README bodies through both gateways that are cold and
    byte-equal to (b)'s mirror body; the service's wedge gauge turns 1
    and the workers' device_available with it (their engines switch
    README to the pixel source), then 0 again, the bodies return to the
    card's, and the workers' engines go back to the coefficient source
    (jpeg_decode_rgb launches again)."""
    trigger = os.path.join(folder, "phase11_stall")
    if os.path.exists(trigger):
        os.remove(trigger)
    srv = _FaultCliServer(folder, trigger, workers=2, warmup=False,
                          device_stall_s=STALL_BOUND_S)
    out = {}
    try:
        srv.wait_banners()
        async with _fresh_session() as s:
            status, healthy, cold = await _fetch(s, srv.base, README)
            check(status == 200 and not cold, "phase11d: healthy README")
            with open(trigger + ".tmp", "w") as f:
                f.write(f"{time.time() + STALL_S!r} {rate!r}")
            os.replace(trigger + ".tmp", trigger)
            t0 = time.monotonic()
            got = await asyncio.gather(*(_fetch(s, srv.base, README)
                                         for _ in range(2)))
            out["stall_to_first_mirror_s"] = time.monotonic() - t0
            wedged = (await _get_stats(s, srv.base))["batcher"]
            check(wedged["device_wedged"] == 1, "phase11d: the service is "
                  f"not wedged: {wedged}")
            await asyncio.sleep(1.2)  # past the workers' gauge cache
            got += await asyncio.gather(*(_fetch(s, srv.base, README)
                                          for _ in range(4)))
            check(all(g[0] == 200 and g[2] and g[1] == mirror_readme
                      for g in got), "phase11d: a README body through the "
                  "gateways was not cold or differs from (b)'s mirror body")
            # each /stats on a fresh connection: some worker's engine
            engines = [(await _get_stats(s, srv.base))["engine"]
                       for _ in range(8)]
            pixel = max(e["pixel_src"] for e in engines)
            check(pixel > 0, "phase11d: no worker switched README to the "
                  "pixel source while the service was wedged")
            os.remove(trigger)
            deadline = time.monotonic() + STALL_S + 30.0
            while (await _get_stats(s, srv.base))["batcher"]["device_wedged"]:
                check(time.monotonic() < deadline,
                      "phase11d: the service never recovered")
                await asyncio.sleep(0.1)
            out["recovered_after_s"] = time.monotonic() - t0
            await asyncio.sleep(1.2)  # past the workers' gauge cache
            mid = await _get_stats(s, srv.base)
            got = await asyncio.gather(*(_fetch(s, srv.base, README)
                                         for _ in range(4)))
            check(all(g[0] == 200 and not g[2] and g[1] == healthy
                      for g in got), "phase11d: README after recovery")
            after = await _get_stats(s, srv.base)
            # the workers are back on the coefficient source
            w = _diff(after["kernel_launches"], mid["kernel_launches"])
            out["after_recovery_launches"] = w
            out["service"] = {k: after["batcher"][k] for k in FAILOVER_KEYS}
            out["worker_pixel_src"] = pixel
        check(w["resample"] > 0 and w["jpeg_decode_rgb"] > 0,
              f"phase11d: launches {w} after recovery")
        out["drain_s"] = srv.terminate()
    finally:
        srv.kill()
    print("phase11d workers 2 " + json.dumps(out), flush=True)
    return out


def phase11(dev: torch.device, folder: str) -> tuple:
    """Phase 11: the mirror against the card, a stall and an error in
    the single process, a stall in worker mode. Returns the failover
    line's figures and the launch-count windows of (b) and (c)."""
    from PIL import Image

    with open(os.path.join(GOLDEN, "lenna_src.jpg"), "rb") as f:
        Image.open(io.BytesIO(f.read())).convert("RGB").save(
            os.path.join(folder, "lenna.png"))
    rate = _sleep_rate()
    out = {"sleep_cycles_per_s": rate}
    out.update(phase11_mirror(dev, folder))
    inproc, windows, mirror_readme = asyncio.run(
        _phase11_inproc(dev, folder, rate))
    out["inproc"] = inproc
    out["workers2"] = asyncio.run(_phase11_workers(dev, folder, rate,
                                                   mirror_readme))
    return out, windows


def main() -> int:
    smi = phase0()
    from fanlin_tpu_torch import device as device_mod

    device_mod.configure()
    dev = device_mod.cuda_device()
    _watch_failover()
    build_s = phase1()
    bench = phase2(dev)
    decode = phase2b(dev)
    phase2b_reuse(dev)
    phase2c(dev)
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
    k9 = phase6_tail(dev)
    _reset_counts()
    dct_coef_engine, n_dct_coef = phase3_engine(dev, True, device_dct=True)
    windows["coef jpegdct engine"] = _counts()
    _reset_counts()
    _, n_dct_pixel = phase3_engine(dev, False, device_dct=True)
    windows["pixel jpegdct engine"] = _counts()
    windows["jpegdct server"] = asyncio.run(_phase6_server(dev))
    phase6_formats(dev)
    # phase 7: the CMYK / ICC path
    cmyk_dir = _gen_cmyk_sources()
    _reset_counts()
    cmyk = phase7_kernels(dev, _phase7_lut(cmyk_dir))
    checked = _counts()  # phase 7 (a, b, e): checks and timing only
    earlier = list(windows)
    _reset_counts()
    cmyk_engine, host_icc_engine, n_cmyk, n_cmyk_px = phase7_engine(
        dev, cmyk_dir)
    windows["cmyk engine"] = _counts()
    phase7_stage_times(cmyk_engine, host_icc_engine, cmyk_dir)
    windows["cmyk server"] = asyncio.run(_phase7_server(dev, cmyk_dir))
    # phase 8: worker mode, N gateway workers around one device service
    windows.update(asyncio.run(_phase8(dev, cmyk_dir, build_s)))
    # phase 9: the folded fast path (tpu.fast_decode, K11) and
    # tpu.data_parallel on one card
    k11 = phase9_kernels(dev)
    fold_engine, n_folded, windows["fold engine"] = phase9_engine(dev)
    w9, burst_folded = asyncio.run(_phase9_workers(dev, cmyk_dir))
    windows.update(w9)
    # phase 10: tpu.fast (the resample kernel's bf16 form, the chain's,
    # K11's) and tpu.profile_dir
    fast_bench = phase10_kernels(dev)
    k11_fast = phase10_k11(dev)
    split_windows = list(windows)
    fast_engine, windows["fast engine"] = phase10_engine(dev)
    w10, n_fast_folded, trace = asyncio.run(_phase10_servers(dev, cmyk_dir))
    windows.update(w10)
    # every phase so far ran on a healthy card: nothing was served by the
    # host mirror
    healthy = check_healthy_phases()
    # phase 11: the host mirror and device failover, faults injected
    failover, w11 = phase11(dev, cmyk_dir)
    failover["healthy_phases"] = healthy
    windows.update(w11)
    split_windows += list(w11)
    for name, c in windows.items():
        print(f"launch counts ({name}): {c}", flush=True)
    for name in earlier:
        check(windows[name]["jpeg_decode_cmyk_rgb"]
              == windows[name]["cmyk_lut"] == 0,
              f"the {name} run launched a CMYK kernel")
    for name in windows:
        check(windows[name]["jpeg_decode_cmyk"] == 0,
              f"the {name} run launched K12a, the yardstick")
    # the window holds the device ICC route's requests (coefficients, and
    # pixels for the EXIF-rotated one) and the host lcms2 route's (pixels:
    # one resample each)
    w = windows["cmyk engine"]
    check(w["jpeg_decode_cmyk_rgb"] == n_cmyk and w["cmyk_lut"] == n_cmyk_px
          and w["resample"] == 2 * (n_cmyk + n_cmyk_px),
          f"cmyk engine launched {w} for {n_cmyk} coefficient and "
          f"{n_cmyk_px} pixel requests on each route")
    for name, paths in (("jpeg_decode_cmyk_rgb", ("cmyk engine",
                                                  "cmyk server")),
                        ("cmyk_lut", ("cmyk engine",))):
        for path in paths:
            check(windows[path][name] > 0,
                  f"kernel {name} was never launched by the {path} run")
    # the fast form only where tpu.fast is on, and the split form never
    # there
    for name in windows:
        keys = FAST_KEYS if name in split_windows else SPLIT_KEYS
        check(all(windows[name][k] == 0 for k in keys),
              f"the {name} run launched {keys}: {windows[name]}")
    for key in FAST_KEYS:
        for path in ("fast engine", "fast server", "phase10c workers"):
            check(windows[path][key] > 0,
                  f"kernel {key} was never launched by the {path} run")
    for path, n in (("coef engine", n_coef), ("coef jpegdct engine",
                                               n_dct_coef)):
        w = windows[path]
        check(w["resample"] + w["resample_blur"] == n
              and w["jpeg_decode_rgb"] == n,
              f"{path} launched {w} for {n} requests")
    for path, n in (("pixel engine", n_pixel), ("pixel jpegdct engine",
                                                 n_dct_pixel)):
        w = windows[path]
        check(w["resample"] + w["resample_blur"] == n
              and w["jpeg_decode_rgb"] == 0,
              f"{path} launched {w} for {n} requests")
    for name in MAIN_PATH_KERNELS:
        for path in ("coef engine", "server", "phase5b"):
            check(windows[path][name] > 0,
                  f"kernel {name} was never launched by the {path} run")
    launches = {k: sum(c[k] for c in windows.values())
                for k in windows["server"]}
    readme_stage_times(pixel_engine, "pixel")
    # the default route (coefficient, PIL encode on the card's machine)
    # and the jpegdct route in turns
    for label, engine in (("coefficient", coef_engine),
                          ("jpegdct coefficient", dct_coef_engine),
                          ("jpegdct coefficient", dct_coef_engine),
                          ("coefficient", coef_engine)):
        readme_stage_times(engine, label)
    # the default README route beside phase 7 (c)'s CMYK stage times,
    # and the README request through the CMYK engine (a YCbCr source)
    readme_stage_times(coef_engine, "coefficient (beside phase 7)")
    readme_stage_times(cmyk_engine, "coefficient, CMYK engine")
    # phase 9 (e): the fast_decode route and the default one in turns
    for label, engine in (("coefficient", coef_engine),
                          ("fast_decode", fold_engine),
                          ("fast_decode", fold_engine),
                          ("coefficient", coef_engine)):
        readme_stage_times(engine, label)
    # phase 10 (d): the fast route and the default one in turns
    for label, engine in (("coefficient", coef_engine),
                          ("fast coefficient", fast_engine),
                          ("fast coefficient", fast_engine),
                          ("coefficient", coef_engine)):
        readme_stage_times(engine, label)
    print("phase10e trace summary " + json.dumps(trace), flush=True)
    print("phase6e K9 tail summary " + json.dumps(k9), flush=True)
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
    ]
    # the CMYK kernels, timed at README-like B=8 (lenna as CMYK 4:4:4);
    # no PyTorch call decodes islow or interpolates a 4-D LUT
    # (grid_sample stops at 3-D volumes): library_ms is null. K12a is off
    # the main path (0 launches there), kept as the fused kernel's
    # yardstick: its checked_launches are phase 7's checks and timing.
    timed = cmyk["lenna_cmyk444_b8"]
    for name, key, err, source, replaces in (
            ("jpeg_decode_cmyk_rgb", "fused", "err", src,
             "fanlin_tpu/ops/jpeg_decode.py:364, "
             "fanlin_tpu/ops/cmyk_lut.py:63"),
            ("cmyk_lut", "k12b", "b_err", "fanlin_tpu_torch/csrc/cmyk_lut.cu",
             "fanlin_tpu/ops/cmyk_lut.py:63, fanlin_tpu/ops/cmyk_lut.py:41"),
            ("jpeg_decode_cmyk", "k12a", "a_err", src,
             "fanlin_tpu/ops/jpeg_decode.py:364")):
        t = timed[key]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r[err] for r in cmyk.values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None}
        if key == "k12a":
            entry["checked_launches"] = checked[name]
        kernels.append(entry)
    # the resample kernel's bf16 form (tpu.fast), at README and blur B=16
    for name, key, shape, line in (
            ("resample_uniform_fast", "resample_fast", "readme_b16", 86),
            ("resample_uniform_blur_fast", "resample_blur_fast", "blur_b16",
             91)):
        r = fast_bench[shape]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fanlin_tpu_torch/csrc/resample.cu",
            "replaces": f"fanlin_tpu/ops/pallas_kernels.py:{line}",
            "launches": launches[key],
            "max_abs_err": max(x["max_abs_err"] for x in fast_bench.values()
                               if x["blur"] == r["blur"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "device_ms": r["device_ms"],
            "split_ms": r["split_ms"]})
    # K11 is torch code, not a kernel: its figures on a line of their own
    # (README B=16; launches: the folded batches of (b) and (c)'s burst;
    # its bf16 form's, those of phase 10 (c))
    t = k11["lenna444_b16"]
    print(json.dumps({"torch_programs": [{
        "name": "folded_decode_resample", "route": "torch",
        "source": "fanlin_tpu_torch/ops/jpeg_decode.py",
        "replaces": "fanlin_tpu/ops/jpeg_decode.py:543",
        "launches": n_folded + burst_folded,
        "max_abs_err": max(r["err"] for r in k11.values()),
        "ms": t["ms"], "device_ms": t["device_ms"],
        "kernels_per_call": t["kernels_per_call"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound"]["bound_ms"], "bound_by": t["bound"]["bound_by"],
        "library_ms": None}, {
        "name": "folded_decode_resample_fast", "route": "torch",
        "source": "fanlin_tpu_torch/ops/jpeg_decode.py",
        "replaces": "fanlin_tpu/ops/jpeg_decode.py:543",
        "launches": n_fast_folded,
        "max_abs_err": max(r["err"] for r in k11_fast.values()),
        "ms": k11_fast["lenna444_b16"]["ms"],
        "device_ms": k11_fast["lenna444_b16"]["device_ms"],
        "f32_ms": k11_fast["lenna444_b16"]["f32_ms"],
        "db_against_f32": k11_fast["lenna444_b16"]["db"]}]}))
    print(json.dumps({"failover": failover}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
