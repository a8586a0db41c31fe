#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fanlin_tpu_torch) on one CUDA card.

Usage, from the repository root:  python3 chip_smoke.py

Phases (each failure exits non-zero; nothing is caught):
  0. versions, card name and power limit (nvidia-smi), host codecs;
     exits non-zero when CUDA is absent
  1. build the CUDA resample kernel from fanlin_tpu_torch/csrc/
  2. the kernel against its plain torch version on the card at the
     main path's shapes (<= 1 LSB, <= 0.5 % of bytes differing), with
     median times (CUDA events, plain/kernel/kernel/plain turns)
  3. the golden floors of tests/test_golden_parity.py on tests/golden:
     the pre-encode floor through the port's batch assembly, then the
     encoded floor through the port's Engine, each request of which
     must launch the kernel
  4. the port's HTTP server in-process on 127.0.0.1 over a file origin
Launch counts are reset after the pre-encode check and read after
phase 4, so they count the Engine's and the server's launches only:
every kernel of the path must have been launched there.

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. The port imports torch and never jax.
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
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
MAX_LSB = 1
MAX_FRAC = 0.005  # share of output bytes allowed to differ

# (name, src_w, src_h, query, batch): the README workload (lenna 512x512
# -> w=300&h=200) and its variants, crop, blur (the K2 kernel) and a
# 12 MP camera source.
SHAPES = [
    ("readme_b1", 512, 512, "w=300&h=200", 1),
    ("readme_b16", 512, 512, "w=300&h=200", 16),
    ("grayscale_b16", 512, 512, "w=300&h=200&grayscale=true", 16),
    ("inverse_b16", 512, 512, "w=300&h=200&inverse=true", 16),
    ("canvas_b16", 512, 512, "w=300&h=200&rgb=32,32,32", 16),
    ("crop_b16", 512, 512, "w=100&h=100&crop=true", 16),
    ("blur_b16", 512, 512, "w=100&h=80&blur=1", 16),
    ("12mp_b2", 4000, 3000, "w=1200&h=800", 2),
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
    print(f"phase1 built {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


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


def phase2(dev: torch.device) -> dict:
    from fanlin_tpu.spec.query import parse_query
    from fanlin_tpu_torch.ops import fused, plan as plan_mod
    from fanlin_tpu_torch.ops import resample_kernels as rk

    rng = np.random.default_rng(20261016)
    results = {}
    for name, sw, sh, qs, batch in SHAPES:
        plan = plan_mod.plan_image(sw, sh, parse_query(qs), opaque=True)
        imgs = [rng.integers(0, 256, (sh, sw, 3), dtype=np.uint8)
                for _ in range(batch)]
        asm = fused.BatchAssembly([plan] * batch, imgs, dev)
        check(asm.uses_kernel(), f"{name}: batch does not take the kernel")
        av, ah, bv, bh = plan_mod._uniform_padded(plan)
        flags, fill, box, tav, tah, tbv, tbh = rk.params_from_numpy(
            asm.flags, asm.fill, asm.box, av, ah, bv, bh, device=dev)
        x = torch.from_numpy(asm.x).to(dev)
        args = (flags, fill, box, tav, tah, x, tbv, tbh)
        crop = (plan.out_h, plan.out_w)

        got = rk.resample_uniform(*args, crop=crop)
        torch.cuda.synchronize()
        want = rk.resample_uniform_ref(*args, crop=crop)
        check(got.shape == want.shape == (asm.b, 3) + crop,
              f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
        max_err = int(diff.max())
        frac = float((diff > 0).float().mean())
        check(max_err <= MAX_LSB, f"{name}: max abs err {max_err} LSB")
        check(frac <= MAX_FRAC, f"{name}: {frac:.6f} of bytes differ")

        reps = 5 if name.startswith("12mp") else 20
        ms, plain_ms = _time_pair(
            lambda: rk.resample_uniform_ref(*args, crop=crop),
            lambda: rk.resample_uniform(*args, crop=crop), reps)
        results[name] = {"batch": asm.b, "max_abs_err": max_err,
                         "frac_diff": frac, "ms": ms, "plain_ms": plain_ms}
        print(f"phase2 {name} B={asm.b} src={asm.sh}x{asm.sw} "
              f"out={asm.oh}x{asm.ow} max_abs_err={max_err} "
              f"frac_diff={frac:.2e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}",
              flush=True)
    return results


def _golden_sources():
    from fanlin_tpu.spec.query import parse_query

    for src in ("synth", "lenna"):
        with open(os.path.join(GOLDEN, f"{src}_src.jpg"), "rb") as f:
            data = f.read()
        for cfg, qs in GOLDEN_CASES:
            yield src, data, cfg, parse_query(qs)


def _golden_rgb(name: str) -> np.ndarray:
    from PIL import Image

    with Image.open(os.path.join(GOLDEN, name)) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def phase3_pre_encode(dev: torch.device) -> None:
    """The pre-encode golden floor: the port's assembly on the card
    against the golden pixels. Runs outside the launch-count window."""
    from fanlin_tpu_torch.engine import codecs
    from fanlin_tpu_torch.ops import fused, plan as plan_mod

    for src, data, cfg, q in _golden_sources():
        img, has_alpha, _ = codecs.decode(data)
        plan = plan_mod.plan_image(img.shape[1], img.shape[0], q,
                                   opaque=not has_alpha)
        out = fused.make_assembly([plan], [img], ["rgb"], dev).run()[0]
        d_px = psnr(out[:, :, :3], _golden_rgb(f"{src}_{cfg}.png"))
        print(f"phase3 {src}/{cfg} pre-encode {d_px:.2f} dB", flush=True)
        check(d_px >= 50.0, f"{src}/{cfg}: pre-encode {d_px:.2f} dB < 50")


def phase3_engine(dev: torch.device) -> int:
    """The port's Engine on the golden corpus: encoded floor, and at
    least one kernel launch by each request."""
    from PIL import Image

    from fanlin_tpu.spec.content import Format
    from fanlin_tpu_torch.engine import Engine
    from fanlin_tpu_torch.ops import resample_kernels as rk

    engine = Engine(dev)
    n = 0
    for src, data, cfg, q in _golden_sources():
        before = sum(rk.launch_counts().values())
        mime, payload = engine.process_image(data, q, Format())
        added = sum(rk.launch_counts().values()) - before
        n += 1
        check(added >= 1, f"{src}/{cfg}: the Engine launched no kernel")
        check(mime == "image/jpeg", f"{src}/{cfg}: mime {mime}")
        with Image.open(io.BytesIO(payload)) as im:
            got = np.asarray(im.convert("RGB"), dtype=np.uint8)
        golden_enc = _golden_rgb(f"{src}_{cfg}.jpg")
        check(got.shape == golden_enc.shape, f"{src}/{cfg}: shape")
        d_enc = psnr(got, golden_enc)
        print(f"phase3 {src}/{cfg} encoded {d_enc:.2f} dB, "
              f"{added} launch(es)", flush=True)
        check(d_enc >= 45.0, f"{src}/{cfg}: encoded {d_enc:.2f} dB < 45")
    return n


async def _phase4(dev: torch.device) -> None:
    import aiohttp
    from aiohttp import web
    from PIL import Image

    from fanlin_tpu.config import Config
    from fanlin_tpu_torch.server.app import build_state, create_app

    cfg = Config.from_obj({
        "port": 0, "bind_addr": "127.0.0.1", "max_clients": 8,
        "client": {"s3": {"aws_region": "x"},
                   "web": {"user_agent": "chip-smoke", "timeout": 2}},
        "providers": [{"path": "baz", "src": "file://localhost" + GOLDEN}],
    })
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
                print("phase4 /stats", await r.text(), flush=True)
    finally:
        await runner.cleanup()
    print("phase4 ping, jpeg 300x200, webp, blur, 404: ok", flush=True)


def main() -> int:
    smi = phase0()
    from fanlin_tpu_torch import device as device_mod
    from fanlin_tpu_torch.ops import resample_kernels as rk

    device_mod.configure()
    dev = device_mod.cuda_device()
    phase1()
    bench = phase2(dev)

    phase3_pre_encode(dev)

    # the main path's launch-count window: the Engine and HTTP phases only
    rk.reset_launch_counts()
    n_requests = phase3_engine(dev)
    after3 = rk.launch_counts()
    check(sum(after3.values()) >= n_requests,
          f"engine phase launched {after3} for {n_requests} requests")
    asyncio.run(_phase4(dev))
    counts = rk.launch_counts()
    check(sum(counts.values()) > sum(after3.values()),
          "the HTTP phase launched no kernel")
    for name, c in counts.items():
        check(c > 0, f"kernel {name} was never launched by the main path")
    print(f"launch counts (engine + server phases): {counts}")
    check("jax" not in sys.modules, "jax was imported")

    k1 = [r for n, r in bench.items() if not n.startswith("blur")]
    k2 = bench["blur_b16"]
    kernels = [
        {"name": "resample_uniform", "route": "cuda",
         "source": "fanlin_tpu_torch/csrc/resample.cu",
         "replaces": "fanlin_tpu/ops/pallas_kernels.py:86",
         "launches": counts["resample"],
         "max_abs_err": max(r["max_abs_err"] for r in k1),
         "ms": bench["readme_b16"]["ms"],
         "plain_ms": bench["readme_b16"]["plain_ms"]},
        {"name": "resample_uniform_blur", "route": "cuda",
         "source": "fanlin_tpu_torch/csrc/resample.cu",
         "replaces": "fanlin_tpu/ops/pallas_kernels.py:91",
         "launches": counts["resample_blur"],
         "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"]},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
