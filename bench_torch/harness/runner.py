"""One run of one cell: the corpus from the seed, the server started and
warmed, the traffic for the window (a capture of the device trace in
its middle when traced), then the check against the reference once the
server has stopped, and the result line."""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from . import cell as cell_mod
from . import compare, devtrace, loadgen, readers
from .server import Server, cli_argv, free_port, split_cores

BUILD = cell_mod.REPO / "build" / "bench_torch"
WARMUP_S = 2.0  # the cell's own loop before the window, after one of each pair
CAPTURE_S = 3.0  # the traced run's /profile capture, at most


@dataclasses.dataclass
class Capture:
    t0: float
    t1: float
    seconds: float
    stats_before: dict
    stats_after: dict
    trace_file: str = ""
    trace: Optional[devtrace.Trace] = None


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    cell: cell_mod.Cell
    seed: int
    seconds: float
    t0: float  # the window, perf_counter seconds
    setup_s: float
    records: List[loadgen.Record]
    stats_before: dict
    stats_after: dict
    sources: Dict[str, dict]  # name -> {"w", "h", "subsamp"}
    host: tuple = ({}, {})  # host_reading() before and after the window
    wrong: set = dataclasses.field(default_factory=set)  # bodies that failed
    capture: Optional[Capture] = None

    @property
    def t_end(self) -> float:
        return self.t0 + self.seconds


def _source_info(path: Path) -> dict:
    from PIL import Image, JpegImagePlugin

    with Image.open(path) as im:
        sub = JpegImagePlugin.get_sampling(im) if im.format == "JPEG" else -1
        return {"w": im.size[0], "h": im.size[1],
                "subsamp": {0: 444, 1: 422, 2: 420}.get(sub, 0)}


def host_reading() -> dict:
    """The host's CPU time by kind (/proc/stat's first line, in ticks),
    its load average and the cores' clocks (MHz), where Linux gives
    them: what else ran on the machine, and how fast, beside a run."""
    out = {}
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:9]]
        out["ticks"] = dict(zip(("user", "nice", "system", "idle", "iowait",
                                 "irq", "softirq", "steal"), v))
        with open("/proc/loadavg") as f:
            out["loadavg"] = float(f.read().split()[0])
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
        if mhz:
            out["mhz"] = (min(mhz), max(mhz))
    except (OSError, ValueError, IndexError):
        pass
    return out


def host_line(before: dict, after: dict) -> str:
    """The host over a window: the shares of its CPU time that were
    busy, stolen by the hypervisor and waiting on I/O, its load average
    and clocks at the end."""
    if "ticks" not in before or "ticks" not in after:
        return "host: not readable"
    d = {k: after["ticks"][k] - before["ticks"][k] for k in before["ticks"]}
    total = sum(d.values()) or 1
    busy = total - d["idle"] - d["iowait"]
    return (f"host over the window: busy {100 * busy / total:.2f} %, steal "
            f"{100 * d['steal'] / total:.2f} %, iowait "
            f"{100 * d['iowait'] / total:.2f} %; loadavg "
            f"{after.get('loadavg')}; MHz {after.get('mhz')}")


def server_config(cell: cell_mod.Cell, port: int, corpus: Path,
                  profile_dir: Optional[Path], control: Optional[str]) -> dict:
    cfg = json.loads(json.dumps(cell.config["server"]))
    cfg.update(port=port, bind_addr="127.0.0.1")
    cfg["providers"] = [{"path": cell.config["provider"],
                         "src": "file://localhost" + str(corpus)}]
    tpu = cfg.setdefault("tpu", {})
    if profile_dir is not None:
        tpu["profile_dir"] = str(profile_dir)
    if control == "fast":
        tpu["fast"] = True
    elif control is not None:
        raise ValueError(f"unknown control {control!r}")
    return cfg


def server_env(work: Path) -> dict:
    """The server's environment: this one, with every build and kernel
    cache the program or its libraries may use at fixed paths inside
    the checkout."""
    env = dict(os.environ)
    cache = BUILD / "cache"
    env.update(TORCH_EXTENSIONS_DIR=str(cache / "torch_extensions"),
               TRITON_CACHE_DIR=str(cache / "triton"),
               CUDA_CACHE_PATH=str(cache / "cuda"))
    return env


def gpu_memory_bytes() -> Optional[int]:
    """The fullest card's memory in use (nvidia-smi, MiB): the server's
    CUDA context and what its caching allocator holds, which it keeps
    at its peak."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used",
             "--format=csv,noheader,nounits"], capture_output=True, text=True,
            timeout=30, check=True).stdout
        return max(int(float(x)) for x in out.split()) * 1024 * 1024
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


async def _get_json(session, url: str, timeout: float = 120.0) -> dict:
    import aiohttp

    async with session.get(url, timeout=aiohttp.ClientTimeout(
            total=timeout)) as r:
        if r.status != 200:
            raise RuntimeError(f"GET {url}: {r.status} {await r.text()}")
        return json.loads(await r.read())


async def _capture(session, base: str, at: float, seconds: float) -> Capture:
    now = time.perf_counter()
    if at > now:
        await asyncio.sleep(at - now)
    before = await _get_json(session, base + "/stats")
    t0 = time.perf_counter()
    got = await _get_json(session, f"{base}/profile?seconds={seconds}",
                          timeout=seconds + 120)
    cap = Capture(t0, t0 + seconds, seconds, before, {})
    cap.stats_after = await _get_json(session, base + "/stats")
    cap.trace_file = got["trace_file"]
    return cap


async def _drive(cell, srv: Server, sources: List[str], seed: int,
                 seconds: float, traced: bool, t_start: float):
    import aiohttp

    traffic = cell.traffic
    # the load generator on its own core (this thread, where the loop
    # runs); the corpus was made before, by threads on every core
    os.sched_setaffinity(0, split_cores()[0])
    conn = aiohttp.TCPConnector(limit=0)
    async with aiohttp.ClientSession(connector=conn) as session:
        t_begin = time.perf_counter()
        client = loadgen.Client(session, srv.base, cell.config["provider"],
                                traffic.get("accept", ""))
        # warm-up: every (source, query) pair of the mix once, then the
        # mix's own loop; none of it is counted
        warm_pairs = sorted({p for p, _ in zip(
            loadgen.pairs(traffic, sources, seed),
            range(len(sources) * sum(int(q.get("weight", 1))
                                     for q in traffic["queries"])))})
        width = int(traffic.get("connections", 8))
        for i in range(0, len(warm_pairs), width):
            recs = [loadgen.Record(s, q, time.perf_counter())
                    for s, q in warm_pairs[i:i + width]]
            await asyncio.gather(*(client.fetch(r) for r in recs))
            bad = [r for r in recs if r.status != 200]
            if bad:
                raise RuntimeError(f"warm-up request {bad[0].src}?"
                                   f"{bad[0].query} answered {bad[0].status}")
        t_pairs = time.perf_counter()
        await loadgen.drive(client, traffic, sources, seed + 1, WARMUP_S,
                            time.perf_counter())
        client.bodies.clear()
        stats_before = await _get_json(session, srv.base + "/stats")
        # the load generator's own collector stays out of the window
        gc.collect()
        gc.freeze()
        gc.disable()
        host_before = host_reading()
        t0 = time.perf_counter() + 0.01
        setup_s = t0 - t_start
        print(f"setup: every pair once {t_pairs - t_begin:.3f} s, the "
              f"loop {t0 - t_pairs:.3f} s", file=sys.stderr)
        window = asyncio.ensure_future(
            loadgen.drive(client, traffic, sources, seed, seconds, t0))
        capture = None
        if traced:
            cap_s = min(CAPTURE_S, seconds / 2)
            capture = await _capture(session, srv.base,
                                     t0 + (seconds - cap_s) / 2, cap_s)
        records = await window
        host = (host_before, host_reading())
        gc.enable()
        gc.unfreeze()
        stats_after = await _get_json(session, srv.base + "/stats")
        return (records, client.bodies, stats_before, stats_after, t0,
                setup_s, capture, host)


class NoCard(RuntimeError):
    """The machine lacks the cards a cell needs."""


def run_cell(cell: cell_mod.Cell, seed: int, seconds: float, traced: bool,
             t_start: float, argv_for: Callable[[str], List[str]] = cli_argv,
             control: Optional[str] = None, on_card: bool = True,
             env: Optional[dict] = None, log=sys.stderr,
             look_for_card: Optional[Callable[[], Optional[str]]] = None) -> dict:
    """The result line's object. `argv_for(config_json)` is the server's
    command. `look_for_card()`, called once the server is spawning (its
    start-up and the harness's own imports overlap), returns why the
    machine will not do, or None; the server is then stopped and NoCard
    raised. `on_card` False (tests) runs the reference on the CPU and
    reports the CPU as the device."""
    seed = int(seed) % 2**63
    work = BUILD / cell.name
    corpus = work / "corpus"
    profile_dir = work / "profile" if traced else None
    for d in (corpus, profile_dir):
        if d is not None:
            shutil.rmtree(d, ignore_errors=True)
            d.mkdir(parents=True)
    port = free_port()
    cfg = server_config(cell, port, corpus, profile_dir, control)
    srv = Server(argv_for(json.dumps(cfg)), cell_mod.REPO,
                 env if env is not None else server_env(work),
                 work / "server.log", port, cpus=split_cores()[1])
    every_core = os.sched_getaffinity(0)
    t_spawn = time.perf_counter()
    srv.start()
    try:
        why = look_for_card() if look_for_card is not None else None
        if why:
            raise NoCard(why)
        gen = cell.config["corpus"]
        paths = cell_mod.load_module("sources", gen["generator"]).generate(
            gen, seed, corpus, cell_mod.BENCH)
        names = sorted(paths)
        t_corpus = time.perf_counter()
        srv.wait_ready(warmup=cfg["tpu"].get("warmup", True))
        print(f"setup: harness start to spawn {t_spawn - t_start:.3f} s, "
              f"corpus {t_corpus - t_spawn:.3f} s, spawn to banner "
              f"{srv.t_banner - t_spawn:.3f} s, to warmed "
              f"{time.perf_counter() - t_spawn:.3f} s", file=log)
        (records, bodies, stats_before, stats_after, t0, setup_s,
         capture, host) = asyncio.run(_drive(cell, srv, names, seed, seconds,
                                             traced, t_start))
        memory = gpu_memory_bytes() if on_card else None
    finally:
        os.sched_setaffinity(0, every_core)  # the check uses every core
        code = srv.stop()
    print(f"server exit code {code}; log {srv.log}", file=log)
    import torch

    sources = {n: _source_info(p) for n, p in paths.items()}
    run = Run(cell, seed, seconds, t0, setup_s, records, stats_before,
              stats_after, sources, host=host, capture=capture)
    if capture is not None:
        capture.trace = devtrace.Trace.load(capture.trace_file)

    device = torch.device("cuda") if on_card else torch.device("cpu")
    checked = compare.check(records, bodies,
                            {n: p.read_bytes() for n, p in paths.items()},
                            device, cell.config["limits"])
    run.wrong = checked["wrong"]
    _report(run, checked, log)

    metrics = {}
    kind = "per_layer" if traced else "end_to_end"
    folder = "metrics" if traced else "end_to_end"
    for m in getattr(cell, kind):
        value = cell_mod.load_module(folder, m["name"]).read(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif value is not None:
            metrics[m["name"]] = {"value": None, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": memory}
    out = {"correct": bool(checked["ok"] and records),
           "attempted": len(records),
           "failed": sum(1 for r in records if r.status != 200),
           "metrics": metrics, "device": dev}
    if capture is not None:
        dev["busy_s"] = capture.trace.busy_s()
        dev["window_s"] = capture.seconds
        out["breakdown"] = {"device_ops": capture.trace.top_ops(),
                            "idle_gaps": capture.trace.idle_gaps()}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checked["numbers"].items()}
    for k, (v, lim) in checked["numbers"].items():
        print(f"check {k} {v} limit {lim}", file=log)
    return out


def _report(run: Run, checked: dict, log) -> None:
    """Lines on standard error before the checks: what the window held,
    the generator's lateness, cold (host-mirror) answers and the
    batcher's failover counters over the window."""
    recs = run.records
    late = [(r.sent - r.due) * 1e3 for r in recs if r.sent]
    print(f"window {run.seconds} s: {len(recs)} requests, "
          f"{sum(r.status == 200 for r in recs)} answered 200, "
          f"{checked['distinct']} distinct bodies checked in "
          f"{checked['seconds']:.3f} s; setup {run.setup_s:.3f} s",
          file=log)
    if late:
        print(f"generator lateness ms: p50 {readers.percentile(late, 50):.3f} "
              f"p99 {readers.percentile(late, 99):.3f} max {max(late):.3f}",
              file=log)
    print(host_line(*run.host), file=log)
    cold = sum(1 for r in recs if r.cold)
    b0, b1 = run.stats_before["batcher"], run.stats_after["batcher"]
    failover = {k: b1.get(k, 0) - b0.get(k, 0)
                for k in ("host_fallbacks", "device_stalls", "device_errors")}
    failover.update(device_wedged=b1.get("device_wedged"),
                    probe_threads=b1.get("probe_threads"))
    print(f"cold answers {cold}; failover over the window {failover}",
          file=log)
    launches = {k: run.stats_after["kernel_launches"].get(k, 0)
                - run.stats_before["kernel_launches"].get(k, 0)
                for k in run.stats_after.get("kernel_launches") or {}}
    print(f"kernel launches over the window "
          f"{ {k: v for k, v in launches.items() if v} }", file=log)
