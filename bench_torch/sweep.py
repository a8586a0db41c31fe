#!/usr/bin/env python3
"""Find the knee of an open-loop traffic mix on a configuration, both
found by name (configs/<name>.json, traffic/<name>.json), before a cell
of them is written into BENCHMARK.json: one server, warmed as a run of
a cell warms it, then the mix's open loop at each offered rate in turn,
each for --seconds.

    python3 bench_torch/sweep.py --config readme-lenna \
        --traffic readme-jpeg-open --seed N --seconds S --rates 50,70,100

One JSON line per rate: offered and completed rates, p50/p99 from the
due time, failures, the generator's lateness, and the backlog's growth
(the p50 of the window's last quarter of arrivals over its first
quarter's, with the p50 of each quarter), then the knee: the highest
rate at and below which every swept rate completed within 2 % of the
offered rate with no growing backlog (the last quarter's p50 at most
1.25 times the first's). An open-loop cell runs at 0.8 times the knee.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import cell as cell_mod  # noqa: E402
from harness import loadgen, readers, runner  # noqa: E402
from harness.server import Server, cli_argv, free_port, split_cores  # noqa: E402


def summary(rate: float, seconds: float, recs) -> dict:
    t0 = min(r.due for r in recs)
    done = sum(1 for r in recs if r.status == 200 and r.done <= t0 + seconds)
    q = max(len(recs) // 4, 1)
    quarters = [readers.percentile([r.latency_s * 1e3
                                    for r in recs[i * q:(i + 1) * q]], 50)
                for i in range(4)]
    first, last = quarters[0], quarters[-1]
    late = [(r.sent - r.due) * 1e3 for r in recs]
    lat = [r.latency_s * 1e3 for r in recs]
    return {"offered_per_s": len(recs) / seconds,
            "completed_per_s": done / seconds,
            "p50_ms": readers.percentile(lat, 50),
            "p99_ms": readers.percentile(lat, 99),
            "failed": sum(1 for r in recs if r.status != 200),
            "lateness_p99_ms": readers.percentile(late, 99),
            "backlog_growth": last / first if first else None,
            "quarters_p50_ms": quarters,
            "rate": rate}


def knee(lines) -> float:
    """The knee of `summary` lines (0 where the lowest rate fails)."""
    best = 0.0
    for line in sorted(lines, key=lambda l: l["rate"]):
        growth = line["backlog_growth"]
        if (line["completed_per_s"] < 0.98 * line["offered_per_s"]
                or growth is None or growth > 1.25):
            break
        best = line["rate"]
    return best


def sweep_cell(config: str, traffic: str) -> cell_mod.Cell:
    """A cell of the named configuration and traffic mix, with no
    metrics: the sweep reports its own numbers."""
    return cell_mod.Cell.from_parts(f"sweep-{config}-{traffic}", config,
                                    traffic, cell_mod.load_json("configs", config),
                                    cell_mod.load_json("traffic", traffic))


async def sweep(cell, srv: Server, names, seed: int, seconds: float, rates):
    import aiohttp

    lines = []
    os.sched_setaffinity(0, split_cores()[0])
    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0)) as session:
        client = loadgen.Client(session, srv.base, cell.config["provider"],
                                cell.traffic.get("accept", ""))
        for s, q in sorted(set(zip(names, [cell.traffic["queries"][0]["query"]]
                                   * len(names)))):
            await client.fetch(loadgen.Record(s, q, time.perf_counter()))
        for rate in rates:
            traffic = dict(cell.traffic, rate=rate)
            await loadgen.drive(client, traffic, names, seed + 1,
                                runner.WARMUP_S, time.perf_counter())
            recs = await loadgen.drive(client, traffic, names, seed, seconds,
                                       time.perf_counter())
            client.bodies.clear()
            line = summary(rate, seconds, recs)
            lines.append(line)
            print(json.dumps(line), flush=True)
            if line["completed_per_s"] < 0.5 * rate:
                break
    k = knee(lines)
    print(json.dumps({"knee": k, "rate_at_0.8": 0.8 * k}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    cell = sweep_cell(args.config, args.traffic)
    if cell.traffic["loop"] != "open":
        print("the sweep is for open-loop traffic", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    work = runner.BUILD / cell.name
    corpus = work / "corpus"
    corpus.mkdir(parents=True, exist_ok=True)
    port = free_port()
    cfg = runner.server_config(cell, port, corpus, None, None)
    srv = Server(cli_argv(json.dumps(cfg)), cell_mod.REPO,
                 runner.server_env(work), work / "server.log", port,
                 cpus=split_cores()[1])
    srv.start()
    try:
        gen = cell.config["corpus"]
        names = sorted(cell_mod.load_module("sources", gen["generator"])
                       .generate(gen, args.seed, corpus, cell_mod.BENCH))
        srv.wait_ready(warmup=True)
        asyncio.run(sweep(cell, srv, names, args.seed, args.seconds,
                          [float(r) for r in args.rates.split(",")]))
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
