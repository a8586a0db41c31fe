#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (fanlin_tpu_torch): one run
of one cell of BENCHMARK.json.

    python3 bench_torch/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. It starts the port's HTTP server
(`python -m fanlin_tpu_torch.cli`) on the one card, makes the cell's
corpus from the seed, waits until the server and the cell's shapes are
warm, drives the cell's traffic for S seconds, checks every answer
against the plain reference once the server has stopped, and prints
one JSON line: the end-to-end metrics with `--trace 0`, the per-layer
metrics (read from a device trace captured in the window's middle)
with `--trace 1`. Runtime files go to build/bench_torch/.

`--control fast` serves with the port's bf16 resample products
(`tpu.fast`), the lower precision the check has to refuse; the
benchmark's own runs never pass it.

Exits non-zero, printing no result, without a CUDA device (or fewer
than the cell asks for: the server it started meanwhile is stopped),
or without the port's package beside it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import cell as cell_mod  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fast",), default=None)
    args = ap.parse_args(argv)

    if not (cell_mod.REPO / "fanlin_tpu_torch" / "cli.py").is_file():
        print("no fanlin_tpu_torch package in this checkout", file=sys.stderr)
        return 3
    cell = cell_mod.load_cell(args.workload)
    from harness import runner

    def look_for_card():
        import torch

        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < cell.chips:
            return (f"the cell needs {cell.chips} CUDA device(s); {n} "
                    "visible: no number without the card")
        return None

    try:
        out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              T_START, control=args.control,
                              look_for_card=look_for_card)
    except runner.NoCard as e:
        print(e, file=sys.stderr)
        return 2
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
