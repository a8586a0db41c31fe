"""A cell and the files it is made of, found by name: BENCHMARK.json's
workload names a configuration (configs/<name>.json) and a traffic mix
(traffic/<name>.json); the configuration names its corpus generator
(sources/<name>.py); each metric is read by a module of its own
(end_to_end/<name>.py, metrics/<name>.py), and a roofline by the work
function of its kernel (work/<kernel>.py)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
_MODULES: Dict[Path, object] = {}


def load_json(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """bench_torch/<kind>/<name>.py, imported once."""
    path = BENCH / kind / f"{name}.py"
    if path not in _MODULES:
        spec = importlib.util.spec_from_file_location(
            "bench_torch_" + kind + "_" + re.sub(r"\W", "_", name), path)
        if spec is None or not path.is_file():
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @classmethod
    def from_parts(cls, name: str, config_name: str, traffic_name: str,
                   config: dict, traffic: dict, end_to_end=(), per_layer=(),
                   chips: int = 1) -> "Cell":
        return cls(name, chips, config_name, traffic_name, config, traffic,
                   [m for m in end_to_end if _applies(m, name)],
                   [m for m in per_layer if _applies(m, name)])


def load_cell(workload: str, benchmark: Path = REPO / "BENCHMARK.json") -> Cell:
    with open(benchmark) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {benchmark}")
    w = cells[workload]
    return Cell.from_parts(workload, w["config"], w["traffic"],
                           load_json("configs", w["config"]),
                           load_json("traffic", w["traffic"]),
                           bench["end_to_end"], bench["per_layer"],
                           int(w["chips"]))
