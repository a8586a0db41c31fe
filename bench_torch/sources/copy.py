"""A corpus of files kept in the benchmark (`files`: paths under
bench_torch/, served under the names in `names`); the seed changes
nothing."""

import shutil
from pathlib import Path


def generate(params: dict, seed: int, out_dir: Path, bench: Path) -> dict:
    out = {}
    for rel, name in zip(params["files"], params["names"]):
        shutil.copyfile(bench / rel, out_dir / name)
        out[name] = out_dir / name
    return out
