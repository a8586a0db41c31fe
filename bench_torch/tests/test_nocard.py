"""No card, no number: without a CUDA device, and in a checkout that
holds only the benchmark, run.py exits non-zero and prints no result."""

import shutil
import subprocess
import sys

import pytest
import torch

from harness import cell

ARGS = ["--workload", "readme-jpeg-serial", "--seed", "2147483999",
        "--seconds", "1", "--trace", "0"]


def test_no_cuda_device_fails_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")
    p = subprocess.run([sys.executable, "bench_torch/run.py", *ARGS],
                       cwd=cell.REPO, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_benchmark_alone_fails_without_a_result(tmp_path):
    shutil.copy(cell.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(cell.BENCH, tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "bench_torch/run.py", *ARGS],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
