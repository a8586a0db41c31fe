"""The harness's tests run on the CPU: `python -m pytest bench_torch/tests`.
They import the harness from bench_torch/ as run.py does."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
