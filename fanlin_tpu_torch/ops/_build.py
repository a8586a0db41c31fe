"""Build and load the port's CUDA kernels (plain C interface, ctypes).

`load()` compiles `fanlin_tpu_torch/csrc/*.cu` with nvcc for sm_90a
into `build/kernels/` at the repository root, keyed by a hash of the
sources and flags, and loads the shared library with ctypes. It runs
at first use, never at import: the CPU test suite imports every module
on a machine without nvcc. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# The resample kernel's tiles: output rows and columns per block, and
# the depth of a K slice. Compiled in below; ops/resample_kernels.py
# computes the band ranges for them.
TILE_M, TILE_N, K_SLICE = 64, 32, 32

# No --use_fast_math: the split-TF32 residual x - tf32(x) and the
# rounding epilogue need IEEE f32 (no flush to zero).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              f"-DFANLIN_TILE_M={TILE_M}", f"-DFANLIN_TILE_N={TILE_N}",
              f"-DFANLIN_K_SLICE={K_SLICE}")

_LOCK = threading.Lock()
_LIB = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def build() -> Path:
    """Compile the kernel library if this exact source is not built
    yet; returns its path."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib = BUILD_DIR / f"libfanlin_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            fn = lib.fanlin_resample_uniform
            fn.argtypes = [p] * 13 + [i] * 10 + [p]
            fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB
