"""Build and load the port's native code (plain C interface, ctypes).

Two libraries, each built into `build/kernels/` at the repository
root, keyed by a hash of its sources and flags, and loaded with ctypes:

* `load()`: the CUDA kernels, `fanlin_tpu_torch/csrc/*.cu`, compiled
  with nvcc for sm_90a;
* `load_host()`: host code, `csrc/*.cpp` (the JPEG entropy reader),
  compiled with the host C++ compiler; it needs no CUDA and no
  libjpeg, so it builds wherever a `c++` does.

Both run at first use, never at import: the CPU test suite imports
every module on a machine without nvcc. A failed build raises; nothing
falls back.
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
              "-O3", "-Xcompiler", "-fPIC",
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


def _run(cmd) -> None:
    """Wait for a started build step; raise with its output if it
    failed. `cmd` is (argv, Popen)."""
    argv, proc = cmd
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"build failed ({proc.returncode}): {' '.join(argv)}\n{out}")


def _start(argv):
    return argv, subprocess.Popen(argv, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)


def _target(name: str, pattern: str, flags) -> tuple:
    """(sources, library path): the library's name carries a hash of
    the sources matching `pattern` and of the flags."""
    sources = sorted(CSRC.glob(pattern))
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return sources, BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library if this exact source is not built
    yet; returns its path. Each source compiles in its own nvcc
    process, all started together; one more links them."""
    sources, lib = _target("fanlin_kernels", "*.cu", NVCC_FLAGS)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    jobs = [_start([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
            for src, obj in zip(sources, objs)]
    for job in jobs:
        _run(job)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    _run(_start([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                 "-o", str(tmp), *map(str, objs)]))
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib)
    return lib


HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-Wextra")

_HOST_LOCK = threading.Lock()
_HOST_LIB = None


def _cxx() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++): cannot build the "
                       "host JPEG reader")


def build_host() -> Path:
    """Compile `csrc/*.cpp` (host code, no CUDA) with the host compiler
    into `build/kernels/`, keyed by a hash of the sources and flags;
    returns the library's path."""
    sources, lib = _target("fanlin_host", "*.cpp", HOST_FLAGS)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    _run(_start([_cxx(), *HOST_FLAGS, "-o", str(tmp), *map(str, sources)]))
    os.replace(tmp, lib)
    return lib


def load_host() -> ctypes.CDLL:
    """The built host library (the JPEG entropy reader) with its C
    signatures declared."""
    global _HOST_LIB
    with _HOST_LOCK:
        if _HOST_LIB is None:
            lib = ctypes.CDLL(str(build_host()))
            p = ctypes.c_void_p
            fn = lib.fanlin_read_jpeg_coeffs
            fn.argtypes = [p, ctypes.c_size_t, p, p, p]
            fn.restype = ctypes.c_int
            lib.fanlin_free.argtypes = [p]
            lib.fanlin_free.restype = None
            _HOST_LIB = lib
        return _HOST_LIB


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
            fn = lib.fanlin_jpeg_islow
            fn.argtypes = [p] * 7 + [i] * 5 + [p]
            fn.restype = ctypes.c_int
            fn = lib.fanlin_jpeg_upsample_rgb
            fn.argtypes = [p] * 4 + [i] * 10 + [p]
            fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB
