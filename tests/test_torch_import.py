"""Every module of the PyTorch port imports without jax."""

import os
import pkgutil
import subprocess
import sys

import fanlin_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    names = [fanlin_tpu_torch.__name__]
    for info in pkgutil.walk_packages(fanlin_tpu_torch.__path__,
                                      fanlin_tpu_torch.__name__ + "."):
        if not info.name.endswith("__main__"):
            names.append(info.name)
    return names


def test_port_modules_listed():
    names = _port_modules()
    for expected in ("fanlin_tpu_torch.device", "fanlin_tpu_torch.ops.plan",
                     "fanlin_tpu_torch.ops.chain",
                     "fanlin_tpu_torch.ops.resample_kernels",
                     "fanlin_tpu_torch.ops.fused",
                     "fanlin_tpu_torch.ops.jpeg_decode",
                     "fanlin_tpu_torch.ops.jpeg_decode_kernels",
                     "fanlin_tpu_torch.engine.jpeg_coeffs",
                     "fanlin_tpu_torch.engine.processor",
                     "fanlin_tpu_torch.server.app", "fanlin_tpu_torch.cli"):
        assert expected in names


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
