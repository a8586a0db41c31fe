"""Every module of the PyTorch port imports without jax and without the
JAX package (fanlin_tpu), and no source of the port names it in an
import."""

import ast
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
                     "fanlin_tpu_torch.server.app", "fanlin_tpu_torch.cli",
                     "fanlin_tpu_torch.config", "fanlin_tpu_torch.spec.query",
                     "fanlin_tpu_torch.spec.content",
                     "fanlin_tpu_torch.infra", "fanlin_tpu_torch.utils.paths",
                     "fanlin_tpu_torch.utils.bytelru",
                     "fanlin_tpu_torch.ops.filters",
                     "fanlin_tpu_torch.server.router",
                     "fanlin_tpu_torch.server.timing"):
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


def test_port_imports_no_jax_package():
    """After importing every port module in a fresh process, nothing of
    fanlin_tpu is loaded."""
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'fanlin_tpu' or m.startswith('fanlin_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _sources():
    pkg = os.path.join(ROOT, "fanlin_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_modules(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_imports_the_jax_package():
    """An AST scan of fanlin_tpu_torch/**/*.py and chip_smoke.py: no
    `import fanlin_tpu...` or `from fanlin_tpu... import`, at any depth
    (function bodies included)."""
    sources = list(_sources())
    assert len(sources) > 30
    bad = [(os.path.relpath(p, ROOT), m) for p in sources
           for m in _imported_modules(p)
           if m == "fanlin_tpu" or m.startswith("fanlin_tpu.")
           or m.split(".")[0] in ("jax", "jaxlib")]
    assert not bad, bad
