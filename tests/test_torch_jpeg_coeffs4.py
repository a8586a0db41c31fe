"""The port's 4-component entropy reader (`read_jpeg_coeffs4`,
csrc/jpeg_coeffs.cpp) against libjpeg's (the JAX package's
native_codecs.read_jpeg_coeffs4) on CMYK and YCCK streams.

Every corpus stream gives array-equal dicts on both readers (same keys,
dtypes and values), or None on both for a layout they refuse. The cut
and corrupted streams run in a subprocess, so that a crash in native
code fails one test instead of taking down the worker that runs it.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from fanlin_tpu.engine import native_codecs
from fanlin_tpu_torch.engine.jpeg_coeffs import (read_jpeg_coeffs,
                                                 read_jpeg_coeffs4)
from tests.conftest import make_test_image
from tests.test_torch_icc import adobe_ycck, cmyk_jpeg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
needs_native = pytest.mark.skipif(not native_codecs.available(),
                                  reason="native codec core not built")


def _cmyk(w, h, seed=0, **kw):
    buf = io.BytesIO()
    Image.fromarray(make_test_image(w, h, seed=seed)).convert("CMYK").save(
        buf, format="JPEG", **kw)
    return buf.getvalue()


def _native_ycck420(w, h, seed=0):
    """A YCCK 4:2:0 stream (libjpeg's YCCK default: comp0 and K 2x2)
    written by the native core, or None without it."""
    arr = np.asarray(Image.open(io.BytesIO(_cmyk(w, h, seed, quality=95))))
    return native_codecs.encode_jpeg_cmyk(255 - arr, 90, True)


def _with_restarts(data: bytes, interval: int) -> bytes:
    """The stream re-encoded by PIL with a restart interval (in MCUs)."""
    im = Image.open(io.BytesIO(data))
    buf = io.BytesIO()
    im.save(buf, format="JPEG", quality=90, restart_marker_blocks=interval)
    return buf.getvalue()


def _corpus():
    cmyk = {f"cmyk_q{q}": _cmyk(120, 88, quality=q) for q in (50, 90, 100)}
    cmyk["ycck444"] = adobe_ycck(cmyk["cmyk_q90"])
    cmyk["progressive"] = _cmyk(120, 88, seed=2, quality=85,
                                progressive=True)
    cmyk["progressive_ycck"] = adobe_ycck(cmyk["progressive"])
    cmyk["restart"] = _with_restarts(cmyk["cmyk_q90"], 3)
    cmyk["odd_7x5"] = _cmyk(7, 5, seed=3, quality=90)
    cmyk["odd_641x479"] = _cmyk(641, 479, seed=4, quality=80)
    cmyk["embedded_icc"] = cmyk_jpeg(64, 48, icc=b"\x00" * 200)
    # the Adobe transform byte other than 0 and 2: libjpeg assumes YCCK
    bad = bytearray(cmyk["cmyk_q50"])
    bad[bad.find(b"\xff\xee") + 15] = 7
    cmyk["adobe_transform_7"] = bytes(bad)
    return cmyk


CORPUS = sorted(_corpus())


def _assert_same(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w and type(g) is type(w), key


@needs_native
@pytest.mark.parametrize("name", CORPUS)
def test_reader_matches_libjpeg(name):
    data = _corpus()[name]
    want = native_codecs.read_jpeg_coeffs4(data)
    got = read_jpeg_coeffs4(data)
    assert want is not None
    _assert_same(got, want)
    assert got["cmyk"] is True
    assert got["ycck"] == (name in ("ycck444", "progressive_ycck",
                                    "adobe_transform_7"))
    assert got["subsamp"] == 444
    # the 3-component reader still refuses a 4-component stream
    assert read_jpeg_coeffs(data) is None


@needs_native
@pytest.mark.parametrize("dims", [(120, 88), (7, 5), (641, 479)])
def test_reader_matches_libjpeg_ycck420(dims):
    data = _native_ycck420(*dims)
    want = native_codecs.read_jpeg_coeffs4(data)
    assert want is not None and want["subsamp"] == 420 and want["ycck"]
    _assert_same(read_jpeg_coeffs4(data), want)


@needs_native
def test_refused_layout_is_none_on_both():
    """PIL's CMYK with subsampling=2 (comp0 2x2, K 1x1: not comp0's
    rate) is refused by both readers."""
    data = _cmyk(120, 88, quality=90, subsampling=2)
    assert native_codecs.read_jpeg_coeffs4(data) is None
    assert read_jpeg_coeffs4(data) is None


@pytest.mark.parametrize("kind", ["rgb", "gray", "garbage", "empty"])
def test_reader_refuses_other_streams(kind):
    buf = io.BytesIO()
    img = Image.fromarray(make_test_image(40, 30))
    if kind == "gray":
        img = img.convert("L")
    img.save(buf, format="JPEG")
    data = {"rgb": buf.getvalue(), "gray": buf.getvalue(),
            "garbage": b"\xff\xd8" + bytes(range(256)), "empty": b""}[kind]
    assert read_jpeg_coeffs4(data) is None
    if native_codecs.available():
        assert native_codecs.read_jpeg_coeffs4(data) is None


def test_plain_cmyk_meta_shapes():
    meta = read_jpeg_coeffs4(_cmyk(641, 479, quality=80))
    assert (meta["w"], meta["h"], meta["subsamp"]) == (641, 479, 444)
    for key in ("y", "cb", "cr", "k"):
        assert meta[key].shape == (60, 81, 64) and meta[key].dtype == np.int16
    assert meta["lq"].dtype == np.uint16 and meta["lq"].shape == (64,)


def test_alloc_gate_refuses_huge_headers():
    """A SOF of 30000 x 30000 (four planes over 512 MiB) is refused
    before any allocation, on both readers."""
    data = bytearray(_cmyk(16, 16, quality=90))
    i = data.find(b"\xff\xc0")
    data[i + 5:i + 9] = (30000).to_bytes(2, "big") * 2
    assert read_jpeg_coeffs4(bytes(data)) is None
    if native_codecs.available():
        assert native_codecs.read_jpeg_coeffs4(bytes(data)) is None


_FUZZ = r"""
import io, sys
import numpy as np
from PIL import Image
sys.path.insert(0, {root!r})
from fanlin_tpu_torch.engine.jpeg_coeffs import read_jpeg_coeffs4
from tests.conftest import make_test_image
rng = np.random.default_rng({seed})
buf = io.BytesIO()
Image.fromarray(make_test_image(48, 40, seed={seed})).convert("CMYK").save(
    buf, format="JPEG", quality=90, progressive={progressive})
base = bytearray(buf.getvalue())
if {ycck}:
    base[base.find(b"\xff\xee") + 15] = 2
dicts = nones = 0
for i in range({n}):
    data = bytearray(base)
    if i % 2:
        data = data[: int(rng.integers(2, len(data)))]
    else:
        for _ in range(int(rng.integers(1, 6))):
            data[int(rng.integers(2, len(data)))] = int(rng.integers(0, 256))
    meta = read_jpeg_coeffs4(bytes(data))
    if meta is None:
        nones += 1
        continue
    assert meta["cmyk"] and meta["subsamp"] in (444, 420)
    for key in ("y", "cb", "cr", "k"):
        assert meta[key].dtype == np.int16 and meta[key].shape[2] == 64
    dicts += 1
print(dicts, nones)
"""


@pytest.mark.parametrize("ycck", [False, True])
@pytest.mark.parametrize("progressive", [False, True])
def test_cut_and_corrupt_streams_in_subprocess(progressive, ycck):
    """300 seeded truncations and byte flips of a CMYK or YCCK stream,
    baseline or progressive: each returns a dict or None, and the reader
    never crashes (run in a subprocess)."""
    n = 300
    code = _FUZZ.format(root=ROOT, seed=17 + 2 * progressive + ycck,
                        progressive=progressive, ycck=ycck, n=n)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    dicts, nones = map(int, proc.stdout.split())
    assert dicts + nones == n and dicts > 0
