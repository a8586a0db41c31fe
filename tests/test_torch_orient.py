"""EXIF orientation on the coefficient path: the port's
`jpeg_decode.orient_meta` against the JAX package's, the Engine's
routing, and the pre-encode output of rotated coefficient batches.

Tolerances: orient_meta is array-equal to the JAX one (and None where
that one is None). A rotated coefficient batch equals the JAX
package's coefficient route (its orient_meta + CoefBatchAssembly) array
for array. Against the port's pixel path (decode, rotate the pixels,
transform) it is within 1 LSB at a downscale: libjpeg's islow rounding
and the fancy upsample's +1/+2 are not symmetric under a flip, so the
rotated decode itself differs from the decoded-then-rotated pixels by
up to 3 LSB at source size, and the resample averages that out.
"""

import copy
import io

import numpy as np
import pytest
import torch
from PIL import Image

from fanlin_tpu.engine import native_codecs
from fanlin_tpu.ops import fused as jfused
from fanlin_tpu.ops import jpeg_decode as jjd
from fanlin_tpu.spec.content import Format
from fanlin_tpu.spec.query import parse_query
from fanlin_tpu_torch.engine import Engine, codecs
from fanlin_tpu_torch.engine.jpeg_coeffs import read_jpeg_coeffs
from fanlin_tpu_torch.ops import fused as tfused
from fanlin_tpu_torch.ops import jpeg_decode as tjd
from fanlin_tpu_torch.ops import plan as tplan
from tests.conftest import make_test_image

CPU = torch.device("cpu")
KIND = {420: "coef", 422: "coef422", 440: "coef440", 444: "coef444"}
ORIENTATIONS = list(range(1, 9))
# (layout, dims): MCU-aligned dims and dims with partial edge MCUs
LAYOUTS = ["420", "422", "440", "444", "gray"]
DIMS = {"aligned": (64, 48), "unaligned": (61, 37)}

needs_native = pytest.mark.skipif(
    not native_codecs.available(), reason="native codec core not built")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jpeg(layout: str, w: int, h: int, orientation: int = 1) -> bytes:
    """A JPEG of a seeded image; PIL writes every layout but 4:4:0 (the
    native encoder's, without EXIF)."""
    img = make_test_image(w, h, seed=w * h)
    if layout == "440":
        assert orientation == 1
        return native_codecs.encode_jpeg_subsamp(img, 90, 1, 2)
    kw = {"quality": 90}
    if layout == "gray":
        img = np.asarray(Image.fromarray(img).convert("L"))
    else:
        kw["subsampling"] = {"444": 0, "422": 1, "420": 2}[layout]
    if orientation != 1:
        exif = Image.Exif()
        exif[0x0112] = orientation
        kw["exif"] = exif
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _same_meta(got: dict, want: dict) -> None:
    for key in ("y", "cb", "cr", "lq", "cq", "w", "h", "subsamp", "gray"):
        g, w = got[key], want[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key


@needs_native
@pytest.mark.parametrize("dims", list(DIMS))
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("orientation", ORIENTATIONS)
def test_orient_meta_matches_jax(orientation, layout, dims):
    meta = native_codecs.read_jpeg_coeffs(_jpeg(layout, *DIMS[dims]))
    before = copy.deepcopy(meta)
    want = jjd.orient_meta(copy.deepcopy(meta), orientation)
    got = tjd.orient_meta(meta, orientation)
    assert (got is None) == (want is None)
    if got is not None:
        _same_meta(got, want)
    _same_meta(meta, before)  # the input is never mutated
    if layout == "420" and dims == "aligned":
        assert got is not None  # every orientation is grid-exact here


def _jax_route_takes_coefficients(data: bytes, orientation: int) -> bool:
    """The JAX Engine's coefficient rule (processor.py:287-306): the
    reader's dict, rotated by its orient_meta, is not None."""
    meta = native_codecs.read_jpeg_coeffs(data)
    return meta is not None and (
        orientation == 1 or jjd.orient_meta(meta, orientation) is not None)


@needs_native
@pytest.mark.parametrize("dims", list(DIMS))
@pytest.mark.parametrize("orientation", ORIENTATIONS)
def test_engine_counts_coef_src_where_jax_takes_coefficients(orientation,
                                                            dims):
    data = _jpeg("420", *DIMS[dims], orientation)
    assert codecs.read_orientation(data) == orientation
    engine = Engine(CPU)
    mime, payload = engine.process_image(data, parse_query("w=30&h=20"),
                                         Format())
    coef = _jax_route_takes_coefficients(data, orientation)
    assert engine.stats == {"coef_src": int(coef), "pixel_src": int(not coef)}
    assert mime == "image/jpeg"
    with Image.open(io.BytesIO(payload)) as im:
        assert im.size[0] <= 30 and im.size[1] <= 20


def _close(a, b, max_lsb=1):
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    assert a.shape == b.shape and int(d.max()) <= max_lsb, int(d.max())


@needs_native
@pytest.mark.parametrize("layout,orientation", [
    ("420", o) for o in ORIENTATIONS] + [
    ("422", 5), ("422", 6), ("444", 7), ("gray", 8)])
def test_rotated_coef_batch_matches_jax_and_pixel_path(layout, orientation):
    w, h = DIMS["aligned"]
    data = _jpeg(layout, w, h)
    q = parse_query("w=30&h=20")
    jmeta = jjd.orient_meta(native_codecs.read_jpeg_coeffs(data), orientation)
    tmeta = tjd.orient_meta(read_jpeg_coeffs(data), orientation)
    assert tmeta["subsamp"] == jmeta["subsamp"]
    tp = tplan.plan_image(tmeta["w"], tmeta["h"], q, opaque=True)
    got = tfused.make_assembly([tp], [tmeta], [KIND[tmeta["subsamp"]]],
                               CPU).run()[0]
    jp = jfused.plan_image(jmeta["w"], jmeta["h"], q, opaque=True)
    want = jfused.CoefBatchAssembly([jp], [jmeta]).run()[0]
    np.testing.assert_array_equal(got, want)
    img, _, _ = codecs.decode(data)
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    pixel = tfused.BatchAssembly(
        [tp], [np.ascontiguousarray(codecs.apply_orientation(img, orientation))],
        CPU).run()[0]
    _close(got, pixel)


def test_transpose_swaps_422_and_440():
    meta = read_jpeg_coeffs(_jpeg("422", 64, 48))
    assert meta["subsamp"] == 422
    t = tjd.orient_meta(meta, 6)
    assert t["subsamp"] == 440 and (t["w"], t["h"]) == (48, 64)
    assert tjd.orient_meta(t, 8)["subsamp"] == 422

