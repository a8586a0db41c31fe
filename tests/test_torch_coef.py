"""The port's coefficient path on the CPU: `CoefBatchAssembly` (the
decode kernels' plain versions, then the pixel path's chain) against the JAX
package's CoefBatchAssembly, against the port's own pixel path, and the
Engine's routing.

Tolerances: against the JAX package, at most 1 LSB anywhere and at
most 0.5 % of bytes differing (the float resample sums in another
order). Against the port's pixel path, none: the decode is bit-exact
with libjpeg's, so the chain sees the same bytes.
"""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from fanlin_tpu.engine import native_codecs
from fanlin_tpu.ops import fused as jfused
from fanlin_tpu.spec.content import Format
from fanlin_tpu.spec.query import parse_query
from fanlin_tpu_torch.engine import Engine, codecs
from fanlin_tpu_torch.engine.jpeg_coeffs import read_jpeg_coeffs
from fanlin_tpu_torch.ops import fused as tfused
from fanlin_tpu_torch.ops import jpeg_decode_kernels as jk
from fanlin_tpu_torch.ops import plan as tplan
from fanlin_tpu_torch.ops import resample_kernels as rk
from tests.conftest import make_test_image

CPU = torch.device("cpu")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
QUERIES = ["w=300&h=200", "w=100&h=100&crop=true",
           "w=300&h=200&grayscale=true", "w=300&h=200&rgb=32,32,32",
           "w=100&h=80&blur=1"]
KIND = {420: "coef", 422: "coef422", 440: "coef440", 444: "coef444"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _golden(name):
    with open(os.path.join(GOLDEN, f"{name}_src.jpg"), "rb") as f:
        return f.read()


def _jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _sources():
    gray = np.asarray(Image.fromarray(make_test_image(101, 83)).convert("L"))
    return {
        "lenna": _golden("lenna"),
        "synth": _golden("synth"),
        "pil422": _jpeg(make_test_image(101, 83, seed=3), quality=85,
                        subsampling=1),
        "gray": _jpeg(gray, quality=90),
        "tiny420": _jpeg(make_test_image(7, 5, seed=4), quality=90,
                         subsampling=2),
    }


def _close(a, b, max_lsb=1, max_frac=0.005):
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a - b)
    assert int(d.max()) <= max_lsb
    assert float((d > 0).mean()) <= max_frac


def _run(meta, qs, kind_sink=""):
    plan = tplan.plan_image(meta["w"], meta["h"], parse_query(qs), opaque=True)
    kind = KIND[meta["subsamp"]] + kind_sink
    return tfused.make_assembly([plan], [meta], [kind], CPU).run()[0]


@pytest.mark.skipif(not native_codecs.available(),
                    reason="native codec core not built")
@pytest.mark.parametrize("qs", QUERIES)
@pytest.mark.parametrize("name", ["lenna", "synth"])
def test_coef_assembly_matches_jax(name, qs):
    data = _golden(name)
    meta = native_codecs.read_jpeg_coeffs(data)  # the JAX package's dict
    jplan = jfused.plan_image(meta["w"], meta["h"], parse_query(qs),
                              opaque=True)
    want = jfused.CoefBatchAssembly([jplan], [meta]).run()[0]
    _close(_run(meta, qs), want)


@pytest.mark.parametrize("qs", ["w=300&h=200", "w=64&h=48&blur=2",
                                "w=40&h=40&crop=true&inverse=true", ""])
@pytest.mark.parametrize("name", ["lenna", "synth", "pil422", "gray",
                                  "tiny420"])
def test_coef_output_equals_pixel_output(name, qs):
    data = _sources()[name]
    meta = read_jpeg_coeffs(data)
    img, has_alpha, _ = codecs.decode(data)
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    assert not has_alpha and img.shape[:2] == (meta["h"], meta["w"])
    plan = tplan.plan_image(meta["w"], meta["h"], parse_query(qs), opaque=True)
    pixel = tfused.BatchAssembly([plan], [img], CPU).run()[0]
    np.testing.assert_array_equal(_run(meta, qs), pixel)


def test_native_440_coef_output_equals_pixel_output():
    data = native_codecs.encode_jpeg_subsamp(make_test_image(101, 83), 85,
                                             1, 2)
    if data is None:
        pytest.skip("native codec core not built")
    meta = read_jpeg_coeffs(data)
    assert meta["subsamp"] == 440
    img, _, _ = codecs.decode(data)
    plan = tplan.plan_image(101, 83, parse_query("w=50&h=40"), opaque=True)
    pixel = tfused.BatchAssembly([plan], [img], CPU).run()[0]
    np.testing.assert_array_equal(_run(meta, "w=50&h=40"), pixel)


@pytest.mark.parametrize("sink", ["+png:3", "+webp420", "+jpeg420"])
def test_coef_sinks_equal_pixel_sinks(sink):
    data = _golden("synth")
    meta = read_jpeg_coeffs(data)
    img, _, _ = codecs.decode(data)
    plan = tplan.plan_image(512, 512, parse_query("w=120&h=90"), opaque=True)
    got = _run(meta, "w=120&h=90", sink)
    want = tfused.make_assembly([plan], [img], [sink[1:]], CPU).run()[0]
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def test_coef_batch_of_two_and_nonuniform():
    """A uniform batch of two and a non-uniform batch (two plans) of the
    same source: each image equals its own pixel-path result."""
    data = _golden("synth")
    meta = read_jpeg_coeffs(data)
    img, _, _ = codecs.decode(data)
    p1 = tplan.plan_image(512, 512, parse_query("w=300&h=200"), opaque=True)
    p2 = tplan.plan_image(512, 512, parse_query("w=90&h=60&blur=1"),
                          opaque=True)
    for plans in ([p1, p1], [p1, p2]):
        asm = tfused.CoefBatchAssembly(plans, [meta, meta], CPU)
        assert asm.uses_kernel() == (plans[1] is p1)
        outs = asm.run()
        for p, o in zip(plans, outs):
            want = tfused.BatchAssembly([p], [img], CPU).run()[0]
            np.testing.assert_array_equal(o, want)


def test_coef_wire_is_padded_int16_blocks():
    meta = read_jpeg_coeffs(_golden("lenna"))  # 512 x 512, 4:4:4
    plan = tplan.plan_image(512, 512, parse_query("w=300&h=200"), opaque=True)
    asm = tfused.CoefBatchAssembly([plan], [meta], CPU)
    assert asm.coef.dtype == np.int16
    assert asm.upload_bytes == 3 * 512 * 512 * 2 + 2 * 64 * 4
    assert (asm.sh, asm.sw) == (tplan.bucket_h(512), tplan.bucket_w(512))


def test_coef_batch_refuses_mixed_geometry():
    a = read_jpeg_coeffs(_golden("lenna"))
    b = read_jpeg_coeffs(_golden("synth"))
    plan = tplan.plan_image(512, 512, parse_query("w=30&h=20"), opaque=True)
    with pytest.raises(ValueError, match="one source geometry"):
        tfused.CoefBatchAssembly([plan, plan], [a, b], CPU)


@pytest.mark.parametrize("kind", ["coef+jpegdct:75", "cmyk420", "jpegdct:75",
                                  "coef444+cmyk"])
def test_unported_coef_kinds_raise(kind):
    meta = read_jpeg_coeffs(_golden("lenna"))
    plan = tplan.plan_image(512, 512, parse_query("w=30&h=20"), opaque=True)
    with pytest.raises(NotImplementedError):
        tfused.make_assembly([plan], [meta], [kind], CPU)


def _oriented_jpeg(orientation):
    exif = Image.Exif()
    exif[0x0112] = orientation
    buf = io.BytesIO()
    Image.fromarray(make_test_image(64, 48)).save(buf, format="JPEG",
                                                   quality=90, exif=exif)
    return buf.getvalue()


def test_engine_counts_coef_src_and_matches_pixel_engine():
    coef, pixel = Engine(CPU), Engine(CPU, device_decode=False)
    rk.reset_launch_counts()
    jk.reset_launch_counts()
    for name, data in _sources().items():
        for qs in ("w=30&h=20", "w=40&h=40&crop=true&grayscale=true"):
            q = parse_query(qs)
            assert coef.process_image(data, q, Format()) == \
                pixel.process_image(data, q, Format()), (name, qs)
    assert coef.stats == {"pixel_src": 0, "coef_src": 10}
    assert pixel.stats == {"pixel_src": 10, "coef_src": 0}
    # the CPU runs the plain versions: no kernel launches
    assert not any(rk.launch_counts().values())
    assert not any(jk.launch_counts().values())


@pytest.mark.parametrize("orientation", [1, 6])
def test_engine_orientation_routes(orientation):
    """EXIF orientation 1 and 6 (64 x 48 4:2:0, MCU-aligned) both take
    the coefficient path; 6 rotates the coefficient grids. Orientation
    1 gives the pixel engine's bytes; 6 its geometry, within the
    transpose's rounding (tests/test_torch_orient.py holds it to 1 LSB
    before the encode)."""
    data = _oriented_jpeg(orientation)
    coef, pixel = Engine(CPU), Engine(CPU, device_decode=False)
    q = parse_query("w=30&h=20")
    got = coef.process_image(data, q, Format())
    want = pixel.process_image(data, q, Format())
    assert coef.stats == {"pixel_src": 0, "coef_src": 1}
    if orientation == 1:
        assert got == want
        return
    assert got[0] == want[0] == "image/jpeg"
    g, w = (np.asarray(Image.open(io.BytesIO(p)).convert("RGB"), np.float64)
            for _, p in (got, want))
    assert g.shape == w.shape == (20, 30, 3)
    assert 10 * np.log10(255.0 ** 2 / np.mean((g - w) ** 2)) >= 40.0


def test_engine_refused_jpeg_takes_pixel_path():
    """A JPEG the reader refuses (CMYK) is decoded on the host."""
    buf = io.BytesIO()
    Image.fromarray(make_test_image(64, 48)).convert("CMYK").save(
        buf, format="JPEG")
    engine = Engine(CPU)
    mime, _ = engine.process_image(buf.getvalue(), parse_query("w=30&h=20"),
                                   Format())
    assert mime == "image/jpeg"
    assert engine.stats == {"pixel_src": 1, "coef_src": 0}


def test_engine_progressive_takes_coef_path():
    """A progressive JPEG takes the coefficient path and gives the pixel
    engine's bytes."""
    data = _jpeg(make_test_image(101, 83, seed=9), quality=85,
                 subsampling=2, progressive=True)
    coef, pixel = Engine(CPU), Engine(CPU, device_decode=False)
    q = parse_query("w=50&h=40")
    assert coef.process_image(data, q, Format()) == \
        pixel.process_image(data, q, Format())
    assert coef.stats == {"pixel_src": 0, "coef_src": 1}
