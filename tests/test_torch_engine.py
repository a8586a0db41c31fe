"""The port's Engine (fanlin_tpu_torch.engine) against the JAX package's
Engine on the pixel-source path (device_decode=False on both), on the
CPU; tests/test_torch_coef.py covers the coefficient path.

For every golden source x golden case: the same mime type, decoded
output pixels within 1 LSB of the reference's (the float resample may
flip a .5 boundary; with identical pixels the encoders are
deterministic), and the golden floors of tests/test_golden_parity.py
(>= 50 dB pre-encode, >= 45 dB encoded).
"""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from fanlin_tpu.engine import Engine as JaxEngine
from fanlin_tpu.spec import content as jcontent
from fanlin_tpu.spec.query import parse_query as jparse_query
from fanlin_tpu_torch.engine import Engine, ProcessError, codecs
from fanlin_tpu_torch.ops import fused as tfused
from fanlin_tpu_torch.ops import plan as tplan
from fanlin_tpu_torch.ops import resample_kernels as rk
from fanlin_tpu_torch.spec.content import Format, extract_accepted_image_formats
from fanlin_tpu_torch.spec.query import parse_query
from tests.conftest import make_test_image, psnr
from tests.test_golden_parity import CASES

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engines():
    return Engine(CPU, device_decode=False), JaxEngine(device_decode=False)


def _src(name):
    with open(os.path.join(GOLDEN, f"{name}_src.jpg"), "rb") as f:
        return f.read()


def _decode(payload):
    with Image.open(io.BytesIO(payload)) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)


def _max_lsb(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@pytest.mark.parametrize("cfg,qs", CASES)
@pytest.mark.parametrize("src_name", ["synth", "lenna"])
def test_engine_matches_reference_and_golden(engines, src_name, cfg, qs):
    port, ref = engines
    data = _src(src_name)
    q = parse_query(qs)
    mime, payload = port.process_image(data, q, Format())
    ref_mime, ref_payload = ref.process_image(data, jparse_query(qs),
                                              jcontent.Format())
    assert mime == ref_mime == "image/jpeg"
    got = _decode(payload)
    assert _max_lsb(got, _decode(ref_payload)) <= 1

    with Image.open(os.path.join(GOLDEN, f"{src_name}_{cfg}.jpg")) as im:
        golden_enc = np.asarray(im.convert("RGB"), dtype=np.uint8)
    assert psnr(got[..., :3], golden_enc) >= 45.0
    with Image.open(os.path.join(GOLDEN, f"{src_name}_{cfg}.png")) as im:
        golden_px = np.asarray(im.convert("RGB"), dtype=np.uint8)
    img, has_alpha, _ = codecs.decode(data)
    plan = tplan.plan_image(img.shape[1], img.shape[0], q, opaque=not has_alpha)
    out = tfused.BatchAssembly([plan], [img], CPU).run()[0]
    assert psnr(out[:, :, :3], golden_px) >= 50.0


@pytest.mark.parametrize("qs,accept,mime", [
    ("w=300&h=200&webp=true&quality=20", ["image/webp"], "image/webp"),
    ("w=120&h=90&blur=2", [], "image/jpeg"),
    ("w=64&h=64&crop=true&grayscale=true", [], "image/jpeg"),
])
def test_engine_output_formats(engines, qs, accept, mime):
    port, ref = engines
    data = _src("lenna")
    got_mime, got = port.process_image(
        data, parse_query(qs), extract_accepted_image_formats(accept))
    ref_mime, want = ref.process_image(
        data, jparse_query(qs), jcontent.extract_accepted_image_formats(accept))
    assert got_mime == ref_mime == mime
    assert _max_lsb(_decode(got), _decode(want)) <= 1


@pytest.mark.parametrize("qs", ["w=40&h=30", "w=50&h=50&rgb=1,2,3",
                                "grayscale=true"])
def test_engine_png_rgba_source(engines, qs):
    """An alpha source (torch chain, PNG sink) round-trips like the
    reference's."""
    port, ref = engines
    rng = np.random.default_rng(5)
    rgba = np.dstack([make_test_image(64, 48, seed=5),
                      rng.integers(0, 256, (48, 64), dtype=np.uint8)])
    buf = io.BytesIO()
    Image.fromarray(rgba, "RGBA").save(buf, format="PNG")
    data = buf.getvalue()
    got_mime, got = port.process_image(data, parse_query(qs), Format())
    ref_mime, want = ref.process_image(data, jparse_query(qs),
                                       jcontent.Format())
    assert got_mime == ref_mime == "image/png"
    assert _max_lsb(_decode(got), _decode(want)) <= 1


def test_engine_gif(engines):
    port, ref = engines
    frames = [Image.fromarray(make_test_image(40, 32, seed=s)) for s in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, format="GIF", save_all=True, append_images=frames[1:],
                   duration=100, loop=0)
    got_mime, got = port.process_image(buf.getvalue(), parse_query("w=20&h=16"),
                                       Format())
    ref_mime, want = ref.process_image(buf.getvalue(),
                                       jparse_query("w=20&h=16"),
                                       jcontent.Format())
    assert got_mime == ref_mime == "image/gif"
    with Image.open(io.BytesIO(got)) as a, Image.open(io.BytesIO(want)) as b:
        assert a.n_frames == b.n_frames == 3
        assert a.size == b.size == (20, 16)


def test_engine_svg_and_unknown(engines):
    port, ref = engines
    svg = (b'<svg xmlns="http://www.w3.org/2000/svg" width="10" height="10">'
           b'<rect width="10" height="10"/></svg>')
    q = parse_query("w=5&h=5")
    assert port.process_image(svg, q, Format()) == ref.process_image(
        svg, jparse_query("w=5&h=5"), jcontent.Format()) == \
        ("image/svg+xml", svg)
    with pytest.raises(ProcessError):
        port.process_image(b"this is not an image\n", q, Format())


def test_engine_as_is_passthrough(engines):
    port, ref = engines
    data = _src("lenna")
    # no transform requested
    assert port.process_image(data, parse_query("quality=30"), Format()) == \
        ref.process_image(data, jparse_query("quality=30"),
                          jcontent.Format()) == ("image/jpeg", data)


def test_engine_unported_decoders_raise(engines):
    port, _ = engines
    q = parse_query("w=10&h=10")
    for data in (b"\x76\x2f\x31\x01" + bytes(64), b"qoif" + bytes(64),
                 b"P6\n2 2\n65535\n" + bytes(24)):
        with pytest.raises(ProcessError, match="not yet ported"):
            port.process_image(data, q, Format())


def test_engine_counts_and_never_launches_on_cpu(engines):
    port, _ = engines
    rk.reset_launch_counts()
    n = port.stats["pixel_src"]
    port.process_image(_src("synth"), parse_query("w=30&h=20"), Format())
    assert port.stats["pixel_src"] == n + 1
    assert rk.launch_counts() == {"resample": 0, "resample_blur": 0}


def test_engine_serves_coefficient_path_and_rejects_device_dct():
    """device_decode (the default) serves a JPEG through the coefficient
    path, with the pixel engine's bytes; the device DCT sink is not in
    the port yet."""
    coef = Engine(CPU)
    assert coef.device_decode
    q = parse_query("w=30&h=20")
    assert coef.process_image(_src("synth"), q, Format()) == \
        Engine(CPU, device_decode=False).process_image(_src("synth"), q,
                                                       Format())
    assert coef.stats == {"pixel_src": 0, "coef_src": 1}
    with pytest.raises(NotImplementedError):
        Engine(CPU, device_dct=True)
