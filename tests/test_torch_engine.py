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
from fanlin_tpu.engine import exr_codec as jexr
from fanlin_tpu.engine import extra_codecs as jextra
from fanlin_tpu.spec import content as jcontent
from fanlin_tpu.spec.query import parse_query as jparse_query
from fanlin_tpu_torch.engine import Engine, ProcessError, codecs
from fanlin_tpu_torch.engine.processor import SyncDeviceRunner
from fanlin_tpu_torch.ops import fused as tfused
from fanlin_tpu_torch.ops import plan as tplan
from fanlin_tpu_torch.ops import resample_kernels as rk
from fanlin_tpu_torch.spec.content import Format, extract_accepted_image_formats
from fanlin_tpu_torch.spec.query import parse_query
from tests.conftest import make_test_image, psnr
from tests.test_golden_parity import CASES
from tests.test_png16 import make_png16
from tests.test_tiff16 import make_tiff16

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


def _f1_sources():
    """One seeded source per format the port decodes outside PIL (and the
    16-bit PNG and TIFF layouts the reference hands to PIL), written with
    the JAX package's encoders and the 16-bit test writers."""
    rng = np.random.default_rng(61)
    img = make_test_image(48, 40, seed=61)
    rgba = np.dstack([img, rng.integers(0, 256, (40, 48), dtype=np.uint8)])
    a16 = rng.integers(0, 65536, (40, 48, 3), dtype=np.uint16)
    a16[0, 0] = 500  # the crate's round scaling gives 2 where PIL gives 1
    g16 = rng.integers(0, 65536, (40, 48, 1), dtype=np.uint16)
    f32 = rng.uniform(-0.2, 1.2, (40, 48, 3)).astype(np.float32)
    damaged = bytearray(make_png16(a16, 2))
    damaged[damaged.index(b"IDAT") + 6] ^= 0xFF  # CRC mismatch
    srcs = {
        "qoi_rgba": jextra.encode_qoi(rgba),
        "qoi_rgb": jextra.encode_qoi(img),
        "farbfeld": jextra.encode_farbfeld(rgba),
        "hdr": jextra.encode_hdr(img),
        "pam_rgba": jextra.encode_pam(rgba),
        "pam_gray_alpha": jextra.encode_pam(rgba, gray_alpha=True),
        "pnm16_rgb": b"P6\n48 40\n65535\n" + a16.astype(">u2").tobytes(),
        "pnm16_gray": b"P5\n48 40\n65535\n" + g16.astype(">u2").tobytes(),
        "png16_rgb": make_png16(a16, 2),
        "png16_rgba": make_png16(np.dstack([a16, g16]), 6),
        "png16_gray": make_png16(g16, 0),
        "png16_damaged": bytes(damaged),  # png16 refuses it; PIL too
        "tiff16_rgb_lzw": make_tiff16(a16, compression=5, rows_per_strip=4),
        "tiff_float_rgb": make_tiff16(f32),
        "tiff16_tiled_flag": make_tiff16(a16, extra_tags=[(322, 3, [8])]),
        "tiff16_gray": make_tiff16(g16),  # wide gray, through PIL (I;16)
        "tiff_float_gray": make_tiff16(f32[:, :, :1]),  # PIL mode F
        "exr_rgb_zip": jexr.encode_exr(img, compression=jexr._ZIP),
    }
    for name in sorted(os.listdir(os.path.join(GOLDEN, "exr"))):
        if name.endswith(".exr"):
            with open(os.path.join(GOLDEN, "exr", name), "rb") as f:
                srcs["exr_" + name[:-4]] = f.read()
    return srcs


F1_SOURCES = _f1_sources()


def _outcome(engine, data, q, accepted, error):
    try:
        return engine.process_image(data, q, accepted)
    except error as e:
        return ("error", type(e).__name__)


@pytest.mark.parametrize("qs", ["w=40&h=30", "w=24&h=24&crop=true&grayscale=true"])
@pytest.mark.parametrize("name", sorted(F1_SOURCES))
def test_engine_unported_decoders_raise(engines, name, qs):
    """Formerly refused by the port (500): every source the reference
    decodes outside PIL is now served with the reference's mime type and
    bytes (within the chain's 1 LSB where they differ), and what the
    reference refuses the port refuses too."""
    from fanlin_tpu.engine.processor import ProcessError as JaxProcessError

    data = F1_SOURCES[name]
    port = Engine(CPU, device_decode=False)
    got = _outcome(port, data, parse_query(qs), Format(), ProcessError)
    want = _outcome(JaxEngine(device_decode=False), data, jparse_query(qs),
                    jcontent.Format(), JaxProcessError)
    assert got[0] == want[0]
    if name == "png16_damaged":
        assert got == ("error", "ProcessError")
        return
    assert got[0] != "error" and port.stats["pixel_src"] == 1
    if got[1] != want[1]:
        # an alpha source runs the float torch chain, which may flip a .5
        # boundary (the 1 LSB budget); the decoders themselves are equal
        # (test_torch_host_modules.py)
        a, b = codecs.decode(got[1])[0], codecs.decode(want[1])[0]
        assert _max_lsb(a, b) <= 1


def test_engine_counts_and_never_launches_on_cpu(engines):
    port, _ = engines
    rk.reset_launch_counts()
    n = port.stats["pixel_src"]
    port.process_image(_src("synth"), parse_query("w=30&h=20"), Format())
    assert port.stats["pixel_src"] == n + 1
    assert rk.launch_counts() == {"resample": 0, "resample_blur": 0,
                                 "resample_fast": 0, "resample_blur_fast": 0}


def test_engine_serves_coefficient_path_and_device_dct():
    """device_decode (the default) serves a JPEG through the coefficient
    path, with the pixel engine's bytes; with device_dct the JPEG leaves
    through the jpegdct sink, on either source path, with equal bytes."""
    coef = Engine(CPU)
    assert coef.device_decode and not coef.device_dct
    q = parse_query("w=30&h=20")
    assert coef.process_image(_src("synth"), q, Format()) == \
        Engine(CPU, device_decode=False).process_image(_src("synth"), q,
                                                       Format())
    assert coef.stats == {"pixel_src": 0, "coef_src": 1}
    kinds = []

    class Recorder(SyncDeviceRunner):
        def run(self, plans, images, kinds_=None):
            kinds.extend(kinds_)
            return super().run(plans, images, kinds_)

    dct_coef = Engine(CPU, runner=Recorder(CPU), device_dct=True)
    dct_pixel = Engine(CPU, runner=Recorder(CPU), device_decode=False,
                       device_dct=True)
    a = dct_coef.process_image(_src("synth"), q, Format())
    b = dct_pixel.process_image(_src("synth"), q, Format())
    assert a == b and a[0] == "image/jpeg"
    assert kinds == ["coef+jpegdct:75", "jpegdct:75"]
    assert dct_coef.stats == {"pixel_src": 0, "coef_src": 1}
    assert dct_pixel.stats == {"pixel_src": 1, "coef_src": 0}


@pytest.mark.parametrize("fmt", ["png", "tiff"])
def test_engine_16bit_pil_fallback_matches(monkeypatch, fmt):
    """Without the native unfilter/LZW pass (the card's machine) a large
    16-bit PNG or LZW TIFF exceeds the bounded python pass and both
    packages hand it to PIL's high-byte read: same bytes."""
    from fanlin_tpu.engine import native_codecs as jnative
    from fanlin_tpu.engine import png16 as jpng16
    from fanlin_tpu.engine import tiff16 as jtiff16
    from fanlin_tpu_torch.engine import native_codecs, png16, tiff16

    a16 = np.random.default_rng(62).integers(0, 65536, (40, 48, 3),
                                             dtype=np.uint16)
    if fmt == "png":
        data = make_png16(a16, 2)
        for mod, nat in ((png16, native_codecs), (jpng16, jnative)):
            monkeypatch.setattr(nat, "png_unfilter", lambda *a: None)
            monkeypatch.setattr(mod, "_PY_UNFILTER_MAX", 64)
    else:
        data = make_tiff16(a16, compression=5, rows_per_strip=4)
        for mod, nat in ((tiff16, native_codecs), (jtiff16, jnative)):
            monkeypatch.setattr(nat, "tiff_lzw", lambda *a: None)
            monkeypatch.setattr(mod, "_PY_LZW_MAX", 64)
    assert codecs.decode(data)[0][0, 0, 0] == a16[0, 0, 0] >> 8  # high byte
    q = parse_query("w=40&h=30")
    got = Engine(CPU, device_decode=False).process_image(data, q, Format())
    want = JaxEngine(device_decode=False).process_image(
        data, jparse_query("w=40&h=30"), jcontent.Format())
    assert got == want
