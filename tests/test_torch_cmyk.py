"""The port's CMYK / ICC path (P9) on the CPU against the JAX package:
`CmykCoefBatchAssembly` with each sink, the Engine's routing and bodies
with device ICC on and off, embedded profiles, EXIF rotation, two
Engines of different profiles interleaved in one process, and the
server's startup with the ICC options.

Tolerances: the chain's, at most 1 LSB anywhere and at most 0.5 % of
bytes differing against the JAX package (the float resample sums in
another order); jpegdct coefficients as in tests/test_torch_coef.py (at
most one step, at quantisation ties). Against the port's own pixel
route on the same LUT, none: the 4-component decode is bit-exact with
PIL's.

The JAX Engine's enable_device_icc installs its LUT in a module global
(fanlin_tpu.ops.fused._CMYK_LUT); every test here that calls it
restores that global afterwards, and the port keeps no such global.
"""

import asyncio
import io
import json
import logging
import os

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from fanlin_tpu.engine import Engine as JEngine
from fanlin_tpu.engine import icc as jicc
from fanlin_tpu.engine import native_codecs
from fanlin_tpu.engine.processor import SyncDeviceRunner as JRunner
from fanlin_tpu.ops import fused as jfused
from fanlin_tpu.spec.content import Format as JFormat
from fanlin_tpu.spec.query import parse_query as jparse_query
from fanlin_tpu_torch.config import Config
from fanlin_tpu_torch.engine import Engine
from fanlin_tpu_torch.engine import icc as ticc
from fanlin_tpu_torch.engine.jpeg_coeffs import read_jpeg_coeffs4
from fanlin_tpu_torch.engine.processor import SyncDeviceRunner
from fanlin_tpu_torch.ops import cmyk_lut as tlut
from fanlin_tpu_torch.ops import fused as tfused
from fanlin_tpu_torch.ops import plan as tplan
from fanlin_tpu_torch.server.app import STATE_KEY, build_state, create_app
from fanlin_tpu_torch.spec.content import Format
from fanlin_tpu_torch.spec.query import parse_query
from tests.conftest import make_test_image
from tests.test_torch_icc import adobe_ycck, cmyk_jpeg, make_cmyk_profile

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def jax_lut():
    """Restores the JAX package's process-wide CMYK LUT after a test that
    runs its Engine.enable_device_icc."""
    saved = dict(jfused._CMYK_LUT)
    yield
    jfused._CMYK_LUT.clear()
    jfused._CMYK_LUT.update(saved)


def _close(a, b, max_lsb=1, max_frac=0.005):
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a - b)
    assert int(d.max()) <= max_lsb
    assert float((d > 0).mean()) <= max_frac


def _sources():
    """CMYK 4:4:4, its YCCK flip and (with the native core) a libjpeg
    YCCK 4:2:0 stream."""
    data = cmyk_jpeg(120, 88, seed=1)
    out = {"cmyk444": data, "ycck444": adobe_ycck(data)}
    arr = np.asarray(Image.open(io.BytesIO(data)))
    ycck420 = native_codecs.encode_jpeg_cmyk(255 - arr, 92, True)
    if ycck420 is not None:
        out["ycck420"] = ycck420
    return out


SOURCES = ["cmyk444", "ycck444", "ycck420"]


def _source(name):
    src = _sources()
    if name not in src:
        pytest.skip("native codec core not built (YCCK 4:2:0 writer)")
    return src[name]


def _lut(seed=0):
    conv = ticc.CMYK2RGB.with_icc_profile(make_cmyk_profile(seed))
    return tlut.sample_lut(conv.convert, 17)


def _meta(data, lut, key=""):
    meta = read_jpeg_coeffs4(data)
    flat = np.ascontiguousarray(lut.reshape(-1, 3).astype(np.float32))
    meta.update(lut_flat=flat, lut_n=lut.shape[0], lut_key=key)
    return meta


def _kind(meta):
    return "cmyk%d%s" % (meta["subsamp"], "y" if meta["ycck"] else "")


QS = "w=60&h=44"


@pytest.mark.parametrize("payload", ["dict", "slot"])
@pytest.mark.parametrize("name", SOURCES)
@pytest.mark.parametrize("qs", [QS, "w=50&h=50&crop=true&blur=1",
                                "w=64&h=40&rgb=9,8,7"])
def test_assembly_matches_jax(name, qs, payload):
    """The pixel result of a CMYK batch, staged from the dict or
    prestaged in a WireSlot, against the JAX CmykCoefBatchAssembly on the
    same metas and LUT (1 LSB, 0.5 %), and byte-equal to the port's pixel
    route (the decoded CMYK pixels through the same LUT)."""
    data = _source(name)
    lut = _lut()
    meta = _meta(data, lut)
    plan = tplan.plan_image(meta["w"], meta["h"], parse_query(qs),
                            opaque=True)
    src = meta if payload == "dict" else tfused.WireSlot(meta, pinned=False)
    got = tfused.make_assembly([plan], [src], [_kind(meta)], CPU).run()[0]
    jplan = jfused.plan_image(meta["w"], meta["h"], jparse_query(qs),
                              opaque=True)
    want = jfused.make_assembly([jplan], [meta], [_kind(meta)]).run()[0]
    _close(got, want)
    px = np.asarray(Image.open(io.BytesIO(data)))
    rgb = tlut.DeviceCmykTransform(lut, CPU).convert(px)
    pixel = tfused.BatchAssembly([plan], [rgb], CPU).run()[0]
    np.testing.assert_array_equal(got, pixel)


@pytest.mark.parametrize("sink", ["jpeg420", "webp420", "png:3"])
@pytest.mark.parametrize("name", SOURCES)
def test_sinks_match_jax_and_pixel_route(name, sink):
    data = _source(name)
    lut = _lut()
    meta = _meta(data, lut)
    plan = tplan.plan_image(meta["w"], meta["h"], parse_query(QS),
                            opaque=True)
    kind = f"{_kind(meta)}+{sink}"
    got = tfused.make_assembly([plan], [meta], [kind], CPU).run()[0]
    jplan = jfused.plan_image(meta["w"], meta["h"], jparse_query(QS),
                              opaque=True)
    want = jfused.make_assembly([jplan], [meta], [kind]).run()[0]
    px = np.asarray(Image.open(io.BytesIO(data)))
    rgb = tlut.DeviceCmykTransform(lut, CPU).convert(px)
    pixel = tfused.make_assembly([plan], [rgb], [sink], CPU).run()[0]
    assert got[0] == want[0] == pixel[0]
    for g, w, p in zip(got[1:], want[1:], pixel[1:]):
        if isinstance(p, np.ndarray):
            np.testing.assert_array_equal(g, p)
            _close(g, w)
        else:
            assert g == w == p


@pytest.mark.parametrize("quality", [75, 92])
@pytest.mark.parametrize("name", SOURCES)
def test_jpegdct_sink_matches_jax(name, quality):
    """"+jpegdct:Q": the JAX package's coefficients but at quantisation
    ties (at most one step, under 0.2 % of them), and exactly the port's
    pixel route's."""
    data = _source(name)
    lut = _lut()
    meta = _meta(data, lut)
    plan = tplan.plan_image(meta["w"], meta["h"], parse_query(QS),
                            opaque=True)
    kind = f"{_kind(meta)}+jpegdct:{quality}"
    got = tfused.make_assembly([plan], [meta], [kind], CPU).run()[0]
    jplan = jfused.plan_image(meta["w"], meta["h"], jparse_query(QS),
                              opaque=True)
    jfused.set_host_fallback(False)  # a narrow-rung overflow re-runs inline
    try:
        want = jfused.make_assembly([jplan], [meta], [kind]).run()[0]
    finally:
        jfused.set_host_fallback(True)
    assert got[0] == want[0] == "coeffs"
    assert got[4:] == want[4:] == (60, 44, quality)
    for g, w in zip(got[1:4], want[1:4]):
        assert g.shape == w.shape and g.dtype == w.dtype == np.int16
        d = np.abs(g.astype(np.int32) - w)
        assert d.max() <= 1 and (d > 0).mean() < 2e-3
    rgb = tlut.DeviceCmykTransform(lut, CPU).convert(
        np.asarray(Image.open(io.BytesIO(data))))
    pixel = tfused.make_assembly([plan], [rgb], [f"jpegdct:{quality}"],
                                 CPU).run()[0]
    for g, p in zip(got, pixel):
        if isinstance(p, np.ndarray):
            np.testing.assert_array_equal(g, p)
        else:
            assert g == p


def test_batch_of_two_and_padding():
    """A uniform batch of two and a batch of three (bucketed to four, one
    padded image) give each image its own single-image bytes."""
    lut = _lut()
    metas = [_meta(cmyk_jpeg(120, 88, seed=s), lut) for s in (1, 2, 3)]
    plan = tplan.plan_image(120, 88, parse_query(QS), opaque=True)
    solo = [tfused.make_assembly([plan], [m], ["cmyk444"], CPU).run()[0]
            for m in metas]
    for k in (2, 3):
        asm = tfused.make_assembly([plan] * k, metas[:k], ["cmyk444"] * k,
                                   CPU)
        assert asm.b == (2 if k == 2 else 4) and asm.uses_kernel()
        for got, want in zip(asm.run(), solo):
            np.testing.assert_array_equal(got, want)


def test_padding_past_the_true_rect_has_zero_weight():
    """The LUT converts the padding too (LUT(0, 0, 0, 0), as the JAX
    program does); the resample weights there are zero, so noise in the
    padding leaves the chain's output unchanged."""
    lut = _lut()
    meta = _meta(cmyk_jpeg(120, 88, seed=1), lut)
    plan = tplan.plan_image(120, 88, parse_query(QS), opaque=True)
    av, ah, _, _ = tplan._uniform_padded(plan)
    assert not av[:, 88:].any() and not ah[:, 120:].any()
    asm = tfused.make_assembly([plan], [meta], ["cmyk444"], CPU)
    x = asm._device_x()
    assert tuple(x.shape) == (1, 3, asm.sh, asm.sw) and x.dtype == torch.uint8
    flat = torch.from_numpy(meta["lut_flat"])
    corner = flat[0].round().to(torch.uint8)
    assert (x[0, :, 88:, :] == corner[:, None, None]).all()
    noisy = x.clone()
    noisy[:, :, 88:, :] = 77
    noisy[:, :, :, 120:] = 200
    asm._device_x = lambda: noisy
    np.testing.assert_array_equal(asm.run()[0],
                                  tfused.make_assembly([plan], [meta],
                                                       ["cmyk444"],
                                                       CPU).run()[0])


@pytest.mark.parametrize("where", ["coef", "transform"])
def test_non_integer_lut_raises(where):
    """A LUT that is not integers in [0, 255] does not pack: the
    coefficient route's batch and DeviceCmykTransform raise ValueError,
    with no f32 form to fall back on."""
    lut = _lut().reshape(-1, 3).astype(np.float32)
    lut[123, 1] = 127.5
    if where == "transform":
        with pytest.raises(ValueError, match="integers"):
            tlut.DeviceCmykTransform(lut, CPU)
        return
    meta = read_jpeg_coeffs4(cmyk_jpeg(120, 88, seed=1))
    meta.update(lut_flat=lut, lut_n=17, lut_key="")
    plan = tplan.plan_image(120, 88, parse_query(QS), opaque=True)
    with pytest.raises(ValueError, match="integers"):
        tfused.make_assembly([plan], [meta], ["cmyk444"], CPU).run()


def test_mixed_profiles_in_one_batch_raise():
    plan = tplan.plan_image(120, 88, parse_query(QS), opaque=True)
    a = _meta(cmyk_jpeg(120, 88, seed=1), _lut(0))
    b = _meta(cmyk_jpeg(120, 88, seed=1), _lut(1), key="abc")
    with pytest.raises(ValueError, match="mixed-profile"):
        tfused.CmykCoefBatchAssembly([plan, plan], [a, b], CPU)


@pytest.mark.parametrize("payload", ["pixels", "meta3", "no_lut",
                                     "wrong_layout"])
def test_cmyk_kind_refuses_other_payloads(payload):
    data = cmyk_jpeg(120, 88, seed=1)
    plan = tplan.plan_image(120, 88, parse_query(QS), opaque=True)
    kind = "cmyk444"
    if payload == "pixels":
        p = make_test_image(120, 88)
    elif payload == "meta3":
        from fanlin_tpu_torch.engine.jpeg_coeffs import read_jpeg_coeffs

        buf = io.BytesIO()
        Image.fromarray(make_test_image(120, 88)).save(buf, format="JPEG")
        p = read_jpeg_coeffs(buf.getvalue())
    elif payload == "no_lut":
        p = read_jpeg_coeffs4(data)
    else:
        p = _meta(data, _lut())
        kind = "cmyk420y"
    with pytest.raises(ValueError):
        tfused.make_assembly([plan], [p], [kind], CPU)


class _Recording:
    """A runner that records the batch kinds it is given."""

    def __init__(self, inner):
        self.inner = inner
        self.kinds = []

    def run(self, plans, images, kinds=None):
        self.kinds.extend(kinds or ["rgb"])
        return self.inner.run(plans, images, kinds)


def _engines(device_icc, embedded=False, seed=0):
    prof = make_cmyk_profile(seed)
    j = JEngine(runner=_Recording(JRunner()),
                cmyk2rgb=jicc.CMYK2RGB.with_icc_profile(prof),
                use_embedded_profile=embedded)
    t = Engine(CPU, runner=_Recording(SyncDeviceRunner(CPU)),
               cmyk2rgb=ticc.CMYK2RGB.with_icc_profile(prof),
               use_embedded_profile=embedded)
    if device_icc:
        j.enable_device_icc()
        t.enable_device_icc()
    return j, t


def _decoded(body):
    with Image.open(io.BytesIO(body)) as im:
        return np.asarray(im.convert("RGB"))


def _both(j, t, data, qs=QS):
    jm, jb = j.process_image(data, jparse_query(qs), JFormat())
    tm, tb = t.process_image(data, parse_query(qs), Format())
    assert tm == jm
    _close(_decoded(tb), _decoded(jb))
    return tb


@pytest.mark.parametrize("name", SOURCES)
@pytest.mark.parametrize("device_icc", [True, False])
def test_engine_routes_like_jax(jax_lut, name, device_icc):
    """With device ICC both engines take the coefficient path
    (coef_src), without it host lcms2 on pixels (pixel_src); equal mime
    types, bodies within the chain's rule, the same batch kinds."""
    data = _source(name)
    j, t = _engines(device_icc)
    _both(j, t, data)
    want = ({"pixel_src": 0, "coef_src": 1} if device_icc
            else {"pixel_src": 1, "coef_src": 0})
    assert t.stats == want and j.stats == want
    assert t.runner.kinds == j.runner.kinds
    if device_icc:
        assert t.runner.kinds[0].split("+")[0] == {
            "cmyk444": "cmyk444", "ycck444": "cmyk444y",
            "ycck420": "cmyk420y"}[name]


@pytest.mark.parametrize("qs", ["w=60&h=44&webp=true&quality=30",
                                "w=60&h=44&grayscale=true",
                                "w=40&h=40&crop=true&rgb=1,2,3"])
def test_engine_outputs_like_jax(jax_lut, qs):
    j, t = _engines(True)
    _both(j, t, _source("cmyk444"), qs)
    assert t.stats == j.stats == {"pixel_src": 0, "coef_src": 1}


def test_engine_embedded_profile_rides_its_own_lut(jax_lut):
    """An embedded profile with device ICC: the "@<key>" kind on both,
    the key the profile's hash; a broken embedded profile falls back to
    the default LUT (no key)."""
    embedded = make_cmyk_profile(1)
    j, t = _engines(True, embedded=True)
    data = cmyk_jpeg(120, 88, seed=1, icc=embedded)
    _both(j, t, data)
    key = ticc.embedded_device_lut(embedded)[2]
    assert t.runner.kinds == j.runner.kinds
    assert t.runner.kinds[0].split("+")[0] == f"cmyk444@{key}"
    from PIL import ImageCms

    srgb = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()
    _both(j, t, cmyk_jpeg(120, 88, seed=1, icc=srgb))
    assert t.runner.kinds[-1].split("+")[0] == "cmyk444"
    assert t.stats == j.stats == {"pixel_src": 0, "coef_src": 2}


def test_engine_embedded_without_device_icc_uses_lcms2(jax_lut):
    embedded = make_cmyk_profile(1)
    j, t = _engines(False, embedded=True)
    body = _both(j, t, cmyk_jpeg(120, 88, seed=1, icc=embedded))
    assert t.stats == j.stats == {"pixel_src": 1, "coef_src": 0}
    # the embedded profile served, not the default one
    j2, t2 = _engines(False, embedded=False)
    other = t2.process_image(cmyk_jpeg(120, 88, seed=1, icc=embedded),
                             parse_query(QS), Format())[1]
    assert body != other


def test_engine_rotated_cmyk_takes_pixels(jax_lut):
    exif = Image.Exif()
    exif[0x0112] = 6
    buf = io.BytesIO()
    Image.fromarray(make_test_image(64, 48)).convert("CMYK").save(
        buf, format="JPEG", quality=90, exif=exif)
    j, t = _engines(True)
    body = _both(j, t, buf.getvalue())
    assert _decoded(body).shape == (44, 60, 3)
    assert t.stats == j.stats == {"pixel_src": 1, "coef_src": 0}
    assert t.runner.kinds == j.runner.kinds


def _rotated_cmyk(icc=None):
    exif = Image.Exif()
    exif[0x0112] = 6
    buf = io.BytesIO()
    Image.fromarray(make_test_image(64, 48)).convert("CMYK").save(
        buf, format="JPEG", quality=90, exif=exif,
        **({"icc_profile": icc} if icc else {}))
    return buf.getvalue()


@pytest.mark.parametrize("route", ["pixels", "pixels_embedded", "coef"])
@pytest.mark.parametrize("fault", ["kernel", "upload"])
def test_engine_device_icc_failure_raises(monkeypatch, route, fault):
    """With device ICC a failure of the LUT kernel's wrapper (K12b on the
    pixel route, the fused decode on the coefficient route) or of the
    packed LUT's upload raises out of process_image, on the pixel route
    (an EXIF-rotated source, with the default or an embedded profile) and
    on the coefficient route: no request is answered with Pillow's plain
    CMYK->RGB."""
    from fanlin_tpu_torch.ops import cmyk_lut_kernels as lk
    from fanlin_tpu_torch.ops import jpeg_decode_kernels as jk

    embedded = make_cmyk_profile(1)
    t = Engine(CPU, cmyk2rgb=ticc.CMYK2RGB.with_icc_profile(
        make_cmyk_profile(0)), use_embedded_profile=True)
    t.enable_device_icc()
    data = {"pixels": _rotated_cmyk(),
            "pixels_embedded": _rotated_cmyk(embedded),
            "coef": _source("cmyk444")}[route]

    def fail(*args, **kwargs):
        raise RuntimeError("injected")

    if fault == "kernel" and route == "coef":
        monkeypatch.setattr(jk, "jpeg_decode_cmyk_rgb", fail)
    elif fault == "kernel":
        monkeypatch.setattr(lk, "cmyk_lut_pixels", fail)
    else:
        monkeypatch.setattr(tfused, "_device_cached", fail)
    with pytest.raises(RuntimeError, match="injected"):
        t.process_image(data, parse_query(QS), Format())


def test_engine_device_lut_pixel_route_equals_coef_route():
    """A CMYK stream the reader refuses (4:2:0 CMYK) converts its pixels
    through the same LUT: its bytes are the coefficient route's would
    be for the same pixels."""
    buf = io.BytesIO()
    Image.fromarray(make_test_image(120, 88)).convert("CMYK").save(
        buf, format="JPEG", quality=90, subsampling=2)
    _, t = _engines(True)
    t.process_image(buf.getvalue(), parse_query(QS), Format())
    assert t.stats == {"pixel_src": 1, "coef_src": 0}
    assert t.runner.kinds[0] in ("rgb", "jpeg420")


def test_engine_without_profile_decodes_cmyk_as_before():
    t = Engine(CPU)
    t.enable_device_icc()  # no default profile: a no-op
    assert t.device_cmyk is None
    t.process_image(_source("cmyk444"), parse_query(QS), Format())
    assert t.stats == {"pixel_src": 1, "coef_src": 0}


def test_two_engines_interleaved_keep_their_profiles():
    """Two Engines with different default profiles, their requests
    interleaved in one process, each give the bytes of its own solo run:
    no LUT is shared through process state."""
    data = {n: _source(n) for n in ("cmyk444", "ycck444")}
    q = parse_query(QS)

    def engine(seed):
        e = Engine(CPU, cmyk2rgb=ticc.CMYK2RGB.with_icc_profile(
            make_cmyk_profile(seed)))
        e.enable_device_icc()
        return e

    solo = {}
    for seed in (0, 1):
        e = engine(seed)
        solo[seed] = {n: e.process_image(d, q, Format()) for n, d in
                      data.items()}
    assert solo[0]["cmyk444"] != solo[1]["cmyk444"]
    a, b = engine(0), engine(1)
    for _ in range(2):
        for n, d in data.items():
            assert a.process_image(d, q, Format()) == solo[0][n]
            assert b.process_image(d, q, Format()) == solo[1][n]
    assert a.stats == b.stats == {"pixel_src": 0, "coef_src": 4}


def _server_config(folder, tpu="{}", extra=None):
    obj = {"port": 0, "bind_addr": "127.0.0.1", "max_clients": 8,
           "client": {"s3": {"aws_region": "x"},
                      "web": {"user_agent": "fanlin-test/0", "timeout": 2}},
           "providers": [{"path": "baz", "src": "file://localhost" + folder}],
           "tpu": json.loads(tpu)}
    obj.update(extra or {})
    return Config.from_obj(obj)


@pytest.fixture
def cmyk_folder(tmp_path):
    (tmp_path / "default.icc").write_bytes(make_cmyk_profile(0))
    (tmp_path / "cmyk.jpg").write_bytes(cmyk_jpeg(120, 88, seed=1))
    (tmp_path / "embedded.jpg").write_bytes(
        cmyk_jpeg(120, 88, seed=1, icc=make_cmyk_profile(1)))
    return str(tmp_path)


def _serve(cfg, urls):
    async def body():
        state = await build_state(cfg, device=CPU)
        client = TestClient(TestServer(create_app(cfg, state)))
        await client.start_server()
        try:
            out = []
            for url in urls:
                r = await client.get(url)
                out.append((r.status, r.headers["Content-Type"],
                            await r.read()))
            r = await client.get("/stats")
            stats = json.loads(await r.text())
            return state, out, stats
        finally:
            await client.close()

    return asyncio.run(body())


@pytest.mark.parametrize("option", ["device_icc", "profile_path",
                                    "use_embedded_profile"])
def test_server_serves_cmyk_with_icc_options(cmyk_folder, option):
    """Each ICC option starts the server on the CPU, and a CMYK request
    answers 200 image/jpeg with a serial Engine's bytes of the same
    configuration."""
    prof = os.path.join(cmyk_folder, "default.icc")
    extra, tpu = {}, "{}"
    if option == "device_icc":
        extra, tpu = {"profile_path": prof}, '{"device_icc": true}'
    elif option == "profile_path":
        extra = {"profile_path": prof}
    else:
        extra = {"use_embedded_profile": True}
    cfg = _server_config(cmyk_folder, tpu, extra)
    state, out, stats = _serve(cfg, ["/baz/cmyk.jpg?" + QS,
                                     "/baz/embedded.jpg?" + QS])
    engine = state.engine
    assert (engine.device_cmyk is not None) == (option == "device_icc")
    assert (engine.cmyk2rgb is not None) == (option != "use_embedded_profile")
    assert engine.use_embedded_profile == (option == "use_embedded_profile")
    serial = Engine(CPU, cmyk2rgb=engine.cmyk2rgb,
                    use_embedded_profile=engine.use_embedded_profile)
    if option == "device_icc":
        serial.enable_device_icc()
    for (status, mime, body), name in zip(out, ("cmyk.jpg", "embedded.jpg")):
        assert status == 200 and mime == "image/jpeg"
        with open(os.path.join(cmyk_folder, name), "rb") as f:
            want = serial.process_image(f.read(), parse_query(QS), Format())
        assert body == want[1]
    src = "coef_src" if option == "device_icc" else "pixel_src"
    assert stats["engine"][src] == 2
    assert stats["kernel_launches"]["jpeg_decode_cmyk"] == 0
    assert stats["kernel_launches"]["cmyk_lut"] == 0


def test_server_missing_profile_warns_and_serves(cmyk_folder, caplog):
    """A profile_path that does not load logs the reference's warning;
    CMYK then serves as with no profile (decoded by PIL)."""
    cfg = _server_config(cmyk_folder, '{"device_icc": true}',
                         {"profile_path": "/nonexistent.icc"})
    with caplog.at_level(logging.WARNING, logger="fanlin.server"):
        state, out, _ = _serve(cfg, ["/baz/cmyk.jpg?" + QS])
    assert "failed to load an icc profile" in caplog.text
    assert state.engine.cmyk2rgb is None and state.engine.device_cmyk is None
    status, mime, body = out[0]
    assert status == 200 and mime == "image/jpeg"
    with open(os.path.join(cmyk_folder, "cmyk.jpg"), "rb") as f:
        want = Engine(CPU).process_image(f.read(), parse_query(QS),
                                         Format())[1]
    assert body == want


def test_server_state_hooks():
    """State.create_cmyk_to_rgb_converter / enable_embedded_profile_
    utilization set the engine's converter and flag (JAX state.py:47-57)."""
    from fanlin_tpu_torch.server.state import State

    engine = Engine(CPU)
    state = State([], None, engine)
    state.create_cmyk_to_rgb_converter("/nonexistent.icc")
    assert engine.cmyk2rgb is None
    state.enable_embedded_profile_utilization()
    assert engine.use_embedded_profile
