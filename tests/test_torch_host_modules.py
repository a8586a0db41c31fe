"""The port's copies of the JAX package's host modules (config, spec,
infra, utils, ops.filters, server.router/timing, and the host decoders
and encoders engine.png16/tiff16/extra_codecs/exr_codec) against the
originals, on the same inputs: each copy must give the same answers, so
the port behaves as it did when it imported them."""

import dataclasses
import os

import numpy as np
import pytest

import chip_smoke
from fanlin_tpu import config as jconfig
from fanlin_tpu.engine import exr_codec as jexr
from fanlin_tpu.engine import extra_codecs as jextra
from fanlin_tpu.engine import png16 as jpng16
from fanlin_tpu.engine import tiff16 as jtiff16
from fanlin_tpu.ops import filters as jfilters
from fanlin_tpu.server import router as jrouter
from fanlin_tpu.server import timing as jtiming
from fanlin_tpu.spec import content as jcontent
from fanlin_tpu.spec import query as jquery
from fanlin_tpu.utils import bytelru as jbytelru
from fanlin_tpu.utils import paths as jpaths
from fanlin_tpu_torch import config as tconfig
from fanlin_tpu_torch.engine import exr_codec as texr
from fanlin_tpu_torch.engine import extra_codecs as textra
from fanlin_tpu_torch.engine import png16 as tpng16
from fanlin_tpu_torch.engine import tiff16 as ttiff16
from fanlin_tpu_torch.ops import filters as tfilters
from fanlin_tpu_torch.server import router as trouter
from fanlin_tpu_torch.server import timing as ttiming
from fanlin_tpu_torch.spec import content as tcontent
from fanlin_tpu_torch.spec import query as tquery
from fanlin_tpu_torch.utils import bytelru as tbytelru
from fanlin_tpu_torch.utils import paths as tpaths

from tests.test_png16 import make_png16
from tests.test_tiff16 import make_tiff16

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the README's queries, chip_smoke.py's golden, main-path and edge
# queries, and malformed ones
QUERIES = sorted(
    {"w=300&h=200", "w=300&h=200&webp=true&quality=20", ""}
    | {qs for _, qs in chip_smoke.GOLDEN_CASES}
    | {s[3] for s in chip_smoke.SHAPES + chip_smoke.EDGE_SHAPES}
    | {"w=abc", "h=-1", "w=300&w=301", "crop=maybe", "rgb=1,2",
       "rgb=300,0,0", "blur=x", "quality=101", "avif=true&w=40&h=40",
       "w=5000&h=5000", "w=10&h=10"})


def _parse(mod, qs):
    try:
        return dataclasses.asdict(mod.parse_query(qs))
    except Exception as e:  # the error class and message are compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("qs", QUERIES)
def test_parse_query_matches(qs):
    got, want = _parse(tquery, qs), _parse(jquery, qs)
    assert got == want
    if isinstance(got, dict):
        t, j = tquery.parse_query(qs), jquery.parse_query(qs)
        for m in ("dimensions", "fill_color", "quality", "cropping", "blur",
                  "grayscale", "inverse", "use_avif", "use_webp", "as_is",
                  "unsupported_scale_size"):
            assert getattr(t, m)() == getattr(j, m)(), m


@pytest.mark.parametrize("name", ["fanlin-tpu.json",
                                  "fanlin-tpu-container.json"])
def test_config_from_file_matches(name):
    path = os.path.join(ROOT, name)
    got = dataclasses.asdict(tconfig.Config.from_file(path))
    want = dataclasses.asdict(jconfig.Config.from_file(path))
    assert got == want


@pytest.mark.parametrize("text", ['{"port": -1}', '{"providers": 3}', "{",
                                  '{"tpu": {"max_batch": "x"}}'])
def test_config_errors_match(text):
    def err(mod):
        try:
            mod.Config.from_str(text)
        except Exception as e:
            return type(e).__name__, str(e)
        return None

    assert err(tconfig) == err(jconfig)


PAIRS = [(512, 300), (512, 512), (7, 3), (100, 997), (4000, 1200)]


@pytest.mark.parametrize("src,out", PAIRS)
@pytest.mark.parametrize("filt", [tfilters.LANCZOS3, tfilters.NEAREST,
                                  tfilters.TRIANGLE, tfilters.CATMULLROM])
def test_filter_matrices_match(filt, src, out):
    got = tfilters.resample_matrix(src, out, filt)
    want = jfilters.resample_matrix(src, out, filt)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tfilters.gaussian_matrix(out, 1.5),
                                  jfilters.gaussian_matrix(out, 1.5))
    assert (tfilters.resize_dimensions(src, out, 300, 200, False)
            == jfilters.resize_dimensions(src, out, 300, 200, False))
    assert (tfilters.fill_crop_window(src, out, 100, 100)
            == jfilters.fill_crop_window(src, out, 100, 100))


def test_luma_matches():
    rgb = np.random.default_rng(0).integers(0, 256, (7, 9, 3), np.uint8)
    np.testing.assert_array_equal(tfilters.luma_u8(rgb),
                                  jfilters.luma_u8(rgb))


PROVIDERS = [{"path": "baz", "src": "file://localhost/srv/img"},
             {"path": "/baz/deep/", "src": "s3://bucket/prefix",
              "fallback_path": "/fb.jpg", "success_even_no_content": True},
             {"path": "web", "src": "https://example.invalid/root"},
             {"path": "", "src": "file://localhost/root"}]
REQ_PATHS = ["/baz/a.jpg", "/baz/deep/b/c.png", "/baz/", "/web/x%20y.jpg",
             "/other/z.gif", "/", "/baz", "/web/日本.jpg", "//baz//a.jpg"]


@pytest.mark.parametrize("req", REQ_PATHS)
def test_router_and_paths_match(req):
    def route(cfg_mod, router_mod):
        r = router_mod.Router([cfg_mod.Provider.from_obj(p)
                               for p in PROVIDERS])
        p = r.at(req)
        return None if p is None else (p.path, p.src, p.fallback_path,
                                       p.success_even_no_content)

    got, want = route(tconfig, trouter), route(jconfig, jrouter)
    assert got == want
    if want is None:
        return
    prefix, src = want[0], want[1]
    assert tpaths.clean_path(req, prefix) == jpaths.clean_path(req, prefix)
    assert tpaths.percent_encode(req) == jpaths.percent_encode(req)
    for fn in ("build_url", "build_local_path",
               "build_bucket_and_object_key"):
        assert getattr(tpaths, fn)(src, prefix, req) == \
            getattr(jpaths, fn)(src, prefix, req), fn


def test_bytelru_eviction_order_matches():
    caches = [tbytelru.ByteLRU(max_bytes=100), jbytelru.ByteLRU(max_bytes=100)]
    rng = np.random.default_rng(1)
    for step in range(400):
        key, size = int(rng.integers(0, 12)), int(rng.integers(1, 40))
        row = []
        for c in caches:
            if step % 3:  # two puts, then a get alone
                c.put(key, step, size)
            row.append((c.get(key), len(c), c.stats()))
        assert row[0] == row[1], step
    t, j = caches
    assert [t.get(k) for k in range(12)] == [j.get(k) for k in range(12)]


def test_timing_header_matches():
    timers = [ttiming.Timer(), jtiming.Timer()]
    for t in timers:
        t.add_duration("f_fetch", 1.25)
        t.add_duration("f_process", 12.345)
        t.add_duration("f_device", 0.05)
    assert timers[0].header_value() == timers[1].header_value() == \
        "f_fetch;dur=1.2, f_process;dur=12.3, f_device;dur=0.1"
    assert ttiming.HEADER_KEY == jtiming.HEADER_KEY == "Server-Timing"


@pytest.mark.parametrize("accept", [[], ["image/webp"], ["image/avif,*/*"],
                                    ["image/webp", "image/avif"], ["*/*"]])
def test_content_negotiation_matches(accept):
    t = tcontent.extract_accepted_image_formats(accept)
    j = jcontent.extract_accepted_image_formats(accept)
    assert (t.webp_accepted(), t.avif_accepted()) == \
        (j.webp_accepted(), j.avif_accepted())
    assert repr(t) == repr(j)


def _call(fn, *args, **kw):
    """fn's result, or its error class and message."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # the error class and message are compared
        return (type(e).__name__, str(e))


def _assert_same(got, want):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert got == want


def _codec_inputs():
    rng = np.random.default_rng(70)
    rgba = rng.integers(0, 256, (23, 31, 4), dtype=np.uint8)
    rgba[5:9] = rgba[5, 5]  # runs (QOI RUN, HDR RLE)
    rgb = np.ascontiguousarray(rgba[..., :3])
    a16 = rng.integers(0, 65536, (9, 13, 3), dtype=np.uint16)
    g16 = rng.integers(0, 65536, (9, 13, 1), dtype=np.uint16)
    f32 = rng.uniform(-0.5, 1.5, (9, 13, 3)).astype(np.float32)
    return rgba, rgb, a16, g16, f32


_RGBA, _RGB, _A16, _G16, _F32 = _codec_inputs()
_EXR = {name[:-4]: open(os.path.join(ROOT, "tests", "golden", "exr", name),
                        "rb").read()
        for name in sorted(os.listdir(os.path.join(ROOT, "tests", "golden",
                                                   "exr")))
        if name.endswith(".exr")}
_PNM16 = b"P6\n13 9\n65535\n" + _A16.astype(">u2").tobytes()
_PGM10 = b"P5\n13 9\n1023\n" + (_G16 >> 6).astype(">u2").tobytes()

# (module, function, arguments): the decoders on sources written from a
# seed, the encoders on seeded pixels, and damaged or refused input
CODEC_CASES = [
    ("extra_codecs", "encode_qoi", (_RGBA,)),
    ("extra_codecs", "encode_qoi", (_RGB,)),
    ("extra_codecs", "decode_qoi", (jextra.encode_qoi(_RGBA),)),
    ("extra_codecs", "decode_qoi", (jextra.encode_qoi(_RGB)[:-12],)),
    ("extra_codecs", "encode_farbfeld", (_RGBA,)),
    ("extra_codecs", "decode_farbfeld", (jextra.encode_farbfeld(_RGBA),)),
    ("extra_codecs", "encode_hdr", (_RGB,)),
    ("extra_codecs", "decode_hdr", (jextra.encode_hdr(_RGB),)),
    ("extra_codecs", "decode_hdr", (jextra.encode_hdr(_RGB)[:40],)),
    ("extra_codecs", "encode_pam", (_RGBA,)),
    ("extra_codecs", "encode_pam", (_RGBA, True)),
    ("extra_codecs", "decode_pam", (jextra.encode_pam(_RGBA),)),
    ("extra_codecs", "decode_pam", (jextra.encode_pam(_RGBA, True),)),
    ("extra_codecs", "pnm_wide_header", (_PNM16,)),
    ("extra_codecs", "decode_pnm_wide", (_PNM16,)),
    ("extra_codecs", "decode_pnm_wide", (_PGM10,)),
    ("extra_codecs", "gray_to_rgb_u8", (_G16[..., 0], 65535)),
    ("extra_codecs", "gray_to_rgb_u8", (_F32[..., 0], 1)),
    ("png16", "is_png16", (make_png16(_A16, 2),)),
    ("png16", "is_png16", (b"\x89PNG\r\n\x1a\n",)),
    ("png16", "decode_png16", (make_png16(_A16, 2),)),
    ("png16", "decode_png16", (make_png16(_A16, 2, interlace=1),)),
    ("png16", "decode_png16", (make_png16(_G16, 0, trns=b"\x01\x02"),)),
    ("png16", "decode_png16", (make_png16(np.dstack([_A16, _G16]), 6),)),
    ("png16", "decode_png16", (make_png16(_A16, 2)[:-30],)),
    ("tiff16", "sniff16_parsed", (make_tiff16(_A16),)),
    ("tiff16", "sniff16_parsed", (make_tiff16(_G16),)),
    ("tiff16", "decode_tiff16", (make_tiff16(_A16, bo=">", compression=8,
                                             predictor=2),)),
    ("tiff16", "decode_tiff16", (make_tiff16(_A16, compression=5),)),
    ("tiff16", "decode_tiff16", (make_tiff16(_A16, compression=32773,
                                             tile=(16, 16)),)),
    ("tiff16", "decode_tiff16", (make_tiff16(_A16, planar=2, big=True),)),
    ("tiff16", "decode_tiff16", (make_tiff16(_F32, predictor=3,
                                             compression=8),)),
    ("tiff16", "decode_tiff16", (make_tiff16(_A16)[:-20],)),
    ("exr_codec", "encode_exr", (_RGB,)),
    ("exr_codec", "encode_exr", (_RGBA, jexr._ZIP)),
    ("exr_codec", "encode_exr", (_RGB, jexr._PXR24)),
    ("exr_codec", "encode_exr_tiled", (_RGBA, (8, 8), jexr._RLE)),
    ("exr_codec", "decode_exr", (jexr.encode_exr(_RGBA, jexr._ZIPS),)),
    ("exr_codec", "decode_exr", (jexr.encode_exr_tiled(_RGB, (16, 8)),)),
    ("exr_codec", "decode_exr", (jexr.encode_exr(_RGB)[:-9],)),
] + [("exr_codec", "decode_exr", (data,)) for data in _EXR.values()]

_MODULES = {"extra_codecs": (textra, jextra), "png16": (tpng16, jpng16),
            "tiff16": (ttiff16, jtiff16), "exr_codec": (texr, jexr)}


@pytest.mark.parametrize("i", range(len(CODEC_CASES)),
                         ids=[f"{m}.{f}-{i}"
                              for i, (m, f, _) in enumerate(CODEC_CASES)])
def test_codec_modules_match(i):
    mod, fn, args = CODEC_CASES[i]
    port, ref = _MODULES[mod]
    _assert_same(_call(getattr(port, fn), *args),
                 _call(getattr(ref, fn), *args))


@pytest.mark.parametrize("native", [True, False])
def test_codec_modules_match_without_native(monkeypatch, native):
    """The card has no native codec core: there the modules' pure-Python
    passes run (PNG unfilter, TIFF LZW, EXR PIZ Huffman); with it and
    without it the copies give the originals' answers."""
    from fanlin_tpu.engine import native_codecs as jnative
    from fanlin_tpu_torch.engine import native_codecs as tnative

    if not native:
        for nat in (jnative, tnative):
            for fn in ("png_unfilter", "tiff_lzw", "exr_huf_uncompress"):
                monkeypatch.setattr(nat, fn, lambda *a: None)
    for data in (make_png16(_A16, 2, filters=(1, 2, 3, 4)),
                 make_tiff16(_A16, compression=5, rows_per_strip=3)):
        t = (tpng16.decode_png16 if data[:1] == b"\x89"
             else ttiff16.decode_tiff16)
        j = (jpng16.decode_png16 if data[:1] == b"\x89"
             else jtiff16.decode_tiff16)
        _assert_same(t(data), j(data))
    for data in _EXR.values():
        _assert_same(_call(texr.decode_exr, data), _call(jexr.decode_exr, data))
