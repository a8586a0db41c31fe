"""The port's copies of the JAX package's host modules (config, spec,
infra, utils, ops.filters, server.router/timing) against the originals,
on the same inputs: each copy must give the same answers, so the port
behaves as it did when it imported them."""

import dataclasses
import os

import numpy as np
import pytest

import chip_smoke
from fanlin_tpu import config as jconfig
from fanlin_tpu.ops import filters as jfilters
from fanlin_tpu.server import router as jrouter
from fanlin_tpu.server import timing as jtiming
from fanlin_tpu.spec import content as jcontent
from fanlin_tpu.spec import query as jquery
from fanlin_tpu.utils import bytelru as jbytelru
from fanlin_tpu.utils import paths as jpaths
from fanlin_tpu_torch import config as tconfig
from fanlin_tpu_torch.ops import filters as tfilters
from fanlin_tpu_torch.server import router as trouter
from fanlin_tpu_torch.server import timing as ttiming
from fanlin_tpu_torch.spec import content as tcontent
from fanlin_tpu_torch.spec import query as tquery
from fanlin_tpu_torch.utils import bytelru as tbytelru
from fanlin_tpu_torch.utils import paths as tpaths

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
