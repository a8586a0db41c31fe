"""The port's decoded-source cache (fanlin_tpu_torch.engine.source_cache,
`tpu.source_cache_mb`) on the CPU: twins of tests/test_source_cache.py
(the JAX package's `_nc_counts` memo has no counterpart: the port has no
nc upload rung). Hot sources served as several variants pay the host
decode once, with bodies byte-equal to an uncached Engine's on every
source path (coefficient, pixel, EXIF-oriented, host-ICC and device-LUT
CMYK, GIF frames). The cache's hit/miss/eviction counts are held equal
to the JAX package's SourceCache on the same put/get sequence, and the
warmup's `shapes_from_state` to the JAX function on the same fallback
images."""

import asyncio
import io
import json
import os

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from fanlin_tpu.config import TpuConfig as JTpuConfig
from fanlin_tpu.engine import source_cache as jsc
from fanlin_tpu.engine import warmup as jwarmup
from fanlin_tpu_torch.config import Config, ConfigError, TpuConfig
from fanlin_tpu_torch.engine import Engine, icc
from fanlin_tpu_torch.engine import source_cache as tsc
from fanlin_tpu_torch.engine import warmup as twarmup
from fanlin_tpu_torch.server.app import build_state, create_app
from fanlin_tpu_torch.spec.content import Format
from fanlin_tpu_torch.spec.query import parse_query
from tests.conftest import make_test_image
from tests.test_torch_icc import cmyk_jpeg, make_cmyk_profile

CPU = torch.device("cpu")
GOLDEN = os.path.abspath(os.path.join(os.path.dirname(__file__), "golden"))
QUERIES = ["w=300&h=200", "w=120&h=90&blur=1", "w=160&h=100&grayscale=true"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jpeg_bytes(img=None, quality=92, **kw):
    buf = io.BytesIO()
    Image.fromarray(img if img is not None else make_test_image()).save(
        buf, format="JPEG", quality=quality, **kw)
    return buf.getvalue()


def _png_bytes(img=None):
    buf = io.BytesIO()
    Image.fromarray(img if img is not None else make_test_image()).save(
        buf, format="PNG")
    return buf.getvalue()


def _oriented_jpeg(w, h, orientation):
    pil = Image.fromarray(make_test_image(w, h))
    exif = pil.getexif()
    exif[0x0112] = orientation
    buf = io.BytesIO()
    pil.save(buf, format="JPEG", exif=exif, quality=95)
    return buf.getvalue()


def _cached_engine(mb=64, **kw):
    e = Engine(CPU, **kw)
    e.source_cache = tsc.SourceCache(mb)
    return e


def _serve_all(engine, data, queries=QUERIES):
    return [engine.process_image(data, parse_query(q), Format())[1]
            for q in queries]


def test_coef_path_identical_and_hits():
    data = _jpeg_bytes()
    plain, cached = Engine(CPU), _cached_engine()
    want = _serve_all(plain, data)
    got = _serve_all(cached, data)
    assert got == want
    st = cached.source_cache.stats()
    # the source was read once; every later variant hit
    assert st["hits"] == len(QUERIES) - 1 and st["entries"] == 1, st
    assert cached.stats == plain.stats == {"pixel_src": 0,
                                           "coef_src": len(QUERIES)}


def test_pixel_path_identical_and_hits():
    data = _png_bytes()
    plain, cached = Engine(CPU), _cached_engine()
    assert _serve_all(cached, data) == _serve_all(plain, data)
    st = cached.source_cache.stats()
    assert st["hits"] == len(QUERIES) - 1, st
    assert cached.stats["pixel_src"] == plain.stats["pixel_src"] > 0


def test_exif_oriented_source_identical():
    data = _oriented_jpeg(128, 96, 6)
    plain, cached = Engine(CPU), _cached_engine()
    assert _serve_all(cached, data) == _serve_all(plain, data)
    assert cached.source_cache.stats()["hits"] == len(QUERIES) - 1


def test_interleaved_sources_stay_isolated():
    """Hits for one source never bleed into another, and repeated serves
    through a warm cache keep giving the first answer."""
    a = _jpeg_bytes(make_test_image(96, 64, seed=1))
    b = _jpeg_bytes(make_test_image(96, 64, seed=2))
    cached = _cached_engine()
    first = {k: _serve_all(cached, d) for k, d in (("a", a), ("b", b))}
    for _ in range(2):
        assert _serve_all(cached, a) == first["a"]
        assert _serve_all(cached, b) == first["b"]
    assert a != b and first["a"] != first["b"]


def test_pixel_entries_are_copies():
    cache = tsc.SourceCache(16)
    img = make_test_image(32, 32)
    key = tsc.content_key(b"some-source")
    cache.put_pixels("pix", key, img, False, False)
    img[:] = 0  # the caller writes its buffer after the put
    got, _, _ = cache.get_pixels("pix", key)
    assert got.any(), "put must store an isolated copy"
    assert got.flags.writeable
    got[:] = 0  # write the hit
    again, _, _ = cache.get_pixels("pix", key)
    assert again.any(), "get must hand out an isolated copy"
    stored = cache._lru.get(("pix", key))[0]
    assert not stored.flags.writeable


def test_eviction_respects_budget():
    cache = tsc.SourceCache(1)  # 1 MB
    big = np.zeros((512, 512, 3), np.uint8)  # 768 KB each
    cache.put_pixels("pix", b"a", big, False, False)
    cache.put_pixels("pix", b"b", big, False, False)
    st = cache.stats()
    assert st["evictions"] >= 1
    assert st["bytes"] <= st["max_bytes"]
    assert cache.get_pixels("pix", b"a") is None  # LRU went first
    assert cache.get_pixels("pix", b"b") is not None


def _sequence(mod):
    """One put/get sequence over every entry kind, through `mod`'s
    SourceCache; returns its stats and what each get found."""
    cache = mod.SourceCache(1)
    rng = np.random.default_rng(5)
    found = []
    for i in range(40):
        key = mod.content_key(b"src%d" % (i % 7))
        size = int(rng.integers(100, 500))
        op = i % 5
        if op == 0:
            cache.put_pixels("pix", key, np.zeros((size, size, 3), np.uint8),
                             False, False)
        elif op == 1:
            cache.put_meta("coef", key, {"y": np.zeros((size, 64), np.int16),
                                         "w": size})
        elif op == 2:
            cache.put_frames(key, [np.zeros((size, 8, 4), np.uint8)] * 3)
        else:
            found.append((cache.get_pixels("pix", key) is not None,
                          cache.get_meta("coef", key) is not None,
                          cache.get_frames(key) is not None))
    return cache.stats(), found


def test_stats_match_jax_on_one_sequence():
    got, got_found = _sequence(tsc)
    want, want_found = _sequence(jsc)
    assert got_found == want_found
    assert got == want
    assert got["hits"] and got["misses"] and got["evictions"], got
    assert tsc.content_key(b"x") == jsc.content_key(b"x")


def test_lut_attach_never_mutates_cached_meta():
    """The CMYK LUT attach copies the shared meta: the cached dict stays
    LUT-free (the LUT is per-request state), and bodies equal the
    uncached Engine's on the device-LUT route and on host lcms2."""
    conv = icc.CMYK2RGB.with_icc_profile(make_cmyk_profile(0))
    data = cmyk_jpeg(96, 64, seed=3)
    key = tsc.content_key(data)
    for device_icc in (True, False):
        plain = Engine(CPU, cmyk2rgb=conv)
        cached = _cached_engine(cmyk2rgb=conv)
        if device_icc:
            plain.enable_device_icc()
            cached.enable_device_icc()
        assert _serve_all(cached, data) == _serve_all(plain, data)
        assert cached.stats == plain.stats
        meta = cached.source_cache.get_meta("coef4", key)
        if device_icc:
            assert meta is not None and meta.get("cmyk")
            assert not {"lut_flat", "lut_n", "lut_key"} & set(meta)
            assert cached.stats["coef_src"] == len(QUERIES)
        else:
            # host lcms2: the converted pixels are cached instead
            assert meta is None
            assert cached.source_cache.get_pixels("icc", key) is not None
            assert cached.source_cache.stats()["hits"] >= len(QUERIES) - 1


def test_config_knob_parses():
    for cls in (TpuConfig, JTpuConfig):
        assert cls.from_obj({"source_cache_mb": 32}).source_cache_mb == 32
        assert cls.from_obj({}).source_cache_mb == 0
    with pytest.raises(ConfigError):
        TpuConfig.from_obj({"source_cache_mb": "lots"})


def test_gif_frames_identical_and_hit():
    with open(os.path.join(GOLDEN, "lenna_src.gif"), "rb") as f:
        data = f.read()
    plain, cached = Engine(CPU), _cached_engine()
    qs = ["w=100&h=80", "w=60&h=40"]
    want = _serve_all(plain, data, qs)
    got = _serve_all(cached, data, qs)
    assert got == want
    st = cached.source_cache.stats()
    assert st["hits"] >= 1 and st["entries"] == 1, st
    # a third serve through the warm cache stays byte-stable
    assert _serve_all(cached, data, qs[:1]) == got[:1]


def test_oriented_meta_cached_post_rotation():
    """EXIF-oriented hot sources cache the oriented meta (the kind
    carries the orientation), and no unoriented entry competes for the
    budget."""
    data = _oriented_jpeg(128, 96, 6)
    cached = _cached_engine()
    first = _serve_all(cached, data)
    assert _serve_all(cached, data) == first
    meta = cached.source_cache.get_meta("coef.o6", tsc.content_key(data))
    assert meta is not None, "oriented meta not cached"
    assert (meta["w"], meta["h"]) == (96, 128)
    assert cached.source_cache.get_meta("coef", tsc.content_key(data)) is None


def test_non_grid_exact_rotation_caches_pixel_sentinel():
    """A rotation that is not grid-exact (a flip of a width that is not
    a multiple of 16) caches a pixel-only sentinel: later variants go
    straight to pixels, with the uncached Engine's bytes."""
    data = _oriented_jpeg(132, 96, 2)
    plain, cached = Engine(CPU), _cached_engine()
    assert _serve_all(cached, data) == _serve_all(plain, data)
    sentinel = cached.source_cache.get_meta("coef.o2", tsc.content_key(data))
    assert sentinel == {"_pixel_only": True}
    assert cached.stats["pixel_src"] == plain.stats["pixel_src"] == 3


def test_sentinel_entries_stay_byte_budgeted():
    """`_pixel_only` sentinels carry no arrays; the per-entry overhead
    keeps them byte-budgeted, as in the JAX package."""
    assert tsc._ENTRY_OVERHEAD == jsc._ENTRY_OVERHEAD
    cap = (1024 * 1024) // tsc._ENTRY_OVERHEAD
    for mod in (tsc, jsc):
        cache = mod.SourceCache(1)  # 1 MiB
        for i in range(cap + 500):
            cache.put_meta("coef", b"%032d" % i, {"_pixel_only": True})
        st = cache.stats()
        assert st["entries"] <= cap, st
        assert st["evictions"] >= 500, st
        assert st["bytes"] <= st["max_bytes"], st


def _fallback_state(images):
    class _State:
        fallback_images = images

    return _State()


def test_shapes_from_state_matches_jax():
    """The warmup shapes a deployment implies, from its fallback images
    (capped, deduplicated, undecodable ones skipped) or its configured
    shapes, equal the JAX package's."""
    imgs = {f"f{i}": _png_bytes(make_test_image(40 + 8 * i, 30 + 4 * i))
            for i in range(6)}
    imgs["dup"] = _png_bytes(make_test_image(40, 30))
    imgs["junk"] = b"not an image"
    imgs["default"] = _png_bytes(make_test_image(512, 512))
    state = _fallback_state(imgs)
    got = twarmup.shapes_from_state(state)
    assert got == jwarmup.shapes_from_state(state)
    assert len(got) == len(twarmup.DEFAULT_SHAPES) + 4
    configured = ((64, 48, "w=32&h=24"),)
    assert (twarmup.shapes_from_state(state, configured)
            == jwarmup.shapes_from_state(state, configured))
    assert twarmup.DEFAULT_SHAPES == jwarmup.DEFAULT_SHAPES


def test_server_stats_show_source_cache():
    """tpu.source_cache_mb through build_state: three variants of one
    source over HTTP read it once, /stats shows caches.sources, and the
    bodies equal a server without the cache."""
    def raw(tpu):
        return {
            "port": 0, "bind_addr": "127.0.0.1", "max_clients": 8,
            "client": {"s3": {"aws_region": "x"},
                       "web": {"user_agent": "t", "timeout": 2}},
            "providers": [{"path": "baz", "src": "file://localhost" + GOLDEN}],
            "tpu": tpu}

    async def serve(tpu):
        cfg = Config.from_obj(raw(tpu))
        client = TestClient(TestServer(create_app(cfg, await build_state(
            cfg, device=CPU))))
        await client.start_server()
        try:
            bodies = []
            for q in QUERIES:
                r = await client.get("/baz/lenna_src.jpg?" + q)
                assert r.status == 200
                bodies.append(await r.read())
            stats = json.loads(await (await client.get("/stats")).text())
            return bodies, stats
        finally:
            await client.close()

    got, stats = asyncio.run(serve({"source_cache_mb": 64}))
    want, off = asyncio.run(serve({}))
    assert got == want
    assert off["caches"]["sources"] is None
    st = stats["caches"]["sources"]
    assert (st["hits"], st["misses"], st["entries"]) == (2, 1, 1), st
