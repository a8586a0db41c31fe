"""The port's HTTP gateway (fanlin_tpu_torch.server.app) through
aiohttp's TestClient on the CPU, over the file origin — the request
semantics of tests/test_server.py: ping, transforms, 404, 400 on a bad
query, options the port lacks refused at startup and the scale-out ones
accepted — and its micro-batcher:
coalescing, 503 on overload, 408 on an expired deadline, /stats and
cleanup."""

import asyncio
import io
import json
import os

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from fanlin_tpu_torch import cli
from fanlin_tpu_torch.config import Config, ConfigError
from fanlin_tpu_torch.engine import Engine
from fanlin_tpu_torch.ops.plan import plan_image
from fanlin_tpu_torch.server.app import (STATE_KEY, build_state, check_ported,
                                         create_app)
from fanlin_tpu_torch.spec import query as query_mod
from fanlin_tpu_torch.spec.content import Format

GOLDEN = os.path.abspath(os.path.join(os.path.dirname(__file__), "golden"))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _raw(tpu: str = "{}", extra: str = "") -> dict:
    return json.loads("""{
  "port": 0, "bind_addr": "127.0.0.1", "max_clients": 8,
  "client": {"s3": {"aws_region": "x"},
             "web": {"user_agent": "fanlin-test/0", "timeout": 2}},
  "providers": [{"path": "baz", "src": "file://localhost%s"}],
  "tpu": %s %s
}""" % (GOLDEN, tpu, extra))


def _config(tpu: str = "{}", extra: str = "") -> Config:
    return Config.from_obj(_raw(tpu, extra))


async def _client(cfg) -> TestClient:
    state = await build_state(cfg, device=CPU)
    client = TestClient(TestServer(create_app(cfg, state)))
    await client.start_server()
    return client


def test_gateway_requests():
    async def body():
        client = await _client(_config('{"response_cache_mb": 4}'))
        try:
            r = await client.get("/ping")
            assert r.status == 200 and await r.text() == "pong"

            r = await client.get("/baz/lenna_src.jpg?w=300&h=200")
            assert r.status == 200
            assert r.headers["Content-Type"] == "image/jpeg"
            assert "f_process" in r.headers["Server-Timing"]
            with Image.open(io.BytesIO(await r.read())) as im:
                assert im.size == (300, 200)

            r = await client.get("/baz/lenna_src.jpg?w=300&h=200&webp=true"
                                 "&quality=20", headers={"Accept": "image/webp"})
            assert r.status == 200
            assert r.headers["Content-Type"] == "image/webp"
            assert r.headers["Vary"] == "Accept"

            r = await client.get("/baz/lenna_src.jpg?w=100&h=80&blur=1")
            assert r.status == 200

            # repeated request: served from the response cache
            r = await client.get("/baz/lenna_src.jpg?w=300&h=200")
            assert r.status == 200 and r.headers.get("X-Cache") == "hit"

            r = await client.get("/baz/missing.jpg?w=100&h=100")
            assert r.status == 404 and await r.text() == "not found"

            r = await client.get("/baz/lenna_src.jpg?w=abc")
            assert r.status == 400
            r = await client.get("/baz/lenna_src.jpg?w=100000&h=10")
            assert r.status == 400

            r = await client.post("/ping")
            assert r.status == 405

            r = await client.get("/stats")
            stats = json.loads(await r.text())
            # device_decode is on by default: JPEGs take the coefficient
            # path
            assert {k: stats["engine"][k] for k in ("pixel_src", "coef_src")
                    } == {"pixel_src": 0, "coef_src": 3}
            # the CPU runs the plain versions: no kernel launches
            assert stats["kernel_launches"] == {
                "resample": 0, "resample_blur": 0, "resample_fast": 0,
                "resample_blur_fast": 0, "jpeg_decode_rgb": 0,
                "jpeg_decode_cmyk": 0, "jpeg_decode_cmyk_rgb": 0,
                "cmyk_lut": 0}
        finally:
            await client.close()

    asyncio.run(body())


@pytest.mark.parametrize("tpu,extra", [
    ('{"fast_decode": true, "spectral_db": 30}', ""),
])
def test_unported_options_refused_at_startup(tpu, extra):
    cfg = _config(tpu, extra)
    with pytest.raises(ConfigError, match="not yet supported"):
        check_ported(cfg)
    with pytest.raises(ConfigError):
        asyncio.run(build_state(cfg, device=CPU))
    assert cli.main(["-j", json.dumps(_raw(tpu, extra))]) == 1


@pytest.mark.parametrize("tpu", [
    '{"fast": true}',
    '{"profile_dir": "fanlin-profile"}',
])
def test_fast_and_profile_dir_accepted_at_startup(tpu):
    """tpu.fast and tpu.profile_dir are ported (tests/test_torch_fast.py,
    tests/test_torch_profile.py): they pass the option check and build a
    state; fast reaches the batcher and the Engine, profile_dir adds the
    /profile route."""
    cfg = _config(tpu)
    check_ported(cfg)
    state = asyncio.run(build_state(cfg, device=CPU))
    try:
        assert state.engine.fast == state.engine.runner.fast == cfg.tpu.fast
        routes = {r.resource.canonical for r in
                  create_app(cfg, state).router.routes()}
        assert ("/profile" in routes) == bool(cfg.tpu.profile_dir)
    finally:
        assert state.engine.runner.batcher.close()


@pytest.mark.parametrize("tpu", [
    '{"fast_decode": true}',
    '{"data_parallel": true}',
    '{"data_parallel": true, "mesh_sp": 2}',
    '{"spectral_db": 30}',
])
def test_fast_decode_and_data_parallel_accepted_at_startup(tpu):
    """tpu.fast_decode (tests/test_torch_folded.py), data_parallel on one
    device (mesh_sp inert there, as in the reference) and spectral_db
    without fast_decode (it only warns: it never acts) start the
    server; fast_decode reaches the Engine."""
    cfg = _config(tpu)
    check_ported(cfg)
    state = asyncio.run(build_state(cfg, device=CPU))
    try:
        assert state.engine.fast_decode == cfg.tpu.fast_decode
    finally:
        assert state.engine.runner.batcher.close()


F2_URLS = ["/baz/lenna_src.jpg?w=300&h=200",
           "/baz/lenna_src.jpg?w=300&h=200&webp=true&quality=20",
           "/baz/lenna_src.jpg?w=100&h=80&blur=1",
           "/baz/synth_src.jpg?w=300&h=200"]


async def _bodies(tpu: str):
    client = await _client(_config(tpu))
    try:
        out = []
        for url in F2_URLS:
            r = await client.get(url, headers={"Accept": "image/webp"})
            assert r.status == 200, url
            out.append(await r.read())
        stats = json.loads(await (await client.get("/stats")).text())
        return out, stats
    finally:
        await client.close()


def test_data_parallel_serves_the_default_bodies_on_one_device():
    """The reference builds no mesh on one device: data_parallel serves
    exactly the default config's bytes there."""
    got, _ = asyncio.run(_bodies('{"data_parallel": true}'))
    want, _ = asyncio.run(_bodies("{}"))
    assert got == want


def test_data_parallel_refused_with_several_devices(monkeypatch):
    """With more than one device visible, data_parallel needs the mesh
    the port lacks: startup raises, naming the option and the count; the
    same count without data_parallel serves on the one given device."""
    from fanlin_tpu_torch import device as device_mod

    monkeypatch.setattr(device_mod, "device_count", lambda device: 2)
    with pytest.raises(ConfigError, match=r"tpu\.data_parallel with 2 "):
        asyncio.run(build_state(_config('{"data_parallel": true}'),
                                device=CPU))
    state = asyncio.run(build_state(_config(), device=CPU))
    assert state.engine.runner.batcher.close()


def test_fast_decode_serves_the_folded_route():
    """The server with fast_decode: every request answers 200 with the
    bytes of a serial Engine(fast_decode=True) and counts coef_src."""
    got, stats = asyncio.run(_bodies('{"fast_decode": true}'))
    assert {k: stats["engine"][k] for k in ("pixel_src", "coef_src")} == {
        "pixel_src": 0, "coef_src": len(F2_URLS)}
    engine = Engine(CPU, fast_decode=True)
    accepted = Format()
    accepted.accept_webp()
    for url, body in zip(F2_URLS, got):
        path, _, qs = url.partition("?")
        with open(os.path.join(GOLDEN, path.split("/")[-1]), "rb") as f:
            want = engine.process_image(f.read(), query_mod.parse_query(qs),
                                        accepted)[1]
        assert body == want, url


@pytest.mark.parametrize("tpu", ['{"workers": 2}', '{"source_cache_mb": 8}'])
def test_scale_out_options_accepted_at_startup(tpu):
    """tpu.workers and tpu.source_cache_mb are ported
    (tests/test_torch_workers.py and test_torch_source_cache.py serve
    with each): they pass the option check and build a state; the source
    cache hangs on the engine, and workers only matter to the CLI, which
    forks them."""
    cfg = _config(tpu)
    check_ported(cfg)
    state = asyncio.run(build_state(cfg, device=CPU))
    try:
        cache = state.engine.source_cache
        if cfg.tpu.source_cache_mb:
            assert cache.stats()["max_bytes"] == 8 * 1024 * 1024
        else:
            assert cache is None and cfg.tpu.workers == 2
    finally:
        assert state.engine.runner.batcher.close()


@pytest.mark.parametrize("tpu,extra", [
    ('{"device_icc": true}', ""),
    ("{}", ', "profile_path": "/nonexistent.icc"'),
    ("{}", ', "use_embedded_profile": true'),
])
def test_icc_options_accepted_at_startup(tpu, extra):
    """tpu.device_icc, profile_path and use_embedded_profile are ported
    (tests/test_torch_cmyk.py serves CMYK with each): they start the
    server. A profile_path that does not load only warns."""
    cfg = _config(tpu, extra)
    check_ported(cfg)
    state = asyncio.run(build_state(cfg, device=CPU))
    assert state.engine.cmyk2rgb is None and state.engine.device_cmyk is None
    assert state.engine.use_embedded_profile == ("use_embedded" in extra)


def test_default_config_accepted():
    check_ported(_config())


@pytest.mark.parametrize("device_decode", [True, False])
def test_device_dct_accepted(device_decode):
    """tpu.device_dct (and the inert dct_pack_floor) start the server,
    and a JPEG request leaves through the jpegdct sink with the bytes of
    a serial Engine(device_dct=True)."""
    tpu = ('{"device_dct": true, "dct_pack_floor": -1, "device_decode": %s}'
           % json.dumps(device_decode))
    check_ported(_config(tpu))

    async def body():
        client = await _client(_config(tpu))
        try:
            state = client.server.app[STATE_KEY]
            assert state.engine.device_dct
            r = await client.get("/baz/lenna_src.jpg?w=300&h=200")
            assert r.status == 200
            assert r.headers["Content-Type"] == "image/jpeg"
            return await r.read()
        finally:
            await client.close()

    got = asyncio.run(body())
    with open(os.path.join(GOLDEN, "lenna_src.jpg"), "rb") as f:
        want = Engine(CPU, device_decode=device_decode,
                      device_dct=True).process_image(
            f.read(), query_mod.parse_query("w=300&h=200"), Format())[1]
    assert got == want


def test_build_state_needs_cuda_by_default():
    """Without an explicit device the server runs on CUDA, and raises
    where there is none rather than serving from the CPU."""
    if torch.cuda.is_available():
        assert asyncio.run(build_state(_config())).engine.runner.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            asyncio.run(build_state(_config()))


async def _get_all(client, urls):
    async def one(url):
        r = await client.get(url)
        return r.status, await r.read()

    return await asyncio.gather(*(one(u) for u in urls))


def test_concurrent_requests_coalesce():
    """Eight concurrent requests for one transform ride fewer device
    batches, and each body equals a lone request's."""
    async def body():
        client = await _client(_config('{"batch_window_ms": 300}'))
        try:
            url = "/baz/lenna_src.jpg?w=300&h=200"
            got = await _get_all(client, [url] * 8)
            batcher = client.server.app[STATE_KEY].engine.runner.batcher
            stats = dict(batcher.stats)
            lone = await _get_all(client, [url])
        finally:
            await client.close()
        assert [s for s, _ in got] == [200] * 8
        assert stats["images"] == 8 and stats["batches"] < 8
        assert all(b == lone[0][1] for _, b in got)

    asyncio.run(body())


def test_max_queue_overload_answers_503():
    async def body():
        client = await _client(_config(
            '{"max_queue": 1, "max_batch": 64, "batch_window_ms": 1000}'))
        try:
            got = await _get_all(client, ["/baz/lenna_src.jpg?w=30&h=20"] * 3)
            stats = json.loads(await (await client.get("/stats")).text())
        finally:
            await client.close()
        assert sorted(s for s, _ in got) == [200, 503, 503]
        assert stats["batcher"]["rejected_overload"] == 2

    asyncio.run(body())


def test_expired_deadline_answers_408(monkeypatch):
    """A request whose deadline passes while it waits for its batch
    gets 408, and its entry is shed before any device work."""
    from fanlin_tpu_torch.server import app as app_mod

    monkeypatch.setattr(app_mod, "REQUEST_TIMEOUT_SECS", 0.3)

    async def body():
        client = await _client(_config('{"batch_window_ms": 1500}'))
        try:
            r = await client.get("/baz/lenna_src.jpg?w=30&h=20")
            assert r.status == 408
            batcher = client.server.app[STATE_KEY].engine.runner.batcher
            for _ in range(100):  # the window flushes the shed entry
                if batcher.stats["shed_cancelled"] + \
                        batcher.stats["shed_expired"]:
                    break
                await asyncio.sleep(0.05)
            assert batcher.stats["shed_cancelled"] + \
                batcher.stats["shed_expired"] == 1
            assert batcher.stats["batches"] == 0
        finally:
            await client.close()

    asyncio.run(body())


@pytest.mark.parametrize("exc,status", [("RequestExpired", 408),
                                        ("BatcherOverload", 503)])
def test_batcher_errors_map_to_status(exc, status):
    from fanlin_tpu_torch.engine import batcher as batcher_mod

    async def body():
        client = await _client(_config())
        state = client.server.app[STATE_KEY]

        async def raising(*a, **k):
            raise getattr(batcher_mod, exc)("shed")

        state.process_image_async = raising
        try:
            r = await client.get("/baz/lenna_src.jpg?w=30&h=20")
            assert r.status == status
        finally:
            await client.close()

    asyncio.run(body())


def test_stats_has_batcher_and_cleanup_closes_it():
    async def body():
        client = await _client(_config())
        try:
            r = await client.get("/baz/lenna_src.jpg?w=30&h=20")
            assert r.status == 200
            stats = json.loads(await (await client.get("/stats")).text())
            batcher = client.server.app[STATE_KEY].engine.runner.batcher
        finally:
            await client.close()
        assert stats["batcher"]["images"] == 1
        assert stats["batcher"]["batches"] == 1
        assert stats["batcher"]["pipeline_depth"] == 2
        assert {"full_flushes", "timer_flushes", "shed_expired",
                "shed_cancelled", "rejected_overload", "backlog",
                "queue_wait_ms_total", "stage_ms_total",
                "permit_wait_ms_total", "submit_ms_total",
                "device_wait_ms_total", "unpack_ms_total",
                "handoff_ms_total", "pageable_bytes", "pageable_uploads",
                "plan_rebuilds", "upload_bytes"} <= set(stats["batcher"])
        plan = plan_image(8, 8, query_mod.parse_query(""), opaque=True)
        with pytest.raises(RuntimeError, match="batcher closed"):
            batcher.submit(plan, np.zeros((8, 8, 3), np.uint8))

    asyncio.run(body())
