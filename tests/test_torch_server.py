"""The port's HTTP gateway (fanlin_tpu_torch.server.app) through
aiohttp's TestClient on the CPU, over the file origin — the request
semantics of tests/test_server.py: ping, transforms, 404, 400 on a bad
query, options the port lacks refused at startup — and its micro-batcher:
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

from fanlin_tpu.config import Config, ConfigError
from fanlin_tpu.spec import query as query_mod
from fanlin_tpu_torch import cli
from fanlin_tpu_torch.ops.plan import plan_image
from fanlin_tpu_torch.server.app import (STATE_KEY, build_state, check_ported,
                                         create_app)

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
            assert stats["engine"] == {"pixel_src": 0, "coef_src": 3}
            # the CPU runs the plain versions: no kernel launches
            assert stats["kernel_launches"] == {
                "resample": 0, "resample_blur": 0, "jpeg_islow": 0,
                "jpeg_upsample_rgb": 0}
        finally:
            await client.close()

    asyncio.run(body())


@pytest.mark.parametrize("tpu,extra", [
    ('{"device_dct": true}', ""),
    ('{"fast_decode": true}', ""),
    ('{"device_icc": true}', ""),
    ('{"workers": 2}', ""),
    ('{"data_parallel": true}', ""),
    ('{"source_cache_mb": 8}', ""),
    ("{}", ', "profile_path": "/nonexistent.icc"'),
])
def test_unported_options_refused_at_startup(tpu, extra):
    cfg = _config(tpu, extra)
    with pytest.raises(ConfigError, match="not yet supported"):
        check_ported(cfg)
    with pytest.raises(ConfigError):
        asyncio.run(build_state(cfg, device=CPU))
    assert cli.main(["-j", json.dumps(_raw(tpu, extra))]) == 1


def test_default_config_accepted():
    check_ported(_config())


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
                "queue_wait_ms_total", "queue_wait_ms_peak",
                "upload_bytes"} <= set(stats["batcher"])
        plan = plan_image(8, 8, query_mod.parse_query(""), opaque=True)
        with pytest.raises(RuntimeError, match="batcher closed"):
            batcher.submit(plan, np.zeros((8, 8, 3), np.uint8))

    asyncio.run(body())
