"""The port's HTTP gateway (fanlin_tpu_torch.server.app) through
aiohttp's TestClient on the CPU, over the file origin — the request
semantics of tests/test_server.py: ping, transforms, 404, 400 on a bad
query, and options the port lacks refused at startup."""

import asyncio
import io
import json
import os

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from fanlin_tpu.config import Config, ConfigError
from fanlin_tpu_torch import cli
from fanlin_tpu_torch.server.app import build_state, check_ported, create_app

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
            assert stats["engine"]["pixel_src"] == 3
            # the CPU runs the plain version: no kernel launches
            assert stats["kernel_launches"] == {"resample": 0,
                                                "resample_blur": 0}
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
