"""`tpu.profile_dir` in the port: `GET /profile?seconds=N` captures this
process with torch.profiler into the directory as a Chrome trace. Twins
of tests/test_middleware.py's five profile tests (the timeout
exemption's three cases, the capture, a capture longer than the request
timeout), on the CPU, with the port's server; and the single-flight
answers: 409 to a second request while one captures, and 409 while
another capture of the port (`utils.profiling.exclusive`) runs in the
process."""

import asyncio
import json
import os
import threading

from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

import fanlin_tpu_torch.server.app as app_mod
import torch
from fanlin_tpu_torch.config import Config
from fanlin_tpu_torch.server.app import make_timeout_middleware
from fanlin_tpu_torch.utils import profiling

CPU = torch.device("cpu")


def _profile_status(profile_route: bool, method: str = "GET") -> int:
    async def go():
        async def slow(_req):
            await asyncio.sleep(1.0)
            return web.Response(text="late")

        app = web.Application(middlewares=[
            make_timeout_middleware(0.05, profile_route=profile_route)
        ])
        app.router.add_route("*", "/{tail:.*}", slow)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            resp = await client.request(method, "/profile")
            return resp.status
        finally:
            await client.close()

    return asyncio.new_event_loop().run_until_complete(go())


def test_profile_timeout_exemption_requires_registered_route():
    """Without tpu.profile_dir there is no profile route: GET /profile is
    an image path like any other and keeps the timeout."""
    assert _profile_status(profile_route=False) == 408


def test_profile_timeout_exemption_is_get_only():
    """The route is GET only: a POST /profile falls to the image route
    and keeps the timeout."""
    assert _profile_status(profile_route=True, method="POST") == 408


def test_profile_timeout_exemption_applies_when_registered():
    """With the route registered a capture (up to 60 s) is not cut at
    the request timeout."""
    assert _profile_status(profile_route=True) == 200


def _cfg(fixtures_dir, prof: str) -> Config:
    return Config.from_str("""
{
  "port": 0, "bind_addr": "127.0.0.1", "max_clients": 4,
  "client": {"s3": {"aws_region": "x"},
             "web": {"user_agent": "t", "timeout": 2}},
  "providers": [{"path": "baz", "src": "file://localhost%s"}],
  "tpu": {"warmup": false, "profile_dir": "%s"}
}
""" % (fixtures_dir, prof))


async def _client(cfg) -> TestClient:
    state = await app_mod.build_state(cfg, device=CPU)
    client = TestClient(TestServer(app_mod.create_app(cfg, state)))
    await client.start_server()
    return client


def _trace_events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_profile_endpoint_captures_trace(fixtures_dir, tmp_path):
    """GET /profile?seconds=N writes a torch.profiler Chrome trace into
    tpu.profile_dir while requests are served."""
    prof = str(tmp_path / "traces")
    cfg = _cfg(fixtures_dir, prof)

    async def go():
        client = await _client(cfg)
        try:
            # work under the trace so it has content
            req = client.get("/baz/lenna.jpg?w=64&h=48")
            resp = await client.get("/profile?seconds=0.3")
            body = await resp.json()
            assert (await req).status == 200
            return resp.status, body
        finally:
            await client.close()

    status, body = asyncio.new_event_loop().run_until_complete(go())
    assert status == 200
    assert body["trace_dir"] == prof and body["seconds"] == 0.3
    found = [f for _root, _dirs, files in os.walk(prof) for f in files]
    assert found == [os.path.basename(body["trace_file"])]
    assert isinstance(_trace_events(body["trace_file"]), list)


def test_profile_exempt_from_request_timeout(fixtures_dir, tmp_path,
                                             monkeypatch):
    """A capture longer than the request timeout completes with 200,
    not a 408 answered while it still runs. Staged with a tiny
    timeout."""
    monkeypatch.setattr(app_mod, "REQUEST_TIMEOUT_SECS", 0.3)
    cfg = _cfg(fixtures_dir, str(tmp_path / "traces"))

    async def go():
        client = await _client(cfg)
        try:
            resp = await client.get("/profile?seconds=1.0")
            return resp.status, await resp.json()
        finally:
            await client.close()

    status, body = asyncio.new_event_loop().run_until_complete(go())
    assert status == 200
    assert body["seconds"] == 1.0


def test_concurrent_profile_gets_409_and_bad_seconds_400(fixtures_dir,
                                                         tmp_path):
    """One capture at a time: a second GET /profile while the first
    captures gets 409 at once; the first still completes. N that is no
    number is 400; N is clamped to 0.1-60."""
    cfg = _cfg(fixtures_dir, str(tmp_path / "traces"))

    async def go():
        client = await _client(cfg)
        try:
            first = asyncio.ensure_future(client.get("/profile?seconds=1.0"))
            await asyncio.sleep(0.3)
            second = await client.get("/profile?seconds=0.1")
            text = await second.text()
            r1 = await first
            bad = await client.get("/profile?seconds=abc")
            short = await client.get("/profile?seconds=0")
            return (second.status, text, r1.status, bad.status,
                    (await short.json())["seconds"])
        finally:
            await client.close()

    s2, text, s1, bad, clamped = \
        asyncio.new_event_loop().run_until_complete(go())
    assert (s2, s1, bad, clamped) == (409, 200, 400, 0.1)
    assert "already running" in text


def test_profile_while_another_capture_runs_gets_409(fixtures_dir,
                                                     tmp_path):
    """A capture of the port already running in the process (here one
    held open by another thread) makes GET /profile answer 409 with the
    reason, not start a second Kineto session; once it ends, /profile
    captures again."""
    cfg = _cfg(fixtures_dir, str(tmp_path / "traces"))
    opened, release = threading.Event(), threading.Event()

    def hold():
        with profiling.exclusive(cuda=False):
            opened.set()
            release.wait(30)

    holder = threading.Thread(target=hold)
    holder.start()
    assert opened.wait(30)

    async def go():
        client = await _client(cfg)
        try:
            busy = await client.get("/profile?seconds=0.1")
            text = await busy.text()
            release.set()
            await asyncio.to_thread(holder.join, 30)
            again = await client.get("/profile?seconds=0.1")
            return busy.status, text, again.status
        finally:
            await client.close()

    try:
        status, text, again = asyncio.new_event_loop().run_until_complete(go())
    finally:
        release.set()
        holder.join(30)
    assert (status, again) == (409, 200)
    assert "already running in this process" in text
