"""The schedule from the seed, latency from the due time against a
stalled stub server, and failures counted past any limit."""

import asyncio
import math
import time

import numpy as np
import pytest

from harness import loadgen, readers

TRAFFIC = {"loop": "open", "rate": 200.0,
           "queries": [{"query": "w=1", "weight": 2}, {"query": "w=2"}]}


def test_pairs_are_whole_shuffled_rounds():
    a = loadgen.pairs(TRAFFIC, ["x", "y"], 7)
    rounds = [[next(a) for _ in range(6)] for _ in range(3)]
    for r in rounds:
        assert sorted(r) == sorted([("x", "w=1"), ("x", "w=1"), ("y", "w=1"),
                                    ("y", "w=1"), ("x", "w=2"), ("y", "w=2")])
    b = loadgen.pairs(TRAFFIC, ["x", "y"], 7)
    assert [next(b) for _ in range(18)] == sum(rounds, [])
    c = loadgen.pairs(TRAFFIC, ["x", "y"], 2**31 + 11)
    assert [next(c) for _ in range(18)] != sum(rounds, [])


def test_poisson_gaps_same_set_other_order():
    g1 = loadgen.poisson_gaps(250.0, 12.0, 1)
    g2 = loadgen.poisson_gaps(250.0, 12.0, 2**33 + 5)
    assert len(g1) == len(g2) == 3000
    assert np.allclose(np.sort(g1), np.sort(g2))
    assert not np.allclose(g1, g2)
    assert g1.sum() == pytest.approx(12.0)
    assert np.mean(g1) == pytest.approx(1 / 250.0)
    # exponential: the spread of the gaps is about their mean
    assert np.std(g1) == pytest.approx(1 / 250.0, rel=0.05)
    assert np.array_equal(g1, loadgen.poisson_gaps(250.0, 12.0, 1))


class _Stub:
    """An HTTP server that answers one request at a time, in 5 ms, and
    stalls `stall_s` on its first; paths containing 'bad' get 500."""

    def __init__(self, stall_s: float):
        self.stall_s = stall_s
        self.first = True

    async def start(self):
        from aiohttp import web

        lock = asyncio.Lock()

        async def handle(request):
            async with lock:
                if self.first:
                    self.first = False
                    await asyncio.sleep(self.stall_s)
                await asyncio.sleep(0.005)
            if "bad" in request.path:
                return web.Response(status=500, text="no")
            return web.Response(body=b"img", headers={
                "Server-Timing": "f_fetch;dur=0.1, f_process;dur=5.0"})

        app = web.Application()
        app.router.add_get("/{tail:.*}", handle)
        self.runner = web.AppRunner(app)
        await self.runner.setup()
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        await site.start()
        return f"http://127.0.0.1:{self.runner.addresses[0][1]}"


async def _open_run(stall_s, sources, rate=100.0, seconds=1.0):
    import aiohttp

    stub = _Stub(stall_s)
    base = await stub.start()
    try:
        async with aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(limit=0)) as s:
            client = loadgen.Client(s, base, "p", "")
            traffic = {"loop": "open", "rate": rate,
                       "queries": [{"query": "w=1"}]}
            return await loadgen.drive(client, traffic, sources, 3, seconds,
                                       time.perf_counter())
    finally:
        await stub.runner.cleanup()


def test_open_loop_times_from_due_and_shows_the_queue():
    recs = asyncio.run(_open_run(0.3, ["a.jpg"]))
    assert len(recs) == 100
    assert all(r.status == 200 for r in recs)
    first = recs[0]
    # every request due during the stall waits out the rest of it, and
    # its latency from the due time says so, though it was sent on time
    queued = [r for r in recs if r.due < first.due + 0.25]
    assert len(queued) >= 20
    for r in queued:
        assert r.sent - r.due < 0.05
        assert r.latency_s >= first.due + 0.3 - r.due
    # the backlog drains: late requests are fast again
    assert recs[-1].latency_s < 0.1
    p99 = readers.percentile([r.latency_s for r in recs], 99)
    assert p99 >= 0.3


def test_failures_count_past_any_limit():
    recs = asyncio.run(_open_run(0.0, ["a.jpg", "bad.jpg"], rate=50.0))
    bad = [r for r in recs if r.src == "bad.jpg"]
    assert bad and all(r.status == 500 for r in bad)
    assert all(math.isinf(r.latency_s) for r in bad)
    # half failed: every percentile past the half is past any limit
    lat = [r.latency_s for r in recs]
    assert len(bad) == len(recs) // 2
    assert math.isinf(readers.percentile(lat, 99))
    assert math.isinf(readers.percentile(lat, 51))
    assert readers.percentile(lat, 50) == max(v for v in lat
                                              if not math.isinf(v))


def test_unanswered_request_is_infinite():
    r = loadgen.Record("a", "q", due=1.0)
    assert math.isinf(r.latency_s)


def test_server_timing_parse():
    assert loadgen.parse_server_timing(
        "f_fetch;dur=0.3, f_decode;dur=5.1, f_device;dur=1.0, "
        "f_encode;dur=0.5, f_process;dur=6.9") == {
        "f_fetch": 0.3, "f_decode": 5.1, "f_device": 1.0, "f_encode": 0.5,
        "f_process": 6.9}


@pytest.fixture(scope="module")
def sweep():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_torch_sweep", loadgen.__file__.replace(
            "harness/loadgen.py", "sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sweep_finds_config_and_traffic_by_name(sweep):
    c = sweep.sweep_cell("readme-lenna", "readme-jpeg-open")
    assert c.traffic["loop"] == "open" and c.traffic["rate"] > 0
    assert c.config["provider"] == "baz"
    assert c.end_to_end == [] and c.per_layer == []


def test_knee_stops_at_the_first_rate_that_fails(sweep):
    def line(rate, done, growth):
        return {"rate": rate, "offered_per_s": rate,
                "completed_per_s": done, "backlog_growth": growth}

    # the sweep of call 5 in PERF.md: 85 rps grew by 1.30
    lines = [line(100, 99.9, 0.97), line(70, 70, 0.98), line(85, 85, 1.30),
             line(160, 159.7, 1.02)]
    assert sweep.knee(lines) == 70
    assert sweep.knee([line(70, 68, 1.0)]) == 0
    assert sweep.knee([line(70, 70, None)]) == 0
