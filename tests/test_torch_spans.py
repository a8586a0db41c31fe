"""The port's own spans and counters (fanlin_tpu_torch/utils/profiling.py,
the gateway, the engine and the micro-batcher), on the CPU: a capture of
a server under concurrent requests holds every span on its kind of
thread, each batch's spans name the requests they served, and the spans
account for the time of a request and of its device stage; `GET
/profile`'s file holds them; a span around a torch op encloses it in the
exported trace on the profiler's clock; with no capture running nothing
is recorded and no profiler function is called; the /stats counters move
by what was done and lose no update across threads. The captures' spans
are read with the benchmark's own reader (bench_torch/harness/spans.py)."""

import asyncio
import functools
import json
import signal
import statistics
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import fanlin_tpu_torch.server.app as app_mod
from fanlin_tpu_torch.config import Config
from fanlin_tpu_torch.engine.batcher import MicroBatcher
from fanlin_tpu_torch.ops import fused
from fanlin_tpu_torch.ops import plan as plan_mod
from fanlin_tpu_torch.spec.query import parse_query
from fanlin_tpu_torch.utils import profiling
from tests.conftest import make_test_image

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "bench_torch"))
from harness import spans as hspans  # noqa: E402

CPU = torch.device("cpu")
GOLDEN = Path(__file__).resolve().parent / "golden"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def time_limit(seconds: float):
    """Fail the test (TimeoutError in its thread) past `seconds` instead
    of hanging its xdist worker."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            def expire(_sig, _frame):
                raise TimeoutError(f"{fn.__name__} ran past its {seconds} s "
                                   "limit")

            old = signal.signal(signal.SIGALRM, expire)
            signal.setitimer(signal.ITIMER_REAL, seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.setitimer(signal.ITIMER_REAL, 0)
                signal.signal(signal.SIGALRM, old)
        return run
    return deco


def _cfg(prof_dir, tpu: str = "") -> Config:
    return Config.from_str("""{
  "port": 0, "bind_addr": "127.0.0.1", "max_clients": 3,
  "client": {"s3": {"aws_region": "x"},
             "web": {"user_agent": "t", "timeout": 2}},
  "providers": [{"path": "baz", "src": "file://localhost%s"}],
  "tpu": {"warmup": false, "profile_dir": "%s", "codec_threads": 3,
          "batch_window_ms": 20 %s}
}""" % (GOLDEN, prof_dir, tpu))


async def _client(cfg) -> TestClient:
    state = await app_mod.build_state(cfg, device=CPU)
    client = TestClient(TestServer(app_mod.create_app(cfg, state)))
    await client.start_server()
    return client


# geometries no other test asks for: the first request of each misses
# the plan caches, so the capture holds a rebuild and a pageable upload
QUERIES = ["w=123&h=77", "w=123&h=77", "w=97&h=61", "w=97&h=61",
           "w=123&h=77", "w=97&h=61"]

# span -> (the thread it is recorded on, complete event on it or not)
THREAD_OF = {
    "fanlin.request": ("loop", False),
    "fanlin.gateway.admit": ("loop", False),
    "fanlin.origin.fetch": ("loop", False),
    "fanlin.engine.pool_return": ("loop", False),
    "fanlin.engine.pool_wait": ("fanlin-codec", False),
    "fanlin.assembly.prestage": ("fanlin-codec", False),
    "fanlin.engine.decode": ("fanlin-codec", True),
    "fanlin.engine.read": ("fanlin-codec", True),
    "fanlin.engine.device": ("fanlin-codec", True),
    "fanlin.engine.encode": ("fanlin-codec", True),
    "fanlin.batcher.handoff": ("fanlin-codec", False),
    "fanlin.batcher.queue": ("fanlin-device", False),
    "fanlin.batcher.stage": ("fanlin-device", True),
    "fanlin.batcher.permit_wait": ("fanlin-device", True),
    "fanlin.batcher.submit": ("fanlin-device", True),
    "fanlin.assembly.rebuild": ("fanlin-device", True),
    "fanlin.assembly.pageable_upload": ("fanlin-device", True),
    "fanlin.batcher.device_wait": ("fanlin-collect", True),
    "fanlin.batcher.unpack": ("fanlin-collect", True),
}


@pytest.fixture(scope="module")
def captured(tmp_path_factory):
    """A capture (`profiling.exclusive`, exported as `GET /profile`
    exports it) of a CPU server answering QUERIES, two at a time, held
    open until every answer is in however loaded the machine is: (the
    capture's spans, the event loop's thread name)."""
    path = str(tmp_path_factory.mktemp("traces") / "capture.json")
    cfg = _cfg(tmp_path_factory.mktemp("profile_dir"),
               ', "response_cache_mb": 0')
    opened, done, held = threading.Event(), threading.Event(), []

    def hold():
        with profiling.exclusive(cuda=False) as prof:
            opened.set()
            done.wait(300)
        held.append(prof)

    async def go():
        client = await _client(cfg)
        holder = threading.Thread(target=hold)
        try:
            holder.start()
            assert await asyncio.to_thread(opened.wait, 60)
            sem = asyncio.Semaphore(2)

            async def one(q):
                async with sem:
                    return await client.get("/baz/lenna_src.jpg?" + q)

            got = await asyncio.gather(*(one(q) for q in QUERIES))
            assert [r.status for r in got] == [200] * len(QUERIES)
            return threading.current_thread().name
        finally:
            done.set()
            await asyncio.to_thread(holder.join, 60)
            await client.close()

    loop_thread = asyncio.new_event_loop().run_until_complete(go())
    profiling.export(held[0], path)
    return hspans.Spans.load(path), loop_thread


@time_limit(120)
def test_profile_route_writes_spans_into_its_trace(tmp_path):
    """GET /profile's file holds the clock-sync annotations and the
    spans of a request answered during the capture."""
    cfg = _cfg(tmp_path)

    async def go():
        client = await _client(cfg)
        try:
            capture = asyncio.ensure_future(
                client.get("/profile?seconds=1.5"))
            await asyncio.sleep(0.3)
            assert (await client.get("/ping")).status == 200
            return (await (await capture).json())["trace_file"]
        finally:
            await client.close()

    spans = hspans.Spans.load(asyncio.new_event_loop().run_until_complete(
        go()))
    assert spans.start is not None
    pings = [s for s in spans.named("fanlin.request")
             if s.args["path"] == "/ping"]
    assert len(pings) == 1 and pings[0].args["status"] == 200
    assert spans.named("fanlin.gateway.admit")


@time_limit(120)
def test_capture_holds_every_span_on_its_thread(captured):
    spans, loop_thread = captured
    for name, (thread, complete) in THREAD_OF.items():
        got = spans.named(name)
        assert got, f"no {name} span in the capture"
        for s in got:
            where = s.args["thread"]
            want = loop_thread if thread == "loop" else thread
            assert where.startswith(want), (name, where)
            assert s.on_thread is complete, name
            assert s.dur >= 0
    images = {s.args["rid"] for s in spans.named("fanlin.request")
              if s.args["path"].startswith("/baz/")}
    assert len(images) == len(QUERIES)
    # a codec thread's stages carry their request's id as an arg
    for name in ("fanlin.engine.decode", "fanlin.engine.device",
                 "fanlin.engine.encode", "fanlin.engine.pool_wait",
                 "fanlin.assembly.prestage", "fanlin.engine.read",
                 "fanlin.batcher.queue", "fanlin.batcher.handoff"):
        assert {s.args["rid"] for s in spans.named(name)} == images, name
    # the reader's span lies inside its request's decode, with the bytes
    # it wrote, the stream's coding process and its scans (lenna_src.jpg
    # is baseline: one), and the slot's making inside it
    decode = {s.args["rid"]: s for s in spans.named("fanlin.engine.decode")}
    stage = {s.args["rid"]: s for s in spans.named("fanlin.assembly.prestage")}
    eps = 1.0  # µs, the trace's rounding
    for s in spans.named("fanlin.engine.read"):
        d, p = decode[s.args["rid"]], stage[s.args["rid"]]
        assert d.ts - eps <= s.ts <= p.ts + eps
        assert p.end <= s.end + eps and s.end <= d.end + eps
        assert s.args["bytes"] > 0
        assert s.args["progressive"] is False and s.args["scans"] == 1


@time_limit(120)
def test_batch_spans_name_the_requests_they_served(captured):
    spans, _ = captured
    images = {s.args["rid"] for s in spans.named("fanlin.request")
              if s.args["path"].startswith("/baz/")}
    batch_of = {s.args["rid"]: s.args["batch"]
                for s in spans.named("fanlin.batcher.queue")}
    for name in hspans.BATCH_PARTS:
        served = set()
        for s in spans.named(name):
            assert s.args["n"] == len(s.args["rids"]) >= 1
            assert set(s.args["rids"]) <= images
            assert all(batch_of[r] == s.args["batch"] for r in s.args["rids"])
            assert s.args["cpu_ms"] >= 0
            served |= set(s.args["rids"])
        assert served == images, name
    submits = spans.named("fanlin.batcher.submit")
    assert sum(s.args.get("pageable_uploads", 0) for s in submits) == len(
        spans.named("fanlin.assembly.pageable_upload"))
    assert sum(s.args.get("plan_rebuilds", 0) for s in submits) == len(
        spans.named("fanlin.assembly.rebuild"))
    assert all(u.args["bytes"] > 0
               for u in spans.named("fanlin.assembly.pageable_upload"))


@time_limit(120)
def test_spans_account_for_a_request_and_its_device_stage(captured):
    """A request's children leave little of it unexplained once the way
    back from the codec thread is counted, and a device stage's queue,
    batch phases and hand-back leave little of it (the thresholds of
    PERF.md, met by most requests on a loaded CPU)."""
    spans, _ = captured
    req = hspans.request_residuals(spans, with_return=True)
    dev = hspans.device_residuals(spans)
    assert len(req) == len(dev) == len(QUERIES)
    assert hspans.covered_share(req, 1000.0) >= 0.8
    assert hspans.covered_share(dev, 500.0) >= 0.8
    # no child outlasts its parent by more than the clocks' rounding
    assert all(r > -5.0 for _, r in req + dev)


@time_limit(60)
def test_span_encloses_the_torch_op_it_wraps(tmp_path):
    """On the profiler's clock a span around a torch op encloses the op,
    each end within 50 µs of it (the median of 20, after a warm-up)."""
    x = torch.zeros(256)
    with profiling.exclusive(cuda=False) as prof:
        for i in range(25):
            with profiling.span("test.enclose", i=i):
                x.add_(1)
            time.sleep(0.001)
    path = str(tmp_path / "enclose.json")
    profiling.export(prof, path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    wrapped = {e["args"]["i"]: e for e in events
               if e.get("name") == "test.enclose"}
    ops = sorted((e for e in events if e.get("name") == "aten::add_"),
                 key=lambda e: e["ts"])
    assert len(wrapped) == 25 and len(ops) == 25
    heads, tails = [], []
    for i, op in enumerate(ops):
        s = wrapped[i]
        head = op["ts"] - s["ts"]
        tail = (s["ts"] + s["dur"]) - (op["ts"] + op["dur"])
        assert head >= 0 and tail >= 0, (i, head, tail)
        if i >= 5:
            heads.append(head)
            tails.append(tail)
    assert statistics.median(heads) <= 50.0, heads
    assert statistics.median(tails) <= 50.0, tails


@time_limit(120)
def test_no_capture_records_nothing_and_calls_no_profiler(tmp_path,
                                                          monkeypatch):
    """100 requests with no capture running: no span record, no call to
    a profiler function, the span of a block the shared no-op object;
    the gateway's and the engine's counters count every request, and
    t_ms moves on."""
    cfg = _cfg(tmp_path, ', "response_cache_mb": 0')
    calls, seen = [], []

    def refuse(*a, **k):
        calls.append(a)
        raise AssertionError("a profiler function was called")

    real_record = profiling.record

    def watched(*a, **k):
        seen.append(a[0])
        return real_record(*a, **k)

    async def go():
        # the server's start-up capture (`profiling.prepare`) comes first
        client = await _client(cfg)
        monkeypatch.setattr(torch.profiler, "record_function", refuse)
        monkeypatch.setattr(torch.autograd.profiler, "record_function",
                            refuse)
        monkeypatch.setattr(torch.autograd, "_profiler_enabled", refuse)
        monkeypatch.setattr(profiling, "record", watched)
        try:
            before = await (await client.get("/stats")).json()
            for i in range(10):
                got = await asyncio.gather(*(client.get(
                    "/baz/lenna_src.jpg?w=30&h=20") for _ in range(10)))
                assert all(r.status == 200 for r in got)
            after = await (await client.get("/stats")).json()
            return before, after
        finally:
            await client.close()

    before, after = asyncio.new_event_loop().run_until_complete(go())
    assert not calls
    assert profiling._RECORDS is None and not profiling.on()
    assert profiling.span("x", a=1) is profiling.span("y")
    # the engine's and batcher's own calls check on() first: the few
    # record() calls that happen are the unguarded span exits, none
    assert seen == []
    # 100 images and the second /stats read
    assert after["gateway"]["requests"] - before["gateway"]["requests"] == 101
    assert after["engine"]["requests"] - before["engine"]["requests"] == 100
    assert after["gateway"]["admit_wait_ms_total"] >= \
        before["gateway"]["admit_wait_ms_total"]
    assert after["engine"]["pool_wait_ms_total"] > \
        before["engine"]["pool_wait_ms_total"]
    assert after["t_ms"] > before["t_ms"]
    b = {k: after["batcher"][k] - before["batcher"][k]
         for k in ("images", "handoff_ms_total", "device_wait_ms_total")}
    assert b["images"] == 100
    assert b["handoff_ms_total"] > 0 and b["device_wait_ms_total"] > 0


@time_limit(120)
def test_counters_move_by_what_was_done(monkeypatch):
    """Each served batch is one stage span and moves `batches` by one;
    `pageable_uploads` and `pageable_bytes` count the matrices the
    misses of the device matrix cache upload, `plan_rebuilds` the misses
    of the padded plan cache; the phases' ms totals grow."""
    puts = {"device": [], "plan": 0}
    real_dev_put = fused._RESIDENT.put
    real_plan_put = plan_mod._UNIFORM_CACHE.put

    def dev_put(key, value, nbytes):
        # one entry a plan: its matrices (bv, bh None without blur)
        puts["device"] += [m.numel() * m.element_size() for m in value
                           if m is not None]
        return real_dev_put(key, value, nbytes)

    def plan_put(key, value, nbytes):
        puts["plan"] += 1
        return real_plan_put(key, value, nbytes)

    monkeypatch.setattr(fused._RESIDENT, "put", dev_put)
    monkeypatch.setattr(plan_mod._UNIFORM_CACHE, "put", plan_put)
    b = MicroBatcher(max_batch=4, window_ms=5.0, device=CPU)
    img = make_test_image(80, 60)
    img = np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)],
                         axis=2)
    try:
        s0 = dict(b.stats)
        with profiling.exclusive(cuda=False) as prof:
            for w, h in ((41, 29), (43, 31), (41, 29), (47, 23)):
                plan = plan_mod.plan_image(80, 60,
                                           parse_query(f"w={w}&h={h}"))
                b.submit(plan, img).result(timeout=30)
        s1 = dict(b.stats)
    finally:
        assert b.close()
    d = {k: s1[k] - s0[k] for k in s0 if isinstance(s0[k], (int, float))}
    names = [r[0] for r in prof.fanlin_spans]
    assert d["batches"] == 4 == names.count("fanlin.batcher.stage")
    assert names.count("fanlin.batcher.submit") == 4
    assert names.count("fanlin.batcher.queue") == d["images"] == 4
    assert d["pageable_uploads"] == len(puts["device"]) >= 3
    assert d["pageable_bytes"] == sum(puts["device"]) > 0
    assert d["plan_rebuilds"] == puts["plan"] == 3
    assert names.count("fanlin.assembly.rebuild") == 3
    for k in ("stage_ms_total", "submit_ms_total", "unpack_ms_total",
              "device_wait_ms_total", "queue_wait_ms_total"):
        assert d[k] > 0, k
    assert d["permit_wait_ms_total"] >= 0


@time_limit(60)
def test_counters_and_records_lose_no_update_across_threads():
    """16 threads (more than the cores) note pool waits and record spans
    at a shortened switch interval while a capture runs: every one is
    counted and recorded."""
    from fanlin_tpu_torch.engine import Engine

    engine = Engine(CPU)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.exclusive(cuda=False) as prof:
            def work():
                for _ in range(500):
                    t = time.perf_counter_ns()
                    engine.note_pool_wait(t, t + 1_000_000)
            threads = [threading.Thread(target=work) for _ in range(16)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(30)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert engine.pool_stats["requests"] == 8000
    assert engine.pool_stats["pool_wait_ms_total"] == pytest.approx(8000.0)
    assert [r[0] for r in prof.fanlin_spans].count(
        "fanlin.engine.pool_wait") == 8000


@time_limit(120)
def test_prestaged_counter_and_its_metric(tmp_path):
    """/stats counts the images a codec thread staged (`prestaged`, next
    to `images`), and the benchmark's `assembly.prestaged_share` reads
    it as a share of the window's images: every JPEG of a CPU server
    with free slots. Likewise the JPEGs the reader wrote straight into
    their slot (`engine.slot_reads`, next to `coef_src`), which
    `engine.slot_read_share` reads: every one of them; and the reader's
    decodes (`reads`), scans and ms, which `engine.read_ms`,
    `engine.progressive_share` and `engine.scans_per_read` read."""
    from types import SimpleNamespace

    from harness import cell as hcell

    cfg = _cfg(tmp_path, ', "response_cache_mb": 0')

    async def go():
        client = await _client(cfg)
        try:
            before = json.loads(await (await client.get("/stats")).text())
            for q in ("w=61&h=41", "w=59&h=43", "w=61&h=41"):
                r = await client.get("/baz/lenna_src.jpg?" + q)
                assert r.status == 200
            after = json.loads(await (await client.get("/stats")).text())
            return before, after
        finally:
            await client.close()

    before, after = asyncio.new_event_loop().run_until_complete(go())
    assert before["batcher"]["prestaged"] == 0
    assert after["batcher"]["prestaged"] - before["batcher"]["prestaged"] == (
        after["batcher"]["images"] - before["batcher"]["images"]) == 3
    read = hcell.load_module("metrics", "assembly.prestaged_share").read
    assert read(SimpleNamespace(stats_before=before,
                                stats_after=after)) == 100.0
    assert before["engine"]["slot_reads"] == 0
    assert after["engine"]["slot_reads"] == after["engine"]["coef_src"] == 3
    read_slots = hcell.load_module("metrics", "engine.slot_read_share").read
    assert read_slots(SimpleNamespace(stats_before=before,
                                      stats_after=after)) == 100.0
    eng0, eng1 = before["engine"], after["engine"]
    assert eng0["reads"] == eng0["read_scans_total"] == 0
    assert eng1["reads"] == eng1["read_scans_total"] == 3  # baseline
    assert eng1["progressive_reads"] == 0
    assert eng1["read_ms_total"] > eng0["read_ms_total"] == 0.0
    window = SimpleNamespace(stats_before=before, stats_after=after)
    readers = {name: hcell.load_module("metrics", name).read
               for name in ("engine.read_ms", "engine.progressive_share",
                            "engine.scans_per_read")}
    assert readers["engine.read_ms"](window) == pytest.approx(
        eng1["read_ms_total"] / 3)
    assert readers["engine.progressive_share"](window) == 0.0
    assert readers["engine.scans_per_read"](window) == 1.0
    # a server without the counter (an older one) gives no reading
    for stats in (before, after):
        del stats["batcher"]["prestaged"]
        del stats["engine"]["slot_reads"]
        del stats["engine"]["reads"]
    for name, reader in readers.items():
        assert reader(window) is None, name
    assert read(SimpleNamespace(stats_before=before,
                                stats_after=after)) is None
    assert read_slots(SimpleNamespace(stats_before=before,
                                      stats_after=after)) is None
