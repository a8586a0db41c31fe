"""The port's multi-worker gateway (fanlin_tpu_torch.server.workers,
`tpu.workers`) on the CPU: twins of tests/test_workers.py, and the
port's own rules.

N gateway workers share the port through SO_REUSEPORT around one
device service that owns the micro-batcher. Each server here boots in a
fresh subprocess (never a fork of this one) with the CPU device passed
to the CLI explicitly, and answers a provider path unique to its test:
a request that reaches another test's listener on a reused port gets
404 and fails loudly. Every wait is bounded and each server's process
group is killed in `finally`.
"""

import asyncio
import copy
import json
import os
import selectors
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from fanlin_tpu import config as jconfig
from fanlin_tpu_torch import config as tconfig
from fanlin_tpu_torch.engine import Engine
from fanlin_tpu_torch.engine import batcher as batcher_mod
from fanlin_tpu_torch.engine import native_codecs
from fanlin_tpu_torch.engine import warmup as warmup_mod
from fanlin_tpu_torch.engine.batcher import REQUEST_DEADLINE, RequestExpired
from fanlin_tpu_torch.ops import fused
from fanlin_tpu_torch.ops.plan import plan_image
from fanlin_tpu_torch.server import app as app_mod
from fanlin_tpu_torch.server import workers as w
from fanlin_tpu_torch.spec.query import parse_query

pytestmark = pytest.mark.skipif(
    not hasattr(socket, "SO_REUSEPORT"), reason="no SO_REUSEPORT")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
CPU = torch.device("cpu")
# one torch thread per process, as every port test here runs: several
# servers' processes share the CPU with the rest of the suite
BOOT = ("import sys, torch; torch.set_num_threads(1); "
        "from fanlin_tpu_torch.cli import main; "
        "sys.exit(main(sys.argv[1:], device=torch.device('cpu')))")
BOOT_S = 180.0


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _raw(port: int, path: str, tpu: dict) -> dict:
    return {
        "port": port, "bind_addr": "127.0.0.1", "max_clients": 8,
        "client": {"s3": {"aws_region": "x"},
                   "web": {"user_agent": "t", "timeout": 2}},
        "providers": [{"path": path, "src": "file://localhost" + GOLDEN}],
        "tpu": {"warmup": False, **tpu},
    }


class _Server:
    """The port's CLI in a subprocess of its own process group: waits
    for one device-service banner and `workers` worker banners (or the
    single-process one), then keeps draining its output."""

    def __init__(self, path: str, workers: int, **tpu):
        self.port = _free_port()
        self.path = path
        self.workers = workers
        raw = _raw(self.port, path, {"workers": workers, **tpu})
        self.proc = subprocess.Popen(
            [sys.executable, "-c", BOOT, "-j", json.dumps(raw)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO,
            start_new_session=True)
        self.log = ""
        try:
            self._wait_banners()
        except BaseException:
            self.kill()
            raise
        self._drain = threading.Thread(target=self._read_rest, daemon=True)
        self._drain.start()

    def _wait_banners(self) -> None:
        want = self.workers if self.workers > 1 else 1
        fd = self.proc.stdout.fileno()
        sel = selectors.DefaultSelector()
        sel.register(fd, selectors.EVENT_READ)
        deadline = time.monotonic() + BOOT_S
        try:
            while (self.log.count("listening on") < want
                   or (self.workers > 1 and "device service" not in self.log)):
                assert time.monotonic() < deadline, \
                    f"server never came up:\n{self.log}"
                if not sel.select(timeout=1.0):
                    continue
                chunk = os.read(fd, 65536).decode("utf-8", "replace")
                assert chunk, f"server died during startup:\n{self.log}"
                self.log += chunk
        finally:
            sel.close()

    def _read_rest(self) -> None:
        for line in iter(self.proc.stdout.readline, b""):
            self.log += line.decode("utf-8", "replace")

    def worker_pids(self) -> list:
        return [int(line.split()[2]) for line in self.log.splitlines()
                if line.startswith("fanlin-tpu-torch worker ")]

    def get(self, url: str, headers=None, timeout: float = 60.0):
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}/{self.path}{url}",
            headers=headers or {})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)

    def stats(self) -> dict:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.port}/stats", timeout=60) as r:
            return json.loads(r.read())

    def terminate(self, timeout: float = 60.0) -> int:
        self.proc.send_signal(signal.SIGTERM)
        return self.proc.wait(timeout=timeout)

    def kill(self) -> None:
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait(timeout=30)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


async def _single_process_bodies(path: str, urls, tpu=None):
    """The same requests through the port's single-process server
    (build_state on the CPU), in this process."""
    cfg = tconfig.Config.from_obj(_raw(0, path, tpu or {}))
    state = await app_mod.build_state(cfg, device=CPU)
    client = TestClient(TestServer(app_mod.create_app(cfg, state)))
    await client.start_server()
    try:
        out = []
        for url, headers in urls:
            r = await client.get(f"/{path}{url}", headers=headers)
            assert r.status == 200
            out.append(await r.read())
        return out
    finally:
        await client.close()


URLS = [
    ("/lenna_src.jpg?w=300&h=200", None),
    ("/lenna_src.jpg?w=300&h=200&webp=true&quality=20",
     {"Accept": "image/webp"}),
    ("/lenna_src.jpg?w=100&h=80&blur=1", None),
    ("/synth_src.jpg?w=300&h=200", None),
    ("/lenna_src.png?w=120&h=90", None),
    ("/lenna_src.gif?w=60&h=40", None),
]


def test_workers_serve_identical_bytes_and_drain():
    srv = _Server("wk-bytes", workers=2)
    try:
        pids = srv.worker_pids()
        assert len(pids) == 2 and all(_alive(p) for p in pids)
        # sequential requests on fresh connections land on both
        # REUSEPORT workers; every body must be the same
        first = [srv.get(u, h)[1] for u, h in URLS]
        for _ in range(3):
            assert [srv.get(u, h)[1] for u, h in URLS] == first
        want = asyncio.run(_single_process_bodies("wk-bytes", URLS))
        assert first == want, "worker-mode bytes != single-process bytes"
        # graceful drain: SIGTERM -> exit 0, no worker left, port closed
        assert srv.terminate() == 0
        deadline = time.monotonic() + 10
        while any(_alive(p) for p in pids) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not any(_alive(p) for p in pids)
        with pytest.raises(OSError):
            srv.get("/lenna_src.jpg?w=30&h=20", timeout=3)
    finally:
        srv.kill()


def test_workers_ping_and_stats():
    srv = _Server("wk-stats", workers=2, source_cache_mb=8)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/ping", timeout=30) as r:
            assert (r.status, r.read()) == (200, b"pong")
        for _ in range(2):
            assert srv.get("/lenna_src.jpg?w=200&h=150")[0] == 200
        full = srv.stats()
        # the batcher and the kernels live in the device service: a
        # worker's /stats fetches their counters from there
        assert full["batcher"]["images"] == 2
        assert full["batcher"]["batches"] >= 1
        assert full["kernel_launches"] == {
            "resample": 0, "resample_blur": 0, "resample_fast": 0,
            "resample_blur_fast": 0, "jpeg_decode_rgb": 0,
            "jpeg_decode_cmyk": 0, "jpeg_decode_cmyk_rgb": 0,
            "cmyk_lut": 0}  # the CPU runs the plain versions
        # the engine and the caches are the answering worker's own: each
        # /stats on a fresh connection may reach either worker, so read
        # it until one answers from a worker that served an image
        assert set(full["engine"]) == {
            "pixel_src", "coef_src", "slot_reads", "reads", "read_ms_total",
            "progressive_reads", "read_scans_total", "requests",
            "pool_wait_ms_total"}
        for _ in range(40):
            if full["engine"]["requests"] >= 1:
                break
            full = srv.stats()
        assert full["engine"]["requests"] >= 1
        # a worker's runner stages nothing: its JPEGs take the dict route,
        # where the reader counts them (lenna is baseline: one scan each)
        eng = full["engine"]
        assert eng["slot_reads"] == eng["progressive_reads"] == 0
        assert 1 <= eng["reads"] == eng["read_scans_total"] <= eng["coef_src"]
        assert eng["read_ms_total"] > 0
        assert full["caches"]["responses"] is None
        assert full["caches"]["sources"]["max_bytes"] == 8 * 1024 * 1024
    finally:
        srv.kill()


def test_workers_config_knob():
    base = """
{"port": 0, "bind_addr": "x", "max_clients": 1,
 "client": {"s3": {"aws_region": "x"},
            "web": {"user_agent": "t", "timeout": 2}},
 "providers": [{"path": "p", "src": "file://localhost/tmp"}],
 "tpu": {"workers": %s}}
"""
    for mod in (tconfig, jconfig):
        assert mod.Config.from_str(base % "4").tpu.workers == 4
        assert mod.Config.from_str(base % "0").tpu.workers == 0
        for bad in ("-1", "1000"):
            with pytest.raises(mod.ConfigError):
                mod.Config.from_str(base % bad)
    app_mod.check_ported(tconfig.Config.from_str(base % "4"))


def _bare_service(**attrs):
    svc = w.DeviceService.__new__(w.DeviceService)
    svc._warmup_on = True
    svc._device_decode = True
    svc._device_dct = False
    svc._fast_decode = False
    svc._warmed = set()
    svc._warm_lock = threading.Lock()
    svc.batcher = None
    svc.stats = {"runs": 0, "recv_ms_total": 0.0, "run_ms_total": 0.0,
                 "send_ms_total": 0.0}
    svc.stats_lock = threading.Lock()
    for k, v in attrs.items():
        setattr(svc, k, v)
    return svc


def test_warm_shapes_dedups_across_workers(monkeypatch):
    """Every worker reports its fallback-derived shapes; the service
    warms each fresh shape once, and a report with nothing new starts
    no warmup."""
    calls = []
    monkeypatch.setattr(
        warmup_mod, "warm",
        lambda batcher, shapes, device_decode=True, device_dct=False,
        fast_decode=False: calls.append(tuple(shapes)))
    svc = _bare_service()
    a, b, c = (64, 64, "w=32&h=32"), (128, 128, "w=32"), (256, 256, "h=9")
    svc.warm_shapes((a, b))       # worker 1
    svc.warm_shapes((a, c))       # worker 2: only c is fresh
    svc.warm_shapes((a,))         # worker 3: nothing fresh
    deadline = time.monotonic() + 10
    while len(calls) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)  # a third warmup would land here
    assert sorted(len(s) for s in calls) == [1, 2]
    assert {shape for s in calls for shape in s} == {a, b, c}


@pytest.fixture
def unix_server(tmp_path):
    """Serve _ServiceHandler for a given service object on a unix
    socket; yields a starter returning the socket's path."""
    started = []

    def start(service):
        path = str(tmp_path / f"svc{len(started)}.sock")
        srv = w._ThreadedUnixServer(path, w._ServiceHandler)
        srv.service = service
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        started.append((srv, t))
        return path

    yield start
    for srv, t in started:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
        assert not t.is_alive()


def test_service_warm_message_roundtrip(unix_server):
    """A ("warm", shapes) message reaches DeviceService.warm_shapes and
    is acknowledged; ("hello",) answers the workers' config."""
    class Stub:
        worker_cfg = {"device_decode": False}

        def __init__(self):
            self.seen = []

        def warm_shapes(self, shapes):
            self.seen.append(tuple(shapes))

    stub = Stub()
    path = unix_server(stub)
    shapes = ((64, 64, "w=1&h=1"),)
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(path)
        w._send(s, ("warm", shapes))
        assert w._recv(s, time.monotonic() + 10) == ("ok", None)
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(path)
        w._send(s, ("hello",))
        assert w._recv(s, time.monotonic() + 10) == (
            "cfg", {"device_decode": False})
    assert stub.seen == [shapes]


def _swallowing_socket(path: str, dribble: bool = False):
    """A unix server that accepts and never answers, or (dribble) that
    announces a 1 MiB reply and trickles it a byte every 0.1 s. Returns
    (close, thread)."""
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(8)
    srv.settimeout(0.1)  # close() does not wake a blocked accept
    held, stop = [], threading.Event()

    def serve():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)
            held.append(conn)
            if dribble:
                try:
                    w._recv(conn)
                    conn.sendall(w._HDR.pack(1 << 20))
                    while not stop.is_set():
                        conn.sendall(b"x")
                        time.sleep(0.1)
                except OSError:
                    pass

    t = threading.Thread(target=serve, daemon=True)
    t.start()

    def close():
        stop.set()
        t.join(timeout=10)
        assert not t.is_alive()
        srv.close()
        for c in held:
            c.close()

    return close


def _plan():
    return plan_image(8, 8, parse_query("w=4&h=4"), opaque=True)


@pytest.mark.parametrize("dribble", [False, True])
def test_remote_runner_bounded_by_deadline(tmp_path, monkeypatch, dribble):
    """A service that accepts but never replies, or that dribbles its
    reply, must not hold the worker's thread: RemoteRunner.run raises
    RequestExpired at the request deadline plus the reply grace, one
    absolute bound through every recv (the gateway's 408)."""
    close = _swallowing_socket(str(tmp_path / "dead.sock"), dribble)
    monkeypatch.setattr(w, "_REPLY_GRACE_S", 0.3)
    runner = w.RemoteRunner(str(tmp_path / "dead.sock"))
    tok = REQUEST_DEADLINE.set(time.monotonic() + 0.4)
    try:
        t0 = time.monotonic()
        with pytest.raises(RequestExpired):
            runner.run([_plan()], [np.zeros((8, 8, 3), np.uint8)], ["rgb"])
        took = time.monotonic() - t0
        assert took < 3.0, f"not bounded end to end: {took:.1f} s"
    finally:
        REQUEST_DEADLINE.reset(tok)
        close()


def test_remote_runner_deadline_is_end_to_end(tmp_path, monkeypatch):
    """The dribbling service of the test above against a deadline well
    past the grace: the run still ends within deadline + grace."""
    close = _swallowing_socket(str(tmp_path / "drip.sock"), dribble=True)
    monkeypatch.setattr(w, "_REPLY_GRACE_S", 0.5)
    runner = w.RemoteRunner(str(tmp_path / "drip.sock"))
    tok = REQUEST_DEADLINE.set(time.monotonic() + 1.0)
    try:
        t0 = time.monotonic()
        with pytest.raises(RequestExpired):
            runner.run([_plan()], [np.zeros((8, 8, 3), np.uint8)], None)
        took = time.monotonic() - t0
        assert 1.0 <= took < 4.0, f"deadline not end to end: {took:.1f} s"
    finally:
        REQUEST_DEADLINE.reset(tok)
        close()


def test_service_stats_payload():
    """The stats reply carries the service's batcher counters and its
    kernels' launch counts (the same dict a single-process /stats
    shows)."""
    class _B:
        stats = {"batches": 3}

    payload = w._service_stats(_bare_service(batcher=_B()))
    assert payload["batcher"] == {"batches": 3}
    assert payload["service"] == {"runs": 0, "recv_ms_total": 0.0,
                                  "run_ms_total": 0.0, "send_ms_total": 0.0}
    assert payload["kernel_launches"] == app_mod.kernel_launches()
    assert set(payload["kernel_launches"]) == {
        "resample", "resample_blur", "resample_fast", "resample_blur_fast",
        "jpeg_decode_rgb", "jpeg_decode_cmyk", "jpeg_decode_cmyk_rgb",
        "cmyk_lut"}


def _service_cfg(**tpu):
    return tconfig.Config.from_obj(_raw(0, "svc", tpu))


@pytest.fixture
def device_service(tmp_path):
    """A real DeviceService on the CPU, in this process."""
    made = []

    def make(**tpu):
        path = str(tmp_path / f"device{len(made)}.sock")
        svc = w.DeviceService(_service_cfg(**tpu), path, device=CPU)
        svc.start()
        made.append(svc)
        return svc, path

    yield make
    for svc in made:
        assert svc.stop()


def test_run_roundtrip_equals_local_runner(device_service):
    """("run", keys, payloads, kinds) through the socket gives the
    results a local runner gives: pixel, coefficient and GIF-style
    (kinds None) batches."""
    from fanlin_tpu_torch.engine import jpeg_coeffs

    _, path = device_service(batch_window_ms=1)
    runner = w.RemoteRunner(path)
    with open(os.path.join(GOLDEN, "lenna_src.jpg"), "rb") as f:
        meta = jpeg_coeffs.read_jpeg_coeffs(f.read())
    q = parse_query("w=300&h=200")
    plan = plan_image(512, 512, q, opaque=True)
    img = np.asarray(np.random.default_rng(3).integers(
        0, 256, (512, 512, 3)), np.uint8)
    local = Engine(CPU).runner
    for payload, kinds in ((img, ["rgb"]), (meta, ["coef444"]),
                           (img, None), (meta, ["coef444+jpeg420"])):
        if kinds and "jpeg420" in kinds[0] and not native_codecs.available():
            continue
        got = runner.run([plan], [payload], kinds)
        want = local.run([plan], [payload], kinds)
        for g, x in zip(got, want):
            if isinstance(x, tuple):
                assert x[0] == g[0] and all(
                    np.array_equal(a, b) for a, b in zip(x[1:], g[1:]))
            else:
                assert np.array_equal(g, x)


def test_plans_reinterned_to_one_object(device_service, monkeypatch):
    """Two workers' requests for one (source, query) arrive as distinct
    plan objects with one key; the service re-interns them into one,
    so their shared batch is uniform (the resample kernel's route)."""
    rows = []
    real = fused.make_assembly

    def make(plans, payloads, kinds, device, **kw):
        asm = real(plans, payloads, kinds, device, **kw)
        rows.append((len(plans), len({id(p) for p in plans}), asm.uniform))
        return asm

    monkeypatch.setattr(fused, "make_assembly", make)
    _, path = device_service(batch_window_ms=500, max_batch=2)
    plan = plan_image(64, 48, parse_query("w=32&h=24"), opaque=True)
    copies = [copy.copy(plan), copy.copy(plan)]
    assert copies[0] is not copies[1] and copies[0].cache_key == plan.cache_key
    img = np.zeros((48, 64, 3), np.uint8)
    gate = threading.Barrier(2)
    out = []

    def one(p):
        gate.wait(timeout=10)
        out.append(w.RemoteRunner(path).run([p], [img], ["rgb"]))

    threads = [threading.Thread(target=one, args=(p,)) for p in copies]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(out) == 2
    assert rows == [(2, 1, True)]


async def _worker_client(runner, **tpu):
    """A gateway worker's app (build_state with a RemoteRunner) under
    aiohttp's TestClient, in this process."""
    cfg = tconfig.Config.from_obj(_raw(0, "wk", tpu))
    state = await app_mod.build_state(cfg, runner=runner)
    assert state.engine.device is None
    client = TestClient(TestServer(app_mod.create_app(cfg, state)))
    await client.start_server()
    return client


def test_worker_overload_answers_503(device_service):
    """BatcherOverload raised in the service crosses the socket with its
    type: the worker answers 503, and its /stats shows the service's
    rejection count."""
    _, path = device_service(max_queue=1, max_batch=64,
                             batch_window_ms=1000)

    async def body():
        client = await _worker_client(w.RemoteRunner(path))
        try:
            rs = await asyncio.gather(*(client.get("/wk/lenna_src.jpg?w=30&h=20")
                                        for _ in range(3)))
            statuses = sorted(r.status for r in rs)
            stats = json.loads(await (await client.get("/stats")).text())
        finally:
            await client.close()
        assert statuses == [200, 503, 503]
        assert stats["batcher"]["rejected_overload"] == 2

    asyncio.run(body())


def test_worker_deadline_answers_408(tmp_path, monkeypatch):
    """A service that never answers: the worker's request ends at the
    gateway's deadline with 408, and its thread is freed at deadline +
    grace (RequestExpired, not a hang)."""
    close = _swallowing_socket(str(tmp_path / "mute.sock"))
    monkeypatch.setattr(app_mod, "REQUEST_TIMEOUT_SECS", 0.3)
    monkeypatch.setattr(w, "_REPLY_GRACE_S", 0.3)
    runner = w.RemoteRunner(str(tmp_path / "mute.sock"))
    freed = []
    real_run = runner.run

    def run(*a):
        try:
            return real_run(*a)
        except RequestExpired:
            freed.append(time.monotonic())
            raise

    runner.run = run

    async def body():
        client = await _worker_client(runner)
        try:
            t0 = time.monotonic()
            r = await client.get("/wk/lenna_src.jpg?w=30&h=20")
            assert r.status == 408
            while not freed and time.monotonic() - t0 < 5:
                await asyncio.sleep(0.05)
            assert freed and freed[0] - t0 < 3.0
        finally:
            await client.close()

    try:
        asyncio.run(body())
    finally:
        close()


@pytest.mark.parametrize("exc,status", [("RequestExpired", 408),
                                        ("BatcherOverload", 503)])
def test_service_errors_keep_their_type(unix_server, exc, status):
    """An exception the service's runner raises reaches the worker as
    itself, and the worker maps it to its status."""
    class Svc:
        worker_cfg = {"device_decode": True}
        stats = {"runs": 0, "recv_ms_total": 0.0, "run_ms_total": 0.0,
                 "send_ms_total": 0.0}
        stats_lock = threading.Lock()

        class runner:
            @staticmethod
            def run(plans, images, kinds):
                raise getattr(batcher_mod, exc)("shed")

    path = unix_server(Svc())
    with pytest.raises(getattr(batcher_mod, exc)):
        w.RemoteRunner(path).run([_plan()], [np.zeros((8, 8, 3), np.uint8)],
                                 ["rgb"])

    async def body():
        client = await _worker_client(w.RemoteRunner(path))
        try:
            return (await client.get("/wk/lenna_src.jpg?w=30&h=20")).status
        finally:
            await client.close()

    assert asyncio.run(body()) == status


def test_worker_without_service_answers_500(tmp_path):
    """No fallback: a worker whose service is gone answers 500 and
    never transforms on its own CPU."""
    runner = w.RemoteRunner(str(tmp_path / "gone.sock"))

    async def body():
        client = await _worker_client(runner)
        try:
            r = await client.get("/wk/lenna_src.jpg?w=30&h=20")
            return r.status, await r.text()
        finally:
            await client.close()

    status, text = asyncio.run(body())
    assert status == 500
    assert text == "server error on processing an image"
    assert runner.service_stats() is None
    # the service's wedge gauge is unknown: the worker keeps its healthy
    # default (device available), as a fresh service's batcher reports it
    local = batcher_mod.BatchingRunner(batcher_mod.MicroBatcher(2, 1.0, CPU))
    try:
        assert runner.device_available() == local.device_available() is True
    finally:
        assert local.batcher.close()


@pytest.mark.parametrize("workers", [1, 2])
def test_workers_warmup_through_the_service(workers):
    """tpu.warmup from the CLI: in worker mode the service warms the
    default shapes and the configured one, each once, on its device
    thread, the workers' reports adding nothing fresh (dedup); a single
    process (workers 1) warms the same shapes on its own batcher. Served
    traffic is counted apart from warm batches."""
    srv = _Server(f"wk-warm{workers}", workers=workers, warmup=True,
                  max_batch=2, warmup_shapes=["64x48:w=32&h=24"])
    try:
        kinds = len(warmup_mod._kinds(True, False))
        want = 3 * 2 * kinds  # 3 shapes, B = 1 and 2
        deadline = time.monotonic() + 120
        while srv.stats()["batcher"]["warm_batches"] < want:
            assert time.monotonic() < deadline, srv.stats()
            time.sleep(0.2)
        time.sleep(0.5)  # a repeated warmup would land here
        stats = srv.stats()["batcher"]
        assert stats["warm_batches"] == want
        assert stats["batches"] == stats["images"] == 0
        assert srv.get("/lenna_src.jpg?w=300&h=200")[0] == 200
        assert srv.terminate() == 0
    finally:
        srv.kill()


def test_workers_serve_fast_decode_and_data_parallel():
    """tpu.fast_decode and tpu.data_parallel (one device) in worker mode:
    the fold decision travels in the batch kind across the socket, and
    every body equals the single-process server's with the same config."""
    tpu = {"fast_decode": True, "data_parallel": True}
    srv = _Server("wk-fold", workers=2, **tpu)
    try:
        got = [srv.get(u, h)[1] for u, h in URLS]
        want = asyncio.run(_single_process_bodies("wk-fold", URLS, tpu))
        assert got == want, "worker-mode bytes != single-process bytes"
        assert srv.terminate() == 0
    finally:
        srv.kill()


def test_workers_serve_fast_and_profile(tmp_path):
    """tpu.fast in worker mode: the device service's batcher holds it and
    its hello tells the workers, whose Engines check it; every body
    equals the single-process server's with fast (and the README body
    differs from the exact one's). With tpu.profile_dir a worker answers
    GET /profile with a trace of its own host activity."""
    tpu = {"fast": True, "profile_dir": str(tmp_path / "traces")}
    srv = _Server("wk-fast", workers=2, **tpu)
    try:
        got = [srv.get(u, h)[1] for u, h in URLS]
        want = asyncio.run(_single_process_bodies("wk-fast", URLS, tpu))
        assert got == want, "worker-mode bytes != single-process bytes"
        exact = asyncio.run(_single_process_bodies("wk-fast", URLS[:1]))
        assert got[0] != exact[0]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/profile?seconds=0.2",
                timeout=60) as r:
            body = json.loads(r.read())
        assert r.status == 200 and os.path.isfile(body["trace_file"])
        assert srv.terminate() == 0
    finally:
        srv.kill()


# the CLI as BOOT runs it, with two devices visible to the device count
BOOT_TWO_DEVICES = BOOT.replace(
    "from fanlin_tpu_torch.cli import main; ",
    "from fanlin_tpu_torch import device; "
    "device.device_count = lambda dev: 2; "
    "from fanlin_tpu_torch.cli import main; ")


@pytest.mark.parametrize("workers", [1, 2])
def test_data_parallel_on_several_devices_stops_the_cli(workers):
    """With two devices visible, tpu.data_parallel stops the CLI with a
    non-zero exit and the reason on stderr, in one process and in worker
    mode (where the device service counts, after the fork): no worker is
    left serving without a service."""
    raw = _raw(_free_port(), "wk-dp2",
               {"workers": workers, "data_parallel": True})
    proc = subprocess.Popen(
        [sys.executable, "-c", BOOT_TWO_DEVICES, "-j", json.dumps(raw)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=BOOT_S)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
            leftover = True
        except ProcessLookupError:
            leftover = False
        proc.wait(timeout=30)
    err = err.decode("utf-8", "replace")
    assert proc.returncode != 0, out
    assert "tpu.data_parallel with 2 cpu devices" in err, err
    assert "listening on" not in out.decode("utf-8", "replace")
    assert not leftover, "a process of the CLI outlived it"


def test_warm_runs_on_the_device_thread(monkeypatch):
    """Single-process warmup: every batch runs on the batcher's device
    thread at B=1 and B=max_batch, the plans land in the plan cache,
    and nothing is counted as served."""
    threads = []
    real = fused.make_assembly

    def make(plans, payloads, kinds, device, **kw):
        threads.append((threading.current_thread().name, len(plans)))
        return real(plans, payloads, kinds, device, **kw)

    monkeypatch.setattr(fused, "make_assembly", make)
    batcher = batcher_mod.MicroBatcher(4, 2.0, device=CPU)
    try:
        shape = (64, 48, "w=32&h=24&blur=1")
        n = warmup_mod.warm(batcher, (shape,), device_dct=True)
        kinds = warmup_mod._kinds(True, True)
        assert n == 2 * len(kinds) == batcher.stats["warm_batches"]
        assert batcher.stats["batches"] == batcher.stats["images"] == 0
        assert all(name.startswith("fanlin-device") for name, _ in threads)
        assert sorted({b for _, b in threads}) == [1, 4]
        assert any(k.startswith("jpegdct") for _, k in kinds)
        plan = plan_image(64, 48, parse_query(shape[2]), opaque=True)
        assert plan.cache_key == (64, 48, parse_query(shape[2]),
                                  "lanczos3", True)
    finally:
        assert batcher.close()
    # a closed batcher ends a warmup without raising
    assert warmup_mod.warm(batcher, (shape,)) == 0


def test_service_takes_a_burst_of_connections(device_service):
    """Many workers' requests connect at once: every connect must reach
    the service (a unix backlog of socketserver's default 5 makes a
    connect with a timeout fail at once with EAGAIN), and all of them
    share batches."""
    svc, path = device_service(batch_window_ms=200, max_batch=32)
    plan = plan_image(64, 48, parse_query("w=32&h=24"), opaque=True)
    img = np.zeros((48, 64, 3), np.uint8)
    n = 32
    gate = threading.Barrier(n)
    errors, done = [], []

    def one():
        tok = REQUEST_DEADLINE.set(time.monotonic() + 30)
        try:
            gate.wait(timeout=10)
            done.append(w.RemoteRunner(path).run([plan], [img], ["rgb"]))
        except Exception as e:  # reported below
            errors.append(repr(e))
        finally:
            REQUEST_DEADLINE.reset(tok)

    threads = [threading.Thread(target=one) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors, errors
    assert len(done) == n
    assert svc.batcher.stats["images"] == n
    assert svc.batcher.stats["batches"] < n
    st = svc.stats
    assert st["runs"] == n and st["run_ms_total"] > 0
    assert st["recv_ms_total"] > 0 and st["send_ms_total"] > 0


def test_warm_host_pays_the_host_side_first():
    """warm_host (run by the parent before the fork and by each worker)
    touches no device and leaves PIL's plugins loaded, the host reader's
    library loaded and the shapes' plans in the plan cache."""
    from PIL import Image

    from fanlin_tpu_torch.ops import _build

    shape = (72, 40, "w=30&h=20&blur=2")
    warmup_mod.warm_host((shape,))
    assert Image._initialized == 2
    assert _build._HOST_LIB is not None
    q = parse_query(shape[2])
    plan = plan_image(72, 40, q, opaque=True)
    assert plan_image(72, 40, q, "lanczos3", True) is plan


def test_message_arrays_travel_in_a_memfd(monkeypatch):
    """_send/_recv: a message's arrays (C- and F-ordered, strided, empty,
    in a meta dict) arrive equal and writable, their bytes ride a memfd
    passed with the message rather than the socket stream, and no
    descriptor leaks on either side."""
    rng = np.random.default_rng(9)
    meta = {"y": rng.integers(-900, 900, (64, 40, 64), dtype=np.int16),
            "lq": np.arange(64, dtype=np.uint16), "w": 320, "h": 512}
    msg = ("run", [(8, 8, parse_query("w=4"), "lanczos3", True)],
           [meta, np.asfortranarray(rng.random((5, 7))),
            np.arange(40)[::3], np.zeros((0, 3), np.uint8)], None, None)
    heads = []
    real_send_fds = socket.send_fds

    def send_fds(sock, buffers, fds):
        heads.append((w._HDR.unpack(buffers[0])[0], len(fds)))
        return real_send_fds(sock, buffers, fds)

    monkeypatch.setattr(w.socket, "send_fds", send_fds)
    fds_before = len(os.listdir("/proc/self/fd"))
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    with a, b:
        sent = []
        t = threading.Thread(target=lambda: sent.append(w._send(a, msg)))
        t.start()
        got = w._recv(b, time.monotonic() + 10)
        t.join(timeout=10)
        assert not t.is_alive() and sent == [None]
        # the stream held only the small head: nothing is left in it
        b.setblocking(False)
        with pytest.raises(BlockingIOError):
            b.recv(1)
    assert len(os.listdir("/proc/self/fd")) == fds_before
    # one descriptor, and a head of well under a KB for ~330 KB of arrays
    assert len(heads) == 1 and heads[0][1] == 1 and heads[0][0] < 1024
    assert got[0] == "run" and got[1] == msg[1] and got[3:] == (None, None)
    gmeta, f, strided, empty = got[2]
    assert gmeta.keys() == meta.keys() and gmeta["w"] == 320
    for k in ("y", "lq"):
        assert gmeta[k].dtype == meta[k].dtype
        assert np.array_equal(gmeta[k], meta[k]) and gmeta[k].flags.writeable
    assert np.array_equal(f, msg[2][1]) and f.flags.f_contiguous
    assert np.array_equal(strided, msg[2][2])
    assert empty.shape == (0, 3)
