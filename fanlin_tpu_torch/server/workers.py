"""Multi-worker gateway (`tpu.workers`): N HTTP gateway processes
feeding one CUDA device service.

Port of fanlin_tpu/server/workers.py. A Python gateway is GIL-bound:
one process carries every request's HTTP, query parsing and host
codecs (the reader, the encoders) on one interpreter lock, while the
reference spreads them over tokio's thread pool (reference
src/main.rs:33). `tpu.workers: N` runs

* N forked GATEWAY workers, each binding the listen port with
  SO_REUSEPORT (the kernel spreads the accepted connections) and
  running the full HTTP and codec stack, but never CUDA: their engines
  use a `RemoteRunner` that forwards each device batch over a unix
  socket;
* ONE device service, the parent process, that owns the card, the
  kernels and the micro-batcher. Requests of different workers still
  coalesce into shared device batches.

Order of startup. The workers fork first, before anything in the parent
initialises CUDA (even `torch.cuda.is_available()` would: without NVML
it calls cudaGetDeviceCount, and torch then refuses CUDA in a forked
child). The kernel libraries are compiled before the fork
(`_build.build()`, `build_host()` only run the compilers) and loaded
after it, in the service. Then the service comes up, then the parent
supervises its workers by pid (never `waitpid(-1)`: that would reap the
compilers `_build` starts, and `Popen` would then read a failed build's
lost status as 0).

Protocol: length-prefixed pickles over a private unix socket (a mode
0700 temporary directory; local and trusted); the arrays of a message
(a coefficient meta is ~1.5 MB of int16 blocks) travel in a memfd
passed with it, not through the socket (`_send`). Plans travel BY KEY
(`ImagePlan.cache_key`) and the service re-interns each through
`plan_image`, so one (source, query) is one plan object across workers:
their batches stay uniform and take the resample kernel, and the
matrices never cross the socket. Errors cross with their types
(`BatcherOverload` -> 503, `RequestExpired` -> 408 in the worker).

Cancellation: the gateway's cancel event cannot cross the process
boundary, so the service sheds queued entries by deadline only; the
worker drops a request already abandoned before paying the socket trip,
and bounds its wait end to end by the deadline plus _REPLY_GRACE_S.

No fallback in a worker: one that cannot reach the service answers 500
(the fallback image path); it never transforms on its own CPU. The
service's batcher has the host mirror (`engine.batcher`): a run reply
carries its mirror flag, and the worker tags such a response cold as
the single process does. The worker reads the service's wedge gauge
through `RemoteRunner.device_available`, cached for _AVAIL_TTL_S; the
mirror itself runs in the service process.

Resilience: a worker that dies is logged and not respawned (the kernel
spreads its SO_REUSEPORT share over the others; respawning would fork
a parent that holds a CUDA context). If the parent dies, the workers
take SIGTERM (PR_SET_PDEATHSIG), drain and exit.

Each worker holds its own response and source caches, as in the JAX
package: N workers hold up to N x `response_cache_mb` and N x
`source_cache_mb`.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import os
import pickle
import shutil
import signal
import socket
import socketserver
import struct
import sys
import tempfile
import threading
import time

import torch
from aiohttp import web

from .. import config as config_mod
from .. import device as device_mod
from ..engine import native_codecs
from ..engine import warmup as warmup_mod
from ..engine.batcher import (REQUEST_CANCEL, REQUEST_DEADLINE,
                              BatchingRunner, RequestExpired)
from ..ops import _build
from ..ops.plan import plan_image
from .app import (build_state, check_data_parallel, create_app,
                  kernel_launches, make_batcher)

log = logging.getLogger("fanlin.workers")

_HDR = struct.Struct(">Q")
# a worker waits for the service's handshake as long as the parent
# lives (PR_SET_PDEATHSIG ends it otherwise), and warns once past this
_HELLO_WARN_S = 300.0
# extra time past the request deadline for the device service to
# deliver its own RequestExpired or error reply before the worker cuts
# the connection (RemoteRunner.run)
_REPLY_GRACE_S = 2.0
# how long the parent waits for its workers to drain after SIGTERM
# before it kills them
_DRAIN_S = 30.0
# how long a worker reuses the service's wedge gauge
_AVAIL_TTL_S = 1.0


def _send(sock: socket.socket, obj) -> None:
    """One message: an 8-byte length and a pickle (protocol 5) of
    (buffer sizes, the object's pickle without its buffers). The
    out-of-band buffers, the numpy arrays' bytes, go into a memfd whose
    descriptor rides with the length (SCM_RIGHTS): one writev here and
    one preadv in the peer instead of a multi-MB socket stream, whose
    every ~200 KB chunk waits for the interpreter lock on both sides."""
    bufs = []
    data = pickle.dumps(obj, protocol=5, buffer_callback=bufs.append)
    views = [b.raw() for b in bufs]
    head = pickle.dumps(([v.nbytes for v in views], data), protocol=5)
    fds = []
    try:
        if views:
            fds.append(os.memfd_create("fanlin-msg", os.MFD_CLOEXEC))
            _write_all(fds[0], views)
        socket.send_fds(sock, [_HDR.pack(len(head))], fds)
        sock.sendall(head)
    finally:
        for fd in fds:
            os.close(fd)


def _recv(sock: socket.socket, deadline: float = None):
    """The next message of _send's; `deadline` as in _recvn."""
    if deadline is not None:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise socket.timeout("reply deadline exceeded")
        sock.settimeout(remaining)
    hdr, fds, _, _ = socket.recv_fds(sock, _HDR.size, 1)
    try:
        if not hdr:
            raise ConnectionError("device service closed the connection")
        if len(hdr) < _HDR.size:
            hdr += _recvn(sock, _HDR.size - len(hdr), deadline)
        (n,) = _HDR.unpack(hdr)
        sizes, data = pickle.loads(_recvn(sock, n, deadline))
        buffers = [bytearray(k) for k in sizes]
        if buffers:
            if not fds:
                raise ConnectionError("a message came without its buffers")
            _read_all(fds[0], buffers)
    finally:
        for fd in fds:
            os.close(fd)
    return pickle.loads(data, buffers=buffers)


def _write_all(fd: int, views) -> None:
    pending = [memoryview(v).cast("B") for v in views]
    while pending:
        n = os.writev(fd, pending)
        while pending and n >= len(pending[0]):
            n -= len(pending[0])
            pending.pop(0)
        if pending and n:
            pending[0] = pending[0][n:]


def _read_all(fd: int, buffers) -> None:
    pending = [memoryview(b) for b in buffers]
    offset = 0
    while pending:
        n = os.preadv(fd, pending, offset)
        if n == 0:
            raise ConnectionError("a message's buffers were cut short")
        offset += n
        while pending and n >= len(pending[0]):
            n -= len(pending[0])
            pending.pop(0)
        if pending and n:
            pending[0] = pending[0][n:]


def _recvn(sock: socket.socket, n: int, deadline: float = None) -> bytes:
    """Read exactly n bytes. `deadline` (time.monotonic) bounds the
    WHOLE read: socket timeouts are per operation, so a peer dribbling a
    multi-MB reply one chunk per timeout window would otherwise hold the
    caller for N_chunks x timeout."""
    parts = []
    while n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("reply deadline exceeded")
            sock.settimeout(remaining)
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("device service closed the connection")
        parts.append(chunk)
        n -= len(chunk)
    return b"".join(parts)


class RemoteRunner:
    """Engine runner that forwards batches to the device service: one
    connection per run() call (a unix connect is ~10 us); callers block
    in worker threads, so plain blocking sockets."""

    def __init__(self, path: str, fast: bool = False):
        """fast: the service's `tpu.fast` (from the hello), which the
        worker's Engine checks against its own."""
        self.path = path
        self.fast = bool(fast)
        self._tls = threading.local()
        # the gauge cache, shared by this worker's request threads
        self._gauge_lock = threading.Lock()
        self._avail = None  # (t_fetched, available)
        self._avail_refreshing = False

    def run(self, plans, images, kinds=None):
        cancel_ev = REQUEST_CANCEL.get()
        if cancel_ev is not None and cancel_ev.is_set():
            raise RequestExpired("request abandoned before dispatch")
        deadline = REQUEST_DEADLINE.get()
        req = ("run", [p.cache_key for p in plans], images, kinds, deadline)
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                reply_deadline = None
                if deadline is not None:
                    # one absolute bound through every recv: a service
                    # that never answers must not hold this thread (and
                    # the SIGTERM drain) forever
                    reply_deadline = (time.monotonic()
                                      + max(deadline - time.monotonic(), 0.1)
                                      + _REPLY_GRACE_S)
                    s.settimeout(reply_deadline - time.monotonic())
                s.connect(self.path)
                _send(s, req)
                status, payload, mirror = _recv(s, reply_deadline)
        except socket.timeout:
            raise RequestExpired(
                "device service did not answer before the request "
                "deadline") from None
        if status == "err":
            raise payload
        if mirror:
            self._tls.host_mirror = True
        return payload

    def consume_host_mirror_flag(self) -> bool:
        """True when a run() on this thread since the last consume was
        served by the service's host mirror."""
        v = getattr(self._tls, "host_mirror", False)
        self._tls.host_mirror = False
        return v

    def device_available(self) -> bool:
        """The service batcher's wedge gauge, cached for _AVAIL_TTL_S:
        the engine asks per JPEG request, and a wedge lasts seconds. A
        stale value only prices the mirror wrongly for a moment (both
        source paths give the same bytes). One request thread refreshes
        at a time; an unreachable service keeps the last known value
        (the request itself reports the failure)."""
        now = time.monotonic()
        with self._gauge_lock:
            cached = self._avail
            if cached is not None and (now - cached[0] < _AVAIL_TTL_S
                                       or self._avail_refreshing):
                return cached[1]
            self._avail_refreshing = True
        try:
            st = self.service_stats()
        finally:
            with self._gauge_lock:
                self._avail_refreshing = False
        with self._gauge_lock:
            v = self._avail[1] if self._avail is not None else True
            if st is not None:
                v = not (st.get("batcher") or {}).get("device_wedged", 0)
            self._avail = (time.monotonic(), v)
            return v

    def service_stats(self):
        """The device service's counters ({"batcher": ...,
        "kernel_launches": ...}); None when it is unreachable."""
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.settimeout(2.0)
                s.connect(self.path)
                _send(s, ("stats",))
                status, payload = _recv(s, time.monotonic() + 2.0)
            return payload if status == "ok" else None
        except OSError:
            return None


def _service_stats(service) -> dict:
    """The service side of a worker's /stats: the batcher's counters and
    the kernels' launch counts live in THIS process; a worker reading
    its own would report zeros forever."""
    with service.stats_lock:
        runs = dict(service.stats)
    return {"batcher": dict(service.batcher.stats),
            "kernel_launches": kernel_launches(), "service": runs}


class _ServiceHandler(socketserver.BaseRequestHandler):
    def handle(self):
        service = self.server.service
        t0 = time.perf_counter()
        try:
            msg = _recv(self.request)
        except ConnectionError:
            return
        t1 = time.perf_counter()
        if msg[0] == "hello":
            _send(self.request, ("cfg", service.worker_cfg))
            return
        if msg[0] == "stats":
            _send(self.request, ("ok", _service_stats(service)))
            return
        if msg[0] == "warm":
            service.warm_shapes(msg[1])
            _send(self.request, ("ok", None))
            return
        _, keys, images, kinds, deadline = msg
        REQUEST_DEADLINE.set(deadline)
        try:
            plans = [plan_image(*k) for k in keys]
            results = service.runner.run(plans, images, kinds)
            # one connection per run, on a thread of its own: the flag is
            # this run's
            reply = ("ok", results, service.runner.consume_host_mirror_flag())
        except Exception as e:  # the exact type crosses back
            try:
                pickle.dumps(e, protocol=pickle.HIGHEST_PROTOCOL)
            except Exception:
                # an exception that does not pickle would kill this
                # thread inside _send: ship its type's name and message
                e = RuntimeError(f"{type(e).__name__}: {e}")
            reply = ("err", e, False)
        t2 = time.perf_counter()
        try:
            _send(self.request, reply)
        except (ConnectionError, BrokenPipeError):
            pass  # the worker gave up (deadline); nothing to deliver
        t3 = time.perf_counter()
        with service.stats_lock:
            st = service.stats
            st["runs"] += 1
            st["recv_ms_total"] += (t1 - t0) * 1e3
            st["run_ms_total"] += (t2 - t1) * 1e3
            st["send_ms_total"] += (t3 - t2) * 1e3


class _ThreadedUnixServer(socketserver.ThreadingMixIn,
                          socketserver.UnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True
    # socketserver's default backlog is 5: a burst of N workers' requests
    # connects at once, and a connect with a timeout on a full unix
    # backlog fails at once (EAGAIN) instead of waiting
    request_queue_size = socket.SOMAXCONN


class DeviceService:
    """The parent's half: owns the device and the micro-batcher and
    serves the unix socket. Built after the workers fork.

    device: where batches run; None serves on CUDA and raises where
    there is none. Tests pass torch.device("cpu")."""

    def __init__(self, cfg, path: str, device=None):
        device_mod.configure()
        if device is None:
            device = device_mod.cuda_device()
        check_data_parallel(cfg, device)  # counts devices: after the fork
        if device.type == "cuda":
            _build.load()  # compiled by the parent before the fork
            torch.empty(1, device=device)  # the CUDA context, now
        self.device = device
        self.batcher = make_batcher(cfg, device)
        self.runner = BatchingRunner(self.batcher)
        # the socket's share of a worker's f_device: per "run" message,
        # the ms from the handler's start to the request decoded (recv),
        # in the batcher (run) and to the reply sent (send)
        self.stats = {"runs": 0, "recv_ms_total": 0.0, "run_ms_total": 0.0,
                      "send_ms_total": 0.0}
        self.stats_lock = threading.Lock()
        # what the workers must know of the device they cannot see: the
        # port's own rule (build_state), not the JAX package's backend
        # test
        self.worker_cfg = {"device_decode": cfg.tpu.device_decode,
                           "fast": bool(cfg.tpu.fast)}
        self._warmup_on = bool(cfg.tpu.warmup)
        self._device_decode = bool(cfg.tpu.device_decode)
        self._device_dct = bool(cfg.tpu.device_dct)
        self._fast_decode = bool(cfg.tpu.fast_decode)
        self._warmed: set = set()
        self._warm_lock = threading.Lock()
        if self._warmup_on:
            self.warm_shapes(tuple(cfg.tpu.warmup_shapes)
                             or warmup_mod.DEFAULT_SHAPES)
        self._server = _ThreadedUnixServer(path, _ServiceHandler)
        self._server.service = self
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="fanlin-devsvc",
            daemon=True)

    def warm_shapes(self, shapes) -> None:
        """Warm (src_w, src_h, query) shapes in the background, each
        once: every worker reports the same fallback-derived shapes, and
        only the fresh ones run."""
        if not self._warmup_on:
            return
        with self._warm_lock:
            fresh = tuple(s for s in shapes if tuple(s) not in self._warmed)
            self._warmed.update(tuple(s) for s in fresh)
        if not fresh:
            return
        threading.Thread(
            target=warmup_mod.warm, args=(self.batcher, fresh),
            kwargs={"device_decode": self._device_decode,
                    "device_dct": self._device_dct,
                    "fast_decode": self._fast_decode},
            name="fanlin-warmup", daemon=True).start()

    def start(self):
        self._thread.start()

    def stop(self) -> bool:
        """Stop serving the socket and drain the batcher; False when its
        device threads outlived the close budget."""
        self._server.shutdown()
        self._server.server_close()
        return self.batcher.close()


async def _serve_worker_async(cfg, uds_path: str) -> None:
    """One gateway worker: handshake with the device service, build a
    device-less state around a RemoteRunner, serve HTTP on a REUSEPORT
    socket, drain on SIGTERM."""
    start = time.monotonic()
    warned = False
    while True:
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.connect(uds_path)
                _send(s, ("hello",))
                _, worker_cfg = _recv(s)
            break
        except OSError:
            if os.getppid() == 1:
                # reparented: the service process is gone
                raise RuntimeError(
                    "device service died before the handshake") from None
            if not warned and time.monotonic() - start > _HELLO_WARN_S:
                warned = True
                log.warning("device service still starting after %.0f s; "
                            "waiting", time.monotonic() - start)
            await asyncio.sleep(0.05)
    runner = RemoteRunner(uds_path, fast=worker_cfg["fast"])
    state = await build_state(cfg, runner=runner,
                              device_decode=worker_cfg["device_decode"])
    if cfg.tpu.warmup:
        # the fallback images live here: hand their shapes to the
        # service, which warms each fresh one once
        shapes = warmup_mod.shapes_from_state(state,
                                              tuple(cfg.tpu.warmup_shapes))
        warmup_mod.warm_host(shapes)
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.settimeout(10.0)
                s.connect(uds_path)
                _send(s, ("warm", tuple(shapes)))
                _recv(s)
        except OSError:
            log.warning("could not hand the warmup shapes to the service")
    app = create_app(cfg, state)
    app_runner = web.AppRunner(app, access_log=None)
    await app_runner.setup()
    site = web.TCPSite(app_runner, cfg.bind_addr, cfg.port, reuse_port=True)
    await site.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    # one write: the workers' banners must not interleave
    sys.stdout.write(f"fanlin-tpu-torch worker {os.getpid()} listening on "
                     f"{cfg.bind_addr}:{cfg.port}\n")
    sys.stdout.flush()
    await stop.wait()
    await app_runner.cleanup()


def _worker_main(cfg, uds_path: str) -> int:
    # a worker never touches the card: hide it, so that nothing which
    # initialises the CUDA driver in passing (torch.profiler does, even
    # for the host-only capture of tpu.profile_dir) opens it here
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    _die_with_parent()
    asyncio.run(_serve_worker_async(cfg, uds_path))
    return 0


def _die_with_parent() -> None:
    """PR_SET_PDEATHSIG: if the parent dies without draining us (SIGKILL,
    the OOM killer), take SIGTERM instead of living on as an orphan that
    holds the port and answers 500 forever."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(1, signal.SIGTERM, 0, 0, 0)  # PR_SET_PDEATHSIG
    if os.getppid() == 1:  # the parent died before the prctl
        os.kill(os.getpid(), signal.SIGTERM)


def _reap(children: list, timeout: float) -> None:
    """Wait for each pid in `children` (removing it) up to `timeout`
    seconds in all; SIGKILL and reap whatever is left."""
    deadline = time.monotonic() + timeout
    while children and time.monotonic() < deadline:
        for pid in list(children):
            try:
                done, _ = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                done = pid
            if done:
                children.remove(pid)
        if children:
            time.sleep(0.05)
    for pid in children:
        log.error("worker %d did not drain in %.0f s: killed", pid, timeout)
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass
    children.clear()


def serve_multiworker(cfg, device=None) -> int:
    """Parent entry point: compile the native code, fork the workers,
    bring up the device service, supervise, drain on SIGTERM/SIGINT.

    device: the service's device; None serves on CUDA (and compiles the
    CUDA kernels first). Tests pass torch.device("cpu")."""
    n = max(int(cfg.tpu.workers), 2)
    # compile before the fork: N workers must not each build the host
    # reader, and no compiler may run under the supervisor's loop. The
    # native codec core loads (or builds) here once for every worker,
    # and with tpu.warmup the host side of a first request is paid here
    # once (the workers' fallback shapes warm in each worker).
    if device is None or device.type == "cuda":
        _build.build()
    _build.build_host()
    native_codecs.available()
    if cfg.tpu.warmup:
        warmup_mod.warm_host(tuple(cfg.tpu.warmup_shapes)
                             + warmup_mod.DEFAULT_SHAPES)
    tmpdir = tempfile.mkdtemp(prefix="fanlin-dev-")
    os.chmod(tmpdir, 0o700)
    uds_path = os.path.join(tmpdir, "device.sock")

    children = []
    sys.stdout.flush()  # a child must not inherit buffered output
    sys.stderr.flush()
    for _ in range(n):
        pid = os.fork()
        if pid == 0:
            code = 1
            try:
                code = _worker_main(cfg, uds_path)
            except BaseException:  # the child must not unwind the parent's stack
                log.exception("worker %d crashed", os.getpid())
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(code)
        children.append(pid)

    # the stop handlers come before the service starts: a SIGTERM
    # during startup must drain the forked workers, not orphan them
    stop = {"flag": False}

    def _on_term(_sig, _frm):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)

    service = None
    died = 0
    try:
        try:
            service = DeviceService(cfg, uds_path, device)
        except config_mod.ConfigError as e:
            # what only the device can tell (tpu.data_parallel's count):
            # no worker may go on serving 502s without a service
            print(f"failed to start: {e}", file=sys.stderr, flush=True)
            return 1
        service.start()
        print(f"fanlin-tpu-torch device service {os.getpid()} up ({n} "
              f"workers on {cfg.bind_addr}:{cfg.port}, {service.device})",
              flush=True)
        while not stop["flag"] and children:
            for pid in list(children):
                done, status = os.waitpid(pid, os.WNOHANG)
                if done:
                    children.remove(pid)
                    died += 1
                    log.error("worker %d exited with code %d", pid,
                              os.waitstatus_to_exitcode(status))
            time.sleep(0.05)
    finally:
        # drain: the workers finish their in-flight requests, which may
        # still need the service, so it stops after them
        for pid in children:
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
        _reap(children, _DRAIN_S)
        clean = service.stop() if service is not None else True
        shutil.rmtree(tmpdir, ignore_errors=True)
    # non-zero when every worker died on its own, so a supervisor that
    # restarts on failure restarts the gateway
    code = 0 if stop["flag"] else (1 if died else 0)
    if not clean:
        # device threads stuck past the batcher's close budget would
        # hold interpreter exit; the workers are drained already
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    return code
