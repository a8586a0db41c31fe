"""The HTTP gateway of the PyTorch port.

Port of fanlin_tpu/server/app.py (aiohttp implementation of the
reference's axum server, reference src/main.rs:88-294) with identical
request semantics:

* ``GET /ping`` -> "pong" (main.rs:89);
* every other path is the generic image handler (main.rs:127-197):
  400 on size-range violations or malformed query types, 404/200 on
  origin miss (per-provider success_even_no_content), 500 on fetch or
  processing errors — all three served with the fallback image when
  one is configured;
* middleware: request trace log with latency (ms), 10 s timeout ->
  408, concurrency cap = max_clients (main.rs:91-111); the timeout
  middleware publishes the request's deadline and cancel event to the
  micro-batcher, which sheds abandoned requests before device work;
* response headers: Content-Type, Vary: Accept when webp/avif was
  requested, Server-Timing with f_fetch / f_process marks; a response
  that a batch of the host mirror served (`engine.processor.COLD_MARK`:
  a stalled or wedged device, see `engine.batcher`) also carries `X-Cache-Warmth: cold` and
  `Cache-Control: no-store`, and never enters the response cache;
* with ``tpu.profile_dir``, ``GET /profile?seconds=N``: a torch.profiler
  capture of this process into that directory (`make_profile_handler`),
  exempt from the request timeout, holding the port's own spans
  (`utils.profiling`): every request gets an id (`trace_middleware`)
  that its spans, and the batches that served it, carry;
* ``GET /stats``: the gateway's, the engine's and the batcher's
  counters, read as a window with `t_ms` (`stats_handler`).

One device. The engine serves through the micro-batcher
(`engine.batcher`, `tpu.max_batch`, `batch_window_ms`,
`pipeline_depth`, `max_queue`): concurrent requests of one shape group
share a device batch, and the host mirror serves while the card does
not answer (`tpu.host_fallback`, `device_stall_s`). With `tpu.workers` >
1 this gateway runs in N
worker processes around one device service (`server.workers`); the
CLI warms the kernels and caches at startup (`tpu.warmup`,
`engine.warmup`); `tpu.source_cache_mb` caches decoded sources
(`engine.source_cache`); `tpu.fast_decode` routes YCbCr coefficient
sources through the folded decode-resize; `tpu.fast` runs the resample
products in bf16 (the batcher and the Engine hold it). There is no mesh:
`tpu.data_parallel` serves unsharded on one device, as the reference
does there, and is refused where more than one is visible
(`check_data_parallel`). Config options whose code is not in the port
raise at startup (`check_ported`). Accepted but inert:
`tpu.spill_wait_ms` (the reference's queue-pressure spillover to the
mirror, left out: see `engine.batcher`), `tpu.dct_pack_floor` (jpegdct batches always download full int16
coefficients, the reference's widest pack level) and, on one device,
`tpu.mesh_sp`.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import threading
import time
from typing import Optional

import torch
from aiohttp import web

from .. import config as config_mod
from .. import device as device_mod
from ..engine import Engine, native_codecs
from ..engine.processor import COLD_MARK
from ..engine.source_cache import SourceCache
from ..engine.batcher import (REQUEST_CANCEL, REQUEST_DEADLINE,
                              BatcherOverload, BatchingRunner, MicroBatcher,
                              RequestExpired)
from ..infra import Client
from ..ops import cmyk_lut_kernels, jpeg_decode_kernels, resample_kernels
from ..spec import content as content_mod
from ..spec import query as query_mod
from ..utils import profiling
from ..utils.bytelru import ByteLRU
from .state import State
from .timing import HEADER_KEY as TIMING_HEADER
from .timing import Timer

log = logging.getLogger("fanlin.server")

STATE_KEY = web.AppKey("state", object)
# the gateway's counters (/stats "gateway"): the wait at the max_clients
# semaphore, summed over the requests it admitted
GATEWAY_STATS_KEY = web.AppKey("gateway_stats", dict)
# request ids (`profiling.REQUEST_ID`), one per request of the process
_REQUEST_IDS = itertools.count(1)

CONTENT_TYPE_TEXT_PLAIN = "text/plain; charset=utf-8"
VARY_ACCEPT = "Accept"
REQUEST_TIMEOUT_SECS = 10.0  # tower TimeoutLayer (main.rs:105-107)

# Config options whose code is not in the port yet: serving them would
# silently serve something else, so startup refuses them. Spectral
# thinning (lossy upload thinning of folded batches) rides the
# narrow-link pack modes, which the port's dense wire lacks.
_UNPORTED = (
    ("tpu.spectral_db with tpu.fast_decode",
     lambda c: c.tpu.fast_decode and c.tpu.spectral_db > 0),
)


def check_ported(cfg: config_mod.Config) -> None:
    """Raise ConfigError naming every set option the port lacks."""
    bad = [name for name, is_set in _UNPORTED if is_set(cfg)]
    if bad:
        raise config_mod.ConfigError(
            "not yet supported by the PyTorch port (fanlin_tpu_torch): "
            + ", ".join(bad)
        )


def check_data_parallel(cfg: config_mod.Config, device: torch.device) -> None:
    """`tpu.data_parallel` on the process that owns `device`: with one
    device visible the batches run unsharded, as in the reference
    (fanlin_tpu/server/app.py:469-486), and `tpu.mesh_sp` does nothing;
    with more the multi-device mesh would be needed, which the port
    lacks, so it raises ConfigError rather than serve from one of them.
    Counts the devices, so it runs only where CUDA may be touched."""
    if not cfg.tpu.data_parallel:
        return
    n = device_mod.device_count(device)
    if n > 1:
        raise config_mod.ConfigError(
            f"tpu.data_parallel with {n} {device.type} devices: the "
            "multi-device mesh is not yet in the PyTorch port "
            "(fanlin_tpu_torch); set data_parallel to false, or make one "
            "device visible")
    log.info("tpu.data_parallel: one %s device, batches run unsharded",
             device.type)


def _create_headers(content_type: str, params: query_mod.Query,
                    timer: Optional[Timer] = None) -> dict:
    headers = {"Content-Type": content_type}
    if params.use_webp() or params.use_avif():
        headers["Vary"] = VARY_ACCEPT
    if timer is not None:
        headers[TIMING_HEADER] = timer.header_value()
    return headers


async def _fallback_or_message(state: State, req_path: str,
                               params: query_mod.Query,
                               accepted: content_mod.Format, status: int,
                               message: str) -> web.Response:
    try:
        # fallback images are re-processed with the live params
        # (handler.rs:134-137) — device-bound work stays off the loop
        mime, processed = await asyncio.to_thread(
            state.fallback, req_path, params, accepted
        )
        return web.Response(
            status=status, headers=_create_headers(mime, params), body=processed
        )
    except Exception:
        return web.Response(
            status=status,
            headers=_create_headers(CONTENT_TYPE_TEXT_PLAIN, params),
            text=message,
        )


async def generic_handler(request: web.Request) -> web.Response:
    state: State = request.app[STATE_KEY]
    try:
        params = query_mod.parse_query(request.query_string)
    except query_mod.QueryError as e:
        return web.Response(
            status=400, text=f"Failed to deserialize query string: {e}"
        )
    if params.unsupported_scale_size():
        return web.Response(
            status=400,
            headers=_create_headers(CONTENT_TYPE_TEXT_PLAIN, params),
            text=f"supported width and height: {query_mod.size_range_info()}",
        )
    timer = Timer()
    accepted = content_mod.extract_accepted_image_formats(
        request.headers.getall("Accept", [])
    )
    # the raw (still percent-encoded) path, like axum's uri.path(): the
    # single decode happens inside clean_path (handler.rs:558)
    path = request.rel_url.raw_path
    # optional full-response cache (tpu.response_cache_mb), keyed on
    # raw path + query + the Accept bits that change the output format
    cache = state.response_cache
    cache_key = None
    if cache is not None:
        cache_key = (path, request.query_string,
                     accepted.webp_accepted(), accepted.avif_accepted())
        hit = cache.get(cache_key)
        if hit is not None:
            mime, processed = hit
            headers = _create_headers(mime, params)
            headers["X-Cache"] = "hit"
            return web.Response(status=200, headers=headers, body=processed)
    try:
        original = await state.get_image(path)
    except Exception as err:
        log.error("failed to get an original image; %s %r", path, err)
        return await _fallback_or_message(
            state, path, params, accepted, 500, "server error on fetching an image"
        )
    if original is None:
        status = 200 if state.treat_as_success_even_no_content(path) else 404
        return await _fallback_or_message(
            state, path, params, accepted, status, "not found"
        )
    t0, t1 = timer.add("f_fetch")
    if profiling.on():
        profiling.record("fanlin.origin.fetch", t0, t1,
                         profiling.REQUEST_ID.get())
    marks: list = []
    try:
        mime, processed = await state.process_image_async(
            original, params, accepted, marks
        )
    except Exception as err:
        if isinstance(err, BatcherOverload):
            # admission control (tpu.max_queue): shed, don't queue
            return web.Response(status=503, text="server overloaded")
        if isinstance(err, RequestExpired):
            # the batcher shed the entry at its deadline; the timeout
            # middleware has usually answered 408 already
            return web.Response(status=408)
        log.error("failed to process an image; %s %r", path, err)
        return await _fallback_or_message(
            state, path, params, accepted, 500, "server error on processing an image"
        )
    cold = any(name == COLD_MARK for name, _ in marks)
    for name, dur in marks:
        if name != COLD_MARK:
            timer.add_duration(name, dur)
    timer.add("f_process")
    headers = _create_headers(mime, params, timer)
    if cold:
        # served by the host mirror (within 1 LSB of the card): no cache
        # or CDN may keep these bytes
        headers["X-Cache-Warmth"] = "cold"
        headers["Cache-Control"] = "no-store"
    elif cache is not None:
        cache.put(cache_key, (mime, processed), len(processed) + 256)
    return web.Response(status=200, headers=headers, body=processed)


async def ping_handler(request: web.Request) -> web.Response:
    # axum's route("/ping", get(..)) answers other methods with 405
    if request.method not in ("GET", "HEAD"):
        return web.Response(status=405, headers={"Allow": "GET, HEAD"})
    return web.Response(text="pong")


def kernel_launches() -> dict:
    """This process's launch counts of every CUDA kernel."""
    return {**resample_kernels.launch_counts(),
            **jpeg_decode_kernels.launch_counts(),
            **cmyk_lut_kernels.launch_counts()}


async def stats_handler(request: web.Request) -> web.Response:
    """Additive observability endpoint (the reference has none):
    gateway, engine and batcher counters, the CUDA kernels' launch
    counts, cache stats, and `t_ms`, this process's monotonic clock at
    the read in ms: a reader divides the counters' deltas between two
    reads by its delta. In a gateway worker the batcher and the kernels
    live in the device service: their counters come from there (None
    when it does not answer); the gateway, the engine and the caches
    are this worker's."""
    state: State = request.app[STATE_KEY]
    runner = state.engine.runner
    extra = {}
    if hasattr(runner, "service_stats"):
        service = await asyncio.to_thread(runner.service_stats) or {}
        batcher_stats = service.get("batcher")
        launches = service.get("kernel_launches")
        # the socket's share of f_device (server.workers)
        extra["service"] = service.get("service")
    else:
        batcher = getattr(runner, "batcher", None)
        batcher_stats = dict(batcher.stats) if batcher is not None else None
        launches = kernel_launches()
    scache = state.engine.source_cache
    body = {
        "t_ms": time.monotonic() * 1e3,
        "gateway": dict(request.app[GATEWAY_STATS_KEY]),
        "engine": {**state.engine.stats, **state.engine.read_stats,
                   **state.engine.pool_stats},
        "batcher": batcher_stats,
        "kernel_launches": launches,
        "caches": {
            "responses": (state.response_cache.stats()
                          if state.response_cache is not None else None),
            "sources": scache.stats() if scache is not None else None,
        },
        **extra,
    }
    return web.Response(text=json.dumps(body), content_type="application/json")


@web.middleware
async def trace_middleware(request: web.Request, handler):
    """The request log line, and the request's id
    (`profiling.REQUEST_ID`, which every span of the request carries) and
    its `fanlin.request` span."""
    t0 = time.perf_counter_ns()
    rid = next(_REQUEST_IDS)
    profiling.REQUEST_ID.set(rid)
    response = await handler(request)
    t1 = time.perf_counter_ns()
    if profiling.on():
        profiling.record("fanlin.request", t0, t1, rid, path=request.path,
                         status=response.status)
    latency_ms = (t1 - t0) / 1e6
    log.info(
        "request",
        extra={
            "fields": {
                "method": request.method,
                "uri": request.path_qs,
                "status": response.status,
                "latency_ms": round(latency_ms, 3),
            }
        },
    )
    return response


def make_profile_handler(profile_dir: str, cuda: bool):
    """GET /profile?seconds=N (`tpu.profile_dir`; fanlin_tpu/server/
    app.py:237-276 captures with jax.profiler): a torch.profiler capture
    of N seconds (clamped to 0.1-60; 400 when N is no number) of this
    process, written into profile_dir as a Chrome trace. `cuda`: record
    the card's activity too (CUPTI, process-wide); a gateway worker
    passes False, as it must never initialise CUDA, so its trace holds
    only its own host activity. One capture at a time: a second request
    gets 409, as does one while another capture of the port runs in the
    process (`utils.profiling.exclusive`); a capture that fails answers
    500 with the reason. Call it on the thread that imported torch
    (`utils.profiling.prepare`): create_app does, on the main thread."""
    # captures run on worker threads; Kineto must start on this one
    profiling.prepare(cuda)

    async def profile_handler(request: web.Request) -> web.Response:
        try:
            seconds = min(max(float(request.query.get("seconds", 3)), 0.1),
                          60.0)
        except ValueError:
            return web.Response(status=400, text="bad seconds")
        try:
            path = await asyncio.to_thread(profiling.capture_trace,
                                           profile_dir, seconds, cuda)
        except profiling.ProfilerBusy as e:
            return web.Response(status=409, text=str(e))
        except Exception as e:
            log.error("profile capture failed; %r", e)
            return web.Response(status=500, text=f"profile failed: {e!r}")
        return web.Response(
            text=json.dumps({"trace_dir": profile_dir, "seconds": seconds,
                             "trace_file": path}),
            content_type="application/json")

    return profile_handler


def make_timeout_middleware(timeout: float, profile_route: bool = False):
    @web.middleware
    async def timeout_middleware(request: web.Request, handler):
        if (profile_route and request.path == "/profile"
                and request.method == "GET"):
            # a capture runs up to 60 s and cannot be interrupted: a 408
            # would answer while it still runs. Only where the route is
            # registered and for GET: otherwise /profile is an image
            # path like any other
            return await handler(request)
        # the engine's worker thread inherits both through
        # asyncio.to_thread's context copy: the batcher sheds an entry
        # whose deadline passed or whose event fired before it pays
        # staging or device time
        REQUEST_DEADLINE.set(time.monotonic() + timeout)
        cancel_ev = threading.Event()
        REQUEST_CANCEL.set(cancel_ev)
        try:
            return await asyncio.wait_for(handler(request), timeout=timeout)
        except asyncio.TimeoutError:
            cancel_ev.set()
            return web.Response(status=408)  # tower Timeout -> 408
        except asyncio.CancelledError:
            # client disconnect: work already handed to a thread or the
            # batcher is not interrupted by the task's cancellation
            cancel_ev.set()
            raise

    return timeout_middleware


def make_concurrency_middleware(max_clients: int, stats: dict):
    """The max_clients cap; the wait for it is added to `stats`
    (`admit_wait_ms_total`, `requests`) and is the request's
    `fanlin.gateway.admit` span."""
    semaphore = asyncio.Semaphore(max_clients)

    @web.middleware
    async def concurrency_middleware(request: web.Request, handler):
        t0 = time.perf_counter_ns()
        async with semaphore:  # queues like tower ConcurrencyLimitLayer
            t1 = time.perf_counter_ns()
            # the event loop's thread alone: no lock
            stats["admit_wait_ms_total"] += (t1 - t0) / 1e6
            stats["requests"] += 1
            if profiling.on():
                profiling.record("fanlin.gateway.admit", t0, t1,
                                 profiling.REQUEST_ID.get())
            return await handler(request)

    return concurrency_middleware


def create_app(cfg: config_mod.Config, state: State) -> web.Application:
    gateway_stats = {"admit_wait_ms_total": 0.0, "requests": 0}
    app = web.Application(
        middlewares=[
            trace_middleware,
            make_timeout_middleware(REQUEST_TIMEOUT_SECS,
                                    profile_route=bool(cfg.tpu.profile_dir)),
            make_concurrency_middleware(cfg.max_clients, gateway_stats),
        ],
        client_max_size=1024**3,
    )
    app[STATE_KEY] = state
    app[GATEWAY_STATS_KEY] = gateway_stats
    app.router.add_route("*", "/ping", ping_handler)
    app.router.add_get("/stats", stats_handler)
    if cfg.tpu.profile_dir:
        # a gateway worker's engine has no device: host activity only
        device = state.engine.device
        app.router.add_get("/profile", make_profile_handler(
            cfg.tpu.profile_dir,
            cuda=device is not None and device.type == "cuda"))
    # axum's .fallback() catches every method (main.rs:90)
    app.router.add_route("*", "/{tail:.*}", generic_handler)

    async def _cleanup(app_):
        await state.client.close()
        batcher = getattr(state.engine.runner, "batcher", None)
        if batcher is not None and not batcher.close():
            log.error("batcher close timed out: device threads still busy")

    app.on_cleanup.append(_cleanup)
    return app


def make_batcher(cfg: config_mod.Config, device: torch.device) -> MicroBatcher:
    """The micro-batcher of a config (the single process's, or the
    device service's in worker mode)."""
    return MicroBatcher(
        cfg.tpu.max_batch, cfg.tpu.batch_window_ms, device=device,
        pipeline_depth=cfg.tpu.pipeline_depth, max_queue=cfg.tpu.max_queue,
        fast=cfg.tpu.fast, host_fallback=cfg.tpu.host_fallback,
        device_stall_s=cfg.tpu.device_stall_s)


async def build_state(cfg: config_mod.Config,
                      device: Optional[torch.device] = None, runner=None,
                      device_decode: Optional[bool] = None) -> State:
    """Startup sequence, mirroring reference main() (main.rs:63-81):
    option check -> device -> its count under `tpu.data_parallel`
    (`check_data_parallel`) -> micro-batcher -> infra client -> state
    -> fallback preload (failure only warns) -> the ICC profile, its
    device LUT (`tpu.device_icc`) and embedded profiles. The engine
    serves through
    the micro-batcher (fanlin_tpu/server/app.py:488-495), built with the
    failover knobs (`host_fallback`, `device_stall_s`);
    `spill_wait_ms` and `dct_pack_floor` are not ported and do nothing.

    device: where the engine runs; defaults to CUDA and raises when
    CUDA is absent. Tests pass torch.device("cpu") explicitly.
    runner: a gateway worker's server.workers.RemoteRunner
    (fanlin_tpu/server/app.py:451-459). With a runner no batcher is
    built and no device is touched here, CMYK stays on host lcms2
    (`device_icc` needs a local batcher), and `device_decode` is the
    device service's (default: `tpu.device_decode`)."""
    check_ported(cfg)
    if runner is None:
        device_mod.configure()
        if device is None:
            device = device_mod.cuda_device()
        check_data_parallel(cfg, device)
        runner = BatchingRunner(make_batcher(cfg, device))
    if device_decode is None:
        device_decode = cfg.tpu.device_decode
    native_codecs.set_webp_method(cfg.tpu.webp_method)
    if cfg.tpu.spectral_db > 0:
        # refused with fast_decode (check_ported); alone it never acts
        log.warning("tpu.spectral_db set without tpu.fast_decode: spectral "
                    "thinning only applies to folded batches and will not "
                    "activate")
    engine = Engine(device, runner=runner, device_decode=device_decode,
                    device_dct=cfg.tpu.device_dct,
                    fast_decode=cfg.tpu.fast_decode, fast=cfg.tpu.fast)
    if cfg.tpu.source_cache_mb:
        engine.source_cache = SourceCache(cfg.tpu.source_cache_mb)
    # the codec threads: tpu.codec_threads of them, or with 0 the loop's
    # default executor (asyncio's: min(32, os.cpu_count() + 4) threads),
    # which the file origin's reads share
    if cfg.tpu.codec_threads:
        from concurrent.futures import ThreadPoolExecutor

        asyncio.get_running_loop().set_default_executor(
            ThreadPoolExecutor(cfg.tpu.codec_threads,
                               thread_name_prefix="fanlin-codec")
        )
    state = State(cfg.providers, Client.new(cfg), engine,
                  singleflight=cfg.tpu.singleflight)
    if cfg.tpu.response_cache_mb:
        state.response_cache = ByteLRU(cfg.tpu.response_cache_mb * 1024 * 1024)
    try:
        await state.with_fallback(cfg.fallback_path, cfg.providers)
    except Exception as err:
        log.warning("failed to initialize fallback images; %r", err)
    # colour management (fanlin_tpu/server/app.py:548-572): a profile that
    # does not load only warns, and CMYK then serves as without one. The
    # JAX gateway bounds the LUT upload and falls back to host lcms2 on a
    # wedged link; here a failed upload raises and the server does not
    # start (the fallback would serve other bytes).
    if cfg.profile_path:
        state.create_cmyk_to_rgb_converter(cfg.profile_path)
        if cfg.tpu.device_icc and isinstance(runner, BatchingRunner):
            state.engine.enable_device_icc()
    if cfg.use_embedded_profile:
        state.enable_embedded_profile_utilization()
    return state
