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
  requested, Server-Timing with f_fetch / f_process marks.

One process, one device. The engine serves through the micro-batcher
(`engine.batcher`, `tpu.max_batch`, `batch_window_ms`,
`pipeline_depth`, `max_queue`): concurrent requests of one shape group
share a device batch. There is no mesh, compile cache or warmup yet.
Config options whose code is not in the port raise at startup
(`check_ported`).
"""

from __future__ import annotations

import asyncio
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
from ..engine.batcher import (REQUEST_CANCEL, REQUEST_DEADLINE,
                              BatcherOverload, BatchingRunner, MicroBatcher,
                              RequestExpired)
from ..infra import Client
from ..ops import jpeg_decode_kernels, resample_kernels
from ..spec import content as content_mod
from ..spec import query as query_mod
from ..utils.bytelru import ByteLRU
from .state import State
from .timing import HEADER_KEY as TIMING_HEADER
from .timing import Timer

log = logging.getLogger("fanlin.server")

STATE_KEY = web.AppKey("state", object)

CONTENT_TYPE_TEXT_PLAIN = "text/plain; charset=utf-8"
VARY_ACCEPT = "Accept"
REQUEST_TIMEOUT_SECS = 10.0  # tower TimeoutLayer (main.rs:105-107)

# Config options whose code is not in the port yet: serving them would
# silently serve something else, so startup refuses them.
_UNPORTED = (
    ("tpu.device_dct", lambda c: c.tpu.device_dct),
    ("tpu.fast_decode", lambda c: c.tpu.fast_decode),
    ("tpu.device_icc", lambda c: c.tpu.device_icc),
    ("tpu.fast", lambda c: c.tpu.fast),
    ("tpu.workers > 0", lambda c: c.tpu.workers > 0),
    ("tpu.data_parallel", lambda c: c.tpu.data_parallel),
    ("tpu.source_cache_mb > 0", lambda c: c.tpu.source_cache_mb > 0),
    ("tpu.profile_dir", lambda c: bool(c.tpu.profile_dir)),
    ("profile_path", lambda c: bool(c.profile_path)),
    ("use_embedded_profile", lambda c: bool(c.use_embedded_profile)),
)


def check_ported(cfg: config_mod.Config) -> None:
    """Raise ConfigError naming every set option the port lacks."""
    bad = [name for name, is_set in _UNPORTED if is_set(cfg)]
    if bad:
        raise config_mod.ConfigError(
            "not yet supported by the PyTorch port (fanlin_tpu_torch): "
            + ", ".join(bad)
        )


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
    timer.add("f_fetch")
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
    for name, dur in marks:
        timer.add_duration(name, dur)
    timer.add("f_process")
    headers = _create_headers(mime, params, timer)
    if cache is not None:
        cache.put(cache_key, (mime, processed), len(processed) + 256)
    return web.Response(status=200, headers=headers, body=processed)


async def ping_handler(request: web.Request) -> web.Response:
    # axum's route("/ping", get(..)) answers other methods with 405
    if request.method not in ("GET", "HEAD"):
        return web.Response(status=405, headers={"Allow": "GET, HEAD"})
    return web.Response(text="pong")


async def stats_handler(request: web.Request) -> web.Response:
    """Additive observability endpoint (the reference has none):
    engine and batcher counters, the CUDA kernels' launch counts, cache
    stats."""
    state: State = request.app[STATE_KEY]
    batcher = getattr(state.engine.runner, "batcher", None)
    body = {
        "engine": dict(state.engine.stats),
        "batcher": dict(batcher.stats) if batcher is not None else None,
        "kernel_launches": {**resample_kernels.launch_counts(),
                            **jpeg_decode_kernels.launch_counts()},
        "caches": {
            "responses": (state.response_cache.stats()
                          if state.response_cache is not None else None),
        },
    }
    return web.Response(text=json.dumps(body), content_type="application/json")


@web.middleware
async def trace_middleware(request: web.Request, handler):
    t0 = time.perf_counter()
    response = await handler(request)
    latency_ms = (time.perf_counter() - t0) * 1000.0
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


def make_timeout_middleware(timeout: float):
    @web.middleware
    async def timeout_middleware(request: web.Request, handler):
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


def make_concurrency_middleware(max_clients: int):
    semaphore = asyncio.Semaphore(max_clients)

    @web.middleware
    async def concurrency_middleware(request: web.Request, handler):
        async with semaphore:  # queues like tower ConcurrencyLimitLayer
            return await handler(request)

    return concurrency_middleware


def create_app(cfg: config_mod.Config, state: State) -> web.Application:
    app = web.Application(
        middlewares=[
            trace_middleware,
            make_timeout_middleware(REQUEST_TIMEOUT_SECS),
            make_concurrency_middleware(cfg.max_clients),
        ],
        client_max_size=1024**3,
    )
    app[STATE_KEY] = state
    app.router.add_route("*", "/ping", ping_handler)
    app.router.add_get("/stats", stats_handler)
    # axum's .fallback() catches every method (main.rs:90)
    app.router.add_route("*", "/{tail:.*}", generic_handler)

    async def _cleanup(app_):
        await state.client.close()
        batcher = getattr(state.engine.runner, "batcher", None)
        if batcher is not None and not batcher.close():
            log.error("batcher close timed out: device threads still busy")

    app.on_cleanup.append(_cleanup)
    return app


async def build_state(cfg: config_mod.Config,
                      device: Optional[torch.device] = None) -> State:
    """Startup sequence, mirroring reference main() (main.rs:63-81):
    option check -> device -> micro-batcher -> infra client -> state
    -> fallback preload (failure only warns). The engine serves through
    the micro-batcher (fanlin_tpu/server/app.py:488-495); the batcher's
    failover knobs (`host_fallback`, `device_stall_s`, `spill_wait_ms`)
    are not ported and do nothing.

    device: where the engine runs; defaults to CUDA and raises when
    CUDA is absent. Tests pass torch.device("cpu") explicitly."""
    check_ported(cfg)
    device_mod.configure()
    if device is None:
        device = device_mod.cuda_device()
    native_codecs.set_webp_method(cfg.tpu.webp_method)
    batcher = MicroBatcher(cfg.tpu.max_batch, cfg.tpu.batch_window_ms,
                           device=device,
                           pipeline_depth=cfg.tpu.pipeline_depth,
                           max_queue=cfg.tpu.max_queue)
    engine = Engine(device, runner=BatchingRunner(batcher),
                    device_decode=cfg.tpu.device_decode)
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
    return state
