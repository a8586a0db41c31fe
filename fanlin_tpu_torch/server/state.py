"""Gateway state: provider routing, origin dispatch, fallback images.

Port of fanlin_tpu/server/state.py (reference src/handler.rs:13-183)
around the port's `Engine`; routing, origins and paths are the port's
copies of the JAX package's host modules (`server.router`, `infra`,
`utils.paths`):

* ``get_image`` routes the request path to a provider and dispatches
  on the src URI scheme (s3 / http / https / file); unknown schemes
  and unrouted paths resolve to None (-> 404) — handler.rs:154-183.
* Fallback images are preloaded at startup through the same fetch
  path (global + per-provider) and re-processed per request with the
  live query params — handler.rs:103-146.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlsplit

from .. import config as config_mod
from ..engine import Engine
from ..engine.icc import CMYK2RGB
from ..infra import Client
from ..spec import content as content_mod
from ..spec import query as query_mod
from ..utils import paths, profiling
from .router import Router

log = logging.getLogger("fanlin.server")


class State:
    def __init__(self, providers: List[config_mod.Provider], client: Client,
                 engine: Engine, singleflight: bool = True):
        self.router = Router(providers)
        self.client = client
        self.engine = engine
        self.fallback_images: Dict[str, bytes] = {}
        self.fallback_path = ""
        # singleflight: concurrent fetches of the same path share ONE
        # origin request (cache-stampede protection)
        self.singleflight = singleflight
        self._inflight: Dict[str, asyncio.Future] = {}
        # optional full-response cache (tpu.response_cache_mb)
        self.response_cache = None

    # -- color management wiring (reference handler.rs:85-101) ------------

    def create_cmyk_to_rgb_converter(self, path) -> None:
        conv = CMYK2RGB.from_file(path)
        if conv is None:
            log.warning("failed to load an icc profile or create a transform; %s", path)
        else:
            self.engine.cmyk2rgb = conv

    def enable_embedded_profile_utilization(self) -> None:
        self.engine.use_embedded_profile = True

    # -- fallback preload (reference handler.rs:103-146) -------------------

    async def with_fallback(self, path: Optional[str],
                            providers: List[config_mod.Provider]) -> None:
        if path:
            img = await self.get_image(path)
            if img is not None:
                self.fallback_images[path] = img
                self.fallback_path = path
        for p in providers:
            if p.fallback_path:
                img = await self.get_image(p.fallback_path)
                if img is not None:
                    self.fallback_images[p.fallback_path] = img

    def fallback(self, req_path: str, params: query_mod.Query,
                 accepted: content_mod.Format) -> Tuple[str, bytes]:
        """Provider fallback image, else global, else error. The image
        is processed with the live params (handler.rs:124-146)."""
        provider = self.router.at(req_path)
        img = None
        if provider is not None:
            img = self.fallback_images.get(provider.fallback_path)
        if img is None:
            img = self.fallback_images.get(self.fallback_path)
        if img is None:
            raise LookupError("fallback image uninitialized")
        return self.engine.process_image(img, params, accepted)

    def treat_as_success_even_no_content(self, req_path: str) -> bool:
        p = self.router.at(req_path)
        return p is not None and p.success_even_no_content

    # -- origin dispatch (reference handler.rs:154-183) --------------------

    async def get_image(self, req_path: str) -> Optional[bytes]:
        if not self.singleflight:
            return await self._fetch_origin(req_path)
        inflight = self._inflight.get(req_path)
        if inflight is not None:
            try:
                return await asyncio.shield(inflight)
            except asyncio.CancelledError:
                # the LEADER was cancelled (timeout or client
                # disconnect): fetch ourselves instead of hanging. If
                # WE were cancelled, the shared future is untouched.
                if inflight.cancelled():
                    return await self._fetch_origin(req_path)
                raise
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        # swallow "exception was never retrieved" for abandoned waiters
        fut.add_done_callback(
            lambda f: f.exception() if not f.cancelled() else None
        )
        self._inflight[req_path] = fut
        try:
            result = await self._fetch_origin(req_path)
        except BaseException as e:
            # resolve the shared future either way so coalesced
            # followers never hang, then re-raise
            if isinstance(e, asyncio.CancelledError):
                if not fut.done():
                    fut.cancel()
            else:
                fut.set_exception(e)
            raise
        else:
            fut.set_result(result)
            return result
        finally:
            self._inflight.pop(req_path, None)

    async def _fetch_origin(self, req_path: str) -> Optional[bytes]:
        provider = self.router.at(req_path)
        if provider is None:
            return None
        scheme = urlsplit(provider.src).scheme
        if scheme == "s3":
            bucket, key = paths.build_bucket_and_object_key(
                provider.src, provider.path, req_path
            )
            return await self.client.s3.get_object(bucket, key)
        if scheme in ("http", "https"):
            url = paths.build_url(provider.src, provider.path, req_path)
            return await self.client.web.get(url)
        if scheme == "file":
            local = paths.build_local_path(provider.src, provider.path, req_path)
            return await self.client.file.read(local)
        return None

    async def process_image_async(self, data: bytes, params, accepted,
                                  marks=None):
        """Run the (blocking, device-bound) engine off the event loop,
        on a codec thread. The wait for one is counted by the engine
        (`Engine.note_pool_wait`: `fanlin.engine.pool_wait`); the way
        back from it to the loop is the `fanlin.engine.pool_return`
        span."""
        out, t_done = await asyncio.to_thread(
            self._process_on_pool, time.perf_counter_ns(), data, params,
            accepted, marks)
        if profiling.on():
            profiling.record("fanlin.engine.pool_return", t_done,
                             time.perf_counter_ns(),
                             profiling.REQUEST_ID.get())
        return out

    def _process_on_pool(self, t_submit_ns: int, data: bytes, params,
                         accepted, marks):
        self.engine.note_pool_wait(t_submit_ns, time.perf_counter_ns())
        out = self.engine.process_image(data, params, accepted, marks)
        return out, time.perf_counter_ns()
