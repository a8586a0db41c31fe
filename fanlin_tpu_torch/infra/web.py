"""HTTP(S) origin client (reference src/infra/web.rs:5-44).

Error semantics match the reference exactly: 404 -> None; any other
non-success status OR transport error -> warn + None (bad upstreams
become 404s at the gateway, never 500s)."""

from __future__ import annotations

import logging
from typing import Optional

import aiohttp

from ..config import WebConfig

log = logging.getLogger("fanlin.infra.web")


class WebClient:
    def __init__(self, cfg: WebConfig):
        self._user_agent = cfg.user_agent
        self._timeout = aiohttp.ClientTimeout(total=cfg.timeout)
        self._session: Optional[aiohttp.ClientSession] = None

    def _get_session(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(
                timeout=self._timeout,
                headers={"User-Agent": self._user_agent},
            )
        return self._session

    async def get(self, url: str) -> Optional[bytes]:
        try:
            # the path is already percent-encoded with the reference's
            # exact ASCII set (utils.paths) — yarl must not re-normalize
            from yarl import URL

            async with self._get_session().get(URL(url, encoded=True)) as resp:
                if resp.status == 404:
                    return None
                if not (200 <= resp.status < 300):
                    log.warning("%s %s", url, resp.status)
                    return None
                return await resp.read()
        except Exception as err:
            log.warning("%s %r", url, err)
            return None

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()
