"""Provider prefix router.

Matchit-equivalent for the reference's routing scheme (reference
src/handler.rs:53-83): each provider is mounted at "/<path>/{*p}"
(bare "/{*p}" for a root provider), the catch-all segment must be
non-empty, and the most specific (longest) prefix wins."""

from __future__ import annotations

from typing import List, Optional

from ..config import Provider as ProviderConfig


class Provider:
    """Resolved provider entry (reference src/handler.rs:23-29)."""

    __slots__ = ("path", "src", "fallback_path", "success_even_no_content")

    def __init__(self, cfg: ProviderConfig):
        # path normalized like make_router (handler.rs:60-64)
        self.path = cfg.path.strip("/")
        self.src = cfg.src
        self.fallback_path = cfg.fallback_path or ""
        self.success_even_no_content = bool(cfg.success_even_no_content)


class Router:
    def __init__(self, providers: List[ProviderConfig]):
        self._providers = sorted(
            (Provider(p) for p in providers),
            key=lambda p: len(p.path),
            reverse=True,
        )

    def at(self, req_path: str) -> Optional[Provider]:
        """Longest-prefix match; the {*p} remainder must be non-empty."""
        for p in self._providers:
            prefix = "/" + p.path + "/" if p.path else "/"
            if req_path.startswith(prefix) and len(req_path) > len(prefix):
                return p
        return None
