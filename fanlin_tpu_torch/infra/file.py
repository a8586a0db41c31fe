"""Local-filesystem origin (reference src/infra/file.rs:1-24):
NotFound -> None; any other IO error propagates (-> 500)."""

from __future__ import annotations

import asyncio
from typing import Optional


class FileClient:
    async def read(self, path: str) -> Optional[bytes]:
        try:
            return await asyncio.to_thread(self._read_sync, path)
        except (FileNotFoundError, NotADirectoryError):
            return None

    @staticmethod
    def _read_sync(path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()
