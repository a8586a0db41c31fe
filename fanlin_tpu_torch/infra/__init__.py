"""L1 — origin clients (s3 / web / file).

Same contract as the reference's infra facade (reference
src/infra/mod.rs:7-22): each client exposes one async fetch returning
``bytes | None`` — None means not-found, an exception means
infrastructure error (-> 500 at the gateway)."""

from __future__ import annotations

from .. import config as config_mod
from .file import FileClient
from .s3 import S3Client
from .web import WebClient


class Client:
    """Bundle of the three origin clients (reference src/infra/mod.rs:7-12)."""

    def __init__(self, s3: S3Client, web: WebClient, file: FileClient):
        self.s3 = s3
        self.web = web
        self.file = file

    @classmethod
    def new(cls, cfg: config_mod.Config) -> "Client":
        return cls(
            s3=S3Client(cfg.client.s3),
            web=WebClient(cfg.client.web),
            file=FileClient(),
        )

    async def close(self) -> None:
        await self.web.close()
        await self.s3.close()
