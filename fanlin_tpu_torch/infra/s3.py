"""S3 origin client with native AWS SigV4 signing over aiohttp.

Re-implements the behavior of the reference's aws-sdk-s3 usage
(reference src/infra/s3.rs:7-67) without an SDK dependency:

* endpoint override (MinIO/dev) -> path-style addressing + static
  credentials from config (s3.rs:16-18, 32-43);
* no override -> virtual-hosted-style https://{bucket}.s3.{region}.
  amazonaws.com with credentials from the environment (s3.rs:24-30);
* NoSuchKey -> None; any other service error raises (-> 500 at the
  gateway) — s3.rs:62-66. Note a 404 with code NoSuchBucket therefore
  raises, matching the SDK behavior the reference relies on.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
from typing import Optional, Tuple
from urllib.parse import urlsplit

import aiohttp

from ..config import S3Config

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()
_UNRESERVED = frozenset(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-._~"
)


def _uri_encode(s: str, encode_slash: bool) -> str:
    out = []
    for b in s.encode("utf-8"):
        if b in _UNRESERVED or (not encode_slash and b == 0x2F):
            out.append(chr(b))
        else:
            out.append(f"%{b:02X}")
    return "".join(out)


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode("utf-8"), hashlib.sha256).digest()


class S3Error(Exception):
    pass


class S3Client:
    def __init__(self, cfg: S3Config):
        self.region = cfg.aws_region
        self.endpoint = cfg.aws_endpoint_url
        if self.endpoint is not None:
            if cfg.aws_access_key_id is None:
                raise S3Error("aws_access_key_id required")
            if cfg.aws_secret_access_key is None:
                raise S3Error("aws_secret_access_key required")
            self.access_key = cfg.aws_access_key_id
            self.secret_key = cfg.aws_secret_access_key
            self.session_token = None
        else:
            self.access_key = os.environ.get("AWS_ACCESS_KEY_ID", "")
            self.secret_key = os.environ.get("AWS_SECRET_ACCESS_KEY", "")
            self.session_token = os.environ.get("AWS_SESSION_TOKEN")
        self._session: Optional[aiohttp.ClientSession] = None

    def _get_session(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=30)
            )
        return self._session

    def _url_for(self, bucket: str, key: str) -> Tuple[str, str, str]:
        """-> (base_url, host, canonical_path)"""
        enc_key = _uri_encode(key, encode_slash=False)
        if self.endpoint is not None:
            # force_path_style (reference s3.rs:16-18)
            parts = urlsplit(self.endpoint)
            host = parts.netloc
            path = f"/{bucket}/{enc_key}"
            return f"{parts.scheme}://{host}{path}", host, path
        host = f"{bucket}.s3.{self.region}.amazonaws.com"
        path = f"/{enc_key}"
        return f"https://{host}{path}", host, path

    def _sign_headers(self, host: str, canonical_path: str,
                      now: Optional[datetime.datetime] = None,
                      extra_headers: Optional[dict] = None,
                      method: str = "GET",
                      payload_hash: str = _EMPTY_SHA256) -> dict:
        """SigV4-sign a request (GET on the serving path; PUT/DELETE
        exist for the test-only bucket manager, mirroring the
        reference's test helper, s3.rs:141-183). `now`/`extra_headers`
        exist so tests can pin the output against AWS's published
        example vectors."""
        if now is None:
            now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        headers = {
            "host": host,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amz_date,
        }
        if extra_headers:
            headers.update(extra_headers)
        if self.session_token:
            headers["x-amz-security-token"] = self.session_token
        signed = ";".join(sorted(headers))
        canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
        canonical_request = "\n".join(
            [method, canonical_path, "", canonical_headers, signed, payload_hash]
        )
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        string_to_sign = "\n".join(
            [
                "AWS4-HMAC-SHA256",
                amz_date,
                scope,
                hashlib.sha256(canonical_request.encode()).hexdigest(),
            ]
        )
        k = _hmac(("AWS4" + self.secret_key).encode(), datestamp)
        k = _hmac(k, self.region)
        k = _hmac(k, "s3")
        k = _hmac(k, "aws4_request")
        signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
        auth = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed}, Signature={signature}"
        )
        out = dict(headers)
        out.pop("host")  # aiohttp sets Host itself
        out["Authorization"] = auth
        return out

    async def get_object(self, bucket: str, key: str) -> Optional[bytes]:
        url, host, canonical_path = self._url_for(bucket, key)
        headers = self._sign_headers(host, canonical_path)
        try:
            # SigV4 signed the exact canonical path — yarl must not
            # re-normalize the percent-encoding
            from yarl import URL

            async with self._get_session().get(
                URL(url, encoded=True), headers=headers
            ) as resp:
                if 200 <= resp.status < 300:
                    return await resp.read()
                # error body: bounded read (a hostile origin must not
                # stream gigabytes into an error branch) + tolerant
                # decode (binary bodies would otherwise leak a raw
                # UnicodeDecodeError past the ClientError net)
                raw = await resp.content.read(64 * 1024)
                body = raw.decode("utf-8", "replace")
                if "<Code>NoSuchKey</Code>" in body:
                    return None  # reference s3.rs:62-64
                raise S3Error(f"s3 GET {bucket}/{key} -> {resp.status}: {body[:200]}")
        except aiohttp.ClientError as e:
            raise S3Error(f"s3 GET {bucket}/{key} failed: {e}") from e

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()
