"""Path mapping & sanitization.

Re-implements the reference's request-path → origin-location mapping
with identical semantics, including the directory-traversal defense
(reference src/handler.rs:495-579):

* ``clean_path`` percent-decodes, strips the provider prefix
  (string-wise, repeatedly — Rust trim_start_matches semantics), then
  iteratively collapses "/../" -> "/", "/./" -> "/", "//" -> "/" until
  a fixpoint, and finally strips leading "../" and "./" repeatedly
  (src/handler.rs:556-579).
* ``build_url`` percent-encodes with NON_ALPHANUMERIC minus
  ``. / - _`` (src/handler.rs:515-532).
* ``build_bucket_and_object_key``: bucket = src host, key = src path
  joined with the cleaned path, leading '/' trimmed
  (src/handler.rs:495-513).
* ``build_local_path``: "file://host/./dir" means a relative path
  (src/handler.rs:534-554).
"""

from __future__ import annotations

from urllib.parse import unquote_to_bytes, urlsplit


class PathError(ValueError):
    """Path could not be built (maps to a 500 via the fetch error path)."""


def _trim_start_matches(s: str, pat: str) -> str:
    if not pat:
        return s
    while s.startswith(pat):
        s = s[len(pat) :]
    return s


def _trim_end_matches(s: str, pat: str) -> str:
    if not pat:
        return s
    while s.endswith(pat):
        s = s[: -len(pat)]
    return s


def clean_path(raw_path: str, prefix: str) -> str:
    """reference src/handler.rs:556-579 (traversal defense fixpoint loop)."""
    try:
        decoded = unquote_to_bytes(raw_path).decode("utf-8")
    except UnicodeDecodeError as e:
        raise PathError(f"invalid percent-encoding: {e}") from e
    stripped_prefix = _trim_end_matches(_trim_start_matches(prefix, "/"), "/")
    target = _trim_start_matches(decoded, "/")
    target = _trim_start_matches(target, stripped_prefix)
    target = _trim_start_matches(target, "/")
    while True:
        tmp = target.replace("/../", "/").replace("/./", "/").replace("//", "/")
        if tmp == target:
            break
        target = tmp
    target = _trim_start_matches(target, "../")
    target = _trim_start_matches(target, "./")
    return target


def _path_join(base: str, rel: str) -> str:
    """std::path::Path::join semantics for our (string) use case."""
    if rel.startswith("/"):
        return rel
    if not base:
        return rel
    if base.endswith("/"):
        return base + rel
    if not rel:
        return base
    return base + "/" + rel


def _split_src(src: str):
    """Parse a provider src URI into (scheme, host, path)."""
    parts = urlsplit(src)
    return parts.scheme, parts.hostname or "", parts.path


def build_bucket_and_object_key(src: str, req_prefix: str, req_path: str):
    """reference src/handler.rs:495-513"""
    scheme, host, src_path = _split_src(src)
    if not host:
        raise PathError("s3 client src is wrong")
    rel = clean_path(req_path, req_prefix)
    key = _path_join(src_path, rel)
    return host, key.lstrip("/")


# percent_encoding::NON_ALPHANUMERIC minus '.', '/', '-', '_'
# (reference src/handler.rs:515-519)
_SAFE = frozenset(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789./-_"
)


def percent_encode(path: str) -> str:
    out = []
    for b in path.encode("utf-8"):
        if b in _SAFE:
            out.append(chr(b))
        else:
            out.append(f"%{b:02X}")
    return "".join(out)


def build_url(src: str, req_prefix: str, req_path: str) -> str:
    """reference src/handler.rs:521-532"""
    rel = clean_path(req_path, req_prefix)
    encoded = percent_encode(rel)
    return _trim_end_matches(src, "/") + "/" + encoded


def build_local_path(src: str, req_prefix: str, req_path: str) -> str:
    """reference src/handler.rs:534-554"""
    _, _, src_path = _split_src(src)
    relative = src_path.startswith("/./")
    rel = clean_path(req_path, req_prefix)
    local = _path_join(src_path, rel)
    if relative:
        return _trim_start_matches(local, "/./")
    return local
