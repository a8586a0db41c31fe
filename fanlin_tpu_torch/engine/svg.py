"""SVG / unknown-format path.

Bytes the sniffer can't identify are decoded as UTF-16LE / UTF-16BE
(by BOM) or UTF-8, validated as SVG, and served back *unchanged* as
image/svg+xml — transforms are never applied to SVG. Mirrors
reference src/handler.rs:368-396 (including the odd-trailing-byte ->
space quirk of the UTF-16 chunking).

Carried over from fanlin_tpu/engine/svg.py: the port imports nothing
of the JAX package."""

from __future__ import annotations

import xml.etree.ElementTree as ET


class SvgError(Exception):
    pass


def _utf16_chars(data: bytes, big_endian: bool) -> str:
    fallback = 0x0020  # odd tail chunk maps to a space (handler.rs:377, 383)
    units = []
    for i in range(0, len(data), 2):
        chunk = data[i : i + 2]
        if len(chunk) == 2:
            units.append(
                int.from_bytes(chunk, "big" if big_endian else "little")
            )
        else:
            units.append(fallback)
    try:
        return "".join(map(chr, units)).encode("utf-16", "surrogatepass").decode(
            "utf-16"
        )
    except UnicodeDecodeError as e:
        raise SvgError(f"failed to treat as UTF-16: {e}") from e


def decode_text(data: bytes) -> str:
    if len(data) > 2 and data[0] == 0xFF and data[1] == 0xFE:
        return _utf16_chars(data, big_endian=False)
    if len(data) > 2 and data[0] == 0xFE and data[1] == 0xFF:
        return _utf16_chars(data, big_endian=True)
    try:
        return data.decode("utf-8")
    except UnicodeDecodeError as e:
        raise SvgError("unknown format") from e


_SVG_NS = "http://www.w3.org/2000/svg"


def _parse_length(v: str):
    """Positive-length check for width/height/viewBox values (px and
    common units; percentages resolve against usvg's default size and
    are always positive when the number is)."""
    s = v.strip().lower()
    for unit in ("px", "pt", "pc", "mm", "cm", "in", "em", "ex", "%"):
        if s.endswith(unit):
            s = s[: -len(unit)].strip()
            break
    try:
        return float(s)
    except ValueError:
        return None


def validate_svg(text: str) -> None:
    """Parse-and-validate only (the reference uses usvg but never
    rasterizes, handler.rs:391-395). Beyond well-formed XML this
    enforces usvg's structural rejections:

    * the root element must be <svg> in the SVG namespace — usvg's
      roxmltree/svgtypes parse fails without the xmlns;
    * the document size must resolve positive: explicit width/height
      that parse to <= 0, or a viewBox with non-positive dims, are
      usvg's Error::InvalidSize.

    usvg remains more lenient INSIDE the tree (it drops unknown
    elements rather than erroring), so attribute-level divergence is
    still possible — recorded in PARITY.md known-diffs."""
    try:
        root = ET.fromstring(text.lstrip("﻿"))
    except ET.ParseError as e:
        raise SvgError(f"failed to parse as SVG: {e}") from e
    if root.tag != "{%s}svg" % _SVG_NS:
        raise SvgError(
            "failed to parse as SVG: root element is not an "
            "svg-namespaced <svg>"
        )
    for attr in ("width", "height"):
        v = root.get(attr)
        if v is not None:
            n = _parse_length(v)
            if n is not None and n <= 0:
                raise SvgError("failed to parse as SVG: invalid size")
    vb = root.get("viewBox")
    if vb is not None:
        parts = vb.replace(",", " ").split()
        if len(parts) == 4:
            try:
                vw, vh = float(parts[2]), float(parts[3])
                if vw <= 0 or vh <= 0:
                    raise SvgError(
                        "failed to parse as SVG: invalid viewBox"
                    )
            except ValueError:
                raise SvgError(
                    "failed to parse as SVG: malformed viewBox"
                ) from None


def process_unknown_format(data: bytes) -> tuple:
    """-> (mime, original text bytes); raises SvgError on non-SVG."""
    text = decode_text(data)
    validate_svg(text)
    return ("image/svg+xml", text.encode("utf-8"))
