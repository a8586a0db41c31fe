"""Client-accepted encoding flags (Accept-header negotiation).

Mirrors the reference's u8 bitflag set (reference src/content.rs:1-48)
and the Accept parsing in the gateway (reference src/main.rs:255-274):
each Accept header value is split on ',' and each piece is matched
*exactly* against known image mime types — no whitespace trimming, no
q-parameter handling, exactly like image::ImageFormat::from_mime_type.
"""

from __future__ import annotations

_WEBP = 1 << 0
_AVIF = 1 << 1

# Mime strings image::ImageFormat::from_mime_type recognizes for the two
# formats we care about.
_WEBP_MIMES = frozenset({"image/webp"})
_AVIF_MIMES = frozenset({"image/avif"})


class Format:
    """Bitflag set of client-accepted output encodings."""

    __slots__ = ("_bits",)

    def __init__(self, bits: int = 0):
        self._bits = bits

    def accept_webp(self) -> None:
        self._bits |= _WEBP

    def accept_avif(self) -> None:
        self._bits |= _AVIF

    def webp_accepted(self) -> bool:
        return bool(self._bits & _WEBP)

    def avif_accepted(self) -> bool:
        return bool(self._bits & _AVIF)

    def __eq__(self, other) -> bool:
        return isinstance(other, Format) and self._bits == other._bits

    def __repr__(self) -> str:
        return f"Format(webp={self.webp_accepted()}, avif={self.avif_accepted()})"


def extract_accepted_image_formats(accept_values) -> Format:
    """Build a Format from an iterable of Accept header values.

    Mirrors reference src/main.rs:255-274 (split on ',', exact mime
    match, multiple Accept headers all contribute).
    """
    fmt = Format()
    for value in accept_values:
        for piece in value.split(","):
            if piece in _WEBP_MIMES:
                fmt.accept_webp()
            elif piece in _AVIF_MIMES:
                fmt.accept_avif()
    return fmt
