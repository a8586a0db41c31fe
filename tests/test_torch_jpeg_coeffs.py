"""The port's host entropy reader (fanlin_tpu_torch.engine.jpeg_coeffs,
csrc/jpeg_coeffs.cpp, no libjpeg) against the JAX package's
native_codecs.read_jpeg_coeffs (libjpeg's jpeg_read_coefficients).

Every key of the dict must be equal, arrays element for element with
the same dtype and shape, on: the golden sources; PIL encodes at five
sizes x three subsamplings x three qualities; native 4:4:0 streams; gray
sources; restart-interval streams; streams cut inside the scan (libjpeg
zero-fills and warns); progressive streams (4:4:4, 4:2:2, 4:2:0, gray,
odd dims, restart intervals, cut inside a scan or between scans).

What the reader refuses (None, and the caller decodes pixels): CMYK,
arithmetic coding (SOF9), 12-bit samples, streams without DHT segments
(libjpeg substitutes its standard tables), a progressive stream with an
illegal successive-approximation value (libjpeg refuses it too),
empty, garbage and header-only input.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

from fanlin_tpu.engine import native_codecs
from fanlin_tpu_torch.engine.jpeg_coeffs import read_jpeg_coeffs
from tests.conftest import make_test_image

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

needs_native = pytest.mark.skipif(
    not native_codecs.available(), reason="native codec core not built")


def _pil_jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _golden(name):
    with open(os.path.join(GOLDEN, f"{name}_src.jpg"), "rb") as f:
        return f.read()


def _assert_same(data):
    got = read_jpeg_coeffs(data)
    want = native_codecs.read_jpeg_coeffs(data)
    assert want is not None and got is not None
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key
    return got


def _scan_start(data: bytes) -> int:
    """Offset of the first entropy-coded byte of the first scan."""
    sos = data.index(b"\xff\xda")
    return sos + 2 + (data[sos + 2] << 8 | data[sos + 3])


@needs_native
@pytest.mark.parametrize("name,subsamp", [("lenna", 444), ("synth", 420)])
def test_golden_sources(name, subsamp):
    assert _assert_same(_golden(name))["subsamp"] == subsamp


@needs_native
@pytest.mark.parametrize("quality", [25, 75, 95])
@pytest.mark.parametrize("subsampling,subsamp", [(0, 444), (1, 422),
                                                 (2, 420)])
@pytest.mark.parametrize("dims", [(512, 512), (500, 375), (101, 83),
                                  (37, 23), (7, 5)])
def test_pil_streams(dims, subsampling, subsamp, quality):
    w, h = dims
    data = _pil_jpeg(make_test_image(w, h, seed=w + h), quality=quality,
                     subsampling=subsampling)
    m = _assert_same(data)
    assert (m["w"], m["h"], m["subsamp"]) == (w, h, subsamp)


@needs_native
@pytest.mark.parametrize("dims", [(504, 360), (101, 83), (37, 23)])
def test_native_440_streams(dims):
    data = native_codecs.encode_jpeg_subsamp(make_test_image(*dims), 85, 1, 2)
    if data is None:
        pytest.skip("native codec core without fc_encode_jpeg_subsamp")
    assert _assert_same(data)["subsamp"] == 440


@needs_native
@pytest.mark.parametrize("dims", [(128, 96), (37, 23)])
def test_gray_streams(dims):
    gray = np.asarray(Image.fromarray(make_test_image(*dims)).convert("L"))
    m = _assert_same(_pil_jpeg(gray, quality=90))
    assert m["gray"] and m["subsamp"] == 444
    assert m["cb"].shape == m["y"].shape and not m["cb"].any()


@needs_native
@pytest.mark.parametrize("subsampling", [0, 2])
@pytest.mark.parametrize("restart", [{"restart_marker_rows": 1},
                                     {"restart_marker_blocks": 5}])
def test_restart_streams(restart, subsampling):
    data = _pil_jpeg(make_test_image(101, 83), quality=80,
                     subsampling=subsampling, **restart)
    assert b"\xff\xdd" in data  # a DRI marker
    _assert_same(data)


@needs_native
@pytest.mark.parametrize("frac", [0.1, 0.5, 0.97])
@pytest.mark.parametrize("name", ["lenna", "synth"])
def test_streams_cut_inside_the_scan(name, frac):
    data = _golden(name)
    s0 = _scan_start(data)
    cut = data[: s0 + int((len(data) - s0) * frac)]
    m = _assert_same(cut)
    # the rest of the image past the cut decodes as zero blocks
    assert not m["y"][-1].any()


@needs_native
@pytest.mark.parametrize("frac", [0.3, 0.8])
def test_restart_stream_cut_inside_the_scan(frac):
    data = _pil_jpeg(make_test_image(101, 83), quality=80, subsampling=2,
                     restart_marker_blocks=3)
    s0 = _scan_start(data)
    _assert_same(data[: s0 + int((len(data) - s0) * frac)])


def _segments(data: bytes):
    """(marker, offset) of every marker segment before the first scan
    and between scans (entropy-coded bytes skipped)."""
    out, i = [], 2
    while i + 4 <= len(data):
        marker = data[i + 1]
        out.append((marker, i))
        length = data[i + 2] << 8 | data[i + 3]
        i += 2 + length
        if marker == 0xDA:  # skip the scan to the next marker
            while i + 1 < len(data) and not (
                    data[i] == 0xFF and data[i + 1] not in (0, 0xFF)
                    and not 0xD0 <= data[i + 1] <= 0xD7):
                i += 1
            if data[i + 1] == 0xD9:
                break
    return out


def _refused(kind):
    img = make_test_image(40, 30)
    if kind == "progressive":
        # successive approximation Al = 14 in the first AC scan
        data = bytearray(_pil_jpeg(img, quality=80, progressive=True))
        sos = [o for m, o in _segments(bytes(data)) if m == 0xDA]
        at = next(o for o in sos if data[o + 4] == 1 and data[o + 7] != 0)
        data[at + 9] = 14
        return bytes(data)
    if kind == "arithmetic":
        data = bytearray(_pil_jpeg(img, quality=80))
        data[data.index(b"\xff\xc0") + 1] = 0xC9  # SOF9
        return bytes(data)
    if kind == "12bit":
        data = bytearray(_pil_jpeg(img, quality=80))
        data[data.index(b"\xff\xc0") + 4] = 12  # sample precision
        return bytes(data)
    if kind == "dht_less":
        data = _pil_jpeg(img, quality=80)
        for marker, at in reversed(_segments(data)):
            if marker == 0xC4:
                length = data[at + 2] << 8 | data[at + 3]
                data = data[:at] + data[at + 2 + length:]
        assert b"\xff\xc4" not in data[:data.index(b"\xff\xda")]
        return data
    if kind == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(img).convert("CMYK").save(buf, format="JPEG")
        return buf.getvalue()
    return {"empty": b"", "garbage": b"\xff\xd8garbage", "zeros": bytes(100),
            "headers_only": _golden("lenna")[:300]}[kind]


@pytest.mark.parametrize("kind", ["progressive", "cmyk", "empty", "garbage",
                                  "zeros", "headers_only", "arithmetic",
                                  "12bit", "dht_less"])
def test_refused_streams_return_none(kind):
    assert read_jpeg_coeffs(_refused(kind)) is None


def _progressive(layout, w, h, quality, **kw):
    img = make_test_image(w, h, seed=w * h + quality)
    if layout == "gray":
        img = np.asarray(Image.fromarray(img).convert("L"))
    else:
        kw["subsampling"] = {"444": 0, "422": 1, "420": 2}[layout]
    data = _pil_jpeg(img, quality=quality, progressive=True, **kw)
    assert b"\xff\xc2" in data  # SOF2
    return data


@needs_native
@pytest.mark.parametrize("quality", [40, 90])
@pytest.mark.parametrize("layout", ["444", "422", "420", "gray"])
@pytest.mark.parametrize("dims", [(512, 512), (101, 83), (37, 23), (7, 5)])
def test_progressive_streams(dims, layout, quality):
    """DC first/refine and AC first/refine scans with EOB runs (libjpeg's
    default progression script), array-equal to libjpeg."""
    m = _assert_same(_progressive(layout, *dims, quality))
    assert (m["w"], m["h"]) == dims
    assert m["subsamp"] == {"444": 444, "422": 422, "420": 420,
                            "gray": 444}[layout]


@needs_native
@pytest.mark.parametrize("layout", ["444", "420"])
@pytest.mark.parametrize("restart", [{"restart_marker_rows": 1},
                                     {"restart_marker_blocks": 3}])
def test_progressive_restart_streams(restart, layout):
    data = _progressive(layout, 101, 83, 80, **restart)
    assert b"\xff\xdd" in data  # a DRI marker
    _assert_same(data)


@needs_native
@pytest.mark.parametrize("layout", ["444", "420"])
@pytest.mark.parametrize("where", ["first_scans", "late_scan", "between_scans",
                                   "restart"])
def test_progressive_streams_cut(where, layout):
    """Cut inside a scan (the rest of that scan, and every later scan,
    stays zero) or inside a DHT segment between scans (libjpeg parses
    its fake EOI bytes as the table, then stops)."""
    data = _progressive(layout, 101, 83, 80,
                        **({"restart_marker_blocks": 3}
                           if where == "restart" else {}))
    scans = [o for m, o in _segments(data) if m == 0xDA]
    if where == "between_scans":
        dht = [o for m, o in _segments(data) if m == 0xC4 and o > scans[1]]
        # marker, length, class/index and 16 counts, then one symbol
        cut = dht[0] + 22
        assert data[dht[0] + 2] << 8 | data[dht[0] + 3] > 21
    elif where == "first_scans":
        cut = scans[0] + (scans[1] - scans[0]) // 2
    else:
        cut = scans[-2] + (scans[-1] - scans[-2]) // 2
    m = _assert_same(data[:cut])
    assert m["y"].any()
