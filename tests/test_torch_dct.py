"""The port's device JPEG back half (fanlin_tpu_torch.ops.dct, K9) and the
jpegdct sink end to end, against the JAX package's (fanlin_tpu.ops.dct,
Engine(device_dct=True)), on the CPU.

Tolerance. The tables, the DCT matrix, the edge pad and
`blocks_from_planar` are equal. The quantised coefficients are equal
except at quantisation ties: where the exact quotient F(u, v) / Q(u, v)
lies on a .5 boundary (within TIE of it), float32 rounding noise decides
which way it rounds, and the two sides sum in different orders (XLA's
CPU GEMM blocks its sums by shape; the port sums each 8-term dot product
in one fixed order, so that the card and the CPU agree bit for bit).
There they may differ by one step. Ties fall mostly on F(0,0), F(0,4),
F(4,0) and F(4,4), whose basis rows are all +-sqrt(1/8): on photo
content at q75 about 2.5e-4 of the coefficients are ties that the two
orders round apart. Each test prints its count. The port's own order is
pinned against a numpy emulation of it, exactly.

The engine twins: the same mime type and JPEG headers, and the
coefficients read back from both bodies equal except at ties; the body
is byte-equal wherever no tie rounds apart.
"""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fanlin_tpu.engine import Engine as JaxEngine
from fanlin_tpu.ops import dct as jdct
from fanlin_tpu.ops import fused as jfused
from fanlin_tpu.spec import content as jcontent
from fanlin_tpu.spec.query import parse_query as jparse_query
from fanlin_tpu_torch.engine import Engine
from fanlin_tpu_torch.engine.jpeg_coeffs import read_jpeg_coeffs
from fanlin_tpu_torch.ops import dct as tdct
from fanlin_tpu_torch.ops import fused as tfused
from fanlin_tpu_torch.spec.content import Format
from fanlin_tpu_torch.spec.query import parse_query
from tests.conftest import make_test_image, psnr
from tests.test_golden_parity import CASES

CPU = torch.device("cpu")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TIE = 1e-3  # distance of an exact quotient from .5 that float noise spans
J_PLANAR = jax.jit(jdct.ycbcr420_to_planar)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def jax_exact_ladder():
    """The JAX jpegdct assembly serves a batch whose narrow download
    overflows from its host mirror (+-1 LSB) while it compiles the wider
    rung in a background thread; with host fallback off it runs the
    wider rung inline, and gives its device coefficients."""
    jfused.set_host_fallback(False)
    yield
    jfused.set_host_fallback(True)


def _exact_quotients(plane_u8, mult, table):
    """f64 F(u, v) / Q(u, v) of a (B, H, W) u8 plane, planar layout, with
    the f32 DCT matrix both sides use."""
    p = tdct._pad_edge(torch.from_numpy(plane_u8).double(), mult) - 128.0
    b, h, w = p.shape
    d = torch.from_numpy(tdct._dct_matrix()).double()
    c = torch.einsum("us,bisjt,vt->biujv", d, p.reshape(b, h // 8, 8, w // 8, 8),
                     d)
    q = torch.from_numpy(np.asarray(table, np.float64)).reshape(1, 1, 8, 1, 8)
    return (c / q).reshape(b, h, w).numpy()


def _tie(r):
    return np.abs(np.abs(r) - np.floor(np.abs(r)) - 0.5) <= TIE


def _differ_at_ties_only(got, want, exact):
    """Asserts got == want except by one step where `exact` is a tie;
    returns the count of differing coefficients."""
    assert got.shape == want.shape == exact.shape
    d = got.astype(np.int32) - want.astype(np.int32)
    assert int(np.abs(d).max(initial=0)) <= 1
    assert _tie(exact[d != 0]).all(), exact[d != 0]
    return int((d != 0).sum())


def _planes(kind, b, h, w, rng):
    ch, cw = (h + 1) // 2, (w + 1) // 2
    if kind == "random":
        return (rng.integers(0, 256, (b, h, w), dtype=np.uint8),
                rng.integers(0, 256, (b, ch, cw), dtype=np.uint8),
                rng.integers(0, 256, (b, ch, cw), dtype=np.uint8))
    if kind == "flat":  # every block an exact DC tie at q50 (luma Q00 16)
        return (np.full((b, h, w), 137, np.uint8),
                np.full((b, ch, cw), 77, np.uint8),
                np.full((b, ch, cw), 200, np.uint8))
    img = make_test_image(w, h, seed=int(rng.integers(100)))
    f = img.astype(np.float64)
    y = np.clip(np.round(0.299 * f[..., 0] + 0.587 * f[..., 1]
                         + 0.114 * f[..., 2]), 0, 255).astype(np.uint8)
    pad = np.pad(img, ((0, h % 2), (0, w % 2), (0, 0)), mode="edge")
    sub = pad.reshape(ch, 2, cw, 2, 3).mean(axis=(1, 3)).round().astype(np.uint8)
    return (np.repeat(y[None], b, 0), np.repeat(sub[None, ..., 1], b, 0),
            np.repeat(sub[None, ..., 2], b, 0))


def test_tables_and_matrix_match():
    for q in range(-1, 103):
        for a, b in zip(tdct.ijg_quant_tables(q), jdct.ijg_quant_tables(q)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tdct._dct_matrix(), jdct._dct_matrix())


@pytest.mark.parametrize("h,w,mult", [(1, 1, 16), (7, 5, 8), (16, 16, 16),
                                      (17, 33, 16), (9, 8, 8)])
def test_pad_edge_matches(h, w, mult):
    x = np.random.default_rng(h * w).uniform(-1, 1, (2, h, w)).astype(np.float32)
    np.testing.assert_array_equal(
        tdct._pad_edge(torch.from_numpy(x), mult).numpy(),
        np.asarray(jdct._pad_edge(jnp.asarray(x), mult)))


@pytest.mark.parametrize("quality", [1, 50, 75, 92, 100])
@pytest.mark.parametrize("h,w,b", [(1, 1, 1), (7, 5, 2), (16, 16, 1),
                                   (17, 9, 2), (199, 301, 1), (200, 300, 2),
                                   (64, 96, 1)])
@pytest.mark.parametrize("kind", ["random", "photo", "flat"])
def test_ycbcr420_to_planar_matches_jax(kind, h, w, b, quality):
    rng = np.random.default_rng(h * 1000 + w + quality)
    planes = _planes(kind, b, h, w, rng)
    lq, cq = jdct.ijg_quant_tables(quality)
    want = J_PLANAR(*(jnp.asarray(p) for p in planes), lq.astype(np.float32),
                    cq.astype(np.float32))
    got = tdct.ycbcr420_to_planar(*(torch.from_numpy(p) for p in planes),
                                  lq, cq)
    n = total = 0
    for g, wnt, p, mult, tab in zip(got, want, planes, (16, 8, 8),
                                    (lq, cq, cq)):
        assert g.dtype == torch.int16
        n += _differ_at_ties_only(g.numpy(), np.asarray(wnt),
                                  _exact_quotients(p, mult, tab))
        total += g.numel()
    print(f"{kind} {h}x{w} B={b} q{quality}: {n} of {total} coefficients "
          f"differ, all at ties ({n / total:.2e})")


def _emulated_fma_dct(x, table):
    """numpy emulation of planar_dct_quant's arithmetic: each 8-term sum as
    an f32 FMA chain in index order (exact f64 product and add, one
    rounding to f32), then the f32 divide and round half away from zero."""
    b, h, w = x.shape
    d = tdct._dct_matrix()

    def chain(terms):  # terms[s]: (coeff (8,) , operand) pairs
        acc = (terms[0][0] * terms[0][1]).astype(np.float32)
        for c, v in terms[1:]:
            acc = (acc.astype(np.float64) + c.astype(np.float64)
                   * v.astype(np.float64)).astype(np.float32)
        return acc

    x5 = x.reshape(b, h // 8, 8, w)
    t = chain([(d[:, s].reshape(1, 1, 8, 1), x5[:, :, s:s + 1])
               for s in range(8)]).reshape(b, h, w)
    t5 = t.reshape(b, h, w // 8, 8)
    c = chain([(d[:, s].reshape(1, 1, 1, 8), t5[..., s:s + 1])
               for s in range(8)]).reshape(b, h // 8, 8, w // 8, 8)
    r = c / np.asarray(table, np.float32).reshape(1, 8, 1, 8)
    r = np.sign(r) * np.floor(np.abs(r) + np.float32(0.5))
    return r.reshape(b, h, w).astype(np.int16)


@pytest.mark.parametrize("quality", [50, 100])
def test_planar_dct_quant_order_is_fixed(quality):
    rng = np.random.default_rng(quality)
    x = (rng.integers(0, 256, (2, 24, 40)) - 128).astype(np.float32)
    x[0, :8, :8] = 9.0  # a flat block: its DC is a tie at q50
    lq, _ = tdct.ijg_quant_tables(quality)
    got = tdct.planar_dct_quant(torch.from_numpy(x),
                                torch.from_numpy(lq.astype(np.float32)))
    np.testing.assert_array_equal(got.numpy(), _emulated_fma_dct(x, lq))


def test_blocks_from_planar_matches_and_owns_its_memory():
    rng = np.random.default_rng(3)
    for shape in ((16, 24), (2, 8, 8), (3, 8, 40), (1, 40, 8)):
        p = rng.integers(-999, 999, shape).astype(np.int16)
        got = tdct.blocks_from_planar(p)
        np.testing.assert_array_equal(got, jdct.blocks_from_planar(p))
        assert got.flags.c_contiguous and not np.shares_memory(got, p)


SIZES = ["w=300&h=200", "w=301&h=199&quality=92", "w=100&h=80&blur=1"]


class _PlaneRecorder:
    """A runner that runs each jpegdct batch as jpeg420 instead and keeps
    the u8 planes: what the jpegdct tail transforms."""

    def __init__(self):
        self.planes = None

    def run(self, plans, payloads, kinds):
        kinds = [k.split("jpegdct:")[0] + "jpeg420" if "jpegdct:" in k else k
                 for k in kinds]
        out = tfused.make_assembly(plans, payloads, kinds, CPU).run()
        self.planes = out[0][1:]
        return out


def _golden(name):
    with open(os.path.join(GOLDEN, f"{name}_src.jpg"), "rb") as f:
        return f.read()


def _sos(data):
    return data[: data.index(b"\xff\xda")]


@pytest.mark.parametrize("device_decode", [False, True],
                         ids=["pixel", "coef"])
@pytest.mark.parametrize("qs", SIZES)
@pytest.mark.parametrize("src", ["synth", "lenna"])
def test_engine_device_dct_matches_reference(jax_exact_ladder, src, qs,
                                             device_decode):
    data = _golden(src)
    port = Engine(CPU, device_decode=device_decode, device_dct=True)
    ref = JaxEngine(device_decode=device_decode, device_dct=True)
    mime, got = port.process_image(data, parse_query(qs), Format())
    ref_mime, want = ref.process_image(data, jparse_query(qs),
                                       jcontent.Format())
    assert mime == ref_mime == "image/jpeg"
    assert port.stats["coef_src" if device_decode else "pixel_src"] == 1
    # the tail's input planes, and each coefficient's exact quotient
    rec = _PlaneRecorder()
    Engine(CPU, runner=rec, device_decode=device_decode,
           device_dct=True).process_image(data, parse_query(qs), Format())
    q = parse_query(qs).quality()
    a, b = read_jpeg_coeffs(got), read_jpeg_coeffs(want)
    assert _sos(got) == _sos(want)
    assert (a["w"], a["h"], a["subsamp"]) == (b["w"], b["h"], b["subsamp"])
    n = 0
    for key, plane, mult, tab in zip(("y", "cb", "cr"), rec.planes,
                                     (16, 8, 8), tdct.ijg_quant_tables(q)):
        exact = tdct.blocks_from_planar(
            _exact_quotients(plane[None], mult, tab))[0]
        exact = exact[: a[key].shape[0], : a[key].shape[1]]
        n += _differ_at_ties_only(a[key], b[key], exact)
    assert (n == 0) == (got == want)
    print(f"{src} {qs} {'coef' if device_decode else 'pixel'}: {n} "
          f"coefficients differ, all at ties; bytes equal: {got == want}")
    with Image.open(io.BytesIO(got)) as im:
        assert im.size == (a["w"], a["h"])
        g = np.asarray(im.convert("RGB"))
    with Image.open(io.BytesIO(want)) as im:
        assert psnr(g, np.asarray(im.convert("RGB"))) >= 50.0


def test_engine_device_dct_end_to_end():
    """Twin of tests/test_dct.py::test_engine_device_dct_end_to_end: the
    jpegdct route decodes to within 45 dB of the plane (jpeg420) route."""
    img = make_test_image(512, 512)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=92)
    q = parse_query("w=300&h=200&quality=80")
    out = {}
    for dct_on in (False, True):
        mime, body = Engine(CPU, device_dct=dct_on).process_image(
            buf.getvalue(), q, Format())
        assert mime == "image/jpeg"
        with Image.open(io.BytesIO(body)) as im:
            out[dct_on] = np.asarray(im.convert("RGB"), np.float64)
    assert out[True].shape == out[False].shape == (200, 300, 3)
    assert psnr(out[True], out[False]) >= 45.0


@pytest.mark.parametrize("cfg,qs", CASES)
@pytest.mark.parametrize("src", ["synth", "lenna"])
def test_jpegdct_golden_floor(jax_exact_ladder, src, cfg, qs):
    """The golden JPEGs were encoded with libjpeg's integer DCT, as the
    default route encodes: the jpegdct route's float DCT scores lower
    against them, for the JAX package (44.09 dB at worst, lenna/crop100)
    and the port alike. Held: >= 44 dB against the golden JPEG (the
    floor chip_smoke.py phase 6 (c) holds on the card), within 0.1 dB of
    the JAX jpegdct route, and >= 45 dB against the default route's
    output (tests/test_dct.py's criterion; here the default route is the
    jpeg420 sink, which needs the native codec core)."""
    data = _golden(src)
    with Image.open(os.path.join(GOLDEN, f"{src}_{cfg}.jpg")) as im:
        golden = np.asarray(im.convert("RGB"))

    def rgb(body):
        with Image.open(io.BytesIO(body)) as im:
            return np.asarray(im.convert("RGB"))

    port = rgb(Engine(CPU, device_dct=True).process_image(
        data, parse_query(qs), Format())[1])
    ref = rgb(JaxEngine(device_dct=True).process_image(
        data, jparse_query(qs), jcontent.Format())[1])
    default = rgb(Engine(CPU).process_image(data, parse_query(qs),
                                            Format())[1])
    d_port, d_ref = psnr(port, golden), psnr(ref, golden)
    d_def = psnr(port, default)
    print(f"{src}/{cfg}: jpegdct against the golden JPEG: port {d_port:.2f} "
          f"dB, JAX {d_ref:.2f} dB; port against the default route "
          f"{d_def:.2f} dB")
    assert d_port >= 44.0 and d_port >= d_ref - 0.1 and d_def >= 45.0
