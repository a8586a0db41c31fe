"""The port's colour management on the CPU: `engine.icc` and
`ops.cmyk_lut` against the JAX package's on the same inputs, with
synthetic CMYK profiles made here (no profile file is needed).

`make_cmyk_profile(seed)` writes an ICC v2 output profile (class prtr,
CMYK -> Lab) with one lut16 (mft2) A2B0 tag, a 5^4 CLUT of a seeded
under-colour formula, plus wtpt and desc; lcms2 (through PIL.ImageCms)
accepts it. Seed 0 is the "default" profile of these tests, seed 1 the
"embedded" one; the other CMYK test files import it.

Tolerances: the icc functions and the sampled LUTs are equal array for
array (both packages run lcms2 and the same numpy). The LUT evaluation
(`lut_planes`) runs the same f32 operations in the same order as the
JAX function; XLA may fuse them otherwise on the CPU, so it is held to
1 LSB there with the share of bytes that differ asserted (0 on these
inputs). Every test makes its own profiles and transforms and leaves no
process state behind (the JAX package's module caches are keyed by the
profile's hash).
"""

import io
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fanlin_tpu.engine import icc as jicc
from fanlin_tpu.ops import cmyk_lut as jlut
from fanlin_tpu_torch.engine import codecs as tcodecs
from fanlin_tpu_torch.engine import icc as ticc
from fanlin_tpu_torch.ops import cmyk_lut as tlut
from fanlin_tpu_torch.ops import cmyk_lut_kernels as lk
from fanlin_tpu_torch.ops import fused as tfused
from tests.conftest import make_test_image

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def make_cmyk_profile(seed: int = 0, grid: int = 5) -> bytes:
    """A synthetic ICC v2 CMYK -> Lab output profile (see the module
    docstring)."""
    rng = np.random.default_rng(seed)
    gain = rng.uniform(0.85, 1.0, 3)
    lv = np.linspace(0.0, 1.0, grid)
    c, m, y, k = np.meshgrid(lv, lv, lv, lv, indexing="ij")
    rgb = np.stack([(1 - c) * gain[0], (1 - m) * gain[1],
                    (1 - y) * gain[2]], -1) * (1 - k)[..., None]
    lum = 100.0 * (rgb @ np.array([0.3, 0.59, 0.11]))
    a = np.clip(90.0 * (rgb[..., 0] - rgb[..., 1]), -127, 127)
    b = np.clip(90.0 * (rgb[..., 1] - rgb[..., 2]), -127, 127)
    # ICC v2 16-bit Lab: L 0..100 -> 0..0xFF00, a and b + 128, times 256
    lab = np.stack([lum / 100.0 * 0xFF00, (a + 128.0) * 256.0,
                    (b + 128.0) * 256.0], -1)
    clut = np.clip(np.round(lab), 0, 0xFFFF).astype(">u2").tobytes()
    ident = struct.pack(">2H", 0, 0xFFFF)
    mft2 = (b"mft2" + bytes(4) + struct.pack(">4B", 4, 3, grid, 0)
            + struct.pack(">9i", 65536, 0, 0, 0, 65536, 0, 0, 0, 65536)
            + struct.pack(">2H", 2, 2) + ident * 4 + clut + ident * 3)
    text = b"synthetic CMYK %d\0" % seed
    desc = (b"desc" + bytes(4) + struct.pack(">I", len(text)) + text
            + struct.pack(">II", 0, 0) + struct.pack(">HB", 0, 0) + bytes(67))
    d50 = struct.pack(">3i", 63190, 65536, 54061)
    tags = [(b"desc", desc), (b"wtpt", b"XYZ " + bytes(4) + d50),
            (b"A2B0", mft2)]
    at = 128 + 4 + 12 * len(tags)
    table, body = b"", b""
    for sig, data in tags:
        data += bytes(-len(data) % 4)
        table += sig + struct.pack(">II", at + len(body), len(data))
        body += data
    header = (struct.pack(">I", at + len(body)) + b"lcms"
              + struct.pack(">I", 0x02100000) + b"prtrCMYKLab "
              + struct.pack(">6H", 2026, 1, 1, 0, 0, 0) + b"acsp"
              + bytes(24) + struct.pack(">I", 0) + d50 + bytes(48))
    return header + struct.pack(">I", len(tags)) + table + body


def cmyk_jpeg(w=120, h=88, seed=0, quality=95, icc=None) -> bytes:
    """PIL's CMYK JPEG (4:4:4, Adobe transform 0) of a seeded image."""
    buf = io.BytesIO()
    kw = {"icc_profile": icc} if icc else {}
    Image.fromarray(make_test_image(w, h, seed=seed)).convert("CMYK").save(
        buf, format="JPEG", quality=quality, **kw)
    return buf.getvalue()


def adobe_ycck(data: bytes) -> bytes:
    """The stream with its Adobe APP14 transform byte (offset 15 from
    FF EE) set to 2: libjpeg then reads it as YCCK."""
    i = data.find(b"\xff\xee")
    assert i > 0 and data[i + 4:i + 9] == b"Adobe"
    out = bytearray(data)
    out[i + 15] = 2
    return bytes(out)


def grid_values(n: int = 17) -> np.ndarray:
    """Samples that include 0, 255 and every grid level +- 1."""
    levels = np.linspace(0, 255, n).round().astype(int)
    v = np.concatenate([levels - 1, levels, levels + 1, [0, 255]])
    return np.unique(np.clip(v, 0, 255))


def test_synthetic_profile_loads_in_both():
    prof = make_cmyk_profile(0)
    assert len(prof) % 4 == 0 and struct.unpack(">I", prof[:4])[0] == len(prof)
    for mod in (jicc, ticc):
        assert mod.CMYK2RGB.with_icc_profile(prof) is not None
    assert make_cmyk_profile(0) == prof != make_cmyk_profile(1)


def _streams():
    rgb = io.BytesIO()
    Image.fromarray(make_test_image(40, 30)).save(rgb, format="JPEG")
    gray = io.BytesIO()
    Image.fromarray(make_test_image(40, 30)).convert("L").save(
        gray, format="JPEG")
    cmyk = cmyk_jpeg(40, 30)
    # T.81 B.1.1.2: fill bytes before a marker
    fill = cmyk[:2] + b"\xff\xff\xff" + cmyk[2:]
    return {"rgb": rgb.getvalue(), "gray": gray.getvalue(), "cmyk": cmyk,
            "ycck": adobe_ycck(cmyk), "fill": fill, "garbage": b"\x00" * 40,
            "soi_only": b"\xff\xd8", "cut": cmyk[:20], "empty": b""}


@pytest.mark.parametrize("name", sorted(_streams()))
def test_jpeg_num_components_matches(name):
    data = _streams()[name]
    assert ticc.jpeg_num_components(data) == jicc.jpeg_num_components(data)


def test_jpeg_num_components_values():
    s = _streams()
    got = {k: ticc.jpeg_num_components(v) for k, v in s.items()}
    assert (got["rgb"], got["gray"], got["cmyk"], got["fill"]) == (3, 1, 4, 4)
    assert got["garbage"] is None and got["empty"] is None


def _arr(x):
    return None if x is None else np.asarray(x)


@pytest.mark.parametrize("case", ["none", "default", "embedded_good",
                                  "embedded_broken", "embedded_off",
                                  "rgb_jpeg", "ycck"])
def test_convert_jpeg_color_matches(case):
    """convert_jpeg_color_if_needed (host lcms2) of both packages on one
    CMYK source: no profile, the default one, a good embedded profile, a
    broken one (an sRGB profile in a CMYK file: the default serves),
    embedded profiles not used, an RGB JPEG (None), a YCCK flip."""
    default_bytes = make_cmyk_profile(0)
    embedded = make_cmyk_profile(1)
    data = cmyk_jpeg()
    use_embedded = case.startswith("embedded") and case != "embedded_off"
    if case in ("embedded_good", "embedded_off"):
        data = cmyk_jpeg(icc=embedded)
    elif case == "embedded_broken":
        srgb = ImageCmsProfileBytes()
        data = cmyk_jpeg(icc=srgb)
    elif case == "rgb_jpeg":
        buf = io.BytesIO()
        Image.fromarray(make_test_image(60, 40)).save(buf, format="JPEG")
        data = buf.getvalue()
    elif case == "ycck":
        data = adobe_ycck(data)
    outs = []
    for mod in (jicc, ticc):
        default = (None if case == "none"
                   else mod.CMYK2RGB.with_icc_profile(default_bytes))
        outs.append(_arr(mod.convert_jpeg_color_if_needed(
            data, default, use_embedded)))
    want, got = outs
    if case in ("none", "rgb_jpeg"):
        assert want is None and got is None
        return
    assert want is not None and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cut", [0.3, 0.6, 0.9])
def test_convert_damaged_stream_matches(cut):
    """A cut CMYK stream that Pillow cannot load gives None on both
    packages (the normal decode path reports it), with a device LUT too,
    and with device_up=False (a wedged device); an intact stream with
    device_up=False converts through the LUT's host twin, to the bytes
    of the device form (here its plain version)."""
    data = cmyk_jpeg()
    data = data[:int(len(data) * cut)]
    prof = make_cmyk_profile(0)
    want = jicc.convert_jpeg_color_if_needed(
        data, jicc.CMYK2RGB.with_icc_profile(prof), False)
    default = ticc.CMYK2RGB.with_icc_profile(prof)
    xform = tlut.DeviceCmykTransform(tlut.sample_lut(default.convert, 5), CPU)
    for t in (None, xform):
        for up in (True, False):
            got = ticc.convert_jpeg_color_if_needed(data, default, False, t,
                                                    device_up=up)
            assert want is None and got is None
    whole = cmyk_jpeg()
    host = ticc.convert_jpeg_color_if_needed(whole, default, False, xform,
                                             device_up=False)
    np.testing.assert_array_equal(
        host, ticc.convert_jpeg_color_if_needed(whole, default, False, xform))


def ImageCmsProfileBytes() -> bytes:
    from PIL import ImageCms

    return ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()


def test_embedded_profile_changes_the_colours():
    """The two synthetic profiles give different colours (the embedded
    cases above are not vacuous)."""
    data = cmyk_jpeg(icc=make_cmyk_profile(1))
    default = ticc.CMYK2RGB.with_icc_profile(make_cmyk_profile(0))
    a = ticc.convert_jpeg_color_if_needed(data, default, True)
    b = ticc.convert_jpeg_color_if_needed(data, default, False)
    assert a.shape == b.shape and (a != b).mean() > 0.5


def test_convert_alloc_gate_raises_codec_error():
    """A CMYK header past the decode allocation gate raises CodecError
    (not the None fallback), as in the JAX package."""
    data = bytearray(cmyk_jpeg(16, 16))
    i = data.find(b"\xff\xc0")
    data[i + 5:i + 9] = struct.pack(">HH", 30000, 30000)
    default = ticc.CMYK2RGB.with_icc_profile(make_cmyk_profile(0))
    with pytest.raises(tcodecs.CodecError):
        ticc.convert_jpeg_color_if_needed(bytes(data), default, False)
    with pytest.raises(jicc.codecs.CodecError):
        jicc.convert_jpeg_color_if_needed(
            bytes(data), jicc.CMYK2RGB.with_icc_profile(make_cmyk_profile(0)),
            False)


@pytest.mark.parametrize("n", [5, 17])
def test_sample_lut_matches(n):
    prof = make_cmyk_profile(0)
    want = jlut.sample_lut(jicc.CMYK2RGB.with_icc_profile(prof).convert, n)
    got = tlut.sample_lut(ticc.CMYK2RGB.with_icc_profile(prof).convert, n)
    assert got.shape == (n, n, n, n, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [1, 2])
def test_embedded_device_lut_matches(seed):
    prof = make_cmyk_profile(seed)
    w_flat, w_n, w_key = jicc.embedded_device_lut(prof)
    g_flat, g_n, g_key = ticc.embedded_device_lut(prof)
    assert (g_n, g_key) == (w_n, w_key) == (17, w_key)
    assert g_flat.dtype == np.float32 and g_flat.shape == (17 ** 4, 3)
    np.testing.assert_array_equal(g_flat, w_flat)
    # a broken profile is None on both, and negative-cached
    assert ticc.embedded_device_lut(b"not a profile") is None
    assert jicc.embedded_device_lut(b"not a profile") is None


def _lut(seed=0, n=17):
    prof = make_cmyk_profile(seed)
    return tlut.sample_lut(ticc.CMYK2RGB.with_icc_profile(prof).convert, n)


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.choice(grid_values(), shape + (4,)).astype(np.uint8)


@pytest.mark.parametrize("n", [5, 17])
@pytest.mark.parametrize("shape", [(3, 17, 29), (1, 64, 80)])
def test_lut_planes_matches_jax(shape, n):
    """The plain lut_planes against the JAX lut_planes on planes that
    hold 0, 255 and every grid level +- 1: within 1 LSB, and the share of
    bytes that differ stated (it is 0 on these inputs)."""
    px = _planes(shape, seed=n)
    flat = _lut(0, n).reshape(-1, 3).astype(np.float32)
    want = jlut.lut_planes(*(jnp.asarray(px[..., i].astype(np.int32))
                             for i in range(4)), jnp.asarray(flat), n)
    got = tlut.lut_planes(*(torch.from_numpy(px[..., i].astype(np.int32))
                            for i in range(4)), torch.from_numpy(flat), n)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        d = np.abs(g.numpy().astype(np.int32) - np.asarray(w).astype(np.int32))
        assert d.max() <= 1
        assert (d > 0).mean() == 0.0  # the share that differs


def test_lut_pixels_matches_jax_program():
    """The pixel form (DeviceCmykTransform.convert on the CPU) against
    the JAX package's _lut_program: within 1 LSB, share stated (0)."""
    px = _planes((48, 70), seed=3)
    lut = _lut(0)
    flat = lut.reshape(-1, 3).astype(np.float32)
    want = np.asarray(jlut._lut_program(17, 48, 70)(jnp.asarray(px),
                                                     jnp.asarray(flat)))
    got = tlut.DeviceCmykTransform(lut, CPU).convert(px)
    assert got.dtype == np.uint8 and got.shape == (48, 70, 3)
    d = np.abs(got.astype(np.int32) - want)
    assert d.max() <= 1 and (d > 0).mean() == 0.0


def test_lut_kernel_cpu_paths_agree():
    """cmyk_lut on planes and cmyk_lut_pixels on the same pixels, given
    the packed LUT, give the same bytes, and equal the plain version on
    the f32 LUT; no launch is counted on the CPU."""
    px = _planes((2, 23, 31), seed=5)
    flat = torch.from_numpy(_lut(1).reshape(-1, 3).astype(np.float32))
    packed = tlut.pack_lut(flat, 17)
    planes = torch.from_numpy(px).permute(0, 3, 1, 2).contiguous()
    lk.reset_launch_counts()
    a = lk.cmyk_lut(planes, packed, 17)
    assert a.shape == (2, 3, 23, 31) and a.dtype == torch.uint8
    np.testing.assert_array_equal(a.numpy(), lk.cmyk_lut_ref(planes, flat,
                                                             17).numpy())
    for i in range(2):
        b = lk.cmyk_lut_pixels(torch.from_numpy(px[i]), packed, 17)
        np.testing.assert_array_equal(b.numpy(),
                                      a[i].permute(1, 2, 0).numpy())
    assert lk.launch_counts() == {"cmyk_lut": 0}


def test_lut_grid_points_interpolate_to_themselves():
    """At grid points one weight is about 1 and the rest about 0: the LUT
    entry comes back within 1 LSB (level * f32((n-1)/255) lands a few ulp
    off the integer, as in tests/test_cmyk_lut.py)."""
    lut = _lut(0)
    levels = np.linspace(0, 255, 17).round().astype(np.uint8)
    idx = np.random.default_rng(0).integers(0, 17, (500, 4))
    px = levels[idx].reshape(20, 25, 4)
    got = tlut.DeviceCmykTransform(lut, CPU).convert(px)
    want = lut[idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]].reshape(20, 25, 3)
    assert np.abs(got.astype(np.int32) - want).max() <= 1


@pytest.mark.parametrize("bad", ["dtype", "channels", "lut_shape",
                                 "lut_dtype", "lut_f32", "device", "n"])
def test_lut_wrapper_rejects_bad_arguments(bad):
    x = torch.zeros((1, 4, 8, 8), dtype=torch.uint8)
    lut = torch.zeros((17 ** 4, 4), dtype=torch.int32)
    n = 17
    if bad == "dtype":
        x = x.to(torch.int32)
    elif bad == "channels":
        x = x[:, :3].contiguous()
    elif bad == "lut_shape":
        lut = lut[:100].contiguous()
    elif bad == "lut_dtype":
        lut = lut.to(torch.int64)
    elif bad == "lut_f32":  # the f32 LUT, not packed
        lut = torch.zeros((17 ** 4, 3), dtype=torch.float32)
    elif bad == "device":
        lut = lut.to("meta")
    else:
        n = 16
    with pytest.raises(ValueError):
        lk.cmyk_lut(x, lut, n)


def test_device_transform_holds_its_lut_on_its_device():
    """The transform's device copy is the packed one the coefficient
    route's cache holds for its host array: one copy per LUT. A flat f32
    LUT is kept as the very array given."""
    lut = _lut(0)
    xform = tlut.DeviceCmykTransform(lut, CPU)
    assert xform.n == 17
    np.testing.assert_array_equal(xform.lut_np, lut.reshape(-1, 3))
    dev = tfused._device_packed_lut(xform.lut_np, 17, CPU)
    assert dev.device == CPU and dev.shape == (17 ** 4, 4)
    assert dev.dtype == torch.int32
    assert xform._lut() is dev
    np.testing.assert_array_equal(dev.numpy(),
                                  tlut.pack_lut(xform.lut_np, 17).numpy())
    flat = xform.lut_np
    assert tlut.DeviceCmykTransform(flat, CPU).lut_np is flat
    with pytest.raises(ValueError):
        tlut.DeviceCmykTransform(flat[:100], CPU)


def test_device_transform_for_caches_per_profile():
    prof = make_cmyk_profile(2)
    lut = ticc.embedded_device_lut(prof)
    a = ticc._device_transform_for(lut, CPU)
    b = ticc._device_transform_for(ticc.embedded_device_lut(prof), CPU)
    # one host array per profile (embedded_device_lut's cache), so one
    # device copy
    assert a.lut_np is b.lut_np is lut[0]
    assert a._lut() is b._lut()
