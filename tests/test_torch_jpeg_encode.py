"""The port's host entropy encoder (fanlin_tpu_torch.engine.jpeg_encode,
csrc/jpeg_encode.cpp, no libjpeg) against the JAX package's
native_codecs.encode_jpeg_coeffs (libjpeg's jpeg_write_coefficients).

Byte-equal on seeded coefficient grids: odd and even block counts in
both axes (8x8, 16x16, 17x9, 9x17, 1x1, 301x199 and more), sparse and
dense blocks, runs of more than 16 zeros (ZRL), all-zero blocks, DC
jumps of +-2047 and ACs of +-1023, at every quality 1-100. Read back by
the port's reader, the stream gives the input blocks within the true
block counts; the blocks past them in the padded grids are never read
(libjpeg writes dummy blocks there).

Out of baseline range (a DC difference over 11 bits, an AC over 10):
the port refuses (None). libjpeg-turbo's SIMD Huffman encoder skips
that check and writes a stream that does not read back as its input.
"""

import numpy as np
import pytest

from fanlin_tpu.engine import native_codecs
from fanlin_tpu_torch.engine.jpeg_coeffs import read_jpeg_coeffs
from fanlin_tpu_torch.engine.jpeg_encode import encode_jpeg_coeffs

needs_native = pytest.mark.skipif(
    not native_codecs.available(), reason="native codec core not built")

SIZES = [(8, 8), (16, 16), (17, 9), (9, 17), (1, 1), (24, 40), (33, 47),
         (300, 200), (301, 199), (15, 1)]


def _grids(w, h):
    """The MCU-padded 4:2:0 grid shapes: (luma, chroma)."""
    mw, mh = (w + 15) // 16, (h + 15) // 16
    return (2 * mh, 2 * mw, 64), (mh, mw, 64)


def _coeffs(shape, rng, kind):
    if kind == "zeros":
        return np.zeros(shape, np.int16)
    a = rng.integers(-1023, 1024, shape).astype(np.int16)
    if kind == "sparse":
        # mostly zero: long zero runs (ZRL) and all-zero blocks
        a[rng.random(shape) < 0.93] = 0
        a[rng.random(shape[:2]) < 0.2] = 0
    # DC in [-1023, 1023]: every difference fits 11 bits
    a[..., 0] = rng.integers(-1023, 1024, shape[:2])
    return a


def _planes(w, h, seed, kind):
    rng = np.random.default_rng(seed)
    ys, cs = _grids(w, h)
    return (_coeffs(ys, rng, kind), _coeffs(cs, rng, kind),
            _coeffs(cs, rng, kind))


@needs_native
@pytest.mark.parametrize("kind", ["sparse", "dense", "zeros"])
@pytest.mark.parametrize("w,h", SIZES)
def test_encoder_byte_equal_to_libjpeg(w, h, kind):
    planes = _planes(w, h, w * 1000 + h, kind)
    for q in (1, 10, 49, 50, 51, 75, 90, 99, 100):
        got = encode_jpeg_coeffs(*planes, w, h, q)
        want = native_codecs.encode_jpeg_coeffs(*planes, w, h, q)
        assert want is not None and got == want, q


@needs_native
def test_encoder_byte_equal_at_every_quality():
    planes = _planes(37, 21, 5, "sparse")
    for q in range(-2, 104):  # both clamp to 1-100
        assert encode_jpeg_coeffs(*planes, 37, 21, q) == \
            native_codecs.encode_jpeg_coeffs(*planes, 37, 21, q), q


@needs_native
@pytest.mark.parametrize("w,h", [(16, 16), (41, 23)])
def test_extreme_values_and_zero_runs(w, h):
    """DC jumps of +-2047 from block to block, ACs of +-1023 and zero runs
    of every length 15-62 before a non-zero AC."""
    ys, cs = _grids(w, h)
    y = np.zeros(ys, np.int16)
    flat = y.reshape(-1, 64)
    flat[0::2, 0] = 1023
    flat[1::2, 0] = -1024  # jumps of -2047 and +2047
    zz = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26,
          33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56,
          57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38,
          31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
    for i, blk in enumerate(flat):
        run = 15 + i % 48  # zeros before the AC at zigzag position run + 1
        blk[zz[min(run + 1, 63)]] = 1023 if i % 3 else -1023
        blk[zz[1]] = -1023 if i % 2 else 0
    cb = np.zeros(cs, np.int16)
    cb.reshape(-1, 64)[:, 63] = 1023
    cr = np.full(cs, -1, np.int16)
    for q in (1, 75, 100):
        got = encode_jpeg_coeffs(y, cb, cr, w, h, q)
        assert got == native_codecs.encode_jpeg_coeffs(y, cb, cr, w, h, q)
    meta = read_jpeg_coeffs(got)
    np.testing.assert_array_equal(meta["y"], y[: (h + 7) // 8, : (w + 7) // 8])
    np.testing.assert_array_equal(meta["cb"], cb)
    np.testing.assert_array_equal(meta["cr"], cr)


@pytest.mark.parametrize("w,h", [(8, 8), (17, 9), (301, 199), (64, 48)])
def test_round_trip_and_dummy_blocks(w, h):
    """The port's reader gives back the blocks within the true counts; the
    blocks past them (in the MCU-padded luma grid) are not read, so noise
    there leaves the bytes unchanged."""
    y, cb, cr = _planes(w, h, 11, "sparse")
    out = encode_jpeg_coeffs(y, cb, cr, w, h, 80)
    meta = read_jpeg_coeffs(out)
    bw, bh = (w + 7) // 8, (h + 7) // 8
    np.testing.assert_array_equal(meta["y"], y[:bh, :bw])
    np.testing.assert_array_equal(meta["cb"], cb)
    np.testing.assert_array_equal(meta["cr"], cr)
    assert (meta["w"], meta["h"], meta["subsamp"]) == (w, h, 420)
    noisy = y.copy()
    rng = np.random.default_rng(12)
    noisy[bh:] = rng.integers(-1023, 1024, noisy[bh:].shape)
    noisy[:, bw:] = rng.integers(-1023, 1024, noisy[:, bw:].shape)
    assert encode_jpeg_coeffs(noisy, cb, cr, w, h, 80) == out


@pytest.mark.parametrize("where,value", [
    ("dc_first", 2048), ("dc_first", -2048), ("dc_jump", 2048),
    ("ac", 1024), ("ac", -1024), ("ac", 32767), ("ac_chroma", -32768)])
def test_out_of_range_refused(where, value):
    y, cb, cr = _planes(16, 16, 3, "zeros")
    if where == "dc_first":
        y[0, 0, 0] = value
    elif where == "dc_jump":
        y[0, 0, 0], y[0, 1, 0] = -1024, 1024  # a difference of 2048
    elif where == "ac":
        y[1, 1, 9] = value
    else:
        cr[0, 0, 40] = value
    assert encode_jpeg_coeffs(y, cb, cr, 16, 16, 75) is None
    ref = native_codecs.encode_jpeg_coeffs(y, cb, cr, 16, 16, 75)
    if ref is not None:
        # libjpeg-turbo's SIMD path writes it anyway: not the input
        back = native_codecs.read_jpeg_coeffs(ref)
        assert back is None or not (np.array_equal(back["y"], y)
                                    and np.array_equal(back["cr"], cr))


@pytest.mark.parametrize("shapes", [
    ((4, 4, 64), (2, 2, 64), (2, 2, 64)),  # one block row short
    ((2, 2, 64), (1, 2, 64), (1, 1, 64)),  # chroma mismatch
    ((2, 2, 63), (1, 1, 64), (1, 1, 64)),  # not 64 per block
])
def test_shape_checks(shapes):
    planes = [np.zeros(s, np.int16) for s in shapes]
    assert encode_jpeg_coeffs(*planes, 16, 16, 75) is None
    if native_codecs.available() and shapes[2] == shapes[1]:
        assert native_codecs.encode_jpeg_coeffs(*planes, 16, 16, 75) is None
