"""The check's numbers on bodies made here: the reference's own body
passes, a near-tie re-quantised passes, and a local gross error that
moves too few values for `px_diff_pct` fails on `px_max_diff`."""

import numpy as np
import pytest

from harness import cell, compare, imaging, loadgen
from sources import photo

LIMITS = cell.load_json("configs", "camera-12mp")["limits"]
QUERY = "w=640&h=480"


@pytest.fixture(scope="module")
def source():
    rgb = photo.photo(1280, 960, np.random.default_rng([3, 100]))
    jpeg = imaging.encode_jpeg(rgb, 90)
    planes = imaging.source_planes(imaging.decode_rgb(jpeg), "cpu")
    geo = imaging.geometry(1280, 960, QUERY)
    return jpeg, imaging.resample(planes, geo)


def _check(source, pixels):
    jpeg, _ = source
    body = imaging.encode_jpeg(pixels, 75)
    rec = loadgen.Record("a.jpg", QUERY, 0.0, status=200,
                         body_hash=compare.body_hash(body))
    return compare.check([rec], {rec.body_hash: body}, {"a.jpg": jpeg},
                         "cpu", LIMITS)


def test_the_references_body_passes(source):
    out = _check(source, source[1])
    assert out["ok"] and out["numbers"]["px_max_diff"][0] == 0
    assert out["numbers"]["px_diff_pct"][0] == 0.0


def test_near_ties_rounded_the_other_way_pass(source):
    px = source[1].astype(np.int16).ravel()
    idx = np.random.default_rng(1).choice(px.size, 40, replace=False)
    px[idx] = np.clip(px[idx] + 1, 0, 255)
    out = _check(source, px.reshape(source[1].shape).astype(np.uint8))
    assert out["ok"]
    assert 0 < out["numbers"]["px_max_diff"][0] <= LIMITS["px_max_diff"]


def test_a_band_of_rows_fails_on_its_magnitude(source):
    px = source[1].copy()
    px[240:244] = 0  # within one row of 16x16 blocks
    out = _check(source, px)
    assert not out["ok"] and out["wrong"]
    assert out["numbers"]["px_diff_pct"][0] < LIMITS["px_diff_pct"]
    assert out["numbers"]["px_max_diff"][0] > LIMITS["px_max_diff"]
    assert out["numbers"]["bad_answers"][0] == 1
