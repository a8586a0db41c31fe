"""The PyTorch port's host planning (fanlin_tpu_torch.ops.plan) against
the JAX package's (fanlin_tpu.ops.fused): plans, padded uniform
matrices and packed per-image parameters must be EXACTLY equal
(array_equal, no tolerance — both are numpy on the same filters)."""

import numpy as np
import pytest
import torch

from fanlin_tpu.ops import filters as jfilters
from fanlin_tpu.ops import fused as jfused
from fanlin_tpu.spec.query import parse_query as jparse_query
from fanlin_tpu_torch.ops import filters as tfilters
from fanlin_tpu_torch.ops import plan as tplan
from fanlin_tpu_torch.spec.query import parse_query as tparse_query


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


GOLDEN_CASES = [
    "w=300&h=200",
    "w=300&h=200&rgb=32,32,32",
    "w=100&h=100&crop=true",
    "w=300&h=200&grayscale=true",
    "w=150&h=150&inverse=true",
    "w=100&h=80&blur=1",
    "w=700&h=600&rgb=7,8,9",
]

# (src_w, src_h, query): the golden corpus on its 512x512 sources, a
# sub-bucket 7x5 source, prime output dims, upscale past the source,
# and no-resize / crop+gray+blur combinations.
CASES = (
    [(512, 512, q) for q in GOLDEN_CASES]
    + [
        (7, 5, "w=3&h=2"),
        (7, 5, "w=13&h=11&crop=true"),
        (7, 5, "grayscale=true"),
        (640, 480, "w=97&h=89"),
        (640, 480, "w=131&h=61&crop=true&grayscale=true&blur=2"),
        (100, 60, "w=997&h=613"),
        (100, 60, "w=400&h=400&rgb=1,2,3&inverse=true"),
        (333, 777, ""),
    ]
)


def _same_plan(a, b):
    for f in ("src_h", "src_w", "out_h", "out_w", "gray", "invert", "fill",
              "box", "use_canvas", "blur_sigma", "want_alpha"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.av, b.av)
    np.testing.assert_array_equal(a.ah, b.ah)
    assert a.av.dtype == b.av.dtype == np.float32


@pytest.mark.parametrize("opaque", [True, False])
@pytest.mark.parametrize("src_w,src_h,qs", CASES)
def test_plan_image_matches(src_w, src_h, qs, opaque):
    q = tparse_query(qs)
    _same_plan(tplan.plan_image(src_w, src_h, q, opaque=opaque),
               jfused.plan_image(src_w, src_h, jparse_query(qs),
                                 opaque=opaque))
    # identical queries share one plan object (uniform batching)
    assert (tplan.plan_image(src_w, src_h, q, opaque=opaque)
            is tplan.plan_image(src_w, src_h, tparse_query(qs),
                                opaque=opaque))


@pytest.mark.parametrize("src_w,src_h,qs", CASES)
def test_uniform_padded_matches(src_w, src_h, qs):
    got = tplan._uniform_padded(
        tplan.plan_image(src_w, src_h, tparse_query(qs)))
    want = jfused._uniform_padded(
        jfused.plan_image(src_w, src_h, jparse_query(qs)))
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("uniform", [True, False])
def test_pack_params_matches(uniform):
    specs = [(64, 48, "w=40&h=30&grayscale=true"),
             (50, 70, "w=40&h=30&blur=2&rgb=9,8,7"),
             (7, 5, "w=40&h=30&crop=true&inverse=true")]
    if uniform:
        specs = [specs[1]] * 3
    args = []
    for mod, parse_query in ((tplan, tparse_query), (jfused, jparse_query)):
        plans = [mod.plan_image(w, h, parse_query(qs)) for w, h, qs in specs]
        b = mod.bucket_b(len(plans))
        sh = mod.bucket_h(max(p.src_h for p in plans))
        sw = mod.bucket_w(max(p.src_w for p in plans))
        oh = mod.bucket_h(max(p.out_h for p in plans))
        ow = mod.bucket_w(max(p.out_w for p in plans))
        has_blur = any(p.blur_sigma > 0 for p in plans)
        args.append(mod._pack_params(plans, b, sh, sw, oh, ow, uniform,
                                     has_blur))
    for g, w in zip(*args):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


@pytest.mark.parametrize("n", [1, 2, 3, 5, 16, 17, 32, 33, 70])
def test_buckets_match(n):
    for v in (n, n * 37, n * 131):
        assert tplan.bucket_h(v) == jfused.bucket_h(v)
        assert tplan.bucket_w(v) == jfused.bucket_w(v)
    assert tplan.bucket_b(n) == jfused.bucket_b(n)


def test_nearest_filter_plan_matches():
    """GIF frames plan with the Nearest filter."""
    _same_plan(tplan.plan_image(64, 48, tparse_query("w=33&h=21"),
                                tfilters.NEAREST),
               jfused.plan_image(64, 48, jparse_query("w=33&h=21"),
                                 jfilters.NEAREST))
