"""The port's resample kernel wrapper (fanlin_tpu_torch.ops.
resample_kernels) on the CPU, where it runs its plain torch version,
against the Pallas kernel it replaces (interpret mode) and against the
JAX package's XLA path, on the four cases of tests/test_pallas.py.

Tolerance: at most 1 LSB anywhere and at most 0.5 % of bytes differing
(float32 sums in another order may flip a value at a .5 rounding
boundary). The CUDA kernel itself is compared with the same plain
version on the card by chip_smoke.py (phase 2).
"""

import numpy as np
import pytest
import torch

from fanlin_tpu.ops import fused as jfused
from fanlin_tpu.ops import pallas_kernels
from fanlin_tpu.spec.query import parse_query
from fanlin_tpu_torch.ops import _build
from fanlin_tpu_torch.ops import resample_kernels as rk
from tests.conftest import make_test_image

CPU = torch.device("cpu")
MAX_LSB = 1
MAX_FRAC = 0.005


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(a, b):
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.max() <= MAX_LSB, d.max()
    assert (d > 0).mean() <= MAX_FRAC, (d > 0).mean()


def _inputs(query, src=64, seeds=(0, 1)):
    plan = jfused.plan_image(src, src, parse_query(query), opaque=True)
    imgs = [make_test_image(src, src, seed=s) for s in seeds]
    asm = jfused.BatchAssembly([plan] * len(imgs), imgs)
    av, ah, bv, bh = jfused._uniform_padded(plan)
    return plan, asm, av, ah, bv, bh


PALLAS_CASES = ["w=100&h=48", "grayscale=true",
                "inverse=true&w=40&h=24&crop=true", "w=64&h=40&blur=1"]


@pytest.mark.parametrize("query", PALLAS_CASES)
def test_resample_uniform_matches_pallas_and_xla(query):
    plan, asm, av, ah, bv, bh = _inputs(query)
    flags, fill, box, tav, tah, tbv, tbh = rk.params_from_numpy(
        asm.flags, asm.fill, asm.box, av, ah, bv, bh, device=CPU)
    x = torch.from_numpy(asm.x)
    before = rk.launch_counts()
    got = rk.resample_uniform(flags, fill, box, tav, tah, x, tbv, tbh)
    assert rk.launch_counts() == before  # the CPU never launches the kernel
    assert got.dtype == torch.uint8 and got.shape == (2, 3) + av.shape[:1] + ah.shape[:1]

    pallas = np.asarray(pallas_kernels.resample_uniform(
        asm.flags, asm.fill, asm.box, av, ah, asm.x, interpret=True,
        bv=bv, bh=bh))
    _close(got.numpy(), pallas)

    xla = asm.run()
    for i, ref in enumerate(xla):
        _close(got[i, :, : plan.out_h, : plan.out_w].permute(1, 2, 0).numpy(),
               ref[..., :3])


@pytest.mark.parametrize("query", PALLAS_CASES)
def test_crop_stores_the_true_rect(query):
    """crop=(out_h, out_w) returns exactly the top-left rect of the
    padded result (blur still runs over the padded intermediate)."""
    plan, asm, av, ah, bv, bh = _inputs(query, seeds=(2, 3, 4))
    args = rk.params_from_numpy(asm.flags, asm.fill, asm.box, av, ah, bv, bh,
                                device=CPU)
    x = torch.from_numpy(asm.x)
    full = rk.resample_uniform(*args[:5], x, *args[5:])
    crop = rk.resample_uniform(*args[:5], x, *args[5:],
                               crop=(plan.out_h, plan.out_w))
    assert crop.shape == (4, 3, plan.out_h, plan.out_w)
    assert crop.is_contiguous()
    assert torch.equal(crop, full[:, :, : plan.out_h, : plan.out_w])


def test_launch_counts_stay_zero_on_cpu():
    rk.reset_launch_counts()
    _, asm, av, ah, bv, bh = _inputs("w=64&h=40&blur=1")
    args = rk.params_from_numpy(asm.flags, asm.fill, asm.box, av, ah, bv, bh,
                                device=CPU)
    rk.resample_uniform(*args[:5], torch.from_numpy(asm.x), *args[5:])
    assert rk.launch_counts() == {"resample": 0, "resample_blur": 0}


def test_params_from_numpy_types():
    _, asm, av, ah, bv, bh = _inputs("w=64&h=40&blur=1")
    flags, fill, box, tav, tah, tbv, tbh = rk.params_from_numpy(
        asm.flags, asm.fill, asm.box.astype(np.int64), av, ah, bv, bh,
        device=CPU)
    assert flags.dtype == fill.dtype == tav.dtype == tbh.dtype == torch.float32
    assert box.dtype == torch.int32
    np.testing.assert_array_equal(box.numpy(), asm.box)
    assert rk.params_from_numpy(asm.flags, asm.fill, asm.box, av, ah,
                                device=CPU)[5:] == (None, None)


def _good_args():
    _, asm, av, ah, bv, bh = _inputs("w=64&h=40&blur=1")
    args = list(rk.params_from_numpy(asm.flags, asm.fill, asm.box, av, ah,
                                     bv, bh, device=CPU))
    return args[:5] + [torch.from_numpy(asm.x)] + args[5:]


@pytest.mark.parametrize("bad", [
    "x_dtype", "x_channels", "x_noncontig", "av_shape", "flags_dtype",
    "box_dtype", "blur_half", "crop_too_big", "device_mismatch",
])
def test_wrapper_rejects_bad_arguments(bad):
    a = _good_args()  # flags, fill, box, av, ah, x, bv, bh
    kw = {}
    if bad == "x_dtype":
        a[5] = a[5].to(torch.int32)
    elif bad == "x_channels":
        a[5] = torch.cat([a[5], a[5][:, :1]], dim=1)
    elif bad == "x_noncontig":
        a[5] = a[5].transpose(2, 3)
    elif bad == "av_shape":
        a[3] = a[3][:, :-8]
    elif bad == "flags_dtype":
        a[0] = a[0].double()
    elif bad == "box_dtype":
        a[2] = a[2].long()
    elif bad == "blur_half":
        a[7] = None
    elif bad == "crop_too_big":
        kw["crop"] = (a[3].shape[0] + 1, 8)
    elif bad == "device_mismatch":
        a[1] = a[1].to("meta")
    with pytest.raises((ValueError, TypeError)):
        rk.resample_uniform(*a, **kw)


def test_non_cpu_non_cuda_device_raises():
    a = [t.to("meta") for t in _good_args()]
    with pytest.raises(ValueError, match="unsupported device"):
        rk.resample_uniform(*a)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: building the kernel raises (it never falls back)."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
