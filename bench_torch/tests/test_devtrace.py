"""The device trace reader on a recorded capture (tests/data/
trace_fixture.json, an excerpt of a `GET /profile` capture of the
server on the H100) and on hand-made intervals."""

import json
from pathlib import Path

import pytest

from harness import devtrace

FIXTURE = Path(__file__).resolve().parent / "data" / "trace_fixture.json"


def test_union_of_overlapping_intervals():
    assert devtrace.union_us([]) == 0.0
    assert devtrace.union_us([(0, 10), (5, 15), (20, 30)]) == 25.0
    assert devtrace.union_us([(20, 30), (0, 10), (2, 3)]) == 20.0
    assert devtrace.union_us([(0, 10), (10, 12)]) == 12.0


def _ev(cat, name, ts, dur, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid}


def test_busy_kernels_and_gaps():
    t = devtrace.Trace([
        _ev("kernel", "void decode_rgb_kernel<0>(DecodeArgs)", 100, 10),
        _ev("kernel", "void (anonymous namespace)::gemm_kernel<2, 0, false>"
            "(Args)", 105, 20),
        _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 200, 50),
        _ev("kernel", "void (anonymous namespace)::gemm_kernel<1, 2, false>"
            "(Args)", 1000, 5),
        _ev("cpu_op", "aten::copy_", 260, 700, tid=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 990, 5, tid=1),
        {"ph": "i", "name": "marker", "ts": 5},
    ])
    assert t.busy_s() == pytest.approx((25 + 50 + 5) / 1e6)
    assert len(t.kernels("gemm_kernel")) == 2
    assert len(t.kernels("gemm_kernel<2, 0")) == 1
    assert t.seconds(t.kernels("gemm_kernel")) == pytest.approx(25e-6)
    assert t.top_ops(2)[0] == ["Memcpy HtoD (Pinned -> Device)",
                               pytest.approx(50e-6)]
    gaps = t.idle_gaps()
    assert gaps[0] == ["aten::copy_", pytest.approx(750e-6)]
    assert gaps[1] == ["no host op traced", pytest.approx(75e-6)]


def test_recorded_capture():
    if not FIXTURE.exists():
        pytest.fail("the recorded fixture is missing")
    t = devtrace.Trace.load(FIXTURE)
    data = json.loads(FIXTURE.read_text())
    meta = data["expected"]
    assert len(t.device) == meta["device_events"]
    assert t.busy_s() == pytest.approx(meta["busy_s"], rel=1e-9)
    assert len(t.kernels("decode_rgb_kernel")) == meta["decode_calls"]
    assert len(t.kernels("gemm_kernel<2, 0")) == meta["resample_calls"]
    # the union never exceeds the summed durations, nor the span (up to
    # the rounding of microsecond stamps near 1.4e12)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in t.device]
    assert t.busy_s() <= t.seconds(t.device) * (1 + 1e-6)
    assert t.busy_s() <= (max(b for _, b in spans)
                          - min(a for a, _ in spans)) / 1e6 * (1 + 1e-6)
