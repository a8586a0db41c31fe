"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit), and the integer and unfused f32 issue
rates the kernels' bounds assume: 64 int32 lanes (a multiply-add as two
operations) and 128 FP32 lanes per SM per clock, 132 SMs at an assumed
1.98 GHz clock (the data sheet gives no integer rate; the clock is an
assumption, stated beside every share that uses it)."""

HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
CLOCK_HZ = 1.98e9
SMS = 132
INT32_OPS_PER_S = 64 * 2 * SMS * CLOCK_HZ
F32_UNFUSED_OPS_PER_S = 128 * SMS * CLOCK_HZ


def bound(nbytes: float, int32_ops: float = 0.0, f32_ops: float = 0.0,
          tf32_flop: float = 0.0) -> dict:
    """The least time of work that moves `nbytes` and issues these
    operations: the larger of the bytes' time at the HBM rate and the
    operations' (int32 and unfused f32 share the schedulers' issue, so
    their times add; tensor-core TF32 products at the TF32 rate), and
    which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (int32_ops / INT32_OPS_PER_S + f32_ops / F32_UNFUSED_OPS_PER_S
             + tf32_flop / TF32_FLOP_PER_S)
    return {"bytes": nbytes, "bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
