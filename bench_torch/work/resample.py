"""The least work of one image through the resample kernel
(`csrc/resample.cu`, `gemm_kernel<...>`): the multiply-adds of each
pass over the non-zero Lanczos3 weights, for just the rows and columns
the next pass or the stored output reads; the bytes of the source
pixels those weights reach, of the non-zero f32 weights, and of the u8
output. The products count as the kernel issues them on the tensor
cores, split TF32: 2 per multiply-add in pass 1, 3 in pass 2 (a copy
of chip_smoke.py's `resample_work`, without the blur pair, which no
cell's traffic asks for)."""

import numpy as np

TRACE_NAME = "gemm_kernel"  # every pass of the kernel
CALL_NAME = "gemm_kernel<2, 0"  # pass 1: one record per call


def resample_work(av, ah, crop, planes: int) -> dict:
    oh, ow = crop
    big_oh, sh = av.shape
    big_ow, sw = ah.shape
    need_r, need_c = np.arange(big_oh) < oh, np.arange(big_ow) < ow
    av, ah = av[need_r], ah[need_c]
    t_cols = ah.any(0)  # columns of T = Av P that pass 2 reads
    macs = [np.count_nonzero(av) * int(t_cols.sum()),
            np.count_nonzero(ah) * int(av.any(1).sum())]
    weights = np.count_nonzero(av) + np.count_nonzero(ah)
    src = int(av.any(0).sum()) * int(t_cols.sum())
    products = 2 * macs[0] + 3 * macs[1]
    return {"flop": 2 * sum(macs) * planes, "tf32_flop": 2 * products * planes,
            "nbytes": planes * (src + oh * ow) + 4 * weights}


def least(geo, source, peaks) -> dict:
    """`geo`: the image's harness.imaging.Geometry; `source`: its
    {"w", "h", "subsamp"}; `peaks`: harness.peaks."""
    av, ah = geo.weights()
    work = resample_work(av, ah, (geo.out_h, geo.out_w), 3)
    return peaks.bound(work["nbytes"], tf32_flop=work["tf32_flop"])
