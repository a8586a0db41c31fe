"""The least work of one image through the fused decode kernel
(`csrc/jpeg_decode.cu`, `decode_rgb_kernel<...>`): the int16 wire of
the image's true MCU grid read once with its three quant tables, the
RGB output of its true rect written once, and the integer operations
of its blocks (dequantise, the 16 passes of the 8-point islow iDCT,
level shift and clamp) and of its pixels (chroma upsample and the
YCbCr to RGB conversion). A copy of chip_smoke.py's `decode_bound` and
its operation counts, for one image whose output is its own rect."""

TRACE_NAME = "decode_rgb_kernel"
CALL_NAME = "decode_rgb_kernel"  # one launch per batch

PASS_OPS = 62
BLOCK_OPS = 64 + 16 * PASS_OPS + 3 * 64
PIXEL_OPS = {444: 22, 422: 30, 440: 30, 420: 34}
DIVISORS = {420: (2, 2), 422: (1, 2), 440: (2, 1), 444: (1, 1)}


def decode_work(w: int, h: int, subsamp: int, n: int, b: int, sh: int,
                sw: int) -> dict:
    """(bytes, int32 operations) of n real images of w x h in a call
    that writes b outputs of sh x sw."""
    dv, dh = DIVISORS[subsamp]
    ch, cw = -(-h // dv), -(-w // dh)
    blocks = -(-h // 8) * -(-w // 8) + 2 * -(-ch // 8) * -(-cw // 8)
    return {"bytes": n * (blocks * 128 + 2 * 64 * 4) + b * 3 * sh * sw,
            "int32_ops": n * (blocks * BLOCK_OPS + h * w * PIXEL_OPS[subsamp])}


def least(geo, source, peaks) -> dict:
    work = decode_work(source["w"], source["h"], source["subsamp"], 1, 1,
                       source["h"], source["w"])
    return peaks.bound(work["bytes"], int32_ops=work["int32_ops"])
