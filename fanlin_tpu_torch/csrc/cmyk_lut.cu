// K12b: the sampled ICC transform, CMYK -> RGB, for Hopper (sm_90a).
//
// Replaces fanlin_tpu/ops/cmyk_lut.py:63 lut_planes (the LUT step of the
// XLA program fused.py:908 get_cmyk_coef_program, after decode_cmyk) and
// :41 _lut_program (the pixel route of DeviceCmykTransform.convert):
// quadrilinear interpolation in an (n^4, 3) f32 LUT sampled from the
// lcms2 transform, 16 corners per pixel. Plain version:
// ops/cmyk_lut.lut_planes.
//
// Bit-exact against the plain version: every f32 operation is the plain
// version's, in its order, rounded on its own (__fmul_rn / __fsub_rn /
// __fadd_rn, so nvcc contracts nothing into an FMA): x = v * scale with
// scale = f32((n - 1) / 255); lo = clamp(floor(x), 0, n - 2); frac = x -
// lo; per corner the weight is the product, left to right from 1, of frac
// or 1 - frac per component (bit i of the corner selects component i),
// the index ((i0 n + i1) n + i2) n + i3, and acc += w * sample; the result
// clamp(floor(acc + 0.5), 0, 255).
//
// What bounds it (chip_smoke.py lut_bound): bytes, 4 read and 3 written
// per pixel, against f32 work outside the tensor cores, 182 operations a
// pixel (per component the scale multiply, the floor and two subtracts,
// 16; per corner 4 weight products, 3 multiplies and 3 adds, 160; per
// channel the rounding add and floor, 6). At 67 TFLOP/s and 3.35 TB/s the
// operations bound it: 2.7 ns against 2.1 ns of bytes per thousand
// pixels. The 16 gathers of 12 B from a 1.0 MB LUT go through L2 and the
// read-only path (__ldg); the LUT does not fit in shared memory as f32,
// and the u8 form (250 KB) is queued. One thread per pixel, strided
// addressing so that one kernel serves the planar coefficient route
// (B, 4, H, W) -> (B, 3, H, W) and the interleaved pixel route (H, W, 4)
// -> (H, W, 3).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

struct LutArgs {
  const uint8_t* in;  // element (b, c, p) at in[b * in_b + c * in_c + p * in_p]
  const float* lut;   // (n^4, 3)
  uint8_t* out;       // element (b, c, p) at out[b * out_b + c * out_c + p * out_p]
  long long npix;     // pixels per image
  long long in_b, in_c, in_p, out_b, out_c, out_p;
  int n;
  float scale;        // f32((n - 1) / 255)
};

__device__ __forceinline__ uint8_t to_u8(float acc) {
  const float v = floorf(__fadd_rn(acc, 0.5f));
  return static_cast<uint8_t>(fminf(fmaxf(v, 0.0f), 255.0f));
}

__global__ void __launch_bounds__(256) cmyk_lut_kernel(LutArgs a) {
  const long long p = blockIdx.x * 256LL + threadIdx.x;
  if (p >= a.npix) return;
  const long long b = blockIdx.y;
  const uint8_t* src = a.in + b * a.in_b + p * a.in_p;
  int lo[4];
  float frac[4], rest[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = __fmul_rn(static_cast<float>(src[i * a.in_c]), a.scale);
    lo[i] = min(max(static_cast<int>(floorf(x)), 0), a.n - 2);
    frac[i] = __fsub_rn(x, static_cast<float>(lo[i]));
    rest[i] = __fsub_rn(1.0f, frac[i]);
  }
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
#pragma unroll
  for (int corner = 0; corner < 16; ++corner) {
    float w = 1.0f;
    int idx = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int bit = (corner >> i) & 1;
      idx = idx * a.n + lo[i] + bit;
      w = __fmul_rn(w, bit ? frac[i] : rest[i]);
    }
    const float* s = a.lut + 3LL * idx;
    acc0 = __fadd_rn(acc0, __fmul_rn(w, __ldg(s)));
    acc1 = __fadd_rn(acc1, __fmul_rn(w, __ldg(s + 1)));
    acc2 = __fadd_rn(acc2, __fmul_rn(w, __ldg(s + 2)));
  }
  uint8_t* dst = a.out + b * a.out_b + p * a.out_p;
  dst[0] = to_u8(acc0);
  dst[a.out_c] = to_u8(acc1);
  dst[2 * a.out_c] = to_u8(acc2);
}

}  // namespace

// in: u8 CMYK, out: u8 RGB, strided as LutArgs says; lut: (n^4, 3) f32,
// 4-byte aligned. scale must be f32((n - 1) / 255). Returns a CUDA error
// code (0 on success).
extern "C" int fanlin_cmyk_lut(const uint8_t* in, const float* lut,
                               uint8_t* out, int batch, long long npix,
                               long long in_b, long long in_c, long long in_p,
                               long long out_b, long long out_c,
                               long long out_p, int n, float scale,
                               void* stream) {
  if (batch <= 0 || batch > 65535 || npix <= 0 || n < 2 ||
      (npix + 255) / 256 > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  LutArgs a{in, lut, out, npix, in_b, in_c, in_p, out_b, out_c, out_p, n,
            scale};
  const dim3 grid(static_cast<unsigned>((npix + 255) / 256), batch);
  cmyk_lut_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
