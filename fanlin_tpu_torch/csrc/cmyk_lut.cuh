// The sampled ICC LUT's evaluation on one pixel, shared by K12b
// (cmyk_lut.cu) and the CMYK decode that converts in its colour stage
// (jpeg_decode.cu, jpeg_decode_cmyk_rgb). Plain versions:
// ops/cmyk_lut.lut_planes (the JAX function's order) and
// lut_planes_packed (this order of work); both give these bits.
//
// Bit-exact: every f32 operation that the plain version rounds is
// rounded here on its own (__fmul_rn, __fsub_rn, __fadd_rn: nvcc fuses
// nothing into an FMA), and the rest is exact. Per component x = v *
// scale, scale = f32((n - 1) / 255); lo = min(floor(x), n - 2) (x >= 0);
// frac = x - lo, rest = 1 - frac. The weights are shared prefixes,
// formed once: f0 * f1 (4), then * f2 (8), then * f3 (16), each the
// plain version's left-to-right product (1 * f0 is f0), so 28
// multiplies give the bits of its 64. Corners 0..15 (bit i selects
// component i) accumulate in order, acc = acc + w * sample from 0; the
// result is floor(acc + 0.5), saturated to [0, 255] by the caller's
// cvt.pack.sat.
//
// The LUT is pack_lut's (ops/cmyk_lut.py): row e holds the u8 RGB words
// of entries e, e + 1, e + n, e + n + 1, the corners of the K and Y bits.
// A pixel gathers four 16 B rows, at base + {0, n^3, n^2, n^3 + n^2}
// (the C and M bits), all issued before it accumulates. The samples are
// integers in [0, 255], so the products are those of the f32 LUT.
//
// Conversions run at an eighth of the FP32 rate on Hopper, so none is
// spent on the 52 bytes a pixel turns into floats. One byte permute makes
// 0x4B0000bb, the f32 2^23 + bb, and a product by bb is one FMA: w * (2^23
// + bb) - w * 2^23 is exactly w * bb, which the FMA rounds once, as
// __fmul_rn(w, bb) does (w * 2^23 is exact, and formed once per corner).
// x + 2^23 rounded down is 2^23 + floor(x), whose bits hold floor(x) as
// an integer. The f32 operations the function needs (LUT_OPS in
// chip_smoke.py): per component the scale multiply, the floor and two
// subtracts (16), 28 weight products, per corner 3 multiplies and 3 adds
// (96), per channel the rounding add and floor (6): 146. The kernels
// issue 16 more (the w * 2^23 of each corner).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace fanlin {

// The LUT as the kernels read it.
struct PackedLut {
  const int4* rows;  // (n^4, 4) words R | G << 8 | B << 16, 16 B aligned
  int n, n2, n3;     // n, n^2, n^3
  float scale;       // f32((n - 1) / 255)
  float top;         // n - 2, the largest base level
};

__host__ __device__ inline PackedLut packed_lut(const int32_t* rows, int n,
                                                float scale) {
  return PackedLut{reinterpret_cast<const int4*>(rows), n, n * n, n * n * n,
                   scale, static_cast<float>(n - 2)};
}

// One pixel between its gathers and its accumulation.
struct LutFetch {
  int4 row[4];  // the rows of the C and M corners 0, 1, 2, 3
  float frac[4], rest[4];
};

// 2^23 + byte i of w, an f32.
__device__ __forceinline__ float biased(uint32_t w, int i) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + i));
}

// __fmul_rn(a, bb) for byte bb given as biased(.) = 2^23 + bb, with
// a_lo = -a * 2^23.
__device__ __forceinline__ float mul_byte(float a, float biased_bb,
                                          float a_lo) {
  return __fmaf_rn(a, biased_bb, a_lo);
}

// Four int32 values saturated to [0, 255] and packed, v0 in the low
// byte: two cvt.pack.sat (I2IP), each placing sat(a) in bits 8-15, sat(b)
// in bits 0-7 and c's low half in bits 16-31.
__device__ __forceinline__ uint32_t pack_sat4(int v0, int v1, int v2,
                                              int v3) {
  uint32_t hi, d;
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, 0;" : "=r"(hi) : "r"(v3), "r"(v2));
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(v1), "r"(v0), "r"(hi));
  return d;
}

// The 4x4 byte transpose: w[p] byte j <-> w[j] byte p (four planes'
// words of four pixels <-> the pixels' words c | m << 8 | y << 16 |
// k << 24).
__device__ __forceinline__ void transpose4(uint32_t (&w)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(t0, t1, 0x5410);
  w[1] = __byte_perm(t0, t1, 0x7632);
  w[2] = __byte_perm(t2, t3, 0x5410);
  w[3] = __byte_perm(t2, t3, 0x7632);
}

// The fractions of pixel cmyk (c | m << 8 | y << 16 | k << 24) and its
// four gathers.
__device__ __forceinline__ void lut_fetch(uint32_t cmyk, const PackedLut& L,
                                          LutFetch& f) {
  int base = 0;
  const float scale_lo = -0x1p23f * L.scale;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = mul_byte(L.scale, biased(cmyk, i), scale_lo);
    const float t = __fadd_rd(x, 0x1p23f);  // 2^23 + floor(x)
    base = base * L.n + min(__float_as_int(t) - 0x4B000000, L.n - 2);
    f.frac[i] = __fsub_rn(x, fminf(__fsub_rn(t, 0x1p23f), L.top));
    f.rest[i] = __fsub_rn(1.0f, f.frac[i]);
  }
  const int4* r = L.rows + base;
  f.row[0] = __ldg(r);
  f.row[1] = __ldg(r + L.n3);
  f.row[2] = __ldg(r + L.n2);
  f.row[3] = __ldg(r + L.n3 + L.n2);
}

// The 16 corners of a fetched pixel: its R, G, B before saturation.
__device__ __forceinline__ void lut_accum(const LutFetch& f, int& r, int& g,
                                          int& b) {
  float p01[4], p012[8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    p01[j] = __fmul_rn(j & 1 ? f.frac[0] : f.rest[0],
                       j & 2 ? f.frac[1] : f.rest[1]);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    p012[j] = __fmul_rn(p01[j & 3], j & 4 ? f.frac[2] : f.rest[2]);
  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const float w = __fmul_rn(p012[c & 7], c & 8 ? f.frac[3] : f.rest[3]);
    const float w_lo = -0x1p23f * w;
    const int4& row = f.row[c & 3];
    const int k = 2 * ((c >> 2) & 1) + (c >> 3);  // the Y and K bits
    const uint32_t word = k == 0   ? row.x
                          : k == 1 ? row.y
                          : k == 2 ? row.z
                                   : row.w;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      acc[ch] = __fadd_rn(acc[ch], mul_byte(w, biased(word, ch), w_lo));
  }
  r = __float2int_rd(__fadd_rn(acc[0], 0.5f));
  g = __float2int_rd(__fadd_rn(acc[1], 0.5f));
  b = __float2int_rd(__fadd_rn(acc[2], 0.5f));
}

// The N pixels px through the LUT, the next pixel's gathers in flight
// while one accumulates: out(j, r, g, b) receives pixel j's R, G, B
// before saturation.
template <int N, typename Out>
__device__ __forceinline__ void lut_pixels(const uint32_t (&px)[N],
                                           const PackedLut& L, Out out) {
  LutFetch f[2];
  lut_fetch(px[0], L, f[0]);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j + 1 < N) lut_fetch(px[j + 1], L, f[(j + 1) & 1]);
    int r, g, b;
    lut_accum(f[j & 1], r, g, b);
    out(j, r, g, b);
  }
}

}  // namespace fanlin
