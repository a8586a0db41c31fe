// K12b: the sampled ICC transform, CMYK -> RGB, for Hopper (sm_90a).
//
// Replaces fanlin_tpu/ops/cmyk_lut.py:63 lut_planes and :41 _lut_program
// (the pixel route of DeviceCmykTransform.convert): quadrilinear
// interpolation in an n^4 LUT sampled from the lcms2 transform, 16
// corners per pixel. The port's pixel route runs it (EXIF-rotated CMYK
// JPEGs, DeviceCmykTransform.convert); the coefficient route converts in
// the decode kernel's colour stage instead (jpeg_decode.cu,
// jpeg_decode_cmyk_rgb), with the same evaluation (cmyk_lut.cuh, whose
// note gives the arithmetic and why it is bit-exact against
// ops/cmyk_lut.lut_planes).
//
// What bounds it (chip_smoke.py lut_bound): issue. Bytes are 4 read and
// 3 written per pixel; the f32 work is 146 operations a pixel, none of
// them fusable, against 33.45 T thread-instructions/s (4 schedulers of
// 32 lanes on each of 132 SMs at 1.98 GHz): 4.4 ns per thousand pixels
// against 2.1 ns of bytes. What the design does about it:
// - The LUT is packed (ops/cmyk_lut.pack_lut): u8 samples, four entries
//   of the K and Y corners to a 16 B row (1.3 MB at n = 17), so a pixel
//   issues four 16 B gathers through the read-only path (__ldg), not 48
//   scalar 4 B ones.
// - The weights are shared prefixes (28 multiplies, not 64), and the
//   bytes enter the arithmetic without conversion instructions, a
//   product by a byte as one FMA (cmyk_lut.cuh).
// - Each thread converts 4 consecutive pixels, the next pixel's gathers
//   in flight while one accumulates, with one 4 B load and store per
//   plane (planar) or one 16 B load and three 4 B stores (pixels).
// The interface stays strided: the planar coefficient form (B, 4, H, W)
// -> (B, 3, H, W) and the interleaved pixel form (H, W, 4) -> (H, W, 3)
// take the vector paths; other strides, and a last thread's tail, load
// and store bytes.

#include <cuda_runtime.h>

#include <cstdint>

#include "cmyk_lut.cuh"

namespace {

using fanlin::PackedLut;

constexpr int kThreads = 256;
constexpr int kPix = 4;  // consecutive pixels per thread

// How the strides lay the pixels out.
enum Form { kStrided = 0, kPlanar = 1, kPixels = 2 };

struct LutArgs {
  const uint8_t* in;  // element (b, c, p) at in[b * in_b + c * in_c + p * in_p]
  uint8_t* out;       // element (b, c, p) at out[b * out_b + c * out_c + p * out_p]
  long long npix;     // pixels per image
  long long in_b, in_c, in_p, out_b, out_c, out_p;
  PackedLut lut;
};

template <int FORM>
__global__ void __launch_bounds__(kThreads) cmyk_lut_kernel(LutArgs a) {
  const long long p0 =
      (blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x) * kPix;
  if (p0 >= a.npix) return;
  const long long b = blockIdx.y;
  const uint8_t* src = a.in + b * a.in_b + p0 * a.in_p;
  uint8_t* dst = a.out + b * a.out_b + p0 * a.out_p;
  const int m =
      static_cast<int>(min(a.npix - p0, static_cast<long long>(kPix)));
  const bool vec = FORM != kStrided && m == kPix;
  uint32_t px[kPix];  // c | m << 8 | y << 16 | k << 24
  if (vec && FORM == kPlanar) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      px[c] = *reinterpret_cast<const uint32_t*>(src + c * a.in_c);
    fanlin::transpose4(px);
  } else if (vec) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    px[0] = v.x;
    px[1] = v.y;
    px[2] = v.z;
    px[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      px[j] = 0;
      if (j < m) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          px[j] |= static_cast<uint32_t>(src[j * a.in_p + c * a.in_c])
                   << (8 * c);
      }
    }
  }
  int rgb[3][kPix];
  fanlin::lut_pixels(px, a.lut, [&](int j, int r, int g, int bl) {
    rgb[0][j] = r;
    rgb[1][j] = g;
    rgb[2][j] = bl;
  });
  if (vec && FORM == kPlanar) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      *reinterpret_cast<uint32_t*>(dst + c * a.out_c) =
          fanlin::pack_sat4(rgb[c][0], rgb[c][1], rgb[c][2], rgb[c][3]);
  } else if (vec) {  // r0 g0 b0 r1 | g1 b1 r2 g2 | b2 r3 g3 b3
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    d[0] = fanlin::pack_sat4(rgb[0][0], rgb[1][0], rgb[2][0], rgb[0][1]);
    d[1] = fanlin::pack_sat4(rgb[1][1], rgb[2][1], rgb[0][2], rgb[1][2]);
    d[2] = fanlin::pack_sat4(rgb[2][2], rgb[0][3], rgb[1][3], rgb[2][3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (j < m) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          dst[j * a.out_p + c * a.out_c] =
              static_cast<uint8_t>(min(max(rgb[c][j], 0), 255));
      }
    }
  }
}

bool aligned(const void* p, int k) {
  return reinterpret_cast<uintptr_t>(p) % k == 0;
}

}  // namespace

// in: u8 CMYK, out: u8 RGB, strided as LutArgs says; lut: pack_lut's
// (n^4, 4) int32, 16-byte aligned. scale must be f32((n - 1) / 255).
// Returns a CUDA error code (0 on success).
extern "C" int fanlin_cmyk_lut(const uint8_t* in, const int32_t* lut,
                               uint8_t* out, int batch, long long npix,
                               long long in_b, long long in_c, long long in_p,
                               long long out_b, long long out_c,
                               long long out_p, int n, float scale,
                               void* stream) {
  const long long blocks = (npix + kThreads * kPix - 1) / (kThreads * kPix);
  if (batch <= 0 || batch > 65535 || npix <= 0 || n < 2 || n > 64 ||
      blocks > 2147483647LL || !aligned(lut, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const LutArgs a{in,    out,   npix,  in_b,
                  in_c,  in_p,  out_b, out_c,
                  out_p, fanlin::packed_lut(lut, n, scale)};
  const bool one = batch == 1;
  const bool planar = in_p == 1 && out_p == 1 && in_c % 4 == 0 &&
                      out_c % 4 == 0 && (one || (in_b % 4 == 0 &&
                                                 out_b % 4 == 0)) &&
                      aligned(in, 4) && aligned(out, 4);
  const bool pixels = in_p == 4 && in_c == 1 && out_p == 3 && out_c == 1 &&
                      (one || (in_b % 16 == 0 && out_b % 4 == 0)) &&
                      aligned(in, 16) && aligned(out, 4);
  const dim3 grid(static_cast<unsigned>(blocks), batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planar) {
    cmyk_lut_kernel<kPlanar><<<grid, kThreads, 0, s>>>(a);
  } else if (pixels) {
    cmyk_lut_kernel<kPixels><<<grid, kThreads, 0, s>>>(a);
  } else {
    cmyk_lut_kernel<kStrided><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
