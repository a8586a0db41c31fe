// The coefficient decode back half for Hopper (sm_90a), CUDA C++.
//
// Replaces the XLA decode prologue of the JAX package's coefficient
// program (fanlin_tpu/ops/fused.py get_coef_program, running
// fanlin_tpu/ops/jpeg_decode.py):
//
//   K3 jpeg_islow (jpeg_decode.py:158 islow_decode_plane, :135
//      islow_idct_planar, :92 _islow_pass): dequant, DC injection, the
//      libjpeg islow column pass (DESCALE by 11) and row pass (by 18),
//      +128 and saturation; int16 natural-order blocks in, u8 planes out.
//   K4 jpeg_upsample_rgb (jpeg_decode.py:243-361 decode{420,422,440,
//      444}_rgb, :195/:277/:313 fancy_upsample_*, :225
//      ycbcr_to_rgb_libjpeg): the layout's fancy chroma upsample at the
//      TRUE chroma dims, then jdcolor's fixed-point YCbCr->RGB, written
//      as u8 r, g, b planes straight into the resample kernel's input
//      layout (B, 3, bucket_h(h), bucket_w(w)), zero outside the true
//      rect.
//
// Both are integer work and bit-exact against their plain torch
// versions (ops/jpeg_decode_kernels.py): int32 products that wrap,
// arithmetic right shifts, the same order of operations.
//
// What bounds them. Each is a single pass over memory with a few dozen
// integer operations per byte: K3 reads 2 B and writes 1 B per sample
// (about 80 int32 ops per sample across both passes), K4 reads ~1.5-3 B
// and writes 3 B per pixel. At 12 MP B=2 that is ~56 MB for K3 and
// ~100 MB for K4, ~0.05 ms at 3.35 TB/s. In the JAX package this was
// an XLA program; ported op by op to eager torch it is ~400 launches
// per request, which on the host costs more than the device work. Two
// launches replace them.
//
// What the design does about it (a simple first form):
// - K3: one thread per 8x8 block, all three planes of the batch in one
//   launch. A thread loads its block as eight 16 B vector loads,
//   dequantizes and runs both passes in registers (64 int32), and
//   stores each output row as one 8 B store; neighbouring threads take
//   neighbouring blocks of a block row, so the stores of a warp are
//   contiguous.
// - K4: one thread per output pixel of the bucket; neighbouring threads
//   take neighbouring columns, so the u8 loads and the three plane
//   stores of a warp are contiguous. The chroma neighbours the upsample
//   reads are shared by adjacent threads and come from L1.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPass1Shift = 11;  // CONST_BITS - PASS1_BITS
constexpr int kPass2Shift = 18;  // CONST_BITS + PASS1_BITS + 3

// One 8-point islow pass (jidctint.c), in place on s[0], s[st], ...
template <int SHIFT>
__device__ __forceinline__ void islow_pass(int* s, int st) {
  int z2 = s[2 * st], z3 = s[6 * st];
  int z1 = (z2 + z3) * 4433;
  const int t2 = z1 - z3 * 15137;
  const int t3 = z1 + z2 * 6270;
  z2 = s[0];
  z3 = s[4 * st];
  const int t0 = (z2 + z3) << 13;
  const int t1 = (z2 - z3) << 13;
  const int e0 = t0 + t3, e3 = t0 - t3;
  const int e1 = t1 + t2, e2 = t1 - t2;
  int o0 = s[7 * st], o1 = s[5 * st], o2 = s[3 * st], o3 = s[1 * st];
  z1 = o0 + o3;
  z2 = o1 + o2;
  z3 = o0 + o2;
  int z4 = o1 + o3;
  const int z5 = (z3 + z4) * 9633;
  o0 = o0 * 2446;
  o1 = o1 * 16819;
  o2 = o2 * 25172;
  o3 = o3 * 12299;
  z1 = z1 * -7373;
  z2 = z2 * -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  o0 = o0 + z1 + z3;
  o1 = o1 + z2 + z4;
  o2 = o2 + z2 + z3;
  o3 = o3 + z1 + z4;
  constexpr int rnd = 1 << (SHIFT - 1);
  s[0] = (e0 + o3 + rnd) >> SHIFT;
  s[1 * st] = (e1 + o2 + rnd) >> SHIFT;
  s[2 * st] = (e2 + o1 + rnd) >> SHIFT;
  s[3 * st] = (e3 + o0 + rnd) >> SHIFT;
  s[4 * st] = (e3 - o0 + rnd) >> SHIFT;
  s[5 * st] = (e2 - o1 + rnd) >> SHIFT;
  s[6 * st] = (e1 - o2 + rnd) >> SHIFT;
  s[7 * st] = (e0 - o3 + rnd) >> SHIFT;
}

struct IslowArgs {
  const int16_t* coef[3];  // (B, bh, bw, 64) per plane
  uint8_t* out[3];         // (B, 8 bh, 8 bw) per plane
  int bh[3], bw[3];
  const int32_t* q;        // (B, 2, 64): luma, chroma
  long long n0, n1;        // blocks in plane 0, planes 0-1
  long long total;         // blocks in all three planes
};

__global__ void __launch_bounds__(128) islow_kernel(IslowArgs a) {
  const long long g = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (g >= a.total) return;
  // selects, not a dynamic index into the parameter arrays (which
  // would copy them to the stack)
  const int plane = g < a.n0 ? 0 : (g < a.n1 ? 1 : 2);
  const long long i = g - (plane == 0 ? 0 : (plane == 1 ? a.n0 : a.n1));
  const int bh = plane ? a.bh[1] : a.bh[0];
  const int bw = plane ? a.bw[1] : a.bw[0];
  const int16_t* coef =
      plane == 0 ? a.coef[0] : (plane == 1 ? a.coef[1] : a.coef[2]);
  uint8_t* out = plane == 0 ? a.out[0] : (plane == 1 ? a.out[1] : a.out[2]);
  const long long per_image = static_cast<long long>(bh) * bw;
  const int b = static_cast<int>(i / per_image);
  const int rem = static_cast<int>(i - b * per_image);
  const int by = rem / bw, bx = rem - by * bw;

  int ws[64];
  const int4* src = reinterpret_cast<const int4*>(coef + i * 64);
  const int32_t* q = a.q + (b * 2 + (plane ? 1 : 0)) * 64;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int4 raw = src[v];
    const int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // little-endian: coefficient 2k is the low half of word k
      const int c = (j & 1) ? (words[j >> 1] >> 16)
                            : static_cast<int16_t>(words[j >> 1] & 0xFFFF);
      ws[v * 8 + j] = c * __ldg(q + v * 8 + j);
    }
  }
#pragma unroll
  for (int x = 0; x < 8; ++x) islow_pass<kPass1Shift>(ws + x, 8);  // columns
#pragma unroll
  for (int y = 0; y < 8; ++y) islow_pass<kPass2Shift>(ws + 8 * y, 1);  // rows

  const long long pitch = 8LL * bw;
  uint8_t* dst =
      out + (static_cast<long long>(b) * bh * 8 + by * 8) * pitch + bx * 8;
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int s0 = min(max(ws[8 * y + x] + 128, 0), 255);
      const int s1 = min(max(ws[8 * y + 4 + x] + 128, 0), 255);
      lo |= static_cast<uint32_t>(s0) << (8 * x);
      hi |= static_cast<uint32_t>(s1) << (8 * x);
    }
    *reinterpret_cast<uint2*>(dst + y * pitch) = make_uint2(lo, hi);
  }
}

struct UpsampleArgs {
  const uint8_t* y;   // (B, yh, yw)
  const uint8_t* cb;  // (B, ch_pad, cw_pad)
  const uint8_t* cr;
  uint8_t* out;       // (B, 3, out_h, out_w)
  int yh, yw, ch_pad, cw_pad;
  int true_h, true_w, ch, cw;  // ch, cw: true chroma dims
  int out_h, out_w;
};

template <int SUBSAMP>
__device__ __forceinline__ int chroma_at(const uint8_t* c, int pitch, int ch,
                                         int cw, int y, int x) {
  if (SUBSAMP == 444) return c[y * pitch + x];
  if (SUBSAMP == 422) {  // h2v1
    const int cx = x >> 1;
    const uint8_t* row = c + y * pitch;
    if (x & 1) return (3 * row[cx] + row[min(cx + 1, cw - 1)] + 2) >> 2;
    return (3 * row[cx] + row[max(cx - 1, 0)] + 1) >> 2;
  }
  if (SUBSAMP == 440) {  // v2h1
    const int cy = y >> 1;
    const int ny = (y & 1) ? min(cy + 1, ch - 1) : max(cy - 1, 0);
    const int bias = (y & 1) ? 2 : 1;
    return (3 * c[cy * pitch + x] + c[ny * pitch + x] + bias) >> 2;
  }
  // h2v2: column sums with the nearer row (x3) and the farther row
  const int cy = y >> 1, cx = x >> 1;
  const int ny = (y & 1) ? min(cy + 1, ch - 1) : max(cy - 1, 0);
  const int nx = (x & 1) ? min(cx + 1, cw - 1) : max(cx - 1, 0);
  const uint8_t* near = c + cy * pitch;
  const uint8_t* far = c + ny * pitch;
  const int col = 3 * near[cx] + far[cx];
  const int side = 3 * near[nx] + far[nx];
  return (3 * col + side + ((x & 1) ? 7 : 8)) >> 4;
}

template <int SUBSAMP>
__global__ void __launch_bounds__(256) upsample_rgb_kernel(UpsampleArgs a) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= a.out_w) return;
  const long long plane = static_cast<long long>(a.out_h) * a.out_w;
  uint8_t* o = a.out + b * 3 * plane + static_cast<long long>(y) * a.out_w + x;
  if (y >= a.true_h || x >= a.true_w) {
    o[0] = 0;
    o[plane] = 0;
    o[2 * plane] = 0;
    return;
  }
  const long long cplane = static_cast<long long>(a.ch_pad) * a.cw_pad;
  const int yy = a.y[(static_cast<long long>(b) * a.yh + y) * a.yw + x];
  const int cbz = chroma_at<SUBSAMP>(a.cb + b * cplane, a.cw_pad, a.ch, a.cw,
                                     y, x) - 128;
  const int crz = chroma_at<SUBSAMP>(a.cr + b * cplane, a.cw_pad, a.ch, a.cw,
                                     y, x) - 128;
  const int r = yy + ((91881 * crz + 32768) >> 16);
  const int bl = yy + ((116130 * cbz + 32768) >> 16);
  const int g = yy + ((-22554 * cbz + 32768 - 46802 * crz) >> 16);
  o[0] = static_cast<uint8_t>(min(max(r, 0), 255));
  o[plane] = static_cast<uint8_t>(min(max(g, 0), 255));
  o[2 * plane] = static_cast<uint8_t>(min(max(bl, 0), 255));
}

}  // namespace

// K3. coef_*: (B, bh, bw, 64) int16, 16-byte aligned; q: (B, 2, 64)
// int32; out_*: (B, 8 bh, 8 bw) u8, 8-byte aligned. Returns a CUDA error
// code (0 on success).
extern "C" int fanlin_jpeg_islow(const int16_t* coef_y, const int16_t* coef_cb,
                                 const int16_t* coef_cr, const int32_t* q,
                                 uint8_t* out_y, uint8_t* out_cb,
                                 uint8_t* out_cr, int batch, int ybh, int ybw,
                                 int cbh, int cbw, void* stream) {
  if (batch <= 0 || ybh <= 0 || ybw <= 0 || cbh <= 0 || cbw <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  IslowArgs a;
  a.coef[0] = coef_y;
  a.coef[1] = coef_cb;
  a.coef[2] = coef_cr;
  a.out[0] = out_y;
  a.out[1] = out_cb;
  a.out[2] = out_cr;
  a.bh[0] = ybh;
  a.bw[0] = ybw;
  a.bh[1] = a.bh[2] = cbh;
  a.bw[1] = a.bw[2] = cbw;
  a.q = q;
  const long long ny = static_cast<long long>(batch) * ybh * ybw;
  const long long nc = static_cast<long long>(batch) * cbh * cbw;
  a.n0 = ny;
  a.n1 = ny + nc;
  a.total = ny + 2 * nc;
  const int threads = 128;
  const long long blocks = (a.total + threads - 1) / threads;
  islow_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K4. y: (B, yh, yw) u8; cb, cr: (B, ch_pad, cw_pad) u8; out: (B, 3,
// out_h, out_w) u8. subsamp: 420, 422, 440 or 444. Returns a CUDA error
// code (0 on success).
extern "C" int fanlin_jpeg_upsample_rgb(const uint8_t* y, const uint8_t* cb,
                                        const uint8_t* cr, uint8_t* out,
                                        int batch, int yh, int yw, int ch_pad,
                                        int cw_pad, int subsamp, int true_h,
                                        int true_w, int out_h, int out_w,
                                        void* stream) {
  const int dv = (subsamp == 420 || subsamp == 440) ? 2 : 1;
  const int dh = (subsamp == 420 || subsamp == 422) ? 2 : 1;
  UpsampleArgs a{y, cb, cr, out, yh, yw, ch_pad, cw_pad, true_h, true_w,
                 (true_h + dv - 1) / dv, (true_w + dh - 1) / dh, out_h, out_w};
  if (batch <= 0 || batch > 65535 || out_h <= 0 || out_h > 65535 ||
      out_w <= 0 || true_h <= 0 || true_w <= 0 || true_h > out_h ||
      true_w > out_w || true_h > yh || true_w > yw || a.ch > ch_pad ||
      a.cw > cw_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const dim3 grid((out_w + threads - 1) / threads, out_h, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (subsamp) {
    case 420: upsample_rgb_kernel<420><<<grid, threads, 0, s>>>(a); break;
    case 422: upsample_rgb_kernel<422><<<grid, threads, 0, s>>>(a); break;
    case 440: upsample_rgb_kernel<440><<<grid, threads, 0, s>>>(a); break;
    case 444: upsample_rgb_kernel<444><<<grid, threads, 0, s>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
