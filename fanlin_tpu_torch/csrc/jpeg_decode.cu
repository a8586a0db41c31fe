// The coefficient decode for Hopper (sm_90a), CUDA C++.
//
// Replaces the XLA decode prologue of the JAX package's coefficient
// program (fanlin_tpu/ops/fused.py:829 get_coef_program, which runs
// fanlin_tpu/ops/jpeg_decode.py inside the same program as the chain):
// jpeg_decode.py:158 islow_decode_plane (:135 islow_idct_planar, :92
// _islow_pass: dequant, the libjpeg islow column pass, DESCALE 11, the
// row pass, DESCALE 18, +128 and saturation) and :243-361
// decode{420,422,440,444}_rgb (:195/:277/:313 fancy_upsample_*, at the
// TRUE chroma dims, and :225 ycbcr_to_rgb_libjpeg, jdcolor's fixed
// point). Integer work, bit-exact against the plain torch versions in
// ops/jpeg_decode_kernels.py: int32 products that wrap, arithmetic right
// shifts, the same operations.
//
// jpeg_decode_rgb, the main path's kernel, does all of it in one launch:
// int16 natural-order block grids (B, bh, bw, 64) and q (B, 2, 64) in,
// (B, 3, out_h, out_w) u8 out, the resample kernel's input layout, zero
// outside the true rect; images i >= n (the batch's bucket padding) are
// the constant that zero coefficients decode to (128 inside the true
// rect). K3 jpeg_islow and K4 jpeg_upsample_rgb, its simple first form
// (one thread per block, then one thread per pixel with byte stores and
// the u8 planes through device memory), remain as a yardstick.
//
// What bounds it (chip_smoke.py decode_bound). Bytes: each coefficient
// of the true MCU grid of a real image read once (2 B), each output byte
// written once. Operations: 1,248 int32 operations per 8x8 block (16
// passes of 62, dequant, +128 and clamp) and 22-34 per pixel (upsample
// and colour). At 3.35 TB/s and 33.45 T int32 operations/s (64 INT32
// lanes per SM per clock, a multiply-add counted as two, 132 SMs, 1.98
// GHz): synth 4:2:0 512x512 at B=16 is 25.2 MB (7.5 us) and 0.265 G
// operations (7.9 us); lenna 4:4:4 at B=8 18.9 MB (5.6 us) and 0.169 G
// (5.0 us); 12 MP 4:2:0 at B=2 148 MB (44 us) and 1.52 G (45 us). Bytes
// and integer issue bound it about equally. Not the tensor cores: islow
// is butterflies on 16-bit operands with a rounding shift between the
// passes, so int8 IMMA would need split operands to stay exact, and the
// multiplies are a fifth of the operations.
//
// What the design does about it:
// - One CTA per tile of whole MCUs, TILE_W output pixels wide and
//   holding FANLIN_DEC_TILE_H chroma rows (both from ops/_build.py): 16 x
//   128 output pixels for 4:4:4, gray and 4:2:2, 32 x 128 for 4:2:0 and
//   4:4:0, one 16-pixel vector of the colour stage per thread (128 or 256
//   threads). The shorter tile puts twice the CTAs on the card at small
//   batches; the layouts that halve chroma vertically keep the taller
//   one, so their halo rows stay under a fifth of the work (below). Only
//   tiles that meet the true rect of a real image decode; the others,
//   the bucket's padding and padded images, store their constant with
//   16 B vectors and never read their wire. Inside a tile, blocks wholly
//   outside the true rect (or the true chroma dims) are skipped.
// - Eight threads per 8x8 block: each loads one 16 B row of the block
//   (four blocks of a block row per warp: 512 contiguous bytes), the
//   next round's row is loaded before this round computes, dequantizes
//   it against q kept in registers, and writes it to a padded (9-word
//   pitch, conflict-free) shared transpose; each then runs one column
//   pass and one row pass in islow_pass's order. No 64-int array per
//   thread; samples stay in shared memory, never in HBM. The tile's job
//   list is worked out once, one entry per thread, into a shared table.
// - The chroma halo. The fancy upsample reads one chroma sample beyond
//   the tile's edge (clamped to the true chroma dims at the image's
//   edge). The tile recomputes just those samples: a row above / below
//   by one thread per block (eight edge column passes, out[0] or out[7]
//   only, each a dot product since a pass is linear before its rounding
//   shift, then one row pass; the corners ride on the rows), eight such
//   jobs to a slot of 8 threads; a column left / right by 8 threads
//   (eight column passes, eight edge row passes). An interior tile does
//   14.7 % more integer work than its own blocks for 4:2:0, 11.8 % for
//   4:4:0, 7.3 % for 4:2:2 and none for 4:4:4 and gray (chip_smoke.py
//   halo_share; 16-row 4:2:0 tiles would do 24.5 %): under the ~20 % at
//   which exchanging edges between the CTAs of a cluster would pay.
// - Colour and stores: each thread makes 16 consecutive pixels of one
//   output row from shared memory (8 or 16 B chroma loads), jdcolor in
//   registers, saturates and packs four bytes in two cvt.pack.sat, and
//   writes one 16 B store per plane; a warp writes whole 128 B lines. The vector
//   that crosses true_w is masked in registers; out_w is a multiple of
//   TILE_W.
// - One launch per batch instead of two: the wrapper's host enqueue
//   (ctypes argtypes set once at load) is paid once.

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

// ---------------------------------------------------------------------
// jpeg_decode_rgb: the whole decode in one tiled launch.

#if !defined(FANLIN_DEC_TILE_H) || !defined(FANLIN_DEC_TILE_W)
#error "build with the -DFANLIN_DEC_* flags of ops/_build.py"
#endif

// Every tile holds kChromaRows chroma rows: 4:4:4, gray and 4:2:2 tiles
// are that many output rows high, 4:2:0 and 4:4:0 tiles twice as many.
constexpr int kChromaRows = FANLIN_DEC_TILE_H;
constexpr int kTileW = FANLIN_DEC_TILE_W;  // output columns per CTA
constexpr int kCPad = 16;  // chroma row: 16 pad | tile | 16 pad
constexpr int kCPitch = kTileW + 2 * kCPad;
constexpr int kCRows = kChromaRows + 2;  // one halo row above and below
constexpr int kWsPitch = 9;  // transpose pitch in words (no conflicts)
static_assert(kChromaRows % 8 == 0 && kTileW % 16 == 0,
              "tiles hold whole MCUs of every layout");
static_assert(2 * kChromaRows * kTileW / 16 <= 1024, "block size");

// What a job makes of one 8x8 block: all of it, or only the column (0 or
// 7) or the row (0 or 7) a neighbour tile's upsample reads. Whole blocks
// and halo columns are jobs of 8 threads, one row of the block each; a
// halo row is a job of one thread.
enum JobKind { kFull = 0, kCol0, kCol7, kRow0, kRow7 };

// A tile's job slots, in this order: its luma blocks; per chroma plane its
// blocks and the halo columns left and right; then the halo rows above
// and below of both planes (with the corners when the layout also halves
// x), eight one-thread jobs to a slot.
template <int DV, int DH>
struct Tiling {
  static constexpr int kTileH = kChromaRows * DV;  // output rows per CTA
  // one 16-pixel vector of the colour stage per thread
  static constexpr int kThreads = kTileH * kTileW / 16;
  static constexpr int kGroups = kThreads / 8;  // 8 threads per block job
  static constexpr int kCTH = kChromaRows, kCTW = kTileW / DH;
  static constexpr int kYBW = kTileW / 8;
  static constexpr int kCBH = kCTH / 8, kCBW = kCTW / 8;
  static constexpr int kNY = (kTileH / 8) * kYBW;
  static constexpr int kNRow = DV == 2 ? kCBW + (DH == 2 ? 2 : 0) : 0;
  static constexpr int kNCol = DH == 2 ? kCBH : 0;
  static constexpr int kNPlane = kCBH * kCBW + 2 * kNCol;  // per plane
  static constexpr int kNGroupJobs = kNY + 2 * kNPlane;
  static constexpr int kNRowJobs = 2 * 2 * kNRow;  // both planes
  static constexpr int kNJobs = kNGroupJobs + (kNRowJobs + 7) / 8;  // slots
  static constexpr int kNEntries = kNGroupJobs + kNRowJobs;  // job table
};

__host__ __device__ constexpr int dv_of(int subsamp) {
  return (subsamp == 420 || subsamp == 440) ? 2 : 1;
}
__host__ __device__ constexpr int dh_of(int subsamp) {
  return (subsamp == 420 || subsamp == 422) ? 2 : 1;
}
template <int SUBSAMP>
using TilingOf = Tiling<dv_of(SUBSAMP), dh_of(SUBSAMP)>;

// Before its rounding shift an islow pass is linear in its inputs, and
// int32 sums and products wrap (arithmetic modulo 2^32), so its out[0] =
// e0 + o3 and out[7] = e0 - o3 are exactly these dot products: the even
// inputs' weights add in both, the odd inputs' are subtracted for out[7].
__device__ constexpr int kEdgeK[8] = {8192, 11363, 10703, 9633,
                                      8192, 6437,  4433,  2260};

// out[0] (last false) or out[7] of islow_pass<SHIFT> on s[0..7].
template <int SHIFT>
__device__ __forceinline__ int islow_edge(const int* s, bool last) {
  int even = 0, odd = 0;
#pragma unroll
  for (int u = 0; u < 8; u += 2) {
    even += kEdgeK[u] * s[u];
    odd += kEdgeK[u + 1] * s[u + 1];
  }
  constexpr int rnd = 1 << (SHIFT - 1);
  return ((last ? even - odd : even + odd) + rnd) >> SHIFT;
}

__device__ __forceinline__ uint32_t sample(int v) {
  return static_cast<uint32_t>(min(max(v + 128, 0), 255));
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

// Eight row-pass outputs as eight u8 samples (+128, saturated).
__device__ __forceinline__ uint2 pack8(const int* s) {
  return make_uint2(pack_sat4(s[0] + 128, s[1] + 128, s[2] + 128, s[3] + 128),
                    pack_sat4(s[4] + 128, s[5] + 128, s[6] + 128, s[7] + 128));
}

// Coefficient v of a natural-order row held as one int4 (little-endian:
// coefficient 2k is the low half of word k).
__device__ __forceinline__ int coef_at(const int4& row, int v) {
  const int w = (v >> 1) == 0 ? row.x
                : (v >> 1) == 1 ? row.y
                : (v >> 1) == 2 ? row.z : row.w;
  return (v & 1) ? (w >> 16) : static_cast<int16_t>(w & 0xFFFF);
}

// Row 0 (last false) or row 7 of a block by one thread: the eight edge
// column passes as dot products accumulated one coefficient row (one
// 16 B load) at a time, then one row pass. q: the natural-order table.
__device__ __forceinline__ uint2 halo_row(const int16_t* blk, const int* q,
                                          bool last) {
  int acc[8] = {};
#pragma unroll 1
  for (int u = 0; u < 8; ++u) {  // one row live at a time
    const int4 row = __ldg(reinterpret_cast<const int4*>(blk) + u);
    const int k = (last && (u & 1)) ? -kEdgeK[u] : kEdgeK[u];
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[v] += k * (coef_at(row, v) * q[u * 8 + v]);
  }
#pragma unroll
  for (int v = 0; v < 8; ++v)
    acc[v] = (acc[v] + (1 << (kPass1Shift - 1))) >> kPass1Shift;
  islow_pass<kPass2Shift>(acc, 1);
  return pack8(acc);
}

struct DecodeArgs {
  const int16_t* coef[3];  // (B, bh, bw, 64): y, cb, cr
  const int32_t* q;        // (B, 2, 64): luma, chroma
  uint8_t* out;            // (B, 3, out_h, out_w)
  int n;                   // images i >= n are the bucket's padding
  int ybh, ybw, cbh, cbw;
  int true_h, true_w, ch, cw;  // ch, cw: true chroma dims
  int out_h, out_w;
};

// One job of a tile: its block, or null when there is nothing to do.
struct __align__(16) Job {
  const int16_t* blk;  // the block's 64 coefficients
  int dst;             // shared offset of its (row 0, col 0); may be < 0
  short plane, kind;
};

// Entry e of a tile's job table: its group jobs in slot order, then its
// one-thread halo rows.
template <int DV, int DH>
__device__ __forceinline__ Job make_job(int e, const DecodeArgs& a, int b,
                                        int y0, int x0) {
  using T = Tiling<DV, DH>;
  Job job{nullptr, 0, 0, kFull};
  const int cy0 = y0 / DV, cx0 = x0 / DH;
  int gby, gbx;
  bool on;
  if (e < T::kNY) {
    gby = y0 / 8 + e / T::kYBW;
    gbx = x0 / 8 + e % T::kYBW;
    on = gby * 8 < a.true_h && gbx * 8 < a.true_w;
    job.dst = (gby * 8 - y0) * kTileW + gbx * 8 - x0;
  } else {
    if (e < T::kNGroupJobs) {
      int k = e - T::kNY;
      job.plane = k < T::kNPlane ? 1 : 2;
      k -= (job.plane - 1) * T::kNPlane;
      constexpr int kNC = T::kCBH * T::kCBW;
      if (k < kNC) {
        gby = cy0 / 8 + k / T::kCBW;
        gbx = cx0 / 8 + k % T::kCBW;
        on = true;
      } else {
        k -= kNC;
        const bool right = k >= T::kNCol;
        gby = cy0 / 8 + (right ? k - T::kNCol : k);
        gbx = right ? cx0 / 8 + T::kCBW : cx0 / 8 - 1;
        job.kind = right ? kCol0 : kCol7;
        on = gbx >= 0;
      }
    } else {  // one thread's halo row
      int k = e - T::kNGroupJobs;
      job.plane = k < 2 * T::kNRow ? 1 : 2;
      k -= (job.plane - 1) * 2 * T::kNRow;
      const bool below = k >= T::kNRow;
      gbx = cx0 / 8 - (DH == 2 ? 1 : 0) + (below ? k - T::kNRow : k);
      gby = below ? cy0 / 8 + T::kCBH : cy0 / 8 - 1;
      job.kind = below ? kRow0 : kRow7;
      on = gbx >= 0 && (below ? cy0 + T::kCTH < a.ch : cy0 > 0);
    }
    // chroma blocks past the true chroma dims are never read
    on = on && gby * 8 < a.ch && gbx * 8 < a.cw;
    job.dst = (gby * 8 - cy0 + 1) * kCPitch + gbx * 8 - cx0 + kCPad;
  }
  if (on) {
    const int bh = job.plane ? a.cbh : a.ybh;
    const int bw = job.plane ? a.cbw : a.ybw;
    const int16_t* base = job.plane == 0 ? a.coef[0]
                          : (job.plane == 1 ? a.coef[1] : a.coef[2]);
    job.blk = base + ((static_cast<long long>(b) * bh + gby) * bw + gbx) * 64;
  }
  return job;
}

// The job of thread j of a group in slot `slot`: the slot's group job, or
// the j-th halo row of a slot past them.
template <int DV, int DH>
__device__ __forceinline__ Job slot_job(const Job* table, int slot, int j) {
  using T = Tiling<DV, DH>;
  if (slot < T::kNGroupJobs) return table[slot];
  const int k = (slot - T::kNGroupJobs) * 8 + j;
  return k < T::kNRowJobs ? table[T::kNGroupJobs + k]
                          : Job{nullptr, 0, 0, kFull};
}

__device__ __forceinline__ int byte_at(const uint32_t* w, int k) {
  return static_cast<int>((w[k >> 2] >> (8 * (k & 3))) & 0xFF);
}

// The upsampled chroma of the 16 output pixels (y, x .. x + 15) of one
// plane, from a tile's shared chroma plane, whose (r + 1, c + kCPad)
// holds chroma sample (cy0 + r, cx0 + c). The formulas and clamps are
// chroma_at's: rows clamped once for the vector, columns per pixel at the
// true chroma width; samples come in as 8 or 16 B loads.
template <int SUBSAMP>
__device__ __forceinline__ void chroma16(const uint8_t* c, int cy0, int cx0,
                                         int ch, int cw, int y, int x,
                                         int (&out)[16]) {
  constexpr bool kHalfY = SUBSAMP == 420 || SUBSAMP == 440;
  const int cy = kHalfY ? y >> 1 : y;
  const int ny = (y & 1) ? min(cy + 1, ch - 1) : max(cy - 1, 0);
  if (SUBSAMP == 444 || SUBSAMP == 440) {
    const uint8_t* near = c + (cy - cy0 + 1) * kCPitch + x - cx0 + kCPad;
    const uint4 nv = *reinterpret_cast<const uint4*>(near);
    const uint32_t nw[4] = {nv.x, nv.y, nv.z, nv.w};
    if (SUBSAMP == 444) {
#pragma unroll
      for (int k = 0; k < 16; ++k) out[k] = byte_at(nw, k);
      return;
    }
    const uint4 fv =
        *reinterpret_cast<const uint4*>(near + (ny - cy) * kCPitch);
    const uint32_t fw[4] = {fv.x, fv.y, fv.z, fv.w};
    const int bias = (y & 1) ? 2 : 1;  // v2h1
#pragma unroll
    for (int k = 0; k < 16; ++k)
      out[k] = (3 * byte_at(nw, k) + byte_at(fw, k) + bias) >> 2;
    return;
  }
  // 4:2:0 and 4:2:2: chroma columns cxs .. cxs + 7 and one beyond each
  // side; col[k + 1] is column cxs + k (a column sum for 4:2:0)
  const int cxs = x >> 1;
  const uint8_t* near = c + (cy - cy0 + 1) * kCPitch + cxs - cx0 + kCPad;
  const uint2 nv = *reinterpret_cast<const uint2*>(near);
  const uint32_t nw[2] = {nv.x, nv.y};
  int col[10];
  if (SUBSAMP == 422) {
#pragma unroll
    for (int k = 0; k < 8; ++k) col[k + 1] = byte_at(nw, k);
    col[0] = near[-1];
    col[9] = near[8];
  } else {
    const uint8_t* far = near + (ny - cy) * kCPitch;
    const uint2 fv = *reinterpret_cast<const uint2*>(far);
    const uint32_t fw[2] = {fv.x, fv.y};
#pragma unroll
    for (int k = 0; k < 8; ++k)
      col[k + 1] = 3 * byte_at(nw, k) + byte_at(fw, k);
    col[0] = 3 * near[-1] + far[-1];
    col[9] = 3 * near[8] + far[8];
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int self = col[k + 1];
    const int left = (k > 0 || cxs > 0) ? col[k] : self;
    const int right = cxs + k + 1 <= cw - 1 ? col[k + 2] : self;
    if (SUBSAMP == 420) {  // h2v2
      out[2 * k] = (3 * self + left + 8) >> 4;
      out[2 * k + 1] = (3 * self + right + 7) >> 4;
    } else {  // h2v1
      out[2 * k] = (3 * self + left + 1) >> 2;
      out[2 * k + 1] = (3 * self + right + 2) >> 2;
    }
  }
}

// At most 64 registers per thread: 65,536 per SM hold 1024 / kThreads
// CTAs.
template <int SUBSAMP>
__global__ void __launch_bounds__(TilingOf<SUBSAMP>::kThreads,
                                  1024 / TilingOf<SUBSAMP>::kThreads)
    decode_rgb_kernel(DecodeArgs a) {
  constexpr int DV = dv_of(SUBSAMP), DH = dh_of(SUBSAMP);
  using T = TilingOf<SUBSAMP>;
  constexpr int kTileH = T::kTileH, kGroups = T::kGroups;
  __shared__ __align__(16) uint8_t s_y[kTileH * kTileW];
  __shared__ __align__(16) uint8_t s_c[2][kCRows * kCPitch];
  __shared__ __align__(16) int s_q[128];
  __shared__ int s_ws[kGroups][8 * kWsPitch];
  __shared__ Job s_jobs[T::kNEntries];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const int cy0 = y0 / DV, cx0 = x0 / DH;
  // uniform over the CTA: only tiles that meet the true rect of a real
  // image decode anything
  const bool decode = b < a.n && y0 < a.true_h && x0 < a.true_w;
  if (decode) {
    if (tid < 32)
      reinterpret_cast<int4*>(s_q)[tid] =
          __ldg(reinterpret_cast<const int4*>(a.q + b * 128) + tid);
    // the tile's job table, one entry per thread
    for (int e = tid; e < T::kNEntries; e += T::kThreads)
      s_jobs[e] = make_job<DV, DH>(e, a, b, y0, x0);
    __syncthreads();
    const int g = tid >> 3, j = tid & 7;
    int* ws = s_ws[g];
    int ql[8], qc[8];  // row j of the luma and chroma tables
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      ql[v] = s_q[j * 8 + v];
      qc[v] = s_q[64 + j * 8 + v];
    }
    constexpr int kRounds = (T::kNJobs + kGroups - 1) / kGroups;
    const int4 kZero = make_int4(0, 0, 0, 0);
    Job job = slot_job<DV, DH>(s_jobs, g, j);
    int4 raw = job.blk && job.kind < kRow0
                   ? __ldg(reinterpret_cast<const int4*>(job.blk + j * 8))
                   : kZero;
    for (int r = 0; r < kRounds; ++r) {
      // the next round's row is in flight while this one computes
      const Job next = slot_job<DV, DH>(s_jobs, g + (r + 1) * kGroups, j);
      const int4 nraw =
          next.blk && next.kind < kRow0
              ? __ldg(reinterpret_cast<const int4*>(next.blk + j * 8))
              : kZero;
      const bool group = job.blk && job.kind < kRow0;
      int s[8];
      if (group) {  // dequantize row j into the transpose
#pragma unroll
        for (int v = 0; v < 8; ++v)
          ws[j * kWsPitch + v] = coef_at(raw, v) * (job.plane ? qc[v] : ql[v]);
      } else if (job.blk) {  // a halo row, by this thread alone
        const bool last = job.kind == kRow7;
        *reinterpret_cast<uint2*>(
            s_c[job.plane - 1] + (job.dst + (last ? 7 : 0) * kCPitch)) =
            halo_row(job.blk, s_q + 64, last);
      }
      __syncwarp();
      if (group) {  // column pass on column j
#pragma unroll
        for (int u = 0; u < 8; ++u) s[u] = ws[u * kWsPitch + j];
        islow_pass<kPass1Shift>(s, 1);
#pragma unroll
        for (int u = 0; u < 8; ++u) ws[u * kWsPitch + j] = s[u];
      }
      __syncwarp();
      if (group) {  // row pass on row j, into the tile's samples
        uint8_t* const tile = job.plane == 0 ? s_y : s_c[job.plane - 1];
        const int pitch = job.plane ? kCPitch : kTileW;
#pragma unroll
        for (int v = 0; v < 8; ++v) s[v] = ws[j * kWsPitch + v];
        if (job.kind == kFull) {
          islow_pass<kPass2Shift>(s, 1);
          *reinterpret_cast<uint2*>(tile + (job.dst + j * pitch)) = pack8(s);
        } else {  // a halo column: column 0 or 7 of the block
          const bool last = job.kind == kCol7;
          tile[job.dst + j * pitch + (last ? 7 : 0)] = static_cast<uint8_t>(
              sample(islow_edge<kPass2Shift>(s, last)));
        }
      }
      __syncwarp();
      job = next;
      raw = nraw;
    }
    __syncthreads();
  }

  // colour: 16 consecutive pixels of one output row, one 16 B store per
  // plane
  constexpr int kVecs = kTileW / 16;
  const long long plane = static_cast<long long>(a.out_h) * a.out_w;
  {
    const int ly = tid / kVecs, lx = (tid % kVecs) * 16;
    const int y = y0 + ly, x = x0 + lx;
    if (y >= a.out_h) return;
    uint32_t w[3][4] = {};
    if (!decode || y >= a.true_h || x >= a.true_w) {
      // zero coefficients decode to Y = Cb = Cr = 128 -> r = g = b = 128
      const uint32_t v = (b >= a.n && y < a.true_h) ? 128u : 0u;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const uint32_t byte = x + k < a.true_w ? v << (8 * (k & 3)) : 0u;
        w[0][k >> 2] |= byte;
        w[1][k >> 2] |= byte;
        w[2][k >> 2] |= byte;
      }
    } else {
      const uint4 yv =
          *reinterpret_cast<const uint4*>(s_y + ly * kTileW + lx);
      const uint32_t yw[4] = {yv.x, yv.y, yv.z, yv.w};
      int cb[16], cr[16];
      chroma16<SUBSAMP>(s_c[0], cy0, cx0, a.ch, a.cw, y, x, cb);
      chroma16<SUBSAMP>(s_c[1], cy0, cx0, a.ch, a.cw, y, x, cr);
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // four pixels, then one pack per plane
        int r[4], g[4], bl[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int k = 4 * i + t;
          const int yy = byte_at(yw, k);
          const int cbz = cb[k] - 128, crz = cr[k] - 128;
          r[t] = yy + ((91881 * crz + 32768) >> 16);
          bl[t] = yy + ((116130 * cbz + 32768) >> 16);
          g[t] = yy + ((-22554 * cbz + 32768 - 46802 * crz) >> 16);
        }
        w[0][i] = pack_sat4(r[0], r[1], r[2], r[3]);
        w[1][i] = pack_sat4(g[0], g[1], g[2], g[3]);
        w[2][i] = pack_sat4(bl[0], bl[1], bl[2], bl[3]);
      }
      if (x + 16 > a.true_w) {  // the vector that crosses true_w
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int keep = min(max(a.true_w - x - 4 * i, 0), 4);
          const uint32_t m = keep == 4 ? ~0u : (1u << (8 * keep)) - 1u;
          w[0][i] &= m;
          w[1][i] &= m;
          w[2][i] &= m;
        }
      }
    }
    uint8_t* o = a.out + static_cast<long long>(b) * 3 * plane +
                 static_cast<long long>(y) * a.out_w + x;
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint4*>(o + p * plane) =
          make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
  }
}

template <int SUBSAMP>
void launch_decode_rgb(const DecodeArgs& a, int batch, cudaStream_t s) {
  using T = TilingOf<SUBSAMP>;
  const dim3 grid(a.out_w / kTileW, (a.out_h + T::kTileH - 1) / T::kTileH,
                  batch);
  decode_rgb_kernel<SUBSAMP><<<grid, T::kThreads, 0, s>>>(a);
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
  const int dv = dv_of(subsamp);
  const int dh = dh_of(subsamp);
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

// The whole decode of a batch: y, cb, cr (B, bh, bw, 64) int16, 16-byte
// aligned; q (B, 2, 64) int32, 16-byte aligned; out (B, 3, out_h, out_w)
// u8, 16-byte aligned, out_w a multiple of tile_w. Images i >= n are
// padding and their wire is never read. tile_h, tile_w must be the tile
// compiled in for the layout. Returns a CUDA error code (0 on success).
extern "C" int fanlin_jpeg_decode_rgb(const int16_t* coef_y,
                                      const int16_t* coef_cb,
                                      const int16_t* coef_cr, const int32_t* q,
                                      uint8_t* out, int batch, int n, int ybh,
                                      int ybw, int cbh, int cbw, int subsamp,
                                      int true_h, int true_w, int out_h,
                                      int out_w, int tile_h, int tile_w,
                                      void* stream) {
  const int dv = dv_of(subsamp);
  const int dh = dh_of(subsamp);
  DecodeArgs a{{coef_y, coef_cb, coef_cr}, q, out, n, ybh, ybw, cbh, cbw,
               true_h, true_w, (true_h + dv - 1) / dv, (true_w + dh - 1) / dh,
               out_h, out_w};
  if (tile_h != kChromaRows * dv || tile_w != kTileW || batch <= 0 ||
      batch > 65535 || n < 0 || n > batch || true_h <= 0 || true_w <= 0 ||
      true_h > out_h || true_w > out_w || out_w % kTileW ||
      (out_h + tile_h - 1) / tile_h > 65535 || 8 * ybh < true_h ||
      8 * ybw < true_w || 8 * cbh < a.ch || 8 * cbw < a.cw)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (subsamp) {
    case 420: launch_decode_rgb<420>(a, batch, s); break;
    case 422: launch_decode_rgb<422>(a, batch, s); break;
    case 440: launch_decode_rgb<440>(a, batch, s); break;
    case 444: launch_decode_rgb<444>(a, batch, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
