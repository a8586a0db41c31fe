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
// rect).
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
//
// jpeg_decode_cmyk (K12a) is the same tile body for 4-component sources.
// It replaces jpeg_decode.py:364 decode_cmyk, the XLA prologue that
// fused.py:908 get_cmyk_coef_program runs before the sampled ICC LUT:
// four islow planes, K (comp3) at comp0's rate and on comp0's table, so
// a tile decodes its K blocks as a second luma-rate plane (jobs after the
// luma blocks, a second luma-sized shared buffer). It stores (B, 4,
// out_h, out_w) u8 in PIL's CMYK convention: plain CMYK (4:4:4) is
// 255 - sample on every plane; YCCK (4:4:4, or 4:2:0 with the same
// halo and upsample as jpeg_decode_rgb) is jdcolor's R G B for C M Y and
// 255 - k for K. Padded images store what zero coefficients decode to
// (127, or 128 128 128 127). Bound: chip_smoke.py cmyk_decode_bound.
// The serving path no longer launches it: it stays as the yardstick of
// the fused form below.
//
// jpeg_decode_cmyk_rgb, the CMYK coefficient route's kernel, is K12a and
// K12b (cmyk_lut.cu, cmyk_lut.py:63 lut_planes) in one launch: the
// colour stage makes each pixel's four CMYK bytes as K12a does (masked
// past true_w, the pad constants in a padded image's true rect) and
// evaluates the packed ICC LUT on them (cmyk_lut.cuh), so the (B, 4, H,
// W) CMYK planes never reach device memory; it stores (B, 3, out_h,
// out_w) RGB, bit-equal to K12b's plain version of K12a's plain version
// over the whole tensor, padding included. The LUT stage is staged: the
// tile's CMYK pixels go to shared memory, and after a barrier the whole
// CTA converts them, 4 consecutive pixels a thread, each pixel's four
// 16 B gathers in flight while the previous pixel accumulates. A tile
// that decodes nothing (past the true rect, padded images) holds
// constants: each vector of 16 evaluates the LUT twice, not 16 times.
// Bound (chip_smoke.py cmyk_rgb_bound): bytes, the 4-plane wire of the
// true MCU grid and 3 output bytes per pixel, against issue, K12a's int32
// operations plus the LUT's 146 f32 operations a pixel at 33.45 T
// thread-instructions/s (the two share the schedulers' dispatch); issue
// bounds it. The 4-component forms hold up to 128 registers (launch
// bounds).

#include <cuda_runtime.h>

#include <cstdint>

#include "cmyk_lut.cuh"

namespace {

using fanlin::pack_sat4;

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

// A tile's job slots, in this order: its luma blocks (and, with NL = 2,
// its K blocks, the fourth component at the luma rate); per chroma plane
// its blocks and the halo columns left and right; then the halo rows
// above and below of both planes (with the corners when the layout also
// halves x), eight one-thread jobs to a slot.
template <int DV, int DH, int NL = 1>
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
  static constexpr int kNGroupJobs = NL * kNY + 2 * kNPlane;
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
template <int SUBSAMP, int NL = 1>
using TilingOf = Tiling<dv_of(SUBSAMP), dh_of(SUBSAMP), NL>;

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
  const int16_t* coef[4];  // (B, bh, bw, 64): y, cb, cr; k (4 components)
  const int32_t* q;        // (B, 2, 64): luma (and K), chroma
  uint8_t* out;            // (B, 3 or 4, out_h, out_w)
  int n;                   // images i >= n are the bucket's padding
  int ybh, ybw, cbh, cbw;
  int true_h, true_w, ch, cw;  // ch, cw: true chroma dims
  int out_h, out_w;
  fanlin::PackedLut lut;  // jpeg_decode_cmyk_rgb's
};

// One job of a tile: its block, or null when there is nothing to do.
// plane: 0 y, 1 cb, 2 cr, 3 k.
struct __align__(16) Job {
  const int16_t* blk;  // the block's 64 coefficients
  int dst;             // shared offset of its (row 0, col 0); may be < 0
  short plane, kind;
};

// Entry e of a tile's job table: its group jobs in slot order, then its
// one-thread halo rows.
template <int DV, int DH, int NL>
__device__ __forceinline__ Job make_job(int e, const DecodeArgs& a, int b,
                                        int y0, int x0) {
  using T = Tiling<DV, DH, NL>;
  Job job{nullptr, 0, 0, kFull};
  const int cy0 = y0 / DV, cx0 = x0 / DH;
  int gby, gbx;
  bool on;
  if (e < NL * T::kNY) {  // a luma-rate block: y, then k
    const bool k_plane = e >= T::kNY;
    const int l = k_plane ? e - T::kNY : e;
    job.plane = k_plane ? 3 : 0;
    gby = y0 / 8 + l / T::kYBW;
    gbx = x0 / 8 + l % T::kYBW;
    on = gby * 8 < a.true_h && gbx * 8 < a.true_w;
    job.dst = (gby * 8 - y0) * kTileW + gbx * 8 - x0;
  } else {
    if (e < T::kNGroupJobs) {
      int k = e - NL * T::kNY;
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
    const bool chroma = job.plane == 1 || job.plane == 2;
    const int bh = chroma ? a.cbh : a.ybh;
    const int bw = chroma ? a.cbw : a.ybw;
    const int16_t* base = job.plane == 0   ? a.coef[0]
                          : job.plane == 1 ? a.coef[1]
                          : job.plane == 2 ? a.coef[2]
                                           : a.coef[3];
    job.blk = base + ((static_cast<long long>(b) * bh + gby) * bw + gbx) * 64;
  }
  return job;
}

// The job of thread j of a group in slot `slot`: the slot's group job, or
// the j-th halo row of a slot past them.
template <int DV, int DH, int NL>
__device__ __forceinline__ Job slot_job(const Job* table, int slot, int j) {
  using T = Tiling<DV, DH, NL>;
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

// What a tile stores: RGB (jpeg_decode_rgb); plain CMYK, each plane
// inverted (255 - sample, PIL's "CMYK;I"); YCCK, C M Y = jdcolor's R G B of
// (y, cb, cr) and K = 255 - k (jpeg_decode_cmyk); or either CMYK form
// converted through the packed ICC LUT to RGB (jpeg_decode_cmyk_rgb).
enum OutKind { kRgb = 0, kCmyk = 1, kYcck = 2, kCmykRgb = 3, kYcckRgb = 4 };

__host__ __device__ constexpr bool through_lut(int out) {
  return out == kCmykRgb || out == kYcckRgb;
}
// The CMYK form a kind makes before its LUT (the kind itself without one).
__host__ __device__ constexpr int cmyk_form(int out) {
  return through_lut(out) ? out - 2 : out;
}

// What zero coefficients decode to, per stored plane of a form (kRgb,
// kCmyk, kYcck): 128 samples give r = g = b = 128; inverted, 127.
__device__ __forceinline__ uint32_t pad_value(int form, int p) {
  return form == kRgb ? 128u : (form == kCmyk || p == 3) ? 127u : 128u;
}

// The R, G, B words of 16 pixels (x .. x + 15) whose CMYK is a constant:
// `inside` up to true_w, 0 past it. Two evaluations of the LUT.
__device__ __forceinline__ void lut_constant(uint32_t inside, int x,
                                             int true_w,
                                             const fanlin::PackedLut& lut,
                                             uint32_t (&w)[4][4]) {
  const uint32_t px[2] = {inside, 0u};
  int v[2][3];
  fanlin::lut_pixels(px, lut, [&](int j, int r, int g, int bl) {
    v[j][0] = min(max(r, 0), 255);
    v[j][1] = min(max(g, 0), 255);
    v[j][2] = min(max(bl, 0), 255);
  });
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[c][i] = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      w[c][k >> 2] |= static_cast<uint32_t>(v[x + k < true_w ? 0 : 1][c])
                      << (8 * (k & 3));
  }
}

// The body of the decode kernels, one CTA per tile. At most 64 registers
// per thread for RGB (65,536 per SM hold 1024 / kThreads CTAs), 128 for
// the four-component forms.
template <int SUBSAMP, int OUT>
__device__ __forceinline__ void decode_tile(const DecodeArgs& a) {
  constexpr int DV = dv_of(SUBSAMP), DH = dh_of(SUBSAMP);
  constexpr int FORM = cmyk_form(OUT);
  constexpr bool kLut = through_lut(OUT);
  constexpr int NL = OUT == kRgb ? 1 : 2;  // luma-rate planes
  constexpr int NP = OUT == kRgb ? 3 : 4;  // planes of the colour stage
  constexpr int NS = kLut ? 3 : NP;        // stored planes
  using T = TilingOf<SUBSAMP, NL>;
  constexpr int kTileH = T::kTileH, kGroups = T::kGroups;
  __shared__ __align__(16) uint8_t s_l[NL][kTileH * kTileW];  // y (, k)
  __shared__ __align__(16) uint8_t s_c[2][kCRows * kCPitch];
  __shared__ __align__(16) int s_q[128];
  __shared__ int s_ws[kGroups][8 * kWsPitch];
  __shared__ Job s_jobs[T::kNEntries];
  // the tile's CMYK pixels, for the LUT stage
  __shared__ __align__(16) uint32_t s_px[kLut ? kTileH * kTileW : 1];
  uint8_t* const s_y = s_l[0];
  uint8_t* const s_k = s_l[NL - 1];

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
      s_jobs[e] = make_job<DV, DH, NL>(e, a, b, y0, x0);
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
    Job job = slot_job<DV, DH, NL>(s_jobs, g, j);
    int4 raw = job.blk && job.kind < kRow0
                   ? __ldg(reinterpret_cast<const int4*>(job.blk + j * 8))
                   : kZero;
    for (int r = 0; r < kRounds; ++r) {
      // the next round's row is in flight while this one computes
      const Job next = slot_job<DV, DH, NL>(s_jobs, g + (r + 1) * kGroups, j);
      const int4 nraw =
          next.blk && next.kind < kRow0
              ? __ldg(reinterpret_cast<const int4*>(next.blk + j * 8))
              : kZero;
      const bool group = job.blk && job.kind < kRow0;
      const bool chroma = job.plane == 1 || job.plane == 2;
      int s[8];
      if (group) {  // dequantize row j into the transpose
#pragma unroll
        for (int v = 0; v < 8; ++v)
          ws[j * kWsPitch + v] = coef_at(raw, v) * (chroma ? qc[v] : ql[v]);
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
        uint8_t* const tile =
            chroma ? s_c[job.plane - 1] : (job.plane == 3 ? s_k : s_y);
        const int pitch = chroma ? kCPitch : kTileW;
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
  // stored plane
  constexpr int kVecs = kTileW / 16;
  const long long plane = static_cast<long long>(a.out_h) * a.out_w;
  const int ly = tid / kVecs, lx = (tid % kVecs) * 16;
  const int y = y0 + ly, x = x0 + lx;
  uint8_t* const o = a.out + static_cast<long long>(b) * NS * plane +
                     static_cast<long long>(y) * a.out_w + x;
  // the LUT stage needs every thread of a decoding tile at its barrier
  const bool barrier = kLut && decode;
  const bool live = y < a.out_h;
  if (!live && !barrier) return;
  uint32_t w[NP][4] = {};
  if (live && (!decode || y >= a.true_h || x >= a.true_w)) {
    // the constant of zero coefficients in a padded image's true rect
    const bool pad = b >= a.n && y < a.true_h;
    if constexpr (kLut) {
      uint32_t inside = 0;
#pragma unroll
      for (int p = 0; p < NP; ++p)
        inside |= (pad ? pad_value(FORM, p) : 0u) << (8 * p);
      if (!barrier) {
        uint32_t rgb[4][4];
        lut_constant(inside, x, a.true_w, a.lut, rgb);
#pragma unroll
        for (int p = 0; p < NS; ++p)
          *reinterpret_cast<uint4*>(o + p * plane) =
              make_uint4(rgb[p][0], rgb[p][1], rgb[p][2], rgb[p][3]);
        return;
      }
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const uint32_t v = pad ? pad_value(FORM, p) : 0u;
#pragma unroll
      for (int k = 0; k < 16; ++k)
        w[p][k >> 2] |= x + k < a.true_w ? v << (8 * (k & 3)) : 0u;
    }
  } else if (live) {
    const uint4 yv = *reinterpret_cast<const uint4*>(s_y + ly * kTileW + lx);
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
        if (FORM == kCmyk) {  // samples in [0, 255]: no saturation needed
          r[t] = 255 - yy;
          g[t] = 255 - cb[k];
          bl[t] = 255 - cr[k];
        } else {
          const int cbz = cb[k] - 128, crz = cr[k] - 128;
          r[t] = yy + ((91881 * crz + 32768) >> 16);
          bl[t] = yy + ((116130 * cbz + 32768) >> 16);
          g[t] = yy + ((-22554 * cbz + 32768 - 46802 * crz) >> 16);
        }
      }
      w[0][i] = pack_sat4(r[0], r[1], r[2], r[3]);
      w[1][i] = pack_sat4(g[0], g[1], g[2], g[3]);
      w[2][i] = pack_sat4(bl[0], bl[1], bl[2], bl[3]);
    }
    if constexpr (NP == 4) {  // K = 255 - k, bytewise (no borrows)
      const uint4 kv = *reinterpret_cast<const uint4*>(s_k + ly * kTileW + lx);
      w[NP - 1][0] = ~kv.x;
      w[NP - 1][1] = ~kv.y;
      w[NP - 1][2] = ~kv.z;
      w[NP - 1][3] = ~kv.w;
    }
    if (x + 16 > a.true_w) {  // the vector that crosses true_w
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int keep = min(max(a.true_w - x - 4 * i, 0), 4);
        const uint32_t m = keep == 4 ? ~0u : (1u << (8 * keep)) - 1u;
#pragma unroll
        for (int p = 0; p < NP; ++p) w[p][i] &= m;
      }
    }
  }
  if constexpr (kLut) {
    // stage the CMYK pixels, then 4 rounds of 4 consecutive pixels a
    // thread over the tile (kThreads * 16 pixels): a warp converts 128
    // pixels of one row and stores 128 B per plane
    if (live) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t t[4] = {w[0][i], w[1][i], w[2][i], w[3][i]};
        fanlin::transpose4(t);
        *reinterpret_cast<uint4*>(s_px + ly * kTileW + lx + 4 * i) =
            make_uint4(t[0], t[1], t[2], t[3]);
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int r = 0; r < 4; ++r) {
      const int q = (r * T::kThreads + tid) * 4;
      const int qy = y0 + q / kTileW, qx = x0 + q % kTileW;
      if (qy >= a.out_h) break;
      const uint4 v = *reinterpret_cast<const uint4*>(s_px + q);
      const uint32_t px[4] = {v.x, v.y, v.z, v.w};
      int rgb[3][4];
      fanlin::lut_pixels(px, a.lut, [&](int j, int vr, int vg, int vb) {
        rgb[0][j] = vr;
        rgb[1][j] = vg;
        rgb[2][j] = vb;
      });
      uint8_t* const d = a.out + static_cast<long long>(b) * NS * plane +
                         static_cast<long long>(qy) * a.out_w + qx;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        *reinterpret_cast<uint32_t*>(d + c * plane) =
            pack_sat4(rgb[c][0], rgb[c][1], rgb[c][2], rgb[c][3]);
    }
    return;
  }
#pragma unroll
  for (int p = 0; p < NS; ++p)
    *reinterpret_cast<uint4*>(o + p * plane) =
        make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
}

template <int SUBSAMP>
__global__ void __launch_bounds__(TilingOf<SUBSAMP>::kThreads,
                                  1024 / TilingOf<SUBSAMP>::kThreads)
    decode_rgb_kernel(DecodeArgs a) {
  decode_tile<SUBSAMP, kRgb>(a);
}

template <int SUBSAMP, int OUT>
__global__ void __launch_bounds__(TilingOf<SUBSAMP, 2>::kThreads,
                                  512 / TilingOf<SUBSAMP, 2>::kThreads)
    decode_cmyk_kernel(DecodeArgs a) {
  decode_tile<SUBSAMP, OUT>(a);
}

template <int SUBSAMP>
void launch_decode_rgb(const DecodeArgs& a, int batch, cudaStream_t s) {
  using T = TilingOf<SUBSAMP>;
  const dim3 grid(a.out_w / kTileW, (a.out_h + T::kTileH - 1) / T::kTileH,
                  batch);
  decode_rgb_kernel<SUBSAMP><<<grid, T::kThreads, 0, s>>>(a);
}

template <int SUBSAMP, int OUT>
__global__ void __launch_bounds__(TilingOf<SUBSAMP, 2>::kThreads,
                                  512 / TilingOf<SUBSAMP, 2>::kThreads)
    decode_cmyk_rgb_kernel(DecodeArgs a) {
  decode_tile<SUBSAMP, OUT>(a);
}

template <int SUBSAMP, int OUT>
void launch_decode_cmyk(const DecodeArgs& a, int batch, cudaStream_t s) {
  using T = TilingOf<SUBSAMP, 2>;
  const dim3 grid(a.out_w / kTileW, (a.out_h + T::kTileH - 1) / T::kTileH,
                  batch);
  if constexpr (through_lut(OUT))
    decode_cmyk_rgb_kernel<SUBSAMP, OUT><<<grid, T::kThreads, 0, s>>>(a);
  else
    decode_cmyk_kernel<SUBSAMP, OUT><<<grid, T::kThreads, 0, s>>>(a);
}

}  // namespace

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
  DecodeArgs a{{coef_y, coef_cb, coef_cr, nullptr}, q, out, n, ybh, ybw,
               cbh, cbw,
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

namespace {

int decode_cmyk_entry(const DecodeArgs& a, int batch, int subsamp, int ycck,
                      bool to_rgb, int tile_h, int tile_w, void* stream) {
  const int dv = dv_of(subsamp);
  if (!(subsamp == 444 || (subsamp == 420 && ycck)) ||
      tile_h != kChromaRows * dv || tile_w != kTileW || batch <= 0 ||
      batch > 65535 || a.n < 0 || a.n > batch || a.true_h <= 0 ||
      a.true_w <= 0 || a.true_h > a.out_h || a.true_w > a.out_w ||
      a.out_w % kTileW || (a.out_h + tile_h - 1) / tile_h > 65535 ||
      8 * a.ybh < a.true_h || 8 * a.ybw < a.true_w || 8 * a.cbh < a.ch ||
      8 * a.cbw < a.cw)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (subsamp == 420) {
    if (to_rgb) launch_decode_cmyk<420, kYcckRgb>(a, batch, s);
    else launch_decode_cmyk<420, kYcck>(a, batch, s);
  } else if (ycck) {
    if (to_rgb) launch_decode_cmyk<444, kYcckRgb>(a, batch, s);
    else launch_decode_cmyk<444, kYcck>(a, batch, s);
  } else {
    if (to_rgb) launch_decode_cmyk<444, kCmykRgb>(a, batch, s);
    else launch_decode_cmyk<444, kCmyk>(a, batch, s);
  }
  return static_cast<int>(cudaGetLastError());
}

DecodeArgs cmyk_args(const int16_t* coef_y, const int16_t* coef_cb,
                     const int16_t* coef_cr, const int16_t* coef_k,
                     const int32_t* q, uint8_t* out, int n, int ybh, int ybw,
                     int cbh, int cbw, int subsamp, int true_h, int true_w,
                     int out_h, int out_w) {
  const int dv = dv_of(subsamp);
  const int dh = dh_of(subsamp);
  return DecodeArgs{{coef_y, coef_cb, coef_cr, coef_k}, q, out, n, ybh, ybw,
                    cbh, cbw, true_h, true_w, (true_h + dv - 1) / dv,
                    (true_w + dh - 1) / dh, out_h, out_w};
}

}  // namespace

// K12a, the 4-component decode: y, cb, cr, k (B, bh, bw, 64) int16, k at
// y's grid, 16-byte aligned; q (B, 2, 64) int32 (comp0's and K's table,
// then the chroma table), 16-byte aligned; out (B, 4, out_h, out_w) u8
// in PIL's CMYK convention, 16-byte aligned, out_w a multiple of tile_w.
// subsamp 444 (plain CMYK or YCCK) or 420 (YCCK only); ycck 0 or 1. As
// fanlin_jpeg_decode_rgb otherwise. Returns a CUDA error code (0 on
// success).
extern "C" int fanlin_jpeg_decode_cmyk(
    const int16_t* coef_y, const int16_t* coef_cb, const int16_t* coef_cr,
    const int16_t* coef_k, const int32_t* q, uint8_t* out, int batch, int n,
    int ybh, int ybw, int cbh, int cbw, int subsamp, int ycck, int true_h,
    int true_w, int out_h, int out_w, int tile_h, int tile_w, void* stream) {
  return decode_cmyk_entry(
      cmyk_args(coef_y, coef_cb, coef_cr, coef_k, q, out, n, ybh, ybw, cbh,
                cbw, subsamp, true_h, true_w, out_h, out_w),
      batch, subsamp, ycck, false, tile_h, tile_w, stream);
}

// K12a and K12b in one launch: as fanlin_jpeg_decode_cmyk, but each
// pixel's CMYK goes through the LUT in the colour stage and out is (B, 3,
// out_h, out_w) u8 RGB. lut: pack_lut's (lut_n^4, 4) int32, 16-byte
// aligned; scale f32((lut_n - 1) / 255). Returns a CUDA error code (0 on
// success).
extern "C" int fanlin_jpeg_decode_cmyk_rgb(
    const int16_t* coef_y, const int16_t* coef_cb, const int16_t* coef_cr,
    const int16_t* coef_k, const int32_t* q, uint8_t* out, int batch, int n,
    int ybh, int ybw, int cbh, int cbw, int subsamp, int ycck, int true_h,
    int true_w, int out_h, int out_w, int tile_h, int tile_w,
    const int32_t* lut, int lut_n, float scale, void* stream) {
  if (lut_n < 2 || lut_n > 64 || reinterpret_cast<uintptr_t>(lut) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a = cmyk_args(coef_y, coef_cb, coef_cr, coef_k, q, out, n, ybh,
                           ybw, cbh, cbw, subsamp, true_h, true_w, out_h,
                           out_w);
  a.lut = fanlin::packed_lut(lut, lut_n, scale);
  return decode_cmyk_entry(a, batch, subsamp, ycck, true, tile_h, tile_w,
                           stream);
}
