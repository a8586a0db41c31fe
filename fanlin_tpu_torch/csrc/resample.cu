// Uniform-batch resample chain for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernels fanlin_tpu/ops/pallas_kernels.py::
// _resample_kernel (K1) and ::_resample_blur_kernel (K2), body
// _kernel_body. Per image b and channel c of an opaque (3-channel) batch
// that shares ONE matrix set:
//
//   P = u8 plane -> f32; Rec.709 fixed-point luma floor((2126r + 7152g
//       + 722b) / 10000) when gray, else 255 - p when invert (gray wins)
//   F = floor(clip(Av @ P @ Ah^T, 0, 255) + 0.5), then the fill colour
//       outside the fg box when use_canvas
//   blur variant: F = floor(clip(Bv @ F @ Bh^T, 0, 255) + 0.5)
//   u8 store of the store_h x store_w rect
//
// The fast form (`tpu.fast`, the reference's bf16 resample products,
// fanlin_tpu/ops/fused.py:186-194, :343-349) computes
// bf16(Av) @ P, then bf16(Ah) @ bf16(T): each weight and the
// intermediate T rounded to bf16 (round to nearest even) and the
// products accumulated in f32, vertical pass first as in the
// reference. The blur pair stays full f32 (the split below), as the
// reference's _post_resample does.
//
// What bounds it. The weights are banded: a Lanczos3 row of Av/Ah has
// ~6*scale non-zeros, a Gaussian row of Bv/Bh ~6*sigma, out of SH/SW.
// Dense, a pass multiplies zeros: 191.7 GFLOP at 12 MP (3072x4096 ->
// 896x1280, B=2), 11.3 at the README shape (512x512 -> 256x384, B=16).
// Walking only each output tile's band leaves 13.3 and 2.6 GFLOP. With
// the split below that is ~28 and ~6 GFLOP of TF32 tensor-core work.
// The memory floor is the source (75.5 MB at 12 MP, 12.6 MB README),
// the f32 intermediate T written and read back (2 x 88 MB; 2 x 25 MB)
// and the output: ~0.08 ms and ~0.02 ms at 3.35 TB/s. The kernel runs
// well above that floor: at 12 MP pass 1 takes ~80 % of the time,
// bound by fetching its Av tile from L2 again for each of the 128
// column tiles (~700 MB per call) and by the instructions around each
// MMA (shared loads, the split's conversions, the pixel mask). At the
// README shape with B=1 the device work is ~0.017 ms and the launch
// and host side dominate.
//
// What the design does about it:
// - Banded contraction. The host computes, per output tile of each
//   weight matrix's row dimension, the union [k_lo, k_hi) of its
//   non-zero columns rounded outward to the K slice
//   (ops/resample_kernels.py::tile_k_ranges). Passes 1 and 3 walk the
//   range of their M tile (rows of Av, Bv), passes 2 and 4 that of their
//   N tile (rows of Ah, Bh). Every skipped term multiplies a weight that
//   is exactly 0, so the result is the dense one. A tile with an empty
//   range skips the mainloop and still runs its epilogue.
// - An async ring. Each block streams BK-deep K slices of both operands
//   through a STAGES-deep ring in dynamic shared memory with cp.async
//   (16 B per thread, zero-filled past the matrix edge), so the next
//   slices load while the current one computes. The pixel operand is
//   loaded as u8 (all three planes for gray) and masked on the way into
//   the MMA fragment. Every global load is a contiguous 16 B run; Ah/Bh
//   (OW x SW, row-major) are already the "N x K, K contiguous" operand
//   the MMA wants. Shared-memory pitches are padded so that every
//   fragment read is free of bank conflicts.
// - Tensor cores with split TF32, mma.sync.m16n8k8 (f32 accumulate).
//   Plain TF32 (10 mantissa bits) moves too many outputs across a .5
//   rounding boundary, so each f32 operand x is split with
//   cvt.rna.tf32.f32 into hi = tf32(x) and lo = tf32(x - hi). Pass 1
//   makes 2 products, Av_hi*P + Av_lo*P: its pixel operand holds the
//   integers 0..255, exact in TF32. Passes 2-4 make 3 (hi*hi + hi*lo +
//   lo*hi). mma.sync rather than wgmma: TF32 wgmma wants both operands
//   K-major in shared memory, but pass 1's pixels and pass 3's F are
//   N-major, and the per-fragment split and mask would have to be
//   written back to shared memory first; mma.sync splits and masks in
//   registers. A persistent, warp-specialised TMA/wgmma form is later
//   work.
// - Tiles: BM x BN = 64 x 32 outputs per 128-thread block (4 warps of
//   32 x 16), BK = 32. 64-row tiles keep the bands narrow (128-row
//   tiles would nearly double the 12 MP work); 32-column tiles put 192
//   and 144 blocks on the 132 SMs at the README shape with B=1. The
//   tile sizes come from ops/_build.py (-D flags) and the C entry
//   refuses ranges computed for other sizes.
// - The grid covers (N tiles, M tiles, 3*B image-planes); the two
//   products of each chain are separate launches with the intermediate
//   in scratch the caller allocates. The last pass stores only the
//   rect the caller asks for; blur runs over the padded intermediate
//   like the TPU kernel.
//
// The fast form rounds each f32 operand of passes 1-2 in registers,
// where the split form splits it: to bf16 (__float2bfloat16_rn), then
// back to f32 bits. A bf16 value is exact in TF32 and the product of two
// 8-bit mantissas is exact in f32, so ONE m16n8k8 TF32 product per
// fragment pair gives the reference's bf16 products with f32
// accumulation. Rounding T as pass 2 loads it equals rounding it at
// pass 1's store; pass 1's pixel operand (integers 0..255) is exact and
// not rounded. A native m16n8k16 bf16 or wgmma form with T stored as
// bf16 is later work: K1 runs far from its tensor-core rate.
//
// Numerics: built WITHOUT --use_fast_math. The luma floor is taken in
// integers, which equals the f32 floor((...) / 10000) the reference
// computes. The split products drop only lo*lo (~2^-22 relative) and sum
// in another order than cuBLAS and XLA, so a value at a .5 rounding
// boundary may flip by 1 LSB.
//
// The launch uses the caller's stream, does not synchronise and
// allocates nothing. The C entry returns a cudaError_t (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(FANLIN_TILE_M) || !defined(FANLIN_TILE_N) || !defined(FANLIN_K_SLICE)
#error "build through fanlin_tpu_torch/ops/_build.py: it passes the tile sizes"
#endif

namespace {

constexpr int BM = FANLIN_TILE_M;  // output rows per block
constexpr int BN = FANLIN_TILE_N;  // output cols per block
constexpr int BK = FANLIN_K_SLICE;  // contraction slice
constexpr int STAGES = 4;           // slices in flight
constexpr int NT = 128;             // 4 warps, 2 x 2
constexpr int WM = BM / 2;          // warp tile rows
constexpr int WN = BN / 2;          // warp tile cols
constexpr int MI = WM / 16;         // m16 fragments per warp
constexpr int NI = WN / 8;          // n8 fragments per warp
// BN % 16: pixel rows load in 16-byte runs
static_assert(BM % 32 == 0 && BN % 16 == 0 && BK % 8 == 0, "tile shape");

// Shared-memory pitches, in elements. A fragment read has lanes
// (g, t) = (lane / 4, lane % 4) at (row g, col t) of an [m][k] or [n][k]
// tile, or (row t, col g) of a [k][n] tile; the pads spread them over
// the 32 banks.
constexpr int A_PITCH = BK + 4;   // f32 [m][k]: bank 4g + t
constexpr int BT_PITCH = BK + 4;  // f32 [n][k]
constexpr int BR_PITCH = BN + 8;  // f32 [k][n]: bank 8t + g
constexpr int BP_PITCH = BN + 16;  // u8 [plane][k][n]: word 12t + g/4

constexpr int A_BYTES = BM * A_PITCH * 4;
constexpr int max3(int a, int b, int c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}
constexpr int B_BYTES =
    max3(BN * BT_PITCH * 4, BK * BR_PITCH * 4, 3 * BK * BP_PITCH);
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
static_assert(A_BYTES % 16 == 0 && STAGE_BYTES % 16 == 0, "16 B stages");
static_assert((BP_PITCH * BK) % 16 == 0, "16 B pixel planes");

// How the B operand (K x N) is read.
enum BMode {
  B_ROW = 0,    // f32, B(k, n) = B[k * ldb + n]
  B_TRANS = 1,  // f32, B(k, n) = B[n * ldb + k]   (a weight matrix's transpose)
  B_PIXEL = 2,  // u8 planes of image z / 3, channel z % 3, masked
};

// What the epilogue does with the f32 sum.
enum Epi {
  E_F32 = 0,          // store the raw sum (f32 scratch)
  E_COMPOSE_F32 = 1,  // round + canvas composite, f32 scratch (blur input)
  E_COMPOSE_U8 = 2,   // round + canvas composite, u8 output
  E_ROUND_U8 = 3,     // round, u8 output (after blur)
};

struct Args {
  int M, N, K;
  const float* A; long long a_z; int lda;  // A(m, k) = A[z*a_z + m*lda + k]
  const float* B; long long b_z; int ldb;  // see BMode; ldb is also the pixel row stride
  const uint8_t* X; long long plane;       // B_PIXEL: SH * SW bytes per plane
  void* C; long long c_z; int ldc;         // C(m, n) = C[z*c_z + m*ldc + n]
  const int* band;    // [k_lo, k_hi) per M tile (B_ROW, B_PIXEL) or N tile (B_TRANS)
  int store_h, store_w;                    // u8 epilogues store only this rect
  const float* flags;                      // (B, 3) [gray, invert, use_canvas]
  const float* fill;                       // (B, 3)
  const int* box;                          // (B, 4) [x0, y0, fw, fh]
};

__device__ __forceinline__ float round_u8(float t) {
  return floorf(fminf(fmaxf(t, 0.f), 255.f) + 0.5f);
}

// 16-byte async copy global -> shared; src_bytes 0 zero-fills dst.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
// x rounded to bf16 (nearest even), as f32 bits: exact in TF32
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)))
         << 16;
}

// d += a * b, m16n8k8, TF32 in, f32 accumulate.
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BMODE>
__device__ __forceinline__ void load_slice(const Args& p, unsigned char* st,
                                           int z, int m0, int n0, int k0,
                                           bool gray) {
  const int tid = threadIdx.x;
  const float* A = p.A + z * p.a_z;
  float* As = reinterpret_cast<float*>(st);
  for (int c = tid; c < BM * BK / 4; c += NT) {
    const int m = c / (BK / 4), k = (c % (BK / 4)) * 4;
    const int gm = m0 + m, gk = k0 + k;
    const bool ok = gm < p.M && gk < p.K;
    cp_async16(As + m * A_PITCH + k, ok ? A + (long long)gm * p.lda + gk : A,
               ok ? 16 : 0);
  }
  unsigned char* bs = st + A_BYTES;
  if (BMODE == B_TRANS) {
    const float* B = p.B + z * p.b_z;
    float* Bs = reinterpret_cast<float*>(bs);
    for (int c = tid; c < BN * BK / 4; c += NT) {
      const int n = c / (BK / 4), k = (c % (BK / 4)) * 4;
      const int gn = n0 + n, gk = k0 + k;
      const bool ok = gn < p.N && gk < p.K;
      cp_async16(Bs + n * BT_PITCH + k,
                 ok ? B + (long long)gn * p.ldb + gk : B, ok ? 16 : 0);
    }
  } else if (BMODE == B_ROW) {
    const float* B = p.B + z * p.b_z;
    float* Bs = reinterpret_cast<float*>(bs);
    for (int c = tid; c < BK * BN / 4; c += NT) {
      const int k = c / (BN / 4), n = (c % (BN / 4)) * 4;
      const int gn = n0 + n, gk = k0 + k;
      const bool ok = gn < p.N && gk < p.K;
      cp_async16(Bs + k * BR_PITCH + n,
                 ok ? B + (long long)gk * p.ldb + gn : B, ok ? 16 : 0);
    }
  } else {
    // gray reads r, g and b into planes 0-2; otherwise the block's own
    // channel into plane 0
    const int img = z / 3, ch = z % 3;
    const uint8_t* X = p.X + (long long)img * 3 * p.plane;
    constexpr int RUNS = BK * BN / 16;  // 16-byte runs per plane
    const int nruns = gray ? 3 * RUNS : RUNS;
    for (int c = tid; c < nruns; c += NT) {
      const int pl = c / RUNS, r = c % RUNS;
      const int k = r / (BN / 16), n = (r % (BN / 16)) * 16;
      const int gn = n0 + n, gk = k0 + k;
      const bool ok = gn < p.N && gk < p.K;
      const uint8_t* src =
          X + (gray ? pl : ch) * p.plane + (long long)gk * p.ldb + gn;
      cp_async16(bs + pl * BK * BP_PITCH + k * BP_PITCH + n, ok ? src : X,
                 ok ? 16 : 0);
    }
  }
}

// The masked pixel at (k, n) of a u8 slice, an integer 0..255.
__device__ __forceinline__ float pixel(const unsigned char* bs, int k, int n,
                                       bool gray, bool inv) {
  const int at = k * BP_PITCH + n;
  unsigned v;
  if (gray) {
    const unsigned r = bs[at], g = bs[BK * BP_PITCH + at],
                   b = bs[2 * BK * BP_PITCH + at];
    v = (2126u * r + 7152u * g + 722u * b) / 10000u;
  } else {
    v = bs[at];
  }
  if (inv) v = 255u - v;
  return static_cast<float>(v);
}

// FAST: the operands rounded to bf16, one product (passes 1-2 of the
// fast form); else split TF32
template <int BMODE, int EPI, bool FAST>
__global__ void __launch_bounds__(NT) gemm_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm0 = (warp / 2) * WM, wn0 = (warp % 2) * WN;
  const int z = blockIdx.z;
  const int img = z / 3;
  const int ch = z % 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  bool gray = false, inv = false;
  if (BMODE == B_PIXEL) {
    const float gf = p.flags[img * 3 + 0];
    gray = gf > 0.f;
    inv = (p.flags[img * 3 + 1] > 0.f) && (gf == 0.f);  // grayscale wins
  }

  // this tile's band of the contraction, aligned to BK by the host
  const int* band = p.band + 2 * (BMODE == B_TRANS ? blockIdx.x : blockIdx.y);
  const int k_lo = band[0];
  const int nk = band[1] > k_lo ? (band[1] - k_lo + BK - 1) / BK : 0;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_slice<BMODE>(p, smem + s * STAGE_BYTES, z, m0, n0,
                                  k_lo + s * BK, gray);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    // slice kt has landed for every thread, and slot (kt - 1) % STAGES,
    // which the next load overwrites, is no longer read
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < nk) load_slice<BMODE>(p, smem + (next % STAGES) * STAGE_BYTES,
                                     z, m0, n0, k_lo + next * BK, gray);
    cp_async_commit();

    const unsigned char* st = smem + (kt % STAGES) * STAGE_BYTES;
    const float* As = reinterpret_cast<const float*>(st);
    const unsigned char* bs = st + A_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ahi[MI][4], alo[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float* a = As + (wm0 + i * 16 + g) * A_PITCH + kk + t;
        const float ax[4] = {a[0], a[8 * A_PITCH], a[4], a[8 * A_PITCH + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (FAST) ahi[i][e] = bf16_bits(ax[e]);
          else split(ax[e], ahi[i][e], alo[i][e]);
        }
      }
      uint32_t bhi[NI][2], blo[NI][2];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = wn0 + j * 8 + g;
        if (BMODE == B_PIXEL) {
          // integers 0..255: exact in TF32 (and bf16), no lo part
          bhi[j][0] = __float_as_uint(pixel(bs, kk + t, n, gray, inv));
          bhi[j][1] = __float_as_uint(pixel(bs, kk + t + 4, n, gray, inv));
        } else {
          const float* b = reinterpret_cast<const float*>(bs);
          float bx[2];
          if (BMODE == B_TRANS) {
            bx[0] = b[n * BT_PITCH + kk + t];
            bx[1] = b[n * BT_PITCH + kk + t + 4];
          } else {
            bx[0] = b[(kk + t) * BR_PITCH + n];
            bx[1] = b[(kk + t + 4) * BR_PITCH + n];
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if constexpr (FAST) bhi[j][e] = bf16_bits(bx[e]);
            else split(bx[e], bhi[j][e], blo[j][e]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          if constexpr (FAST) {
            mma(acc[i][j], ahi[i], bhi[j]);
          } else {
            mma(acc[i][j], alo[i], bhi[j]);
            if (BMODE != B_PIXEL) mma(acc[i][j], ahi[i], blo[j]);
            mma(acc[i][j], ahi[i], bhi[j]);
          }
        }
    }
  }
  cp_async_wait<0>();

  bool canvas = false;
  int x0 = 0, y0 = 0, fw = 0, fh = 0;
  float fillc = 0.f;
  if (EPI == E_COMPOSE_F32 || EPI == E_COMPOSE_U8) {
    canvas = p.flags[img * 3 + 2] > 0.f;
    x0 = p.box[img * 4 + 0];
    y0 = p.box[img * 4 + 1];
    fw = p.box[img * 4 + 2];
    fh = p.box[img * 4 + 3];
    fillc = p.fill[img * 3 + ch];
  }
  // accumulator e of fragment (i, j): row g (+8 for e >= 2), col 2t + e % 2
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm0 + i * 16 + g + 8 * h;
        const int n = n0 + wn0 + j * 8 + 2 * t;
        const long long at = z * p.c_z + (long long)m * p.ldc + n;
        float v[2] = {acc[i][j][2 * h], acc[i][j][2 * h + 1]};
        if (EPI != E_F32) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = round_u8(v[e]);
            if (EPI != E_ROUND_U8) {
              const bool inrect = m >= y0 && m < y0 + fh && n + e >= x0 &&
                                  n + e < x0 + fw;
              if (canvas && !inrect) v[e] = fillc;
            }
          }
        }
        if (EPI == E_F32 || EPI == E_COMPOSE_F32) {
          // N is even (checked by the wrapper), so n < N covers n + 1
          if (m < p.M && n < p.N)
            *reinterpret_cast<float2*>(static_cast<float*>(p.C) + at) =
                make_float2(v[0], v[1]);
        } else if (m < p.store_h) {
          uint8_t* o = static_cast<uint8_t*>(p.C) + at;
          if (n < p.store_w) o[0] = static_cast<uint8_t>(v[0]);
          if (n + 1 < p.store_w) o[1] = static_cast<uint8_t>(v[1]);
        }
      }
}

template <int BMODE, int EPI, bool FAST = false>
cudaError_t launch(const Args& p, int planes, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<BMODE, EPI, FAST>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, planes);
  gemm_kernel<BMODE, EPI, FAST><<<grid, NT, SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

// The chain's launches; FAST selects the bf16 form of passes 1-2.
template <bool FAST>
cudaError_t run_chain(const uint8_t* x, const float* av, const float* ah,
                      const float* bv, const float* bh, const float* flags,
                      const float* fill, const int* box, const int* bands,
                      uint8_t* out, float* t_buf, float* g_buf, float* u_buf,
                      int batch, int sh, int sw, int oh, int ow, int store_h,
                      int store_w, cudaStream_t s) {
  const int planes = batch * 3;
  const int m_tiles = (oh + BM - 1) / BM, n_tiles = (ow + BN - 1) / BN;
  const int* band_av = bands;
  const int* band_ah = band_av + 2 * m_tiles;
  const int* band_bv = band_ah + 2 * n_tiles;
  const int* band_bh = band_bv + 2 * m_tiles;
  Args base = {};
  base.flags = flags;
  base.fill = fill;
  base.box = box;
  base.store_h = store_h;
  base.store_w = store_w;

  // pass 1: T = Av @ mask(P)   (M = OH, N = SW, K = SH)
  Args p = base;
  p.M = oh; p.N = sw; p.K = sh;
  p.A = av; p.a_z = 0; p.lda = sh;
  p.X = x; p.plane = (long long)sh * sw; p.ldb = sw;
  p.C = t_buf; p.c_z = (long long)oh * sw; p.ldc = sw;
  p.band = band_av;
  cudaError_t e = launch<B_PIXEL, E_F32, FAST>(p, planes, s);
  if (e != cudaSuccess) return e;

  // pass 2: F = T @ Ah^T, round, composite   (M = OH, N = OW, K = SW)
  p = base;
  p.M = oh; p.N = ow; p.K = sw;
  p.A = t_buf; p.a_z = (long long)oh * sw; p.lda = sw;
  p.B = ah; p.b_z = 0; p.ldb = sw;
  p.band = band_ah;
  if (bv == nullptr) {
    p.C = out; p.c_z = (long long)store_h * store_w; p.ldc = store_w;
    return launch<B_TRANS, E_COMPOSE_U8, FAST>(p, planes, s);
  }
  p.C = g_buf; p.c_z = (long long)oh * ow; p.ldc = ow;
  e = launch<B_TRANS, E_COMPOSE_F32, FAST>(p, planes, s);
  if (e != cudaSuccess) return e;

  // passes 3-4, the blur pair, split TF32 in both forms
  // pass 3: U = Bv @ F   (M = OH, N = OW, K = OH)
  p = base;
  p.M = oh; p.N = ow; p.K = oh;
  p.A = bv; p.a_z = 0; p.lda = oh;
  p.B = g_buf; p.b_z = (long long)oh * ow; p.ldb = ow;
  p.C = u_buf; p.c_z = (long long)oh * ow; p.ldc = ow;
  p.band = band_bv;
  e = launch<B_ROW, E_F32>(p, planes, s);
  if (e != cudaSuccess) return e;

  // pass 4: V = U @ Bh^T, round   (M = OH, N = OW, K = OW)
  p = base;
  p.M = oh; p.N = ow; p.K = ow;
  p.A = u_buf; p.a_z = (long long)oh * ow; p.lda = ow;
  p.B = bh; p.b_z = 0; p.ldb = ow;
  p.C = out; p.c_z = (long long)store_h * store_w; p.ldc = store_w;
  p.band = band_bh;
  return launch<B_TRANS, E_ROUND_U8>(p, planes, s);
}

}  // namespace

// x (B, 3, SH, SW) u8; av (OH, SH), ah (OW, SW) f32; bv (OH, OH) and
// bh (OW, OW) f32 or both null; flags/fill (B, 3) f32; box (B, 4) i32;
// bands: int32 [k_lo, k_hi) pairs for the ceil(OH/BM) row tiles of Av,
// the ceil(OW/BN) row tiles of Ah, then (blur only) those of Bv and Bh,
// computed for tile_m x tile_n tiles and k_slice-deep slices;
// out (B, 3, store_h, store_w) u8 with store_h <= OH, store_w <= OW.
// Scratch: t_buf (B*3, OH, SW) f32; g_buf and u_buf (B*3, OH, OW) f32,
// used only with blur. SH, OH and OW are multiples of 4, SW of 16, and
// every pointer is 16-byte aligned. fast != 0 runs the bf16 form.
// Returns a cudaError_t (0 = launched).
extern "C" int fanlin_resample_uniform(
    const uint8_t* x, const float* av, const float* ah, const float* bv,
    const float* bh, const float* flags, const float* fill, const int* box,
    const int* bands, uint8_t* out, float* t_buf, float* g_buf, float* u_buf,
    int batch, int sh, int sw, int oh, int ow, int store_h, int store_w,
    int tile_m, int tile_n, int k_slice, int fast, void* stream) {
  if (tile_m != BM || tile_n != BN || k_slice != BK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      fast ? run_chain<true>(x, av, ah, bv, bh, flags, fill, box, bands, out,
                             t_buf, g_buf, u_buf, batch, sh, sw, oh, ow,
                             store_h, store_w, s)
           : run_chain<false>(x, av, ah, bv, bh, flags, fill, box, bands, out,
                              t_buf, g_buf, u_buf, batch, sh, sw, oh, ow,
                              store_h, store_w, s);
  return static_cast<int>(e);
}
