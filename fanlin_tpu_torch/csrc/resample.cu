// Uniform-batch resample chain for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernels fanlin_tpu/ops/pallas_kernels.py::
// _resample_kernel and ::_resample_blur_kernel (body _kernel_body). Per
// image b and channel c of an opaque (3-channel) batch that shares ONE
// matrix set:
//
//   P = u8 plane -> f32; Rec.709 fixed-point luma floor((2126r + 7152g
//       + 722b) / 10000) when gray, else 255 - p when invert (gray wins)
//   F = floor(clip(Av @ P @ Ah^T, 0, 255) + 0.5), then the fill colour
//       outside the fg box when use_canvas
//   blur variant: F = floor(clip(Bv @ F @ Bh^T, 0, 255) + 0.5)
//   u8 store
//
// What bounds it on this card: the two products. At the README shapes
// (SH=SW=512 -> OH=256, OW=384) one image is ~0.70 GFLOP against ~1.1 MB
// of u8 traffic, far above the f32 ridge, so the kernel is bound by f32
// FMA throughput. A 12 MP source (SH=3072, SW=4096 -> OH=896, OW=1280)
// is ~96 GFLOP per image and its Ah alone is 21 MB: unlike the TPU's
// VMEM, shared memory (227 KB per block) cannot pin the weights.
//
// What the design does about it: every pass is one shared-memory tiled
// SGEMM on the CUDA cores (64x64 output tile per 256-thread block, 4x4
// outputs per thread, K streamed in 16-deep slices), so any matrix size
// works and each weight element is read once per output tile. The grid
// covers (N tiles, M tiles, 3*B image-planes). The mask and u8->f32
// conversion are fused into the load of P (luma needs r, g and b at the
// same offset), and clip/round/composite into the epilogue of the second
// pass. Intermediates live in scratch the caller allocates. The last pass
// stores only the rect the caller asks for (the true out_h x out_w of a
// uniform batch); blur runs over the padded intermediate like the TPU
// kernel. The weights are banded (a Lanczos3 row has ~6*scale non-zeros
// out of SH); exploiting that, and wgmma/TMA, is later work.
//
// Numerics: full f32, no TF32; built WITHOUT --use_fast_math so the luma
// division stays an IEEE division. Accumulation order differs from
// cuBLAS and XLA, so a value at a .5 rounding boundary may flip by 1 LSB.
//
// The launch uses the caller's stream, does not synchronise and
// allocates nothing. The C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output cols per block
constexpr int BK = 16;   // contraction slice
constexpr int NT = 256;  // threads per block: 16 x 16, 4 x 4 outputs each
constexpr int PAD = 4;   // smem row padding

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
  int store_h, store_w;                    // u8 epilogues store only this rect
  const float* flags;                      // (B, 3) [gray, invert, use_canvas]
  const float* fill;                       // (B, 3)
  const int* box;                          // (B, 4) [x0, y0, fw, fh]
};

__device__ __forceinline__ float round_u8(float t) {
  return floorf(fminf(fmaxf(t, 0.f), 255.f) + 0.5f);
}

template <int BMODE, int EPI>
__global__ void __launch_bounds__(NT) gemm_kernel(Args p) {
  __shared__ float As[BK][BM + PAD];
  __shared__ float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int z = blockIdx.z;
  const int img = z / 3;
  const int ch = z % 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const float* A = p.A + z * p.a_z;

  bool gray = false, inv = false;
  if (BMODE == B_PIXEL) {
    const float g = p.flags[img * 3 + 0];
    gray = g > 0.f;
    inv = (p.flags[img * 3 + 1] > 0.f) && (g == 0.f);  // grayscale wins
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = tid % BK;
      const int m = tid / BK + 16 * i;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < p.M && gk < p.K) ? A[(long long)gm * p.lda + gk] : 0.f;
    }
    if (BMODE == B_TRANS) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = tid % BK;
        const int n = tid / BK + 16 * i;
        const int gn = n0 + n, gk = k0 + k;
        Bs[k][n] = (gn < p.N && gk < p.K)
                       ? p.B[z * p.b_z + (long long)gn * p.ldb + gk]
                       : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = tid % BN;
        const int k = tid / BN + 4 * i;
        const int gn = n0 + n, gk = k0 + k;
        float v = 0.f;
        if (gn < p.N && gk < p.K) {
          if (BMODE == B_ROW) {
            v = p.B[z * p.b_z + (long long)gk * p.ldb + gn];
          } else {
            const uint8_t* px =
                p.X + (long long)img * 3 * p.plane + (long long)gk * p.ldb + gn;
            if (gray) {
              const float r = px[0];
              const float g = px[p.plane];
              const float b = px[2 * p.plane];
              v = floorf((2126.f * r + 7152.f * g + 722.f * b) / 10000.f);
            } else {
              v = px[ch * p.plane];
            }
            if (inv) v = 255.f - v;
          }
        }
        Bs[k][n] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      const long long at = z * p.c_z + (long long)m * p.ldc + n;
      if (EPI == E_F32) {
        if (m < p.M && n < p.N) static_cast<float*>(p.C)[at] = acc[i][j];
        continue;
      }
      float v = round_u8(acc[i][j]);
      if (EPI != E_ROUND_U8) {
        const bool inrect = m >= y0 && m < y0 + fh && n >= x0 && n < x0 + fw;
        if (canvas && !inrect) v = fillc;
      }
      if (EPI == E_COMPOSE_F32) {
        if (m < p.M && n < p.N) static_cast<float*>(p.C)[at] = v;
      } else if (m < p.store_h && n < p.store_w) {
        static_cast<uint8_t*>(p.C)[at] = static_cast<uint8_t>(v);
      }
    }
  }
}

template <int BMODE, int EPI>
cudaError_t launch(const Args& p, int planes, cudaStream_t stream) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, planes);
  gemm_kernel<BMODE, EPI><<<grid, NT, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x (B, 3, SH, SW) u8; av (OH, SH), ah (OW, SW) f32; bv (OH, OH) and
// bh (OW, OW) f32 or both null; flags/fill (B, 3) f32; box (B, 4) i32;
// out (B, 3, store_h, store_w) u8 with store_h <= OH, store_w <= OW.
// Scratch: t_buf (B*3, OH, SW) f32; g_buf and u_buf (B*3, OH, OW) f32,
// used only with blur. Returns cudaGetLastError() (0 = launched).
extern "C" int fanlin_resample_uniform(
    const uint8_t* x, const float* av, const float* ah, const float* bv,
    const float* bh, const float* flags, const float* fill, const int* box,
    uint8_t* out, float* t_buf, float* g_buf, float* u_buf, int batch, int sh,
    int sw, int oh, int ow, int store_h, int store_w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int planes = batch * 3;
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
  cudaError_t e = launch<B_PIXEL, E_F32>(p, planes, s);
  if (e != cudaSuccess) return static_cast<int>(e);

  // pass 2: F = T @ Ah^T, round, composite   (M = OH, N = OW, K = SW)
  p = base;
  p.M = oh; p.N = ow; p.K = sw;
  p.A = t_buf; p.a_z = (long long)oh * sw; p.lda = sw;
  p.B = ah; p.b_z = 0; p.ldb = sw;
  if (bv == nullptr) {
    p.C = out; p.c_z = (long long)store_h * store_w; p.ldc = store_w;
    return static_cast<int>(launch<B_TRANS, E_COMPOSE_U8>(p, planes, s));
  }
  p.C = g_buf; p.c_z = (long long)oh * ow; p.ldc = ow;
  e = launch<B_TRANS, E_COMPOSE_F32>(p, planes, s);
  if (e != cudaSuccess) return static_cast<int>(e);

  // pass 3: U = Bv @ F   (M = OH, N = OW, K = OH)
  p = base;
  p.M = oh; p.N = ow; p.K = oh;
  p.A = bv; p.a_z = 0; p.lda = oh;
  p.B = g_buf; p.b_z = (long long)oh * ow; p.ldb = ow;
  p.C = u_buf; p.c_z = (long long)oh * ow; p.ldc = ow;
  e = launch<B_ROW, E_F32>(p, planes, s);
  if (e != cudaSuccess) return static_cast<int>(e);

  // pass 4: V = U @ Bh^T, round   (M = OH, N = OW, K = OW)
  p = base;
  p.M = oh; p.N = ow; p.K = ow;
  p.A = u_buf; p.a_z = (long long)oh * ow; p.lda = ow;
  p.B = bh; p.b_z = 0; p.ldb = ow;
  p.C = out; p.c_z = (long long)store_h * store_w; p.ldc = store_w;
  return static_cast<int>(launch<B_TRANS, E_ROUND_U8>(p, planes, s));
}
