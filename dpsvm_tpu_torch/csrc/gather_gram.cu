// Working-set gather + kernel rows + Gram block for Hopper (sm_90a).
//
// Replaces the TPU kernel dpsvm_tpu/ops/pallas_round.py gather_gram
// (_gather_gram_kernel, kernel B4): one pass over X that gathers the q
// working-set rows X[w], forms K(W, :) = kernel_from_dots(X[w] X^T) as
// (q, n) float32 kernel rows and, from the same rows, the (q, q) Gram
// block K(W, W).
//
// What bounds it on this card: at the 60000 x 784 headline (q = 256) the
// product is 24.3 GFLOP against 157 MB (bf16 X read once, the 62 MB of
// kernel rows written once). With bf16 X on the tensor cores bytes would
// bound it (~47 us); this kernel runs on the CUDA cores in float32, where
// the operations bound it (~362 us at 67 TFLOP/s).
//
// What the design does about it: a plain tiled shared-memory GEMM. Each
// 256-thread CTA owns a 64 (working-set rows) x 128 (data rows) output
// tile, loops over d in chunks of 16, stages both operand tiles in shared
// memory as float32 (bf16 is widened on load: every bf16 product is exact
// in float32) and gives each thread an 8 x 4 register tile of float32
// accumulators, one fused multiply-add per term in order k = 0 .. d-1.
// The gather rides the A-tile loads: each CTA reads the rows w[m] of X
// directly, so no gathered (q, d) buffer is written. blockIdx.x walks the
// working-set tiles fastest, so the q / 64 CTAs that share one X tile run
// together and read it from L2. The epilogue applies kernel_from_dots
// (ops/kernels.py, same operation order) and writes each warp's 32
// consecutive columns with one coalesced store. Extra CTAs past the last
// data tile compute K(W, W) with the gathered rows as the B operand too.
// No tensor cores, TMA or pipelining yet: right first, fast later.
//
// Numerics: built with -fmad=false; the accumulation uses explicit fused
// multiply-adds. The sum order differs from cuBLAS and from the CPU, so
// kernel values agree with the plain version within rounding only.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kBM = 64;   // working-set rows per CTA
constexpr int kBN = 128;  // data rows per CTA
constexpr int kBK = 16;   // depth per shared-memory stage
constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_gram_kernel(const T* __restrict__ x, const int* __restrict__ w,
                   const float* __restrict__ x_sq, const float* __restrict__ qsq,
                   float* __restrict__ k_rows, float* __restrict__ kb, int n, int d,
                   int q, int n_tiles, KParams kp) {
  __shared__ float a_s[kBK][kBM + 4];
  __shared__ float b_s[kBK][kBN + 4];
  __shared__ int a_row[kBM];
  __shared__ int b_row[kBN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const bool gram = (int)blockIdx.y >= n_tiles;  // CTA-uniform
  const int n0 = (gram ? (int)blockIdx.y - n_tiles : (int)blockIdx.y) * kBN;
  const int ncols = gram ? q : n;
  if (tid < kBM) a_row[tid] = m0 + tid < q ? w[m0 + tid] : -1;
  if (tid < kBN) {
    const int j = n0 + tid;
    b_row[tid] = j < ncols ? (gram ? w[j] : j) : -1;
  }
  __syncthreads();

  const int tx = tid & 31;  // columns tx, tx + 32, tx + 64, tx + 96
  const int ty = tid >> 5;  // rows 8 ty .. 8 ty + 7 (one warp: one ty)
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK, gr = a_row[r], k = k0 + kk;
      a_s[kk][r] = (gr >= 0 && k < d) ? widen(x[(size_t)gr * d + k]) : 0.0f;
    }
    for (int e = tid; e < kBN * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK, gr = b_row[r], k = k0 + kk;
      b_s[kk][r] = (gr >= 0 && k < d) ? widen(x[(size_t)gr * d + k]) : 0.0f;
    }
    __syncthreads();
    const int kmax = d - k0 < kBK ? d - k0 : kBK;
    for (int kk = 0; kk < kmax; ++kk) {
      float av[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = a_s[kk][ty * 8 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[kk][tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = gram ? kb : k_rows;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= q) break;
    const float asq = qsq[m];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 32 * j;
      if (col < ncols) {
        const float bsq = gram ? qsq[col] : x_sq[col];
        out[(size_t)m * ncols + col] = from_dot(acc[i][j], bsq, asq, kp);
      }
    }
  }
}

}  // namespace

extern "C" int dpsvm_gather_gram(const void* x, int x_bf16, const int* w,
                                 const float* x_sq, const float* qsq, float* k_rows,
                                 float* kb, int n, int d, int q, int kind, float gamma,
                                 float coef0, int degree, void* stream) {
  const int n_tiles = (n + kBN - 1) / kBN;
  const int g_tiles = (q + kBN - 1) / kBN;
  if (n < 1 || d < 1 || q < 1 || kind < kRbf || kind > kSigmoid ||
      n_tiles + g_tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const KParams kp{kind, -gamma, gamma, coef0, degree};
  const dim3 grid((q + kBM - 1) / kBM, n_tiles + g_tiles);
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16) {
    gather_gram_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, w, x_sq, qsq, k_rows, kb, n, d, q, n_tiles, kp);
  } else {
    gather_gram_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)x, w, x_sq, qsq, k_rows, kb, n, d, q, n_tiles, kp);
  }
  return (int)cudaGetLastError();
}
