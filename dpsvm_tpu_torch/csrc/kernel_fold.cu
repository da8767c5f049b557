// The block round's fold after the kernel-row GEMM, for Hopper (sm_90a):
//
//     delta[j] = sum_k coef[k] K(dots[k, j])       (k = 0 .. q-1, in order)
//
// where K is ops/kernels.py kernel_from_dots for one element (common.cuh
// from_dot: rbf, linear, poly, sigmoid) and dots the (q, n) row-major
// float32 block q . X^T that cuBLAS's SGEMM (ops/kernels.py row_dots)
// leaves. It replaces no TPU kernel: the JAX package leaves
// coef @ kernel_rows(...) to XLA (dpsvm_tpu/solver/block.py), and the port
// ran it as torch's elementwise passes over the (q, n) block (five float32
// temporaries of its size for rbf) and a cuBLAS gemv, which read or write
// the block seven times. Here it is read once and only the (n,) delta is
// written (ops/kernel_fold.py fold_dots).
//
// What bounds it on this card: bytes. q n 4 bytes read (2.46 GB at q 256,
// n 2,400,000: 0.73 ms at 3.35 TB/s) against some twenty instructions an
// element (the rbf transform, an IEEE expf, one fused multiply-add), about
// half the card's issue rate over the same time.
//
// Design: each thread owns V consecutive columns and walks k in order,
// with the loads of kUnroll rows in flight before their arithmetic; a
// warp reads 32 V contiguous floats of a row, so V = 4 (n a multiple of 4
// and the block 16-byte aligned) reads every row with one coalesced
// 16-byte load a lane, and V = 1 (any other n) with one 4-byte load a
// lane. The loads allocate no L1 line (the block is read once). The
// coefficients and the working-set rows' squared norms are staged in
// shared memory kTileK rows at a time, so any q fits; the data rows' norms
// sit in registers. Blocks of kThreads threads tile the columns; nothing
// crosses blocks.
//
// Numerics: built with -fmad=false. Each element is from_dot in
// kernel_from_dots' order (rbf: x_sq + q_sq, then - 2 dots, then
// max(., 0), then expf(-gamma .), IEEE expf, no fast math), and the sum is
// acc = fma(coef[k], K, acc) from +0.0, one rounding a term, in order k.
// A column's delta depends only on its column of dots, its x_sq and the
// coefficients: not on n, on where the column lies, nor on V. Folding a
// subset of the columns (a mesh shard) therefore gives those columns'
// values bit for bit. The sum is in another order than cuBLAS's gemv, so
// the delta agrees with the plain version within rounding only; a dead
// slot (coef 0) adds an exact zero wherever K is finite.

#include <stdint.h>

#include "common.cuh"

namespace {

// Blocks of 128 to 512 threads with 4 to 16 rows in flight a thread all
// time within 2.6% of each other at q 256, n 2,400,000 (PERF.md section 6).
constexpr int kThreads = 256;
constexpr int kUnroll = 8;     // rows whose loads a thread has in flight
constexpr int kTileK = 1024;   // coefficient rows staged at a time

// One row's V columns, read once: no L1 line.
__device__ __forceinline__ float load1_stream(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

template <int V>
__device__ __forceinline__ void load_cols(float (&o)[V], const float* p) {
  if constexpr (V == 4) {
    unpack(load4_stream(p), o);
  } else {
    o[0] = load1_stream(p);
  }
}

// acc[e] += coef_k K(dot[e]) for the thread's V columns.
template <int V>
__device__ __forceinline__ void accumulate(float (&acc)[V], const float (&dot)[V],
                                           const float (&bsq)[V], float asq, float ck,
                                           const KParams& kp) {
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = __fmaf_rn(ck, from_dot(dot[e], bsq[e], asq, kp), acc[e]);
}

template <int KIND, int V>
__global__ void __launch_bounds__(kThreads)
kernel_fold_kernel(const float* __restrict__ dots, const float* __restrict__ x_sq,
                   const float* __restrict__ q_sq, const float* __restrict__ coef,
                   float* __restrict__ out, int q, int n, float gamma, float coef0, int degree) {
  __shared__ float s_coef[kTileK];
  __shared__ float s_qsq[kTileK];
  // KIND is a constant, so from_dot's branches on the kind fold away.
  const KParams kp{KIND, -gamma, gamma, coef0, degree};
  const long long col = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  const bool live = col < n;  // n is a multiple of V
  float acc[V], bsq[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    acc[e] = 0.0f;
    bsq[e] = (KIND == kRbf && live) ? x_sq[col + e] : 0.0f;
  }
  const size_t ld = (size_t)n;
  for (int k0 = 0; k0 < q; k0 += kTileK) {
    const int kn = min(kTileK, q - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int t = threadIdx.x; t < kn; t += kThreads) {
      s_coef[t] = coef[k0 + t];
      s_qsq[t] = KIND == kRbf ? q_sq[k0 + t] : 0.0f;
    }
    __syncthreads();
    if (!live) continue;
    const float* row = dots + (size_t)k0 * ld + col;
    int k = 0;
    for (; k + kUnroll <= kn; k += kUnroll) {
      float v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load_cols<V>(v[u], row + (size_t)(k + u) * ld);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) accumulate<V>(acc, v[u], bsq, s_qsq[k + u], s_coef[k + u], kp);
    }
    for (; k < kn; ++k) {
      float v[V];
      load_cols<V>(v, row + (size_t)k * ld);
      accumulate<V>(acc, v, bsq, s_qsq[k], s_coef[k], kp);
    }
  }
  if (!live) return;
  if constexpr (V == 4) {
    store4(out + col, acc);
  } else {
    out[col] = acc[0];
  }
}

template <int KIND, int V>
int launch(const float* dots, const float* x_sq, const float* q_sq, const float* coef,
           float* out, int q, int n, float gamma, float coef0, int degree, cudaStream_t st) {
  const long long threads = ((long long)n + V - 1) / V;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  kernel_fold_kernel<KIND, V><<<(unsigned)blocks, kThreads, 0, st>>>(dots, x_sq, q_sq, coef, out,
                                                                     q, n, gamma, coef0, degree);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_kind(const float* dots, const float* x_sq, const float* q_sq, const float* coef,
                float* out, int q, int n, float gamma, float coef0, int degree, cudaStream_t st) {
  const bool vec = n % 4 == 0 && (uintptr_t)dots % 16 == 0 && (uintptr_t)out % 16 == 0;
  return vec ? launch<KIND, 4>(dots, x_sq, q_sq, coef, out, q, n, gamma, coef0, degree, st)
             : launch<KIND, 1>(dots, x_sq, q_sq, coef, out, q, n, gamma, coef0, degree, st);
}

}  // namespace

// dots (q, n) row-major float32, x_sq (n,), q_sq (q,) (read for rbf
// only), coef (q,), out (n,), all on the current device; kind as
// ops/kernel_fold.py _KINDS (rbf 0, linear 1, poly 2, sigmoid 3). The
// 16-byte path is taken where n is a multiple of 4 and dots and out are
// 16-byte aligned. Returns the launch's CUDA error (0 on success).
extern "C" int dpsvm_kernel_fold(const float* dots, const float* x_sq, const float* q_sq,
                                 const float* coef, float* out, int q, int n, int kind,
                                 float gamma, float coef0, int degree, void* stream) {
  if (q < 0 || n < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case kRbf:
      return launch_kind<kRbf>(dots, x_sq, q_sq, coef, out, q, n, gamma, coef0, degree, st);
    case kLinear:
      return launch_kind<kLinear>(dots, x_sq, q_sq, coef, out, q, n, gamma, coef0, degree, st);
    case kPoly:
      return launch_kind<kPoly>(dots, x_sq, q_sq, coef, out, q, n, gamma, coef0, degree, st);
    case kSigmoid:
      return launch_kind<kSigmoid>(dots, x_sq, q_sq, coef, out, q, n, gamma, coef0, degree, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
