// Row-cache fill for Hopper (sm_90a): the per-pair engines' device-side
// branch over the hit and miss cases of their kernel-row cache.
//
// Replaces no TPU kernel. It is the counterpart of the branch the JAX
// package compiles inside its per-pair while_loop: the lax.switch over
// the four hit/miss cases of dpsvm_tpu/solver/cache.py lookup_pair (both
// miss: one (2, d) x (d, n) product; one miss: a (1, d) one; both hit:
// nothing) and the lax.cond of lookup_one. The port keeps the cache's
// keys and ticks on the device (solver/cache.py), so the host does not
// know which case a trip is in, and computing both rows every trip and
// discarding the hits would undo the cache. This kernel reads the case
// from device memory instead: for each query r with flags[r] (its miss)
// set it writes the dot row x[ids[r]] . X^T into line dest[r] of the
// cache's store; a hit line is left as it is, and a trip with no miss
// (both hit, or a masked trip) returns at once. A pair's third flag
// (save) covers the one-line cache: query 0 hit the line query 1's row
// is about to replace, so that line is first copied to line dest[0] (the
// spare), entry by entry in the warp that then overwrites it.
//
// What bounds it on this card: bytes. A miss reads X once (n x d values,
// 94 MB at 60000 x 784 in bfloat16: 28 us at 3.35 TB/s) for 2 d flops a
// row and a query; a double miss takes both queries in the same pass.
//
// The design, simple first: one warp a row of X, in a grid-stride loop
// over the rows. Each lane reads 16 bytes of the row at a time (four
// float32 or eight bfloat16 values) where the row length allows it, else
// one value, multiplies them by the queries' values (read through the
// read-only cache: the two query rows stay hot in L1 and L2), and keeps
// one float32 partial sum a query; the warp adds its lanes' sums with a
// butterfly of shuffles and lane 0 writes the row's entries. Products of
// bfloat16 values are exact in float32 and summed in float32, as
// ops/kernels.py row_dots computes them. The order of the sum is not
// cuBLAS's, so the rows differ from the plain version's in the last bits;
// the order is fixed, so two launches on the same inputs give the same
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps a block (256 threads)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Sixteen bytes of a row: VEC values of T, unpacked to float32.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float (&o)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&o)[8]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // A bfloat16 is the high half of the float32 with the same bits.
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    cache_fill_kernel(const T* __restrict__ x, float* __restrict__ store,
                      const int64_t* __restrict__ ids, const int64_t* __restrict__ dest,
                      const bool* __restrict__ flags, int nq, long long n, int d) {
  const bool m0 = flags[0];
  const bool m1 = nq > 1 && flags[1];
  const bool save = nq > 1 && flags[2];  // implies m1 and not m0
  if (!m0 && !m1) return;  // every query hit, or the trip is masked
  const T* q0 = x + (size_t)ids[0] * d;
  const T* q1 = x + (size_t)ids[nq > 1 ? 1 : 0] * d;
  float* out0 = store + (size_t)dest[0] * n;
  float* out1 = store + (size_t)dest[nq > 1 ? 1 : 0] * n;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long j = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); j < n; j += stride) {
    const T* row = x + (size_t)j * d;
    float s0 = 0.0f, s1 = 0.0f;
    if (kVec) {
      constexpr int V = Vec<T>::kN;
      for (int k = lane * V; k < d; k += 32 * V) {
        float r[V], a[V], b[V];
        Vec<T>::load(row + k, r);
        if (m0) {
          Vec<T>::load(q0 + k, a);
#pragma unroll
          for (int i = 0; i < V; ++i) s0 += a[i] * r[i];
        }
        if (m1) {
          Vec<T>::load(q1 + k, b);
#pragma unroll
          for (int i = 0; i < V; ++i) s1 += b[i] * r[i];
        }
      }
    } else {
      for (int k = lane; k < d; k += 32) {
        const float r = to_f(row[k]);
        if (m0) s0 += to_f(q0[k]) * r;
        if (m1) s1 += to_f(q1[k]) * r;
      }
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    if (lane == 0) {
      if (save) out0[j] = out1[j];
      if (m0) out0[j] = s0;
      if (m1) out1[j] = s1;
    }
  }
}

template <typename T>
int launch(const void* x, float* store, const int64_t* ids, const int64_t* dest,
           const bool* flags, int nq, long long n, int d, int vec, int blocks,
           cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  if (vec) {
    cache_fill_kernel<T, true><<<blocks, kWarps * 32, 0, stream>>>(xt, store, ids, dest, flags,
                                                                   nq, n, d);
  } else {
    cache_fill_kernel<T, false><<<blocks, kWarps * 32, 0, stream>>>(xt, store, ids, dest, flags,
                                                                    nq, n, d);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n, d) row-major, float32 (bf16 == 0) or bfloat16 (bf16 == 1);
// store: (lines, n) float32 row-major; ids, dest: (nq,) int64; flags:
// nq == 1: (1,) bool {miss}; nq == 2: (3,) bool {miss0, miss1, save}.
// vec: each row starts 16-byte aligned and d is a multiple of
// 16 / sizeof(value) (the wrapper checks both). blocks: the
// grid (ops/cache_fill.py cache_fill_plan). Returns the launch's CUDA
// error code.
extern "C" int dpsvm_cache_fill(const void* x, float* store, const int64_t* ids,
                                const int64_t* dest, const bool* flags, int nq, long long n,
                                int d, int bf16, int vec, int blocks, void* stream) {
  if (nq < 1 || nq > 2 || n < 1 || d < 1 || blocks < 1 || (bf16 != 0 && bf16 != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, store, ids, dest, flags, nq, n, d, vec, blocks, s)
              : launch<float>(x, store, ids, dest, flags, nq, n, d, vec, blocks, s);
}
