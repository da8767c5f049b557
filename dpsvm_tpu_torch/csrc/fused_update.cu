// Fused rank-2 gradient update + next pair selection for Hopper (sm_90a).
//
// Replaces the TPU kernel dpsvm_tpu/ops/pallas_fused.py
// fused_update_select (_fused_kernel and its jnp epilogue, kernel B6),
// the per-pair engine's (engine="pallas") one pass over its O(n)
// vectors per pair update:
//   k_hi = kernel_from_dots(d_hi, x_sq, qsq_hi), k_lo alike;
//   f'   = f + coef_hi * k_hi + coef_lo * k_lo, written back;
//   b_hi = min f' over I_up, b_lo = max f' over I_low (masks from the
//          already-scattered alpha and `valid`), each with the lowest flat
//          id whose value equals it.
//
// What bounds it on this card: bytes, and at the per-pair engine's sizes
// hardly even those. It reads seven float32 vectors and writes one (2.1 MB
// at n = 65536: 0.63 us at 3.35 TB/s) for a few dozen flops and one exp
// per element, so a launch costs more than the work.
//
// What the design does about it: one pass, one launch. Each thread owns
// four consecutive elements, read with one 16-byte load per vector and
// written with one 16-byte store; 256 threads a block (1024 elements, 64
// blocks at n = 65536). The block reduces its (value, id) candidates with
// warp shuffles and one shared slot per warp, writes them to a partials
// buffer and counts itself in an arrival counter; the last block to arrive
// reduces every block's partials the same way, writes the four results and
// resets the counter for the next launch. So the selection needs no second
// kernel and no host round trip.
//
// Numerics: built with -fmad=false, so kernel_from_dots rounds per
// operation as the plain version does; the update is the two explicit
// fused multiply-adds XLA contracts it into on the CPU,
// fma(coef_lo, k_lo, fma(coef_hi, k_hi, f)). expf may differ from torch's
// exp by an ulp, so f' agrees with the plain version within that; the
// selection is exact on the kernel's own f'.
//
// Ties and edges: the (value, id) rules of common.cuh (lowest id among
// equal values, +0.0 and -0.0 included; the IEEE minimum / maximum for the
// reported value), so the result does not depend on the blocking. An empty
// set reports +inf (up) / -inf (low) with id 0. NaN in f is not supported.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerBlock = kThreads * 4;

__device__ __forceinline__ void warp_reduce(Cand& up, Cand& lo) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float uv = __shfl_xor_sync(0xffffffffu, up.v, s);
    const int ui = __shfl_xor_sync(0xffffffffu, up.i, s);
    const float lv = __shfl_xor_sync(0xffffffffu, lo.v, s);
    const int li = __shfl_xor_sync(0xffffffffu, lo.i, s);
    take_min(up, uv, ui);
    take_max(lo, lv, li);
  }
}

// The block's reduction of (up, lo); the result is valid in thread 0.
// Every thread of the block must call it.
__device__ void block_reduce(Cand& up, Cand& lo) {
  __shared__ Cand s_up[kWarps];
  __shared__ Cand s_lo[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  warp_reduce(up, lo);
  if (lane == 0) {
    s_up[warp] = up;
    s_lo[warp] = lo;
  }
  __syncthreads();
  if (warp == 0) {
    up = lane < kWarps ? s_up[lane] : Cand{INFINITY, INT_MAX};
    lo = lane < kWarps ? s_lo[lane] : Cand{-INFINITY, INT_MAX};
    warp_reduce(up, lo);
  }
}

__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const float* __restrict__ scalars, const float* __restrict__ f,
                    const float* __restrict__ alpha, const float* __restrict__ y,
                    const float* __restrict__ valid, const float* __restrict__ d_hi,
                    const float* __restrict__ d_lo, const float* __restrict__ x_sq,
                    float* __restrict__ f_out, float* part_v, int* part_i, int* counter,
                    float* __restrict__ out_v, int* __restrict__ out_i, int n,
                    KParams kp, float c_pos, float c_neg) {
  const float coef_hi = scalars[0];
  const float coef_lo = scalars[1];
  const float qsq_hi = scalars[2];
  const float qsq_lo = scalars[3];
  Cand up{INFINITY, INT_MAX};
  Cand lo{-INFINITY, INT_MAX};
  const int id0 = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (id0 < n) {
    const size_t off = (size_t)id0;
    float fv[4], av[4], yv[4], vv[4], dh[4], dl[4], xs[4], fn[4];
    unpack(load4(f + off), fv);
    unpack(load4(alpha + off), av);
    unpack(load4(y + off), yv);
    unpack(load4(valid + off), vv);
    unpack(load4(d_hi + off), dh);
    unpack(load4(d_lo + off), dl);
    unpack(load4(x_sq + off), xs);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float k_hi = from_dot(dh[e], xs[e], qsq_hi, kp);
      const float k_lo = from_dot(dl[e], xs[e], qsq_lo, kp);
      fn[e] = __fmaf_rn(coef_lo, k_lo, __fmaf_rn(coef_hi, k_hi, fv[e]));
      const bool ok = vv[e] > 0.0f;
      const bool pos = yv[e] > 0.0f;
      const bool in_up = ok && (pos ? av[e] < c_pos : av[e] > 0.0f);
      const bool in_low = ok && (pos ? av[e] > 0.0f : av[e] < c_neg);
      take_min(up, in_up ? fn[e] : INFINITY, id0 + e);
      take_max(lo, in_low ? fn[e] : -INFINITY, id0 + e);
    }
    store4(f_out + off, fn);
  }
  block_reduce(up, lo);

  __shared__ bool last;
  const int blocks = (int)gridDim.x;
  if (threadIdx.x == 0) {
    part_v[blockIdx.x] = up.v;
    part_i[blockIdx.x] = up.i;
    part_v[blocks + blockIdx.x] = lo.v;
    part_i[blocks + blockIdx.x] = lo.i;
    __threadfence();  // the partials are visible before the arrival counts
    last = atomicAdd(counter, 1) == blocks - 1;
  }
  __syncthreads();
  if (!last) return;

  // The last block to arrive: reduce every block's partials (read past
  // L1, which may hold stale lines of the buffer).
  __threadfence();
  up = Cand{INFINITY, INT_MAX};
  lo = Cand{-INFINITY, INT_MAX};
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
    take_min(up, __ldcg(part_v + b), __ldcg(part_i + b));
    take_max(lo, __ldcg(part_v + blocks + b), __ldcg(part_i + blocks + b));
  }
  block_reduce(up, lo);
  if (threadIdx.x == 0) {
    out_v[0] = up.v;
    out_i[0] = up.i;
    out_v[1] = lo.v;
    out_i[1] = lo.i;
    *counter = 0;
  }
}

}  // namespace

// n: the element count (a multiple of 4, 16-byte aligned vectors);
// part_v / part_i: 2 * ceil(n / 1024) scratch slots; counter: one int, 0
// before the launch and left at 0 after it; out_v / out_i: (b_hi, b_lo)
// and (i_hi, i_lo).
extern "C" int dpsvm_fused_update_select(
    const float* scalars, const float* f, const float* alpha, const float* y,
    const float* valid, const float* d_hi, const float* d_lo, const float* x_sq,
    float* f_out, float* part_v, int* part_i, int* counter, float* out_v, int* out_i,
    int n, int kind, float gamma, float coef0, int degree, float c_pos, float c_neg,
    void* stream) {
  if (n < 4 || n % 4 != 0 || kind < kRbf || kind > kSigmoid) {
    return (int)cudaErrorInvalidValue;
  }
  const KParams kp{kind, -gamma, gamma, coef0, degree};
  const int grid = (n + kPerBlock - 1) / kPerBlock;
  fused_update_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      scalars, f, alpha, y, valid, d_hi, d_lo, x_sq, f_out, part_v, part_i, counter,
      out_v, out_i, n, kp, c_pos, c_neg);
  return (int)cudaGetLastError();
}
