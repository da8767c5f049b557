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
// What bounds it on this card: bytes. It reads seven float32 vectors and
// writes one (2.1 MB at n = 65536: 0.63 us at 3.35 TB/s) for a few dozen
// flops and one exp per element. At that size one DRAM round trip and the
// step that joins the blocks' selections are most of the kernel's time,
// and the launch costs more: on the H100 an empty launch reads 5.0 us on
// the timer that reads 8.6 us for this kernel (chip_smoke.py --turns).
//
// What the design does about it (ops/fused_update.py fused_update_plan):
// - One group a thread. Each thread owns four consecutive elements, read
//   with one 16-byte load per vector and written with one 16-byte store;
//   blocks of 128 threads, as many as the groups need (128 at n = 65536).
//   Smaller blocks reach more SMs but post more atomics in the join, and
//   on the H100 that costs more than the SMs save.
// - A short join. A thread keeps its best (key, id) of each side, where
//   the key orders f' as an unsigned word (okey). Each warp reduces them
//   with redux.sync (the least key, then the least id holding it), thread 0
//   of the block takes the best of its warps and posts it with one 64-bit
//   atomicMin a side on key << 32 | id. The block that arrives last (an
//   acq_rel arrival count) swaps the words back to their empty values and
//   decodes the result: one thread, four atomics, no second pass over
//   partials. The words persist between launches, one set per (device,
//   stream) held by the wrapper, and are left empty by every launch; the
//   results go to a buffer the wrapper allocates for each launch.
//
// Numerics: built with -fmad=false, so kernel_from_dots rounds per
// operation as the plain version does; the update is the two explicit
// fused multiply-adds XLA contracts it into on the CPU,
// fma(coef_lo, k_lo, fma(coef_hi, k_hi, f)). expf may differ from torch's
// exp by an ulp, so f' agrees with the plain version within that; the
// selection is exact on the kernel's own f'. min and max are order-free,
// so two launches on the same inputs give the same bits.
//
// Ties and edges (those of common.cuh take_min / take_max): values that
// compare equal go to the lowest flat id, +0.0 and -0.0 included (okey
// maps both to one key); the value reported for a +-0 extremum is -0.0 for
// b_hi when an I_up member is -0.0 and +0.0 for b_lo when an I_low member
// is +0.0 (one flag bit a side, or-ed across blocks). Elements outside a
// set stand at +inf (up) / -inf (low) with their own id, so an empty set
// reports +-inf with id 0. NaN in f is not supported.

#include "common.cuh"

namespace {

// The cross-block words (ops/fused_update.py _words): empty is
// {~0, ~0, 0, 0}.
struct Words {
  unsigned long long up;  // min over elements of okey(f'_up) << 32 | id
  unsigned long long lo;  // min over elements of ~okey(f'_low) << 32 | id
  unsigned flags;         // bit 0: an I_up member is -0.0; bit 1: an I_low member is +0.0
  unsigned arrived;       // blocks that have posted this launch
};

__device__ __forceinline__ unsigned long long pack(unsigned key, unsigned id) {
  return ((unsigned long long)key << 32) | id;
}

__device__ __forceinline__ unsigned arrive(unsigned* count) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(count)
               : "memory");
  return old;
}

__global__ void fused_update_kernel(const float* __restrict__ scalars, const float* __restrict__ f,
                                    const float* __restrict__ alpha, const float* __restrict__ y,
                                    const float* __restrict__ valid,
                                    const float* __restrict__ d_hi,
                                    const float* __restrict__ d_lo,
                                    const float* __restrict__ x_sq, float* __restrict__ f_out,
                                    Words* words, float* __restrict__ out, int groups,
                                    KParams kp, float c_pos, float c_neg) {
  // [up key, up id, low key, low id, flags] for each warp.
  extern __shared__ unsigned rec[];
  const float coef_hi = scalars[0];
  const float coef_lo = scalars[1];
  const float qsq_hi = scalars[2];
  const float qsq_lo = scalars[3];
  unsigned up_k = ~0u, up_i = ~0u, lo_k = ~0u, lo_i = ~0u, flags = 0;
  // The thread's group; a thread meets its ids in increasing order, so a
  // strictly smaller key is the only one that replaces its best.
  const int grp = blockIdx.x * blockDim.x + threadIdx.x;
  if (grp < groups) {
    const size_t off = (size_t)grp * 4;
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
      const unsigned id = (unsigned)off + e;
      const unsigned ku = okey(in_up ? fn[e] : INFINITY);
      const unsigned kl = ~okey(in_low ? fn[e] : -INFINITY);
      if (ku < up_k) {
        up_k = ku;
        up_i = id;
      }
      if (kl < lo_k) {
        lo_k = kl;
        lo_i = id;
      }
      const unsigned bits = __float_as_uint(fn[e]);
      flags |= (in_up && bits == 0x80000000u ? 1u : 0u) | (in_low && bits == 0u ? 2u : 0u);
    }
    store4(f_out + off, fn);
  }

  const unsigned all = 0xffffffffu;
  const unsigned wu = __reduce_min_sync(all, up_k);
  const unsigned wui = __reduce_min_sync(all, up_k == wu ? up_i : ~0u);
  const unsigned wl = __reduce_min_sync(all, lo_k);
  const unsigned wli = __reduce_min_sync(all, lo_k == wl ? lo_i : ~0u);
  const unsigned wf = __reduce_or_sync(all, flags);
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    unsigned* r = rec + 5 * warp;
    r[0] = wu;
    r[1] = wui;
    r[2] = wl;
    r[3] = wli;
    r[4] = wf;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  unsigned long long up = ~0ull, lo = ~0ull;
  unsigned fl = 0;
  for (int w = 0; w < nwarps; ++w) {
    const unsigned* r = rec + 5 * w;
    const unsigned long long u = pack(r[0], r[1]), l = pack(r[2], r[3]);
    up = u < up ? u : up;
    lo = l < lo ? l : lo;
    fl |= r[4];
  }
  atomicMin(&words->up, up);
  atomicMin(&words->lo, lo);
  if (fl != 0) atomicOr(&words->flags, fl);
  // Release: this block's atomics come before its arrival; acquire: the
  // last block sees every block's.
  if (arrive(&words->arrived) != gridDim.x - 1) return;

  up = atomicExch(&words->up, ~0ull);
  lo = atomicExch(&words->lo, ~0ull);
  fl = atomicExch(&words->flags, 0u);
  atomicExch(&words->arrived, 0u);
  float b_hi = from_okey((unsigned)(up >> 32));
  float b_lo = from_okey(~(unsigned)(lo >> 32));
  if (b_hi == 0.0f && (fl & 1u)) b_hi = -0.0f;
  if (b_lo == 0.0f && !(fl & 2u)) b_lo = -0.0f;
  int* out_i = reinterpret_cast<int*>(out);
  out[0] = b_hi;
  out[1] = b_lo;
  out_i[2] = (int)(unsigned)up;
  out_i[3] = (int)(unsigned)lo;
}

}  // namespace

// n: the element count (a multiple of 4, 16-byte aligned vectors); the
// launch plan (threads, blocks, smem) of ops/fused_update.py
// fused_update_plan, checked here: `threads` a multiple of 32 up to 1024,
// smem 20 bytes a warp, one group of four a thread covering the n / 4
// groups and no block without a group; words: the (device, stream)'s
// cross-block words, empty before the launch and left empty after it;
// out: (b_hi, b_lo) as float32, then (i_hi, i_lo) as int32.
extern "C" int dpsvm_fused_update_select(
    const float* scalars, const float* f, const float* alpha, const float* y,
    const float* valid, const float* d_hi, const float* d_lo, const float* x_sq,
    float* f_out, void* words, float* out, int n, int threads, int blocks,
    int smem, int kind, float gamma, float coef0, int degree, float c_pos, float c_neg,
    void* stream) {
  const long long groups = n / 4;
  if (n < 4 || n % 4 != 0 || kind < kRbf || kind > kSigmoid || threads < 32 ||
      threads > 1024 || threads % 32 != 0 || blocks < 1 || smem != 20 * (threads / 32) ||
      (long long)blocks * threads < groups || (long long)(blocks - 1) * threads >= groups) {
    return (int)cudaErrorInvalidValue;
  }
  const KParams kp{kind, -gamma, gamma, coef0, degree};
  fused_update_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      scalars, f, alpha, y, valid, d_hi, d_lo, x_sq, f_out, static_cast<Words*>(words), out,
      (int)groups, kp, c_pos, c_neg);
  return (int)cudaGetLastError();
}
