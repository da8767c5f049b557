// Block-engine subproblem solve for Hopper (sm_90a).
//
// Replaces the TPU kernel dpsvm_tpu/ops/pallas_subproblem.py
// solve_subproblem_pallas (kernel _subproblem_kernel): the whole
// q-variable SMO subproblem of one block round in ONE launch. Per trip:
// argmin f over I_up and argmax f over I_low (lowest slot wins ties), or
// LibSVM's WSS2 partner by second-order gain, or (rule nu) both extrema
// within each class and the class with the larger violation, by the
// float32 test (b_lo+ - b_hi+) >= (b_lo- - b_hi-); the pair_alpha_update
// algebra; f_W += dalpha * y * K(W, W) rows. Stops when the local gap
// b_lo <= b_hi + 2 eps or after `limit` pairs. With pair_batch 2 or 4 (rule
// mvp) a trip goes on to pair_batch - 1 further coordinate-disjoint pairs:
// each is SELECTED by rank from the trip's pre-update f over I_up / I_low
// with the earlier pairs' slots excluded (stale), and UPDATED exactly from
// the current f_W. An attempted slot counts while the budget lasts even
// when its update is gated to a no-op (empty stale set, or the corrected
// pair no longer violating: the margin-free b_lo > b_hi gate).
//
// What bounds it on this card: not bytes and not arithmetic. Each trip
// moves two Gram rows (2 * q * 4 bytes) and does O(q) flops; what it
// cannot avoid is the serial chain of dependent block-wide reductions and
// L2 reads, one trip after another, with a data-dependent exit.
//
// What the design does about it: one CTA holds the whole chain, so a trip
// costs one barrier (two for second_order) and no launch. The per-slot
// state (alpha, f, y, kd, ok) lives in registers, each thread owning
// slots tid, tid + blockDim, ... so any q up to 4096 works. Each
// reduction is warp shuffles, then one shared-memory slot per warp that
// every thread reads and reduces itself (double-buffered by parity,
// so no second barrier), so all threads hold the same pair, run the
// scalar update redundantly and leave the loop together. Under nu the +
// and - classes' winners ride side by side through that one reduction
// (four candidates instead of two), so a nu trip also costs one barrier.
// K(W, W) stays in global memory and is read from L2 (256 KiB at q=256 is
// over the 227 KB a block can have in shared memory). `limit` and the pair
// count stay on the device, so a round needs no host sync before the
// launch.
//
// Numerics: built with -fmad=false and IEEE division so every expression
// rounds per operation in the JAX package's order (solver/smo.py
// pair_alpha_update, solver/block.py _solve_subproblem), except the f_W
// update, which is two explicit fused multiply-adds: XLA on the CPU
// contracts that expression, and the reference's trajectory follows it.
// The snap constants arrive precomputed from the host exactly as the JAX
// package rounds them.

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr int kMvp = 0;
constexpr int kSecondOrder = 1;
constexpr int kNu = 2;

struct BoxConsts {
  float c_pos, c_neg;        // box upper bounds per class
  float snap_pos, snap_neg;  // 1e-6 * C, rounded as the reference rounds it
  float cms_pos, cms_neg;    // C - snap
  float two_eps;             // 2 * eps in float32
  float tau;                 // eta clamp
};

// (value, slot) total order for argmin / argmax with lowest-slot ties.
__device__ __forceinline__ bool better_min(float v2, int i2, float v1, int i1) {
  return v2 < v1 || (v2 == v1 && i2 < i1);
}
__device__ __forceinline__ bool better_max(float v2, int i2, float v1, int i1) {
  return v2 > v1 || (v2 == v1 && i2 < i1);
}

// Candidate with its payload (f and alpha at the winning slot).
struct Cand {
  float v;
  int i;
  float f;
  float a;
};

template <bool kMin>
__device__ __forceinline__ void take_if_better(Cand& c, const Cand& o) {
  bool b = kMin ? better_min(o.v, o.i, c.v, c.i) : better_max(o.v, o.i, c.v, c.i);
  if (b) c = o;
}

template <bool kMin>
__device__ __forceinline__ Cand warp_reduce(Cand c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Cand o;
    o.v = __shfl_xor_sync(0xffffffffu, c.v, off);
    o.i = __shfl_xor_sync(0xffffffffu, c.i, off);
    o.f = __shfl_xor_sync(0xffffffffu, c.f, off);
    o.a = __shfl_xor_sync(0xffffffffu, c.a, off);
    take_if_better<kMin>(c, o);
  }
  return c;
}

// Block-wide (up-min, low-max): warp shuffles, one shared slot per warp,
// one barrier; every thread then reduces the per-warp winners itself, so
// all threads hold the same pair.
__device__ __forceinline__ void block_reduce(Cand& up, Cand& lo, Cand* red_up,
                                             Cand* red_lo, int lane, int warp,
                                             int nwarps) {
  up = warp_reduce<true>(up);
  lo = warp_reduce<false>(lo);
  if (lane == 0) {
    red_up[warp] = up;
    red_lo[warp] = lo;
  }
  __syncthreads();
  up = red_up[0];
  lo = red_lo[0];
  for (int w = 1; w < nwarps; ++w) {
    take_if_better<true>(up, red_up[w]);
    take_if_better<false>(lo, red_lo[w]);
  }
}

// The nu rule's four extrema (up-min and low-max within + and within -)
// through the same single barrier: each warp's four winners go to their
// own shared slots, then every thread reduces all four itself.
__device__ __forceinline__ void block_reduce_nu(Cand& up_p, Cand& lo_p, Cand& up_n,
                                                Cand& lo_n, Cand* red_up_p,
                                                Cand* red_lo_p, Cand* red_up_n,
                                                Cand* red_lo_n, int lane, int warp,
                                                int nwarps) {
  up_p = warp_reduce<true>(up_p);
  lo_p = warp_reduce<false>(lo_p);
  up_n = warp_reduce<true>(up_n);
  lo_n = warp_reduce<false>(lo_n);
  if (lane == 0) {
    red_up_p[warp] = up_p;
    red_lo_p[warp] = lo_p;
    red_up_n[warp] = up_n;
    red_lo_n[warp] = lo_n;
  }
  __syncthreads();
  up_p = red_up_p[0];
  lo_p = red_lo_p[0];
  up_n = red_up_n[0];
  lo_n = red_lo_n[0];
  for (int w = 1; w < nwarps; ++w) {
    take_if_better<true>(up_p, red_up_p[w]);
    take_if_better<false>(lo_p, red_lo_p[w]);
    take_if_better<true>(up_n, red_up_n[w]);
    take_if_better<false>(lo_n, red_lo_n[w]);
  }
}

// solver/smo.py pair_alpha_update for slots i (up side) and j (low side):
// the new (a_i, a_j), unchanged when `gate` is false or a pair value is not
// finite. Every thread runs it redundantly on the same scalars.
__device__ __forceinline__ void pair_update(const BoxConsts& k, float a_i_old,
                                            float a_j_old, float y_i, float y_j,
                                            float b_hi, float b_lo, float eta, bool gate,
                                            float& ai, float& aj) {
  const bool pi = y_i > 0.0f, pj = y_j > 0.0f;
  const float c_i = pi ? k.c_pos : k.c_neg;
  const float c_j = pj ? k.c_pos : k.c_neg;
  const float snap_i = pi ? k.snap_pos : k.snap_neg;
  const float snap_j = pj ? k.snap_pos : k.snap_neg;
  const float cms_i = pi ? k.cms_pos : k.cms_neg;
  const float cms_j = pj ? k.cms_pos : k.cms_neg;
  const bool upd = gate && isfinite(b_hi) && isfinite(b_lo);
  const float sgn = y_i * y_j;
  const float w = a_i_old + sgn * a_j_old;
  const float lo_b = sgn > 0.0f ? fmaxf(0.0f, w - c_i) : fmaxf(0.0f, -w);
  const float hi_b = sgn > 0.0f ? fminf(c_j, w) : fminf(c_j, c_i - w);
  aj = a_j_old + (y_j * (b_hi - b_lo)) / eta;
  aj = fminf(fmaxf(aj, lo_b), hi_b);
  aj = aj < snap_j ? 0.0f : (aj > cms_j ? c_j : aj);
  ai = a_i_old + sgn * (a_j_old - aj);
  ai = fminf(fmaxf(ai, 0.0f), c_i);
  ai = ai < snap_i ? 0.0f : (ai > cms_i ? c_i : ai);
  if (!upd) {
    ai = a_i_old;
    aj = a_j_old;
  }
}

template <int S>
__global__ void __launch_bounds__(1024, 1)
subproblem_kernel(const float* __restrict__ kb, const float* __restrict__ alpha_in,
                  const float* __restrict__ y_in, const float* __restrict__ f_in,
                  const float* __restrict__ kd_in, const float* __restrict__ ok_in,
                  const int* __restrict__ limit_p, float* __restrict__ alpha_out,
                  int* __restrict__ t_out, int q, int rule, int pair_batch,
                  BoxConsts k) {
  extern __shared__ float smem[];  // y_s[q], kd_s[q]: read-only after setup
  float* y_s = smem;
  float* kd_s = smem + q;
  // [reduction parity][warp]: per-warp winners of a reduction (up-min and
  // low-max, or the second_order gain). `par` flips after every reduction,
  // so the next one writes the other buffer and needs no second barrier.
  __shared__ Cand red_up[2][32];
  __shared__ Cand red_lo[2][32];
  __shared__ Cand red_g[2][32];
  // The nu rule's - class winners, beside the + class's in red_up / red_lo.
  __shared__ Cand red_up_n[2][32];
  __shared__ Cand red_lo_n[2][32];

  const float inf = INFINITY;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nt + 31) >> 5;

  float a[S], f[S], yv[S], kdv[S], cv[S];
  bool ok[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int slot = tid + s * nt;
    if (slot < q) {
      a[s] = alpha_in[slot];
      f[s] = f_in[slot];
      yv[s] = y_in[slot];
      kdv[s] = kd_in[slot];
      ok[s] = ok_in[slot] > 0.0f;
      y_s[slot] = yv[s];
      kd_s[slot] = kdv[s];
    } else {
      a[s] = 0.0f;
      f[s] = 0.0f;
      yv[s] = 1.0f;
      kdv[s] = 1.0f;
      ok[s] = false;
    }
    cv[s] = yv[s] > 0.0f ? k.c_pos : k.c_neg;
  }
  const int limit = *limit_p;
  __syncthreads();

  int t = 0;
  int par = 0;
  while (t < limit) {
    // ---- phase 1: b_hi / argmin over I_up, b_lo / argmax over I_low;
    // under nu, within each class (up / lo the + class's, up_n / lo_n the
    // - class's).
    Cand up{inf, INT_MAX, 0.0f, 0.0f};
    Cand lo{-inf, INT_MAX, 0.0f, 0.0f};
    Cand up_n = up, lo_n = lo;
    bool low_s[S];
    float fup[S], flo[S];  // f over I_up / I_low as this trip's selection saw it
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int slot = tid + s * nt;
      const bool pos = yv[s] > 0.0f;
      const bool in_up = ok[s] && (pos ? a[s] < cv[s] : a[s] > 0.0f);
      low_s[s] = ok[s] && (pos ? a[s] > 0.0f : a[s] < cv[s]);
      fup[s] = in_up ? f[s] : inf;
      flo[s] = low_s[s] ? f[s] : -inf;
      if (slot < q && rule == kNu) {
        // A slot offers its f only to its own class's pair; the other
        // class sees +-inf, as the JAX package's class masks do, so an
        // empty class reduces to slot 0 at +-inf.
        take_if_better<true>(up, Cand{pos ? fup[s] : inf, slot, f[s], a[s]});
        take_if_better<false>(lo, Cand{pos ? flo[s] : -inf, slot, f[s], a[s]});
        take_if_better<true>(up_n, Cand{pos ? inf : fup[s], slot, f[s], a[s]});
        take_if_better<false>(lo_n, Cand{pos ? -inf : flo[s], slot, f[s], a[s]});
      } else if (slot < q) {
        take_if_better<true>(up, Cand{fup[s], slot, f[s], a[s]});
        take_if_better<false>(lo, Cand{flo[s], slot, f[s], a[s]});
      }
    }
    if (rule == kNu) {
      block_reduce_nu(up, lo, up_n, lo_n, red_up[par], red_lo[par], red_up_n[par],
                      red_lo_n[par], lane, warp, nwarps);
      // The class with the larger violation, in float32; ties to the +
      // class (an empty class's difference is -inf).
      if (!((lo.v - up.v) >= (lo_n.v - up_n.v))) {
        up = up_n;
        lo = lo_n;
      }
    } else {
      block_reduce(up, lo, red_up[par], red_lo[par], lane, warp, nwarps);
    }
    par ^= 1;
    const float b_hi = up.v;
    const int i = up.i;
    // Same float32 expression as the JAX package: b_lo > b_hi + 2 eps.
    const bool gap_open = lo.v > b_hi + k.two_eps;
    if (!gap_open) break;  // uniform: every thread reduced the same data

    const float* row_i = kb + (size_t)i * q;
    float ri[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int slot = tid + s * nt;
      ri[s] = slot < q ? row_i[slot] : 0.0f;
    }
    Cand jc = lo;  // mvp and nu partner: the (class's) max violator
    if (rule == kSecondOrder) {
      // ---- phase 2: WSS2 partner j by max (f_j - b_hi)^2 / eta_ij.
      const float kd_i = kd_s[i];
      Cand g{-inf, INT_MAX, 0.0f, 0.0f};
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int slot = tid + s * nt;
        if (slot < q) {
          const float diff = f[s] - b_hi;
          const float eta_j = fmaxf((kd_i + kdv[s]) - 2.0f * ri[s], k.tau);
          const float gain = (low_s[s] && diff > 0.0f) ? (diff * diff) / eta_j : -inf;
          take_if_better<false>(g, Cand{gain, slot, f[s], a[s]});
        }
      }
      g = warp_reduce<false>(g);
      if (lane == 0) red_g[par][warp] = g;
      __syncthreads();
      g = red_g[par][0];
      for (int w = 1; w < nwarps; ++w) take_if_better<false>(g, red_g[par][w]);
      par ^= 1;
      if (!(g.v > -inf)) {
        // No eligible partner (only reachable in budget mode, whose eps
        // keeps the gap open): a counted no-op trip, as in the JAX rule.
        ++t;
        continue;
      }
      jc = g;
    }
    const int j = jc.i;
    const float b_lo = jc.f;
    const float* row_j = kb + (size_t)j * q;
    float rj[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int slot = tid + s * nt;
      rj[s] = slot < q ? row_j[slot] : 0.0f;
    }
    const float k_ij = row_i[j];

    // ---- pair_alpha_update, redundantly in every thread.
    const float y_i = y_s[i], y_j = y_s[j];
    const float a_i_old = up.a, a_j_old = jc.a;
    const float eta = fmaxf((kd_s[i] + kd_s[j]) - 2.0f * k_ij, k.tau);
    float ai, aj;
    pair_update(k, a_i_old, a_j_old, y_i, y_j, b_hi, b_lo, eta, true, ai, aj);
    const float di = (ai - a_i_old) * y_i;
    const float dj = (aj - a_j_old) * y_j;
    bool excl[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int slot = tid + s * nt;
      if (slot == i) a[s] = ai;
      if (slot == j) a[s] = aj;  // j written last, as in the JAX rule
      excl[s] = slot == i || slot == j;
      // Two fused multiply-adds, as XLA contracts the JAX package's
      // f + (da_i y_i) row_i + (da_j y_j) row_j on the CPU.
      f[s] = __fmaf_rn(dj, rj[s], __fmaf_rn(di, ri[s], f[s]));
    }
    ++t;

    // ---- pair_batch - 1 further pairs (rule mvp): ranked by the trip's
    // pre-update f with the earlier pairs' slots excluded, updated from
    // the current f. An empty stale set reduces to slot 0 (every value
    // +-inf, lowest slot wins), which is then excluded too, as the JAX
    // package's argmin / argmax over an all-inf vector gives 0.
    for (int e = 1; e < pair_batch; ++e) {
      Cand up2{inf, INT_MAX, 0.0f, 0.0f};
      Cand lo2{-inf, INT_MAX, 0.0f, 0.0f};
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int slot = tid + s * nt;
        if (excl[s]) {
          fup[s] = inf;
          flo[s] = -inf;
        }
        if (slot < q) {
          take_if_better<true>(up2, Cand{fup[s], slot, f[s], a[s]});
          take_if_better<false>(lo2, Cand{flo[s], slot, f[s], a[s]});
        }
      }
      block_reduce(up2, lo2, red_up[par], red_lo[par], lane, warp, nwarps);
      par ^= 1;
      const int i2 = up2.i, j2 = lo2.i;
      const float* row_i2 = kb + (size_t)i2 * q;
      const float* row_j2 = kb + (size_t)j2 * q;
      const float b_hi2 = up2.f, b_lo2 = lo2.f;  // corrected: the current f
      const float y_i2 = y_s[i2], y_j2 = y_s[j2];
      const float eta2 = fmaxf((kd_s[i2] + kd_s[j2]) - 2.0f * row_i2[j2], k.tau);
      const bool cnt2 = t < limit;
      const bool upd2 = cnt2 && up2.v < inf && lo2.v > -inf && b_lo2 > b_hi2;
      float ai2, aj2;
      pair_update(k, up2.a, lo2.a, y_i2, y_j2, b_hi2, b_lo2, eta2, upd2, ai2, aj2);
      const float di2 = (ai2 - up2.a) * y_i2;
      const float dj2 = (aj2 - lo2.a) * y_j2;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int slot = tid + s * nt;
        const float r_i = slot < q ? row_i2[slot] : 0.0f;
        const float r_j = slot < q ? row_j2[slot] : 0.0f;
        if (slot == i2) a[s] = ai2;
        if (slot == j2) a[s] = aj2;
        excl[s] = excl[s] || slot == i2 || slot == j2;
        f[s] = __fmaf_rn(dj2, r_j, __fmaf_rn(di2, r_i, f[s]));
      }
      if (cnt2) ++t;
    }
  }

#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int slot = tid + s * nt;
    if (slot < q) alpha_out[slot] = a[s];
  }
  if (tid == 0) *t_out = t;
}

}  // namespace

extern "C" int dpsvm_subproblem(const float* kb, const float* alpha, const float* y,
                                const float* f, const float* kd, const float* ok,
                                const int* limit, float* alpha_out, int* t_out, int q,
                                int rule, int pair_batch, float c_pos, float c_neg, float snap_pos,
                                float snap_neg, float cms_pos, float cms_neg,
                                float two_eps, float tau, void* stream) {
  if (q < 1 || q > 4096 || (rule != kMvp && rule != kSecondOrder && rule != kNu) ||
      (pair_batch != 1 && pair_batch != 2 && pair_batch != 4) ||
      (pair_batch > 1 && rule != kMvp)) {
    return (int)cudaErrorInvalidValue;
  }
  const BoxConsts k{c_pos, c_neg, snap_pos, snap_neg, cms_pos, cms_neg, two_eps, tau};
  const int nt = q < 1024 ? ((q + 31) / 32) * 32 : 1024;
  const int slots = (q + nt - 1) / nt;
  const size_t shm = 2 * (size_t)q * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (slots == 1) {
    subproblem_kernel<1><<<1, nt, shm, st>>>(kb, alpha, y, f, kd, ok, limit, alpha_out,
                                             t_out, q, rule, pair_batch, k);
  } else if (slots == 2) {
    subproblem_kernel<2><<<1, nt, shm, st>>>(kb, alpha, y, f, kd, ok, limit, alpha_out,
                                             t_out, q, rule, pair_batch, k);
  } else {
    subproblem_kernel<4><<<1, nt, shm, st>>>(kb, alpha, y, f, kd, ok, limit, alpha_out,
                                             t_out, q, rule, pair_batch, k);
  }
  return (int)cudaGetLastError();
}
