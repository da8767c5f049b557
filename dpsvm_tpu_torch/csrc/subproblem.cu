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
// cannot avoid is the serial chain of dependent reductions, row reads and
// the scalar update, one trip after another, with a data-dependent exit.
// tools/b1_trip_clocks.py splits a trip's cycles by phase; the design
// follows what it measured:
//
// - Short reductions. The launch plan (ops/subproblem.py subproblem_plan)
//   gives one slot a thread up to q = 256, then 2 slots a thread up to
//   q = 2048 and 4 beyond (slots tid + s * blockDim): past 8 warps, fewer
//   warps to reduce over pay for the second slot. Each slot's I_up / I_low
//   tests are one compare of y alpha against thresholds fixed at the
//   start, branch-free. A warp's winner is one redux.sync on a
//   32-bit orderable key of the value (-0.0 keyed as +0.0, so equal
//   values tie), a ballot whose lowest lane holding the best key holds
//   the lowest slot (with several slots a thread a second redux.sync
//   finds the slot), and shuffles of that lane's record (value, slot, f,
//   alpha). Lane 0 posts the warp's record to shared memory; after one
//   barrier every warp reduces the posted records the same way, one
//   record a lane. Records are double-buffered by parity, so a reduction
//   needs no second barrier. Every thread ends with the same pair, runs
//   the scalar update redundantly and leaves the loop with the others.
//   Under nu the + and - classes' extrema ride the same barrier (four
//   sides instead of two).
// - The Gram block on chip where it fits. The first `nchip` rows of
//   K(W, W) (all rows up to q = 236; 216 of 256 at q = 256) are brought
//   into shared memory by one bulk asynchronous copy (cp.async.bulk,
//   completing on an mbarrier) at the start of the launch. Until the
//   mbarrier reports it landed, and for rows past nchip, rows come from
//   global memory through L2: both hold the same bits, so the source
//   changes no value.
// - One round trip for the rows. The rule is a template parameter, so
//   under mvp and nu, where the pair (i, j) comes out of one reduction,
//   row i, row j and k_ij are issued together.
//
// Why not the alternatives (measured, PERF.md section 6): a 2-CTA cluster
// holding all 256 rows' columns at q = 256 pays more a trip for its
// cluster barrier and remote posts than the L2 round trip it saves; one
// warp of 4 or 8 slots a lane needs no barrier, but its per-slot work
// costs more than the barrier and the records; and a thread reducing
// every posted record itself pays a dependent shared-memory read a
// record.
//
// `limit` and the pair count stay on the device, so a round needs no host
// sync before the launch.
//
// Numerics: built with -fmad=false and IEEE division so every expression
// rounds per operation in the JAX package's order (solver/smo.py
// pair_alpha_update, solver/block.py _solve_subproblem), except the f_W
// update, which is two explicit fused multiply-adds: XLA on the CPU
// contracts that expression, and the reference's trajectory follows it.
// The snap constants arrive precomputed from the host exactly as the JAX
// package rounds them. Where operands come from and how the extrema are
// reduced changes no value: the (value, slot) order is total.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMvp = 0;
constexpr int kSecondOrder = 1;
constexpr int kNu = 2;

// Shared-memory layout (ops/subproblem.py _HEAD_BYTES): the mbarrier, then
// the records [parity][side][warp], then K's first nchip rows, y, kd.
constexpr int kSides = 5;  // up, lo, up of the - class, lo of the - class, gain
constexpr int kMaxWarps = 32;
constexpr int kHeadBytes = 16 + 2 * kSides * kMaxWarps * 16;
enum Side { kUp = 0, kLo = 1, kUpN = 2, kLoN = 3, kGain = 4 };

struct BoxConsts {
  float c_pos, c_neg;        // box upper bounds per class
  float snap_pos, snap_neg;  // 1e-6 * C, rounded as the reference rounds it
  float cms_pos, cms_neg;    // C - snap
  float two_eps;             // 2 * eps in float32
  float tau;                 // eta clamp
};

// A candidate: the value it is ranked by, its slot, and f and alpha there.
struct __align__(16) Rec {
  float v;
  int i;
  float f;
  float a;
};

// Unsigned order of the key = float order of the value; -0.0 keys as +0.0
// so that equal values tie and the slot decides.
__device__ __forceinline__ unsigned key_of(float v) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The record no slot beats: +inf (min) or -inf (max) at slot INT_MAX.
template <bool kMin>
__device__ __forceinline__ Rec empty_rec() {
  return Rec{kMin ? INFINITY : -INFINITY, INT_MAX, 0.0f, 0.0f};
}

// A lane's best of its S slots. Slots increase with s, and a slot past q
// ranks +-inf (its thresholds keep it out of I_up and I_low), so it never
// beats a real slot: ties keep the left, lower slot.
template <bool kMin, int S>
__device__ __forceinline__ Rec lane_best(const float (&v)[S], const float (&f)[S],
                                         const float (&a)[S], int tid, int nt) {
  Rec r[S];
#pragma unroll
  for (int s = 0; s < S; ++s) r[s] = Rec{v[s], tid + s * nt, f[s], a[s]};
#pragma unroll
  for (int w = 1; w < S; w *= 2) {
#pragma unroll
    for (int s = 0; s + w < S; s += 2 * w) {
      if (kMin ? r[s + w].v < r[s].v : r[s + w].v > r[s].v) r[s] = r[s + w];
    }
  }
  return r[0];
}

// The warp's best record, in every lane: the best key by redux.sync, then
// the lowest slot among the lanes holding it, then that lane's record.
// kByLane: the lanes' slots increase with the lane (one slot a thread, or
// the warps' records), so the lowest such lane holds the lowest slot; else
// a second redux.sync finds the slot.
template <bool kMin, bool kByLane>
__device__ __forceinline__ Rec warp_best(const Rec& c) {
  const unsigned key = key_of(c.v);
  const unsigned best = kMin ? __reduce_min_sync(0xffffffffu, key)
                             : __reduce_max_sync(0xffffffffu, key);
  int src;
  if constexpr (kByLane) {
    src = __ffs(__ballot_sync(0xffffffffu, key == best)) - 1;
  } else {
    const unsigned win =
        __reduce_min_sync(0xffffffffu, key == best ? (unsigned)c.i : 0xffffffffu);
    src = __ffs(__ballot_sync(0xffffffffu, key == best && (unsigned)c.i == win)) - 1;
  }
  Rec w;
  w.v = __shfl_sync(0xffffffffu, c.v, src);
  w.i = __shfl_sync(0xffffffffu, c.i, src);
  w.f = __shfl_sync(0xffffffffu, c.f, src);
  w.a = __shfl_sync(0xffffffffu, c.a, src);
  return w;
}

// The block's best of S slots a thread: the lane's, then the warp's; with
// several warps each warp's winner (the same in all its lanes) is posted by
// lane 0 as record `warp` of `recs` for gather() after the caller's
// barrier, which reduces the records one a lane. With one slot a thread a
// lower warp holds lower slots, so records too reduce by lane.
template <bool kMin, int S>
__device__ __forceinline__ Rec block_cand(const float (&v)[S], const float (&f)[S],
                                          const float (&a)[S], int tid, int nt) {
  return warp_best<kMin, S == 1>(lane_best<kMin, S>(v, f, a, tid, nt));
}
__device__ __forceinline__ void post(const Rec& w, Rec* recs, int lane, int warp) {
  if (lane == 0) recs[warp] = w;
}
template <bool kMin, int S>
__device__ __forceinline__ Rec gather(const Rec* recs, int nwarps, int lane) {
  return warp_best<kMin, S == 1>(lane < nwarps ? recs[lane] : empty_rec<kMin>());
}

// Row r of K(W, W): in shared memory when it is on chip and has landed,
// else in global memory (the same bits).
__device__ __forceinline__ const float* gram_row_ptr(const float* kb, const float* k_s, bool chip,
                                                     int r, int q) {
  return (chip ? k_s : kb) + (size_t)r * q;
}
// A slot past q reads the last column: its f is never ranked.
template <int S>
__device__ __forceinline__ void gram_row(const float* row, int q, int tid, int nt,
                                         float (&out)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) out[s] = row[min(tid + s * nt, q - 1)];
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

// Whether phase 0 of the mbarrier has completed (acquire: the bulk copy's
// bytes are then visible to this thread).
__device__ __forceinline__ bool landed(uint64_t* bar) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], 0;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(smem_addr(bar))
      : "memory");
  return done != 0;
}

template <int kRule, int S>
__global__ void __launch_bounds__(1024, 1)
subproblem_kernel(const float* __restrict__ kb, const float* __restrict__ alpha_in,
                  const float* __restrict__ y_in, const float* __restrict__ f_in,
                  const float* __restrict__ kd_in, const float* __restrict__ ok_in,
                  const int* __restrict__ limit_p, float* __restrict__ alpha_out,
                  int* __restrict__ t_out, int q, int nchip, int pair_batch, BoxConsts k) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  Rec* red = reinterpret_cast<Rec*>(smem + 16);  // [2][kSides][kMaxWarps]
  float* k_s = reinterpret_cast<float*>(smem + kHeadBytes);  // K(W, W) rows [0, nchip)
  float* y_s = k_s + (size_t)nchip * q;
  float* kd_s = y_s + q;

  const float inf = INFINITY;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;

  // The first nchip rows of K(W, W) in one bulk copy (the plan makes their
  // bytes a multiple of 16 and kb 16-byte aligned), landing while the
  // first trips run from L2.
  if (nchip > 0 && tid == 0) {
    const unsigned bytes = (unsigned)nchip * q * 4u;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
            "r"(smem_addr(k_s)),
        "l"(kb), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  }
  for (int e = tid; e < q; e += nt) {
    y_s[e] = y_in[e];
    kd_s[e] = kd_in[e];
  }
  // Per slot, y a < up_thr is alpha's I_up test and y a > lo_thr its I_low
  // test (y = +-1, so y a is exact): + class a < C and a > 0, - class
  // a > 0 and a < C; a dead or padding slot gets thresholds no value
  // passes. Branch-free, so several slots a thread stay predicated.
  float a[S], f[S], yv[S], kdv[S], up_thr[S], lo_thr[S];
  bool own[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int slot = tid + s * nt;
    own[s] = slot < q;
    const bool ok = own[s] && ok_in[slot] > 0.0f;
    a[s] = own[s] ? alpha_in[slot] : 0.0f;
    f[s] = own[s] ? f_in[slot] : 0.0f;
    yv[s] = own[s] ? y_in[slot] : 1.0f;
    kdv[s] = own[s] ? kd_in[slot] : 1.0f;
    const bool pos = yv[s] > 0.0f;
    up_thr[s] = ok ? (pos ? k.c_pos : 0.0f) : -inf;
    lo_thr[s] = ok ? (pos ? 0.0f : -k.c_neg) : inf;
  }
  const int limit = *limit_p;
  __syncthreads();  // y_s, kd_s and the mbarrier's initialisation

  bool ready = false;  // rows [0, nchip) have landed in shared memory
  int t = 0;
  int par = 0;
  while (t < limit) {
    if (nchip > 0 && !ready) ready = landed(bar);
    Rec* rb = red + par * kSides * kMaxWarps;
    // ---- phase 1: b_hi / argmin over I_up, b_lo / argmax over I_low;
    // under nu, within each class (up / lo the + class's, up_n / lo_n the
    // - class's).
    bool low_s[S];
    float fup[S], flo[S];  // f over I_up / I_low as this trip's selection saw it
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float ya = yv[s] * a[s];
      low_s[s] = ya > lo_thr[s];
      fup[s] = ya < up_thr[s] ? f[s] : inf;
      flo[s] = low_s[s] ? f[s] : -inf;
    }
    Rec up, lo, up_n, lo_n;
    if constexpr (kRule == kNu) {
      // A slot offers its f only to its own class's pair; the other
      // class sees +-inf, as the JAX package's class masks do, so an
      // empty class reduces to slot 0 at +-inf.
      float v_up[S], v_lo[S], v_up_n[S], v_lo_n[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const bool pos = yv[s] > 0.0f;
        v_up[s] = pos ? fup[s] : inf;
        v_lo[s] = pos ? flo[s] : -inf;
        v_up_n[s] = pos ? inf : fup[s];
        v_lo_n[s] = pos ? -inf : flo[s];
      }
      up = block_cand<true, S>(v_up, f, a, tid, nt);
      lo = block_cand<false, S>(v_lo, f, a, tid, nt);
      up_n = block_cand<true, S>(v_up_n, f, a, tid, nt);
      lo_n = block_cand<false, S>(v_lo_n, f, a, tid, nt);
      if (nwarps > 1) {
        post(up, rb + kUp * kMaxWarps, lane, warp);
        post(lo, rb + kLo * kMaxWarps, lane, warp);
        post(up_n, rb + kUpN * kMaxWarps, lane, warp);
        post(lo_n, rb + kLoN * kMaxWarps, lane, warp);
        __syncthreads();
        up = gather<true, S>(rb + kUp * kMaxWarps, nwarps, lane);
        lo = gather<false, S>(rb + kLo * kMaxWarps, nwarps, lane);
        up_n = gather<true, S>(rb + kUpN * kMaxWarps, nwarps, lane);
        lo_n = gather<false, S>(rb + kLoN * kMaxWarps, nwarps, lane);
        par ^= 1;
      }
      // The class with the larger violation, in float32; ties to the +
      // class (an empty class's difference is -inf).
      if (!((lo.v - up.v) >= (lo_n.v - up_n.v))) {
        up = up_n;
        lo = lo_n;
      }
    } else {
      up = block_cand<true, S>(fup, f, a, tid, nt);
      lo = block_cand<false, S>(flo, f, a, tid, nt);
      if (nwarps > 1) {
        post(up, rb + kUp * kMaxWarps, lane, warp);
        post(lo, rb + kLo * kMaxWarps, lane, warp);
        __syncthreads();
        up = gather<true, S>(rb + kUp * kMaxWarps, nwarps, lane);
        lo = gather<false, S>(rb + kLo * kMaxWarps, nwarps, lane);
        par ^= 1;
      }
    }
    const float b_hi = up.v;
    const int i = up.i;
    // Same float32 expression as the JAX package: b_lo > b_hi + 2 eps.
    const bool gap_open = lo.v > b_hi + k.two_eps;
    if (!gap_open) break;  // uniform: every thread reduced the same data

    const float* row_i = gram_row_ptr(kb, k_s, ready && i < nchip, i, q);
    float ri[S], rj[S];
    Rec jc = lo;  // mvp and nu partner: the (class's) max violator
    if constexpr (kRule == kSecondOrder) {
      gram_row<S>(row_i, q, tid, nt, ri);
      // ---- phase 2: WSS2 partner j by max (f_j - b_hi)^2 / eta_ij.
      const float kd_i = kd_s[i];
      float gain[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float diff = f[s] - b_hi;
        const float eta_j = fmaxf((kd_i + kdv[s]) - 2.0f * ri[s], k.tau);
        gain[s] = (low_s[s] && diff > 0.0f) ? (diff * diff) / eta_j : -inf;
      }
      jc = block_cand<false, S>(gain, f, a, tid, nt);
      if (nwarps > 1) {
        Rec* rg = red + par * kSides * kMaxWarps + kGain * kMaxWarps;
        post(jc, rg, lane, warp);
        __syncthreads();
        jc = gather<false, S>(rg, nwarps, lane);
        par ^= 1;
      }
      if (!(jc.v > -inf)) {
        // No eligible partner (only reachable in budget mode, whose eps
        // keeps the gap open): a counted no-op trip, as in the JAX rule.
        ++t;
        continue;
      }
      gram_row<S>(gram_row_ptr(kb, k_s, ready && jc.i < nchip, jc.i, q), q, tid, nt, rj);
    } else {
      // i and j are known together: row i, row j and k_ij in one round trip.
      gram_row<S>(row_i, q, tid, nt, ri);
      gram_row<S>(gram_row_ptr(kb, k_s, ready && jc.i < nchip, jc.i, q), q, tid, nt, rj);
    }
    const float k_ij = row_i[jc.i];
    const int j = jc.i;
    const float b_lo = jc.f;

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
    for (int e = 1; kRule == kMvp && e < pair_batch; ++e) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (excl[s]) {
          fup[s] = inf;
          flo[s] = -inf;
        }
      }
      Rec up2 = block_cand<true, S>(fup, f, a, tid, nt);
      Rec lo2 = block_cand<false, S>(flo, f, a, tid, nt);
      if (nwarps > 1) {
        Rec* rb2 = red + par * kSides * kMaxWarps;
        post(up2, rb2 + kUp * kMaxWarps, lane, warp);
        post(lo2, rb2 + kLo * kMaxWarps, lane, warp);
        __syncthreads();
        up2 = gather<true, S>(rb2 + kUp * kMaxWarps, nwarps, lane);
        lo2 = gather<false, S>(rb2 + kLo * kMaxWarps, nwarps, lane);
        par ^= 1;
      }
      const int i2 = up2.i, j2 = lo2.i;
      const float* row_i2 = gram_row_ptr(kb, k_s, ready && i2 < nchip, i2, q);
      float ri2[S], rj2[S];
      gram_row<S>(row_i2, q, tid, nt, ri2);
      gram_row<S>(gram_row_ptr(kb, k_s, ready && j2 < nchip, j2, q), q, tid, nt, rj2);
      const float k_ij2 = row_i2[j2];
      const float b_hi2 = up2.f, b_lo2 = lo2.f;  // corrected: the current f
      const float y_i2 = y_s[i2], y_j2 = y_s[j2];
      const float eta2 = fmaxf((kd_s[i2] + kd_s[j2]) - 2.0f * k_ij2, k.tau);
      const bool cnt2 = t < limit;
      const bool upd2 = cnt2 && up2.v < inf && lo2.v > -inf && b_lo2 > b_hi2;
      float ai2, aj2;
      pair_update(k, up2.a, lo2.a, y_i2, y_j2, b_hi2, b_lo2, eta2, upd2, ai2, aj2);
      const float di2 = (ai2 - up2.a) * y_i2;
      const float dj2 = (aj2 - lo2.a) * y_j2;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int slot = tid + s * nt;
        if (slot == i2) a[s] = ai2;
        if (slot == j2) a[s] = aj2;
        excl[s] = excl[s] || slot == i2 || slot == j2;
        f[s] = __fmaf_rn(dj2, rj2[s], __fmaf_rn(di2, ri2[s], f[s]));
      }
      if (cnt2) ++t;
    }
  }

#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (own[s]) alpha_out[tid + s * nt] = a[s];
  }
  if (tid == 0) *t_out = t;
  // The bulk copy must not outlive the CTA whose shared memory it fills.
  if (nchip > 0) {
    while (!landed(bar)) {
    }
  }
}

// Shared-memory bytes of a launch: ops/subproblem.py subproblem_plan.
size_t smem_bytes(int q, int nchip) {
  return kHeadBytes + 4 * (size_t)nchip * q + 8 * (size_t)q;
}

template <int kRule, int S>
cudaError_t launch(int threads, size_t smem, cudaStream_t st, const float* kb,
                   const float* alpha, const float* y, const float* f, const float* kd,
                   const float* ok, const int* limit, float* alpha_out, int* t_out, int q,
                   int nchip, int pair_batch, BoxConsts k) {
  auto* fn = subproblem_kernel<kRule, S>;
  const cudaError_t err = allow_smem((const void*)fn);
  if (err != cudaSuccess) return err;
  fn<<<1, threads, smem, st>>>(kb, alpha, y, f, kd, ok, limit, alpha_out, t_out, q, nchip,
                               pair_batch, k);
  return cudaGetLastError();
}

template <int kRule>
cudaError_t launch_rule(int threads, int slots, size_t smem, cudaStream_t st, const float* kb,
                        const float* alpha, const float* y, const float* f, const float* kd,
                        const float* ok, const int* limit, float* alpha_out, int* t_out, int q,
                        int nchip, int pair_batch, BoxConsts k) {
#define DPSVM_LAUNCH(S) \
  launch<kRule, S>(threads, smem, st, kb, alpha, y, f, kd, ok, limit, alpha_out, t_out, q, \
                   nchip, pair_batch, k)
  switch (slots) {
    case 1: return DPSVM_LAUNCH(1);
    case 2: return DPSVM_LAUNCH(2);
    default: return DPSVM_LAUNCH(4);
  }
#undef DPSVM_LAUNCH
}

}  // namespace

// The launch plan (threads, slots, nchip, smem) is ops/subproblem.py
// subproblem_plan's; it is checked here and refused (cudaErrorInvalidValue)
// when it does not cover the q slots or the rows it puts on chip cannot be
// one 16-byte aligned bulk copy.
extern "C" int dpsvm_subproblem(const float* kb, const float* alpha, const float* y,
                                const float* f, const float* kd, const float* ok,
                                const int* limit, float* alpha_out, int* t_out, int q,
                                int rule, int pair_batch, int threads, int slots, int nchip,
                                int smem, float c_pos, float c_neg, float snap_pos,
                                float snap_neg, float cms_pos, float cms_neg, float two_eps,
                                float tau, void* stream) {
  const bool plan_ok =
      threads >= 32 && threads <= 1024 && threads % 32 == 0 &&
      (slots == 1 || slots == 2 || slots == 4) && (long)threads * slots >= q &&
      nchip >= 0 && nchip <= q && ((long)nchip * q) % 4 == 0 &&
      (nchip == 0 || reinterpret_cast<uintptr_t>(kb) % 16 == 0) &&
      (size_t)smem == smem_bytes(q, nchip) && smem <= kSmemLimit;
  if (q < 1 || q > 4096 || (rule != kMvp && rule != kSecondOrder && rule != kNu) ||
      (pair_batch != 1 && pair_batch != 2 && pair_batch != 4) ||
      (pair_batch > 1 && rule != kMvp) || !plan_ok) {
    return (int)cudaErrorInvalidValue;
  }
  const BoxConsts k{c_pos, c_neg, snap_pos, snap_neg, cms_pos, cms_neg, two_eps, tau};
  cudaStream_t st = (cudaStream_t)stream;
  if (rule == kMvp) {
    return (int)launch_rule<kMvp>(threads, slots, smem, st, kb, alpha, y, f, kd, ok, limit,
                                  alpha_out, t_out, q, nchip, pair_batch, k);
  }
  if (rule == kSecondOrder) {
    return (int)launch_rule<kSecondOrder>(threads, slots, smem, st, kb, alpha, y, f, kd, ok,
                                          limit, alpha_out, t_out, q, nchip, pair_batch, k);
  }
  return (int)launch_rule<kNu>(threads, slots, smem, st, kb, alpha, y, f, kd, ok, limit,
                               alpha_out, t_out, q, nchip, pair_batch, k);
}
