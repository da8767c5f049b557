// The mesh block engines' ring exchange for Hopper (sm_90a).
//
// Replaces the TPU kernels of dpsvm_tpu/ops/ring.py:
//
//   ring_gather (_ring_gather_kernel, kernel B7): every rank's (L, lanes)
//   float32 candidate block ends in rank-id slots of every rank's
//   (P, L, lanes) output, the layout and the bits of an all_gather.
//
//   ring_fold_window (_ring_fold_kernel, kernel B8): the shard-local sync.
//   The (R q, d + 3) window [x row | x_sq | coef | pair-count lane] rides
//   a ring, and each arriving window is folded into the rank's gradient
//   inside the kernel: f += coef @ K(rows, x_loc), right neighbour first,
//   with the Kahan step of solver/smo.py kahan_add when compensated.
//
// B7 is no ring here. On the TPU the blocks travel P - 1 neighbour hops
// because ICI moves data between neighbours only; on one card every rank's
// memory is one address space, and stream order already makes every
// rank's block ready before the launch. So B7 is one ordinary launch with
// no flags, no fences and no spin: block (x, s) reads chunk x of rank s's
// block once (16-byte __ldcg where every base is aligned and the count is a
// multiple of 4 words, else word by word) and writes it into slot s of
// every rank's output. The chunks, the block size and the copy width are
// the wrapper's launch plan (ops/ring.py gather_plan), which this file
// checks. What bounds it: bytes, P blocks read and P x P written (16.2 MB
// at P = 4 with 811 KB blocks, 4.8 us at 3.35 TB/s); each thread keeps
// kGatherUnroll 16-byte loads in flight before it stores them, so one wave
// of blocks has the whole read set in flight.
//
// The rest of this note is B8's.
//
// How ranks address each other. The kernel takes, per rank, the base
// pointer of that rank's output and of its flag words (RingPtrs, passed by
// value: P entries each). A "remote copy to the left neighbour" is a store
// through the neighbour's pointer; a "receive" is a wait on the rank's own
// flag word for that slot. Nothing else is shared between ranks: no
// __syncthreads handoff, no shared memory, no grid-wide sync.
// With every pointer on one card the P ranks are logical shards of it. Ranks
// on several cards would take peer-mapped pointers and one launch a card
// over that card's ranks (not run yet: one card here, so blockIdx.y is the
// rank).
//
// Slot discipline (ops/ring.py:119-134): a rank copies its own block into
// out[my] first; at hop h it forwards out[(my + h) % P] into the SAME slot
// of rank (my - 1) % P, and the arrival of that hop lands in
// out[(my + h + 1) % P]. Each slot of each rank is written exactly once per
// call, so nothing is ever overwritten however far a sender runs ahead.
//
// Publication. A slot is cut into gridDim.x chunks, chunk b moved by block b
// of each rank, with one flag word per (rank, slot, chunk). The writer's
// threads store their part, __threadfence_system(), meet at a barrier, and
// one thread stores the flag; the reader spins on its flag (volatile),
// fences, meets at a barrier, and reads the data past L1 (__ldcg). A flag
// carries the CALL'S SEQUENCE NUMBER, not 0/1: the flag words live across
// calls and are never reset, so no reset pass can race the next call.
//
// No entry barrier. The TPU kernel's _neighbor_barrier keeps a remote write
// from landing before its target has entered the kernel, because the
// target's output is allocated by its own call. Here one host thread
// allocates every rank's output and flag words BEFORE it launches any rank,
// and the sequence number tells this call's flags from the last call's: a
// write that lands before its target has started is still a write into
// memory that exists and that nothing else touches.
//
// Co-residency. Blocks that spin on each other must all be running. One
// COOPERATIVE launch covers every rank (blockIdx.y = rank): the runtime
// starts such a grid only when all of its blocks fit on the device at once,
// whatever else runs there, and refuses a grid that never could
// (cudaErrorCooperativeLaunchTooLarge), also under a context that was given
// a share of the SMs. dpsvm_ring_max_blocks is the occupancy query the
// wrapper sizes the grid with; a block loops over its share of the work. The
// kernel uses no grid-wide sync: ranks still meet only through their flags.
// A spin that sees no flag within its trip bound prints the rank, slot and
// chunk and traps, so a lost peer is an error, never a hang. The bound is
// seconds for a copy and grows with the fold a peer may be busy with.
//
// What bounds it on this card. B8 does
// (P - 1) x 2 R q d n_loc flops per rank (72 GFLOP over four ranks at the
// headline) against 0.1 GB: operations, on the tensor cores (~73 us at
// 989 TFLOP/s with bf16 X; with float32 X the 3xTF32 product is three
// times the flops at 495 TFLOP/s, ~0.44 ms).
//
// What B8's design does about it: the fold is the tensor-core tile product
// of csrc/mma_tile.cuh (bf16 MMA for bf16 X, 3xTF32 for float32 X). A block
// of 8 warps owns 128 output rows (rows of x_loc, the B operand) and walks
// the window in passes of 128 rows (the A operand), both brought by a
// 3-stage cp.async ring. Window rows cannot be a raw cp.async of the slot:
// their stride is (d + 3) x 4 bytes and they are float32. So once a hop,
// after the slot has arrived, the rank's blocks each convert a share of it
// to X's storage type (rounding to bf16 for bf16 X, as the TPU kernel
// casts the window; exact for values a bf16 shard produced) into a
// per-rank, per-slot buffer with rows padded to 16 bytes, publish their
// share with a flag word (slots P .. 2P - 1 of the flag table), and wait
// for the rank's other blocks: one more cross-block handoff a hop, and the
// fold's tile loads are those of B4. A pass's epilogue applies
// kernel_from_dots to the accumulators, parks the 128 x 128 kernel values
// in shared memory, and one thread per output row contracts them with coef
// by an in-order chain of fused multiply-adds carried across passes, so
// the fold delta does not depend on the tiling (ROADMAP C.17). A rank
// forwards an arrived window BEFORE it folds it, so later hops' copies run
// under the fold. A block folds the same output tiles on every hop.
//
// The spin bound's fold allowance (kFoldOpsPerTrip) was sized for the
// CUDA-core fold; the tensor-core fold is faster, which only makes the
// bound looser: still seconds, still a trap and never a hang.
//
// Numerics: built with -fmad=false; the contraction uses explicit fused
// multiply-adds. The dots and the contraction sum in other orders than the
// library product of the plain version, so f' agrees with it within
// rounding only.

#include <cuda_bf16.h>
#include <stdio.h>

#include "common.cuh"
#include "mma_tile.cuh"

namespace {

constexpr int kMaxRanks = 16;
constexpr int kGatherUnroll = 4;  // ops/ring.py _GATHER_UNROLL
constexpr long long kSpinTrips = 1 << 24;  // x >= 100 ns: seconds, then trap
// A peer forwards a window only after it has folded the one before: a wait
// may last one hop's fold of all P ranks, 2 P rq d n_loc operations. Allow
// for a card that does no more than 1e11 of them a second (under a hundredth
// of what the fold reaches): 1e4 operations a trip of >= 100 ns.
constexpr long long kFoldOpsPerTrip = 10000;

struct RingPtrs {
  float* out[kMaxRanks];       // rank r's (P, count) output
  unsigned* flags[kMaxRanks];  // rank r's (P, chunks) flag words
  const float* blk[kMaxRanks]; // rank r's own (count,) block
};

struct GatherPtrs {
  float* out[kMaxRanks];        // rank r's (P, count) output
  const float* blk[kMaxRanks];  // rank r's own (count,) block
};

struct FoldPtrs {
  const void* x[kMaxRanks];     // (n_loc, d) rows, float32 or bfloat16
  const float* x_sq[kMaxRanks];
  const float* f[kMaxRanks];
  const float* err[kMaxRanks];  // null unless compensated
  float* f_out[kMaxRanks];
  float* err_out[kMaxRanks];
  void* conv[kMaxRanks];  // (P, rq, dp) windows in X's type, rows padded to 16 bytes
};

__device__ __forceinline__ void wait_flag(const unsigned* flag, unsigned seq,
                                          long long spin, int rank, int slot,
                                          int chunk) {
  const volatile unsigned* p = flag;
  long long trips = 0;
  while (*p != seq) {
    __nanosleep(100);
    if (++trips > spin) {
      printf("dpsvm ring: rank %d never received slot %d chunk %d (call %u): "
             "a peer is not running\n", rank, slot, chunk, seq);
      __trap();
    }
  }
}

// Copy words [lo, hi) of src to dst, reading past L1. `vec`: both bases are
// 16-byte aligned and lo, hi are multiples of 4.
__device__ __forceinline__ void copy_words(float* dst, const float* src, long lo,
                                           long hi, bool vec) {
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (long e = lo / 4 + threadIdx.x; e < hi / 4; e += blockDim.x) d4[e] = __ldcg(s4 + e);
  } else {
    for (long e = lo + threadIdx.x; e < hi; e += blockDim.x) dst[e] = __ldcg(src + e);
  }
}

// Make this block's stores visible everywhere, then raise the flag.
__device__ __forceinline__ void publish(unsigned* flag, unsigned seq) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) *reinterpret_cast<volatile unsigned*>(flag) = seq;
}

// The ring for block b's chunk, up to and including the send of hop 0:
// own block into out[my][my], then into the same slot of the left rank.
struct Ring {
  int my, left, P, b, chunks;
  long count, lo, hi;
  bool vec;
  unsigned seq;
  long long spin;  // trips a wait may take before it traps

  __device__ float* slot(const RingPtrs& p, int rank, int s) const {
    return p.out[rank] + (long)s * count;
  }
  __device__ unsigned* flag(const RingPtrs& p, int rank, int s, int chunk) const {
    return p.flags[rank] + (long)s * chunks + chunk;
  }
  __device__ void send(const RingPtrs& p, int s) const {
    copy_words(slot(p, left, s), slot(p, my, s), lo, hi, vec);
    publish(flag(p, left, s, b), seq);
  }
  __device__ void start(const RingPtrs& p) const {
    copy_words(slot(p, my, my), p.blk[my], lo, hi, vec);
    __syncthreads();
    send(p, my);
  }
  // Wait for this block's chunk of slot s to arrive.
  __device__ void receive(const RingPtrs& p, int s) const {
    if (threadIdx.x == 0) wait_flag(flag(p, my, s, b), seq, spin, my, s, b);
    __threadfence_system();
    __syncthreads();
  }
  // Wait for every chunk of slot s.
  __device__ void receive_all(const RingPtrs& p, int s) const {
    for (int c = threadIdx.x; c < chunks; c += blockDim.x)
      wait_flag(flag(p, my, s, c), seq, spin, my, s, c);
    __threadfence_system();
    __syncthreads();
  }
};

__device__ __forceinline__ Ring make_ring(int P, long count, bool vec, unsigned seq,
                                          long long spin) {
  Ring r;
  r.my = blockIdx.y;
  r.left = (r.my + P - 1) % P;
  r.P = P;
  r.b = blockIdx.x;
  r.chunks = gridDim.x;
  r.count = count;
  r.vec = vec;
  const long units = vec ? count / 4 : count;
  const long per = (units + r.chunks - 1) / r.chunks;
  const long scale = vec ? 4 : 1;
  const long lo = (long)r.b * per, hi = lo + per;
  r.lo = (lo < units ? lo : units) * scale;
  r.hi = (hi < units ? hi : units) * scale;
  r.seq = seq;
  r.spin = spin;
  return r;
}

// B7: block (x, s) copies units [x per, (x + 1) per) of rank s's block
// (a unit is 4 words when vec, else 1) into slot s of every rank's
// output; each thread loads kGatherUnroll units before it stores them.
__global__ void __launch_bounds__(1024)
ring_gather_kernel(GatherPtrs p, int P, long count, long units, long per, bool vec) {
  const int s = blockIdx.y;
  const long lo = (long)blockIdx.x * per;
  const long hi = lo + per < units ? lo + per : units;
  const long step = (long)blockDim.x * kGatherUnroll;
  for (long u0 = lo + threadIdx.x; u0 < hi; u0 += step) {
    if (vec) {
      const float4* src = reinterpret_cast<const float4*>(p.blk[s]);
      float4 v[kGatherUnroll];
#pragma unroll
      for (int m = 0; m < kGatherUnroll; ++m) {
        const long u = u0 + (long)m * blockDim.x;
        if (u < hi) v[m] = __ldcg(src + u);
      }
      for (int r = 0; r < P; ++r) {
        float4* dst = reinterpret_cast<float4*>(p.out[r] + (long)s * count);
#pragma unroll
        for (int m = 0; m < kGatherUnroll; ++m) {
          const long u = u0 + (long)m * blockDim.x;
          if (u < hi) dst[u] = v[m];
        }
      }
    } else {
      float v[kGatherUnroll];
#pragma unroll
      for (int m = 0; m < kGatherUnroll; ++m) {
        const long u = u0 + (long)m * blockDim.x;
        if (u < hi) v[m] = __ldcg(p.blk[s] + u);
      }
      for (int r = 0; r < P; ++r) {
        float* dst = p.out[r] + (long)s * count;
#pragma unroll
        for (int m = 0; m < kGatherUnroll; ++m) {
          const long u = u0 + (long)m * blockDim.x;
          if (u < hi) dst[u] = v[m];
        }
      }
    }
  }
}

constexpr int kFoldThreads = 256;
constexpr int kFM = 128;  // window rows a pass (the A operand)
constexpr int kFN = 128;  // output rows a tile (the B operand, rows of x_loc)
constexpr int kFoldStages = 3;
constexpr int kWM = 64;  // window rows of a warp's sub-tile (4 MMA rows)
constexpr int kLdK = kFN + 8;  // row of the parked kernel values

// A window value as X's storage type holds it, in the stage's element type:
// rounded to bf16 for bf16 X (exact for values a bf16 shard produced).
__device__ __forceinline__ __nv_bfloat16 as_stored(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float as_stored(float v, float*) { return v; }

template <typename T>
constexpr int fold_smem_bytes() {
  return kFoldStages * (kFM + kFN) * Tile<T>::kLd * (int)sizeof(typename Tile<T>::S) +
         (kFM * kLdK + 2 * kFM + kFN) * (int)sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kFoldThreads, 1)
ring_fold_kernel(RingPtrs p, FoldPtrs fp, int P, int rq, int d, int dp, int n_loc,
                 int compensated, bool vec, bool x_vec, unsigned seq, long long spin,
                 KParams kp) {
  using S = typename Tile<T>::S;
  constexpr int kLd = Tile<T>::kLd, kSt = kFoldStages;
  extern __shared__ __align__(16) unsigned char smem[];
  S* a_s = reinterpret_cast<S*>(smem);                 // kSt x kFM x kLd
  S* b_s = a_s + kSt * kFM * kLd;                      // kSt x kFN x kLd
  float* k_s = reinterpret_cast<float*>(b_s + kSt * kFN * kLd);  // kFM x kLdK
  float* coef_s = k_s + kFM * kLdK;
  float* qsq_s = coef_s + kFM;
  float* xsq_s = qsq_s + kFM;  // the tile's output rows' norms

  const int lanes = d + 3;
  const Ring r = make_ring(P, (long)rq * lanes, vec, seq, spin);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 64 window rows, 32 output rows
  const T* x = reinterpret_cast<const T*>(fp.x[r.my]);
  const float* x_sq = fp.x_sq[r.my];
  float* f_out = fp.f_out[r.my];
  float* err_out = fp.err_out[r.my];
  const int n_tiles = (n_loc + kFN - 1) / kFN;
  const int passes = (rq + kFM - 1) / kFM;
  const int nk = (d + kBK - 1) / kBK;
  // This block's output tiles, tile = r.b + i r.chunks, the same on every
  // hop: hop h + 1 reads the f_out this block wrote at hop h.
  const int my_tiles = r.b < n_tiles ? (n_tiles - 1 - r.b) / r.chunks + 1 : 0;
  const int its = my_tiles * passes * nk;  // (tile, pass, depth stage), depth fastest

  r.start(p);
  for (int h = 0; h + 1 < P; ++h) {
    const int arrived = (r.my + h + 1) % P;
    // Forward first (this block's chunk, as soon as it is here), fold after:
    // the next rank's wait runs under this rank's fold.
    r.receive(p, arrived);
    if (h + 2 < P) r.send(p, arrived);
    r.receive_all(p, arrived);
    const float* win = r.slot(p, r.my, arrived);  // (rq, d + 3), written by a peer
    const float* f_in = h == 0 ? fp.f[r.my] : f_out;
    const float* err_in = h == 0 ? fp.err[r.my] : err_out;

    // The window's rows in X's storage type, 16-byte rows zero-padded to dp,
    // into this rank's buffer for the slot: each block converts its share,
    // publishes it, and waits for the rank's other blocks, so the fold
    // loads them by cp.async like rows of X. A slot's buffer is written
    // once a call: a block still folding an earlier hop reads another.
    T* cw = reinterpret_cast<T*>(fp.conv[r.my]) + (long)arrived * rq * dp;
    {
      const long total = (long)rq * dp, per = (total + r.chunks - 1) / r.chunks;
      const long lo = (long)r.b * per, hi = lo + per < total ? lo + per : total;
      for (long e = lo + tid; e < hi; e += kFoldThreads) {
        const long row = e / dp;
        const int k = (int)(e % dp);
        cw[e] = as_stored(k < d ? __ldcg(win + row * lanes + k) : 0.0f, cw);
      }
    }
    publish(r.flag(p, r.my, P + arrived, r.b), seq);
    r.receive_all(p, P + arrived);

    auto issue = [&](int it) {  // window rows and x_loc rows of stage it
      if (it < its) {
        const int j0 = (r.b + it / nk / passes * r.chunks) * kFN;
        const int m0 = (it / nk) % passes * kFM, k0 = (it % nk) * kBK, s = it % kSt;
        load_rows<T, kFoldThreads>(a_s + s * kFM * kLd, kFM, cw, dp, k0, true,
                                   [&](int row) { return m0 + row < rq ? m0 + row : -1; });
        load_rows<T, kFoldThreads>(b_s + s * kFN * kLd, kFN, x, d, k0, x_vec,
                                   [&](int row) { return j0 + row < n_loc ? j0 + row : -1; });
      }
      cp_async_commit();
    };
    for (int it = 0; it < kSt - 1; ++it) issue(it);
    float acc[kWM / 16][4][4];
    zero_acc(acc);
    float delta = 0.0f;  // of output row j0 + tid, threads tid < kFN
    for (int it = 0; it < its; ++it) {
      cp_async_wait<kSt - 2>();
      __syncthreads();  // stage it landed; stage it - 1 is free
      issue(it + kSt - 1);
      const int item = it / nk, pass = item % passes, m0 = pass * kFM;
      const int mrows = min(kFM, rq - m0);
      const int s = it % kSt;
      if (wm * kWM < mrows)
        warp_mma(a_s + (s * kFM + wm * kWM) * kLd, b_s + (s * kFN + wn * kWN) * kLd, acc);
      if (it % nk != nk - 1) continue;

      // ---- epilogue of (tile, pass): kernel_from_dots parked in shared
      // memory, then the in-order contraction with coef.
      const int j0 = (r.b + item / passes * r.chunks) * kFN;
      static_assert(kFM + kFN <= kFoldThreads, "one value a thread");
      if (tid < kFM) {
        const int m = m0 + tid;
        qsq_s[tid] = m < rq ? __ldcg(win + (long)m * lanes + d) : 0.0f;
        coef_s[tid] = m < rq ? __ldcg(win + (long)m * lanes + d + 1) : 0.0f;
      } else if (tid < kFM + kFN) {
        const int j = j0 + tid - kFM;
        xsq_s[tid - kFM] = j < n_loc ? x_sq[j] : 0.0f;
      }
      __syncthreads();
      if (wm * kWM < mrows) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int c = 0; c < 4; c += 2) {
              const int row = wm * kWM + frag_row(mi, c), col = wn * kWN + frag_col(ni, c);
              const int jj = j0 + col;  // even; n_loc may be odd
              const float asq = qsq_s[row];
              const float v0 = jj < n_loc ? from_dot(acc[mi][ni][c], xsq_s[col], asq, kp) : 0.0f;
              const float v1 =
                  jj + 1 < n_loc ? from_dot(acc[mi][ni][c + 1], xsq_s[col + 1], asq, kp) : 0.0f;
              *reinterpret_cast<float2*>(k_s + row * kLdK + col) = make_float2(v0, v1);
            }
      }
      __syncthreads();
      if (tid < kFN) {
#pragma unroll 8
        for (int i = 0; i < mrows; ++i) delta = __fmaf_rn(coef_s[i], k_s[i * kLdK + tid], delta);
        const int j = j0 + tid;
        if (pass == passes - 1) {
          if (j < n_loc) {
            const float f0 = f_in[j];
            if (compensated) {
              // solver/smo.py kahan_add, same expression order.
              const float yv = delta - err_in[j];
              const float t = f0 + yv;
              f_out[j] = t;
              err_out[j] = (t - f0) - yv;
            } else {
              f_out[j] = f0 + delta;
            }
          }
          delta = 0.0f;
        }
      }
      zero_acc(acc);
    }
    cp_async_wait<0>();
  }
}

// Fills the pointer table; returns whether 16-byte vector copies are safe
// (count a multiple of 4 words and every base 16-byte aligned).
bool fill_ring(RingPtrs& p, int P, void* const* out, void* const* flags,
               const void* const* blk, long count) {
  unsigned long long bits = 0;
  for (int r = 0; r < P; ++r) {
    p.out[r] = (float*)out[r];
    p.flags[r] = (unsigned*)flags[r];
    p.blk[r] = (const float*)blk[r];
    bits |= (unsigned long long)out[r] | (unsigned long long)blk[r];
  }
  return count % 4 == 0 && bits % 16 == 0;
}

// Kernel `which` (1 ring_fold_window on float32 X, 2 on bfloat16 X) with the block size and dynamic shared memory it launches
// with, and the most blocks of it that run at once on the current device
// (common.cuh resident_blocks, which also raises the fold's dynamic
// shared-memory limit there: the fold takes more than the default 48 KB).
struct Launch {
  const void* fn;
  int threads, smem, blocks;
};

cudaError_t launch_of(int which, Launch* l) {
  switch (which) {
    case 1:
      *l = {(const void*)ring_fold_kernel<float>, kFoldThreads, fold_smem_bytes<float>(), 0};
      break;
    case 2:
      *l = {(const void*)ring_fold_kernel<__nv_bfloat16>, kFoldThreads,
            fold_smem_bytes<__nv_bfloat16>(), 0};
      break;
    default: return cudaErrorInvalidValue;
  }
  return resident_blocks(l->fn, l->threads, l->smem, &l->blocks);
}

// One cooperative launch of kernel `which`: `chunks` blocks for each of the
// P ranks, all of which must fit on the device at once.
cudaError_t launch_ring(int which, int chunks, int P, void** args, cudaStream_t st) {
  Launch l{};
  const cudaError_t err = launch_of(which, &l);
  if (err != cudaSuccess) return err;
  if ((long)chunks * P > l.blocks) return cudaErrorCooperativeLaunchTooLarge;
  return cudaLaunchCooperativeKernel(l.fn, dim3(chunks, P), dim3(l.threads), args, l.smem, st);
}

}  // namespace

// The most blocks of kernel `which` (see launch_of) that run at once on the
// current device with its block size and dynamic shared memory: what a
// cooperative launch of it may hold.
extern "C" int dpsvm_ring_max_blocks(int which, int* blocks) {
  Launch l{};
  const cudaError_t err = launch_of(which, &l);
  *blocks = l.blocks;
  return (int)err;
}

// out, blk: host arrays of P device pointers by rank; threads, per, chunks
// and vec are ops/ring.py gather_plan's: `chunks` blocks of `threads` for
// each of the P ranks' blocks, `per` units each, a unit 4 words when vec.
extern "C" int dpsvm_ring_gather(void* const* out, const void* const* blk, int P,
                                 long count, int threads, long per, int chunks, int vec,
                                 void* stream) {
  const long units = vec ? count / 4 : count;
  if (P < 2 || P > kMaxRanks || count < 1 || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || per < 1 || chunks < 1 || chunks > 65535 ||
      (long)chunks * per < units || (long)(chunks - 1) * per >= units ||
      (vec && count % 4 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  GatherPtrs p{};
  unsigned long long bits = 0;
  for (int r = 0; r < P; ++r) {
    p.out[r] = (float*)out[r];
    p.blk[r] = (const float*)blk[r];
    bits |= (unsigned long long)out[r] | (unsigned long long)blk[r];
  }
  if (vec && bits % 16 != 0) return (int)cudaErrorInvalidValue;
  ring_gather_kernel<<<dim3(chunks, P), threads, 0, (cudaStream_t)stream>>>(
      p, P, count, units, per, vec != 0);
  return (int)cudaGetLastError();
}

extern "C" int dpsvm_ring_fold_window(void* const* out, void* const* flags,
                                      const void* const* pend, const void* const* x,
                                      const void* const* x_sq, const void* const* f,
                                      const void* const* err, void* const* f_out,
                                      void* const* err_out, void* const* conv, int P,
                                      int rq, int d, int dp, int n_loc, int x_bf16,
                                      int compensated, int chunks,
                                      unsigned seq, int kind, float gamma, float coef0,
                                      int degree, void* stream) {
  const int esz = x_bf16 ? 2 : 4;
  if (P < 2 || P > kMaxRanks || rq < 1 || d < 1 || dp < d || (dp * esz) % 16 != 0 ||
      n_loc < 1 || chunks < 1 || chunks > kFoldThreads || kind < kRbf || kind > kSigmoid) {
    return (int)cudaErrorInvalidValue;
  }
  RingPtrs p{};
  bool vec = fill_ring(p, P, out, flags, pend, (long)rq * (d + 3));
  bool x_vec = (d * esz) % 16 == 0;  // 16-byte cp.async of x_loc rows
  FoldPtrs fp{};
  for (int r = 0; r < P; ++r) {
    x_vec = x_vec && (unsigned long long)x[r] % 16 == 0;
    fp.x[r] = x[r];
    fp.x_sq[r] = (const float*)x_sq[r];
    fp.f[r] = (const float*)f[r];
    fp.err[r] = compensated ? (const float*)err[r] : nullptr;
    fp.f_out[r] = (float*)f_out[r];
    fp.err_out[r] = compensated ? (float*)err_out[r] : nullptr;
    fp.conv[r] = conv[r];
  }
  KParams kp{kind, -gamma, gamma, coef0, degree};
  long long spin =
      kSpinTrips + 2LL * P * rq * d * (long long)n_loc / kFoldOpsPerTrip;
  void* args[] = {&p,    &fp,          &P,   &rq,    &d,   &dp,   &n_loc,
                  &compensated, &vec, &x_vec, &seq, &spin, &kp};
  return (int)launch_ring(x_bf16 ? 2 : 1, chunks, P, args, (cudaStream_t)stream);
}
