// The mesh block engines' ring exchange for Hopper (sm_90a).
//
// Replaces the TPU kernels of dpsvm_tpu/ops/ring.py:
//
//   ring_gather (_ring_gather_kernel, kernel B7): every rank's (L, lanes)
//   float32 candidate block travels P - 1 leftward hops; each rank ends with
//   all P blocks in rank-id slots of its (P, L, lanes) output, the layout
//   and the bits of an all_gather.
//
//   ring_fold_window (_ring_fold_kernel, kernel B8): the shard-local sync.
//   The (R q, d + 3) window [x row | x_sq | coef | pair-count lane] rides
//   the same ring, and each arriving window is folded into the rank's
//   gradient inside the kernel: f += coef @ K(rows, x_loc), right neighbour
//   first, with the Kahan step of solver/smo.py kahan_add when compensated.
//
// How ranks address each other. The kernels take, per rank, the base
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
// kernels use no grid-wide sync: ranks still meet only through their flags.
// A spin that sees no flag within its trip bound prints the rank, slot and
// chunk and traps, so a lost peer is an error, never a hang. The bound is
// seconds for a copy and grows with the fold a peer may be busy with.
//
// What bounds them on this card. B7 moves (P - 1) blocks in and out per
// rank: bytes (19 MB at P = 4 with 811 KB blocks, ~6 us). B8 does
// (P - 1) x 2 R q d n_loc flops per rank (72 GFLOP over four ranks at the
// headline) against 0.1 GB: operations, on the CUDA cores in float32
// (~1.1 ms at 67 TFLOP/s; with bf16 X on the tensor cores bytes would).
//
// What B8's design does about it: the fold is the tiled shared-memory GEMM
// of csrc/gather_gram.cu. A block owns 128 output rows at a time and walks
// the window in chunks of 64 rows: both operand tiles are staged in shared
// memory as float32 (window rows are first rounded to X's storage type, as
// the TPU kernel casts them), each thread keeps an 8 x 4 register tile, one
// fused multiply-add per term in order k. The epilogue applies
// kernel_from_dots, parks the 64 x 128 kernel values in shared memory, and
// one thread per output row contracts them with coef by an in-order chain
// of fused multiply-adds over the window rows, so the fold delta does not
// depend on the tiling. A rank forwards an arrived window BEFORE it folds
// it, so later hops' copies run under the fold. No tensor cores or TMA yet:
// right first, fast later.
//
// Numerics: built with -fmad=false; the accumulations use explicit fused
// multiply-adds. The sum order differs from the library product of the
// plain version, so f' agrees with it within rounding only.

#include <cuda_bf16.h>
#include <stdio.h>

#include "common.cuh"

namespace {

constexpr int kMaxRanks = 16;
constexpr int kThreads = 256;
constexpr long long kSpinTrips = 1 << 24;  // x >= 100 ns: seconds, then trap
// A peer forwards a window only after it has folded the one before: a wait
// may last one hop's fold of all P ranks, 2 P rq d n_loc operations. Allow
// for a card that does no more than 1e11 of them a second (about a hundredth
// of what the fold reaches): 1e4 operations a trip of >= 100 ns.
constexpr long long kFoldOpsPerTrip = 10000;

struct RingPtrs {
  float* out[kMaxRanks];       // rank r's (P, count) output
  unsigned* flags[kMaxRanks];  // rank r's (P, chunks) flag words
  const float* blk[kMaxRanks]; // rank r's own (count,) block
};

struct FoldPtrs {
  const void* x[kMaxRanks];     // (n_loc, d) rows, float32 or bfloat16
  const float* x_sq[kMaxRanks];
  const float* f[kMaxRanks];
  const float* err[kMaxRanks];  // null unless compensated
  float* f_out[kMaxRanks];
  float* err_out[kMaxRanks];
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

__global__ void __launch_bounds__(kThreads)
ring_gather_kernel(RingPtrs p, int P, long count, bool vec, unsigned seq,
                   long long spin) {
  const Ring r = make_ring(P, count, vec, seq, spin);
  r.start(p);
  for (int h = 0; h + 1 < P; ++h) {
    const int arrived = (r.my + h + 1) % P;
    r.receive(p, arrived);
    if (h + 2 < P) r.send(p, arrived);  // hop h + 1 forwards what hop h landed
  }
}

constexpr int kBM = 64;   // window rows per pass
constexpr int kBN = 128;  // output rows per tile
constexpr int kBK = 16;   // depth per shared-memory stage

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
// A window value as X's storage type holds it.
template <typename T>
__device__ __forceinline__ float as_stored(float v);
template <>
__device__ __forceinline__ float as_stored<float>(float v) { return v; }
template <>
__device__ __forceinline__ float as_stored<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_fold_kernel(RingPtrs p, FoldPtrs fp, int P, int rq, int d, int n_loc,
                 int compensated, bool vec, unsigned seq, long long spin, KParams kp) {
  __shared__ float a_s[kBK][kBM + 4];
  __shared__ float b_s[kBK][kBN + 4];
  __shared__ float k_s[kBM][kBN];
  __shared__ float coef_s[kBM];
  __shared__ float qsq_s[kBM];

  const int lanes = d + 3;
  const Ring r = make_ring(P, (long)rq * lanes, vec, seq, spin);
  const int tid = threadIdx.x;
  const int tx = tid & 31;  // columns tx, tx + 32, tx + 64, tx + 96
  const int ty = tid >> 5;  // rows 8 ty .. 8 ty + 7
  const T* x = reinterpret_cast<const T*>(fp.x[r.my]);
  const float* x_sq = fp.x_sq[r.my];
  float* f_out = fp.f_out[r.my];
  float* err_out = fp.err_out[r.my];
  const int n_tiles = (n_loc + kBN - 1) / kBN;

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

    for (int tile = r.b; tile < n_tiles; tile += r.chunks) {
      const int n0 = tile * kBN;
      float delta = 0.0f;  // of output row n0 + tid, threads tid < kBN
      for (int m0 = 0; m0 < rq; m0 += kBM) {
        if (tid < kBM) {
          const int m = m0 + tid;
          qsq_s[tid] = m < rq ? __ldcg(win + (long)m * lanes + d) : 0.0f;
          coef_s[tid] = m < rq ? __ldcg(win + (long)m * lanes + d + 1) : 0.0f;
        }
        float acc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
        for (int k0 = 0; k0 < d; k0 += kBK) {
          for (int e = tid; e < kBM * kBK; e += kThreads) {
            const int row = e / kBK, kk = e % kBK, m = m0 + row, k = k0 + kk;
            a_s[kk][row] = (m < rq && k < d)
                               ? as_stored<T>(__ldcg(win + (long)m * lanes + k))
                               : 0.0f;
          }
          for (int e = tid; e < kBN * kBK; e += kThreads) {
            const int row = e / kBK, kk = e % kBK, j = n0 + row, k = k0 + kk;
            b_s[kk][row] = (j < n_loc && k < d) ? widen(x[(long)j * d + k]) : 0.0f;
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
        // kernel_from_dots, parked for the in-order contraction.
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float asq = qsq_s[ty * 8 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = tx + 32 * j;
            const int jj = n0 + col;
            k_s[ty * 8 + i][col] =
                jj < n_loc ? from_dot(acc[i][j], x_sq[jj], asq, kp) : 0.0f;
          }
        }
        __syncthreads();
        if (tid < kBN) {
          const int mmax = rq - m0 < kBM ? rq - m0 : kBM;
          for (int i = 0; i < mmax; ++i) delta = __fmaf_rn(coef_s[i], k_s[i][tid], delta);
        }
        __syncthreads();
      }
      const int j = n0 + tid;
      if (tid < kBN && j < n_loc) {
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
    }
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

const void* kernel_of(int which) {
  switch (which) {
    case 0: return (const void*)ring_gather_kernel;
    case 1: return (const void*)ring_fold_kernel<float>;
    case 2: return (const void*)ring_fold_kernel<__nv_bfloat16>;
    default: return nullptr;
  }
}

}  // namespace

// The most blocks of kernel `which` (0 ring_gather, 1 ring_fold_window on
// float32 X, 2 on bfloat16 X) that run at once on the current device: what a
// cooperative launch of it may hold.
extern "C" int dpsvm_ring_max_blocks(int which, int* blocks) {
  const void* fn = kernel_of(which);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
  *blocks = sms * per_sm;
  return (int)err;
}

// out, flags, blk: host arrays of P device pointers by rank.
extern "C" int dpsvm_ring_gather(void* const* out, void* const* flags,
                                 const void* const* blk, int P, long count, int chunks,
                                 unsigned seq, void* stream) {
  if (P < 2 || P > kMaxRanks || count < 1 || chunks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  RingPtrs p{};
  bool vec = fill_ring(p, P, out, flags, blk, count);
  long long spin = kSpinTrips;
  void* args[] = {&p, &P, &count, &vec, &seq, &spin};
  return (int)cudaLaunchCooperativeKernel(kernel_of(0), dim3(chunks, P), dim3(kThreads),
                                          args, 0, (cudaStream_t)stream);
}

extern "C" int dpsvm_ring_fold_window(void* const* out, void* const* flags,
                                      const void* const* pend, const void* const* x,
                                      const void* const* x_sq, const void* const* f,
                                      const void* const* err, void* const* f_out,
                                      void* const* err_out, int P, int rq, int d,
                                      int n_loc, int x_bf16, int compensated, int chunks,
                                      unsigned seq, int kind, float gamma, float coef0,
                                      int degree, void* stream) {
  if (P < 2 || P > kMaxRanks || rq < 1 || d < 1 || n_loc < 1 || chunks < 1 ||
      chunks > kThreads || kind < kRbf || kind > kSigmoid) {
    return (int)cudaErrorInvalidValue;
  }
  RingPtrs p{};
  bool vec = fill_ring(p, P, out, flags, pend, (long)rq * (d + 3));
  FoldPtrs fp{};
  for (int r = 0; r < P; ++r) {
    fp.x[r] = x[r];
    fp.x_sq[r] = (const float*)x_sq[r];
    fp.f[r] = (const float*)f[r];
    fp.err[r] = compensated ? (const float*)err[r] : nullptr;
    fp.f_out[r] = (float*)f_out[r];
    fp.err_out[r] = compensated ? (float*)err_out[r] : nullptr;
  }
  KParams kp{kind, -gamma, gamma, coef0, degree};
  long long spin =
      kSpinTrips + 2LL * P * rq * d * (long long)n_loc / kFoldOpsPerTrip;
  void* args[] = {&p, &fp, &P, &rq, &d, &n_loc, &compensated, &vec, &seq, &spin, &kp};
  return (int)cudaLaunchCooperativeKernel(kernel_of(x_bf16 ? 2 : 1), dim3(chunks, P),
                                          dim3(kThreads), args, 0, (cudaStream_t)stream);
}
