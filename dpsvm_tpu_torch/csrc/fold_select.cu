// Fused fold + per-row working-set candidates for Hopper (sm_90a).
//
// Replaces three TPU kernels that share one pass over the (R, 128)
// float32 views of the block engine's O(n) vectors (R = n_pad / 128):
//   B2  dpsvm_tpu/ops/pallas_fold_select.py fold_select
//       (_fold_select_kernel): f' = f + delta, delta read from memory;
//   B3  dpsvm_tpu/ops/pallas_fold_select.py select_rows
//       (_fold_select_kernel, fold=False): candidates from f as it
//       stands, no delta and no write-back;
//   B5  dpsvm_tpu/ops/pallas_round.py fold_rows_select
//       (_fold_rows_select_kernel): delta = coef @ K(W, row) contracted
//       inside the kernel from the (q, n_pad) kernel rows.
// Each then builds the up/low masks of the already-scattered alpha and
// emits, per 128-element row, (min f' over I_up, lowest flat id) and
// (max f' over I_low, lowest flat id) into one (4, R) buffer of 32-bit
// words: up values, up ids, low values, low ids.
//
// What bounds it on this card: bytes. B2 and B3 move 5-7 and 4 float32
// words per element and do a handful of flops each; B5 reads the
// (q, n_pad) kernel rows once (q * 4 bytes per element, ~62 MB at
// q = 256, n_pad = 60416) for 2 q flops per element, far below the
// card's ratio of flops to bytes. At the 60000-row headline B2 and B3
// move only 1-2 MB in one wave, so their bytes bound is shorter than one
// DRAM round trip: there they are latency, and at covtype scale
// (R = 3912, 8-16 MB) the bytes bound binds.
//
// B2 and B3 (fold_select_kernel, launch plan ops/fold_select.py
// fold_select_plan): one warp per row, each lane owning four consecutive
// elements, so every vector is read with one coalesced 16-byte load per
// lane (y and valid first) and f' / err' are written the same way. A
// lane keeps its best (orderable key, id) a side (common.cuh okey) and
// one flag bit a side for the sign of a zero; the warp reduces them with
// five redux.sync (the least key, the least id holding it, the flags),
// not a chain of dependent shuffles, and lanes 0-3 store the row's four
// words with one store each. No shared memory and no barrier: blocks of
// `warps` rows, as many as the rows need. A row's time goes to its
// loads' DRAM round trip, the reduction and the stores' acknowledgement
// (PERF.md section 6, from chip_smoke.py --turns stamp_split). The loads
// allocate no L1 line and prefetch 256 bytes into L2, and every launch
// is a programmatic dependent launch whose blocks wait
// (griddepcontrol.wait) for the kernel ahead before any load: the launch
// and the blocks' dispatch overlap that kernel's tail, and the kernel is
// safe behind any kernel (in an ordinary launch the wait returns at
// once).

// B5 (fold_rows_kernel, launch plan ops/round.py fold_rows_plan): one block
// per 128-column row, whose `warps` warps split the q contraction, warp w
// taking the contiguous kernel rows [w q / warps, (w + 1) q / warps). Each
// warp streams its rows' 512-byte segments into shared memory with bulk
// asynchronous copies (cp.async.bulk, lanes issuing one segment each) on
// a ring of `stages` stages of `chunk` rows, each stage completing on its
// own mbarrier, so stages x chunk x 512 bytes per warp are in flight while
// it folds the landed ones (lane l, columns 4l..4l+3, one fused
// multiply-add a term, in order k). At the headline (q 256, 472 rows)
// that is 4 warps x 3 stages x 8 rows: 48 KB in flight per block, four
// blocks on an SM, all 472 blocks resident at once. The copies mark their
// lines evict_first in L2: the rows already folded make room for the
// next, not the lines the previous kernel left dirty (their write-back
// took about a fifth of the unhinted kernel's time on the H100, PERF.md
// section 6) or rows still to be read.
// The warps' partial deltas meet in shared memory and warp 0 adds them in
// warp order (deterministic), then runs B2's epilogue on the row (its
// inputs loaded before the stream starts).
//
// Numerics: built with -fmad=false, so the fold and the Kahan step
// (solver/smo.py kahan_add: y = delta - err; t = f + y;
// err' = (t - f) - y) round per operation exactly as the plain version
// and the JAX package do; B2 and B3 are therefore bitwise equal to their
// plain versions. B5's contraction sums in another order than a GEMM, so
// its f' agrees with the plain version within rounding only; a dead slot
// (coef 0) adds an exact zero.
//
// Ties and edges: values that compare equal go to the lowest flat id,
// +0.0 and -0.0 included (okey gives both one key); the value reported
// for a +-0 tie is -0.0 on the up side and +0.0 on the low side whenever
// a member has that sign. A row with no member of a set reports +inf
// (up) / -inf (low) with the row's first flat id. NaN in f is not
// supported.
//
// Built with -DDPSVM_STAMPS (chip_smoke.py --turns), lane 0 of each row's
// warp writes %globaltimer and clock64 at five points of B2 and B3 (entry,
// loads landed, reduction done, stores issued, stores acknowledged) into
// a device array read back by dpsvm_fold_select_stamps.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kRowWarps = 8;  // B2 / B3: the most rows (warps) a block

enum Mode { kFold = 0, kSelect = 1 };

#ifdef DPSVM_STAMPS
constexpr int kStampRows = 4096;
constexpr int kStamps = 5;
// [row][stamp][globaltimer ns, clock64]
__device__ unsigned long long dpsvm_fs_stamps[kStampRows * kStamps * 2];

// Stamp k of `row` from lane 0. Both reads are predicated on `dep`, so
// they issue only once the registers it is computed from (loaded or
// reduced values) have arrived; a `dep` of 0x7fbfffff reads 0.
__device__ __forceinline__ void stamp(int row, int lane, int k, unsigned dep) {
  unsigned long long gt, clk;
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %1, 0x7fbfffff;\n @p mov.u64 %0, 0;\n"
      " @!p mov.u64 %0, %%globaltimer;\n}"
      : "=l"(gt)
      : "r"(dep)
      : "memory");
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %1, 0x7fbfffff;\n @p mov.u64 %0, 0;\n"
      " @!p mov.u64 %0, %%clock64;\n}"
      : "=l"(clk)
      : "r"(dep)
      : "memory");
  if (lane == 0 && row < kStampRows) {
    dpsvm_fs_stamps[(row * kStamps + k) * 2] = gt;
    dpsvm_fs_stamps[(row * kStamps + k) * 2 + 1] = clk;
  }
}
#define FS_STAMP(k, dep) stamp(row, lane, k, dep)
#define FS_FENCE() __threadfence()
#else
#define FS_STAMP(k, dep)
#define FS_FENCE()
#endif

// The row's inputs a lane holds: its four elements of f, alpha, y, valid
// and (compensated) err.
struct RowIn {
  float f[4], a[4], y[4], v[4], e[4];
};

// B2 / B3's loads: read once, no L1 line, a 256-byte L2 prefetch.
__device__ __forceinline__ void load_vec(float (&o)[4], const float* p) {
  unpack(load4_stream(p), o);
}

// y and valid first, then the state.
template <bool kComp>
__device__ __forceinline__ void load_hinted(RowIn& in, const float* f, const float* err,
                                            const float* alpha, const float* y,
                                            const float* valid, size_t off) {
  load_vec(in.y, y + off);
  load_vec(in.v, valid + off);
  load_vec(in.f, f + off);
  load_vec(in.a, alpha + off);
  if (kComp) load_vec(in.e, err + off);
}

// B5's loads, issued before its stream of kernel rows.
template <bool kComp>
__device__ __forceinline__ void load_row(RowIn& in, const float* f, const float* err,
                                         const float* alpha, const float* y,
                                         const float* valid, size_t off) {
  unpack(load4(y + off), in.y);
  unpack(load4(valid + off), in.v);
  unpack(load4(f + off), in.f);
  unpack(load4(alpha + off), in.a);
  if (kComp) unpack(load4(err + off), in.e);
}

// The row's four candidate words, the same in every lane of its warp:
// the least up key and the least id holding it, the least low key
// (~okey of the value) and its id, and the zero-sign flags.
struct RowBest {
  unsigned up_k, up_i, lo_k, lo_i, flags;
};

// Lane `lane` of the warp that owns a row: the masks and the lane's best
// (key, id) a side over its four elements (ids id0 .. id0 + 3, met in
// increasing order, so only a strictly smaller key replaces the best),
// then the warp's by redux.sync. fsel: the lane's four values of the
// gradient the selection sees.
__device__ __forceinline__ RowBest reduce_row(const RowIn& in, const float (&fsel)[4], int id0,
                                              float c_pos, float c_neg) {
  unsigned up_k = ~0u, up_i = 0, lo_k = ~0u, lo_i = 0, flags = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool ok = in.v[e] > 0.0f;
    const bool pos = in.y[e] > 0.0f;
    const bool in_up = ok && (pos ? in.a[e] < c_pos : in.a[e] > 0.0f);
    const bool in_low = ok && (pos ? in.a[e] > 0.0f : in.a[e] < c_neg);
    const unsigned ku = okey(in_up ? fsel[e] : INFINITY);
    const unsigned kl = ~okey(in_low ? fsel[e] : -INFINITY);
    if (ku < up_k) {
      up_k = ku;
      up_i = (unsigned)(id0 + e);
    }
    if (kl < lo_k) {
      lo_k = kl;
      lo_i = (unsigned)(id0 + e);
    }
    const unsigned bits = __float_as_uint(fsel[e]);
    flags |= (in_up && bits == 0x80000000u ? 1u : 0u) | (in_low && bits == 0u ? 2u : 0u);
  }
  const unsigned all = 0xffffffffu;
  RowBest b;
  b.up_k = __reduce_min_sync(all, up_k);
  b.lo_k = __reduce_min_sync(all, lo_k);
  b.up_i = __reduce_min_sync(all, up_k == b.up_k ? up_i : ~0u);
  b.lo_i = __reduce_min_sync(all, lo_k == b.lo_k ? lo_i : ~0u);
  b.flags = __reduce_or_sync(all, flags);
  return b;
}

// Lanes 0-3 store the row's four words into cand (4, rows): the up value
// (-0.0 when the least key is zero's and an I_up member is -0.0), its id,
// the low value (+0.0 only when an I_low member is +0.0), its id.
__device__ __forceinline__ void store_row(const RowBest& b, int lane, int row, int rows,
                                          unsigned* cand) {
  if (lane >= 4) return;
  float up = from_okey(b.up_k);
  float lo = from_okey(~b.lo_k);
  if (up == 0.0f && (b.flags & 1u)) up = -0.0f;
  if (lo == 0.0f && !(b.flags & 2u)) lo = -0.0f;
  const unsigned w = lane == 0   ? __float_as_uint(up)
                     : lane == 1 ? b.up_i
                     : lane == 2 ? __float_as_uint(lo)
                                 : b.lo_i;
  cand[(size_t)lane * rows + row] = w;
}

// The fold of a lane's four elements, f' = f + delta (the Kahan step when
// compensated), f' and err' stored; fsel gets f' less err', the values
// the selection sees.
template <bool kComp>
__device__ __forceinline__ void fold(const RowIn& in, const float (&dv)[4], size_t off,
                                     float* f_out, float* err_out, float (&fsel)[4]) {
  float fn[4];
  if (kComp) {
    float en[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float yk = dv[e] - in.e[e];
      const float t = in.f[e] + yk;
      en[e] = (t - in.f[e]) - yk;
      fn[e] = t;
      fsel[e] = t - en[e];
    }
    store4(err_out + off, en);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      fn[e] = in.f[e] + dv[e];
      fsel[e] = fn[e];
    }
  }
  store4(f_out + off, fn);
}

// B5's epilogue: the fold, then the row's candidates from f' less err'.
template <bool kComp>
__device__ __forceinline__ void fold_emit(const RowIn& in, const float (&dv)[4], size_t off,
                                          int lane, int row, int rows, float* f_out,
                                          float* err_out, float c_pos, float c_neg,
                                          unsigned* cand) {
  float fsel[4];
  fold<kComp>(in, dv, off, f_out, err_out, fsel);
  store_row(reduce_row(in, fsel, (int)off, c_pos, c_neg), lane, row, rows, cand);
}

template <int M, bool kComp>
__global__ void __launch_bounds__(kRowWarps * 32)
fold_select_kernel(const float* __restrict__ f, const float* __restrict__ err,
                   const float* __restrict__ alpha, const float* __restrict__ y,
                   const float* __restrict__ valid, const float* __restrict__ delta,
                   float* __restrict__ f_out, float* __restrict__ err_out,
                   unsigned* __restrict__ cand, int rows, float c_pos, float c_neg) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform
  FS_STAMP(0, 0u);
  const size_t off = (size_t)row * kLanes + lane * 4;
  // The kernel ahead has finished and its writes are visible.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  RowIn in;
  load_hinted<kComp>(in, f, err, alpha, y, valid, off);
  float fsel[4];
  if (M == kSelect) {
    FS_STAMP(1, __float_as_uint(in.f[3]) ^ __float_as_uint(in.a[3]) ^
                    __float_as_uint(in.y[3]) ^ __float_as_uint(in.v[3]));
#pragma unroll
    for (int e = 0; e < 4; ++e) fsel[e] = in.f[e];
  } else {
    float dv[4];
    load_vec(dv, delta + off);
    FS_STAMP(1, __float_as_uint(in.f[3]) ^ __float_as_uint(in.a[3]) ^
                    __float_as_uint(in.y[3]) ^ __float_as_uint(in.v[3]) ^
                    __float_as_uint(dv[3]) ^ (kComp ? __float_as_uint(in.e[3]) : 0u));
    fold<kComp>(in, dv, off, f_out, err_out, fsel);
  }
  const RowBest b = reduce_row(in, fsel, (int)off, c_pos, c_neg);
  FS_STAMP(2, b.up_k ^ b.up_i ^ b.lo_k ^ b.lo_i ^ b.flags);
  store_row(b, lane, row, rows, cand);
  FS_STAMP(3, 0u);
  FS_FENCE();
  FS_STAMP(4, 0u);
}

template <int M>
int launch(const float* f, const float* err, const float* alpha, const float* y,
           const float* valid, const float* delta, float* f_out, float* err_out,
           unsigned* cand, int rows, int compensated, int warps, int blocks, float c_pos,
           float c_neg, void* stream) {
  if (rows < 1 || warps < 1 || warps > kRowWarps || blocks != (rows + warps - 1) / warps) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      compensated ? cudaLaunchKernelEx(&cfg, fold_select_kernel<M, true>, f, err, alpha, y, valid,
                                       delta, f_out, err_out, cand, rows, c_pos, c_neg)
                  : cudaLaunchKernelEx(&cfg, fold_select_kernel<M, false>, f, err, alpha, y,
                                       valid, delta, f_out, err_out, cand, rows, c_pos, c_neg);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---- B5.

constexpr int kMaxQ = 8192;
constexpr int kMaxWarps = 8;
constexpr int kSegBytes = kLanes * 4;  // one kernel row's 128 columns

// B5's shared memory (ops/round.py fold_rows_smem): the ring
// [warp][stage][chunk][128] floats, the partial deltas [warp][128], the
// coefficients (q, rounded up to 16 bytes), an mbarrier per (warp, stage).
__host__ __device__ constexpr int ring_bytes(int warps, int chunk, int stages) {
  return warps * stages * chunk * kSegBytes;
}
__host__ __device__ constexpr int coef_bytes(int q) { return (q + 3) / 4 * 16; }
__host__ __device__ constexpr int rows_smem(int q, int warps, int chunk, int stages) {
  return ring_bytes(warps, chunk, stages) + warps * kSegBytes + coef_bytes(q) +
         warps * stages * 8;
}

__device__ __forceinline__ void wait_phase(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Kernel rows [k0, k0 + nr) of this block's 128 columns into `buf`,
// landing on `bar`: lane 0 sets the bytes to expect, then lane r < nr
// copies row k0 + r. The lines are marked evict_first in L2, so the rows
// already folded, and not lines the kernel has still to read or the
// previous kernel's dirty ones, make room for the next. Called by the
// whole warp.
__device__ __forceinline__ void fetch_chunk(float* buf, uint64_t* bar, const float* src,
                                            size_t ld, int k0, int nr, int lane) {
  if (lane == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
                 "r"(nr * kSegBytes)
                 : "memory");
  }
  __syncwarp();
  if (lane < nr) {
    uint64_t pol;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
        " [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(buf + lane * kLanes)),
        "l"(src + (size_t)(k0 + lane) * ld), "r"(kSegBytes), "r"(smem_addr(bar)), "l"(pol)
        : "memory");
  }
}

template <bool kComp>
__global__ void __launch_bounds__(kMaxWarps * 32, 4)
fold_rows_kernel(const float* __restrict__ k_rows, const float* __restrict__ coef,
                 const float* __restrict__ f, const float* __restrict__ err,
                 const float* __restrict__ alpha, const float* __restrict__ y,
                 const float* __restrict__ valid, float* __restrict__ f_out,
                 float* __restrict__ err_out, unsigned* __restrict__ cand, int q, int rows,
                 int chunk, int stages, float c_pos, float c_neg) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* ring = reinterpret_cast<float*>(smem);
  float* part = reinterpret_cast<float*>(smem + ring_bytes(warps, chunk, stages));
  float* coef_s = part + warps * kLanes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(coef_s) +
                                               coef_bytes(q));

  const int row = blockIdx.x;
  const size_t ld = (size_t)rows * kLanes;
  const float* src = k_rows + (size_t)row * kLanes;
  const int k_lo = warp * q / warps;
  const int k_hi = (warp + 1) * q / warps;
  const int chunks = (k_hi - k_lo + chunk - 1) / chunk;
  float* wring = ring + (size_t)warp * stages * chunk * kLanes;
  uint64_t* wbar = bars + warp * stages;

  // Each warp's own ring: its barriers, then its first `stages` chunks in
  // flight before anything else.
  if (lane == 0) {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(wbar + s)));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  for (int c = 0; c < stages && c < chunks; ++c) {
    const int k0 = k_lo + c * chunk;
    fetch_chunk(wring + (size_t)c * chunk * kLanes, wbar + c, src, ld, k0,
                min(chunk, k_hi - k0), lane);
  }
  const size_t off = (size_t)row * kLanes + lane * 4;
  RowIn in;
  if (warp == 0) load_row<kComp>(in, f, err, alpha, y, valid, off);
  for (int k = threadIdx.x; k < q; k += blockDim.x) coef_s[k] = coef[k];
  __syncthreads();  // the coefficients

  // delta over this warp's rows, in order k.
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c = 0; c < chunks; ++c) {
    const int s = c % stages;
    const int k0 = k_lo + c * chunk;
    const int nr = min(chunk, k_hi - k0);
    float* buf = wring + (size_t)s * chunk * kLanes;
    wait_phase(wbar + s, (unsigned)(c / stages) & 1u);
    for (int r = 0; r < nr; ++r) {
      const float4 kv = *reinterpret_cast<const float4*>(buf + r * kLanes + lane * 4);
      const float ck = coef_s[k0 + r];
      acc[0] = __fmaf_rn(ck, kv.x, acc[0]);
      acc[1] = __fmaf_rn(ck, kv.y, acc[1]);
      acc[2] = __fmaf_rn(ck, kv.z, acc[2]);
      acc[3] = __fmaf_rn(ck, kv.w, acc[3]);
    }
    __syncwarp();  // every lane has read the stage before it is refilled
    const int next = c + stages;
    if (next < chunks) {
      const int kn = k_lo + next * chunk;
      fetch_chunk(buf, wbar + s, src, ld, kn, min(chunk, k_hi - kn), lane);
    }
  }
  store4(part + warp * kLanes + lane * 4, acc);
  __syncthreads();
  if (warp != 0) return;

  // The warps' partials in warp order, then B2's epilogue on the row.
  float dv[4];
  unpack(*reinterpret_cast<const float4*>(part + lane * 4), dv);
  for (int w = 1; w < warps; ++w) {
    const float4 p = *reinterpret_cast<const float4*>(part + w * kLanes + lane * 4);
    dv[0] += p.x;
    dv[1] += p.y;
    dv[2] += p.z;
    dv[3] += p.w;
  }
  fold_emit<kComp>(in, dv, off, lane, row, rows, f_out, err_out, c_pos, c_neg, cand);
}

template <bool kComp>
int launch_rows(const float* k_rows, const float* coef, const float* f, const float* err,
                const float* alpha, const float* y, const float* valid, float* f_out,
                float* err_out, unsigned* cand, int q, int rows, int warps, int chunk,
                int stages, int smem, float c_pos, float c_neg, cudaStream_t st) {
  const cudaError_t e = allow_smem((const void*)fold_rows_kernel<kComp>);
  if (e != cudaSuccess) return (int)e;
  fold_rows_kernel<kComp><<<rows, warps * 32, smem, st>>>(k_rows, coef, f, err, alpha, y, valid,
                                                          f_out, err_out, cand, q, rows, chunk,
                                                          stages, c_pos, c_neg);
  return (int)cudaGetLastError();
}

}  // namespace

// The views (R, 128) float32, 16-byte aligned; cand (4, rows) 32-bit
// words; the launch plan (warps, blocks) of ops/fold_select.py
// fold_select_plan, checked here: 1 <= warps <= 8 and blocks the rows'
// ceil(rows / warps).
extern "C" int dpsvm_fold_select(const float* f, const float* err, const float* alpha,
                                 const float* y, const float* valid, const float* delta,
                                 float* f_out, float* err_out, unsigned* cand, int rows,
                                 int compensated, int warps, int blocks, float c_pos,
                                 float c_neg, void* stream) {
  return launch<kFold>(f, err, alpha, y, valid, delta, f_out, err_out, cand, rows, compensated,
                       warps, blocks, c_pos, c_neg, stream);
}

extern "C" int dpsvm_select_rows(const float* f, const float* alpha, const float* y,
                                 const float* valid, unsigned* cand, int rows, int warps,
                                 int blocks, float c_pos, float c_neg, void* stream) {
  return launch<kSelect>(f, nullptr, alpha, y, valid, nullptr, nullptr, nullptr, cand, rows, 0,
                         warps, blocks, c_pos, c_neg, stream);
}

#ifdef DPSVM_STAMPS
// The stamps of the rows below 4096 (kStampRows x 5 x 2 words), copied
// into `out` (host memory) once the device is idle.
extern "C" int dpsvm_fold_select_stamps(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, dpsvm_fs_stamps, sizeof(dpsvm_fs_stamps));
}
#endif

// k_rows (q, rows * 128) and the views 16-byte aligned; the launch plan
// (warps, chunk, stages, smem) of ops/round.py fold_rows_plan, checked
// here: 1 <= warps <= min(8, q), 1 <= chunk <= 32, stages >= 1, and smem
// the bytes of rows_smem within what a block may have.
extern "C" int dpsvm_fold_rows_select(const float* k_rows, const float* coef,
                                      const float* f, const float* err,
                                      const float* alpha, const float* y,
                                      const float* valid, float* f_out, float* err_out,
                                      unsigned* cand, int q, int rows, int compensated, int warps,
                                      int chunk, int stages, int smem, float c_pos,
                                      float c_neg, void* stream) {
  if (rows < 1 || q < 1 || q > kMaxQ || warps < 1 || warps > kMaxWarps || warps > q ||
      chunk < 1 || chunk > 32 || stages < 1 || stages > 64 ||
      smem != rows_smem(q, warps, chunk, stages) || smem > kSmemLimit) {
    return (int)cudaErrorInvalidValue;
  }
  auto* fn = compensated ? &launch_rows<true> : &launch_rows<false>;
  return fn(k_rows, coef, f, err, alpha, y, valid, f_out, err_out, cand, q, rows, warps, chunk,
            stages, smem, c_pos, c_neg, (cudaStream_t)stream);
}
