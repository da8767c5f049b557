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
// (max f' over I_low, lowest flat id).
//
// What bounds it on this card: bytes. B2 and B3 move 5-7 and 4 float32
// words per element and do a handful of flops each; B5 reads the
// (q, n_pad) kernel rows once (q * 4 bytes per element, ~62 MB at
// q = 256, n_pad = 60416) for 2 q flops per element, far below the
// card's ratio of flops to bytes.
//
// What the design does about it: one warp per row, each lane owning four
// consecutive elements, so every vector is read with one coalesced
// 16-byte load per lane and f' / err' are written the same way; the row's
// extremum is a five-step warp-shuffle reduction, with no shared memory
// and no barrier. Two rows per 64-thread block keep the grid at R / 2
// blocks (236 at the 60000-row headline), well over the 132 SMs. In B5
// the coefficients sit in shared memory and each lane walks the q kernel
// rows down its four columns (each step a coalesced 512-byte warp load),
// accumulating in float32 with one fused multiply-add per term, in order
// k = 0 .. q-1.
//
// Numerics: built with -fmad=false, so the fold and the Kahan step
// (solver/smo.py kahan_add: y = delta - err; t = f + y;
// err' = (t - f) - y) round per operation exactly as the plain version
// and the JAX package do; B2 and B3 are therefore bitwise equal to their
// plain versions. B5's contraction sums in another order than a GEMM, so
// its f' agrees with the plain version within rounding only.
//
// Ties and edges: values that compare equal go to the lowest flat id,
// +0.0 and -0.0 included; the value reported for a +-0 tie is -0.0 on the
// up side and +0.0 on the low side whenever a member has that sign. A row
// with no member of a set reports +inf (up) / -inf (low) with the row's
// first flat id. NaN in f is not supported.

#include "common.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kRowsPerBlock = 2;  // one warp per row
constexpr int kThreads = kRowsPerBlock * 32;

enum Mode { kFold = 0, kSelect = 1, kRows = 2 };

template <int M, bool kComp>
__global__ void __launch_bounds__(kThreads)
fold_select_kernel(const float* __restrict__ f, const float* __restrict__ err,
                   const float* __restrict__ alpha, const float* __restrict__ y,
                   const float* __restrict__ valid, const float* __restrict__ delta,
                   const float* __restrict__ k_rows, const float* __restrict__ coef,
                   int q, float* __restrict__ f_out, float* __restrict__ err_out,
                   float* __restrict__ upv, int* __restrict__ upi,
                   float* __restrict__ lov, int* __restrict__ loi, int rows,
                   float c_pos, float c_neg) {
  extern __shared__ float coef_s[];  // kRows: the q fold coefficients
  if (M == kRows) {
    for (int k = threadIdx.x; k < q; k += blockDim.x) coef_s[k] = coef[k];
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform, after the only barrier
  const int id0 = row * kLanes + lane * 4;
  const size_t off = (size_t)id0;

  float fv[4], av[4], yv[4], vv[4], fsel[4];
  unpack(load4(f + off), fv);
  unpack(load4(alpha + off), av);
  unpack(load4(y + off), yv);
  unpack(load4(valid + off), vv);

  if (M == kSelect) {
#pragma unroll
    for (int e = 0; e < 4; ++e) fsel[e] = fv[e];
  } else {
    float dv[4];
    if (M == kFold) {
      unpack(load4(delta + off), dv);
    } else {
      // delta = coef @ K(W, these four columns), in order k = 0 .. q-1.
      dv[0] = dv[1] = dv[2] = dv[3] = 0.0f;
      const size_t ld = (size_t)rows * kLanes;
      const float* kr = k_rows + off;
#pragma unroll 8
      for (int k = 0; k < q; ++k) {
        const float4 kv = load4(kr + (size_t)k * ld);
        const float ck = coef_s[k];
        dv[0] = __fmaf_rn(ck, kv.x, dv[0]);
        dv[1] = __fmaf_rn(ck, kv.y, dv[1]);
        dv[2] = __fmaf_rn(ck, kv.z, dv[2]);
        dv[3] = __fmaf_rn(ck, kv.w, dv[3]);
      }
    }
    float fn[4];
    if (kComp) {
      float ev[4], en[4];
      unpack(load4(err + off), ev);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float yk = dv[e] - ev[e];
        const float t = fv[e] + yk;
        en[e] = (t - fv[e]) - yk;
        fn[e] = t;
        fsel[e] = t - en[e];
      }
      store4(err_out + off, en);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fn[e] = fv[e] + dv[e];
        fsel[e] = fn[e];
      }
    }
    store4(f_out + off, fn);
  }

  const float inf = INFINITY;
  Cand up{inf, INT_MAX};
  Cand lo{-inf, INT_MAX};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool ok = vv[e] > 0.0f;
    const bool pos = yv[e] > 0.0f;
    const bool in_up = ok && (pos ? av[e] < c_pos : av[e] > 0.0f);
    const bool in_low = ok && (pos ? av[e] > 0.0f : av[e] < c_neg);
    take_min(up, in_up ? fsel[e] : inf, id0 + e);
    take_max(lo, in_low ? fsel[e] : -inf, id0 + e);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float uv = __shfl_xor_sync(0xffffffffu, up.v, s);
    const int ui = __shfl_xor_sync(0xffffffffu, up.i, s);
    const float lv = __shfl_xor_sync(0xffffffffu, lo.v, s);
    const int li = __shfl_xor_sync(0xffffffffu, lo.i, s);
    take_min(up, uv, ui);
    take_max(lo, lv, li);
  }
  if (lane == 0) {
    upv[row] = up.v;
    upi[row] = up.i;
    lov[row] = lo.v;
    loi[row] = lo.i;
  }
}

template <int M>
int launch(const float* f, const float* err, const float* alpha, const float* y,
           const float* valid, const float* delta, const float* k_rows,
           const float* coef, int q, float* f_out, float* err_out, float* upv,
           int* upi, float* lov, int* loi, int rows, int compensated, float c_pos,
           float c_neg, void* stream) {
  if (rows < 1 || (M == kRows && (q < 1 || q > 8192))) {
    return (int)cudaErrorInvalidValue;
  }
  const int grid = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t shm = M == kRows ? (size_t)q * sizeof(float) : 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (compensated) {
    fold_select_kernel<M, true><<<grid, kThreads, shm, st>>>(
        f, err, alpha, y, valid, delta, k_rows, coef, q, f_out, err_out, upv, upi,
        lov, loi, rows, c_pos, c_neg);
  } else {
    fold_select_kernel<M, false><<<grid, kThreads, shm, st>>>(
        f, err, alpha, y, valid, delta, k_rows, coef, q, f_out, err_out, upv, upi,
        lov, loi, rows, c_pos, c_neg);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dpsvm_fold_select(const float* f, const float* err, const float* alpha,
                                 const float* y, const float* valid, const float* delta,
                                 float* f_out, float* err_out, float* upv, int* upi,
                                 float* lov, int* loi, int rows, int compensated,
                                 float c_pos, float c_neg, void* stream) {
  return launch<kFold>(f, err, alpha, y, valid, delta, nullptr, nullptr, 0, f_out,
                       err_out, upv, upi, lov, loi, rows, compensated, c_pos, c_neg,
                       stream);
}

extern "C" int dpsvm_select_rows(const float* f, const float* alpha, const float* y,
                                 const float* valid, float* upv, int* upi, float* lov,
                                 int* loi, int rows, float c_pos, float c_neg,
                                 void* stream) {
  return launch<kSelect>(f, nullptr, alpha, y, valid, nullptr, nullptr, nullptr, 0,
                         nullptr, nullptr, upv, upi, lov, loi, rows, 0, c_pos, c_neg,
                         stream);
}

extern "C" int dpsvm_fold_rows_select(const float* k_rows, const float* coef,
                                      const float* f, const float* err,
                                      const float* alpha, const float* y,
                                      const float* valid, float* f_out, float* err_out,
                                      float* upv, int* upi, float* lov, int* loi,
                                      int q, int rows, int compensated, float c_pos,
                                      float c_neg, void* stream) {
  return launch<kRows>(f, err, alpha, y, valid, nullptr, k_rows, coef, q, f_out,
                       err_out, upv, upi, lov, loi, rows, compensated, c_pos, c_neg,
                       stream);
}
