// Working-set gather + kernel rows + Gram block for Hopper (sm_90a), on the
// tensor cores.
//
// Replaces the TPU kernel dpsvm_tpu/ops/pallas_round.py gather_gram
// (_gather_gram_kernel, kernel B4): one pass over X that gathers the q
// working-set rows X[w], forms K(W, :) = kernel_from_dots(X[w] X^T) as
// (q, n) float32 kernel rows and, from the same rows, the (q, q) Gram
// block K(W, W).
//
// What bounds it on this card: at the 60000 x 784 headline (q = 256) the
// product is 24.3 GFLOP against 157 MB (bf16 X read once, the 62 MB of
// kernel rows written once). With bf16 X on the tensor cores bytes bound
// it (~47 us at 3.35 TB/s; the flops alone take ~25 us at 989 TFLOP/s).
// With float32 X the 3xTF32 product is 73 GFLOP: ~147 us at 495 TFLOP/s,
// over the bytes (252 MB, ~75 us).
//
// What the design does about it (csrc/mma_tile.cuh holds the tile
// product): a CTA of 16 warps owns kMG = 128 working-set rows (the A
// operand, rows w[m]) against one tile of kBN = 128 rows of X (the B
// operand). Warps sit 4 (M) x 4 (N), each on a 32 x 32 sub-tile (32
// accumulators a thread: 512 threads get at most 128 registers each, and
// 64 x 32 sub-tiles spilled); a warp whose rows are all past q idles. Up
// to q = 128 each X tile is read from device memory once, by one CTA: the
// TPU kernel's one pass over X. Above, the working-set rows are tiled
// across CTAs (gridDim.y = ceil(q / 128)); the groups' CTAs walk the
// same tiles at the same pace, so the second read of an X tile can hit L2.
// The gathered rows come straight from X by cp.async (no x[w] buffer is
// written); all CTAs read them, so they stay in L2. A persistent grid
// (one CTA an SM, as common.cuh resident_blocks reports for its shared
// memory; split evenly between the groups) walks the ceil(n / 128)
// data tiles and then the ceil(q / 128) Gram tiles, which take the
// gathered rows as their B operand too. Its cp.async ring (3 stages) runs
// across tile boundaries: the next tile's first stages load while this
// tile's epilogue runs. The epilogue parks the accumulators 64 rows at a
// time in shared memory, applies kernel_from_dots (common.cuh from_dot,
// same operation order) with the norms from shared memory, and writes the
// kernel rows with 16-byte stores, a warp's 32 lanes on 512 consecutive
// bytes (scalar stores where a row of the output is not a multiple of 4
// floats).
//
// Numerics: built with -fmad=false. bf16 X: exact products, float32 sums
// in the tensor core's order. float32 X: 3xTF32 (mma_tile.cuh). Kernel
// values agree with the plain version within rounding only
// (ops/round.py gram_tolerance).

#include <cuda_bf16.h>

#include <algorithm>

#include "common.cuh"
#include "mma_tile.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMI = 2;          // 16-row MMA blocks of a warp's sub-tile
constexpr int kWR = 16 * kMI;   // working-set rows of a warp's sub-tile
constexpr int kMG = 128;        // working-set rows a CTA holds
constexpr int kBN = 128;        // X rows a tile
constexpr int kWarpsN = kBN / kWN;  // warps across a tile's columns
static_assert(kThreads / 32 == (kMG / kWR) * kWarpsN, "one warp per 32 x 32 sub-tile");

constexpr int kSt = 3;          // stages of the cp.async ring
constexpr int kPass = 64;       // rows the epilogue parks at a time
constexpr int kLdE = kBN + 4;   // row of the epilogue's parking buffer

template <typename T>
constexpr int smem_bytes() {
  return kSt * (kMG + kBN) * Tile<T>::kLd * (int)sizeof(typename Tile<T>::S) +
         (kMG + 2 * kBN + kPass * kLdE) * (int)sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gather_gram_kernel(const T* __restrict__ x, const int* __restrict__ w,
                   const float* __restrict__ x_sq, const float* __restrict__ qsq,
                   float* __restrict__ k_rows, float* __restrict__ kb, int n, int d, int q,
                   int n_tiles, int tiles, bool vec, KParams kp) {
  using S = typename Tile<T>::S;
  constexpr int kLd = Tile<T>::kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  S* a_s = reinterpret_cast<S*>(smem);  // kSt x kMG x kLd
  S* b_s = a_s + kSt * kMG * kLd;       // kSt x kBN x kLd
  float* asq_s = reinterpret_cast<float*>(b_s + kSt * kBN * kLd);  // the CTA's rows' norms
  float* bsq_s = asq_s + kMG;  // 2 x kBN: the columns' norms, by tile parity
  float* e_s = bsq_s + 2 * kBN;  // kPass x kLdE: rows of dots, parked

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;  // 32-row block, 32-column block
  const int m_base = blockIdx.y * kMG;
  const int mrows = min(kMG, q - m_base);
  const int mt = (mrows + kWR - 1) / kWR;  // live 32-row blocks
  const int nk = (d + kBK - 1) / kBK;
  const int my_tiles =
      (int)blockIdx.x < tiles ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int its = my_tiles * nk;
  for (int r = tid; r < kMG; r += kThreads) asq_s[r] = r < mrows ? qsq[m_base + r] : 0.0f;

  auto a_row = [&](int r) { return r < mrows ? w[m_base + r] : -1; };
  auto issue = [&](int it) {
    if (it < its) {
      const int t = blockIdx.x + (it / nk) * gridDim.x, k0 = (it % nk) * kBK, s = it % kSt;
      const bool gram = t >= n_tiles;
      const int j0 = (gram ? t - n_tiles : t) * kBN, ncols = gram ? q : n;
      load_rows<T, kThreads>(a_s + s * kMG * kLd, mt * kWR, x, d, k0, vec, a_row);
      load_rows<T, kThreads>(b_s + s * kBN * kLd, kBN, x, d, k0, vec, [&](int r) {
        const int j = j0 + r;
        return j < ncols ? (gram ? w[j] : j) : -1;
      });
    }
    cp_async_commit();  // empty past the end: keeps the group count
  };

  float acc[kMI][4][4];
  zero_acc(acc);
  for (int it = 0; it < kSt - 1; ++it) issue(it);
  for (int it = 0; it < its; ++it) {
    const int ti = it / nk, t = blockIdx.x + ti * gridDim.x;
    const bool gram = t >= n_tiles;
    const int j0 = (gram ? t - n_tiles : t) * kBN, ncols = gram ? q : n;
    float* bsq = bsq_s + (ti & 1) * kBN;
    if (it % nk == 0) {  // read by this tile's epilogue; tile ti - 2's is done
      for (int c = tid; c < kBN; c += kThreads) {
        const int j = j0 + c;
        bsq[c] = j < ncols ? (gram ? qsq[j] : x_sq[j]) : 0.0f;
      }
    }
    cp_async_wait<kSt - 2>();
    __syncthreads();            // stage it landed; stage it - 1 is free
    issue(it + kSt - 1);
    const int s = it % kSt;
    if (wm < mt) warp_mma(a_s + (s * kMG + wm * kWR) * kLd, b_s + (s * kBN + wn * kWN) * kLd, acc);
    if (it % nk != nk - 1) continue;

    // ---- epilogue of tile t: kernel_from_dots, kPass rows at a time.
    float* out = gram ? kb : k_rows;
    const bool v4 = ncols % 4 == 0;  // rows of whole float4s
    constexpr int kWarpsPass = kPass / kWR;  // 32-row blocks a pass parks
    for (int p = 0; p * kPass < mrows; ++p) {
      if (wm / kWarpsPass == p) {
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int c = 0; c < 4; c += 2)
              *reinterpret_cast<float2*>(
                  e_s + ((wm % kWarpsPass) * kWR + frag_row(mi, c)) * kLdE + wn * kWN +
                  frag_col(ni, c)) = make_float2(acc[mi][ni][c], acc[mi][ni][c + 1]);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kPass * kBN / 4 / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int r = e / (kBN / 4), c = (e % (kBN / 4)) * 4;
        const int m = p * kPass + r, col = j0 + c;
        if (m >= mrows || col >= ncols) continue;
        const float asq = asq_s[m];
        const float4 dots = *reinterpret_cast<const float4*>(e_s + r * kLdE + c);
        float v[4] = {dots.x, dots.y, dots.z, dots.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = from_dot(v[j], bsq[c + j], asq, kp);
        float* o = out + (size_t)(m_base + m) * ncols + col;
        if (v4 && col + 3 < ncols) {
          store4(o, v);
        } else {
          for (int j = 0; j < 4 && col + j < ncols; ++j) o[j] = v[j];
        }
      }
      __syncthreads();
    }
    zero_acc(acc);
  }
  cp_async_wait<0>();
}

template <typename T>
int launch(const T* x, const int* w, const float* x_sq, const float* qsq, float* k_rows,
           float* kb, int n, int d, int q, const KParams& kp, cudaStream_t st) {
  int slots = 0;
  const cudaError_t err =
      resident_blocks((const void*)gather_gram_kernel<T>, kThreads, smem_bytes<T>(), &slots);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n + kBN - 1) / kBN;
  const int tiles = n_tiles + (q + kBN - 1) / kBN;
  const int groups = (q + kMG - 1) / kMG;
  const dim3 grid(std::min(tiles, std::max(1, slots / groups)), groups);
  const bool vec = (d * (int)sizeof(T)) % 16 == 0 && (uintptr_t)x % 16 == 0;
  gather_gram_kernel<T><<<grid, kThreads, smem_bytes<T>(), st>>>(
      x, w, x_sq, qsq, k_rows, kb, n, d, q, n_tiles, tiles, vec, kp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dpsvm_gather_gram(const void* x, int x_bf16, const int* w,
                                 const float* x_sq, const float* qsq, float* k_rows,
                                 float* kb, int n, int d, int q, int kind, float gamma,
                                 float coef0, int degree, void* stream) {
  if (n < 1 || d < 1 || q < 1 || kind < kRbf || kind > kSigmoid || q > 65535 * kMG) {
    return (int)cudaErrorInvalidValue;
  }
  const KParams kp{kind, -gamma, gamma, coef0, degree};
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16) {
    return launch((const __nv_bfloat16*)x, w, x_sq, qsq, k_rows, kb, n, d, q, kp, st);
  }
  return launch((const float*)x, w, x_sq, qsq, k_rows, kb, n, d, q, kp, st);
}
