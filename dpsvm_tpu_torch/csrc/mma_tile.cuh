// A tensor-core tile product shared by kernels B4 (gather_gram.cu) and B8
// (ring.cu's fold): dots of M gathered rows against N rows, both operands
// K-major, (M rows of A) . (N rows of B)^T, accumulated in float32.
//
// Two numeric modes, picked by X's storage type T:
//
//   bf16 X: mma.sync m16n8k16 on bf16 operands with float32 accumulation.
//   Every bf16 product is exact in float32, so only the order of the sum
//   differs from a float32 sum of the same products.
//
//   float32 X: 3xTF32. Each operand is split in registers into
//   hi = cvt.rna.tf32(a) and lo = cvt.rna.tf32(a - hi), and lo.hi + hi.lo +
//   hi.hi is accumulated in float32 by mma.sync m16n8k8 tf32 (small terms
//   first). The dropped lo.lo term and the rounding of lo leave about
//   3 . 2^-22 |a b| a product. One-pass TF32 (hi.hi alone) keeps about
//   three digits and is not used. The MMA adds into its float32
//   accumulator without rounding to nearest: chained over all of d (3 d / 8
//   MMAs), the dots drifted far past a float32 sum's rounding on the card
//   (B8 failed its float64-fold check at d = 784, R = 2). So each stage's
//   sums start from zero and reach the running dot by one IEEE add: d / 32
//   adds a dot.
//
// Layout. A stage holds kBK = 32 depth columns of ROWS rows, row-major in
// shared memory with a padded row of Tile<T>::kLd elements (80 bytes bf16,
// 144 bytes float32): every row starts on 16 bytes, and the fragment loads
// below (32-bit, lane (g, t) reads row g column 2t or t) hit 32 distinct
// banks. A warp owns a 16 MI x 32 output sub-tile: MI x 4 MMA tiles of
// 16 x 8, 16 MI float32 accumulators a thread, acc[mi][ni][c] at row
// 16 mi + g + 8 (c / 2), column 8 ni + 2 t + (c % 2) (frag_row, frag_col).
//
// Loads. load_rows fills a stage from rows of X chosen by id (a gathered
// working-set row, a data row, or -1 for a masked row, which reads as 0).
// Where a row is a whole number of 16-byte chunks (d . sizeof(T) % 16 == 0)
// and X is 16-byte aligned, each chunk is one cp.async (zero-filled past d
// or for a masked row: the K tail, 784 = 24 x 32 + 16, needs no extra pass),
// so the copy of stage k+1 runs under the MMAs of stage k. Otherwise (a row
// of d = 37 bf16 is 74 bytes) every element is loaded and stored by a
// thread: the element path, in the same kernel.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBK = 32;  // depth of one shared-memory stage
constexpr int kWN = 32;  // columns of a warp's sub-tile (its rows: 16 MI)

template <typename T>
struct Tile;

template <>
struct Tile<__nv_bfloat16> {
  using S = __nv_bfloat16;  // element type in shared memory
  static constexpr int kLd = kBK + 8;
};

template <>
struct Tile<float> {
  using S = float;
  static constexpr int kLd = kBK + 4;
};

__device__ __forceinline__ int frag_row(int mi, int c) {
  return 16 * mi + ((threadIdx.x & 31) >> 2) + 8 * (c >> 1);
}
__device__ __forceinline__ int frag_col(int ni, int c) {
  return 8 * ni + 2 * (threadIdx.x & 3) + (c & 1);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16*) {
  return __ushort_as_bfloat16((unsigned short)0);
}
__device__ __forceinline__ float zero_of(float*) { return 0.0f; }

// Rows [0, rows) of one stage, depth columns [k0, k0 + kBK) of X (n, d):
// stage row r is X row row_of(r), or zeros where row_of(r) < 0 or past d.
// NT threads take part. `vec`: the 16-byte path (see the note above).
template <typename T, int NT, typename RowOf>
__device__ __forceinline__ void load_rows(typename Tile<T>::S* dst, int rows, const T* x, int d,
                                          int k0, bool vec, RowOf row_of) {
  constexpr int kLd = Tile<T>::kLd;
  if (vec) {
    constexpr int kE = 16 / (int)sizeof(T);  // elements a chunk
    constexpr int kChunks = kBK / kE;        // chunks a stage row
    for (int e = threadIdx.x; e < rows * kChunks; e += NT) {
      const int r = e / kChunks, c = e % kChunks, k = k0 + c * kE;
      const int g = row_of(r);
      const bool live = g >= 0 && k < d;  // d is a multiple of kE here
      cp_async16(dst + r * kLd + c * kE, live ? x + (size_t)g * d + k : x, live ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * kBK; e += NT) {
      const int r = e / kBK, kk = e % kBK, k = k0 + kk;
      const int g = row_of(r);
      dst[r * kLd + kk] = (g >= 0 && k < d) ? x[(size_t)g * d + k] : zero_of(dst);
    }
  }
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo to about 2^-22 relative, both tf32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// One stage of a warp's 16 MI x 32 sub-tile: a, b point at the sub-tile's
// first A and B rows of the stage.
template <int MI>
__device__ __forceinline__ void warp_mma(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                         float (&acc)[MI][4][4]) {
  constexpr int kLd = Tile<__nv_bfloat16>::kLd;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int k = 0; k < kBK; k += 16) {
    uint32_t bf[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const __nv_bfloat16* p = b + (8 * ni + g) * kLd + k + 2 * t;
      bf[ni][0] = lds32(p);
      bf[ni][1] = lds32(p + 8);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const __nv_bfloat16* p = a + (16 * mi + g) * kLd + k + 2 * t;
      const uint32_t af[4] = {lds32(p), lds32(p + 8 * kLd), lds32(p + 8), lds32(p + 8 * kLd + 8)};
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af, bf[ni]);
    }
  }
}

// 3xTF32: each 16-row block's three-product sums over the stage go to a
// fresh accumulator, which is then added to the running dot by one IEEE
// float32 add (see the note at the top: the MMA's own accumulation does
// not round to nearest). The B fragments are split again for every row
// block, which keeps the live registers at 16 partial sums.
template <int MI>
__device__ __forceinline__ void warp_mma(const float* a, const float* b, float (&acc)[MI][4][4]) {
  constexpr int kLd = Tile<float>::kLd;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    float part[4][4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[ni][c] = 0.0f;
#pragma unroll
    for (int k = 0; k < kBK; k += 8) {
      const float* p = a + (16 * mi + g) * kLd + k + t;
      uint32_t ah[4], al[4];
      split_tf32(p[0], ah[0], al[0]);
      split_tf32(p[8 * kLd], ah[1], al[1]);
      split_tf32(p[4], ah[2], al[2]);
      split_tf32(p[8 * kLd + 4], ah[3], al[3]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* q = b + (8 * ni + g) * kLd + k + t;
        uint32_t bh[2], bl[2];
        split_tf32(q[0], bh[0], bl[0]);
        split_tf32(q[4], bh[1], bl[1]);
        mma_tf32(part[ni], al, bh);
        mma_tf32(part[ni], ah, bl);
        mma_tf32(part[ni], ah, bh);
      }
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] += part[ni][c];
  }
}

template <int MI>
__device__ __forceinline__ void zero_acc(float (&acc)[MI][4][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.0f;
}

}  // namespace
