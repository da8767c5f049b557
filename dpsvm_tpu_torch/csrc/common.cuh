// Helpers shared by the port's kernels: orderable keys of float32 values
// for (value, id) reductions with the JAX package's tie rules, 16-byte
// vector access (plain, and loads with cache hints), ops/kernels.py
// kernel_from_dots for one element, shared-memory addresses and limits,
// and the occupancy query that sizes a persistent or cooperative grid.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include <mutex>

namespace {

// f as an unsigned word in the float order, -0.0 and +0.0 on one key:
// the least key is the least value, and a (key, id) pair reduces by
// redux.sync (the least key, then the least id holding it). Kernels B2,
// B3, B5 and B6 select through it; a flag bit a side carries the sign of
// a +-0 extremum.
__device__ __forceinline__ unsigned okey(float v) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_okey(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// A read-only 16-byte load that allocates no L1 line and asks L2 to
// fetch the whole 256-byte stretch around it (data read once).
__device__ __forceinline__ float4 load4_stream(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void unpack(const float4 v, float (&o)[4]) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

enum Kind { kRbf = 0, kLinear = 1, kPoly = 2, kSigmoid = 3 };

struct KParams {
  int kind;
  float neg_gamma;  // float32(-gamma), as torch rounds the scalar
  float gamma;
  float coef0;
  int degree;
};

// ops/kernels.py kernel_from_dots for one element: `bsq` is the data
// row's squared norm, `asq` the working-set row's.
__device__ __forceinline__ float from_dot(float dot, float bsq, float asq,
                                          const KParams& kp) {
  if (kp.kind == kLinear) return dot;
  if (kp.kind == kRbf) {
    float s = bsq + asq;
    s = s - 2.0f * dot;
    s = fmaxf(s, 0.0f);
    return expf(kp.neg_gamma * s);
  }
  const float v = kp.gamma * dot + kp.coef0;
  if (kp.kind == kSigmoid) return tanhf(v);
  if (kp.degree == 1) return v;
  if (kp.degree == 2) return v * v;
  if (kp.degree == 3) return v * v * v;
  return powf(v, (float)kp.degree);
}

constexpr int kSmemLimit = 232448;  // shared memory one block may have on sm_90

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Raise kernel `fn`'s dynamic shared-memory limit to what a block may
// have, once per (kernel, device) (cudaFuncSetAttribute holds for the
// current device only).
inline cudaError_t allow_smem(const void* fn) {
  constexpr int kEntries = 64;
  static const void* fns[kEntries];
  static int devs[kEntries];
  static int used = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  for (int e = 0; e < used; ++e)
    if (fns[e] == fn && devs[e] == dev) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess && used < kEntries) {
    fns[used] = fn;
    devs[used] = dev;
    ++used;
  }
  return err;
}

// The blocks of kernel `fn`, launched with `threads` threads and `smem`
// bytes of dynamic shared memory, that run at once on the current device.
// The first call for a (kernel, device) raises the kernel's dynamic
// shared-memory limit to `smem` (needed above 48 KB; cudaFuncSetAttribute
// holds for the current device only) before it asks the occupancy query
// with `smem`; later calls read the cache. Call it before every launch of
// such a kernel, so that a launch on another device sets its attribute too.
inline cudaError_t resident_blocks(const void* fn, int threads, int smem, int* blocks) {
  struct Entry {
    const void* fn;
    int dev, blocks;
  };
  constexpr int kEntries = 64;
  static Entry cache[kEntries];
  static int used = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    if (cache[i].fn == fn && cache[i].dev == dev) {
      *blocks = cache[i].blocks;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  if (smem > 0) err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  if (used < kEntries) cache[used++] = {fn, dev, *blocks};
  return cudaSuccess;
}

}  // namespace
