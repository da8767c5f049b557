// Device helpers shared by the port's kernels: (value, id) reductions
// with the JAX package's tie rules, 16-byte vector access, and
// ops/kernels.py kernel_from_dots for one element.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

struct Cand {
  float v;
  int i;
};

// (value, id) reductions. Equal values keep the lowest id; of two equal
// zeros the minimum keeps -0.0 and the maximum +0.0 (IEEE minimum and
// maximum, as XLA reduces), so the result does not depend on the order
// the reduction meets the elements in.
__device__ __forceinline__ void take_min(Cand& c, float v, int i) {
  if (v < c.v) {
    c.v = v;
    c.i = i;
  } else if (v == c.v) {
    if (i < c.i) c.i = i;
    if (signbit(v)) c.v = v;
  }
}

__device__ __forceinline__ void take_max(Cand& c, float v, int i) {
  if (v > c.v) {
    c.v = v;
    c.i = i;
  } else if (v == c.v) {
    if (i < c.i) c.i = i;
    if (!signbit(v)) c.v = v;
  }
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
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

}  // namespace
