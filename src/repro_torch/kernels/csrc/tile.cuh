// The fused kernel-function epilogue (rbf / linear / poly with the
// self-kernel normalize) that the gram and project kernels apply to their
// finished dot products.
#pragma once

#include <cuda_runtime.h>

namespace kpca {

enum Kind : int { kRbf = 0, kLinear = 1, kPoly = 2 };

struct Epilogue {
  int kind;
  int degree;
  float coef;
  float scale;
  int normalize;

  // What the epilogue takes per row from its squared norm: the norm itself
  // (rbf) or the self-kernel K(x, x) (linear/poly).
  __device__ __forceinline__ float self_k(float sumsq) const {
    if (kind == kRbf) return sumsq;
    float v = sumsq * scale;
    if (kind == kPoly) {
      float base = v + coef, p = 1.0f;
      for (int i = 0; i < degree; ++i) p *= base;
      v = p;
    }
    return v;
  }

  // dot = x.y; a, b = squared norms (rbf) or self-kernels (linear/poly).
  __device__ __forceinline__ float apply(float dot, float a, float b,
                                         float gamma) const {
    if (kind == kRbf) {
      float d2 = fmaxf(a + b - 2.0f * dot, 0.0f);
      return expf(-gamma * d2);
    }
    float v = dot * scale;
    if (kind == kPoly) {
      float base = v + coef, p = 1.0f;
      for (int i = 0; i < degree; ++i) p *= base;
      v = p;
    }
    if (normalize) v = v / sqrtf(fmaxf(a * b, 1e-12f));
    return v;
  }
};

}  // namespace kpca
