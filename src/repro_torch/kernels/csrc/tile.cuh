// The fused kernel-function epilogue (rbf / linear / poly with the
// self-kernel normalize) that the gram and project kernels apply to their
// finished dot products.
#pragma once

#include <cuda_runtime.h>

namespace kpca {

// Dynamic shared memory above 48 KB is an opt-in per kernel and per device:
// cudaFuncSetAttribute acts on the current device's context, so the opt-in
// is recorded per device (opted[device]: the bytes opted in so far), not
// once per process, or the first launch on a second card fails.
constexpr int kMaxDevices = 64;

template <typename F>
cudaError_t opt_in_smem(F* func, int bytes, int* opted) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && opted[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(func, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < kMaxDevices) opted[dev] = bytes;
  return e;
}

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

  // K(x, x) of a self-Gram's diagonal from the row's own a: what apply
  // gives with the exact dot x.x (rbf: d2 = 0). The tensor cores' dot of a
  // row with itself sums only positive products, so their accumulation's
  // rounding does not cancel, and a + a - 2 dot would carry it into d2.
  __device__ __forceinline__ float self_value(float a) const {
    if (kind == kRbf) return 1.0f;
    return normalize ? a / sqrtf(fmaxf(a * a, 1e-12f)) : a;
  }
};

}  // namespace kpca
