// Shared building blocks of the gram and project kernels: the fused
// kernel-function epilogue (rbf / linear / poly with the self-kernel
// normalize) that both apply to their finished dot products, and the fp32
// SIMT tile product  acc[i][j] = sum_k A[row_i, k] * B[row_j, k]  over the
// feature axis, whose only user is the project kernel (gram runs on the
// tensor cores, csrc/gram.cu).
//
// TileDot: both operands are row-major with the contraction along the row
// (the feature axis M), so one tile of each is staged through shared memory
// per step of BK features, transposed on the way in so that the inner loop
// reads consecutive addresses. Rows and features past the operand's edge
// load as zero: no operand is ever padded by the caller. Accumulation is
// IEEE fp32 (fmaf), in the same order for every output element whatever its
// position in the tile, so a row's result does not depend on how rows were
// batched.
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

// One block computes a BM x BN tile of A.B^T with NT = (BM/TM)*(BN/TN)
// threads, each holding a TM x TN register tile. Thread (tx, ty) owns rows
// ty + i*TY and columns tx + j*TX (strided, so a warp's shared-memory reads
// of B are consecutive and of A are broadcasts).
template <int BM, int BN, int BK, int TM, int TN>
struct TileDot {
  static constexpr int TX = BN / TN;
  static constexpr int TY = BM / TM;
  static constexpr int NT = TX * TY;
  static constexpr int A_SMEM = BK * (BM + 1);
  static constexpr int B_SMEM = BK * (BN + 1);

  // a: first row of the A tile (row stride m), a_rows valid rows from it;
  // b likewise. as/bs: shared scratch of A_SMEM / B_SMEM floats.
  __device__ __forceinline__ static void run(
      const float* __restrict__ a, int a_rows, const float* __restrict__ b,
      int b_rows, int m, float* as, float* bs, float (&acc)[TM][TN]) {
    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < m; k0 += BK) {
      for (int e = tid; e < BM * BK; e += NT) {
        const int r = e / BK, kk = e % BK;
        float v = 0.0f;
        if (r < a_rows && k0 + kk < m) v = a[(size_t)r * m + k0 + kk];
        as[kk * (BM + 1) + r] = v;
      }
      for (int e = tid; e < BN * BK; e += NT) {
        const int r = e / BK, kk = e % BK;
        float v = 0.0f;
        if (r < b_rows && k0 + kk < m) v = b[(size_t)r * m + k0 + kk];
        bs[kk * (BN + 1) + r] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = as[kk * (BM + 1) + ty + i * TY];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = bs[kk * (BN + 1) + tx + j * TX];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
};

}  // namespace kpca
