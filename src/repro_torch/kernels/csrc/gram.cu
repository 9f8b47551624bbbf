// Batched Gram (kernel) matrix  K[z, i, j] = kfun(x[z, i], y[z, j]).
//
// Replaces the TPU kernel src/repro/kernels/gram/gram.py:gram_tiles
// (_gram_kernel): x.y^T accumulated in fp32 over the feature axis with the
// rbf / linear / poly + normalize epilogue fused in, one output write per
// tile, no distance matrix in device memory.
//
// What bounds it on an H100: 2*n*k*m fp32 operations on the CUDA cores (the
// tensor cores would need TF32, which breaks fp32 parity). At the fit's
// shapes (20 x 500 x 500 x 784, 2000 x 2000 x 784) that is 8-16x the time the
// bytes take, so the kernel is compute-bound.
// What the design does about it: each 256-thread block computes a 64 x 64
// output tile with a 4 x 4 register tile per thread (16 FMAs per pair of
// shared-memory reads), staging 16-feature slabs of both operands through
// shared memory. blockIdx.z walks a batch with explicit strides, so the
// fit's 20 per-node Grams go in one launch instead of 20. No wgmma/TMA yet.

#include "tile.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kTM = 4, kTN = 4;
using Dot = kpca::TileDot<kBM, kBN, kBK, kTM, kTN>;

__global__ void __launch_bounds__(Dot::NT)
gram_kernel(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ sx, const float* __restrict__ sy,
            const float* __restrict__ gamma, float* __restrict__ out, int n,
            int k, int m, long long x_bs, long long y_bs, long long sx_bs,
            long long sy_bs, long long out_bs, kpca::Epilogue ep) {
  __shared__ float as[Dot::A_SMEM];
  __shared__ float bs[Dot::B_SMEM];
  const long long z = blockIdx.z;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  float acc[kTM][kTN];
  Dot::run(x + z * x_bs + (size_t)row0 * m, n - row0,
           y + z * y_bs + (size_t)col0 * m, k - col0, m, as, bs, acc);

  const float g = ep.kind == kpca::kRbf ? *gamma : 0.0f;
  const int tx = threadIdx.x % Dot::TX, ty = threadIdx.x / Dot::TX;
  const float* sxz = sx + z * sx_bs;
  const float* syz = sy + z * sy_bs;
  float* outz = out + z * out_bs;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty + i * Dot::TY;
    if (r >= n) continue;
    const float a = sxz[r];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx + j * Dot::TX;
      if (c >= k) continue;
      outz[(size_t)r * k + c] = ep.apply(acc[i][j], a, syz[c], g);
    }
  }
}

}  // namespace

extern "C" int kpca_gram(const float* x, const float* y, const float* sx,
                         const float* sy, const float* gamma, float* out,
                         int batch, int n, int k, int m, long long x_bs,
                         long long y_bs, long long sx_bs, long long sy_bs,
                         long long out_bs, int kind, int degree, float coef,
                         float scale, int normalize, void* stream) {
  if (batch < 1 || n < 1 || k < 1 || m < 1 || batch > 65535 ||
      (n + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  kpca::Epilogue ep{kind, degree, coef, scale, normalize};
  dim3 grid((k + kBN - 1) / kBN, (n + kBM - 1) / kBM, batch);
  gram_kernel<<<grid, Dot::NT, 0, (cudaStream_t)stream>>>(
      x, y, sx, sy, gamma, out, n, k, m, x_bs, y_bs, sx_bs, sy_bs, out_bs, ep);
  return (int)cudaGetLastError();
}
