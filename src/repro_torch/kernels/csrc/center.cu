// Gram-matrix centering (paper §6.1) over a batch of blocks:
//
//   out[z, i, j] = k[z, i, j] - row[z, i] - col[z, j] + tot[z]
//
// Replaces the TPU kernel src/repro/kernels/centering/centering.py:
// center_tiles (_center_kernel). As there, the row / column / total means are
// reduced by the wrapper and the kernel is one elementwise pass that reads
// each entry of K once and writes each output entry once.
//
// What bounds it on an H100: bytes. Three fp32 operations per entry against
// eight bytes moved (one read, one write), so at the fit's 2000 x 2000 block
// (32 MB) the least time is about 0.0096 ms at 3.35 TB/s.
// What the design does about it: a grid-stride loop over the flat output
// index, so neighbouring threads write neighbouring addresses and, where the
// input's column stride is 1, read neighbouring addresses too. The TPU tiles
// a contiguous 2-D block; here the input may be a strided view with two
// batch dimensions (the setup's (J, S, S, N, N) block view, whose (J, S)
// dims merge and whose last slot dim does not), so the kernel takes the
// input's four strides and the wrapper never copies it. The output is
// contiguous. No shared memory: nothing is reused.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks per SM, 132 SMs

__global__ void __launch_bounds__(kThreads)
center_kernel(const float* __restrict__ k, const float* __restrict__ row,
              const float* __restrict__ col, const float* __restrict__ tot,
              float* __restrict__ out, long long total, int z2, int n, int m,
              long long s1, long long s2, long long sn, long long sm) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(idx % m);
    const long long zi = idx / m;
    const int i = (int)(zi % n);
    const long long z = zi / n;
    const long long za = z / z2, zb = z % z2;
    const float kv = k[za * s1 + zb * s2 + i * sn + j * sm];
    out[idx] = kv - row[z * n + i] - col[z * m + j] + tot[z];
  }
}

}  // namespace

// k: z1 x z2 batch of (n, m) blocks at strides (s1, s2, sn, sm) elements;
// row (z1*z2, n), col (z1*z2, m), tot (z1*z2,) and out (z1*z2, n, m)
// contiguous.
extern "C" int kpca_center(const float* k, const float* row, const float* col,
                           const float* tot, float* out, int z1, int z2,
                           int n, int m, long long s1, long long s2,
                           long long sn, long long sm, void* stream) {
  if (z1 < 1 || z2 < 1 || n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)z1 * z2 * n * m;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  center_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      k, row, col, tot, out, total, z2, n, m, s1, s2, sn, sm);
  return (int)cudaGetLastError();
}
