// Batched Gram (kernel) matrix  K[z, i, j] = kfun(x[z, i], y[z, j])  on
// Hopper's tensor cores, fp32-grade.
//
// Replaces the TPU kernel src/repro/kernels/gram/gram.py:gram_tiles
// (_gram_kernel): x.y^T accumulated in fp32 over the feature axis with the
// rbf / linear / poly + normalize epilogue fused in, one output write per
// element, no distance matrix in device memory.
//
// What bounds it on an H100: operations. fp32 on the CUDA cores peaks at
// 67 TFLOP/s; the tensor cores take TF32 (10 mantissa bits) at 495 TFLOP/s.
// Plain TF32 would lose fp32 parity, so every product is split 3xTF32:
//   x.y ~= x_lo.y_hi + x_hi.y_lo + x_hi.y_hi,
//   hi = tf32_rna(x), lo = tf32_rna(x - hi),
// three tensor-core products for one fp32 one, still 2.5x the fp32 peak.
//
// Two launches per Gram:
//  1. the split pass (hopper.cuh: tf32_split_kernel), one warp per row:
//     reads the operand once, writes hi and lo at a row stride padded to 32
//     floats with zero fill (128-byte rows, whole K-tiles, TMA-aligned) and
//     the row's squared norm (rbf) or self-kernel (linear/poly). y = x is
//     split once.
//  2. gram_mma_kernel: a BM x 128 output tile per block (BM = 128: two
//     consumer warpgroups; BM = 64, for grids under one wave: one). One
//     producer warp streams 32-float-deep K-tiles of hi and lo of both
//     operands into a ring of shared-memory stages with TMA (128-byte
//     swizzle, 3-D maps over (batch, rows, padded m) that zero-fill the
//     ragged row edge); each stage completes on an mbarrier. Consumers issue
//     wgmma.mma_async m64n128k8 .tf32 with both operands K-major, the two
//     small terms before hi.hi at each k-step, into a per-stage fp32
//     accumulator that is added into the running sum with one rounded fp32
//     add per element (the tensor core's own accumulation chain then spans
//     one stage, 12 instructions, not the whole feature axis).
//     With y = x only tiles on or above the diagonal run; each off-diagonal
//     tile is written twice (direct and mirrored), both stores coalesced
//     through a shared-memory copy of the finished tile, and a diagonal tile
//     writes its upper triangle and mirrors it, so K equals K^T bit for bit.
// No atomics: every output element is written once, in a fixed order.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tile.cuh"

namespace {

constexpr int kBN = 128;                 // output tile columns (y rows)
constexpr int kEpiStride = kBN + 1;      // shared copy of the finished tile

template <int BM>
struct Cfg {
  static constexpr int kConsumers = BM / 64;             // warpgroups
  static constexpr int kThreads = kConsumers * 128 + 32;  // + producer warp
  static constexpr int kStages = BM == 128 ? 3 : 4;
  static constexpr int kXBytes = BM * kTileK * 4;         // one x tile
  static constexpr int kYBytes = kBN * kTileK * 4;        // one y tile
  static constexpr int kStageBytes = 2 * kXBytes + 2 * kYBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kSmemBytes = 1024 + kRingBytes + 2 * kStages * 8;
  static_assert(BM * kEpiStride * 4 <= kRingBytes, "epilogue copy");
};

struct Maps {
  CUtensorMap xh, xl, yh, yl;
};

// grid: (tiles, batch). Symmetric: tiles enumerate (bi <= bj) of the
// nt x nt tile grid; otherwise bi = t / ntc, bj = t % ntc.
template <int BM>
__global__ void __launch_bounds__(Cfg<BM>::kThreads, 1)
gram_mma_kernel(const __grid_constant__ Maps maps,
                const float* __restrict__ sx, const float* __restrict__ sy,
                const float* __restrict__ gamma, float* __restrict__ out,
                int n, int k, int mp, int symmetric, kpca::Epilogue ep) {
  using C = Cfg<BM>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* ring_ptr = smem_raw + (ring - raw);
  const uint32_t full0 = ring + C::kRingBytes;
  const uint32_t empty0 = full0 + C::kStages * 8;

  const int z = blockIdx.y;
  int bi, bj;
  if (symmetric) {
    const int nt = (n + kBN - 1) / kBN;
    int t = blockIdx.x;
    bi = 0;
    while (t >= nt - bi) {
      t -= nt - bi;
      ++bi;
    }
    bj = bi + t;
  } else {
    const int ntc = (k + kBN - 1) / kBN;
    bi = blockIdx.x / ntc;
    bj = blockIdx.x % ntc;
  }
  const int row0 = bi * BM, col0 = bj * kBN;
  const int kt = mp / kTileK;
  const int tid = threadIdx.x;
  constexpr int kConsumerThreads = C::kConsumers * 128;

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // -- producer warp: one thread keeps the ring full -----------------
    if (tid == kConsumerThreads) {
      for (int it = 0; it < kt; ++it) {
        const int s = it % C::kStages;
        mbar_wait(empty0 + 8 * s, ((it / C::kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t st = ring + s * C::kStageBytes;
        mbar_expect_tx(full, C::kStageBytes);
        const int c0 = it * kTileK;
        tma_load_3d(st, &maps.xh, full, c0, row0, z);
        tma_load_3d(st + C::kXBytes, &maps.xl, full, c0, row0, z);
        tma_load_3d(st + 2 * C::kXBytes, &maps.yh, full, c0, col0, z);
        tma_load_3d(st + 2 * C::kXBytes + C::kYBytes, &maps.yl, full, c0,
                    col0, z);
      }
    }
    return;
  }

  // -- consumer warpgroups: rows wg*64 .. wg*64+63 of the tile ------------
  const int wg = tid / 128;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.0f;
  for (int it = 0; it < kt; ++it) {
    const int s = it % C::kStages;
    mbar_wait(full0 + 8 * s, (it / C::kStages) & 1);
    const uint32_t st = ring + s * C::kStageBytes;
    const uint64_t xh = sw128_desc(st + wg * 64 * kTileK * 4);
    const uint64_t xl = sw128_desc(st + C::kXBytes + wg * 64 * kTileK * 4);
    const uint64_t yh = sw128_desc(st + 2 * C::kXBytes);
    const uint64_t yl = sw128_desc(st + 2 * C::kXBytes + C::kYBytes);
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileK / 8; ++kk) {
      wgmma_tf32(part, xl + 2 * kk, yh + 2 * kk, kk > 0);
      wgmma_tf32(part, xh + 2 * kk, yl + 2 * kk, 1);
      wgmma_tf32(part, xh + 2 * kk, yh + 2 * kk, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(part);
    mbar_arrive(empty0 + 8 * s);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }

  // -- epilogue: kernel function on the fragment, into a shared copy -------
  // Every consumer has finished reading the ring before any writes to it.
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumerThreads) : "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  float* tile = reinterpret_cast<float*>(ring_ptr);
  const float g = ep.kind == kpca::kRbf ? *gamma : 0.0f;
  const float* sxz = sx + (size_t)z * n;
  const float* syz = sy + (size_t)z * k;
  const int warp = (tid % 128) / 32, lane = tid % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + warp * 16 + lane / 4 + 8 * h;
    const float a = row0 + r < n ? sxz[row0 + r] : 0.0f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * (lane % 4) + e;
        const float b = col0 + c < k ? syz[col0 + c] : 0.0f;
        tile[r * kEpiStride + c] = ep.apply(acc[4 * j + 2 * h + e], a, b, g);
      }
    }
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumerThreads) : "memory");

  float* outz = out + (size_t)z * n * k;
  const bool diag = symmetric && bi == bj;
  // direct copy: consecutive threads along a row of the output
  for (int e = tid; e < BM * kBN; e += kConsumerThreads) {
    const int r = e / kBN, c = e % kBN;
    if (row0 + r < n && col0 + c < k && (!diag || r <= c))
      outz[(size_t)(row0 + r) * k + col0 + c] = tile[r * kEpiStride + c];
  }
  if (!symmetric) return;
  // mirrored copy (K^T tile at (bj, bi)): consecutive threads along a row
  // of the mirrored tile, i.e. down a column of the shared copy
  for (int e = tid; e < BM * kBN; e += kConsumerThreads) {
    const int c = e / BM, r = e % BM;
    if (row0 + r < n && col0 + c < n && (!diag || r < c))
      outz[(size_t)(col0 + c) * n + row0 + r] = tile[r * kEpiStride + c];
  }
}

template <int BM>
int launch_mma(const Maps& maps, const float* sx, const float* sy,
               const float* gamma, float* out, int batch, int n, int k,
               int mp, int symmetric, kpca::Epilogue ep,
               cudaStream_t stream) {
  using C = Cfg<BM>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gram_mma_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int ntr = (n + BM - 1) / BM, ntc = (k + kBN - 1) / kBN;
  const int tiles = symmetric ? ntc * (ntc + 1) / 2 : ntr * ntc;
  gram_mma_kernel<BM><<<dim3(tiles, batch), C::kThreads, C::kSmemBytes,
                        stream>>>(maps, sx, sy, gamma, out, n, k, mp,
                                  symmetric, ep);
  return (int)cudaGetLastError();
}

}  // namespace

// x (batch, n, m) and y (batch, k, m) contiguous fp32; y == NULL means y
// is x: split once, only tiles on or above the diagonal, mirrored (needs
// bm == 128). scratch: xh, xl (batch, n, mp), then yh, yl (batch, k, mp)
// unless y is x, then the norms sx (batch, n) and sy (batch, k) unless y is
// x; mp = m rounded up to 32. out (batch, n, k). bm: 128 or 64 output rows
// per block. Three launches (two when y is x), one C call.
extern "C" int kpca_gram(const float* x, const float* y, float* scratch,
                         const float* gamma, float* out, int batch, int n,
                         int k, int m, int mp, int bm, int kind, int degree,
                         float coef, float scale, int normalize,
                         void* stream) {
  const int symmetric = y == nullptr;
  if (symmetric) k = n;
  if (batch < 1 || n < 1 || k < 1 || m < 1 || mp < m || mp % kTileK != 0 ||
      batch > 65535 || (bm != 64 && bm != 128) || (symmetric && bm != 128))
    return (int)cudaErrorInvalidValue;
  const size_t xs = (size_t)batch * n * mp, ys = (size_t)batch * k * mp;
  float* xh = scratch;
  float* xl = xh + xs;
  float* yh = symmetric ? xh : xl + xs;
  float* yl = symmetric ? xl : yh + ys;
  float* sx = (symmetric ? xl : yl) + (symmetric ? xs : ys);
  float* sy = symmetric ? sx : sx + (size_t)batch * n;
  cudaStream_t s = (cudaStream_t)stream;
  kpca::Epilogue ep{kind, degree, coef, scale, normalize};
  cudaError_t e =
      tf32_split<32>(x, nullptr, xh, xl, sx, batch * n, m, mp, ep, s);
  if (e == cudaSuccess && !symmetric)
    e = tf32_split<32>(y, nullptr, yh, yl, sy, batch * k, m, mp, ep, s);
  if (e != cudaSuccess) return (int)e;
  Maps maps;
  if (!encode(&maps.xh, xh, batch, n, mp, bm) ||
      !encode(&maps.xl, xl, batch, n, mp, bm) ||
      !encode(&maps.yh, yh, batch, k, mp, kBN) ||
      !encode(&maps.yl, yl, batch, k, mp, kBN))
    return (int)cudaErrorInvalidValue;
  return bm == 128 ? launch_mma<128>(maps, sx, sy, gamma, out, batch, n, k,
                                     mp, symmetric, ep, s)
                   : launch_mma<64>(maps, sx, sy, gamma, out, batch, n, k,
                                    mp, symmetric, ep, s);
}
