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
//     K's diagonal is K(x, x) from the split pass's fp32 norm (Epilogue::
//     self_value): at llama3.2-3b's width (M = 3072) the tensor cores' x.x
//     put the self-Gram 7.15e-7 from float64, 3x the plain fp32 version's
//     error (measured on an NVIDIA H100 80GB HBM3 at a 700.00 W limit).
//  2'. gram_split_kernel, the short-row route (gram.py:split_count > 1:
//     n, k <= 128, so one output tile per batch element, and at least 32
//     K-tiles). Route 2 would walk every K-tile of that one tile in series
//     on one SM, 64 x 128 of tensor-core work a k-step for as few as 24 x
//     24 outputs: a chain that grows with M while the other SMs idle (96 x
//     96 x 4096 took 0.146 ms against a 0.0005 ms bound, PERF.md). Here the
//     S CTAs of a thread-block cluster (grid (S, batch), cluster (S, 1, 1))
//     each run route 2's stage loop over their own contiguous S-th of the
//     K-tiles, with the MMA sized to the tile (m64n32k8 where k <= 32,
//     m64n128k8 otherwise; 64 rows where n <= 64, else two warpgroups).
//     Each CTA leaves its fp32 partial fragment in its own shared memory;
//     after a cluster barrier CTA rank r finishes the fragment registers
//     [r F / S, (r + 1) F / S) of every consumer thread (F of them): it
//     reads that slice of every rank's partial through distributed shared
//     memory, adds them in rank order (a fixed order), applies the same
//     Epilogue, and writes each element once (a self-Gram: the upper
//     triangle, mirrored, its diagonal from the row's own norm). Finishing
//     a slice per rank spreads the partials' traffic over the cluster: rank
//     0 alone would read S - 1 whole 64 KB tiles. A second cluster barrier
//     keeps every CTA's shared memory alive until its peers have read it.
//     No workspace in device memory, no atomics. The split pass takes a
//     256-thread block per row here (route 2's warp a row walked 96 serial
//     32-float steps at M = 3072: 7.8 us a launch at 24 rows, PERF.md).
//     The split count and tile sizes depend on (n, k, m) alone, so element
//     z of a batch gets the bits of the same operands alone.
// No atomics: every output element is written once, in a fixed order.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tile.cuh"

namespace cg = cooperative_groups;

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
  const bool diag = symmetric && bi == bj;   // row0 == col0: BM == kBN
  // direct copy: consecutive threads along a row of the output; K's
  // diagonal from the row's own norm (Epilogue::self_value)
  for (int e = tid; e < BM * kBN; e += kConsumerThreads) {
    const int r = e / kBN, c = e % kBN;
    if (row0 + r < n && col0 + c < k && (!diag || r <= c))
      outz[(size_t)(row0 + r) * k + col0 + c] =
          diag && r == c ? ep.self_value(sxz[row0 + r])
                         : tile[r * kEpiStride + c];
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
  static int opted[kpca::kMaxDevices] = {};
  const cudaError_t e =
      kpca::opt_in_smem(gram_mma_kernel<BM>, C::kSmemBytes, opted);
  if (e != cudaSuccess) return (int)e;
  const int ntr = (n + BM - 1) / BM, ntc = (k + kBN - 1) / kBN;
  const int tiles = symmetric ? ntc * (ntc + 1) / 2 : ntr * ntc;
  gram_mma_kernel<BM><<<dim3(tiles, batch), C::kThreads, C::kSmemBytes,
                        stream>>>(maps, sx, sy, gamma, out, n, k, mp,
                                  symmetric, ep);
  return (int)cudaGetLastError();
}

// The short-row route's block: BM output rows (BM / 64 consumer warpgroups)
// by BN columns, the whole output of one batch element.
template <int BM, int BN>
struct SplitCfg {
  static constexpr int kConsumerThreads = BM / 64 * 128;
  static constexpr int kThreads = kConsumerThreads + 32;  // + producer warp
  static constexpr int kAcc = BN / 2;      // fp32 a thread of a 64 x BN tile
  static constexpr int kXBytes = BM * kTileK * 4;         // one x tile
  static constexpr int kYBytes = BN * kTileK * 4;         // one y tile
  static constexpr int kStageBytes = 2 * kXBytes + 2 * kYBytes;
  static constexpr int kStages = kStageBytes > 48 * 1024 ? 3 : 4;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kSmemBytes = 1024 + kRingBytes + 2 * kStages * 8;
  static_assert(BM * BN * 4 <= kRingBytes, "partial fragments");
};

// The short-row route: the whole (n <= BM, k <= BN) output of batch element
// blockIdx.y is one tile, its K-tiles split over the gridDim.x CTAs of a
// cluster (the grid's x extent is the cluster's). The stage loop is route
// 2's (gram_mma_kernel), over this CTA's range of K-tiles; it is written
// out again rather than shared, because an inlined shared loop changed
// route 2's code generation and slowed the fit's 2000 x 2000 Gram by 1 %
// (PERF.md). Every thread of every CTA reaches both cluster barriers.
template <int BM, int BN>
__global__ void __launch_bounds__(BM / 64 * 128 + 32, 1)
gram_split_kernel(const __grid_constant__ Maps maps,
                  const float* __restrict__ sx, const float* __restrict__ sy,
                  const float* __restrict__ gamma, float* __restrict__ out,
                  int n, int k, int mp, int symmetric, kpca::Epilogue ep) {
  using C = SplitCfg<BM, BN>;
  static_assert(C::kThreads == BM / 64 * 128 + 32, "launch bounds");
  constexpr int kConsumerThreads = C::kConsumerThreads;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  float* partials = reinterpret_cast<float*>(smem_raw + (ring - raw));
  const uint32_t full0 = ring + C::kRingBytes;
  const uint32_t empty0 = full0 + C::kStages * 8;

  const int z = blockIdx.y, rank = blockIdx.x, splits = gridDim.x;
  const int kt = mp / kTileK;
  const int kt0 = rank * kt / splits, nk = (rank + 1) * kt / splits - kt0;
  const int tid = threadIdx.x;

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
      for (int it = 0; it < nk; ++it) {
        const int s = it % C::kStages;
        mbar_wait(empty0 + 8 * s, ((it / C::kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t st = ring + s * C::kStageBytes;
        mbar_expect_tx(full, C::kStageBytes);
        const int c0 = (kt0 + it) * kTileK;
        tma_load_3d(st, &maps.xh, full, c0, 0, z);
        tma_load_3d(st + C::kXBytes, &maps.xl, full, c0, 0, z);
        tma_load_3d(st + 2 * C::kXBytes, &maps.yh, full, c0, 0, z);
        tma_load_3d(st + 2 * C::kXBytes + C::kYBytes, &maps.yl, full, c0, 0,
                    z);
      }
    }
  } else {
    // -- consumer warpgroups: rows wg*64 .. wg*64+63, route 2's stages ----
    const int wg = tid / 128;
    float acc[C::kAcc], part[C::kAcc];
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) acc[i] = part[i] = 0.0f;
    for (int it = 0; it < nk; ++it) {
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
      for (int i = 0; i < C::kAcc; ++i) acc[i] += part[i];
    }
    // every consumer is past the ring before any writes its partial there
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumerThreads) : "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i)
      partials[i * kConsumerThreads + tid] = acc[i];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every rank's partial is in its shared memory

  if (tid < kConsumerThreads) {
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const float g = ep.kind == kpca::kRbf ? *gamma : 0.0f;
    const float* sxz = sx + (size_t)z * n;
    const float* syz = sy + (size_t)z * k;
    float* outz = out + (size_t)z * n * k;
    const int i0 = rank * C::kAcc / splits;
    const int i1 = (rank + 1) * C::kAcc / splits;
    for (int i = i0; i < i1; ++i) {
      // fragment register i: row lane / 4 + 8 h, column 8 j + 2 (lane % 4)
      // + e of the warp's 16 rows, i = 4 j + 2 h + e
      const int r = wg * 64 + warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
      const int c = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      if (r >= n || c >= k || (symmetric && r > c)) continue;
      if (symmetric && r == c) {
        outz[(size_t)r * k + c] = ep.self_value(sxz[r]);
        continue;
      }
      float* slot = partials + i * kConsumerThreads + tid;
      float dot = *cluster.map_shared_rank(slot, 0);
#pragma unroll 4
      for (int q = 1; q < splits; ++q)
        dot += *cluster.map_shared_rank(slot, q);
      const float v = ep.apply(dot, sxz[r], syz[c], g);
      outz[(size_t)r * k + c] = v;
      if (symmetric) outz[(size_t)c * n + r] = v;
    }
  }
  cluster.sync();   // no CTA leaves while a peer may read its partial
}

template <int BM, int BN>
int launch_split(const Maps& maps, const float* sx, const float* sy,
                 const float* gamma, float* out, int batch, int n, int k,
                 int mp, int symmetric, int splits, kpca::Epilogue ep,
                 cudaStream_t stream) {
  using C = SplitCfg<BM, BN>;
  static int opted[kpca::kMaxDevices] = {};
  cudaError_t e =
      kpca::opt_in_smem(gram_split_kernel<BM, BN>, C::kSmemBytes, opted);
  if (e == cudaSuccess && splits > 8)   // past the portable cluster size
    e = cudaFuncSetAttribute(gram_split_kernel<BM, BN>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, batch, 1);
  cfg.blockDim = dim3(C::kThreads, 1, 1);
  cfg.dynamicSmemBytes = C::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, gram_split_kernel<BM, BN>, maps, sx, sy,
                         gamma, out, n, k, mp, symmetric, ep);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// One operand's split pass, by its element type: a warp a row (route 2),
// or a 256-thread block a row (the short-row route).
template <int TPR>
cudaError_t split_operand(const void* v, int bf16, float* hi, float* lo,
                          float* norms, int rows, int m, int mp,
                          const kpca::Epilogue& ep, cudaStream_t s) {
  return bf16 ? tf32_split<TPR>(static_cast<const __nv_bfloat16*>(v),
                                nullptr, hi, lo, norms, rows, m, mp, ep, s)
              : tf32_split<TPR>(static_cast<const float*>(v), nullptr, hi,
                                lo, norms, rows, m, mp, ep, s);
}

}  // namespace

// x (batch, n, m) and y (batch, k, m) contiguous, each fp32, or bf16 where
// its flag is set (the split pass's bf16 instance widens it on load, so a
// bf16 operand gives the bits of its widened fp32 copy); y == NULL means y
// is x: split once, only tiles on or above the diagonal, mirrored (route 2
// needs bm == 128). scratch: xh, xl (batch, n, mp), then yh, yl (batch, k,
// mp) unless y is x, then the norms sx (batch, n) and sy (batch, k) unless
// y is x; mp = m rounded up to 32. out (batch, n, k). splits: 1 for route
// 2, with bm (128 or 64) output rows per block; 2..16 for the short-row
// route (n, k <= 128, at most one CTA per K-tile), which sizes its own
// tile and ignores bm. Three launches (two when y is x), one C call.
extern "C" int kpca_gram(const void* x, int x_bf16, const void* y,
                         int y_bf16, float* scratch,
                         const float* gamma, float* out, int batch, int n,
                         int k, int m, int mp, int bm, int splits, int kind,
                         int degree, float coef, float scale, int normalize,
                         void* stream) {
  const int symmetric = y == nullptr;
  if (symmetric) k = n;
  const bool split = splits > 1;
  if (batch < 1 || n < 1 || k < 1 || m < 1 || mp < m || mp % kTileK != 0 ||
      batch > 65535 || splits < 1 ||
      (split ? n > 128 || k > 128 || splits > 16 || splits > mp / kTileK
             : (bm != 64 && bm != 128) || (symmetric && bm != 128)))
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
  const auto split_pass = split ? &split_operand<kSplitThreads>
                                : &split_operand<32>;
  cudaError_t e = split_pass(x, x_bf16, xh, xl, sx, batch * n, m, mp, ep, s);
  if (e == cudaSuccess && !symmetric)
    e = split_pass(y, y_bf16, yh, yl, sy, batch * k, m, mp, ep, s);
  if (e != cudaSuccess) return (int)e;
  const int bx = split ? (n <= 64 ? 64 : 128) : bm;
  const int by = split && k <= 32 ? 32 : kBN;
  Maps maps;
  if (!encode(&maps.xh, xh, batch, n, mp, bx) ||
      !encode(&maps.xl, xl, batch, n, mp, bx) ||
      !encode(&maps.yh, yh, batch, k, mp, by) ||
      !encode(&maps.yl, yl, batch, k, mp, by))
    return (int)cudaErrorInvalidValue;
  if (split) {
    const auto launch = bx == 64 ? (by == 32 ? &launch_split<64, 32>
                                             : &launch_split<64, kBN>)
                                 : (by == 32 ? &launch_split<128, 32>
                                             : &launch_split<128, kBN>);
    return launch(maps, sx, sy, gamma, out, batch, n, k, mp, symmetric,
                  splits, ep, s);
  }
  return bm == 128 ? launch_mma<128>(maps, sx, sy, gamma, out, batch, n, k,
                                     mp, symmetric, ep, s)
                   : launch_mma<64>(maps, sx, sy, gamma, out, batch, n, k,
                                    mp, symmetric, ep, s);
}
