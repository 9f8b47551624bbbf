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
//  1. gram_split_kernel, one warp per row: reads the operand once, writes hi
//     and lo at a row stride padded to 32 floats with zero fill (128-byte
//     rows, whole K-tiles, TMA-aligned) and the row's squared norm (rbf) or
//     self-kernel (linear/poly). y = x is split once.
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

#include "tile.cuh"

namespace {

constexpr int kBN = 128;                 // output tile columns (y rows)
constexpr int kBK = 32;                  // floats per K-tile: one 128-B row
constexpr int kRowPad = 32;              // padded row stride multiple
constexpr int kEpiStride = kBN + 1;      // shared copy of the finished tile

template <int BM>
struct Cfg {
  static constexpr int kConsumers = BM / 64;             // warpgroups
  static constexpr int kThreads = kConsumers * 128 + 32;  // + producer warp
  static constexpr int kStages = BM == 128 ? 3 : 4;
  static constexpr int kXBytes = BM * kBK * 4;            // one x tile
  static constexpr int kYBytes = kBN * kBK * 4;           // one y tile
  static constexpr int kStageBytes = 2 * kXBytes + 2 * kYBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kSmemBytes = 1024 + kRingBytes + 2 * kStages * 8;
  static_assert(BM * kEpiStride * 4 <= kRingBytes, "epilogue copy");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(v));
  return __uint_as_float(u);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Waits for the phase of the given parity to complete. A wait that outlasts
// about four seconds of SM clock traps, so a fault in the pipeline ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 8000000000LL) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart. A K-step of 8 tf32 (32 bytes) inside the swizzle atom
// advances the start address field by 2.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;              // leading byte offset (unused here)
  d |= (uint64_t)(1024 >> 4) << 32;    // stride byte offset
  d |= (uint64_t)1 << 62;              // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma issue / wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define KPCA_ACC8(i)                                                       \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128 fp32 fragment) = (scale_d ? d : 0) + A(64 x 8) . B(128 x 8)^T
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n\t}"
      : KPCA_ACC8(0), KPCA_ACC8(8), KPCA_ACC8(16), KPCA_ACC8(24),
        KPCA_ACC8(32), KPCA_ACC8(40), KPCA_ACC8(48), KPCA_ACC8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef KPCA_ACC8

// One warp per row of the flat (rows, m) operand.
__global__ void __launch_bounds__(256)
gram_split_kernel(const float* __restrict__ x, float* __restrict__ hi,
                  float* __restrict__ lo, float* __restrict__ norms, int rows,
                  int m, int mp, kpca::Epilogue ep) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * m;
  float* hr = hi + (size_t)row * mp;
  float* lr = lo + (size_t)row * mp;
  float ss = 0.0f;
  for (int c = lane; c < mp; c += 32) {
    const float v = c < m ? xr[c] : 0.0f;
    const float h = tf32_rna(v);
    hr[c] = h;
    lr[c] = tf32_rna(v - h);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (lane == 0) norms[row] = ep.self_k(ss);
}

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
  const int kt = mp / kBK;
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
        const int c0 = it * kBK;
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
    const uint64_t xh = sw128_desc(st + wg * 64 * kBK * 4);
    const uint64_t xl = sw128_desc(st + C::kXBytes + wg * 64 * kBK * 4);
    const uint64_t yh = sw128_desc(st + 2 * C::kXBytes);
    const uint64_t yl = sw128_desc(st + 2 * C::kXBytes + C::kYBytes);
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
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

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime's
// entry-point query, so the library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (batch, rows, mp) fp32 operand, boxes of box_rows x 32 floats.
bool encode(CUtensorMap* map, const float* base, int batch, int rows, int mp,
            int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)mp, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)mp * 4,
                                 (cuuint64_t)rows * mp * 4};
  const cuuint32_t box[3] = {(cuuint32_t)kBK, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
            const_cast<float*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  if (batch < 1 || n < 1 || k < 1 || m < 1 || mp < m || mp % kRowPad != 0 ||
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
  gram_split_kernel<<<(batch * n + 7) / 8, 256, 0, s>>>(x, xh, xl, sx,
                                                        batch * n, m, mp, ep);
  if (!symmetric)
    gram_split_kernel<<<(batch * k + 7) / 8, 256, 0, s>>>(y, yh, yl, sy,
                                                          batch * k, m, mp, ep);
  cudaError_t e = cudaGetLastError();
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
