// Hopper building blocks shared by the tensor-core kernels (csrc/gram.cu,
// csrc/project.cu): shared-memory addresses, the 3xTF32 split pass that
// writes both kernels' operands, mbarriers, TMA tile loads and their tensor maps, the 128-byte-swizzle
// wgmma descriptor, and wgmma.mma_async .tf32 at the two N widths the
// kernels use (m64n128k8 for gram, m64n32k8 for project and gram's
// short-row route where k <= 32). Everything here
// is for sm_90a; the definitions sit in an anonymous namespace, one copy
// per translation unit.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

constexpr int kTileK = 32;   // floats per K-tile: one 128-byte swizzled row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Round to TF32 (10 mantissa bits), to nearest, ties away from zero.
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(v));
  return __uint_as_float(u);
}

// The 3xTF32 operand format that the tensor-core kernels read through TMA:
// each row of a (rows, m) fp32 operand, less a shift row (NULL: none), as
// hi = rna(v) and lo = rna(v - hi) at a row stride mp padded to whole
// K-tiles with zeros (128-byte rows), and the row's squared norm (rbf) or
// self-kernel (linear/poly) for the epilogue. TPR threads take a row: 32
// (one warp, eight rows per block; gram's many rows) or kSplitThreads (one
// block per row; project's short query batches and its support set). A
// row's norm is summed thread-strided, then by a shuffle tree per warp,
// then the warps in order: an order fixed by mp and TPR alone. The input
// element T is float, or __nv_bfloat16 for gram's bf16 operands and
// project's bf16 query slabs: a
// bf16 value widens to fp32 exactly on load, and everything after the load
// is the fp32 path's, so a bf16 row gives the same bits as its widened fp32
// copy, from half the bytes.
constexpr int kSplitThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int TPR, typename T>
__global__ void __launch_bounds__(kSplitThreads)
tf32_split_kernel(const T* __restrict__ x,
                  const float* __restrict__ shift, float* __restrict__ hi,
                  float* __restrict__ lo, float* __restrict__ norms, int rows,
                  int m, int mp, kpca::Epilogue ep) {
  static_assert(TPR == 32 || TPR == kSplitThreads, "a warp or a block a row");
  constexpr int kWarps = TPR / 32;
  const int t = threadIdx.x % TPR, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kSplitThreads / TPR) + threadIdx.x / TPR;
  if (row >= rows) return;   // whole warps; with a block a row, never
  const T* xr = x + (size_t)row * m;
  float* hr = hi + (size_t)row * mp;
  float* lr = lo + (size_t)row * mp;
  float ss = 0.0f;
#pragma unroll 4
  for (int c = t; c < mp; c += TPR) {
    const float v = c < m ? widen(xr[c]) - (shift ? shift[c] : 0.0f) : 0.0f;
    const float h = tf32_rna(v);
    hr[c] = h;
    lr[c] = tf32_rna(v - h);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if constexpr (kWarps == 1) {
    if (lane == 0) norms[row] = ep.self_k(ss);
  } else {
    __shared__ float warp_ss[kWarps];
    if (lane == 0) warp_ss[threadIdx.x / 32] = ss;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.0f;
      for (int w = 0; w < kWarps; ++w) total += warp_ss[w];
      norms[row] = ep.self_k(total);
    }
  }
}

// One launch of the split pass over rows rows, TPR threads a row.
template <int TPR, typename T>
cudaError_t tf32_split(const T* x, const float* shift, float* hi,
                       float* lo, float* norms, int rows, int m, int mp,
                       const kpca::Epilogue& ep, cudaStream_t stream) {
  constexpr int per_block = kSplitThreads / TPR;
  tf32_split_kernel<TPR, T><<<(rows + per_block - 1) / per_block, kSplitThreads,
                           0, stream>>>(x, shift, hi, lo, norms, rows, m, mp,
                                        ep);
  return cudaGetLastError();
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
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// d (64 x 32 fp32 fragment) = (scale_d ? d : 0) + A(64 x 8) . B(32 x 8)^T
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %18, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n\t}"
      : KPCA_ACC8(0), KPCA_ACC8(8)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef KPCA_ACC8

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

// A (batch, rows, mp) fp32 operand, boxes of box_rows x 32 floats, 128-byte
// swizzle; rows past the edge load as zero.
bool encode(CUtensorMap* map, const float* base, int batch, int rows, int mp,
            int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)mp, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)mp * 4,
                                 (cuuint64_t)rows * mp * 4};
  const cuuint32_t box[3] = {(cuuint32_t)kTileK, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
            const_cast<float*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
