// Fused local ADMM update per node (paper eq. 12-13):
//
//   rhs   = sum_s (rho_s G[:, s] - B[:, s])
//   alpha = V diag(inv_den) V^T rhs         (the eigh-factorized eq. 12 solve)
//   ka    = K alpha
//   B'    = B + rho_s (ka 1^T - G)          (eq. 13)
//
// Replaces the TPU kernel src/repro/kernels/admm_step/admm_step.py:
// admm_local_update (_admm_kernel). It also writes ka, which the solver's
// primal residual needs, so the caller does not form K alpha again.
//
// What bounds it on an H100: bytes. Three N x N matrix-vector products per
// node (6 N^2 fp32 operations) against one read of V and K (8 N^2 bytes);
// at the main path's J = 20, N = 100, S = 5 the whole call moves about
// 1.74 MB, 0.00052 ms at 3.35 TB/s, so in practice it is bound by the
// latency of its dependent steps and by the launch.
// What the design does about it: one block of 1024 threads per node holds
// rhs, t = inv_den * V^T rhs and alpha in shared memory (3N floats). With
// only J blocks in flight, the time is the latency of each block's longest
// chain of dependent loads. V and K do not depend on rhs, so for N <= 168
// (V and K, 2N^2 floats, fit in the 227 KB of shared memory beside the
// vectors: 226 KB at N = 168, 80 KB at the main path's N = 100) the block's
// first instructions issue cp.async copies of its V and then its K into
// shared memory, as two commit groups, and each thread's inv_den entry into
// a register; rhs is formed from B and G while they land, and the three
// matrix-vector phases read shared memory only (V^T rhs and V t wait for the
// first group, K alpha for the second; its warps load their rows' B, G and
// rho before the product). Past N = 168
// the block reads V and K from device memory in each phase (resident in the
// 50 MB L2 across iterations). Every phase spreads over all 1024 threads:
// t = V^T rhs gives each column kThreads / N row groups (10 at N = 100), one
// thread each, whose partial sums are added in a fixed order — a warp's
// reads of a row of V stay consecutive; V t and K alpha take one warp per
// row with lane-strided reads and a shuffle reduction. The TPU program does
// the V^T rhs reduction in one invocation; here it is the __syncthreads
// between the two halves. Accumulation is IEEE fp32 (fmaf), no tensor cores,
// in the same order on both paths. B and G are read through their strides,
// so the solver's transposed G view needs no copy; everything else is
// contiguous.
//
// scripts/project_ablate.py times copies of this file edited by exact text:
// the kThreads line and the `staged` line of kpca_admm_step. A change to
// either line goes into its VARIANTS too.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// rhs, t and alpha: 3N floats of dynamic shared memory within the 48 KB a
// block gets without opting in, so N <= 4096 (the TPU kernel's VMEM guard was
// N <= 1024). Below N = 512 the row groups' partial sums of V^T rhs take
// another kThreads floats at most.
constexpr int kMaxN = 4096;
constexpr int kSmemMax = 232448;    // a block's shared memory after opt-in
constexpr int kStagedMaxN = 168;    // largest N whose V and K fit beside it

// Row groups per column of V^T rhs: all threads busy while N < kThreads.
__host__ __device__ __forceinline__ int row_groups(int n) {
  return n < kThreads ? kThreads / n : 1;
}

// Floats of shared memory: V and K when staged, rhs, t, alpha, partials.
__host__ __device__ __forceinline__ size_t smem_floats(int n, bool staged) {
  const int groups = row_groups(n);
  return (staged ? 2 * (size_t)n * n : 0) + 3 * (size_t)n +
         (groups > 1 ? (size_t)groups * n : 0);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Copy count floats into shared memory with cp.async, 16 bytes per copy
// where both sides allow it, else 4; one commit group.
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int count, bool vec16) {
  if (vec16) {
    for (int i = 4 * threadIdx.x; i < count; i += 4 * kThreads)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       (uint32_t)__cvta_generic_to_shared(dst + i)),
                   "l"(src + i)
                   : "memory");
  } else {
    for (int i = threadIdx.x; i < count; i += kThreads)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       (uint32_t)__cvta_generic_to_shared(dst + i)),
                   "l"(src + i)
                   : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
admm_step_kernel(const float* __restrict__ v, const float* __restrict__ inv,
                 const float* __restrict__ k, const float* __restrict__ b,
                 const float* __restrict__ g, const float* __restrict__ rho,
                 float* __restrict__ alpha, float* __restrict__ bout,
                 float* __restrict__ ka, int n, int s, long long b_sj,
                 long long b_sn, long long b_ss, long long g_sj,
                 long long g_sn, long long g_ss) {
  extern __shared__ float smem[];
  const long long node = blockIdx.x;
  const size_t nn = (size_t)n * n;
  v += node * nn;
  k += node * nn;
  // V and K first: their copies are in flight while rhs is formed
  const float* vm = v;
  const float* km = k;
  float* vec = smem;
  if (kStaged) {
    const bool vec16 = nn % 4 == 0 && ((size_t)v % 16) == 0 &&
                       ((size_t)k % 16) == 0;
    copy_async(smem, v, (int)nn, vec16);
    copy_async(smem + nn, k, (int)nn, vec16);
    vm = smem;
    km = smem + nn;
    vec = smem + 2 * nn;
  }
  float* rhs = vec;
  float* t = vec + n;
  float* al = vec + 2 * n;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  inv += node * n;
  const float inv_own = tid < n ? inv[tid] : 0.0f;   // in flight with V, K
  b += node * b_sj;
  g += node * g_sj;
  rho += node * s;
  alpha += node * n;
  ka += node * n;
  bout += node * n * s;

  for (int r = tid; r < n; r += kThreads) {
    float acc = 0.0f;
    for (int q = 0; q < s; ++q)
      acc += rho[q] * g[r * g_sn + q * g_ss] - b[r * b_sn + q * b_ss];
    rhs[r] = acc;
  }
  if (kStaged) copy_wait<1>();                      // this thread's V copies
  __syncthreads();

  const int groups = row_groups(n);                 // t = inv * V^T rhs
  if (groups > 1) {
    float* part = vec + 3 * n;                      // groups x n partials
    if (tid < groups * n) {
      const int c = tid % n, h = tid / n;
      float acc = 0.0f;
      for (int r = h; r < n; r += groups)
        acc = fmaf(vm[(size_t)r * n + c], rhs[r], acc);
      part[h * n + c] = acc;
    }
    __syncthreads();
    for (int c = tid; c < n; c += kThreads) {
      float acc = 0.0f;
      for (int h = 0; h < groups; ++h) acc += part[h * n + c];
      t[c] = acc * (c == tid ? inv_own : inv[c]);
    }
  } else {
    for (int c = tid; c < n; c += kThreads) {
      float acc = 0.0f;
      for (int r = 0; r < n; ++r)
        acc = fmaf(vm[(size_t)r * n + c], rhs[r], acc);
      t[c] = acc * (c == tid ? inv_own : inv[c]);
    }
  }
  __syncthreads();

  for (int r = warp; r < n; r += kWarps) {         // alpha = V t
    float acc = 0.0f;
    for (int c = lane; c < n; c += 32)
      acc = fmaf(vm[(size_t)r * n + c], t[c], acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      al[r] = acc;
      alpha[r] = acc;
    }
  }
  if (kStaged) copy_wait<0>();                      // this thread's K copies
  __syncthreads();

  for (int r = warp; r < n; r += kWarps) {         // ka = K alpha, then eq. 13
    // the row's first 32 slots of B, G and rho are loaded before the
    // product, so their latency hides behind it
    const bool own = lane < s;
    const float b0 = own ? b[r * b_sn + lane * b_ss] : 0.0f;
    const float g0 = own ? g[r * g_sn + lane * g_ss] : 0.0f;
    const float r0 = own ? rho[lane] : 0.0f;
    float acc = 0.0f;
    for (int c = lane; c < n; c += 32)
      acc = fmaf(km[(size_t)r * n + c], al[c], acc);
    acc = warp_sum(acc);                           // every lane holds the sum
    if (lane == 0) ka[r] = acc;
    if (own) bout[r * s + lane] = b0 + r0 * (acc - g0);
    for (int q = lane + 32; q < s; q += 32)
      bout[r * s + q] = b[r * b_sn + q * b_ss]
                        + rho[q] * (acc - g[r * g_sn + q * g_ss]);
  }
}

}  // namespace

// v, k (j, n, n), inv (j, n), rho (j, s), alpha and ka (j, n), bout (j, n, s)
// contiguous; b and g (j, n, s) at the given element strides.
extern "C" int kpca_admm_step(const float* v, const float* inv, const float* k,
                              const float* b, const float* g, const float* rho,
                              float* alpha, float* bout, float* ka, int j,
                              int n, int s, long long b_sj, long long b_sn,
                              long long b_ss, long long g_sj, long long g_sn,
                              long long g_ss, void* stream) {
  if (j < 1 || n < 1 || s < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const bool staged = n <= kStagedMaxN;
  const size_t smem = smem_floats(n, staged) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (staged) {
    static int opted[kpca::kMaxDevices] = {};
    const cudaError_t e =
        kpca::opt_in_smem(admm_step_kernel<true>, (int)kSmemMax, opted);
    if (e != cudaSuccess) return (int)e;
    admm_step_kernel<true><<<j, kThreads, smem, st>>>(
        v, inv, k, b, g, rho, alpha, bout, ka, n, s, b_sj, b_sn, b_ss, g_sj,
        g_sn, g_ss);
  } else {
    admm_step_kernel<false><<<j, kThreads, smem, st>>>(
        v, inv, k, b, g, rho, alpha, bout, ka, n, s, b_sj, b_sn, b_ss, g_sj,
        g_sn, g_ss);
  }
  return (int)cudaGetLastError();
}
