// Gram-matrix centering (paper §6.1) over a batch of blocks, means included:
//
//   out[z, i, j] = k[z, i, j] - colmean[z, j] - rowmean[z, i] + totmean[z]
//
// Replaces the TPU kernel src/repro/kernels/centering/centering.py:
// center_tiles (_center_kernel), whose wrapper reduces the three means with
// separate XLA reductions. Here the means are the kernels' own work, so the
// op launches nothing but these kernels.
//
// What bounds it on an H100: bytes. A few fp32 operations per entry against
// eight bytes moved (one read, one write): at the fit's 2000 x 2000 block
// (16 MB in, 16 MB out) about 0.0096 ms at 3.35 TB/s.
// What the design does about it:
//  - a block that fits in shared memory, where the blocks fill a wave of
//    SMs or each is at most 64 KB (center_small_kernel): one block of
//    threads per (n, m) block reads it once into shared memory, forms the
//    row and column sums there and writes the centred block: one read and
//    one write, the bound, in one launch (the wrapper picks the path);
//  - larger blocks, two launches over R x 128 tiles: center_stats_kernel
//    writes each tile's row partial sums, column partial sums and total into
//    scratch; center_apply_kernel reduces the partials its tile needs in a
//    fixed order (no atomics: the same bits on every run) and writes, its
//    second read of K served mostly from the 50 MB L2.
// The input may be a strided view with two batch dimensions (the setup's
// (J, S, S, N, N) block view): every kernel takes its four strides and the
// wrapper never copies it. A warp reads 128 consecutive columns of a row,
// 16 bytes a thread where the column stride is 1 and rows are aligned
// (VEC), else 4 bytes a thread, 32 apart. The output is contiguous. Each
// (batch, row, column) index comes from the grid and loops, with no 64-bit
// division per element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // stats / apply: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 128;           // one warp covers a tile row
constexpr int kSmallThreads = 1024;

struct View {
  const float* k;
  int z2, n, m;
  long long s1, s2, sn, sm;
  __device__ __forceinline__ const float* block(int z) const {
    return k + (long long)(z / z2) * s1 + (long long)(z % z2) * s2;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The 4 columns a lane owns in a 128-column tile row: 4*lane + q (VEC) or
// lane + 32*q.
template <bool VEC>
__device__ __forceinline__ int lane_col(int lane, int q) {
  return VEC ? 4 * lane + q : lane + 32 * q;
}

template <bool VEC>
__device__ __forceinline__ void load4(const float* row, int c0, int m,
                                      long long sm, int lane, float (&v)[4]) {
  if (VEC) {
    const int c = c0 + 4 * lane;
    if (c < m) {
      const float4 t = *reinterpret_cast<const float4*>(row + c);
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.0f;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + lane + 32 * q;
      v[q] = c < m ? row[c * sm] : 0.0f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* row, int c0, int m, int lane,
                                       const float (&v)[4]) {
  if (VEC) {
    const int c = c0 + 4 * lane;
    if (c < m)
      *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + lane + 32 * q;
      if (c < m) row[c] = v[q];
    }
  }
}

// One block of threads per (n, m) block, the block held in shared memory.
// Phases, one barrier apart: load; row sums (a warp per row) and column
// partial sums (kGroups row groups per column); the means and the total;
// the centred block out.
template <bool VEC>
__global__ void __launch_bounds__(kSmallThreads)
center_small_kernel(View v, float* __restrict__ out) {
  extern __shared__ float sh[];
  const int n = v.n, m = v.m, z = blockIdx.x;
  float* kb = sh;                       // n * m
  float* cpart = kb + n * m;            // kSmallThreads
  float* rsum = cpart + kSmallThreads;  // n
  float* rmean = rsum + n;              // n
  float* cmean = rmean + n;             // m
  float* tot = cmean + m;               // 1
  const float* src = v.block(z);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int kW = kSmallThreads / 32;
  if (VEC) {
    const int m4 = m / 4;
#pragma unroll 4
    for (int e = tid; e < n * m4; e += kSmallThreads) {
      const int i = e / m4, j = e % m4;
      reinterpret_cast<float4*>(kb)[e] =
          *reinterpret_cast<const float4*>(src + i * v.sn + 4 * j);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < n * m; e += kSmallThreads) {
      const int i = e / m, j = e % m;
      kb[e] = src[i * v.sn + j * v.sm];
    }
  }
  __syncthreads();
  // row sums, four rows of a warp at a time so their shuffle trees overlap
  for (int i0 = 4 * warp; i0 < n; i0 += 4 * kW) {
    float s[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s[q] = 0.0f;
      if (i0 + q < n)
        for (int j = lane; j < m; j += 32) s[q] += kb[(i0 + q) * m + j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[q] += __shfl_xor_sync(0xffffffffu, s[q], off);
    if (lane < 4 && i0 + lane < n)
      rsum[i0 + lane] = lane == 0 ? s[0] : lane == 1 ? s[1] : lane == 2 ? s[2] : s[3];
  }
  // column partials: thread (g, j) sums rows g, g + G, ... of column j
  const int groups = m < kSmallThreads ? kSmallThreads / m : 1;
  if (groups > 1) {
    if (tid < groups * m) {
      const int g = tid / m, j = tid % m;
      float s = 0.0f;
      for (int i = g; i < n; i += groups) s += kb[i * m + j];
      cpart[tid] = s;
    }
  } else {
    for (int j = tid; j < m; j += kSmallThreads) {
      float s = 0.0f;
      for (int i = 0; i < n; ++i) s += kb[i * m + j];
      cmean[j] = s / n;
    }
  }
  __syncthreads();
  if (groups > 1 && tid < m) {
    float s = 0.0f;
    for (int g = 0; g < groups; ++g) s += cpart[g * m + tid];
    cmean[tid] = s / n;
  }
  for (int i = tid; i < n; i += kSmallThreads) rmean[i] = rsum[i] / m;
  if (warp == kW - 1) {
    float s = 0.0f;
    for (int i = lane; i < n; i += 32) s += rsum[i];
    s = warp_sum(s);
    if (lane == 0) tot[0] = s / ((float)n * (float)m);
  }
  __syncthreads();
  const float t = tot[0];
  float* o = out + (size_t)z * n * m;
  if (VEC) {
    const int m4 = m / 4;
    for (int e = tid; e < n * m4; e += kSmallThreads) {
      const int i = e / m4, j = 4 * (e % m4);
      const float4 kv = reinterpret_cast<const float4*>(kb)[e];
      const float r = rmean[i];
      reinterpret_cast<float4*>(o)[e] = make_float4(
          kv.x - cmean[j] - r + t, kv.y - cmean[j + 1] - r + t,
          kv.z - cmean[j + 2] - r + t, kv.w - cmean[j + 3] - r + t);
    }
  } else {
    for (int e = tid; e < n * m; e += kSmallThreads) {
      const int i = e / m, j = e % m;
      o[e] = kb[e] - cmean[j] - rmean[i] + t;
    }
  }
}

// Scratch of the two-pass path, per batch entry z (cb < CB column tiles,
// rs < RS row slabs): rowpart[z][cb][i], colpart[z][rs][j], totpart[z][rs][cb].
struct Plan {
  int rows;   // rows per slab (R)
  int rs;     // row slabs (RS)
  int cb;     // 128-column tiles (CB)
};

// grid (CB, RS, Z): tile = rows [rs*R, rs*R + R) x columns [cb*128, +128).
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
center_stats_kernel(View v, Plan p, float* __restrict__ rowpart,
                    float* __restrict__ colpart, float* __restrict__ totpart) {
  __shared__ float cpart[kWarps][kTileCols];
  __shared__ float wtot[kWarps];
  const int cb = blockIdx.x, rs = blockIdx.y, z = blockIdx.z;
  const int n = v.n, m = v.m;
  const int c0 = cb * kTileCols, r0 = rs * p.rows;
  const int r1 = min(n, r0 + p.rows);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* src = v.block(z);
  float col[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float wsum = 0.0f;
  float* rp = rowpart + ((size_t)z * p.cb + cb) * n;
  for (int i = r0 + warp; i < r1; i += kWarps) {
    float x[4];
    load4<VEC>(src + i * v.sn, c0, m, v.sm, lane, x);
#pragma unroll
    for (int q = 0; q < 4; ++q) col[q] += x[q];
    const float s = warp_sum((x[0] + x[1]) + (x[2] + x[3]));
    if (lane == 0) rp[i] = s;
    wsum += s;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) cpart[warp][lane_col<VEC>(lane, q)] = col[q];
  if (lane == 0) wtot[warp] = wsum;
  __syncthreads();
  if (tid < kTileCols && c0 + tid < m) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += cpart[w][tid];
    colpart[((size_t)z * p.rs + rs) * m + c0 + tid] = s;
  }
  if (tid == 0) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += wtot[w];
    totpart[((size_t)z * p.rs + rs) * p.cb + cb] = s;
  }
}

// Same grid and tiles as the stats pass.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
center_apply_kernel(View v, Plan p, const float* __restrict__ rowpart,
                    const float* __restrict__ colpart,
                    const float* __restrict__ totpart,
                    float* __restrict__ out) {
  extern __shared__ float rmean[];        // p.rows
  __shared__ float cmean[kTileCols];
  __shared__ float wtot[kWarps];
  const int cb = blockIdx.x, rs = blockIdx.y, z = blockIdx.z;
  const int n = v.n, m = v.m;
  const int c0 = cb * kTileCols, r0 = rs * p.rows;
  const int r1 = min(n, r0 + p.rows);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // total: the (RS, CB) tile totals in a fixed order
  {
    const float* tp = totpart + (size_t)z * p.rs * p.cb;
    float s = 0.0f;
    for (int e = tid; e < p.rs * p.cb; e += kThreads) s += tp[e];
    s = warp_sum(s);
    if (lane == 0) wtot[warp] = s;
  }
  if (tid < kTileCols && c0 + tid < m) {
    const float* cp = colpart + (size_t)z * p.rs * m + c0 + tid;
    float s = 0.0f;
    for (int r = 0; r < p.rs; ++r) s += cp[(size_t)r * m];
    cmean[tid] = s / n;
  }
  for (int i = r0 + tid; i < r1; i += kThreads) {
    const float* rp = rowpart + (size_t)z * p.cb * n + i;
    float s = 0.0f;
    for (int c = 0; c < p.cb; ++c) s += rp[(size_t)c * n];
    rmean[i - r0] = s / m;
  }
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += wtot[w];
  t /= (float)n * (float)m;
  const float* src = v.block(z);
  float* o = out + (size_t)z * n * m;
  float cm[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = lane_col<VEC>(lane, q);
    cm[q] = c0 + c < m ? cmean[c] : 0.0f;
  }
  for (int i = r0 + warp; i < r1; i += kWarps) {
    float x[4];
    load4<VEC>(src + i * v.sn, c0, m, v.sm, lane, x);
    const float r = rmean[i - r0];
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = x[q] - cm[q] - r + t;
    store4<VEC>(o + (size_t)i * m, c0, m, lane, x);
  }
}

// Shared memory the one-launch path takes for an (n, m) block: the block,
// the column partials, the row sums and means, the column means, the total.
long long small_smem(int n, int m) {
  return 4LL * ((long long)n * m + kSmallThreads + 2LL * n + m + 1);
}

int launch_small(const View& v, float* out, int z, int vec, cudaStream_t st) {
  const long long smem = small_smem(v.n, v.m);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  // opt in above 48 KB once per kernel, to the most any call has needed
  static long long opted[2] = {48 * 1024, 48 * 1024};
  if (smem > opted[vec ? 1 : 0]) {
    const cudaError_t e = cudaFuncSetAttribute(
        vec ? center_small_kernel<true> : center_small_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted[vec ? 1 : 0] = smem;
  }
  if (vec)
    center_small_kernel<true><<<z, kSmallThreads, smem, st>>>(v, out);
  else
    center_small_kernel<false><<<z, kSmallThreads, smem, st>>>(v, out);
  return (int)cudaGetLastError();
}

int launch_two_pass(const View& v, const Plan& p, float* scratch, float* out,
                    int z, int vec, cudaStream_t st) {
  if (p.rows < 1 || p.rows > 4096 || p.rs < 1 || p.rs > 65535 ||
      (long long)p.rows * p.rs < v.n ||
      p.cb != (v.m + kTileCols - 1) / kTileCols || z > 65535)
    return (int)cudaErrorInvalidValue;
  float* rowpart = scratch;
  float* colpart = rowpart + (size_t)z * p.cb * v.n;
  float* totpart = colpart + (size_t)z * p.rs * v.m;
  const dim3 grid(p.cb, p.rs, z);
  const size_t smem = (size_t)p.rows * 4;
  if (vec) {
    center_stats_kernel<true><<<grid, kThreads, 0, st>>>(v, p, rowpart,
                                                         colpart, totpart);
    center_apply_kernel<true><<<grid, kThreads, smem, st>>>(
        v, p, rowpart, colpart, totpart, out);
  } else {
    center_stats_kernel<false><<<grid, kThreads, 0, st>>>(v, p, rowpart,
                                                          colpart, totpart);
    center_apply_kernel<false><<<grid, kThreads, smem, st>>>(
        v, p, rowpart, colpart, totpart, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// k: z1 x z2 batch of (n, m) blocks at strides (s1, s2, sn, sm) elements;
// out (z1*z2, n, m) contiguous. rows == 0: the one-launch shared-memory
// path (scratch unused); else the two-pass path over slabs of `rows` rows
// (rows * slabs >= n, col_tiles = ceil(m / 128)), scratch holding rowpart
// (Z, col_tiles, n), colpart (Z, slabs, m) and totpart (Z, slabs,
// col_tiles). vec: sm == 1, m % 4 == 0 and every other stride and the base
// 16-byte aligned.
extern "C" int kpca_center(const float* k, float* scratch, float* out, int z1,
                           int z2, int n, int m, long long s1, long long s2,
                           long long sn, long long sm, int rows, int slabs,
                           int col_tiles, int vec, void* stream) {
  if (z1 < 1 || z2 < 1 || n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const View v{k, z2, n, m, s1, s2, sn, sm};
  cudaStream_t st = (cudaStream_t)stream;
  if (rows == 0) return launch_small(v, out, z1 * z2, vec, st);
  return launch_two_pass(v, Plan{rows, slabs, col_tiles}, scratch, out,
                         z1 * z2, vec, st);
}
