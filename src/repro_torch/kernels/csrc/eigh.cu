// Batched symmetric eigendecomposition by two-sided cyclic Jacobi, one block
// per matrix, A and V in shared memory:
//
//   A = V diag(lam) V^T,  lam ascending, V's columns the eigenvectors
//
// (torch.linalg.eigh's layout; only A's lower triangle is read, as there).
//
// Replaces no TPU kernel: the JAX package calls jnp.linalg.eigh. It takes
// the place of cuSOLVER's batched Jacobi (torch.linalg.eigh on the card) in
// the fit's set-up, where the J node Grams (80 x 100 x 100 fp32 at the
// paper's Fig. 3 size) took 122 ms of device time in 21,041 launches, about
// 5.8 us of work each, and a host synchronisation: about 60 % of a fit.
//
// What bounds it on an H100: neither bytes nor operations. A sweep costs
// about 9 n^3 flops with the vectors, about 7 GFLOP for the 80 Grams over
// ten sweeps (0.1 ms on the CUDA cores), and the matrices and vectors are
// 9.6 MB read and written once (3 us). What bounds it is the chain of
// dependent rounds: a sweep is n - 1 rounds of n / 2 disjoint rotations, and
// each round waits for the last one (two block-wide barriers a round, about
// 1,000 rounds a solve at n = 100), and within a round shared memory: a
// round reads and writes about 3.5 n^2 words of A and V. On the card, n =
// 100, a round takes about 2,650 cycles (clock64 in one block): 1,300-1,450
// in the step on A and about 950 in the step on V.
// What the design does about it: one block of 1024 threads per matrix holds
// A and V (rows padded to an odd stride, against bank conflicts) in shared
// memory for the whole solve, so a round touches no device memory and the
// whole batch is one launch. Pairs follow the round-robin (circle) order, so
// the n / 2 pairs of a round are disjoint. A round has two steps. First
// every 2 x 2 block of A between two pairs is rotated on both sides at once
// by one thread, which writes the block and its mirror image (A stays
// exactly symmetric, and a round reads half of A instead of all of it
// twice); a pair's own block takes a_pp - t a_pq, a_qq + t a_pq and an exact
// zero off the diagonal. Then, while the first warps compute the next
// round's rotations from the new A (Rutishauser's formulas, theta =
// (a_qq - a_pp) / 2 a_pq, t = sign(theta) / (|theta| + sqrt(theta^2 + 1)),
// c = 1 / sqrt(t^2 + 1), s = t c), the other warps rotate V's column pairs
// by this round's, so the rotations' chain of divisions and square roots
// hides behind V's update. A rotation is one float4 (c, s, t and the pair's
// indices); a thread of the V step takes one pair and reads it once, then
// that pair's rows vrow, vrow + g, ... Odd n is padded by a zero row and
// column that never rotates. (Tried and no faster: V transposed, four rows
// a float4; the A step reading the second pair's c, s alone.)
// Stopping: a pair rotates only while its off-diagonal exceeds both
// eps sqrt(|a_pp| |a_qq|) (negligible against the pair's diagonals) and
// eps ||A||_F / n, so that at the end the off-diagonal part's Frobenius norm
// is at most eps max(||A||_F, sum |a_ii|) (cuSOLVER's syevj stops at
// eps ||A||_F); a sweep that rotates no pair ends the solve, and kMaxSweeps
// caps it. The sweeps used are written out per matrix (0: A held NaN or
// inf, and lam and V are NaN). Everything is IEEE fp32 on the CUDA cores
// (fmaf, sqrtf and division correctly rounded), no library call. The
// eigenvalues are ranked in the kernel (ties by index, NaN last) and V's
// columns are written out in that order, each divided by its norm.

#include <cuda_runtime.h>
#include <float.h>

#include "tile.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 168;          // A and V at 168 x 169 floats: 227 KB
constexpr int kMaxSweeps = 32;      // cuSOLVER's Jacobi: 100; 6-10 suffice
constexpr int kSmemMax = 232448;    // a block's shared memory after opt-in
// 2 x 2 blocks of A a thread rotates: (n/2)(n/2 + 1)/2 over the threads
constexpr int kBlockItems =
    ((kMaxN / 2) * (kMaxN / 2 + 1) / 2 + kThreads - 1) / kThreads;

// Bytes of shared memory for n (padded to even np): A and V at np x (np + 1)
// floats; two rounds' rotations, a float4 (c, s, t, p | q << 16) a pair;
// the norm's warp partials; three sweep flags.
__host__ __device__ __forceinline__ size_t smem_bytes(int n) {
  const size_t np = n + (n & 1), ld = np + 1;
  return 4 * (2 * np * ld + 2 * 4 * (np / 2) + kWarps + 3);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Index at position pos of round r in the circle order over np indices:
// position 0 stays, the others turn by one each round.
__device__ __forceinline__ int circle(int pos, int r, int np) {
  if (pos == 0) return 0;
  const int k = pos - 1 + r;
  return 1 + (k < np - 1 ? k : k - (np - 1));
}

// Pair k's rotation in round r, from A as it stands: (c, s, t, p | q << 16),
// t = 0 (c = 1, s = 0) where the pair's off-diagonal is negligible; a
// rotation sets *flag.
__device__ __forceinline__ float4 rotation(const float* a, int ld, int np,
                                           int k, int r, float floor_off,
                                           int* flag) {
  const int p = circle(k, r, np), q = circle(np - 1 - k, r, np);
  const float app = a[p * ld + p], aqq = a[q * ld + q];
  const float apq = a[p * ld + q], off = fabsf(apq);
  float c = 1.0f, s = 0.0f, t = 0.0f;
  if (off > floor_off &&
      off > FLT_EPSILON * sqrtf(fabsf(app)) * sqrtf(fabsf(aqq))) {
    const float theta = (aqq - app) / (2.0f * apq);
    t = 1.0f / (fabsf(theta) + sqrtf(fmaf(theta, theta, 1.0f)));
    if (theta < 0.0f) t = -t;
    c = 1.0f / sqrtf(fmaf(t, t, 1.0f));
    s = t * c;
    *flag = 1;
  }
  return make_float4(c, s, t, __int_as_float(p | q << 16));
}

__global__ void __launch_bounds__(kThreads)
jacobi_eigh_kernel(const float* __restrict__ in, float* __restrict__ lam,
                   float* __restrict__ vec, int* __restrict__ sweeps_out,
                   int n) {
  extern __shared__ float smem[];
  const int np = n + (n & 1), ld = np + 1, m = np / 2;
  float* a = smem;
  float* v = a + np * ld;
  float4* rot = reinterpret_cast<float4*>(v + np * ld);   // [2][m]
  float* part = reinterpret_cast<float*>(rot + 2 * m);
  int* flag = reinterpret_cast<int*>(part + kWarps);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long mat = blockIdx.x;
  in += mat * n * n;
  vec += mat * n * n;
  lam += mat * n;

  // V = I, the padding row and column of A zero
  for (int idx = tid; idx < np * np; idx += kThreads) {
    const int i = idx / np, j = idx - i * np;
    v[i * ld + j] = i == j ? 1.0f : 0.0f;
    if (i == n || j == n) a[i * ld + j] = 0.0f;
  }
  // A from the lower triangle, mirrored; ||A||_F^2 on the way
  float sq = 0.0f;
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx - i * n;
    if (i >= j) {
      const float x = in[idx];
      a[i * ld + j] = x;
      a[j * ld + i] = x;
      sq = fmaf(i == j ? x : 2.0f * x, x, sq);
    }
  }
  sq = warp_sum(sq);
  if (lane == 0) part[warp] = sq;
  if (tid < 3) flag[tid] = 0;
  __syncthreads();
  float fro2 = 0.0f;
  for (int w = 0; w < kWarps; ++w) fro2 += part[w];
  if (!(fro2 <= FLT_MAX)) {         // NaN or inf in A: NaN out, no sweep
    const float nan = __int_as_float(0x7fc00000);
    for (int idx = tid; idx < n * n; idx += kThreads) vec[idx] = nan;
    for (int i = tid; i < n; i += kThreads) lam[i] = nan;
    if (tid == 0) sweeps_out[mat] = 0;
    return;                         // the whole block: fro2 is uniform
  }
  const float floor_off = FLT_EPSILON * sqrtf(fro2) / n;

  // this thread's 2 x 2 blocks (pair P <= pair Q), row by row of the
  // triangle, packed P << 16 | Q; -1: none
  int item[kBlockItems];
  {
    const int blocks = m * (m + 1) / 2;
#pragma unroll
    for (int k = 0; k < kBlockItems; ++k) {
      int idx = tid + k * kThreads;
      item[k] = -1;
      if (idx < blocks) {
        int p = 0;
        while (idx >= m - p) {
          idx -= m - p;
          ++p;
        }
        item[k] = (p << 16) | (p + idx);
      }
    }
  }
  // The first warps compute the next round's rotations while the others
  // rotate V by this round's: vthreads threads, g a pair, each taking the
  // pair's rows vrow, vrow + g, ... (one rotation read, then rows alone).
  const int rot_threads = 32 * ((m + 31) / 32);
  const int vthreads = kThreads - rot_threads, vtid = tid - rot_threads;
  const int g = vthreads / m, vpair = vtid / g, vrow = vtid - vpair * g;

  // flag[s % 3]: sweep s rotated a pair. It is set while the rotations of
  // sweep s are computed (the first ones during sweep s - 1), read after
  // its last barrier, and cleared during sweep s - 1, after sweep s - 2's
  // was read.
  if (tid < m) rot[tid] = rotation(a, ld, np, tid, 0, floor_off, &flag[1]);
  __syncthreads();
  int sweep = 1, cur = 0;
  for (;; ++sweep) {
    int* now = &flag[sweep % 3];
    int* next = &flag[(sweep + 1) % 3];
    for (int r = 0; r < np - 1; ++r, cur ^= 1) {
      const float4* rc = rot + cur * m;
      if (r == 0 && tid == kThreads - 1) *next = 0;
#pragma unroll
      for (int k = 0; k < kBlockItems; ++k) {   // A <- J^T A J, by blocks
        if (item[k] < 0) continue;
        const int bp = item[k] >> 16, bq = item[k] & 0xffff;
        const float4 r1 = rc[bp], r2 = rc[bq];
        if (r1.z == 0.0f && r2.z == 0.0f) continue;
        const int pq1 = __float_as_int(r1.w);
        const int p = pq1 & 0xffff, q = pq1 >> 16;
        if (bp == bq) {
          const float apq = a[p * ld + q];
          a[p * ld + p] = fmaf(-r1.z, apq, a[p * ld + p]);
          a[q * ld + q] = fmaf(r1.z, apq, a[q * ld + q]);
          a[p * ld + q] = 0.0f;
          a[q * ld + p] = 0.0f;
          continue;
        }
        const int pq2 = __float_as_int(r2.w);
        const int u = pq2 & 0xffff, w = pq2 >> 16;
        const float c1 = r1.x, s1 = r1.y, c2 = r2.x, s2 = r2.y;
        const float apu = a[p * ld + u], apw = a[p * ld + w];
        const float aqu = a[q * ld + u], aqw = a[q * ld + w];
        // rows by P's rotation, then columns by Q's
        const float rpu = c1 * apu - s1 * aqu, rpw = c1 * apw - s1 * aqw;
        const float rqu = s1 * apu + c1 * aqu, rqw = s1 * apw + c1 * aqw;
        const float npu = c2 * rpu - s2 * rpw, npw = s2 * rpu + c2 * rpw;
        const float nqu = c2 * rqu - s2 * rqw, nqw = s2 * rqu + c2 * rqw;
        a[p * ld + u] = npu;
        a[u * ld + p] = npu;
        a[p * ld + w] = npw;
        a[w * ld + p] = npw;
        a[q * ld + u] = nqu;
        a[u * ld + q] = nqu;
        a[q * ld + w] = nqw;
        a[w * ld + q] = nqw;
      }
      __syncthreads();
      if (tid < rot_threads) {                 // the next round's rotations
        if (tid < m) {
          const bool last = r == np - 2;       // next: the next sweep's first
          rot[(cur ^ 1) * m + tid] = rotation(
              a, ld, np, tid, last ? 0 : r + 1, floor_off, last ? next : now);
        }
      } else if (vpair < m) {                  // V <- V J, by column pairs
        const float4 rk = rc[vpair];
        if (rk.z != 0.0f) {
          const int pq = __float_as_int(rk.w);
          float* vp = v + vrow * ld + (pq & 0xffff);
          float* vq = v + vrow * ld + (pq >> 16);
          for (int i = vrow; i < n; i += g, vp += g * ld, vq += g * ld) {
            const float xp = *vp, xq = *vq;
            *vp = rk.x * xp - rk.y * xq;
            *vq = rk.y * xp + rk.x * xq;
          }
        }
      }
      __syncthreads();
    }
    if (!*now || sweep == kMaxSweeps) break;
  }

  // rank the eigenvalues ascending (NaN last, ties by index): lam[rank] and
  // the column of V it takes; V's column norms: the rotations' roundings
  // drift them from 1 by up to about 2e-5 at n = 100, so the columns are
  // divided by them (both kept in the rotations' space, free now)
  int* perm = reinterpret_cast<int*>(rot);
  float* norm = reinterpret_cast<float*>(rot) + np;
  const float inf = __int_as_float(0x7f800000);
  for (int j = warp; j < n; j += kWarps) {
    float acc = 0.0f;
    for (int i = lane; i < n; i += 32)
      acc = fmaf(v[i * ld + j], v[i * ld + j], acc);
    acc = warp_sum(acc);
    if (lane == 0) norm[j] = sqrtf(acc);
  }
  for (int i = tid; i < n; i += kThreads) {
    const float di = a[i * ld + i];
    const float ki = di != di ? inf : di;
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const float dj = a[j * ld + j];
      const float kj = dj != dj ? inf : dj;
      rank += kj < ki || (kj == ki && j < i);
    }
    lam[rank] = di;
    perm[rank] = i;
  }
  if (tid == 0) sweeps_out[mat] = sweep;
  __syncthreads();
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx - i * n;
    const int col = perm[j];
    vec[idx] = v[i * ld + col] / norm[col];
  }
}

}  // namespace

// in, vec (batch, n, n), lam (batch, n) fp32 and sweeps (batch,) int32,
// contiguous; 1 <= n <= kMaxN.
extern "C" int kpca_sym_eigh(const float* in, float* lam, float* vec,
                             int* sweeps, int batch, int n, void* stream) {
  if (batch < 1 || n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  static int opted[kpca::kMaxDevices] = {};
  const cudaError_t e =
      kpca::opt_in_smem(jacobi_eigh_kernel, (int)kSmemMax, opted);
  if (e != cudaSuccess) return (int)e;
  jacobi_eigh_kernel<<<batch, kThreads, smem_bytes(n),
                       (cudaStream_t)stream>>>(in, lam, vec, sweeps, n);
  return (int)cudaGetLastError();
}
