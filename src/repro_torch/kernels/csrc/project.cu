// Fused out-of-sample kPCA projection (the serving hot path):
//
//   scores[q, c] = sum_l K(xq_q, xs_l) A[l, c]
//                  + (1/L) * sum_l K(xq_q, xs_l) * cvec[c] + bvec[c]
//
// Replaces the TPU kernel src/repro/kernels/project/project.py:project_tiles
// (_project_kernel). As there, the (B, L) kernel block never reaches device
// memory and the row-sum for the centering term rides along as one extra
// column of A (all-ones over real support rows for project_op, the caller's
// indicator column for project_partial_op), so A here is (L, C+1).
//
// What bounds it on an H100: for B <= 128 queries against L in {500, 2000}
// support rows of M = 784 features, 2*B*L*M fp32 operations on the CUDA
// cores against one pass over the (L, M) support set: at B = 128 the
// operations dominate, at B = 8 the bytes do.
// What the design does about it: the TPU walks the support axis
// sequentially per query block; with B <= 128 one block per query tile
// would light 1-4 of the 132 SMs. So the grid splits the support axis too:
// block (chunk, qtile) takes 32 queries and one chunk of 32-row support
// tiles, forms each 32 x 32 K tile in registers (fp32 tile product +
// epilogue), parks it in shared memory, multiplies it by the matching
// (32, C+1) slice of A, and keeps the (32, C+1) partial in registers across
// its tiles. It writes that partial to scratch; a second small launch sums
// the chunks in a fixed order and applies the centering epilogue. No atomics:
// the chunking depends on L alone, so a query's scores are bit-identical
// however the engine batched it.

#include "tile.cuh"

namespace {

constexpr int kPQ = 32, kPL = 32, kPK = 32, kPT = 2;
constexpr int kCp1Max = 32;  // C + 1 <= 32 columns of A
using Dot = kpca::TileDot<kPQ, kPL, kPK, kPT, kPT>;
constexpr int kMaxPairs = kPQ * kCp1Max / Dot::NT;

__global__ void __launch_bounds__(Dot::NT)
project_partials_kernel(const float* __restrict__ xq,
                        const float* __restrict__ xs,
                        const float* __restrict__ a,
                        const float* __restrict__ ss,
                        const float* __restrict__ gamma,
                        float* __restrict__ scratch, int b, int l, int m,
                        int cp1, int tiles_per_chunk, kpca::Epilogue ep) {
  __shared__ float as[Dot::A_SMEM];
  __shared__ float bs[Dot::B_SMEM];
  __shared__ float ks[kPQ * (kPL + 1)];
  __shared__ float ac[kPL * kCp1Max];
  __shared__ float sq[kPQ];
  const int chunk = blockIdx.x, q0 = blockIdx.y * kPQ;
  const int tid = threadIdx.x;
  const int tx = tid % Dot::TX, ty = tid / Dot::TX;
  const float g = ep.kind == kpca::kRbf ? *gamma : 0.0f;

  // The query rows' squared norms (or self-kernels), computed here in a
  // fixed order — lane-strided partial sums, then a shuffle tree — so they
  // do not depend on how many rows the batch holds (a PyTorch reduction's
  // order can change with the tensor's shape).
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kPQ; r += Dot::NT / 32) {
    const int q = q0 + r;
    float s = 0.0f;
    if (q < b)
      for (int k = lane; k < m; k += 32) {
        const float v = xq[(size_t)q * m + k];
        s = fmaf(v, v, s);
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) sq[r] = ep.self_k(s);
  }
  __syncthreads();

  float part[kMaxPairs];
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) part[p] = 0.0f;

  const int n_tiles = (l + kPL - 1) / kPL;
  const int t_end = min((chunk + 1) * tiles_per_chunk, n_tiles);
  for (int t = chunk * tiles_per_chunk; t < t_end; ++t) {
    const int l0 = t * kPL;
    float acc[kPT][kPT];
    Dot::run(xq + (size_t)q0 * m, b - q0, xs + (size_t)l0 * m, l - l0, m, as,
             bs, acc);
#pragma unroll
    for (int i = 0; i < kPT; ++i) {
      const float av = sq[ty + i * Dot::TY];
#pragma unroll
      for (int j = 0; j < kPT; ++j) {
        const int c = tx + j * Dot::TX, li = l0 + c;
        // Rows past L get a zero A row below; zeroing K there too keeps a
        // non-finite epilogue value of a zero row out of the product.
        ks[(ty + i * Dot::TY) * (kPL + 1) + c] =
            li < l ? ep.apply(acc[i][j], av, ss[li], g) : 0.0f;
      }
    }
    for (int e = tid; e < kPL * cp1; e += Dot::NT) {
      const int r = e / cp1, c = e % cp1;
      ac[r * kCp1Max + c] = l0 + r < l ? a[(size_t)(l0 + r) * cp1 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kMaxPairs; ++p) {
      const int pair = tid + p * Dot::NT;
      if (pair < kPQ * cp1) {
        const int r = pair / cp1, c = pair % cp1;
        float s = 0.0f;
#pragma unroll 8
        for (int ll = 0; ll < kPL; ++ll)
          s = fmaf(ks[r * (kPL + 1) + ll], ac[ll * kCp1Max + c], s);
        part[p] += s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    const int pair = tid + p * Dot::NT;
    if (pair < kPQ * cp1) {
      const int r = pair / cp1, c = pair % cp1, q = q0 + r;
      if (q < b) scratch[((size_t)chunk * b + q) * cp1 + c] = part[p];
    }
  }
}

// Sum the chunks' partials in chunk order; with the epilogue, column C is the
// kernel row-sum and out is (B, C), else out is the raw (B, C+1) partials.
__global__ void project_finalize_kernel(const float* __restrict__ scratch,
                                        const float* __restrict__ cvec,
                                        const float* __restrict__ bvec,
                                        float* __restrict__ out, int n_chunks,
                                        int b, int cp1, int with_epilogue,
                                        float inv_l) {
  const int ncols = with_epilogue ? cp1 - 1 : cp1;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= b * ncols) return;
  const int q = idx / ncols, c = idx % ncols;
  float s = 0.0f;
  for (int ch = 0; ch < n_chunks; ++ch)
    s += scratch[((size_t)ch * b + q) * cp1 + c];
  if (with_epilogue) {
    float rowsum = 0.0f;
    for (int ch = 0; ch < n_chunks; ++ch)
      rowsum += scratch[((size_t)ch * b + q) * cp1 + cp1 - 1];
    s = s + (rowsum * inv_l) * cvec[c] + bvec[c];
  }
  out[(size_t)q * ncols + c] = s;
}

}  // namespace

extern "C" int kpca_project_partials(const float* xq, const float* xs,
                                     const float* a, const float* ss,
                                     const float* gamma,
                                     float* scratch, int b, int l, int m,
                                     int cp1, int tiles_per_chunk, int kind,
                                     int degree, float coef, float scale,
                                     int normalize, void* stream) {
  if (b < 1 || l < 1 || m < 1 || cp1 < 1 || cp1 > kCp1Max ||
      tiles_per_chunk < 1 || (b + kPQ - 1) / kPQ > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (l + kPL - 1) / kPL;
  const int n_chunks = (n_tiles + tiles_per_chunk - 1) / tiles_per_chunk;
  kpca::Epilogue ep{kind, degree, coef, scale, normalize};
  dim3 grid(n_chunks, (b + kPQ - 1) / kPQ);
  project_partials_kernel<<<grid, Dot::NT, 0, (cudaStream_t)stream>>>(
      xq, xs, a, ss, gamma, scratch, b, l, m, cp1, tiles_per_chunk, ep);
  return (int)cudaGetLastError();
}

extern "C" int kpca_project_finalize(const float* scratch, const float* cvec,
                                     const float* bvec, float* out,
                                     int n_chunks, int b, int cp1,
                                     int with_epilogue, float inv_l,
                                     void* stream) {
  if (n_chunks < 1 || b < 1 || cp1 < 1 || (with_epilogue && cp1 < 2))
    return (int)cudaErrorInvalidValue;
  const int total = b * (with_epilogue ? cp1 - 1 : cp1);
  project_finalize_kernel<<<(total + 255) / 256, 256, 0,
                            (cudaStream_t)stream>>>(
      scratch, cvec, bvec, out, n_chunks, b, cp1, with_epilogue, inv_l);
  return (int)cudaGetLastError();
}
