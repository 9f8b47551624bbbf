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
// support rows of M = 784 features, the 2*B*L*M products of the dot block.
// On the tensor cores at fp32 grade (3xTF32, as in csrc/gram.cu: three
// products per fp32 one, 495 TFLOP/s) they take 2.4 us at B128 x L2000; one
// pass over the support set takes 1.9 us at 3.35 TB/s. At B8 the bytes
// dominate, and in practice the latency of a short dependent chain.
//
// What the design does about it, in three launches from one C call:
//  1. the split pass (hopper.cuh: tf32_split_kernel), one block per query:
//     the query less the shift row, split into its TF32 halves hi = rna(x),
//     lo = rna(x - hi) at a row stride padded to 32 floats, and its squared
//     norm (or self-kernel) in a fixed order. The support set goes through
//     the same pass once per model (kpca_project_support below, from
//     kernels/project/project.py:prepare_support). For rbf the shift is the
//     support's mean row: distances stay, but the norms and dot products
//     whose difference forms them shrink (about 15x on the served models),
//     and so does the rounding the difference amplifies. Without it the
//     scores missed fp32 grade on the card (2.2-2.7x the plain version's
//     error against float64): the tensor cores' fp32 accumulation is not
//     round-to-nearest, and an error of one sign adds up over the support.
//  2. project_partials_kernel: wgmma.mma_async m64n32k8 .tf32 with 64 support
//     rows on M and 32 queries on N, the two small terms before hi.hi at each
//     k-step, into a per-stage fragment added into the running fp32 sum
//     (gram's accumulation scheme). One producer warp streams 32-feature
//     stages of both operands' halves into a ring with TMA (128-byte swizzle,
//     rows past the edge zero-filled), each stage completing on an mbarrier.
//     Enough blocks: a block takes one 64-row support tile, NQ <= 4 query
//     tiles (one wgmma each per k-step on the shared support stage; NQ is a
//     template argument so that no branch separates the wgmma instructions)
//     and one of KS slices of the feature axis, KS a function of L only
//     (project.py:support_chunking): with T = ceil(L / 64) support tiles, the
//     largest of 1, 2, 4, 8 with T * KS <= 66, half the SMs. Grid = (T * KS,
//     ceil(B / (32 NQ))): L500 -> 8 x 8 = 64 blocks, L2000 -> 32 x 2 = 64
//     blocks, at every B <= 128. The KS blocks of a tile form a thread-block
//     cluster; each finishes 32 NQ / KS of the query columns. Every block
//     stores its partial dot products of a column straight into the shared
//     memory of the block that finishes it (distributed shared memory, no
//     wait); after a cluster barrier the partials are summed in rank order,
//     then the kernel epilogue (kpca::Epilogue), then the (64 x C+1) product
//     with A.
//     The tile's (B, C+1) partial goes to scratch.
//  3. project_finalize_kernel sums the tiles' partials in tile order and
//     applies the centering epilogue.
// Batch invariance: the MMA's N is 32 for every B, the feature slices and
// the tile order depend on L alone, and a query's norm is summed in an order
// fixed by M, so a query's scores are bit-identical however the engine
// batched it. No atomics.
//
// scripts/project_ablate.py times copies of this file edited by exact text:
// the three wgmma_tf32 lines of the main loop, the `nk` line and the heads
// of the two epilogue loops. A change to any of them goes into its VARIANTS
// too.

#include <cooperative_groups.h>

#include "hopper.cuh"
#include "tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 64;                     // support rows per block (M)
constexpr int kQTile = 32;                    // queries per wgmma (N)
constexpr int kQTiles = 4;                    // query tiles per block, most
constexpr int kCp1Max = 32;                   // C + 1 <= 32 columns of A
constexpr int kThreads = 128 + 32;            // consumer warpgroup + producer
constexpr int kSupBytes = kRows * kTileK * 4;   // one support hi or lo tile
constexpr int kQBytes = kQTile * kTileK * 4;    // one query hi or lo tile
constexpr int kRedStride = kRows + 1;

// Shared memory of a block with nq query tiles and ks feature slices, past
// 1024-byte alignment: the ring; the cluster's partial dot tiles of this
// block's columns, red[slice][support row][column]; the epilogue's operands
// (the tile of A, the support rows' and the columns' norms); the barriers.
// After the main loop the ring holds the finished K block.
struct Layout {
  int stages = 0, stage_bytes = 0, red_stride = 0, red_off = 0, ac_off = 0,
      ss_off = 0, sq_off = 0, bar_off = 0, total = 0;
};

__host__ __device__ constexpr Layout layout(int nq, int ks) {
  Layout s{};
  s.stages = nq <= 2 ? 4 : 3;
  s.stage_bytes = 2 * kSupBytes + 2 * nq * kQBytes;
  s.red_stride = nq * kQTile / ks + 2;      // float2 rows, fewer conflicts
  s.red_off = s.stages * s.stage_bytes;
  s.ac_off = s.red_off + ks * kRows * s.red_stride * 4;
  s.ss_off = s.ac_off + kRows * kCp1Max * 4;
  s.sq_off = s.ss_off + kRows * 4;
  s.bar_off = s.sq_off + kQTiles * kQTile * 4;
  s.total = s.bar_off + 2 * s.stages * 8;
  return s;
}

struct Maps {
  CUtensorMap sh, sl, qh, ql;
};

// KS feature slices per support tile (the cluster), NQ query tiles per
// block.
template <int KS, int NQ>
__global__ void __launch_bounds__(kThreads, 1)
project_partials_kernel(const __grid_constant__ Maps maps,
                        const float* __restrict__ sq,
                        const float* __restrict__ a,
                        const float* __restrict__ ss,
                        const float* __restrict__ gamma,
                        float* __restrict__ scratch, int b, int l, int mp,
                        int cp1, kpca::Epilogue ep) {
  constexpr Layout lay = layout(NQ, KS);
  constexpr int ncl = NQ * kQTile / KS;  // query columns this block finishes
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* bp = smem_raw + (base - raw);

  const int tile = blockIdx.x / KS, rank = blockIdx.x % KS;
  const int row0 = tile * kRows;
  const int qb = blockIdx.y * NQ * kQTile;
  const int kt = mp / kTileK;
  const int k_begin = rank * kt / KS, nk = (rank + 1) * kt / KS - k_begin;
  const uint32_t full0 = base + lay.bar_off;
  const uint32_t empty0 = full0 + 8 * lay.stages;
  float* red = reinterpret_cast<float*>(bp + lay.red_off);
  float* ac = reinterpret_cast<float*>(bp + lay.ac_off);
  float* ssb = reinterpret_cast<float*>(bp + lay.ss_off);
  float* sqb = reinterpret_cast<float*>(bp + lay.sq_off);
  const int cl0 = rank * ncl;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < lay.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // A block may store into another's shared memory only once that block
  // runs: arrive here, wait before the first such store.
  if constexpr (KS > 1)
    asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");

  if (tid >= 128) {
    // -- producer warp: one thread keeps the ring full ---------------------
    if (tid == 128) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % lay.stages;
        mbar_wait(empty0 + 8 * s, ((it / lay.stages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t st = base + s * lay.stage_bytes;
        const int c0 = (k_begin + it) * kTileK;
        mbar_expect_tx(full, lay.stage_bytes);
        tma_load_3d(st, &maps.sh, full, c0, row0, 0);
        tma_load_3d(st + kSupBytes, &maps.sl, full, c0, row0, 0);
#pragma unroll
        for (int qt = 0; qt < NQ; ++qt) {
          const uint32_t qa = st + 2 * kSupBytes + qt * 2 * kQBytes;
          tma_load_3d(qa, &maps.qh, full, c0, qb + qt * kQTile, 0);
          tma_load_3d(qa + kQBytes, &maps.ql, full, c0, qb + qt * kQTile, 0);
        }
      }
    } else {
      // the other 31 lanes stage the epilogue's operands meanwhile
      for (int e = tid - 129; e < kRows * cp1; e += 31) {
        const int r = e / cp1, c = e % cp1;
        ac[r * kCp1Max + c] =
            row0 + r < l ? a[(size_t)(row0 + r) * cp1 + c] : 0.0f;
      }
      for (int r = tid - 129; r < kRows; r += 31)
        ssb[r] = row0 + r < l ? ss[row0 + r] : 0.0f;
      for (int c = tid - 129; c < ncl; c += 31)
        sqb[c] = qb + cl0 + c < b ? sq[qb + cl0 + c] : 0.0f;
    }
    if constexpr (KS > 1) asm volatile("barrier.cluster.wait;" ::: "memory");
  } else {
    // -- consumer warpgroup ------------------------------------------------
    const int warp = tid / 32, lane = tid % 32;
    float acc[NQ][16], part[NQ][16];
#pragma unroll
    for (int qt = 0; qt < NQ; ++qt)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[qt][i] = part[qt][i] = 0.0f;
    for (int it = 0; it < nk; ++it) {
      const int s = it % lay.stages;
      mbar_wait(full0 + 8 * s, (it / lay.stages) & 1);
      const uint32_t st = base + s * lay.stage_bytes;
      const uint64_t sh = sw128_desc(st), sl = sw128_desc(st + kSupBytes);
#pragma unroll
      for (int qt = 0; qt < NQ; ++qt) fence_acc(part[qt]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileK / 8; ++kk) {
#pragma unroll
        for (int qt = 0; qt < NQ; ++qt) {
          const uint32_t qa = st + 2 * kSupBytes + qt * 2 * kQBytes;
          const uint64_t qh = sw128_desc(qa), ql = sw128_desc(qa + kQBytes);
          wgmma_tf32(part[qt], sl + 2 * kk, qh + 2 * kk, kk > 0);
          wgmma_tf32(part[qt], sh + 2 * kk, ql + 2 * kk, 1);
          wgmma_tf32(part[qt], sh + 2 * kk, qh + 2 * kk, 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int qt = 0; qt < NQ; ++qt) fence_acc(part[qt]);
      mbar_arrive(empty0 + 8 * s);
#pragma unroll
      for (int qt = 0; qt < NQ; ++qt)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[qt][i] += part[qt][i];
    }
    if constexpr (KS > 1) asm volatile("barrier.cluster.wait;" ::: "memory");
    // The partial dot tile goes to the blocks that finish its columns:
    // column c to rank c / ncl, into its red[this rank][row][c % ncl], two
    // neighbouring columns per store. The stores into other blocks' shared
    // memory need no wait; the cluster barrier below makes them visible.
#pragma unroll
    for (int qt = 0; qt < NQ; ++qt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = qt * kQTile + 8 * j + 2 * (lane % 4);
        float* dst = red + rank * kRows * lay.red_stride + c % ncl;
        if constexpr (KS > 1)
          dst = cg::this_cluster().map_shared_rank(dst, c / ncl);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + lane / 4 + 8 * h;
          *reinterpret_cast<float2*>(dst + r * lay.red_stride) = make_float2(
              acc[qt][4 * j + 2 * h], acc[qt][4 * j + 2 * h + 1]);
        }
      }
  }

  // -- every slice's partial has arrived: finish this block's columns -------
  if constexpr (KS > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
  // The ring is free (every stage consumed, its wgmma reads waited on); it
  // now holds the finished K block.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  float* kb = reinterpret_cast<float*>(bp);
  const float g = ep.kind == kpca::kRbf ? *gamma : 0.0f;
#pragma unroll 4
  for (int e = tid; e < ncl * kRows; e += kThreads) {
    const int c = e % ncl, r = e / ncl;
    float dot = 0.0f;
#pragma unroll
    for (int k = 0; k < KS; ++k)
      dot += red[(k * kRows + r) * lay.red_stride + c];
    // Rows past L get a zero A row; zeroing K there too keeps a non-finite
    // epilogue value of a zero row out of the product.
    kb[c * kRedStride + r] = row0 + r < l && qb + cl0 + c < b
                                 ? ep.apply(dot, sqb[c], ssb[r], g)
                                 : 0.0f;
  }
  __syncthreads();
  // (column, coefficient) pairs, four lanes each: a lane sums 16 support
  // rows, then two shuffles add the four quarters in a fixed order
  const int quarter = tid % 4;
  for (int e0 = 0; e0 < ncl * cp1 * 4; e0 += kThreads) {
    const int pair = (e0 + tid) / 4;
    const bool live = pair < ncl * cp1;
    const int c = live ? pair / cp1 : 0, j = live ? pair % cp1 : 0;
    float s = 0.0f;
#pragma unroll
    for (int r = quarter * 16; r < quarter * 16 + 16; ++r)
      s = fmaf(kb[c * kRedStride + r], ac[r * kCp1Max + j], s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const int q = qb + cl0 + c;
    if (live && quarter == 0 && q < b)
      scratch[((size_t)tile * b + q) * cp1 + j] = s;
  }
}

// Sum the tiles' partials in tile order; with the epilogue, column C is the
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
#pragma unroll 8
  for (int ch = 0; ch < n_chunks; ++ch)
    s += scratch[((size_t)ch * b + q) * cp1 + c];
  if (with_epilogue) {
    float rowsum = 0.0f;
#pragma unroll 8
    for (int ch = 0; ch < n_chunks; ++ch)
      rowsum += scratch[((size_t)ch * b + q) * cp1 + cp1 - 1];
    s = s + (rowsum * inv_l) * cvec[c] + bvec[c];
  }
  out[(size_t)q * ncols + c] = s;
}

template <int KS, int NQ>
int launch_partials(const Maps& maps, const float* sq, const float* a,
                    const float* ss, const float* gamma, float* scratch, int b,
                    int l, int mp, int cp1, kpca::Epilogue ep,
                    cudaStream_t stream) {
  constexpr int smem = 1024 + layout(NQ, KS).total;
  static int opted[kpca::kMaxDevices] = {};
  const cudaError_t oe =
      kpca::opt_in_smem(project_partials_kernel<KS, NQ>, smem, opted);
  if (oe != cudaSuccess) return (int)oe;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((l + kRows - 1) / kRows * KS,
                     (b + NQ * kQTile - 1) / (NQ * kQTile), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = KS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = KS > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, project_partials_kernel<KS, NQ>,
                                     maps, sq, a, ss, gamma, scratch, b, l,
                                     mp, cp1, ep);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

typedef int (*LaunchFn)(const Maps&, const float*, const float*, const float*,
                        const float*, float*, int, int, int, int,
                        kpca::Epilogue, cudaStream_t);

// [log2 KS][NQ - 1]
constexpr LaunchFn kLaunch[4][kQTiles] = {
    {launch_partials<1, 1>, launch_partials<1, 2>, launch_partials<1, 3>,
     launch_partials<1, 4>},
    {launch_partials<2, 1>, launch_partials<2, 2>, launch_partials<2, 3>,
     launch_partials<2, 4>},
    {launch_partials<4, 1>, launch_partials<4, 2>, launch_partials<4, 3>,
     launch_partials<4, 4>},
    {launch_partials<8, 1>, launch_partials<8, 2>, launch_partials<8, 3>,
     launch_partials<8, 4>}};

}  // namespace

// xq (b, m) contiguous queries, fp32, or bf16 where xq_bf16 is set (widened
// on load by the split pass, the only part that reads them); sh, sl (l, mp)
// the TF32 halves of the
// support rows less shift, at a row stride mp (a multiple of 32, zero past
// m); shift (m,) subtracted from each query too, or NULL; a (l, cp1); ss
// (l,); gamma 0-d; scratch: the queries' halves (b, mp) twice and their
// norms (b,), then (ceil(l / 64), b, cp1) partials; ks feature slices (1, 2,
// 4, 8); out (b, cp1 - 1) with the epilogue, else (b, cp1). Three launches,
// one C call.
extern "C" int kpca_project(const void* xq, int xq_bf16, const float* sh,
                            const float* sl,
                            const float* shift, const float* a,
                            const float* ss, const float* gamma,
                            float* scratch, const float* cvec,
                            const float* bvec, float* out, int b, int l,
                            int m, int mp, int cp1, int ks, int with_epilogue,
                            float inv_l, int kind, int degree, float coef,
                            float scale, int normalize, void* stream) {
  const int ks_log2 =
      ks == 1 ? 0 : ks == 2 ? 1 : ks == 4 ? 2 : ks == 8 ? 3 : -1;
  if (b < 1 || l < 1 || m < 1 || mp < m || mp % kTileK != 0 || cp1 < 1 ||
      cp1 > kCp1Max || (with_epilogue && cp1 < 2) || ks_log2 < 0 ||
      (b + kQTiles * kQTile - 1) / (kQTiles * kQTile) > 65535)
    return (int)cudaErrorInvalidValue;
  float* qh = scratch;
  float* ql = qh + (size_t)b * mp;
  float* sq = ql + (size_t)b * mp;
  float* partials = sq + b;
  Maps maps;
  if (!encode(&maps.sh, sh, 1, l, mp, kRows) ||
      !encode(&maps.sl, sl, 1, l, mp, kRows) ||
      !encode(&maps.qh, qh, 1, b, mp, kQTile) ||
      !encode(&maps.ql, ql, 1, b, mp, kQTile))
    return (int)cudaErrorInvalidValue;
  kpca::Epilogue ep{kind, degree, coef, scale, normalize};
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      xq_bf16 ? tf32_split<kSplitThreads>(
                    static_cast<const __nv_bfloat16*>(xq), shift, qh, ql, sq,
                    b, m, mp, ep, s)
              : tf32_split<kSplitThreads>(static_cast<const float*>(xq),
                                          shift, qh, ql, sq, b, m, mp, ep, s);
  if (e != cudaSuccess) return (int)e;
  // query tiles per block: up to four, as many as the batch fills
  const int nq = min(kQTiles, (b + kQTile - 1) / kQTile);
  const int rc = kLaunch[ks_log2][nq - 1](maps, sq, a, ss, gamma, partials, b,
                                         l, mp, cp1, ep, s);
  if (rc != 0) return rc;
  const int total = b * (with_epilogue ? cp1 - 1 : cp1);
  project_finalize_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      partials, cvec, bvec, out, (l + kRows - 1) / kRows, b, cp1,
      with_epilogue, inv_l);
  return (int)cudaGetLastError();
}

// The per-model half of the operands: xs (l, m) contiguous support rows less
// shift (m,) (NULL: none) into sh, sl (l, mp) and their norms (rbf) or
// self-kernels ss (l,), by the pass that splits the queries per call. One
// launch.
extern "C" int kpca_project_support(const float* xs, const float* shift,
                                    float* sh, float* sl, float* ss, int l,
                                    int m, int mp, int kind, int degree,
                                    float coef, float scale, int normalize,
                                    void* stream) {
  if (l < 1 || m < 1 || mp < m || mp % kTileK != 0)
    return (int)cudaErrorInvalidValue;
  const kpca::Epilogue ep{kind, degree, coef, scale, normalize};
  return (int)tf32_split<kSplitThreads>(xs, shift, sh, sl, ss, l, m, mp, ep,
                                        (cudaStream_t)stream);
}
