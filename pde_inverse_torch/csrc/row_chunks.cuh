// The fixed summation order of the column sums over rows: sum_rows
// (csrc/pairwise.cu) and tf32_column_sum (csrc/mma_tf32.cu).
//
// out[e] = sum over rows r of part[r][e] is taken as
//     out[e] = (..((s_0 + s_1) + s_2) + ..) + s_{n_chunks - 1},
//     s_c    = (..((0 + part[c C][e]) + part[c C + 1][e]) + ..)
// over chunks of C consecutive rows (the last one ragged), so the order
// depends on (rows, len) alone and two calls are bitwise equal.  With
// rows <= C it is plain row order, and C >= 64: K5-K8 finish up to one
// partial row a ref split, and a masked ref's split adds a row of zeros, so
// below 64 splits dropping a masked ref changes no bit of the sums (rows of
// zeros add exactly 0.0 in row order, but would move the chunk boundaries).
// On the card a warp sums one chunk for a slab of columns (a lane a column);
// the warps of one slab sit in one block and, past 8 chunks, in the blocks
// of one thread-block cluster along the rows (grid.y, so the cluster rank is
// blockIdx.y), and the block of rank 0 adds the chunk sums in chunk order
// through distributed shared memory: one launch, no scratch, no atomics.
// pde_inverse_torch/ops/cuda/row_chunks.py::sum_rows_plan is the Python twin
// (checked against sum_rows_plan_c on the card).

#pragma once

#include <utility>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace row_chunks {

constexpr int kWarps = 8;       // warps a block
constexpr int kMaxCluster = 8;  // blocks a cluster (the portable maximum)
constexpr int kMinChunk = 64;   // least rows a chunk

struct Plan {
  int chunk;            // rows a chunk, a multiple of 8 (an m16n8k8 k-step)
  int n_chunks;         // <= kWarps * kMaxCluster
  int warps_per_slab;   // warps of a block along the rows: 1, 2, 4 or 8
  int cluster;          // blocks of a cluster along the rows
  int slabs_per_block;  // kWarps / warps_per_slab
  long long blocks;     // blocks along the columns (grid.x)
};

// The plan for part [rows, len] in slabs of `slab` columns a warp.
inline Plan plan(long long rows, long long len, int slab) {
  Plan p;
  const long long per_chunk = (rows + kWarps * kMaxCluster - 1) / (kWarps * kMaxCluster);
  const long long chunk = (per_chunk + 7) / 8 * 8;
  p.chunk = static_cast<int>(chunk > kMinChunk ? chunk : kMinChunk);
  p.n_chunks = static_cast<int>((rows + p.chunk - 1) / p.chunk);
  p.warps_per_slab = 1;
  while (p.warps_per_slab < p.n_chunks && p.warps_per_slab < kWarps) p.warps_per_slab *= 2;
  p.cluster = (p.n_chunks + p.warps_per_slab - 1) / p.warps_per_slab;
  p.slabs_per_block = kWarps / p.warps_per_slab;
  const long long slabs = (len + slab - 1) / slab;
  p.blocks = (slabs + p.slabs_per_block - 1) / p.slabs_per_block;
  return p;
}

// This warp's (chunk, slab within the block) under plan p.
__device__ __forceinline__ void position(const Plan& p, int warp, int* chunk, int* slab) {
  *slab = warp % p.slabs_per_block;
  *chunk = static_cast<int>(blockIdx.y) * p.warps_per_slab + warp / p.slabs_per_block;
}

// Block-wide (one block along the rows) or cluster-wide barrier.
__device__ __forceinline__ void sync(const Plan& p) {
  if (p.cluster == 1) {
    __syncthreads();
  } else {
    cooperative_groups::this_cluster().sync();
  }
}

// In the block of rank 0: sum over the chunks, in order, of the partial at
// `col` of slab `slab`, out of every block's sums [kWarps][COLS] (warp w
// holds chunk w / slabs_per_block of slab w % slabs_per_block).  Call
// between two sync(p)s.
template <int COLS>
__device__ __forceinline__ float add_chunks(const Plan& p, float* sums, int slab, int col) {
  float total = 0.0f;
  if (p.cluster == 1) {
    for (int c = 0; c < p.n_chunks; ++c) total += sums[(c * p.slabs_per_block + slab) * COLS + col];
    return total;
  }
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
#pragma unroll 8
  for (int c = 0; c < p.n_chunks; ++c) {
    const float* src = cluster.map_shared_rank(sums, c / p.warps_per_slab);
    total += src[((c % p.warps_per_slab) * p.slabs_per_block + slab) * COLS + col];
  }
  return total;
}

// Launches `kernel` over plan p: grid (blocks, cluster), kWarps warps a
// block, clusters of p.cluster blocks along y (a plain launch for one).
template <typename... Params, typename... Args>
cudaError_t launch(const Plan& p, cudaStream_t st, void (*kernel)(Params...), Args&&... args) {
  if (p.cluster == 1) {
    kernel<<<static_cast<unsigned>(p.blocks), 32 * kWarps, 0, st>>>(std::forward<Args>(args)...);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.blocks), static_cast<unsigned>(p.cluster), 1);
  cfg.blockDim = dim3(32 * kWarps, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = static_cast<unsigned>(p.cluster);
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace row_chunks
