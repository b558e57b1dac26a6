// S2 and S3: tensor-core products in TF32 and 3xTF32 for Hopper, the
// counterparts of the Pallas kernels of scripts/microtest_sublane_reduce.py
// (S2: an axis-0 sum of [R, w] as a ones-row product, at the TPU's default
// and HIGHEST precisions) and scripts/microtest_blkdiag_dot.py (S3:
// [R, p*w] x [p*w, p*w] block-diagonal products x @ W and x @ W^T at both
// precisions).  The TPU's default f32 dot runs bf16 passes; Hopper's
// counterpart is a TF32 tensor-core product (10-bit mantissa, f32
// accumulation), and HIGHEST's is 3xTF32: each operand split into a TF32
// big part and a TF32 small part (x - big), and
//     a @ b ~ big_a @ small_b + small_a @ big_b + big_a @ big_b,
// which recovers about f32 accuracy.  S2's third mode, the plain f32
// column sum, is the fixed-order row sum of csrc/pairwise.cu (pw_sum_rows).
//
// S3's design (tf32_gemm_kernel): mma.sync.aligned.m16n8k8.row.col.f32.tf32
// with both operands staged in shared memory.  A block owns 16 rows of C (one
// m16 tile) against up to 128 columns (all of them at S3's N = 120) and
// walks K in stages of 64, two stage buffers in shared memory: at S3's
// [2048, 120] x [120, 120] that is 128 blocks on 132 SMs (one wave), each
// with two stages (k 0-63 and 64-119) that together hold its 16 x 120 slab
// of A and all of B.  A thread loads its share of a stage into registers
// (16 bytes a load where the rows allow it, all of its loads issued before
// any is used: at most 9), rounds each value to TF32 once (to nearest, ties
// away: cvt.rna's bits, by two integer operations, rna_tf32) and, for 3xTF32,
// splits it into its big and small parts once, and stores them; the next
// stage's loads fly while this one is multiplied.  The first design read
// both operands straight from device memory and rounded an A value at each
// of its 15 n-tiles.  B is stored as it lies in device memory, [k][n] for x @ W
// and [n][k] for x @ W^T (W [N, K]); the fragment addressing follows the
// layout, so neither direction transposes on load.  Row strides: k-rows (A;
// B of x @ W^T) of 68 floats, n-rows (B of x @ W) of 120 floats (136 where
// the columns are a multiple of 16), so that each fragment read of a warp
// hits 32 different banks (gemm_ld_k, gemm_ld_n).  Shared memory at S3's
// shape: TF32 2 x (16 x 68 + 64 x 120) x 4 = 70,144 B for x @ W and
// 2 x (16 x 68 + 120 x 68) x 4 = 73,984 B for x @ W^T; 3xTF32 twice that
// (140,288 and 147,968 B); at most 156,672 B (128 columns).  Eight warps a
// block: warp w owns the 8-column tiles w and w + 8 (two of S3's 15, one
// for warp 7) and keeps each k-step's A fragment in registers across them.
// Rows, columns and k past the edges are staged as 0.  Per k-step and tile
// the products run in the first design's order, big.small, small.big,
// big.big (3xTF32), and the k-steps in k order, so every entry sees the same
// sequence of mma.sync as before and the plain version and the rounding
// bounds hold as they did.
//
// Fragment layout (PTX ISA, m16n8k8 .tf32), with g = lane / 4 and
// t = lane % 4:
//     A: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//     B: b0 (k = t, n = g), b1 (k = t + 4, n = g)
//     C: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
//
// What bounds it on an H100: at S3's shape 2.0 MB of traffic (A read, C
// written) and 59 MFLOP, 0.6 us at 3.35 TB/s and 0.12 us at 495 TFLOP/s
// TF32: bytes.  A launch of a few microseconds is bound by latency: a
// block's staging (load, round, store, barrier) and each warp's 15
// dependent k-steps on a tile are two chains, and the host paces the call.
// Taller slabs (kGemmRows 32 or 64, or 64 x 64 tiles) move less from L2 but
// lengthen both chains and measured slower (scripts/ablate_s3.py).  S2's and S3's kernels exist to measure the error
// envelope of TF32 and 3xTF32 products at the KMV MLP's width 20.  wgmma and
// TMA are later work.
//
// S2's ones-row product has a kernel of its own, tf32_column_sum_kernel:
// out[c] = sum_r x[r][c] as the m16n8k8 product x^T [w, R] @ ones [R, 8]
// with x on the A side (a warp's A fragment is 16 columns x 8 rows of x, so
// the M dimension carries 16 live columns) and the ones operand a constant
// register fragment (TF32 1.0 is exact; nothing is loaded for it).  3xTF32
// keeps two products a k-step, small(x) then big(x): small(1) = 0, so the
// big_a @ small_b product is exactly zero and dropped.  The rows are split
// into the chunks of csrc/row_chunks.cuh (a multiple of 8 rows, at least
// 64), a warp runs one chunk's k-steps for its 16 columns with the C
// fragment as the running sum (the loads of four k-steps issued before their
// products), and the block of rank 0 of the cluster adds the chunk sums in
// chunk order through distributed shared memory.  The general
// tf32_gemm_kernel on ones [1, R] @ x would give [2048, 120] 15 warps of 256
// dependent k-steps each, 15 of A's 16 rows zero, and a ones row to fill.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"
#include "row_chunks.cuh"

namespace {

constexpr int kGemmWarps = 8;
constexpr int kGemmRows = 16;                             // rows of C a block: m16 tiles
constexpr int kGemmCols = 128;                            // columns of C a block, at most
constexpr int kGemmDepth = 64;                            // k a stage, at most
constexpr int kGemmBuffers = 2;                           // stages in shared memory at once
constexpr int kGemmRowTiles = kGemmRows / 16;             // m16 tiles a block; a warp owns one
constexpr int kGemmColGroups = kGemmWarps / kGemmRowTiles;  // warps on one m16 tile
constexpr int kGemmTiles = kGemmCols / 8 / kGemmColGroups;  // 8-column tiles a warp, at most
static_assert(kGemmRows % 16 == 0 && kGemmWarps % kGemmRowTiles == 0, "whole m16 tiles, whole warps a tile");

__host__ __device__ constexpr int round8(int x) { return (x + 7) / 8 * 8; }

// Row strides in shared memory (floats) that keep the fragment reads of a
// warp on 32 different banks.  Rows along k (A, and B for x @ W^T) are read
// at g * ld + t: ld = 4 (mod 8) puts the 8 rows g on 8 different groups of
// four banks.  Rows along n (B for x @ W) are read at t * ld + g: ld = 8 or
// 24 (mod 32) puts the 4 rows t on 4 different groups of eight banks.
__host__ __device__ constexpr int gemm_ld_k(int depth) { return depth + 4; }
__host__ __device__ constexpr int gemm_ld_n(int cols) { return cols % 16 == 0 ? cols + 8 : cols; }

// floats of one stage's buffer (A and B, big parts and, for 3xTF32, small)
__host__ __device__ constexpr int gemm_buffer_floats(bool split, bool bt, int nb) {
  return (split ? 2 : 1) *
         (kGemmRows * gemm_ld_k(kGemmDepth) + (bt ? nb * gemm_ld_k(kGemmDepth) : kGemmDepth * gemm_ld_n(nb)));
}

// dynamic shared memory of a tf32_gemm_kernel block (bytes)
size_t gemm_shared_bytes(bool split, bool bt, int N) {
  return sizeof(float) * kGemmBuffers * gemm_buffer_floats(split, bt, std::min(kGemmCols, round8(N)));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x rounded to TF32, to nearest with ties away from zero: for finite x the
// bits that cvt.rna.tf32.f32 gives (and ops/cuda/mma_tf32.py round_tf32), by
// two integer operations at the ALUs' full rate
__device__ __forceinline__ float rna_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// A stage's tile of a row-major source (rows x cols, cols a multiple of 8,
// cols / 4 <= 32) is moved four floats a thread: the lanes of a warp cover
// 32 / (cols / 4) rows side by side, the warps of the block the next rows,
// in `passes` passes.  TileMap is that mapping.
struct TileMap {
  int c;      // the thread's first column
  int r0;     // its first row
  int step;   // rows between its passes
  bool on;    // whether the thread has columns at all
};

__device__ __forceinline__ TileMap tile_map(int cols) {
  const int units = cols / 4;
  const int per = 32 / units;
  const int lane = threadIdx.x & 31;
  return {4 * (lane % units), (static_cast<int>(threadIdx.x) >> 5) * per + lane / units, kGemmWarps * per,
          lane < per * units};
}

// The thread's share of the tile into registers: one 16-byte load where `vec`
// (the source's rows 16-byte aligned) and all four floats lie inside, every
// load of the thread issued before any is used; entries past rows_in or
// cols_in are 0.
template <int PASSES>
__device__ __forceinline__ void load_tile(float4 (&v)[PASSES], const float* __restrict__ src, int ld_src,
                                          int rows, int rows_in, int cols, int cols_in, bool vec) {
  const TileMap m = tile_map(cols);
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const int r = m.r0 + i * m.step;
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (m.on && r < rows && r < rows_in) {
      const float* p = src + static_cast<size_t>(r) * ld_src + m.c;
      if (vec && m.c + 3 < cols_in) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(p));
        x[0] = q.x;
        x[1] = q.y;
        x[2] = q.z;
        x[3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = m.c + j < cols_in ? __ldg(p + j) : 0.0f;
      }
    }
    v[i] = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// The thread's share, rounded to TF32 once, into shared memory at row stride
// ld (big) and, for 3xTF32, the rounded rest x - big (small).
template <bool SPLIT, int PASSES>
__device__ __forceinline__ void store_tile(const float4 (&v)[PASSES], float* big, float* small, int ld, int rows,
                                           int cols) {
  const TileMap m = tile_map(cols);
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const int r = m.r0 + i * m.step;
    if (!m.on || r >= rows) continue;
    const float x[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
    float b[4], sm[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = rna_tf32(x[j]);
      sm[j] = rna_tf32(x[j] - b[j]);
    }
    *reinterpret_cast<float4*>(big + r * ld + m.c) = make_float4(b[0], b[1], b[2], b[3]);
    if constexpr (SPLIT) *reinterpret_cast<float4*>(small + r * ld + m.c) = make_float4(sm[0], sm[1], sm[2], sm[3]);
  }
}

// passes of a stage's tiles: A is kGemmRows rows of at most kGemmDepth; B is
// kGemmDepth rows of at most kGemmCols (x @ W) or at most kGemmCols rows of
// kGemmDepth (x @ W^T), so at most 8 passes of 8 warps
constexpr int kRowsAPass = kGemmWarps * (32 / (kGemmDepth / 4));
constexpr int kPassesA = (kGemmRows + kRowsAPass - 1) / kRowsAPass;
constexpr int kPassesB = 8;
static_assert(kGemmDepth <= kPassesB * kGemmWarps && kGemmCols <= kPassesB * kGemmWarps * (32 / (kGemmDepth / 4)),
              "B in kPassesB passes");

// S3's product: a block owns kGemmRows rows of C against up to kGemmCols
// columns (all of them at S3's N = 120) and walks K in stages of at most
// kGemmDepth.  Each stage copies its slab of A and its slab of B into shared
// memory with 16-byte loads where the rows allow them, rounding every value
// to TF32 once (3xTF32: also its small part, once), then syncs; warp w owns
// m16 tile w % kGemmRowTiles and its 8-column tiles c, c + kGemmColGroups,
// ... (c = w / kGemmRowTiles), and keeps a k-step's A fragment in registers
// across them.  B is stored as it lies in device memory: [k][n]
// for x @ W, [n][k] for x @ W^T, with the fragment addressing chosen by the
// template, so neither direction transposes on load.
template <bool SPLIT, bool BT>
__global__ void __launch_bounds__(32 * kGemmWarps)
    tf32_gemm_kernel(int M, int N, int K, const float* __restrict__ A, int lda, bool a_vec,
                     const float* __restrict__ B, int ldb, bool b_vec, float* __restrict__ C, int ldc) {
  extern __shared__ float4 gemm_smem4[];
  constexpr int kParts = SPLIT ? 2 : 1;
  const int row0 = blockIdx.x * kGemmRows;
  const int n0 = blockIdx.y * kGemmCols;
  const int nb = min(kGemmCols, round8(N - n0));  // this block's columns
  const int lda_s = gemm_ld_k(kGemmDepth);
  const int ldb_s = BT ? gemm_ld_k(kGemmDepth) : gemm_ld_n(nb);
  const int a_floats = kGemmRows * lda_s;
  const int b_floats = (BT ? nb : kGemmDepth) * ldb_s;
  const int buffer = gemm_buffer_floats(SPLIT, BT, nb);
  // buffer b: A big | A small | B big | B small
  float* const smem = reinterpret_cast<float*>(gemm_smem4);
  auto a_big = [&](int b) { return smem + b * buffer; };
  auto b_big = [&](int b) { return smem + b * buffer + kParts * a_floats; };
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int m16 = 16 * (warp % kGemmRowTiles);  // the warp's first row in the block
  const int col_group = warp / kGemmRowTiles;
  const int n_tiles = nb / 8;
  const int n_stages = (K + kGemmDepth - 1) / kGemmDepth;
  // stage s: k from s kGemmDepth, staged in buffer s % 2
  float4 va[kPassesA], vb[kPassesB];
  auto load = [&](int s) {
    const int kb = s * kGemmDepth;
    const int kc = min(kGemmDepth, round8(K - kb));
    load_tile(va, A + static_cast<size_t>(row0) * lda + kb, lda, kGemmRows, M - row0, kc, K - kb, a_vec);
    if constexpr (BT) {
      load_tile(vb, B + static_cast<size_t>(n0) * ldb + kb, ldb, nb, N - n0, kc, K - kb, b_vec);
    } else {
      load_tile(vb, B + static_cast<size_t>(kb) * ldb + n0, ldb, kc, K - kb, nb, N - n0, b_vec);
    }
  };
  auto store = [&](int s) {
    const int kc = min(kGemmDepth, round8(K - s * kGemmDepth));
    float* ab = a_big(s % kGemmBuffers);
    float* bb = b_big(s % kGemmBuffers);
    store_tile<SPLIT>(va, ab, ab + a_floats, lda_s, kGemmRows, kc);
    store_tile<SPLIT>(vb, bb, bb + b_floats, ldb_s, BT ? nb : kc, BT ? kc : nb);
  };
  float d[kGemmTiles][4];
#pragma unroll
  for (int j = 0; j < kGemmTiles; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.0f;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < n_stages; ++s) {
    // the next stage's loads fly while this one is multiplied
    if (s + 1 < n_stages) load(s + 1);
    const int kc = min(kGemmDepth, round8(K - s * kGemmDepth));
    float* const a_b = a_big(s % kGemmBuffers);
    float* const a_s = a_b + a_floats;
    float* const b_b = b_big(s % kGemmBuffers);
    float* const b_s = b_b + b_floats;
#pragma unroll
    for (int k0 = 0; k0 < kGemmDepth; k0 += 8) {
      if (k0 >= kc) break;
      // A: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
      const int a0 = (m16 + g) * lda_s + k0 + t;
      const int a_at[4] = {a0, a0 + 8 * lda_s, a0 + 4, a0 + 8 * lda_s + 4};
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ab[i] = __float_as_uint(a_b[a_at[i]]);
        if constexpr (SPLIT) as[i] = __float_as_uint(a_s[a_at[i]]);
      }
#pragma unroll
      for (int j = 0; j < kGemmTiles; ++j) {
        const int tile = col_group + j * kGemmColGroups;
        if (tile >= n_tiles) break;  // warp-uniform
        // B: b0 (k = t, n = g), b1 (k = t + 4, n = g)
        const int n = tile * 8 + g;
        const int b0 = BT ? n * ldb_s + k0 + t : (k0 + t) * ldb_s + n;
        const int b1 = BT ? b0 + 4 : b0 + 4 * ldb_s;
        const uint32_t bb[2] = {__float_as_uint(b_b[b0]), __float_as_uint(b_b[b1])};
        if constexpr (SPLIT) {
          const uint32_t bs[2] = {__float_as_uint(b_s[b0]), __float_as_uint(b_s[b1])};
          mma_tf32(d[j], ab, bs);
          mma_tf32(d[j], as, bb);
        }
        mma_tf32(d[j], ab, bb);
      }
    }
    if (s + 1 < n_stages) {  // the other buffer was last read before the previous barrier
      store(s + 1);
      __syncthreads();
    }
  }
  const int r = row0 + m16 + g;
#pragma unroll
  for (int j = 0; j < kGemmTiles; ++j) {
    const int tile = col_group + j * kGemmColGroups;
    if (tile >= n_tiles) break;
    const int c = n0 + tile * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ri = r + (i >= 2 ? 8 : 0);
      const int ci = c + (i & 1);
      if (ri < M && ci < N) C[static_cast<size_t>(ri) * ldc + ci] = d[j][i];
    }
  }
}

constexpr uint32_t kOneTf32 = 0x3f800000u;  // 1.0f, exact in TF32

// out [w] = the column sums of x [R, w] (row-major) on the tensor cores in
// TF32 (SPLIT false) or 3xTF32, in the chunk order of plan p (16-column
// slabs).
template <bool SPLIT>
__global__ void __launch_bounds__(32 * row_chunks::kWarps)
    tf32_column_sum_kernel(const float* __restrict__ x, float* __restrict__ out, int R, int w,
                           row_chunks::Plan p) {
  __shared__ float sums[row_chunks::kWarps * 16];  // [warp][column of its slab]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  int chunk, slab;
  row_chunks::position(p, warp, &chunk, &slab);
  const int col0 = (static_cast<int>(blockIdx.x) * p.slabs_per_block + slab) * 16;
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (chunk < p.n_chunks && col0 < w) {  // warp-uniform, as mma.sync needs
    const bool lo = col0 + g < w;
    const bool hi = col0 + g + 8 < w;
    const uint32_t ones[2] = {kOneTf32, kOneTf32};
    const int r1 = min(R, (chunk + 1) * p.chunk);
    for (int k0 = chunk * p.chunk; k0 < r1; k0 += 32) {
      // A fragments of four k-steps: a0 (col g, row t), a1 (g + 8, t),
      // a2 (g, t + 4), a3 (g + 8, t + 4); rows past the chunk load 0
      float v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ra = k0 + 8 * i + t;
        const int rb = ra + 4;
        const float* xa = x + static_cast<size_t>(ra) * w + col0 + g;
        const float* xb = x + static_cast<size_t>(rb) * w + col0 + g;
        v[i][0] = lo && ra < r1 ? __ldg(xa) : 0.0f;
        v[i][1] = hi && ra < r1 ? __ldg(xa + 8) : 0.0f;
        v[i][2] = lo && rb < r1 ? __ldg(xb) : 0.0f;
        v[i][3] = hi && rb < r1 ? __ldg(xb + 8) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (k0 + 8 * i >= r1) break;  // warp-uniform
        uint32_t big[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) big[j] = to_tf32(v[i][j]);
        if constexpr (SPLIT) {
          uint32_t small[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) small[j] = to_tf32(v[i][j] - __uint_as_float(big[j]));
          mma_tf32(d, small, ones);
        }
        mma_tf32(d, big, ones);
      }
    }
  }
  // every C column is the same sum: d[0] is column col0 + g, d[2] col0 + g + 8
  if (p.n_chunks == 1) {  // grid-uniform: the chunk sum is the sum
    if (t == 0 && col0 + g < w) out[col0 + g] = d[0];
    if (t == 0 && col0 + g + 8 < w) out[col0 + g + 8] = d[2];
    return;
  }
  if (t == 0) {
    sums[warp * 16 + g] = d[0];
    sums[warp * 16 + g + 8] = d[2];
  }
  row_chunks::sync(p);
  // warp w < slabs_per_block of rank 0 holds chunk 0 of slab w
  if (blockIdx.y == 0 && warp < p.slabs_per_block && lane < 16 && col0 + lane < w) {
    out[col0 + lane] = row_chunks::add_chunks<16>(p, sums, slab, lane);
  }
  row_chunks::sync(p);  // no block leaves while rank 0 reads its shared memory
}

// tf32_matmul's shared-memory limit, per instantiation [2 SPLIT + BT]: its
// calls take microseconds, so it is raised once (launch::allow_shared_once)
size_t gemm_allowed[4][launch::kMaxDevices];

template <bool SPLIT, bool BT>
cudaError_t launch_gemm(int device, int M, int N, int K, const float* A, int lda, bool a_vec, const float* B,
                        int ldb, bool b_vec, float* C, int ldc, cudaStream_t st) {
  const size_t smem = gemm_shared_bytes(SPLIT, BT, N);
  const cudaError_t err =
      launch::allow_shared_once(tf32_gemm_kernel<SPLIT, BT>, smem, device, gemm_allowed[2 * SPLIT + BT]);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kGemmRows - 1) / kGemmRows, (N + kGemmCols - 1) / kGemmCols);
  tf32_gemm_kernel<SPLIT, BT><<<grid, 32 * kGemmWarps, smem, st>>>(M, N, K, A, lda, a_vec, B, ldb, b_vec, C, ldc);
  return cudaGetLastError();
}

}  // namespace

// S2's column sum: out [w] = sum over the rows of x [R, w] (row-major) on
// `stream` in TF32 (split = 0) or 3xTF32 (split = 1); returns a CUDA error
// code (0 on success).
extern "C" int tf32_column_sum(int device, int split, int R, int w, const float* x, float* out,
                               void* stream) {
  if (R <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const row_chunks::Plan p = row_chunks::plan(R, w, 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = split ? row_chunks::launch(p, st, tf32_column_sum_kernel<true>, x, out, R, w, p)
              : row_chunks::launch(p, st, tf32_column_sum_kernel<false>, x, out, R, w, p);
  return static_cast<int>(err);
}

// Plain C entry point, bound with ctypes: C [M, N] (row stride ldc) = A [M, K]
// (row stride lda) @ W (transpose_b = 0: W [K, N]) or @ W^T (transpose_b = 1:
// W [N, K]), W's row stride ldb, on `stream` in TF32 (split = 0) or 3xTF32
// (split = 1); returns a CUDA error code (0 on success).  Validation of
// shapes, strides and devices is the wrapper's.
extern "C" int tf32_matmul(int device, int split, int transpose_b, int M, int N, int K, const float* A,
                           int lda, const float* B, int ldb, float* C, int ldc, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || device < 0 || device >= launch::kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool a_vec = lda % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const bool b_vec = ldb % 4 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split) {
    err = transpose_b ? launch_gemm<true, true>(device, M, N, K, A, lda, a_vec, B, ldb, b_vec, C, ldc, st)
                      : launch_gemm<true, false>(device, M, N, K, A, lda, a_vec, B, ldb, b_vec, C, ldc, st);
  } else {
    err = transpose_b ? launch_gemm<false, true>(device, M, N, K, A, lda, a_vec, B, ldb, b_vec, C, ldc, st)
                      : launch_gemm<false, false>(device, M, N, K, A, lda, a_vec, B, ldb, b_vec, C, ldc, st);
  }
  return static_cast<int>(err);
}
