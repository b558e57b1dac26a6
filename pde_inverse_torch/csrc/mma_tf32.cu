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
// Design: the first tensor-core code of the port, kept simple so that it
// can be held against a float64 product.  One warp computes one 16 x 8 tile
// of C = A @ B with mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32,
// walking K in steps of 8 and loading its fragments straight from device
// memory (rows and columns past the edges load 0).  B is addressed through
// strides, so x @ W and x @ W^T are one kernel.  Fragment layout (PTX ISA,
// m16n8k8 .tf32), with g = lane / 4 and t = lane % 4:
//     A: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//     B: b0 (k = t, n = g), b1 (k = t + 4, n = g)
//     C: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
//
// What bounds it on an H100: at S2's and S3's shapes ([2048, 120] x
// [120, 120] at most) a few MB of traffic and under 0.1 GFLOP, so a launch
// takes microseconds and is bound by latency; these kernels exist to measure
// the error envelope of TF32 and 3xTF32 products at the KMV MLP's width 20,
// which a tensor-core redesign of K7/K8 needs.  Fast tensor-core products
// (wgmma, TMA, shared-memory staging) are later work.
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

#include <cstdint>

#include <cuda_runtime.h>

#include "row_chunks.cuh"

namespace {

constexpr int kWarps = 4;

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

// C [M, N] (row stride ldc) = A [M, K] (row stride lda) @ B, B[k][n] at
// B + k * sbk + n * sbn.  SPLIT: 3xTF32.
template <bool SPLIT>
__global__ void __launch_bounds__(32 * kWarps)
    tf32_gemm_kernel(int M, int N, int K, const float* __restrict__ A, int lda,
                     const float* __restrict__ B, long long sbk, long long sbn,
                     float* __restrict__ C, int ldc) {
  const int warp = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_tiles = (N + 7) / 8;
  const int m_tiles = (M + 15) / 16;
  if (warp >= m_tiles * n_tiles) return;
  const int row0 = (warp / n_tiles) * 16;
  const int col0 = (warp % n_tiles) * 8;
  const int g = lane / 4;
  const int t = lane % 4;
  auto a_at = [&](int r, int c) {
    return r < M && c < K ? A[static_cast<size_t>(r) * lda + c] : 0.0f;
  };
  auto b_at = [&](int k, int n) {
    return k < K && n < N ? B[k * sbk + n * sbn] : 0.0f;
  };
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float av[4] = {a_at(row0 + g, k0 + t), a_at(row0 + g + 8, k0 + t),
                         a_at(row0 + g, k0 + t + 4), a_at(row0 + g + 8, k0 + t + 4)};
    const float bv[2] = {b_at(k0 + t, col0 + g), b_at(k0 + t + 4, col0 + g)};
    uint32_t a_big[4], b_big[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) a_big[i] = to_tf32(av[i]);
#pragma unroll
    for (int i = 0; i < 2; ++i) b_big[i] = to_tf32(bv[i]);
    if constexpr (SPLIT) {
      uint32_t a_small[4], b_small[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a_small[i] = to_tf32(av[i] - __uint_as_float(a_big[i]));
#pragma unroll
      for (int i = 0; i < 2; ++i) b_small[i] = to_tf32(bv[i] - __uint_as_float(b_big[i]));
      mma_tf32(d, a_big, b_small);
      mma_tf32(d, a_small, b_big);
    }
    mma_tf32(d, a_big, b_big);
  }
  const int r = row0 + g;
  const int c = col0 + 2 * t;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ri = r + (i >= 2 ? 8 : 0);
    const int ci = c + (i & 1);
    if (ri < M && ci < N) C[static_cast<size_t>(ri) * ldc + ci] = d[i];
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

// Plain C entry point, bound with ctypes: C = A @ B on `stream` in TF32
// (split = 0) or 3xTF32 (split = 1); returns a CUDA error code (0 on
// success).  Validation of shapes, strides and devices is the wrapper's.
extern "C" int tf32_matmul(int device, int split, int M, int N, int K, const float* A, int lda,
                           const float* B, long long sbk, long long sbn, float* C, int ldc,
                           void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>((M + 15) / 16) * ((N + 7) / 8);
  const dim3 grid(static_cast<unsigned>((tiles + kWarps - 1) / kWarps));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split) {
    tf32_gemm_kernel<true><<<grid, 32 * kWarps, 0, st>>>(M, N, K, A, lda, B, sbk, sbn, C, ldc);
  } else {
    tf32_gemm_kernel<false><<<grid, 32 * kWarps, 0, st>>>(M, N, K, A, lda, B, sbk, sbn, C, ldc);
  }
  return static_cast<int>(cudaGetLastError());
}
