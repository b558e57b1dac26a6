// K3 and K4: the fused per-point {grad V, v^T Hess V v} pass of a
// PotentialMLP, forward (K3) and its VJP (K4), for Hopper.
//
// K3 replaces pde_inverse_tpu/ops/pallas/pointwise_kernel.py::_fwd_kernel
// (entry mlp_grad_quad).  Given the first-layer streams (z1, d_v z1,
// d_v^2 z1) [n, w0] and the layers after the first, it propagates the three
// second-order streams through every layer, forms quad = 2 sum(dz_L^2 +
// z_L d2z_L) of the sum-of-squares head and runs the reverse sweep
// delta <- (delta W^T) * act'(z_k) from 2 z_L down to delta = dV/dz1.
//
// K4 replaces pointwise_kernel.py::_bwd_kernel (entry mlp_grad_quad_bwd):
// the VJP of K3 for the cotangents (g_quad [n], g_delta [n, w0]).  It runs
// four forward streams (z, p, q, r with r0 = g_delta), the head cotangents,
// and one reverse sweep that needs act''' and sums the weight gradients.
//
// Both keep a tile's streams in shared memory feature-major with the points
// minor ([stream][feature][point], rows of tile + 4 floats), so that one
// float4 read gives four points of one feature, and both take widths in
// multiples of 8 (the wrapper zero-pads, exactly).
//
// K3's design.
//  * Register-tiled products.  A pair of lanes (l and l + 16 of a warp, each
//    reducing over half the rows, then exchanging sums) owns four points by
//    four output features of the three streams z, p, q: one float4 of
//    weights and three of streams feed 48 FMAs (the first design: one weight
//    and three float4s for 12).  The reverse sweep's products (one stream,
//    delta W^T) are the same routine with four points by four features.
//  * Only what the reverse sweep needs is kept: the pre-activation z_k of
//    every layer's input, p and q of the current layer's input, one
//    activated copy (h, hp, hq) of it, and for the last layer, the widest,
//    one chunk of at most 64 output features at a time.  A chunk's z_L, p_L,
//    q_L stay in registers: the lane pair adds p_L^2 + z_L q_L over its four
//    features into one partial a point (quad's sum over the chunks runs in a
//    fixed order), writes 2 z_L into the chunk's rows, and the chunk's
//    product 2 z_L W_L^T is added into running sums over the rows that p and
//    q no longer need; after the last chunk the step back through
//    act'(z_{L-1}) writes delta over z_{L-1}, and so on down to z_1.  The
//    256-wide layer is never held whole.
//  * Two blocks an SM.  At the full width (64 -> 64 -> 256) a 32-point tile
//    takes 528 rows of 36 floats, 76 KB, and __launch_bounds__(256, 2) caps a
//    thread at 128 registers, so 16 warps share an SM.  Chains that leave no
//    room for two blocks get one (k3_plan in ops/cuda/pointwise.py decides,
//    k3_shared_bytes_c here computes the same bytes).
//  * A block per tile, no atomics, nothing summed across points: two calls
//    give bitwise-equal outputs, and points past n load zeros and are not
//    stored.
//
// What bounds K3 on an H100.  FP32 FMAs: 81,920 a point at the full width,
// 41 GFLOP against 0.26 GB of device traffic at n = 250,000 (0.611 ms at 67
// TFLOP/s).  It takes 1.6 ms on an H100 at 700 W (38 % of that bound; the
// first design 3.35 ms, 18 %), with 124 registers and no spill.  By ablation
// the last layer's forward products take 0.6 ms (61 % of their FMA bound),
// the hbar products 0.27 ms (45 %), and the tile loads hide behind the other
// block's products.  Not kept: eight points by four features in the reverse
// products (12 % slower: half the lane pairs idle), a 64-point tile at one
// block an SM (29 % slower).
//
// K4's design (the same layout of rows, tile + 4 floats each).
//  * Register-tiled products.  A pair of lanes (l and l + 16 of a warp, each
//    reducing over half the rows and then exchanging sums) owns four points
//    by four output features of all the streams, which share W_k: one float4
//    of weights and one float4 a stream feed 64 FMAs (the first design: one
//    weight and four float4s for 16).  The forward products and the products
//    hbar_s = sbar_s W_k^T of the reverse sweep are this one routine.
//  * Ten products, not twelve.  qbar = g_quad rbar holds at the head (2 g z_L
//    = g 2 z_L) and the step back through an activation keeps the factor, so
//    hqbar = g hrbar is no product of its own, and hq and hr enter the weight
//    gradients as the one stream hr + g hq.
//  * A 32-point tile with the last layer streamed (64 points where the rows
//    fit, as at 32->32->128).  The last layer, the widest, is never held
//    whole: 64 of its output features at a time are computed, turned into
//    the head cotangents in registers, and consumed at once by the weight
//    gradients of that chunk and by running hbar sums that the lane pair
//    keeps in registers over the chunks.  At the full width a block holds 4
//    streams x (128 saved + 64 activated + 64 of the chunk) rows x 36 floats
//    = 144 KB.
//  * Weight gradients summed in the block.  A warp owns 8 x 32 entries of
//    Wbar_k, its quarters split the (stream, four points) steps of the tile,
//    exchange their sums by shuffles and add them, once a tile, to the
//    block's sums in shared memory (81 KB at the full width; in the block's
//    row of the partials in device memory where they do not fit).  A block
//    walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ... in order and
//    writes its row of the partials once, at its end; k4_reduce adds the rows
//    in block order.  No atomics: the same n on the same card gives
//    bitwise-equal gradients on every call.  Points past n (the ragged last
//    tile) load zeros and get zero cotangents, so they add exactly nothing.
//  * Two act_d a feature, layer and point (forward and step back), not three.
//
// What bounds K4 on an H100.  FP32 FMAs: 10 products of 20,480 multiply-adds
// a point at the full width, 102 GFLOP against 0.45 GB of device traffic at
// n = 250,000.  One block of 8 warps fits an SM (226 registers a thread, 225
// KB of shared memory), and with two warps a scheduler the FMA pipe stays
// about half idle whatever is taken out of the loops (loads, shuffles and
// the activation were ablated one by one): 4.56 ms on an H100 at 700 W against the first
// design's 10.5 ms.  The same products on the tensor cores (3xTF32 mma.sync)
// were tried for the weight gradients and lost to the cost of splitting the
// fragments.
//
// K9 and K10: the Fourier front end of a PotentialMLP and its VJP.  They
// replace no TPU kernel: the JAX package leaves this front end to XLA's
// fusion (pde_inverse_tpu/losses/fused_pointwise.py:68-87), which keeps
// p = x B, dp = v B, cos p, sin p and dp^2 out of memory; run as PyTorch
// operations it is ~95 kernels a step that each read and write [n, 64]
// tensors.  K9 (entry front_streams) gives the first-layer streams
//   z1 = x W0y + b0 + cos p W0c + sin p W0s
//   dz1 = v W0y + (-sin p dp) W0c + (cos p dp) W0s
//   d2z1 = (-cos p dp^2) W0c + (-sin p dp^2) W0s
// and cos p, sin p (which the recovery of grad V from delta reads); K10
// (entry front_streams_bwd) is their VJP for the cotangents of all five:
// the gradients of W0 = [W0y; W0c; W0s], b0 and B, with p and dp recomputed.
// Both take d, F, w0 as template parameters (only the presets' 4, 64, 64 is
// instantiated), full-precision sincosf and FP32 FMAs throughout.
//
// What bounds them on an H100.  FP32 FMAs: K9 3 streams x (2F + d) x w0,
// 25,088 a point at 4, 64, 64 (0.75 ms at n = 1,000,000 and 67 TFLOP/s),
// against 32 B in and 768 B (+ 512 B of cos p, sin p) out a point (0.38
// ms at 3.35 TB/s); K10 two such sets, the weight gradients (six F x w0
// outer products a point) and the cotangents of cos p and sin p (six F x w0
// matrix-vector products a point), ~50,000 a point (1.5 ms).  At n =
// 1,000,000 on an H100 at 700 W K9 takes 1.72 ms (44 % of its bound) and
// K10 3.55 ms (43 %; 128 registers, two blocks an SM), against 16.7 ms for
// the same front end as PyTorch operations, forward and backward.
//
// K9's design: K3's.  A tile of 32 points stages the three streams' inputs
// feature-major in shared memory ([stream][row][point], rows x | cos | sin,
// v | -sin dp | cos dp, 0 | -cos dp^2 | -sin dp^2), and a lane pair owns
// four points by four features of all three streams, which share W0: one
// float4 of weights and three of streams feed 48 FMAs.  The first half of
// the warp reduces over the x and cos rows, the second over the sin rows.
// Nothing [n, F] goes to memory but cos p and sin p; consecutive lanes own
// consecutive features, so each stream's row of a point is one 256-byte
// store of the warp.
//
// K10's design.  Persistent blocks walk the tiles in order (as K4's).  A
// tile's cotangents are staged feature-major beside cos p, sin p and dp.
// The cotangents of cos p and sin p come from K9's routine with W0^T (a lane
// pair owns four points by four features, the first half of the warp the
// cos rows and the second the sin rows, each over all w0 rows), are turned
// into those of p and dp in registers (the halves exchange their parts by
// one shuffle) and summed into the gradient of B.  The weight gradients:
// a thread owns four features f by four columns j, at cos row f and sin row
// f, and sums over the tile's points from the same staged rows (the products
// -sin dp, ... formed in registers), then adds them once a tile into the
// block's sums in shared memory.  At its end a block writes one row of
// partials; the last block to finish (a ticket taken with one atomic)
// adds the rows in block order, so the gradients are the same bits on every
// call with the same n on the same card.  Points past
// n load zeros and add exactly nothing.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMid = 16;
constexpr int kTanh = 0;
constexpr int kSilu = 1;
constexpr int kSoftplus = 2;

// (act, act', act'', act''') of one value; the stable forms of sigmoid and
// softplus, as jax.nn's.
template <int ACT>
__device__ __forceinline__ void act_d(float z, float& a0, float& a1, float& a2, float& a3) {
  if constexpr (ACT == kTanh) {
    const float a = tanhf(z);
    const float d1 = 1.0f - a * a;
    a0 = a;
    a1 = d1;
    a2 = -2.0f * a * d1;
    a3 = d1 * (4.0f * a * a - 2.0f * d1);
  } else if constexpr (ACT == kSilu) {
    const float s = 1.0f / (1.0f + expf(-z));
    const float s1 = s * (1.0f - s);
    const float s2 = s1 * (1.0f - 2.0f * s);
    const float s3 = s2 * (1.0f - 2.0f * s) - 2.0f * s1 * s1;
    a0 = z * s;
    a1 = s + z * s1;
    a2 = 2.0f * s1 + z * s2;
    a3 = 3.0f * s2 + z * s3;
  } else {
    const float s = 1.0f / (1.0f + expf(-z));
    const float s1 = s * (1.0f - s);
    a0 = fmaxf(z, 0.0f) + log1pf(expf(-fabsf(z)));
    a1 = s;
    a2 = s1;
    a3 = s1 * (1.0f - 2.0f * s);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void fma4(float4& acc, float4 x, float w) {
  acc.x = fmaf(x.x, w, acc.x);
  acc.y = fmaf(x.y, w, acc.y);
  acc.z = fmaf(x.z, w, acc.z);
  acc.w = fmaf(x.w, w, acc.w);
}

constexpr unsigned kFull = 0xffffffffu;

// acc[s][c] (four points of output column c, stream s < NS) += sum over
// `steps` rows i (a multiple of 4) of X_s[i][four points] * W[i][c], from the
// rows W and X point at: one float4 of weights (read-only cache) and one
// float4 a stream (shared memory) feed 16 NS FMAs; with SKIPQ stream 2 is
// left out.  NS follows from acc: 4 in K4, 3 or 1 in K3.  The
// weights come from L2 more often than not (the block's shared memory leaves
// little L1), so those of the next four rows are loaded while these four are
// used.
__device__ __forceinline__ void load_rows4(float4 (&w)[4], const float4* wp, int ldw4) {
#pragma unroll
  for (int u = 0; u < 4; ++u) w[u] = __ldg(wp + u * ldw4);
}

template <bool SKIPQ, int NS>
__device__ __forceinline__ void fma_rows4(float4 (&acc)[NS][4], const float4 (&w)[4], const float* X,
                                          int sstride, int row) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (SKIPQ && s == 2) continue;
      const float4 x = ld4(X + u * row + s * sstride);
      fma4(acc[s][0], x, w[u].x);
      fma4(acc[s][1], x, w[u].y);
      fma4(acc[s][2], x, w[u].z);
      fma4(acc[s][3], x, w[u].w);
    }
  }
}

template <bool SKIPQ, int NS>
__device__ __forceinline__ void product4(float4 (&acc)[NS][4], const float* __restrict__ W, int ldw,
                                         const float* X, int sstride, int row, int steps) {
  const float4* wp = reinterpret_cast<const float4*>(W);
  const int ldw4 = ldw / 4;
  float4 wa[4], wb[4];  // two sets of four rows, used in turns: no copy between them
  load_rows4(wa, wp, ldw4);
  for (int i = 0; i < steps; i += 8) {
    const bool more = i + 4 < steps;
    if (more) load_rows4(wb, wp + 4 * ldw4, ldw4);
    fma_rows4<SKIPQ>(acc, wa, X, sstride, row);
    wp += 8 * ldw4;
    if (i + 8 < steps) load_rows4(wa, wp, ldw4);
    if (more) fma_rows4<SKIPQ>(acc, wb, X + 4 * row, sstride, row);
    X += 8 * row;
  }
}

template <int NS>
__device__ __forceinline__ void zero4(float4 (&acc)[NS][4]) {
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[s][c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Both halves of the warp end with the sums of the two halves' reductions.
template <bool SKIPQ, int NS>
__device__ __forceinline__ void join_halves(float4 (&acc)[NS][4]) {
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (SKIPQ && s == 2) continue;
      acc[s][c].x += __shfl_xor_sync(kFull, acc[s][c].x, 16);
      acc[s][c].y += __shfl_xor_sync(kFull, acc[s][c].y, 16);
      acc[s][c].z += __shfl_xor_sync(kFull, acc[s][c].z, 16);
      acc[s][c].w += __shfl_xor_sync(kFull, acc[s][c].w, 16);
    }
}

__device__ __forceinline__ float4 pick(bool second, float4 a, float4 b) { return second ? b : a; }

// ---- K3 -------------------------------------------------------------------------
//
// The chain as K3 runs it: every width a multiple of 8, a tile of `tile` points
// (64, 32, 16 or 8), the last layer's output features in chunks of at most
// `chunk`.  Shared memory holds rows of tile + 4 floats: z_k, the
// pre-activation of layer k's input, for every layer (zrow[k] ...); p and q of
// the current layer's input (pq_row ..., q max_in rows after p), over which
// the last layer's running hbar sums go; the activated streams h, hp, hq of
// the current layer's input (tmp_row ..., max_in rows apart); one chunk of
// 2 z_L (chunk_row ...); and the chunk's quad partials, one row for four
// output features (quad_row ...).
struct K3Net {
  int n_mid;
  int w[kMaxMid + 1];
  int p_off[kMaxMid];
  int t_off[kMaxMid];
  int zrow[kMaxMid];
  int max_in;
  int pq_row;
  int tmp_row;
  int chunk_row;
  int quad_row;
  int rows;
  int tile;
  int chunk;
};

// tmp = (act(z), act' p, act'' p^2 + act' q) of layer k's inputs
template <int ACT>
__device__ void k3_activate(float* sm, const K3Net& net, int sstride, int row, int k) {
  const int T = net.tile;
  const int win = net.w[k];
  for (int idx = threadIdx.x; idx < win * T; idx += kThreads) {
    const int i = idx / T;
    const int c = idx - i * T;
    const float* pq = sm + (net.pq_row + i) * row + c;
    float* dst = sm + (net.tmp_row + i) * row + c;
    float a0, a1, a2, a3;
    act_d<ACT>(sm[(net.zrow[k] + i) * row + c], a0, a1, a2, a3);
    const float p = pq[0];
    dst[0] = a0;
    dst[sstride] = a1 * p;
    dst[2 * sstride] = a2 * p * p + a1 * pq[sstride];
  }
}

// delta = hbar * act'(z) at four points
template <int ACT>
__device__ __forceinline__ float4 k3_step_back(float4 hb, float4 z) {
  float a0, a1, a2, a3;
  act_d<ACT>(z.x, a0, a1, a2, a3);
  hb.x *= a1;
  act_d<ACT>(z.y, a0, a1, a2, a3);
  hb.y *= a1;
  act_d<ACT>(z.z, a0, a1, a2, a3);
  hb.z *= a1;
  act_d<ACT>(z.w, a0, a1, a2, a3);
  hb.w *= a1;
  return hb;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <int ACT>
__global__ void __launch_bounds__(kThreads, 2)
    k3_kernel(K3Net net, int n, const float* __restrict__ z1, const float* __restrict__ dz1,
              const float* __restrict__ d2z1, const float* __restrict__ params,
              const float* __restrict__ params_t, float* __restrict__ quad,
              float* __restrict__ delta) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int T = net.tile;
  const int row = T + 4;
  const int npg = T / 4;
  const int sstride = net.max_in * row;  // floats between p and q, and between h, hp and hq
  const int w0 = net.w[0];
  const int L = net.n_mid;
  const int base = blockIdx.x * T;
  const int lane = threadIdx.x & 31;
  const bool second = lane >= 16;
  // this thread's item of a pass: 16 items a warp, each held by lane l and l + 16
  const int slot = (threadIdx.x >> 5) * 16 + (lane & 15);

  // the tile's rows of z1 (to zrow[0]), dz1 and d2z1 (to p and q), 12 loads a
  // thread in flight
  {
    const float* src[3] = {z1, dz1, d2z1};
    float* dst[3] = {sm + net.zrow[0] * row, sm + net.pq_row * row, sm + net.pq_row * row + sstride};
    const int live = min(T, n - base) * w0;  // floats of the tile that exist
    for (int i0 = threadIdx.x; i0 < T * w0; i0 += 4 * kThreads) {
      float v[4][3];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          const int idx = i0 + u * kThreads;
          v[u][s] = idx < live ? src[s][static_cast<size_t>(base) * w0 + idx] : 0.0f;
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = i0 + u * kThreads;
        if (idx < T * w0) {
          const int c = idx / w0;
          const int i = idx - c * w0;
#pragma unroll
          for (int s = 0; s < 3; ++s) dst[s][i * row + c] = v[u][s];
        }
      }
    }
  }
  __syncthreads();

  // forward through the layers before the last: z_{k+1} to its rows, p and q
  // over those of layer k (consumed by the activation)
  for (int k = 0; k + 1 < L; ++k) {
    k3_activate<ACT>(sm, net, sstride, row, k);
    __syncthreads();
    const int win = net.w[k];
    const int wout = net.w[k + 1];
    const float* __restrict__ W = params + net.p_off[k];
    const float* __restrict__ b = W + win * wout;
    const int items = npg * (wout / 4);
    const int mid = win / 2;
    for (int ib = 0; ib < items; ib += kThreads / 2) {
      const bool active = ib + slot < items;
      const int item = active ? ib + slot : 0;
      const int pg = item % npg;
      const int jg = item / npg;
      float4 o[3][4];
      zero4(o);
      product4<false>(o, W + (second ? mid : 0) * wout + jg * 4, wout,
                      sm + (net.tmp_row + (second ? mid : 0)) * row + pg * 4, sstride, row, mid);
      join_halves<false>(o);
      if (!active) continue;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = jg * 4 + (second ? 2 : 0) + t;
        const float bj = __ldg(b + j);
        float4 z = pick(second, o[0][t], o[0][2 + t]);
        z.x += bj;
        z.y += bj;
        z.z += bj;
        z.w += bj;
        st4(sm + (net.zrow[k + 1] + j) * row + pg * 4, z);
        float* pq = sm + (net.pq_row + j) * row + pg * 4;
        st4(pq, pick(second, o[1][t], o[1][2 + t]));
        st4(pq + sstride, pick(second, o[2][t], o[2][2 + t]));
      }
    }
    __syncthreads();
  }
  k3_activate<ACT>(sm, net, sstride, row, L - 1);
  __syncthreads();

  // the last layer, a chunk of its output features at a time: forward, the
  // quad partials and 2 z_L of the chunk, then hbar += 2 z_L W_L^T over the
  // chunk into running sums over the p rows, and after the last chunk the
  // step back through act'(z_{L-1}), written over z_{L-1}
  const int wl_in = net.w[L - 1];
  const int wl = net.w[L];
  const float* __restrict__ WL = params + net.p_off[L - 1];
  const float* __restrict__ bL = WL + wl_in * wl;
  const float* __restrict__ WLt = params_t + net.t_off[L - 1];
  float* hbar = sm + net.pq_row * row;
  float qsum = 0.0f;  // thread c < T: point c's sum of p_L^2 + z_L q_L over the chunks so far
  for (int j0 = 0; j0 < wl; j0 += net.chunk) {
    const int cn = min(net.chunk, wl - j0);
    const bool last = j0 + cn == wl;
    {
      const int items = npg * (cn / 4);
      const int mid = wl_in / 2;
      for (int ib = 0; ib < items; ib += kThreads / 2) {
        const bool active = ib + slot < items;
        const int item = active ? ib + slot : 0;
        const int pg = item % npg;
        const int jg = item / npg;
        float4 o[3][4];
        zero4(o);
        product4<false>(o, WL + (second ? mid : 0) * wl + j0 + jg * 4, wl,
                        sm + (net.tmp_row + (second ? mid : 0)) * row + pg * 4, sstride, row, mid);
        join_halves<false>(o);
        // p^2 + z q of four points over this lane's two features, then the pair's four
        float4 part = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (active) {
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int jc = jg * 4 + (second ? 2 : 0) + t;
            const float bj = __ldg(bL + j0 + jc);
            float4 z = pick(second, o[0][t], o[0][2 + t]);
            const float4 p = pick(second, o[1][t], o[1][2 + t]);
            const float4 q = pick(second, o[2][t], o[2][2 + t]);
            z.x += bj;
            z.y += bj;
            z.z += bj;
            z.w += bj;
            part.x += p.x * p.x + z.x * q.x;
            part.y += p.y * p.y + z.y * q.y;
            part.z += p.z * p.z + z.z * q.z;
            part.w += p.w * p.w + z.w * q.w;
            st4(sm + (net.chunk_row + jc) * row + pg * 4,
                make_float4(2.0f * z.x, 2.0f * z.y, 2.0f * z.z, 2.0f * z.w));
          }
        }
        part.x += __shfl_xor_sync(kFull, part.x, 16);
        part.y += __shfl_xor_sync(kFull, part.y, 16);
        part.z += __shfl_xor_sync(kFull, part.z, 16);
        part.w += __shfl_xor_sync(kFull, part.w, 16);
        if (active && !second) st4(sm + (net.quad_row + jg) * row + pg * 4, part);
      }
    }
    __syncthreads();
    if (threadIdx.x < T) {
      float s = 0.0f;
      for (int r = 0; r < cn / 4; ++r) s += sm[(net.quad_row + r) * row + threadIdx.x];
      qsum += s;
    }
    {
      const int items = npg * (wl_in / 4);
      const int midc = cn / 2;
      for (int ib = 0; ib < items; ib += kThreads / 2) {
        const bool active = ib + slot < items;
        const int item = active ? ib + slot : 0;
        const int pg = item % npg;
        const int ig = item / npg;
        float4 o[1][4];
        zero4(o);
        product4<false>(o, WLt + (j0 + (second ? midc : 0)) * wl_in + ig * 4, wl_in,
                        sm + (net.chunk_row + (second ? midc : 0)) * row + pg * 4, 0, row, midc);
        join_halves<false>(o);
        if (!active) continue;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int i = ig * 4 + (second ? 2 : 0) + t;
          float4 h = pick(second, o[0][t], o[0][2 + t]);
          float* hp = hbar + i * row + pg * 4;
          if (j0 > 0) h = add4(ld4(hp), h);
          if (last) {
            float* zp = sm + (net.zrow[L - 1] + i) * row + pg * 4;
            st4(zp, k3_step_back<ACT>(h, ld4(zp)));
          } else {
            st4(hp, h);
          }
        }
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < T && base + static_cast<int>(threadIdx.x) < n) quad[base + threadIdx.x] = 2.0f * qsum;

  // the layers before the last, in reverse: delta_k = (delta_{k+1} W_k^T) *
  // act'(z_k), written over z_k
  for (int k = L - 2; k >= 0; --k) {
    const int win = net.w[k];
    const int wout = net.w[k + 1];
    const float* __restrict__ Wt = params_t + net.t_off[k];
    const int items = npg * (win / 4);
    const int mid = wout / 2;
    for (int ib = 0; ib < items; ib += kThreads / 2) {
      const bool active = ib + slot < items;
      const int item = active ? ib + slot : 0;
      const int pg = item % npg;
      const int ig = item / npg;
      float4 o[1][4];
      zero4(o);
      product4<false>(o, Wt + (second ? mid : 0) * win + ig * 4, win,
                      sm + (net.zrow[k + 1] + (second ? mid : 0)) * row + pg * 4, 0, row, mid);
      join_halves<false>(o);
      if (!active) continue;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int i = ig * 4 + (second ? 2 : 0) + t;
        float* zp = sm + (net.zrow[k] + i) * row + pg * 4;
        st4(zp, k3_step_back<ACT>(pick(second, o[0][t], o[0][2 + t]), ld4(zp)));
      }
    }
    __syncthreads();
  }

  const float* from = sm + net.zrow[0] * row;
  for (int idx = threadIdx.x; idx < T * w0; idx += kThreads) {
    const int c = idx / w0;
    const int i = idx - c * w0;
    if (base + c < n) delta[static_cast<size_t>(base + c) * w0 + i] = from[i * row + c];
  }
}

// ---- K4 -------------------------------------------------------------------------
//
// The chain as K4 runs it: every width a multiple of 8 (the wrapper zero-pads),
// a tile of `tile` points (64, 32, 16 or 8), the last layer's output features in
// chunks of at most `chunk`.  Shared memory holds, for each of the four streams,
// `rows` feature rows of tile + 4 floats: the saved inputs of every layer
// (row0[k] ...), one activated copy (tmp_row ...) and one chunk of the last
// layer (chunk_row ...); then g_quad of the tile and, with acc_shared, the
// block's weight-gradient sums in the params layout.
struct K4Net {
  int n_mid;
  int w[kMaxMid + 1];
  int p_off[kMaxMid];
  int t_off[kMaxMid];
  int row0[kMaxMid];
  int tmp_row;
  int chunk_row;
  int rows;
  int tile;
  int chunk;
  int acc_shared;
};

// tmp = the activated streams of layer k's inputs: h = act(z), hp = act' p,
// hq = act'' p^2 + act' q, hr = act' r.  For the last layer (LAST) also
// hr + g hq, the one stream that stands for hq and hr in its weight
// gradients, into the rows at h3.
template <int ACT, bool LAST>
__device__ void k4_activate(float* sm, const K4Net& net, int sstride, int row, int k,
                            const float* gq, float* h3) {
  const int T = net.tile;
  const int win = net.w[k];
  for (int idx = threadIdx.x; idx < win * T; idx += kThreads) {
    const int i = idx / T;
    const int c = idx - i * T;
    const float* src = sm + (net.row0[k] + i) * row + c;
    float* dst = sm + (net.tmp_row + i) * row + c;
    float a0, a1, a2, a3;
    act_d<ACT>(src[0], a0, a1, a2, a3);
    const float dp = src[sstride];
    const float dq = src[2 * sstride];
    const float hq = a2 * dp * dp + a1 * dq;
    const float hr = a1 * src[3 * sstride];
    dst[0] = a0;
    dst[sstride] = a1 * dp;
    dst[2 * sstride] = hq;
    dst[3 * sstride] = hr;
    if constexpr (LAST) h3[i * row + c] = fmaf(gq[c], hq, hr);
  }
}

// One point of the step back through layer k's activation: from hbar_s =
// sbar_s W^T and the saved (z, p, q, r) to the cotangents, in place.  qbar is
// g rbar at every layer (at the head 2 g z_L = g 2 z_L, and the step back keeps
// the factor), so hqb = g hrb is not a product of its own, and hq and hr
// enter the weight gradients as hr + g hq: with TMP the activated streams
// (h, hp, hr + g hq) for them.
template <int ACT, bool TMP>
__device__ __forceinline__ void step_back(float g, float hb, float hpb, float hrb, float& z,
                                          float& p, float& q, float& r, float& h, float& hp,
                                          float& hr) {
  float a0, a1, a2, a3;
  act_d<ACT>(z, a0, a1, a2, a3);
  const float hqb = g * hrb;
  if constexpr (TMP) {
    h = a0;
    hp = a1 * p;
    hr = fmaf(g, a2 * p * p + a1 * q, a1 * r);
  }
  const float zbar = hb * a1 + hpb * (a2 * p) + hrb * (a2 * r) + hqb * (a3 * p * p + a2 * q);
  const float pbar = hpb * a1 + hqb * (2.0f * a2 * p);
  z = zbar;
  p = pbar;
  q = hqb * a1;
  r = hrb * a1;
}

// The step back for the item (four points at pg, four features at ig) whose
// hbar sums (streams 0, 1, 3) both halves of the warp hold: each half takes
// two features.
template <int ACT, bool TMP>
__device__ __forceinline__ void step_back_item(float* sm, const K4Net& net, int sstride, int row,
                                               int k, int pg, int ig, bool second, const float* gq,
                                               const float4 (&hb)[4][4]) {
  const float4 g = ld4(gq + pg * 4);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int i = ig * 4 + (second ? 2 : 0) + t;
    const float4 b0 = pick(second, hb[0][t], hb[0][2 + t]);
    const float4 b1 = pick(second, hb[1][t], hb[1][2 + t]);
    const float4 b3 = pick(second, hb[3][t], hb[3][2 + t]);
    float* zp = sm + (net.row0[k] + i) * row + pg * 4;
    float4 z = ld4(zp), p = ld4(zp + sstride), q = ld4(zp + 2 * sstride), r = ld4(zp + 3 * sstride);
    float4 h, hp, hr;
    step_back<ACT, TMP>(g.x, b0.x, b1.x, b3.x, z.x, p.x, q.x, r.x, h.x, hp.x, hr.x);
    step_back<ACT, TMP>(g.y, b0.y, b1.y, b3.y, z.y, p.y, q.y, r.y, h.y, hp.y, hr.y);
    step_back<ACT, TMP>(g.z, b0.z, b1.z, b3.z, z.z, p.z, q.z, r.z, h.z, hp.z, hr.z);
    step_back<ACT, TMP>(g.w, b0.w, b1.w, b3.w, z.w, p.w, q.w, r.w, h.w, hp.w, hr.w);
    st4(zp, z);
    st4(zp + sstride, p);
    st4(zp + 2 * sstride, q);
    st4(zp + 3 * sstride, r);
    if constexpr (TMP) {
      float* tp = sm + (net.tmp_row + i) * row + pg * 4;
      st4(tp, h);
      st4(tp + sstride, hp);
      st4(tp + 3 * sstride, hr);
    }
  }
}

// Weight gradients of layer k for the cn output columns from j0, whose
// cotangents sbar_s lie in the rows from s_row: acc[W_k][i][j0 + j] += sum
// over the points of h(i) zbar(j) + hp(i) pbar(j) + (hr + g hq)(i) rbar(j),
// with h and hp in the activated copy and hr + g hq in the rows at h3; the
// bias entries += the sum of zbar over the points.  A warp owns 8 rows i by
// 32 columns j; its quarters split the 3 x tile / 4 steps (stream, four
// points), a lane with the 4 columns jl, jl + 8, jl + 16, jl + 24 (rows of
// neighbouring lanes: no bank conflict; 12 float4 loads feed 128 FMAs); the
// quarters exchange their sums and each adds two of the rows.  Each entry
// has one owner.
__device__ void k4_weight_grads(float* sm, const K4Net& net, int sstride, int row, int k,
                                int s_row, int j0, int cn, const float* h3, float* acc) {
  constexpr int CC = 4;  // columns a lane; 8 measured slower (5.16 against 4.95 ms on an H100)
  const int win = net.w[k];
  const int wout = net.w[k + 1];
  const int npg = net.tile / 4;
  const int nib = win / 8;
  const int nq = nib * ((cn + 8 * CC - 1) / (8 * CC));
  const int lane = threadIdx.x & 31;
  const int jl = lane & 7;
  const int steps = 3 * npg;
  const int per = (steps + 3) / 4;
  const int st0 = (lane >> 3) * per;
  const int st1 = min(st0 + per, steps);
  float* gW = acc + net.p_off[k];
  const float* H0 = sm + net.tmp_row * row;
  const float* S0 = sm + s_row * row;
  for (int q = threadIdx.x >> 5; q < nq; q += kThreads / 32) {
    const int ib = q % nib;
    const int i0 = ib * 8;
    const int jr0 = (q / nib) * (8 * CC) + jl;
    int so[CC];
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) so[cc] = min(jr0 + 8 * cc, cn - 1) * row;
    float a[8][CC];
    float bs[CC];
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) {
      bs[cc] = 0.0f;
#pragma unroll
      for (int r = 0; r < 8; ++r) a[r][cc] = 0.0f;
    }
#pragma unroll 2
    for (int st = st0; st < st1; ++st) {
      const int si = st / npg;  // 0: (h, zbar), 1: (hp, pbar), 2: (hr + g hq, rbar)
      const int po = (st - si * npg) * 4;
      const float* Hq = (si == 0 ? H0 : si == 1 ? H0 + sstride : h3) + i0 * row + po;
      const float* Sq = S0 + (si == 2 ? 3 : si) * sstride + po;
      float4 c[CC];
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) c[cc] = ld4(Sq + so[cc]);
      if (ib == 0 && si == 0) {  // zbar in the warps of the first rows: the bias sums
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) bs[cc] += (c[cc].x + c[cc].y) + (c[cc].z + c[cc].w);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 h = ld4(Hq + r * row);
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          a[r][cc] = fmaf(h.x, c[cc].x, a[r][cc]);
          a[r][cc] = fmaf(h.y, c[cc].y, a[r][cc]);
          a[r][cc] = fmaf(h.z, c[cc].z, a[r][cc]);
          a[r][cc] = fmaf(h.w, c[cc].w, a[r][cc]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        a[r][cc] += __shfl_xor_sync(kFull, a[r][cc], 8);
        a[r][cc] += __shfl_xor_sync(kFull, a[r][cc], 16);
      }
    const int part = lane >> 3;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int i = i0 + 2 * part + t;
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const int j = jr0 + 8 * cc;
        const float v = part == 0 ? a[t][cc] : part == 1 ? a[2 + t][cc] : part == 2 ? a[4 + t][cc] : a[6 + t][cc];
        if (j < cn) gW[i * wout + j0 + j] += v;
      }
    }
    if (ib == 0) {
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        bs[cc] += __shfl_xor_sync(kFull, bs[cc], 8);
        bs[cc] += __shfl_xor_sync(kFull, bs[cc], 16);
        const int j = jr0 + 8 * cc;
        if (part == 0 && j < cn) gW[win * wout + j0 + j] += bs[cc];
      }
    }
  }
}

template <int ACT>
__global__ void __launch_bounds__(kThreads, 1)
    k4_kernel(K4Net net, int n, const float* __restrict__ z1, const float* __restrict__ dz1,
              const float* __restrict__ d2z1, const float* __restrict__ g_quad,
              const float* __restrict__ g_delta, const float* __restrict__ params,
              const float* __restrict__ params_t, float* __restrict__ partials, int n_params,
              float* __restrict__ z1bar, float* __restrict__ dz1bar,
              float* __restrict__ d2z1bar) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int T = net.tile;
  const int row = T + 4;
  const int npg = T / 4;
  const int sstride = net.rows * row;  // floats between two streams
  float* gq = sm + 4 * sstride;
  // hr + g hq of the last layer's inputs: the chunk's rows of stream 2, which
  // hold nothing else (qbar = g rbar is never stored)
  float* h3_last = sm + 2 * sstride + net.chunk_row * row;
  float* part = partials + static_cast<size_t>(blockIdx.x) * n_params;
  float* acc = net.acc_shared ? gq + T : part;
  const int w0 = net.w[0];
  const int L = net.n_mid;
  const int wl_in = net.w[L - 1];
  const int wl = net.w[L];
  const int n_tiles = (n + T - 1) / T;
  const int lane = threadIdx.x & 31;
  const bool second = lane >= 16;
  // this thread's item of a pass: 16 items a warp, each held by lane l and l + 16
  const int slot = (threadIdx.x >> 5) * 16 + (lane & 15);

  for (int e = threadIdx.x; e < n_params; e += kThreads) acc[e] = 0.0f;
  __syncthreads();

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * T;
    // the tile's rows of the four inputs, 16 loads a thread in flight
    const float* src[4] = {z1, dz1, d2z1, g_delta};
    const int live = min(T, n - base) * w0;  // floats of the tile that exist
    for (int i0 = threadIdx.x; i0 < T * w0; i0 += 4 * kThreads) {
      float v[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int idx = i0 + u * kThreads;
          v[u][s] = idx < live ? src[s][static_cast<size_t>(base) * w0 + idx] : 0.0f;
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = i0 + u * kThreads;
        if (idx < T * w0) {
          const int c = idx / w0;
          const int i = idx - c * w0;
          float* dst = sm + static_cast<size_t>(net.row0[0] + i) * row + c;
#pragma unroll
          for (int s = 0; s < 4; ++s) dst[s * sstride] = v[u][s];
        }
      }
    }
    if (threadIdx.x < T) gq[threadIdx.x] = base + threadIdx.x < n ? g_quad[base + threadIdx.x] : 0.0f;
    __syncthreads();

    // forward through the layers before the last: saved_{k+1} = tmp W_k (+ b_k)
    for (int k = 0; k + 1 < L; ++k) {
      k4_activate<ACT, false>(sm, net, sstride, row, k, gq, nullptr);
      __syncthreads();
      const int win = net.w[k];
      const int wout = net.w[k + 1];
      const float* __restrict__ W = params + net.p_off[k];
      const float* __restrict__ b = W + win * wout;
      const int items = npg * (wout / 4);
      const int mid = win / 2;
      for (int ib = 0; ib < items; ib += kThreads / 2) {
        const bool active = ib + slot < items;
        const int item = active ? ib + slot : 0;
        const int pg = item % npg;
        const int jg = item / npg;
        float4 o[4][4];
        zero4(o);
        product4<false>(o, W + (second ? mid : 0) * wout + jg * 4, wout,
                 sm + (net.tmp_row + (second ? mid : 0)) * row + pg * 4, sstride, row, mid);
        join_halves<false>(o);
        if (!active) continue;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = jg * 4 + (second ? 2 : 0) + t;
          const float bj = __ldg(b + j);
          float* out = sm + static_cast<size_t>(net.row0[k + 1] + j) * row + pg * 4;
          float4 z = pick(second, o[0][t], o[0][2 + t]);
          z.x += bj;
          z.y += bj;
          z.z += bj;
          z.w += bj;
          st4(out, z);
          st4(out + sstride, pick(second, o[1][t], o[1][2 + t]));
          st4(out + 2 * sstride, pick(second, o[2][t], o[2][2 + t]));
          st4(out + 3 * sstride, pick(second, o[3][t], o[3][2 + t]));
        }
      }
      __syncthreads();
    }
    k4_activate<ACT, true>(sm, net, sstride, row, L - 1, gq, h3_last);
    __syncthreads();

    // the last layer, a chunk of its output features at a time: forward,
    // head cotangents of S = gq 2 sum(p_L^2 + z_L q_L) + <2 z_L, r_L> (zero past
    // n), its weight gradients, and the running sums hbar_s = sbar_s W^T of
    // this thread's item (four points, four input features; one pass)
    const float* __restrict__ WL = params + net.p_off[L - 1];
    const float* __restrict__ bL = WL + wl_in * wl;
    const float* __restrict__ WLt = params_t + net.t_off[L - 1];
    const int items_b = npg * (wl_in / 4);
    const bool active_b = slot < items_b;
    const int item_b = active_b ? slot : 0;
    const int pg_b = item_b % npg;
    const int ig_b = item_b / npg;
    float4 hb[4][4];
    zero4(hb);
    for (int j0 = 0; j0 < wl; j0 += net.chunk) {
      const int cn = min(net.chunk, wl - j0);
      const int items = npg * (cn / 4);
      const int mid = wl_in / 2;
      for (int ib = 0; ib < items; ib += kThreads / 2) {
        const bool active = ib + slot < items;
        const int item = active ? ib + slot : 0;
        const int pg = item % npg;
        const int jg = item / npg;
        float4 o[4][4];
        zero4(o);
        product4<false>(o, WL + (second ? mid : 0) * wl + j0 + jg * 4, wl,
                 sm + (net.tmp_row + (second ? mid : 0)) * row + pg * 4, sstride, row, mid);
        join_halves<false>(o);
        if (!active) continue;
        const float4 g = ld4(gq + pg * 4);
        const int pt = base + pg * 4;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int jc = jg * 4 + (second ? 2 : 0) + t;
          const float bj = __ldg(bL + j0 + jc);
          float4 z = pick(second, o[0][t], o[0][2 + t]);
          const float4 p = pick(second, o[1][t], o[1][2 + t]);
          const float4 q = pick(second, o[2][t], o[2][2 + t]);
          const float4 r = pick(second, o[3][t], o[3][2 + t]);
          z.x += bj;
          z.y += bj;
          z.z += bj;
          z.w += bj;
          float4 zb, pb, rb;
#define K4_HEAD(e, off)                                  \
  {                                                      \
    const bool valid = pt + off < n;                     \
    zb.e = valid ? 2.0f * g.e * q.e + 2.0f * r.e : 0.0f; \
    pb.e = valid ? 4.0f * g.e * p.e : 0.0f;              \
    rb.e = valid ? 2.0f * z.e : 0.0f;                    \
  }
          K4_HEAD(x, 0)
          K4_HEAD(y, 1)
          K4_HEAD(z, 2)
          K4_HEAD(w, 3)
#undef K4_HEAD
          float* out = sm + static_cast<size_t>(net.chunk_row + jc) * row + pg * 4;
          st4(out, zb);
          st4(out + sstride, pb);
          st4(out + 3 * sstride, rb);
        }
      }
      __syncthreads();
      {
        const int midc = cn / 2;
        product4<true>(hb, WLt + (j0 + (second ? midc : 0)) * wl_in + ig_b * 4, wl_in,
                 sm + (net.chunk_row + (second ? midc : 0)) * row + pg_b * 4, sstride, row, midc);
      }
      k4_weight_grads(sm, net, sstride, row, L - 1, net.chunk_row, j0, cn, h3_last, acc);
      __syncthreads();
    }
    join_halves<true>(hb);
    if (active_b) step_back_item<ACT, false>(sm, net, sstride, row, L - 1, pg_b, ig_b, second, gq, hb);
    __syncthreads();

    // the layers before the last, in reverse: the cotangents of layer k + 1
    // lie over its saved streams
    for (int k = L - 2; k >= 0; --k) {
      const int win = net.w[k];
      const int wout = net.w[k + 1];
      const float* __restrict__ Wt = params_t + net.t_off[k];
      const int items = npg * (win / 4);
      const int mid = wout / 2;
      for (int ib = 0; ib < items; ib += kThreads / 2) {
        const bool active = ib + slot < items;
        const int item = active ? ib + slot : 0;
        const int pg = item % npg;
        const int ig = item / npg;
        float4 o[4][4];
        zero4(o);
        product4<true>(o, Wt + (second ? mid : 0) * win + ig * 4, win,
                 sm + (net.row0[k + 1] + (second ? mid : 0)) * row + pg * 4, sstride, row, mid);
        join_halves<true>(o);
        if (active) step_back_item<ACT, true>(sm, net, sstride, row, k, pg, ig, second, gq, o);
      }
      __syncthreads();
      k4_weight_grads(sm, net, sstride, row, k, net.row0[k + 1], 0, wout,
                      sm + 3 * sstride + net.tmp_row * row, acc);
      __syncthreads();
    }

    float* dst[3] = {z1bar, dz1bar, d2z1bar};
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float* from = sm + s * sstride + static_cast<size_t>(net.row0[0]) * row;
      for (int idx = threadIdx.x; idx < T * w0; idx += kThreads) {
        const int c = idx / w0;
        const int i = idx - c * w0;
        if (base + c < n) dst[s][static_cast<size_t>(base + c) * w0 + i] = from[i * row + c];
      }
    }
    __syncthreads();
  }
  if (net.acc_shared) {
    for (int e = threadIdx.x; e < n_params; e += kThreads) part[e] = acc[e];
  }
}

// grads[e] = sum over blocks b, in order, of partials[b][e]
__global__ void k4_reduce(const float* __restrict__ partials, float* __restrict__ grads,
                          int blocks, int n_params) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_params) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += partials[static_cast<size_t>(b) * n_params + e];
  grads[e] = s;
}

// K3's plan (tile, chunk) over the chain; returns the parameter count, or -1
// if the chain or the plan is not one the kernel takes: widths in multiples
// of 8, a tile of 8, 16, 32 or 64 points, a chunk in multiples of 8.
int make_k3_net(int n_mid, const int* widths, int tile, int chunk, K3Net* net) {
  if (n_mid < 1 || n_mid > kMaxMid) return -1;
  if ((tile != 8 && tile != 16 && tile != 32 && tile != 64) || chunk < 8 || chunk % 8 != 0) return -1;
  net->n_mid = n_mid;
  int p = 0, t = 0, row = 0, max_in = 0;
  for (int k = 0; k <= n_mid; ++k) {
    if (widths[k] < 8 || widths[k] % 8 != 0) return -1;
    net->w[k] = widths[k];
  }
  for (int k = 0; k < n_mid; ++k) {
    net->p_off[k] = p;
    net->t_off[k] = t;
    net->zrow[k] = row;
    row += widths[k];
    p += widths[k] * widths[k + 1] + widths[k + 1];
    t += widths[k] * widths[k + 1];
    if (widths[k] > max_in) max_in = widths[k];
  }
  net->max_in = max_in;
  net->pq_row = row;
  net->tmp_row = row + 2 * max_in;
  net->chunk_row = row + 5 * max_in;
  net->quad_row = net->chunk_row + chunk;
  net->rows = net->quad_row + chunk / 4;
  net->tile = tile;
  net->chunk = chunk;
  return p;
}

size_t k3_shared_bytes(const K3Net& net) {
  return static_cast<size_t>(net.rows) * (net.tile + 4) * sizeof(float);
}

// K4's plan (tile, chunk, acc_shared) over the chain; returns the parameter
// count, or -1 if the chain or the plan is not one the kernel takes: widths
// in multiples of 8, a tile of 8, 16, 32 or 64 points, a chunk in multiples of 8,
// and one pass (kThreads / 2 items of four points by four features) over the
// last layer's inputs.
int make_k4_net(int n_mid, const int* widths, int tile, int chunk, int acc_shared, K4Net* net) {
  if (n_mid < 1 || n_mid > kMaxMid) return -1;
  if ((tile != 8 && tile != 16 && tile != 32 && tile != 64) || chunk < 8 || chunk % 8 != 0) return -1;
  net->n_mid = n_mid;
  int p = 0, t = 0, row = 0, max_in = 0;
  for (int k = 0; k <= n_mid; ++k) {
    if (widths[k] < 8 || widths[k] % 8 != 0) return -1;
    net->w[k] = widths[k];
  }
  for (int k = 0; k < n_mid; ++k) {
    net->p_off[k] = p;
    net->t_off[k] = t;
    net->row0[k] = row;
    row += widths[k];
    p += widths[k] * widths[k + 1] + widths[k + 1];
    t += widths[k] * widths[k + 1];
    if (widths[k] > max_in) max_in = widths[k];
  }
  if ((tile / 4) * (widths[n_mid - 1] / 4) > kThreads / 2) return -1;
  net->tmp_row = row;
  net->chunk_row = row + max_in;
  net->rows = row + max_in + (chunk > widths[n_mid - 1] ? chunk : widths[n_mid - 1]);
  net->tile = tile;
  net->chunk = chunk;
  net->acc_shared = acc_shared != 0;
  return p;
}

size_t k4_shared_bytes(const K4Net& net, int n_params) {
  const size_t streams = static_cast<size_t>(4) * net.rows * (net.tile + 4);
  return (streams + net.tile + (net.acc_shared ? n_params : 0)) * sizeof(float);
}

using launch::allow_shared;

template <int ACT>
cudaError_t k3_blocks_per_sm(size_t smem, int* blocks) {
  cudaError_t err = allow_shared(k3_kernel<ACT>, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k3_kernel<ACT>, kThreads, smem);
}

template <int ACT>
cudaError_t k4_blocks_per_sm(size_t smem, int* blocks) {
  cudaError_t err = allow_shared(k4_kernel<ACT>, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k4_kernel<ACT>, kThreads, smem);
}

// ---- K9 and K10 -----------------------------------------------------------------

constexpr int kFrontTile = 32;  // points a tile of K9 and K10

__device__ __forceinline__ float at4(float4 a, int u) {
  return u == 0 ? a.x : u == 1 ? a.y : u == 2 ? a.z : a.w;
}
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
// acc + <a, b> over the four points, in order
__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The front end's shapes: rows of W0 (x, cos, sin), a tile's rows of tile + 4
// floats, the parameter count of the gradients (W0 [K, w0] row-major, b0, B
// [d, F]).
template <int D, int F, int W0>
struct FrontShape {
  static constexpr int T = kFrontTile;
  static constexpr int ROW = T + 4;
  static constexpr int K = D + 2 * F;
  static constexpr int NW = K * W0;
  static constexpr int NP = NW + W0 + D * F;
  static_assert(D % 4 == 0 && F % 16 == 0 && W0 % 16 == 0, "d in 4s, F and w0 in 16s");
  static_assert((T / 4) * (W0 / 4) == kThreads / 2 && (T / 4) * (F / 4) == kThreads / 2,
                "one pass of the block's lane pairs over a tile's products");
  static_assert(kThreads == 256 && D * W0 <= kThreads,
                "16 x 16 owners of the Fourier rows' gradients; a thread an entry of W0y");
  // K9: the three streams' inputs, K rows each
  static constexpr int K9_FLOATS = 3 * K * ROW;
  // K10: three cotangent streams (w0 rows), cos p / sin p / dp (F rows), x and
  // v (d rows), the block's sums of the gradients (the Fourier rows of W0;
  // B's by the tile's point groups; W0y; b0), a flag
  static constexpr int K10_COT = 0;
  static constexpr int K10_CSE = 3 * W0 * ROW;
  static constexpr int K10_XV = K10_CSE + 3 * F * ROW;
  static constexpr int K10_ACC = K10_XV + 2 * D * ROW;
  static constexpr int K10_GB = K10_ACC + 2 * F * W0;
  static constexpr int K10_GY = K10_GB + (T / 4) * D * F;
  static constexpr int K10_FLAG = K10_GY + D * W0 + W0;
  static constexpr int K10_FLOATS = K10_FLAG + 4;
  static_assert(NP % 4 == 0, "the partial rows are float4s");
};

template <int D, int F, int W0>
__global__ void __launch_bounds__(kThreads, 2)
    k9_kernel(int n, const float* __restrict__ x, int ldx, const float* __restrict__ v, int ldv,
              const float* __restrict__ B, const float* __restrict__ W, const float* __restrict__ b0,
              float* __restrict__ z1, float* __restrict__ dz1, float* __restrict__ d2z1,
              float* __restrict__ cosp, float* __restrict__ sinp) {
  using S = FrontShape<D, F, W0>;
  constexpr int T = S::T, ROW = S::ROW, K = S::K;
  constexpr int SS = K * ROW;  // floats between two streams
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int base = blockIdx.x * T;

  // the streams' inputs; consecutive threads take consecutive features of a
  // point, so that cos p and sin p are written in rows
  for (int idx = threadIdx.x; idx < T * F; idx += kThreads) {
    const int c = idx / F;
    const int f = idx - c * F;
    const int pt = base + c;
    float p = 0.0f, e = 0.0f;
    if (pt < n) {
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        const float b = __ldg(B + dd * F + f);
        p = fmaf(x[static_cast<size_t>(pt) * ldx + dd], b, p);
        e = fmaf(v[static_cast<size_t>(pt) * ldv + dd], b, e);
      }
    }
    float s, co;
    sincosf(p, &s, &co);
    const float ee = e * e;
    float* r = sm + (D + f) * ROW + c;
    r[0] = co;
    r[F * ROW] = s;
    r[SS] = -(s * e);
    r[SS + F * ROW] = co * e;
    r[2 * SS] = -(co * ee);
    r[2 * SS + F * ROW] = -(s * ee);
    if (pt < n) {
      cosp[static_cast<size_t>(pt) * F + f] = co;
      sinp[static_cast<size_t>(pt) * F + f] = s;
    }
  }
  for (int idx = threadIdx.x; idx < T * D; idx += kThreads) {
    const int c = idx / D;
    const int dd = idx - c * D;
    const int pt = base + c;
    sm[dd * ROW + c] = pt < n ? x[static_cast<size_t>(pt) * ldx + dd] : 0.0f;
    sm[SS + dd * ROW + c] = pt < n ? v[static_cast<size_t>(pt) * ldv + dd] : 0.0f;
  }
  __syncthreads();

  // four points by four features a lane pair; the first half of the warp
  // takes the x rows (no d2z1 part) and the cos rows, the second the sin rows
  const int lane = threadIdx.x & 31;
  const bool second = lane >= 16;
  const int slot = (threadIdx.x >> 5) * 16 + (lane & 15);
  const int jg = slot % (W0 / 4);
  const int pg = slot / (W0 / 4);
  float4 o[3][4];
  zero4(o);
  if (!second) product4<true>(o, W + jg * 4, W0, sm + pg * 4, SS, ROW, D);
  const int r0 = D + (second ? F : 0);
  product4<false>(o, W + r0 * W0 + jg * 4, W0, sm + r0 * ROW + pg * 4, SS, ROW, F);
  join_halves<false>(o);

  const int j = jg * 4 + (second ? 2 : 0);
  float* out[3] = {z1, dz1, d2z1};
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const float4 a = pick(second, o[s][0], o[s][2]);
    const float4 b = pick(second, o[s][1], o[s][3]);
    const float ba = s == 0 ? __ldg(b0 + j) : 0.0f;
    const float bb = s == 0 ? __ldg(b0 + j + 1) : 0.0f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int pt = base + pg * 4 + u;
      if (pt < n) {
        *reinterpret_cast<float2*>(out[s] + static_cast<size_t>(pt) * W0 + j) =
            make_float2(at4(a, u) + ba, at4(b, u) + bb);
      }
    }
  }
}

template <int D, int F, int W0>
__global__ void __launch_bounds__(kThreads, 2)
    k10_kernel(int n, const float* __restrict__ x, int ldx, const float* __restrict__ v, int ldv,
               const float* __restrict__ B, const float* __restrict__ Wt,
               const float* __restrict__ g_z1, const float* __restrict__ g_dz1,
               const float* __restrict__ g_d2z1, const float* __restrict__ g_cos,
               const float* __restrict__ g_sin, float* __restrict__ partials,
               unsigned int* __restrict__ ticket, float* __restrict__ grads) {
  using S = FrontShape<D, F, W0>;
  constexpr int T = S::T, ROW = S::ROW, K = S::K, NW = S::NW, NP = S::NP;
  constexpr int CS = W0 * ROW;  // floats between two cotangent streams
  constexpr int TS = F * ROW;   // between the cos p, sin p and dp rows
  constexpr int NI = F / 16;    // features a thread owns in the weight gradients
  constexpr int NM = W0 / 16;   // columns
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* cot = sm + S::K10_COT;
  float* cse = sm + S::K10_CSE;
  float* xv = sm + S::K10_XV;
  float* acc = sm + S::K10_ACC;  // [2F][w0]: the cos rows, then the sin rows
  float* acc_b = sm + S::K10_GB;  // [T / 4][d][F]: B's, by the point group of a lane pair
  float* acc_y = sm + S::K10_GY;  // [d][w0]: W0y's, then b0's [w0]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool second = lane >= 16;
  const int slot = (tid >> 5) * 16 + (lane & 15);
  const int kg = slot % (F / 4);
  const int pg = slot / (F / 4);
  const int fq = tid >> 4;  // the weight gradients' features fq + 16 i ...
  const int jq = tid & 15;  // ... by columns jq + 16 m
  const int n_tiles = (n + T - 1) / T;

  for (int e = tid; e < S::K10_FLAG - S::K10_ACC; e += kThreads) acc[e] = 0.0f;
  __syncthreads();

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * T;
    // the cotangents of the streams, 12 loads a thread in flight
    {
      const float* src[3] = {g_z1, g_dz1, g_d2z1};
      const int live = min(T, n - base) * W0;
      for (int i0 = tid; i0 < T * W0; i0 += 4 * kThreads) {
        float val[4][3];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int s = 0; s < 3; ++s) {
            const int idx = i0 + u * kThreads;
            val[u][s] = idx < live ? src[s][static_cast<size_t>(base) * W0 + idx] : 0.0f;
          }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int idx = i0 + u * kThreads;
          if (idx < T * W0) {
            const int c = idx / W0;
            const int jj = idx - c * W0;
#pragma unroll
            for (int s = 0; s < 3; ++s) cot[s * CS + jj * ROW + c] = val[u][s];
          }
        }
      }
    }
    // cos p, sin p, dp; consecutive threads take consecutive points
    for (int idx = tid; idx < T * F; idx += kThreads) {
      const int f = idx / T;
      const int c = idx - f * T;
      const int pt = base + c;
      float p = 0.0f, e = 0.0f;
      if (pt < n) {
#pragma unroll
        for (int dd = 0; dd < D; ++dd) {
          const float b = __ldg(B + dd * F + f);
          p = fmaf(x[static_cast<size_t>(pt) * ldx + dd], b, p);
          e = fmaf(v[static_cast<size_t>(pt) * ldv + dd], b, e);
        }
      }
      float s, co;
      sincosf(p, &s, &co);
      cse[f * ROW + c] = co;
      cse[TS + f * ROW + c] = s;
      cse[2 * TS + f * ROW + c] = e;
    }
    for (int idx = tid; idx < T * D; idx += kThreads) {
      const int dd = idx / T;
      const int c = idx - dd * T;
      const int pt = base + c;
      xv[dd * ROW + c] = pt < n ? x[static_cast<size_t>(pt) * ldx + dd] : 0.0f;
      xv[(D + dd) * ROW + c] = pt < n ? v[static_cast<size_t>(pt) * ldv + dd] : 0.0f;
    }
    __syncthreads();

    // the cotangents of cos p (first half) or sin p (second) at four points
    // by the features 4 kg + c, from the three streams: s_bar W^T
    {
      float4 o[3][4];
      zero4(o);
      product4<false>(o, Wt + D + (second ? F : 0) + kg * 4, K, cot + pg * 4, CS, ROW, W0);
      // the half's cotangent of cos p or sin p given from outside, a row a point
      float4 g_out[4];
      const float* g_trig = second ? g_sin : g_cos;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int pt = base + pg * 4 + u;
        g_out[u] = pt < n ? *reinterpret_cast<const float4*>(g_trig + static_cast<size_t>(pt) * F + kg * 4)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int f = kg * 4 + c;
        const float4 cv = ld4(cse + f * ROW + pg * 4);
        const float4 sv = ld4(cse + TS + f * ROW + pg * 4);
        const float4 ev = ld4(cse + 2 * TS + f * ROW + pg * 4);
        float pb[4], eb[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float co = at4(cv, u), si = at4(sv, u), e = at4(ev, u);
          const float zc = at4(o[0][c], u), pc = at4(o[1][c], u), qc = at4(o[2][c], u);
          const float ee = e * e;
          const float g = at4(g_out[u], c);
          float P, E;
          if (!second) {  // cos p's: -sin p (Zc + g_cos) - cos p dp Pc + sin p dp^2 Qc
            P = fmaf(-si, zc + g, fmaf(-(co * e), pc, (si * ee) * qc));
            E = fmaf(-si, pc, -2.0f * (co * e) * qc);
          } else {  // sin p's: cos p (Zs + g_sin) - sin p dp Ps - cos p dp^2 Qs
            P = fmaf(co, zc + g, fmaf(-(si * e), pc, -(co * ee) * qc));
            E = fmaf(co, pc, -2.0f * (si * e) * qc);
          }
          pb[u] = P + __shfl_xor_sync(kFull, P, 16);
          eb[u] = E + __shfl_xor_sync(kFull, E, 16);
        }
        // B's gradient, this half's dims: x p_bar + v dp_bar over the points
#pragma unroll
        for (int h = 0; h < D / 2; ++h) {
          const int dd = (second ? D / 2 : 0) + h;
          const float4 xd = ld4(xv + dd * ROW + pg * 4);
          const float4 vd = ld4(xv + (D + dd) * ROW + pg * 4);
          float a = 0.0f;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            a = fmaf(at4(xd, u), pb[u], a);
            a = fmaf(at4(vd, u), eb[u], a);
          }
          acc_b[(pg * D + dd) * F + f] += a;
        }
      }
    }

    // the Fourier rows' weight gradients: cos row f += cos p zbar - sin p dp
    // pbar - cos p dp^2 qbar, sin row f += sin p zbar + cos p dp pbar - sin p
    // dp^2 qbar, one stream at a time
    {
      float ac[NI][NM], as[NI][NM];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int m = 0; m < NM; ++m) ac[i][m] = as[i][m] = 0.0f;
#pragma unroll 1
      for (int q = 0; q < T / 4; ++q) {
        const int po = q * 4;
        float4 cb[NM];
#pragma unroll
        for (int m = 0; m < NM; ++m) cb[m] = ld4(cot + (jq + 16 * m) * ROW + po);
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int f = fq + 16 * i;
          const float4 cv = ld4(cse + f * ROW + po);
          const float4 sv = ld4(cse + TS + f * ROW + po);
#pragma unroll
          for (int m = 0; m < NM; ++m) {
            ac[i][m] = dot4(ac[i][m], cv, cb[m]);
            as[i][m] = dot4(as[i][m], sv, cb[m]);
          }
        }
#pragma unroll
        for (int m = 0; m < NM; ++m) cb[m] = ld4(cot + CS + (jq + 16 * m) * ROW + po);
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int f = fq + 16 * i;
          const float4 cv = ld4(cse + f * ROW + po);
          const float4 sv = ld4(cse + TS + f * ROW + po);
          const float4 ev = ld4(cse + 2 * TS + f * ROW + po);
          const float4 nse = mul4(make_float4(-sv.x, -sv.y, -sv.z, -sv.w), ev);
          const float4 ce = mul4(cv, ev);
#pragma unroll
          for (int m = 0; m < NM; ++m) {
            ac[i][m] = dot4(ac[i][m], nse, cb[m]);
            as[i][m] = dot4(as[i][m], ce, cb[m]);
          }
        }
#pragma unroll
        for (int m = 0; m < NM; ++m) cb[m] = ld4(cot + 2 * CS + (jq + 16 * m) * ROW + po);
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int f = fq + 16 * i;
          const float4 cv = ld4(cse + f * ROW + po);
          const float4 sv = ld4(cse + TS + f * ROW + po);
          const float4 ev = ld4(cse + 2 * TS + f * ROW + po);
          const float4 ee = mul4(ev, ev);
          const float4 ncee = mul4(make_float4(-cv.x, -cv.y, -cv.z, -cv.w), ee);
          const float4 nsee = mul4(make_float4(-sv.x, -sv.y, -sv.z, -sv.w), ee);
#pragma unroll
          for (int m = 0; m < NM; ++m) {
            ac[i][m] = dot4(ac[i][m], ncee, cb[m]);
            as[i][m] = dot4(as[i][m], nsee, cb[m]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          const int f = fq + 16 * i;
          const int jj = jq + 16 * m;
          acc[f * W0 + jj] += ac[i][m];
          acc[(F + f) * W0 + jj] += as[i][m];
        }
    }

    // W0y's entry (tid / w0, tid % w0) += x zbar + v pbar; b0 += zbar
    if (tid < D * W0) {
      const int r = tid / W0;
      const int jj = tid - r * W0;
      float a = 0.0f, bs = 0.0f;
#pragma unroll
      for (int q = 0; q < T / 4; ++q) {
        const float4 zb = ld4(cot + jj * ROW + q * 4);
        a = dot4(a, ld4(xv + r * ROW + q * 4), zb);
        a = dot4(a, ld4(xv + (D + r) * ROW + q * 4), ld4(cot + CS + jj * ROW + q * 4));
        bs += (zb.x + zb.y) + (zb.z + zb.w);
      }
      acc_y[tid] += a;
      if (r == 0) acc_y[D * W0 + jj] += bs;
    }
    __syncthreads();
  }

  // the block's row of partials: W0 [K, w0], b0, then B [d, F] summed over
  // the tile's point groups in order
  float* part = partials + static_cast<size_t>(blockIdx.x) * NP;
  for (int e = tid; e < D * W0; e += kThreads) part[e] = acc_y[e];
  for (int e = tid; e < W0; e += kThreads) part[NW + e] = acc_y[D * W0 + e];
  for (int e = tid; e < 2 * F * W0; e += kThreads) part[D * W0 + e] = acc[e];
  for (int e = tid; e < D * F; e += kThreads) {
    float s = 0.0f;
    for (int q = 0; q < T / 4; ++q) s += acc_b[q * D * F + e];
    part[NW + W0 + e] = s;
  }

  // the last block to finish adds the rows in block order
  __threadfence();
  __syncthreads();
  unsigned int* last = reinterpret_cast<unsigned int*>(sm + S::K10_FLAG);
  if (tid == 0) *last = atomicAdd(ticket, 1u) == gridDim.x - 1 ? 1u : 0u;
  __syncthreads();
  if (*last == 0u) return;
  __threadfence();
  // a thread sums R float4s of every row, all in flight together (one row
  // of the block's is ~35 KB; the rows come from L2)
  constexpr int NP4 = NP / 4;
  constexpr int R = (NP4 + kThreads - 1) / kThreads;
  float4 s[R];
#pragma unroll
  for (int q = 0; q < R; ++q) s[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4* rows4 = reinterpret_cast<const float4*>(partials);
#pragma unroll 2
  for (int b = 0; b < static_cast<int>(gridDim.x); ++b) {
    float4 r[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int e = tid + q * kThreads;
      r[q] = e < NP4 ? __ldcg(rows4 + static_cast<size_t>(b) * NP4 + e) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int q = 0; q < R; ++q) s[q] = add4(s[q], r[q]);
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int e = tid + q * kThreads;
    if (e < NP4) reinterpret_cast<float4*>(grads)[e] = s[q];
  }
}

// K9's and K10's dynamic shared memory for (d, F, w0), or -1 where no
// instantiation has that shape (the wrapper's FRONT_SHAPES names the same)
long long front_shared_bytes(int d, int nf, int w0, bool bwd) {
  if (d == 4 && nf == 64 && w0 == 64) {
    using S = FrontShape<4, 64, 64>;
    return static_cast<long long>(sizeof(float)) * (bwd ? S::K10_FLOATS : S::K9_FLOATS);
  }
  return -1;
}

}  // namespace

// Plain C entry points, bound with ctypes.  Each launches on `stream` and
// returns a CUDA error code (0 on success); validation of shapes, dtypes
// and devices is the Python wrapper's job.  `widths` is a host array of
// n_mid + 1 ints; params packs [W_k (row-major [w_k, w_{k+1}]), b_k] for
// every layer k, params_t packs W_k^T.

// Dynamic shared memory of a K3 block under the plan, or -1 for a chain or a
// plan the kernel does not take; the wrapper's k3_plan computes the same.
extern "C" long long k3_shared_bytes_c(int n_mid, const int* widths, int tile, int chunk) {
  K3Net net;
  return make_k3_net(n_mid, widths, tile, chunk, &net) < 0 ? -1
                                                          : static_cast<long long>(k3_shared_bytes(net));
}

// Resident K3 blocks per SM at `smem` bytes of dynamic shared memory.
extern "C" int k3_max_blocks(int device, int act, int smem, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (act) {
    case kTanh: err = k3_blocks_per_sm<kTanh>(smem, blocks); break;
    case kSilu: err = k3_blocks_per_sm<kSilu>(smem, blocks); break;
    case kSoftplus: err = k3_blocks_per_sm<kSoftplus>(smem, blocks); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// widths: the padded chain (multiples of 8); tile, chunk: the wrapper's plan;
// one block a tile.
extern "C" int k3_mlp_grad_quad(int device, int act, int n_mid, const int* widths, int n, int tile,
                                int chunk, const float* z1, const float* dz1, const float* d2z1,
                                const float* params, const float* params_t, float* quad,
                                float* delta, void* stream) {
  K3Net net;
  if (n <= 0 || make_k3_net(n_mid, widths, tile, chunk, &net) < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = k3_shared_bytes(net);
  const dim3 grid((n + tile - 1) / tile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kTanh: err = allow_shared(k3_kernel<kTanh>, smem); break;
    case kSilu: err = allow_shared(k3_kernel<kSilu>, smem); break;
    case kSoftplus: err = allow_shared(k3_kernel<kSoftplus>, smem); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
#define K3_ARGS net, n, z1, dz1, d2z1, params, params_t, quad, delta
  switch (act) {
    case kTanh: k3_kernel<kTanh><<<grid, kThreads, smem, st>>>(K3_ARGS); break;
    case kSilu: k3_kernel<kSilu><<<grid, kThreads, smem, st>>>(K3_ARGS); break;
    case kSoftplus: k3_kernel<kSoftplus><<<grid, kThreads, smem, st>>>(K3_ARGS); break;
  }
#undef K3_ARGS
  return static_cast<int>(cudaGetLastError());
}

// Resident K4 blocks per SM at `smem` bytes of dynamic shared memory; the
// wrapper sizes the grid (and the partials buffer) from it.
extern "C" int k4_max_blocks(int device, int act, int smem, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (act) {
    case kTanh: err = k4_blocks_per_sm<kTanh>(smem, blocks); break;
    case kSilu: err = k4_blocks_per_sm<kSilu>(smem, blocks); break;
    case kSoftplus: err = k4_blocks_per_sm<kSoftplus>(smem, blocks); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of a K4 block under the plan, or -1 for a chain or a
// plan the kernel does not take; the wrapper's k4_plan computes the same.
extern "C" long long k4_shared_bytes_c(int n_mid, const int* widths, int tile, int chunk,
                                       int acc_shared) {
  K4Net net;
  const int n_params = make_k4_net(n_mid, widths, tile, chunk, acc_shared, &net);
  return n_params < 0 ? -1 : static_cast<long long>(k4_shared_bytes(net, n_params));
}

// widths: the padded chain (multiples of 8); tile, chunk, acc_shared: the
// wrapper's plan; partials: [blocks, n_params] scratch; grads: [n_params]
// weight and bias gradients in the params layout.
extern "C" int k4_mlp_grad_quad_bwd(int device, int act, int n_mid, const int* widths, int n,
                                    int blocks, int tile, int chunk, int acc_shared,
                                    const float* z1, const float* dz1,
                                    const float* d2z1, const float* g_quad,
                                    const float* g_delta, const float* params,
                                    const float* params_t, float* partials, float* grads,
                                    float* z1bar, float* dz1bar, float* d2z1bar,
                                    void* stream) {
  K4Net net;
  const int n_params = make_k4_net(n_mid, widths, tile, chunk, acc_shared, &net);
  if (n <= 0 || blocks <= 0 || n_params < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = k4_shared_bytes(net, n_params);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kTanh: err = allow_shared(k4_kernel<kTanh>, smem); break;
    case kSilu: err = allow_shared(k4_kernel<kSilu>, smem); break;
    case kSoftplus: err = allow_shared(k4_kernel<kSoftplus>, smem); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
#define K4_ARGS \
  net, n, z1, dz1, d2z1, g_quad, g_delta, params, params_t, partials, n_params, z1bar, dz1bar, d2z1bar
  switch (act) {
    case kTanh: k4_kernel<kTanh><<<blocks, kThreads, smem, st>>>(K4_ARGS); break;
    case kSilu: k4_kernel<kSilu><<<blocks, kThreads, smem, st>>>(K4_ARGS); break;
    case kSoftplus: k4_kernel<kSoftplus><<<blocks, kThreads, smem, st>>>(K4_ARGS); break;
  }
#undef K4_ARGS
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k4_reduce<<<(n_params + kThreads - 1) / kThreads, kThreads, 0, st>>>(partials, grads, blocks,
                                                                        n_params);
  return static_cast<int>(cudaGetLastError());
}

// Resident K10 blocks per SM; the wrapper sizes the grid (and the partials)
// from it.
extern "C" int k10_max_blocks(int device, int d, int nf, int w0, int* blocks) {
  const long long smem = front_shared_bytes(d, nf, w0, true);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_shared(k10_kernel<4, 64, 64>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k10_kernel<4, 64, 64>, kThreads, smem));
}

// x [n, d] and v [n, d] with row strides ldx, ldv; B [d, F]; W = W0 [d + 2F,
// w0] row-major; outputs z1, dz1, d2z1 [n, w0] and cos p, sin p [n, F]; one
// block a tile of 32 points.
extern "C" int k9_front_streams(int device, int d, int nf, int w0, int n, const float* x, int ldx,
                                const float* v, int ldv, const float* B, const float* W,
                                const float* b0, float* z1, float* dz1, float* d2z1, float* cosp,
                                float* sinp, void* stream) {
  const long long smem = front_shared_bytes(d, nf, w0, false);
  if (n <= 0 || smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_shared(k9_kernel<4, 64, 64>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k9_kernel<4, 64, 64><<<(n + kFrontTile - 1) / kFrontTile, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      n, x, ldx, v, ldv, B, W, b0, z1, dz1, d2z1, cosp, sinp);
  return static_cast<int>(cudaGetLastError());
}

// Wt = W0^T [w0, d + 2F] row-major (a Dense layer's weight as PyTorch keeps
// it); the cotangents of z1, dz1, d2z1 [n, w0] and of cos p, sin p [n, F];
// partials: [blocks, n_params] scratch; ticket: one unsigned int of scratch,
// set to 0 on the stream before the launch; grads [n_params]: W0 [d + 2F,
// w0] row-major, b0 [w0], B [d, F].
extern "C" int k10_front_streams_bwd(int device, int d, int nf, int w0, int n, int blocks,
                                     const float* x, int ldx, const float* v, int ldv,
                                     const float* B, const float* Wt, const float* g_z1,
                                     const float* g_dz1, const float* g_d2z1, const float* g_cos,
                                     const float* g_sin, float* partials, unsigned int* ticket,
                                     float* grads, void* stream) {
  const long long smem = front_shared_bytes(d, nf, w0, true);
  if (n <= 0 || blocks <= 0 || smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_shared(k10_kernel<4, 64, 64>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(ticket, 0, sizeof(unsigned int), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  k10_kernel<4, 64, 64><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      n, x, ldx, v, ldv, B, Wt, g_z1, g_dz1, g_d2z1, g_cos, g_sin, partials, ticket, grads);
  return static_cast<int>(cudaGetLastError());
}
