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
// and one reverse sweep that needs act''' and accumulates the weight
// gradients.
//
// Design.  A block owns a tile of kTile points and keeps every layer's
// streams for the tile in shared memory, feature-major with the points
// minor ([stream][feature][point], rows padded to kRow floats), so that
// one float4 read gives a thread four points of one feature and reads of
// neighbouring features hit distinct banks.  The reverse sweep reads the
// saved streams from there and overwrites them with the cotangents in
// place.  Layer products are written out by hand: a thread owns four
// points of one output feature, walks the reduction dimension reading W
// (or the wrapper's packed W^T, so that a warp's reads are contiguous)
// through the read-only cache, and keeps the sums of all streams in
// registers.  At the full width of the KGMM-nonparametric-online preset
// (w0 = 64, layers 64->64 and 64->256) K3 holds 3 x 448 rows x 20 floats =
// 105 KB and K4 4 x 448 x 20 = 140 KB per block, above the 48 KB default,
// so the launch opts in to large dynamic shared memory
// (cudaFuncAttributeMaxDynamicSharedMemorySize, up to 227 KB).
//
// Weight gradients.  The TPU grid runs in order and accumulates into one
// output block; CUDA blocks run concurrently.  K4 therefore runs a fixed
// grid of at most (resident blocks x SMs) blocks, each walking the tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... in order and accumulating into
// its own row of a partials buffer (each entry is owned by one thread, no
// atomics); a second kernel sums the rows in block order.  The same n on
// the same card gives bitwise-equal gradients on every call.  Points past
// n (the ragged last tile) load zeros and get zero cotangents, so they add
// exactly nothing.
//
// What bounds it on an H100.  Both kernels are FP32-FMA bound: at the full
// width (n = 250,000) K3 does about 41 GFLOP against 0.26 GB of device
// traffic and K4 about 123 GFLOP against 0.5 GB, far above the card's
// FP32 ridge (~20 FLOP/byte).  This first design issues one shared-memory
// read per four FMAs in the products and keeps 8 warps per SM (K4) or 16
// (K3) resident; tensor cores (TF32/3xTF32 wgmma) and register tiling of
// several features per thread are left to later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;              // points per tile
constexpr int kRow = kTile + 4;        // floats per feature row in shared memory
constexpr int kGroup = 4;              // points per thread in a layer product
constexpr int kGroups = kTile / kGroup;
constexpr int kMaxMid = 16;
constexpr int kTanh = 0;
constexpr int kSilu = 1;
constexpr int kSoftplus = 2;

struct Net {
  int n_mid;
  int w[kMaxMid + 1];    // widths: w[0] = w0, w[k + 1] = output width of layer k
  int p_off[kMaxMid];    // W_k [w_k, w_{k+1}] at params + p_off[k], b_k right after
  int t_off[kMaxMid];    // W_k^T [w_{k+1}, w_k] at params_t + t_off[k]
  int row[kMaxMid + 1];  // first shared-memory row of layer k's streams
  int rows;              // rows of all layers (the sum of the widths)
  int tmp_rows;          // rows of the activated copy (widest input, padded to 4)
};

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

// row i of stream s of layer k, and row i of stream s of the activated copy
__device__ __forceinline__ float* srow(float* sm, const Net& net, int s, int k, int i) {
  return sm + static_cast<size_t>(s * net.rows + net.row[k] + i) * kRow;
}
__device__ __forceinline__ float* trow(float* tmp, const Net& net, int s, int i) {
  return tmp + static_cast<size_t>(s * net.tmp_rows + i) * kRow;
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

// [n, w0] rows of the tile starting at point `base` -> shared rows of layer 0
__device__ void load_tile(float* dst, const float* __restrict__ src, int base, int n, int w0) {
  for (int idx = threadIdx.x; idx < kTile * w0; idx += kThreads) {
    const int p = idx / w0;
    const int i = idx - p * w0;
    const int pt = base + p;
    dst[i * kRow + p] = pt < n ? src[static_cast<size_t>(pt) * w0 + i] : 0.0f;
  }
}

__device__ void store_tile(float* __restrict__ dst, const float* src, int base, int n, int w0) {
  for (int idx = threadIdx.x; idx < kTile * w0; idx += kThreads) {
    const int p = idx / w0;
    const int i = idx - p * w0;
    const int pt = base + p;
    if (pt < n) dst[static_cast<size_t>(pt) * w0 + i] = src[i * kRow + p];
  }
}

// Activated streams of layer k's inputs into the copy `tmp`:
// h = act(z), hp = act' p, hq = act'' p^2 + act' q, hr = act' r.
template <int NS, int ACT>
__device__ void activate(float* sm, float* tmp, const Net& net, int k) {
  const int win = net.w[k];
  for (int idx = threadIdx.x; idx < win * kTile; idx += kThreads) {
    const int i = idx / kTile;
    const int p = idx - i * kTile;
    float a0, a1, a2, a3;
    act_d<ACT>(srow(sm, net, 0, k, i)[p], a0, a1, a2, a3);
    const float dp = srow(sm, net, 1, k, i)[p];
    const float dq = srow(sm, net, 2, k, i)[p];
    trow(tmp, net, 0, i)[p] = a0;
    trow(tmp, net, 1, i)[p] = a1 * dp;
    trow(tmp, net, 2, i)[p] = a2 * dp * dp + a1 * dq;
    if constexpr (NS == 4) trow(tmp, net, 3, i)[p] = a1 * srow(sm, net, 3, k, i)[p];
  }
}

// Layer k's streams out of the activated copy: out_s = h_s W (+ b for z).
template <int NS>
__device__ void forward_product(float* sm, float* tmp, const Net& net, int k,
                                const float* __restrict__ params) {
  const int win = net.w[k];
  const int wout = net.w[k + 1];
  const float* __restrict__ W = params + net.p_off[k];
  const float* __restrict__ b = W + win * wout;
  for (int item = threadIdx.x; item < kGroups * wout; item += kThreads) {
    const int g = item / wout;
    const int j = item - g * wout;
    float4 acc[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = 0; i < win; ++i) {
      const float w = __ldg(W + static_cast<size_t>(i) * wout + j);
#pragma unroll
      for (int s = 0; s < NS; ++s) fma4(acc[s], ld4(trow(tmp, net, s, i) + g * kGroup), w);
    }
    const float bj = __ldg(b + j);
    acc[0].x += bj;
    acc[0].y += bj;
    acc[0].z += bj;
    acc[0].w += bj;
#pragma unroll
    for (int s = 0; s < NS; ++s) st4(srow(sm, net, s, k + 1, j) + g * kGroup, acc[s]);
  }
}

template <int NS, int ACT>
__device__ void forward(float* sm, float* tmp, const Net& net, const float* __restrict__ params) {
  for (int k = 0; k < net.n_mid; ++k) {
    activate<NS, ACT>(sm, tmp, net, k);
    __syncthreads();
    forward_product<NS>(sm, tmp, net, k, params);
    __syncthreads();
  }
}

template <int ACT>
__global__ void __launch_bounds__(kThreads)
    k3_kernel(Net net, int n, const float* __restrict__ z1, const float* __restrict__ dz1,
              const float* __restrict__ d2z1, const float* __restrict__ params,
              const float* __restrict__ params_t, float* __restrict__ quad,
              float* __restrict__ delta) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* tmp = sm + 3 * net.rows * kRow;
  const int base = blockIdx.x * kTile;
  const int w0 = net.w[0];
  const int L = net.n_mid;

  load_tile(srow(sm, net, 0, 0, 0), z1, base, n, w0);
  load_tile(srow(sm, net, 1, 0, 0), dz1, base, n, w0);
  load_tile(srow(sm, net, 2, 0, 0), d2z1, base, n, w0);
  __syncthreads();
  forward<3, ACT>(sm, tmp, net, params);

  // quad = 2 sum_j (dz_L^2 + z_L d2z_L): one warp per point, f32
  const int lane = threadIdx.x % 32;
  for (int p = threadIdx.x / 32; p < kTile; p += kThreads / 32) {
    float s = 0.0f;
    for (int j = lane; j < net.w[L]; j += 32) {
      const float z = srow(sm, net, 0, L, j)[p];
      const float dz = srow(sm, net, 1, L, j)[p];
      s += dz * dz + z * srow(sm, net, 2, L, j)[p];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0 && base + p < n) quad[base + p] = 2.0f * s;
  }

  // reverse sweep: delta_k = (delta_{k+1} W_k^T) * act'(z_k) from
  // delta_L = 2 z_L, written over z_k.  The factor 2 is applied to the
  // first product's sum (exact in floating point).
  for (int k = L - 1; k >= 0; --k) {
    const int win = net.w[k];
    const int wout = net.w[k + 1];
    const float* __restrict__ Wt = params_t + net.t_off[k];
    const float scale = k == L - 1 ? 2.0f : 1.0f;
    for (int item = threadIdx.x; item < kGroups * win; item += kThreads) {
      const int g = item / win;
      const int i = item - g * win;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j = 0; j < wout; ++j) {
        fma4(acc, ld4(srow(sm, net, 0, k + 1, j) + g * kGroup), __ldg(Wt + static_cast<size_t>(j) * win + i));
      }
      float* zp = srow(sm, net, 0, k, i) + g * kGroup;
      const float4 z = ld4(zp);
      float a0, a1, a2, a3;
      act_d<ACT>(z.x, a0, a1, a2, a3);
      acc.x = acc.x * scale * a1;
      act_d<ACT>(z.y, a0, a1, a2, a3);
      acc.y = acc.y * scale * a1;
      act_d<ACT>(z.z, a0, a1, a2, a3);
      acc.z = acc.z * scale * a1;
      act_d<ACT>(z.w, a0, a1, a2, a3);
      acc.w = acc.w * scale * a1;
      st4(zp, acc);
    }
    __syncthreads();
  }
  store_tile(delta, srow(sm, net, 0, 0, 0), base, n, w0);
}

// New cotangents of layer k's inputs for one point, from the products
// hbar_s = sbar_s W^T and the saved streams (z, p, q, r), written in place.
template <int ACT>
__device__ __forceinline__ void input_cotangents(float hb, float hpb, float hqb, float hrb,
                                                 float& z, float& p, float& q, float& r) {
  float a0, a1, a2, a3;
  act_d<ACT>(z, a0, a1, a2, a3);
  const float zbar = hb * a1 + hpb * (a2 * p) + hrb * (a2 * r) + hqb * (a3 * p * p + a2 * q);
  const float pbar = hpb * a1 + hqb * (2.0f * a2 * p);
  z = zbar;
  p = pbar;
  q = hqb * a1;
  r = hrb * a1;
}

template <int ACT>
__global__ void __launch_bounds__(kThreads)
    k4_kernel(Net net, int n, const float* __restrict__ z1, const float* __restrict__ dz1,
              const float* __restrict__ d2z1, const float* __restrict__ g_quad,
              const float* __restrict__ g_delta, const float* __restrict__ params,
              const float* __restrict__ params_t, float* __restrict__ partials, int n_params,
              float* __restrict__ z1bar, float* __restrict__ dz1bar,
              float* __restrict__ d2z1bar) {
  extern __shared__ float4 smem4[];
  __shared__ float gq[kTile];
  float* sm = reinterpret_cast<float*>(smem4);
  float* tmp = sm + 4 * net.rows * kRow;
  float* __restrict__ part = partials + static_cast<size_t>(blockIdx.x) * n_params;
  const int w0 = net.w[0];
  const int L = net.n_mid;
  const int n_tiles = (n + kTile - 1) / kTile;

  for (int e = threadIdx.x; e < n_params; e += kThreads) part[e] = 0.0f;
  __syncthreads();

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int base = tile * kTile;
    load_tile(srow(sm, net, 0, 0, 0), z1, base, n, w0);
    load_tile(srow(sm, net, 1, 0, 0), dz1, base, n, w0);
    load_tile(srow(sm, net, 2, 0, 0), d2z1, base, n, w0);
    load_tile(srow(sm, net, 3, 0, 0), g_delta, base, n, w0);
    if (threadIdx.x < kTile) gq[threadIdx.x] = base + threadIdx.x < n ? g_quad[base + threadIdx.x] : 0.0f;
    __syncthreads();
    forward<4, ACT>(sm, tmp, net, params);

    // head cotangents of S = gq 2 sum(p_L^2 + z_L q_L) + <2 z_L, r_L>, zero
    // past n
    for (int idx = threadIdx.x; idx < net.w[L] * kTile; idx += kThreads) {
      const int j = idx / kTile;
      const int p = idx - j * kTile;
      float* zr = srow(sm, net, 0, L, j) + p;
      float* pr = srow(sm, net, 1, L, j) + p;
      float* qr = srow(sm, net, 2, L, j) + p;
      float* rr = srow(sm, net, 3, L, j) + p;
      const bool valid = base + p < n;
      const float g = gq[p];
      const float z = *zr;
      const float pp = *pr;
      const float q = *qr;
      const float r = *rr;
      *zr = valid ? 2.0f * g * q + 2.0f * r : 0.0f;
      *pr = valid ? 4.0f * g * pp : 0.0f;
      *qr = valid ? 2.0f * g * z : 0.0f;
      *rr = valid ? 2.0f * z : 0.0f;
    }
    __syncthreads();

    for (int k = L - 1; k >= 0; --k) {
      const int win = net.w[k];
      const int wout = net.w[k + 1];
      activate<4, ACT>(sm, tmp, net, k);
      __syncthreads();

      // weight gradients: Wbar[i][j] += sum_{s,p} h_s(p, i) sbar_s(p, j),
      // a thread owning four rows i of one column j; bbar[j] += sum_p zbar
      float* __restrict__ gW = part + net.p_off[k];
      const int n_ig = (win + 3) / 4;
      for (int item = threadIdx.x; item < n_ig * wout; item += kThreads) {
        const int ig = item / wout;
        const int j = item - ig * wout;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            const float4 c = ld4(srow(sm, net, s, k + 1, j) + g * kGroup);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float4 h = ld4(trow(tmp, net, s, 4 * ig + r) + g * kGroup);
              acc[r] = fmaf(h.x, c.x, acc[r]);
              acc[r] = fmaf(h.y, c.y, acc[r]);
              acc[r] = fmaf(h.z, c.z, acc[r]);
              acc[r] = fmaf(h.w, c.w, acc[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (4 * ig + r < win) gW[static_cast<size_t>(4 * ig + r) * wout + j] += acc[r];
        }
      }
      for (int j = threadIdx.x; j < wout; j += kThreads) {
        const float* zb = srow(sm, net, 0, k + 1, j);
        float s = 0.0f;
        for (int p = 0; p < kTile; ++p) s += zb[p];
        gW[win * wout + j] += s;
      }

      // input cotangents: hbar_s = sbar_s W^T, then the chain rule through
      // the activation, over the saved streams of layer k
      const float* __restrict__ Wt = params_t + net.t_off[k];
      for (int item = threadIdx.x; item < kGroups * win; item += kThreads) {
        const int g = item / win;
        const int i = item - g * win;
        float4 acc[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int j = 0; j < wout; ++j) {
          const float w = __ldg(Wt + static_cast<size_t>(j) * win + i);
#pragma unroll
          for (int s = 0; s < 4; ++s) fma4(acc[s], ld4(srow(sm, net, s, k + 1, j) + g * kGroup), w);
        }
        float* zp = srow(sm, net, 0, k, i) + g * kGroup;
        float* pp = srow(sm, net, 1, k, i) + g * kGroup;
        float* qp = srow(sm, net, 2, k, i) + g * kGroup;
        float* rp = srow(sm, net, 3, k, i) + g * kGroup;
        float4 z = ld4(zp), p = ld4(pp), q = ld4(qp), r = ld4(rp);
        input_cotangents<ACT>(acc[0].x, acc[1].x, acc[2].x, acc[3].x, z.x, p.x, q.x, r.x);
        input_cotangents<ACT>(acc[0].y, acc[1].y, acc[2].y, acc[3].y, z.y, p.y, q.y, r.y);
        input_cotangents<ACT>(acc[0].z, acc[1].z, acc[2].z, acc[3].z, z.z, p.z, q.z, r.z);
        input_cotangents<ACT>(acc[0].w, acc[1].w, acc[2].w, acc[3].w, z.w, p.w, q.w, r.w);
        st4(zp, z);
        st4(pp, p);
        st4(qp, q);
        st4(rp, r);
      }
      __syncthreads();
    }
    store_tile(z1bar, srow(sm, net, 0, 0, 0), base, n, w0);
    store_tile(dz1bar, srow(sm, net, 1, 0, 0), base, n, w0);
    store_tile(d2z1bar, srow(sm, net, 2, 0, 0), base, n, w0);
    __syncthreads();
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

// Net from the widths; returns the parameter count, or -1 if invalid.
int make_net(int n_mid, const int* widths, Net* net) {
  if (n_mid < 1 || n_mid > kMaxMid) return -1;
  net->n_mid = n_mid;
  int p = 0, t = 0, row = 0, max_in = 0;
  for (int k = 0; k <= n_mid; ++k) {
    if (widths[k] < 1) return -1;
    net->w[k] = widths[k];
    net->row[k] = row;
    row += widths[k];
  }
  for (int k = 0; k < n_mid; ++k) {
    net->p_off[k] = p;
    net->t_off[k] = t;
    p += widths[k] * widths[k + 1] + widths[k + 1];
    t += widths[k] * widths[k + 1];
    if (widths[k] > max_in) max_in = widths[k];
  }
  net->rows = row;
  net->tmp_rows = (max_in + 3) / 4 * 4;
  return p;
}

size_t shared_bytes(const Net& net, int n_streams) {
  return static_cast<size_t>(n_streams) * (net.rows + net.tmp_rows) * kRow * sizeof(float);
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int ACT>
cudaError_t k4_blocks_per_sm(size_t smem, int* blocks) {
  cudaError_t err = allow_shared(k4_kernel<ACT>, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k4_kernel<ACT>, kThreads, smem);
}

}  // namespace

// Plain C entry points, bound with ctypes.  Each launches on `stream` and
// returns a CUDA error code (0 on success); validation of shapes, dtypes
// and devices is the Python wrapper's job.  `widths` is a host array of
// n_mid + 1 ints; params packs [W_k (row-major [w_k, w_{k+1}]), b_k] for
// every layer k, params_t packs W_k^T.

extern "C" int k3_mlp_grad_quad(int device, int act, int n_mid, const int* widths, int n,
                                const float* z1, const float* dz1, const float* d2z1,
                                const float* params, const float* params_t, float* quad,
                                float* delta, void* stream) {
  Net net;
  if (n <= 0 || make_net(n_mid, widths, &net) < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = shared_bytes(net, 3);
  const dim3 grid((n + kTile - 1) / kTile);
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

// partials: [blocks, n_params] scratch; grads: [n_params] weight and bias
// gradients in the params layout.
extern "C" int k4_mlp_grad_quad_bwd(int device, int act, int n_mid, const int* widths, int n,
                                    int blocks, const float* z1, const float* dz1,
                                    const float* d2z1, const float* g_quad,
                                    const float* g_delta, const float* params,
                                    const float* params_t, float* partials, float* grads,
                                    float* z1bar, float* dz1bar, float* d2z1bar,
                                    void* stream) {
  Net net;
  const int n_params = make_net(n_mid, widths, &net);
  if (n <= 0 || blocks <= 0 || n_params < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = shared_bytes(net, 4);
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
