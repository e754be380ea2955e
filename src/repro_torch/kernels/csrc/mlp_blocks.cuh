// Building blocks of the fused decode layer's epilogue (fused_decode.cu)
// and of the SwiGLU kernel (swiglu.cu), written for Hopper (sm_90a):
//
//  * split_k_gemm_kernel: P[s] = X[:, ks] @ W[ks, :] for the s-th slice ks
//    of the contraction, f32 accumulation.  A block owns a tile of
//    kTileM activation rows by kTileN weight columns and one slice of the
//    depth; it stages kChunkK-deep tiles of X and W (upcast to f32) in
//    shared memory and every thread accumulates a 2 x 4 block of outputs
//    in registers.  Each weight element is read from device memory once
//    per row tile — once in all for decode, where the rows are the lanes
//    (n <= kTileM).  The depth is split across blocks so that a skinny
//    product (8 rows, 1024 columns) still puts ~2 blocks on every SM; the
//    slices' partial sums go to a workspace and the next row pass adds
//    them in a fixed order, so results do not change from run to run.
//  * residual_norm_kernel: h1 = h + sum_s P[s], then
//    hn = h1 * rsqrt(mean(h1^2) + eps) * scale (one block per row);
//  * silu_mul_kernel: act = silu(sum_s G[s]) * sum_s U[s];
//  * sum_partials_kernel: out = base + sum_s P[s], cast to the output type.
//
// Shapes the wrappers guarantee: K % 4 == 0, N % 8 == 0, 16-byte aligned
// operands (the vector loads), row-major contiguous tensors.

#pragma once

#include "common.cuh"

namespace mlp {

constexpr int kThreads = 256;
constexpr int kTileM = 32;         // activation rows per block
constexpr int kTileN = 64;         // weight columns per block
constexpr int kChunkK = 64;        // depth staged in shared memory per step
constexpr int kTargetBlocks = 264;  // ~2 blocks on each of the H100's 132 SMs

// 4 consecutive activations as f32 (one 16-byte or 8-byte load)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
  return make_float4(to_f32(b[0]), to_f32(b[1]), to_f32(b[2]), to_f32(b[3]));
}

// 8 consecutive weights as f32 (one 16-byte load of bf16, two of f32)
__device__ __forceinline__ void load8(const float* p, float4& a, float4& b) {
  a = reinterpret_cast<const float4*>(p)[0];
  b = reinterpret_cast<const float4*>(p)[1];
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float4& a,
                                      float4& b) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(&raw);
  a = make_float4(to_f32(w[0]), to_f32(w[1]), to_f32(w[2]), to_f32(w[3]));
  b = make_float4(to_f32(w[4]), to_f32(w[5]), to_f32(w[6]), to_f32(w[7]));
}

// P[s, r, c] = sum_{k in slice s} X[r, k] * W[k, c] with X (n, K) of TX
// and W (K, N) of TW; P is (splits, n, N) f32.  blockIdx: x = column tile,
// y = depth slice s, z = mat * row_tiles + row tile (mat picks W0/P0 or
// W1/P1, so the gate and up products share one launch).
template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
split_k_gemm_kernel(const TX* __restrict__ X, const TW* __restrict__ W0,
                    const TW* __restrict__ W1, float* __restrict__ P0,
                    float* __restrict__ P1, int n, int K, int N,
                    int k_per_split, int row_tiles) {
  // +4: rows of xs start on different banks and stay 16-byte aligned
  __shared__ __align__(16) float xs[kTileM][kChunkK + 4];
  __shared__ __align__(16) float ws[kChunkK][kTileN];
  const int mat = blockIdx.z / row_tiles;
  const int r0 = (blockIdx.z - mat * row_tiles) * kTileM;
  const TW* __restrict__ W = mat ? W1 : W0;
  float* __restrict__ P = mat ? P1 : P0;
  const int c0 = blockIdx.x * kTileN;
  const int s = blockIdx.y;
  const int k_lo = s * k_per_split;
  const int k_hi = min(K, k_lo + k_per_split);
  const int tr = threadIdx.x / 16;     // rows tr and tr + 16 of the tile
  const int tc = threadIdx.x % 16;     // columns 4 tc .. 4 tc + 3
  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kChunkK) {
    // stage X[r0:r0+kTileM, k0:k0+kChunkK] and W[k0:.., c0:c0+kTileN] as
    // f32; rows past n, columns past N and depth past the slice read as 0
    for (int e = threadIdx.x; e < kTileM * kChunkK / 4; e += kThreads) {
      const int r = e / (kChunkK / 4);
      const int kk = (e % (kChunkK / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < n && k0 + kk < k_hi)
        v = load4(X + (size_t)(r0 + r) * K + k0 + kk);
      *reinterpret_cast<float4*>(&xs[r][kk]) = v;
    }
    for (int e = threadIdx.x; e < kChunkK * kTileN / 8; e += kThreads) {
      const int kk = e / (kTileN / 8);
      const int cc = (e % (kTileN / 8)) * 8;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (k0 + kk < k_hi && c0 + cc < N)
        load8(W + (size_t)(k0 + kk) * N + c0 + cc, a, b);
      *reinterpret_cast<float4*>(&ws[kk][cc]) = a;
      *reinterpret_cast<float4*>(&ws[kk][cc + 4]) = b;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kChunkK; ++kk) {
      const float4 w = *reinterpret_cast<const float4*>(&ws[kk][tc * 4]);
      const float x0 = xs[tr][kk];
      const float x1 = xs[tr + 16][kk];
      acc[0][0] += x0 * w.x;
      acc[0][1] += x0 * w.y;
      acc[0][2] += x0 * w.z;
      acc[0][3] += x0 * w.w;
      acc[1][0] += x1 * w.x;
      acc[1][1] += x1 * w.y;
      acc[1][2] += x1 * w.z;
      acc[1][3] += x1 * w.w;
    }
    __syncthreads();
  }
  float* Ps = P + (size_t)s * n * N;
  const int c = c0 + tc * 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + tr + 16 * i;
    if (r < n && c < N)
      *reinterpret_cast<float4*>(Ps + (size_t)r * N + c) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// One row per block: h1 = h + sum_s P[s]; hn = h1 * rsqrt(mean(h1^2) +
// eps) * scale, both f32 (n, d).
template <typename TH>
__global__ void __launch_bounds__(kThreads)
residual_norm_kernel(const TH* __restrict__ h, const float* __restrict__ P,
                     int splits, const TH* __restrict__ scale,
                     float* __restrict__ h1, float* __restrict__ hn, int n,
                     int d, float eps) {
  __shared__ float red[kThreads / 32];
  __shared__ float total;
  const int r = blockIdx.x;
  const size_t row = (size_t)r * d;
  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float v = to_f32(h[row + c]);
    for (int s = 0; s < splits; ++s) v += P[(size_t)s * n * d + row + c];
    h1[row + c] = v;
    ss += v * v;
  }
  ss = warp_sum(ss);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < kThreads / 32 ? red[threadIdx.x] : 0.f;
    t = warp_sum(t);
    if (threadIdx.x == 0) total = t;
  }
  __syncthreads();
  const float rstd = rsqrtf(total / (float)d + eps);
  for (int c = threadIdx.x; c < d; c += kThreads)
    hn[row + c] = h1[row + c] * rstd * to_f32(scale[c]);
}

// act[i] = silu(sum_s G[s][i]) * sum_s U[s][i] over `count` elements.
__global__ void __launch_bounds__(kThreads)
silu_mul_kernel(const float* __restrict__ G, const float* __restrict__ U,
                int splits, long long count, float* __restrict__ act) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < count; i += (long long)gridDim.x * kThreads) {
    float g = 0.f, u = 0.f;
    for (int s = 0; s < splits; ++s) {
      g += G[s * count + i];
      u += U[s * count + i];
    }
    act[i] = g / (1.f + expf(-g)) * u;
  }
}

// out[i] = (base ? base[i] : 0) + sum_s P[s][i], cast to TO.
template <typename TO>
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ base,
                    const float* __restrict__ P, int splits,
                    long long count, TO* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < count; i += (long long)gridDim.x * kThreads) {
    float v = base ? base[i] : 0.f;
    for (int s = 0; s < splits; ++s) v += P[s * count + i];
    out[i] = from_f32<TO>(v);
  }
}

// How a product of depth K is split across blocks: enough slices that the
// grid has ~kTargetBlocks blocks, each slice a whole number of chunks.
struct SplitK {
  int splits;
  int k_per_split;
};

inline SplitK plan_split(int K, int N, int n_mats, int n_rows) {
  const int others = ((N + kTileN - 1) / kTileN) * n_mats *
                     ((n_rows + kTileM - 1) / kTileM);
  const int chunks = (K + kChunkK - 1) / kChunkK;
  int s = (kTargetBlocks + others - 1) / others;
  s = s < 1 ? 1 : (s > chunks ? chunks : s);
  SplitK out;
  out.k_per_split = ((chunks + s - 1) / s) * kChunkK;
  out.splits = (K + out.k_per_split - 1) / out.k_per_split;
  return out;
}

template <typename TX, typename TW>
cudaError_t launch_gemm(const TX* X, const TW* W0, const TW* W1, float* P0,
                        float* P1, int n, int K, int N, int n_mats,
                        SplitK sk, cudaStream_t stream) {
  const int row_tiles = (n + kTileM - 1) / kTileM;
  const dim3 grid((N + kTileN - 1) / kTileN, sk.splits, n_mats * row_tiles);
  split_k_gemm_kernel<TX, TW><<<grid, kThreads, 0, stream>>>(
      X, W0, W1, P0, P1, n, K, N, sk.k_per_split, row_tiles);
  return cudaGetLastError();
}

inline int elementwise_blocks(long long count) {
  const long long b = (count + kThreads - 1) / kThreads;
  return (int)(b < 4096 ? (b < 1 ? 1 : b) : 4096);
}

inline cudaError_t launch_silu_mul(const float* G, const float* U,
                                   int splits, long long count, float* act,
                                   cudaStream_t stream) {
  silu_mul_kernel<<<elementwise_blocks(count), kThreads, 0, stream>>>(
      G, U, splits, count, act);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_sum_partials(const float* base, const float* P,
                                int splits, long long count, TO* out,
                                cudaStream_t stream) {
  sum_partials_kernel<TO><<<elementwise_blocks(count), kThreads, 0, stream>>>(
      base, P, splits, count, out);
  return cudaGetLastError();
}

}  // namespace mlp
