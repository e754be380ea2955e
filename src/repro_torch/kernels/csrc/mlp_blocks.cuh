// Row passes of the fused decode layer (fused_decode.cu) and of SwiGLU's
// few-row chain (swiglu.cu), written for Hopper (sm_90a):
//
//  * residual_norm_kernel: h1 = h + sum_s P[s], then
//    hn = h1 * rsqrt(mean(h1^2) + eps) * scale (one block per row);
//  * silu_mul_kernel: act = silu(sum_s G[s]) * sum_s U[s];
//  * sum_partials_kernel: out = base + sum_s P[s], cast to the output type.
// P, G and U are the f32 partial sums of the depth slices of a product
// (stream_gemm.cuh), added in slice order, so results do not change from
// run to run.  The passes run as programmatic dependent launches: each
// lets the next grid be scheduled, then waits for the previous grid's
// writes (both no-ops under a plain launch).
//
// Shapes the wrappers guarantee: d % 4 == 0, 16-byte aligned operands
// (the vector loads), row-major contiguous tensors.

#pragma once

#include "common.cuh"

namespace mlp {

constexpr int kThreads = 256;

// 4 consecutive activations as f32 (one 16-byte or 8-byte load)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
  return make_float4(to_f32(b[0]), to_f32(b[1]), to_f32(b[2]), to_f32(b[3]));
}

// One row per block: h1 = h + sum_s P[s]; hn = h1 * rsqrt(mean(h1^2) +
// eps) * scale, both f32 (n, d), d % 4 == 0.  A thread takes 4 adjacent
// columns and has four slices' 16-byte loads in flight at once; the
// slices are still added in order.
template <typename TH>
__global__ void __launch_bounds__(kThreads)
residual_norm_kernel(const TH* __restrict__ h, const float* __restrict__ P,
                     int splits, const TH* __restrict__ scale,
                     float* __restrict__ h1, float* __restrict__ hn, int n,
                     int d, float eps) {
  __shared__ float red[kThreads / 32];
  __shared__ float total;
  grid_launch_dependents();
  grid_dependency_wait();
  const int r = blockIdx.x;
  const size_t row = (size_t)r * d;
  const size_t slice = (size_t)n * d;
  auto add = [](float4& v, const float4 p) {
    v.x += p.x;
    v.y += p.y;
    v.z += p.z;
    v.w += p.w;
  };
  float ss = 0.f;
  for (int c = threadIdx.x * 4; c < d; c += kThreads * 4) {
    float4 v = load4(h + row + c);
    const float* pc = P + row + c;
    int s = 0;
    for (; s + 4 <= splits; s += 4) {
      const float4 p0 = load4(pc + (s + 0) * slice);
      const float4 p1 = load4(pc + (s + 1) * slice);
      const float4 p2 = load4(pc + (s + 2) * slice);
      const float4 p3 = load4(pc + (s + 3) * slice);
      add(v, p0);
      add(v, p1);
      add(v, p2);
      add(v, p3);
    }
    for (; s < splits; ++s) add(v, load4(pc + s * slice));
    *reinterpret_cast<float4*>(h1 + row + c) = v;
    ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
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
  for (int c = threadIdx.x * 4; c < d; c += kThreads * 4) {
    const float4 v = *reinterpret_cast<const float4*>(h1 + row + c);
    const float4 g = load4(scale + c);
    *reinterpret_cast<float4*>(hn + row + c) =
        make_float4(v.x * rstd * g.x, v.y * rstd * g.y, v.z * rstd * g.z,
                    v.w * rstd * g.w);
  }
}

// act[i] = silu(sum_s G[s][i]) * sum_s U[s][i] over `count` elements.
__global__ void __launch_bounds__(kThreads)
silu_mul_kernel(const float* __restrict__ G, const float* __restrict__ U,
                int splits, long long count, float* __restrict__ act) {
  grid_launch_dependents();
  grid_dependency_wait();
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
  grid_launch_dependents();
  grid_dependency_wait();
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < count; i += (long long)gridDim.x * kThreads) {
    float v = base ? base[i] : 0.f;
    for (int s = 0; s < splits; ++s) v += P[s * count + i];
    out[i] = from_f32<TO>(v);
  }
}

inline int elementwise_blocks(long long count) {
  const long long b = (count + kThreads - 1) / kThreads;
  return (int)(b < 4096 ? (b < 1 ? 1 : b) : 4096);
}

}  // namespace mlp
