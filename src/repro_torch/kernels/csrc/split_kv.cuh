// Device code shared by the split-KV paged attention kernels: decode
// (paged_attention.cu, one query row per query head) and speculative
// verify (paged_verify.cu, k query rows per query head).  Both cut each
// lane's logical rows into fixed splits, grid (kv_head, lane, split), and
// write one f32 partial softmax state (m, l, acc) per split and query row
// to scratch the wrapper allocates; split_merge_kernel then combines a
// (lane, KV head)'s splits in split order, so a call repeats bit for bit.
// Scores are kept in log2 units (q.k * 1/sqrt(hd) * log2(e)), so the
// partials' m are too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;        // the TPU kernels' mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMergeWarps = 8;

// 2^x on the special-function unit (flushes results below 2^-126 to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// N contiguous elements as f32, in one vector load
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[N]) {
  const Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = to_f32(x.v[j]);
}

// One call's shape.  kq: query rows per query head (1 for decode);
// rows of a (lane, KV head) = kq * groups.
struct Shape {
  int kq, nkv, hd, bs, n_table, groups, window, n_split, tile;
  float sl2;                     // 1/sqrt(hd) * log2(e): scores in log2 units
};

// Grid (kv_head, lane), one warp per query row: merge the splits'
// partials (part_ml (n, nkv, S, R) float2, part_acc (n, nkv, S, R, hd))
// in split order into out (n, kq, nh, hd).  Launched as a programmatic
// dependent of the split kernel (decode) or after it (verify).
template <typename TQ>
__global__ void __launch_bounds__(kMergeWarps * 32)
split_merge_kernel(const float2* __restrict__ part_ml,
                   const float* __restrict__ part_acc, TQ* __restrict__ out,
                   Shape a) {
  const int kvh = blockIdx.x;
  const int seq = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rows = a.kq * a.groups;
  const int hd = a.hd;
  const int nh = a.nkv * a.groups;
  const size_t pb = ((size_t)seq * a.nkv + kvh) * a.n_split * rows;
  grid_launch_dependents();                // a dependent consumer (the fused
                                           // layer's wo product) may start
  grid_dependency_wait();                  // every split's partial written
  for (int r = warp; r < rows; r += kMergeWarps) {
    float big = kNegInf;
    for (int s = lane; s < a.n_split; s += 32)
      big = fmaxf(big, part_ml[pb + (size_t)s * rows + r].x);
    big = warp_max(big);
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    float den = 0.f;
    // four splits at a time, their loads issued before any is used; an
    // empty split (l = 0) adds nothing, and its acc, never written, is
    // selected away rather than multiplied by 0
    for (int s0 = 0; s0 < a.n_split; s0 += 4) {
      float2 ml[4];
      float v[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int s = min(s0 + u, a.n_split - 1);
        ml[u] = part_ml[pb + (size_t)s * rows + r];
        const float* src = part_acc + (pb + (size_t)s * rows + r) * hd;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v[u][k] = lane + 32 * k < hd ? src[lane + 32 * k] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (s0 + u < a.n_split && ml[u].y > 0.f) {   // uniform in the warp
          const float w = exp2_approx(ml[u].x - big);
          den += ml[u].y * w;
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] += v[u][k] * w;
        }
      }
    }
    const float inv = 1.f / fmaxf(den, 1e-30f);
    const int i = r / a.groups;
    const int head = kvh * a.groups + (r - i * a.groups);
    TQ* o_row = out + (((size_t)seq * a.kq + i) * nh + head) * hd;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (lane + 32 * k < hd) o_row[lane + 32 * k] = from_f32<TQ>(acc[k] * inv);
  }
}

}  // namespace
