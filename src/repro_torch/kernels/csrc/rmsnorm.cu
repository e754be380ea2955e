// RMSNorm over the last axis of a (rows, d) matrix, written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `rms_norm_2d` / `_rmsnorm_kernel` in
// src/repro/kernels/rmsnorm.py.  Computes what
// repro_torch.kernels.ref.rms_norm_ref defines:
// out = (x * rsqrt(mean(x^2) + eps)) * w in f32, cast once to x's type;
// x and w may differ in type (f32 or bf16 each), d is any width.
//
// What bounds it on an H100: the bytes — x read once, out written once,
// w (d values) read once per warp or block; a handful of flops per
// element.  The floor is (2 rows d + d) * itemsize over 3.35 TB/s, and at
// few rows the launch itself (PERF.md: the harness floor).
//
// Design: one read of x, the row held in registers.
//  - A thread holds up to kMaxVec 16-byte vectors of its row (8 bf16 or
//    4 f32 each; vector v of thread t is the row's vector v * tpr + t, so
//    a warp's loads are contiguous), issued together: a row costs one
//    round trip to memory, not a chain of them, and no second pass.
//  - A row is split over tpr threads, the fewest warps that hold it in
//    those registers: a warp at d <= 2048 bf16 or 1024 f32, a block of up
//    to 8 warps past that (d <= 16384 bf16, 8192 f32).  Warp rows run up
//    to 4 to a block, fewer below 512 rows (kTargetBlocks blocks or more).
//  - w is loaded into registers the same way, its loads issued after x's:
//    x is on the critical path (sum, reduction), w only scales the output.
//  - The sum of squares is f32 in a fixed order (each thread's vectors in
//    order, a butterfly over the warp, the warps in order): a call repeats
//    bit for bit.
//  - Where d is not a multiple of the vector width or an operand is not
//    16-byte aligned (bf16 with d % 8 != 0), the same kernel runs on
//    single elements; rows wider than 8 warps' registers take a two-pass
//    block-per-row kernel.
// CUDA rather than Triton because the port's kernels share one nvcc build
// path and none of them needs Triton's runtime.

#include "common.cuh"

namespace {

constexpr int kMaxVec = 8;          // vectors a thread holds
constexpr int kMaxWarps = 8;        // warps a row may span
constexpr int kWarpRowsPerBlock = 4;
constexpr int kTargetBlocks = 128;  // 512 rows: 4 warp rows a block
constexpr int kWideThreads = 1024;

// N consecutive elements of T, loaded and stored as one access (two for
// 32 bytes)
template <typename T, int N>
struct alignas(sizeof(T) * N >= 16 ? 16 : sizeof(T) * N) Vec {
  T v[N];
};

// the sum of x over the threads of a row: a warp's butterfly, then (tpr >
// 32) the warps' sums in warp order through shared memory
__device__ __forceinline__ float row_sum(float x, int tpr, float* red) {
  x = warp_sum(x);
  if (tpr == 32) return x;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = x;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < tpr / 32; ++i) total += red[i];
  __syncthreads();                  // red is free for the next row
  return total;
}

// Rows of tpr threads; tpr == 32: blockDim / 32 warp rows a block, else
// one block row.  VX elements a vector (1: the single-element path), VPT
// vectors a thread.
template <typename TX, typename TW, int VX, int VPT>
__global__ void __launch_bounds__(32 * kMaxWarps)
rms_norm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                TX* __restrict__ out, int rows, int d, int tpr, float eps) {
  using VXv = Vec<TX, VX>;
  using VWv = Vec<TW, VX>;
  __shared__ float red[kMaxWarps];
  const int nv = d / VX;
  const int t = threadIdx.x % tpr;
  const int row = blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;
  const VWv* wp = reinterpret_cast<const VWv*>(w);
  const VXv* xr = reinterpret_cast<const VXv*>(x + (size_t)row * d);
  VXv xv[VPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v)
    if (live && v * tpr + t < nv) xv[v] = xr[v * tpr + t];
  VWv wv[VPT];                     // after x: needed only at the end
#pragma unroll
  for (int v = 0; v < VPT; ++v)
    if (v * tpr + t < nv) wv[v] = wp[v * tpr + t];
  if (!live) return;               // no barrier follows for warp rows
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    if (v * tpr + t < nv) {
#pragma unroll
      for (int e = 0; e < VX; ++e) {
        const float f = to_f32(xv[v].v[e]);
        ss += f * f;
      }
    }
  }
  const float rstd = rsqrtf(row_sum(ss, tpr, red) / (float)d + eps);
  VXv* o = reinterpret_cast<VXv*>(out + (size_t)row * d);
#pragma unroll
  for (int v = 0; v < VPT; ++v)
    if (v * tpr + t < nv) {
      VXv r;
#pragma unroll
      for (int e = 0; e < VX; ++e)
        r.v[e] = from_f32<TX>(to_f32(xv[v].v[e]) * rstd *
                              to_f32(wv[v].v[e]));
      o[v * tpr + t] = r;
    }
}

// Rows too wide for the registers: a block a row, one pass for the sum of
// squares and one (from L2) for the output.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kWideThreads)
rms_norm_wide_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                     TX* __restrict__ out, int d, float eps) {
  __shared__ float red[kWideThreads / 32];
  const TX* xr = x + (size_t)blockIdx.x * d;
  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += kWideThreads) {
    const float f = to_f32(xr[c]);
    ss += f * f;
  }
  const float rstd = rsqrtf(row_sum(ss, kWideThreads, red) / (float)d + eps);
  TX* o = out + (size_t)blockIdx.x * d;
  for (int c = threadIdx.x; c < d; c += kWideThreads)
    o[c] = from_f32<TX>(to_f32(xr[c]) * rstd * to_f32(w[c]));
}

template <typename TX, typename TW, int VX>
cudaError_t launch_resident(const void* x, const void* w, void* out,
                            int rows, int d, float eps, cudaStream_t stream) {
  const int nv = d / VX;
  const int warps = (nv + 32 * kMaxVec - 1) / (32 * kMaxVec);
  const int tpr = 32 * warps;
  const int vpt = (nv + tpr - 1) / tpr;
  int per_block = 1;               // rows a block
  if (warps == 1) {
    per_block = rows / kTargetBlocks;
    per_block = per_block < 1 ? 1
                : (per_block > kWarpRowsPerBlock ? kWarpRowsPerBlock
                                                 : per_block);
  }
  const long long blocks = (rows + per_block - 1) / per_block;
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* op = static_cast<TX*>(out);
  const dim3 grid((unsigned)blocks), block(tpr * per_block);
  if (vpt <= 1)
    rms_norm_kernel<TX, TW, VX, 1><<<grid, block, 0, stream>>>(
        xp, wp, op, rows, d, tpr, eps);
  else if (vpt <= 2)
    rms_norm_kernel<TX, TW, VX, 2><<<grid, block, 0, stream>>>(
        xp, wp, op, rows, d, tpr, eps);
  else if (vpt <= 4)
    rms_norm_kernel<TX, TW, VX, 4><<<grid, block, 0, stream>>>(
        xp, wp, op, rows, d, tpr, eps);
  else
    rms_norm_kernel<TX, TW, VX, 8><<<grid, block, 0, stream>>>(
        xp, wp, op, rows, d, tpr, eps);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int d,
                   float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TX);        // elements of a 16-byte x
  const bool vec = d % kVec == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(out);
  const int nv = vec ? d / kVec : d;
  if (nv <= 32 * kMaxVec * kMaxWarps) {
    if (vec)
      return launch_resident<TX, TW, kVec>(x, w, out, rows, d, eps, stream);
    return launch_resident<TX, TW, 1>(x, w, out, rows, d, eps, stream);
  }
  rms_norm_wide_kernel<TX, TW><<<rows, kWideThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(out), d, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; out has x's type.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int rms_norm_fwd(const void* x, const void* w, void* out, int rows,
                            int d, float eps, int x_dtype, int w_dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, w, out, rows, d, eps, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<bf16, bf16>(x, w, out, rows, d, eps, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<bf16, float>(x, w, out, rows, d, eps, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, bf16>(x, w, out, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
