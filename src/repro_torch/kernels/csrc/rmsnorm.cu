// RMSNorm over the last axis of a (rows, d) matrix, written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `rms_norm_2d` / `_rmsnorm_kernel` in
// src/repro/kernels/rmsnorm.py.  Computes what
// repro_torch.kernels.ref.rms_norm_ref defines:
// out = (x * rsqrt(mean(x^2) + eps)) * w in f32, cast to x's type.
//
// What bounds it on an H100: the bytes — x read once, out written once,
// w (d values) read by every row but from cache; a handful of flops per
// element.  The floor is (2 rows d + d) * itemsize over 3.35 TB/s.
//
// Design (simple first): one warp per row, 8 rows per block.  Lane i takes
// columns i, i + 32, ... so a warp reads 32 consecutive elements per step;
// the sum of squares is f32, reduced by shuffles; a second pass over the
// row (now in L1/L2) writes the output.  The TPU kernel's 256-row tiles
// exist to amortize its grid steps; a warp per row needs no tiling.  CUDA
// rather than Triton because the port's kernels share one nvcc build path
// and none of them needs Triton's runtime.

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = kRowsPerBlock * 32;

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rms_norm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                TX* __restrict__ out, int rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;                  // whole warps leave together
  const TX* xr = x + (size_t)row * d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = to_f32(xr[c]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  const float rstd = rsqrtf(ss / (float)d + eps);
  TX* o = out + (size_t)row * d;
  for (int c = lane; c < d; c += 32)
    o[c] = from_f32<TX>(to_f32(xr[c]) * rstd * to_f32(w[c]));
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int d,
                   float eps, cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rms_norm_kernel<TX, TW><<<blocks, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(out), rows, d, eps);
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
