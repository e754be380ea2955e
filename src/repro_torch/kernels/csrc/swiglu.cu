// The SwiGLU MLP silu(x @ Wg) * (x @ Wu) @ Wd, written for Hopper (sm_90a).
//
// Replaces the TPU kernel `swiglu_2d` / `_swiglu_kernel` in
// src/repro/kernels/swiglu.py.  Computes what
// repro_torch.kernels.ref.swiglu_ref defines: both products and the silu
// in f32 from x and weights of one type, f32 accumulation, one cast of the
// result to x's type.
//
// What bounds it on an H100: with m rows, 6 m d f flops against
// 3 d f weights read, so few rows (decode, m < ~300 in bf16) are bound by
// the weight bytes and many rows (prefill, training) by the flops; this
// kernel does its flops on the CUDA cores in f32 (67 TFLOP/s), not on the
// tensor cores the bf16 bound assumes.
//
// Design.  The TPU kernel keeps the (m, f) hidden in VMEM, one (256, 512)
// tile at a time, accumulating the (256, d) output across d_ff blocks.
// Here the hidden goes through a device-memory workspace instead: one call
// is a fixed chain of 4 launches built from mlp_blocks.cuh — the gate and
// up products (one split-K launch), act = silu(g) * u in f32, the down
// product, and the sum of its slices cast to x's type — so the same
// product kernel serves the fused decode layer and a block never holds
// more than a 32 x 64 output tile.  The workspace holds g, u (per depth
// slice), act and the down product's slices in f32: for m rows at
// qwen3-0.6b's widths ~(3 x 3072 + 1024) x 4 m bytes once the rows fill
// the card (no split), more for few rows.  The wrapper allocates it.

#include "mlp_blocks.cuh"

namespace {

struct Layout {
  mlp::SplitK gu, down;
  long long p_g, p_u, act, p_down, total;   // floats
};

Layout layout(int m, int d, int f) {
  Layout L;
  L.gu = mlp::plan_split(d, f, 2, m);
  L.down = mlp::plan_split(f, d, 1, m);
  long long at = 0;
  L.p_g = at;    at += (long long)L.gu.splits * m * f;
  L.p_u = at;    at += (long long)L.gu.splits * m * f;
  L.act = at;    at += (long long)m * f;
  L.p_down = at; at += (long long)L.down.splits * m * d;
  L.total = at;
  return L;
}

template <typename T>
cudaError_t swiglu(const void* x, const void* wg, const void* wu,
                   const void* wd, void* out, float* ws, int m, int d, int f,
                   cudaStream_t stream) {
  const Layout L = layout(m, d, f);
  cudaError_t err = mlp::launch_gemm<T, T>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), ws + L.p_g, ws + L.p_u, m, d, f, 2, L.gu,
      stream);
  if (err != cudaSuccess) return err;
  err = mlp::launch_silu_mul(ws + L.p_g, ws + L.p_u, L.gu.splits,
                             (long long)m * f, ws + L.act, stream);
  if (err != cudaSuccess) return err;
  err = mlp::launch_gemm<float, T>(ws + L.act, static_cast<const T*>(wd),
                                   nullptr, ws + L.p_down, nullptr, m, f, d,
                                   1, L.down, stream);
  if (err != cudaSuccess) return err;
  return mlp::launch_sum_partials<T>(nullptr, ws + L.p_down, L.down.splits,
                                     (long long)m * d, static_cast<T*>(out),
                                     stream);
}

}  // namespace

// f32 elements of the workspace one call needs.
extern "C" long long swiglu_workspace_floats(int m, int d, int f) {
  return layout(m, d, f).total;
}

// dtype codes: 0 = float32, 1 = bfloat16 (x, the weights and out share
// it).  Returns the first failing launch's cudaError_t (0 on success).
extern "C" int swiglu_fwd(const void* x, const void* wg, const void* wu,
                          const void* wd, void* out, void* workspace, int m,
                          int d, int f, int dtype, void* stream) {
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return swiglu<float>(x, wg, wu, wd, out, ws, m, d, f, s);
  if (dtype == 1)
    return swiglu<__nv_bfloat16>(x, wg, wu, wd, out, ws, m, d, f, s);
  return (int)cudaErrorInvalidValue;
}
