// The fused paged decode layer, written for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_decode_layer` / `_fused_kernel` in
// src/repro/kernels/fused_decode.py.  Computes what
// repro_torch.kernels.ref.fused_decode_layer_ref defines, all in f32 with
// one cast at the end:
//   attn = paged attention of q over the lane's block table (lengths
//          include the current token; window masks older rows),
//   h1   = h + attn @ wo,
//   hn   = h1 * rsqrt(mean(h1^2) + eps) * scale,
//   out  = h1 + (silu(hn @ Wg) * (hn @ Wu)) @ Wd.
//
// What bounds it on an H100: the bytes.  At qwen3-0.6b's widths a layer's
// weights are 2048x1024 + 3 x 1024x3072 values (23,068,672 B in bf16),
// read once for all lanes, plus the K/V rows the lanes attend to; with
// 8 lanes the products do ~2 flops per weight byte read, far below the
// card's ridge, so the floor is those bytes over 3.35 TB/s.
//
// Design.  The TPU kernel maps every weight matrix whole into each
// program; here they are ~100x one SM's shared memory, and the epilogue's
// phases each need whole rows of the phase before (the wo product needs
// the full attention row, RMSNorm the full h1 row, the down product the
// full silu(g)*u row).  So one op call is a fixed chain of 7 launches on
// the caller's stream, issued by one C call (no grid-wide barrier, no run
// time switch between designs):
//   1. paged attention (the kernel of paged_attention.cuh, f32 output):
//      one block per (kv head, lane), all of the lane's query heads;
//   2. split-K product attn @ wo into per-slice partial sums;
//   3. per row: h1 = h + sum of the partials, RMSNorm -> hn (f32);
//   4. split-K products hn @ Wg and hn @ Wu (one launch);
//   5. act = silu(g) * u, summing the slices;
//   6. split-K product act @ Wd;
//   7. out = h1 + sum of the partials, cast to h's type.
// Products (mlp_blocks.cuh) tile the weight by 64 columns and the depth by
// slices, each block streaming its weight tile from device memory once
// for all n <= 32 lanes and upcasting bf16 to f32 in registers; the
// (n, width) intermediates live in a caller-allocated f32 workspace (a
// few MB, L2-resident), whose slices' sums are added in a fixed order.
// The kernel allocates nothing: the wrapper passes out and the workspace.

#include "mlp_blocks.cuh"
#include "paged_attention.cuh"

namespace {

struct Layout {
  mlp::SplitK wo, gu, down;
  long long attn, p_wo, h1, hn, p_g, p_u, act, p_down, total;   // floats
};

Layout layout(int n, int nh, int hd, int d, int f) {
  Layout L;
  const int kq = nh * hd;
  L.wo = mlp::plan_split(kq, d, 1, n);
  L.gu = mlp::plan_split(d, f, 2, n);
  L.down = mlp::plan_split(f, d, 1, n);
  long long at = 0;
  L.attn = at;   at += (long long)n * kq;
  L.p_wo = at;   at += (long long)L.wo.splits * n * d;
  L.h1 = at;     at += (long long)n * d;
  L.hn = at;     at += (long long)n * d;
  L.p_g = at;    at += (long long)L.gu.splits * n * f;
  L.p_u = at;    at += (long long)L.gu.splits * n * f;
  L.act = at;    at += (long long)n * f;
  L.p_down = at; at += (long long)L.down.splits * n * d;
  L.total = at;
  return L;
}

template <typename TA, typename TKV>
cudaError_t fused_layer(const void* h, const void* q, const void* k_pages,
                        const void* v_pages, const int32_t* tables,
                        const int32_t* lengths, const void* wo,
                        const void* scale, const void* wg, const void* wu,
                        const void* wd, void* out, float* ws, int n, int nh,
                        int nkv, int hd, int bs, int n_table, int d, int f,
                        int window, float eps, cudaStream_t stream) {
  const Layout L = layout(n, nh, hd, d, f);
  const int kq = nh * hd;
  cudaError_t err = launch_paged_attention<TA, TKV, float>(
      q, k_pages, v_pages, nullptr, nullptr, tables, lengths, ws + L.attn, n,
      nh, nkv, hd, bs, n_table, window, stream);
  if (err != cudaSuccess) return err;
  err = mlp::launch_gemm<float, TA>(ws + L.attn, static_cast<const TA*>(wo),
                                    nullptr, ws + L.p_wo, nullptr, n, kq, d,
                                    1, L.wo, stream);
  if (err != cudaSuccess) return err;
  mlp::residual_norm_kernel<TA><<<n, mlp::kThreads, 0, stream>>>(
      static_cast<const TA*>(h), ws + L.p_wo, L.wo.splits,
      static_cast<const TA*>(scale), ws + L.h1, ws + L.hn, n, d, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = mlp::launch_gemm<float, TA>(ws + L.hn, static_cast<const TA*>(wg),
                                    static_cast<const TA*>(wu), ws + L.p_g,
                                    ws + L.p_u, n, d, f, 2, L.gu, stream);
  if (err != cudaSuccess) return err;
  err = mlp::launch_silu_mul(ws + L.p_g, ws + L.p_u, L.gu.splits,
                             (long long)n * f, ws + L.act, stream);
  if (err != cudaSuccess) return err;
  err = mlp::launch_gemm<float, TA>(ws + L.act, static_cast<const TA*>(wd),
                                    nullptr, ws + L.p_down, nullptr, n, f, d,
                                    1, L.down, stream);
  if (err != cudaSuccess) return err;
  return mlp::launch_sum_partials<TA>(ws + L.h1, ws + L.p_down,
                                      L.down.splits, (long long)n * d,
                                      static_cast<TA*>(out), stream);
}

}  // namespace

// f32 elements of the workspace one call needs.
extern "C" long long fused_decode_workspace_floats(int n, int nh, int hd,
                                                   int d, int f) {
  return layout(n, nh, hd, d, f).total;
}

// dtype codes: 0 = float32, 1 = bfloat16.  act_dtype is that of h, q, the
// weights, the norm scale and out; kv_dtype that of the pages.  window <= 0
// means no window.  Returns the first failing launch's cudaError_t (0 on
// success).
extern "C" int fused_decode_layer_fwd(
    const void* h, const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, const void* wo,
    const void* scale, const void* wg, const void* wu, const void* wd,
    void* out, void* workspace, int n, int nh, int nkv, int hd, int bs,
    int n_table, int d, int f, int window, float eps, int act_dtype,
    int kv_dtype, void* stream) {
  const int32_t* t = static_cast<const int32_t*>(tables);
  const int32_t* l = static_cast<const int32_t*>(lengths);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define FUSED_ARGS                                                         \
  h, q, k_pages, v_pages, t, l, wo, scale, wg, wu, wd, out, ws, n, nh, nkv, \
      hd, bs, n_table, d, f, window, eps, s
  if (act_dtype == 0 && kv_dtype == 0)
    return fused_layer<float, float>(FUSED_ARGS);
  if (act_dtype == 1 && kv_dtype == 1)
    return fused_layer<bf16, bf16>(FUSED_ARGS);
  if (act_dtype == 0 && kv_dtype == 1)
    return fused_layer<float, bf16>(FUSED_ARGS);
  if (act_dtype == 1 && kv_dtype == 0)
    return fused_layer<bf16, float>(FUSED_ARGS);
#undef FUSED_ARGS
  return (int)cudaErrorInvalidValue;
}
