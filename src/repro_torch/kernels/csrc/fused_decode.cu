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
// 8 lanes the products do ~2 flops per weight value read, far below the
// card's ridge, so the floor is those bytes over 3.35 TB/s.
//
// Design.  The TPU kernel maps every weight matrix whole into each
// program; here they are ~100x one SM's shared memory, and the epilogue's
// phases each need whole rows of the phase before (the wo product needs
// the full attention row, RMSNorm the full h1 row, the down product the
// full silu(g)*u row).  So one op call is a fixed chain of 8 launches on
// the caller's stream, issued by one C call (no grid-wide barrier, no run
// time switch between designs):
//   1. the split-KV decode kernel of paged_decode.cuh: 128-row splits
//      from the table width, grid (kv_head, lane, split), page tiles
//      through a cp.async ring, f32 partials;
//   2. its fixed-order merge, which writes the f32 attention rows into
//      the workspace;
//   3. the split-K product attn @ wo into per-slice partial sums;
//   4. per row: h1 = h + the partials summed in slice order, RMSNorm ->
//      hn (f32);
//   5. the split-K products hn @ Wg and hn @ Wu (one launch);
//   6. act = silu(sum of the G slices) * (sum of the U slices);
//   7. the split-K product act @ Wd;
//   8. out = h1 + the partials summed in slice order, cast to h's type.
// Launches 2-8 are programmatic dependents of the launch before each: a
// grid's blocks are scheduled while the previous grid runs and wait in
// griddepcontrol.wait for its writes, which hides the launch gaps, and
// the product kernels (stream_gemm.cuh) issue their first weight tiles
// before that wait, so the 23 MB of weights stream while attention, the
// merge and the row passes compute.  bf16 weights run on the tensor cores
// (mma.sync with the operands swapped, activations split into two bf16
// parts), f32 weights on the CUDA cores; both stream through a cp.async
// ring.  The (n, width) intermediates live in a caller-allocated f32
// workspace (a few MB, L2-resident), whose slices' sums are added in a
// fixed order, so a call repeats bit for bit.  Folding a row pass into
// its consumer bought nothing: silu * u formed while the down product
// stages its activations measured within 0.5 us of launch 6 (PERF.md
// §6), and the residual + RMSNorm of a block's lanes in the gate/up
// prologue would have each of its ~290 blocks re-read all wo partials of
// its rows (the norm needs whole rows).  The kernels allocate nothing:
// the wrapper passes out and the workspace.

#include "mlp_blocks.cuh"     // residual + RMSNorm, silu * u, final sum
#include "paged_decode.cuh"   // the split-KV attention and its merge
#include "stream_gemm.cuh"    // the weight-streaming products

namespace {

inline long long align4(long long x) { return (x + 3) & ~3ll; }

struct Layout {
  int n_split;                         // attention splits
  sg::Split wo, gu, down;
  long long part_ml, part_acc, attn, p_wo, h1, hn, p_g, p_u, act, p_down,
      total;                           // floats
};

Layout layout(int n, int nh, int nkv, int hd, int bs, int n_table, int d,
              int f) {
  Layout L;
  const int kq = nh * hd;
  const int rt = sg::row_tiles(n);
  L.n_split = decode_splits(n_table, bs);
  L.wo = sg::plan(kq, d, 1, rt);
  L.gu = sg::plan(d, f, 2, rt);
  L.down = sg::plan(f, d, 1, rt);
  long long at = 0;
  auto take = [&](long long floats) {
    const long long off = at;
    at = align4(at + floats);
    return off;
  };
  const long long parts = (long long)n * nkv * L.n_split * (nh / nkv);
  L.part_ml = take(2 * parts);
  L.part_acc = take(parts * hd);
  L.attn = take((long long)n * kq);
  L.p_wo = take((long long)L.wo.splits * n * d);
  L.h1 = take((long long)n * d);
  L.hn = take((long long)n * d);
  L.p_g = take((long long)L.gu.splits * n * f);
  L.p_u = take((long long)L.gu.splits * n * f);
  L.act = take((long long)n * f);
  L.p_down = take((long long)L.down.splits * n * d);
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
  const Layout L = layout(n, nh, nkv, hd, bs, n_table, d, f);
  const int kq = nh * hd;
  const TA* w_o = static_cast<const TA*>(wo);
  const TA* w_g = static_cast<const TA*>(wg);
  const TA* w_u = static_cast<const TA*>(wu);
  const TA* w_d = static_cast<const TA*>(wd);
  const Shape a = make_shape(nh, nkv, hd, bs, n_table, window, L.n_split);
  cudaError_t err = dispatch<TA, float, TKV>(
      q, k_pages, v_pages, nullptr, nullptr, tables, lengths, ws + L.attn,
      ws + L.part_ml, ws + L.part_acc, n, a, stream);
  if (err != cudaSuccess) return err;
  err = sg::launch_product<TA>(ws + L.attn, w_o, w_o, ws + L.p_wo,
                               ws + L.p_wo, n, kq, d, 1, L.wo, stream);
  if (err != cudaSuccess) return err;
  err = launch_dependent(mlp::residual_norm_kernel<TA>, dim3(n),
                         dim3(mlp::kThreads), 0, stream,
                         static_cast<const TA*>(h), ws + L.p_wo,
                         L.wo.splits, static_cast<const TA*>(scale),
                         ws + L.h1, ws + L.hn, n, d, eps);
  if (err != cudaSuccess) return err;
  err = sg::launch_product<TA>(ws + L.hn, w_g, w_u, ws + L.p_g, ws + L.p_u,
                               n, d, f, 2, L.gu, stream);
  if (err != cudaSuccess) return err;
  const long long nf = (long long)n * f;
  err = launch_dependent(mlp::silu_mul_kernel,
                         dim3(mlp::elementwise_blocks(nf)),
                         dim3(mlp::kThreads), 0, stream, ws + L.p_g,
                         ws + L.p_u, L.gu.splits, nf, ws + L.act);
  if (err != cudaSuccess) return err;
  err = sg::launch_product<TA>(ws + L.act, w_d, w_d, ws + L.p_down,
                               ws + L.p_down, n, f, d, 1, L.down, stream);
  if (err != cudaSuccess) return err;
  const long long nd = (long long)n * d;
  return launch_dependent(mlp::sum_partials_kernel<TA>,
                          dim3(mlp::elementwise_blocks(nd)),
                          dim3(mlp::kThreads), 0, stream, ws + L.h1,
                          ws + L.p_down, L.down.splits, nd,
                          static_cast<TA*>(out));
}

}  // namespace

// f32 elements of the workspace one call needs.
extern "C" long long fused_decode_workspace_floats(int n, int nh, int nkv,
                                                   int hd, int bs,
                                                   int n_table, int d,
                                                   int f) {
  return layout(n, nh, nkv, hd, bs, n_table, d, f).total;
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn (kv_dtype
// only).  act_dtype is that of h, q, the weights, the norm scale and out;
// kv_dtype that of the pages.  window <= 0
// means no window.  Returns the first failing launch's cudaError_t (0 on
// success).
extern "C" int fused_decode_layer_fwd(
    const void* h, const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, const void* wo,
    const void* scale, const void* wg, const void* wu, const void* wd,
    void* out, void* workspace, int n, int nh, int nkv, int hd, int bs,
    int n_table, int d, int f, int window, float eps, int act_dtype,
    int kv_dtype, void* stream) {
  if (nkv < 1 || nh % nkv != 0) return (int)cudaErrorInvalidValue;
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
  if (act_dtype == 0 && kv_dtype == 2)
    return fused_layer<float, __nv_fp8_e4m3>(FUSED_ARGS);
  if (act_dtype == 1 && kv_dtype == 2)
    return fused_layer<bf16, __nv_fp8_e4m3>(FUSED_ARGS);
#undef FUSED_ARGS
  return (int)cudaErrorInvalidValue;
}
