// Paged attention for one decode token per lane over fp pages (f32, bf16
// or fp8 e4m3) and over int8 pages with per-row scales, written for Hopper
// (sm_90a): the C entry points of the split-KV decode kernel of
// paged_decode.cuh (its design notes are there).
//
// Replaces the TPU kernels `paged_attention_lanes` / `_paged_kernel` and
// `paged_attention_quant_lanes` / `_paged_quant_kernel` in
// src/repro/kernels/paged_attention.py.

#include "paged_decode.cuh"

// Number of splits a call with this table needs (the scratch's third axis;
// at least one, so an empty table still launches and writes zeros).
extern "C" int paged_attention_splits(int n_table, int bs) {
  return decode_splits(n_table, bs);
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn (kv_dtype
// only: pages of the JAX package's fp8 KV cache, converted to f32 in
// registers as they are read).  window <= 0 means no window.
// part_ml: n * nkv * splits * groups float2; part_acc: that many rows of
// hd floats (splits from paged_attention_splits).  Two launches (split,
// merge); returns the first failing cudaError_t (0 on success).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const void* tables,
                                   const void* lengths, void* out,
                                   void* part_ml, void* part_acc, int n,
                                   int nh, int nkv, int hd, int bs,
                                   int n_table, int window, int q_dtype,
                                   int kv_dtype, void* stream) {
  const int32_t* t = static_cast<const int32_t*>(tables);
  const int32_t* l = static_cast<const int32_t*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (nkv < 1 || nh % nkv != 0) return (int)cudaErrorInvalidValue;
  const Shape a = make_shape(nh, nkv, hd, bs, n_table, window,
                             decode_splits(n_table, bs));
  if (q_dtype == 0 && kv_dtype == 0)
    return dispatch<float, float, float>(q, k_pages, v_pages, nullptr,
                                         nullptr, t, l, out, part_ml,
                                         part_acc, n, a, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch<bf16, bf16, bf16>(q, k_pages, v_pages, nullptr, nullptr,
                                      t, l, out, part_ml, part_acc, n, a, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return dispatch<float, float, bf16>(q, k_pages, v_pages, nullptr,
                                        nullptr, t, l, out, part_ml,
                                        part_acc, n, a, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return dispatch<bf16, bf16, float>(q, k_pages, v_pages, nullptr,
                                       nullptr, t, l, out, part_ml,
                                       part_acc, n, a, s);
  using fp8 = __nv_fp8_e4m3;
  if (q_dtype == 0 && kv_dtype == 2)
    return dispatch<float, float, fp8>(q, k_pages, v_pages, nullptr,
                                       nullptr, t, l, out, part_ml,
                                       part_acc, n, a, s);
  if (q_dtype == 1 && kv_dtype == 2)
    return dispatch<bf16, bf16, fp8>(q, k_pages, v_pages, nullptr, nullptr,
                                     t, l, out, part_ml, part_acc, n, a, s);
  return (int)cudaErrorInvalidValue;
}

// int8 pages with f32 per-row scales (P, bs, nkv); q_dtype and the
// scratch as above.  Two launches; returns the first failing cudaError_t
// (0 on success).
extern "C" int paged_attention_quant_fwd(const void* q, const void* k_pages,
                                         const void* v_pages,
                                         const void* k_scales,
                                         const void* v_scales,
                                         const void* tables,
                                         const void* lengths, void* out,
                                         void* part_ml, void* part_acc,
                                         int n, int nh, int nkv, int hd,
                                         int bs, int n_table, int window,
                                         int q_dtype, void* stream) {
  const int32_t* t = static_cast<const int32_t*>(tables);
  const int32_t* l = static_cast<const int32_t*>(lengths);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nkv < 1 || nh % nkv != 0) return (int)cudaErrorInvalidValue;
  const Shape a = make_shape(nh, nkv, hd, bs, n_table, window,
                             decode_splits(n_table, bs));
  if (q_dtype == 0)
    return dispatch<float, float, int8_t>(q, k_pages, v_pages, ks, vs, t, l,
                                          out, part_ml, part_acc, n, a, s);
  using bf16 = __nv_bfloat16;
  if (q_dtype == 1)
    return dispatch<bf16, bf16, int8_t>(q, k_pages, v_pages, ks, vs, t, l,
                                        out, part_ml, part_acc, n, a, s);
  return (int)cudaErrorInvalidValue;
}
