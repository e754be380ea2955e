// Paged attention for one decode token per lane, read through per-lane
// block tables, written for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_attention_lanes` / `_paged_kernel` in
// src/repro/kernels/paged_attention.py.  Computes what
// repro_torch.kernels.ref.paged_attention_ref defines: for each lane and
// KV head, the `groups = nh / nkv` query heads attend over the logical rows
// [max(0, length - window), length); K/V row `row` lives in physical block
// tables[lane, row / bs] at offset row % bs; scores are q.k * 1/sqrt(hd) in
// f32; the softmax is online in f32; the output is cast to q's dtype.
//
// What bounds it on an H100: the bytes.  A launch must read
// sum_lanes ceil(len/bs) * bs * nkv * hd * 2 (K and V) * itemsize bytes of
// pages and does ~2 flops per element read, far below the card's ~295
// flop/byte ridge, so the floor is those bytes over 3.35 TB/s.  At full
// width and short contexts the launch latency (a few microseconds) is as
// large as the byte time.
//
// Design (simple first; memory-level parallelism over everything else):
//  * one CUDA block of 8 warps per (kv_head, lane): the TPU grid's
//    (lane, kv_head) axes become blockIdx.y / blockIdx.x;
//  * the TPU's sequential logical-block grid axis becomes a loop inside the
//    block: warp w takes rows in batches of kRows, batch k covering rows
//    lo + (k * kWarps + w) * kRows ..., from the first row inside the
//    window to length - 1 — masked rows are never read;
//  * the block reads its own table entries (the TPU's scalar prefetch):
//    lane r of a warp loads the entry of the batch's row r, and shuffles
//    hand it to the other lanes — one load per batch;
//  * each warp loads a whole batch of K and V rows before using any
//    (kRows rows in flight); lane i owns head dims [i*DPL, i*DPL + DPL),
//    so a row is one vector load per lane and the warp reads it whole in
//    one coalesced instruction; every load is unconditional at a valid
//    address (rows past the end read the garbage block) and masked after,
//    so no branch sits between the loads; K/V are upcast to f32 in
//    registers;
//  * each warp keeps its own online-softmax state (running max m,
//    denominator l, accumulator acc, all f32, in registers) with no
//    barrier inside the loop; at the end the warps' states are merged
//    through shared memory, rescaling each by exp(m_w - max_w m_w).
// The kernel allocates nothing: the caller passes the output buffer.
//
// int8 pages (`paged_attention_quant_fwd`) replace the TPU kernel
// `paged_attention_quant_lanes` / `_paged_quant_kernel` in the same file of
// the JAX package, and compute repro_torch.kernels.ref.
// paged_attention_quant_ref: each K/V value is int8 * scale[row, kv_head]
// (f32 per-row scales of shape (P, bs, nkv)).  The same kernel body runs
// with TKV = int8_t: a lane's DPL dims of a row are one DPL-byte load (4 B
// at head_dim 128, so a warp still reads a row whole in one coalesced
// 128-B access), the row's two scales are loaded by the lane that loads
// its table entry and broadcast by shuffles, and every value is
// dequantized in registers before use — no f32 copy of the cache exists.
// A row costs hd + 4 bytes of K (and of V) against 2 * hd in bf16, so the
// byte floor at the same lengths is (hd + 4) / (2 * hd) of bf16's.

#include "paged_attention.cuh"

// dtype codes: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const void* tables,
                                   const void* lengths, void* out, int n,
                                   int nh, int nkv, int hd, int bs,
                                   int n_table, int window, int q_dtype,
                                   int kv_dtype, void* stream) {
  const int32_t* t = static_cast<const int32_t*>(tables);
  const int32_t* l = static_cast<const int32_t*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_paged_attention<float, float, float>(
        q, k_pages, v_pages, nullptr, nullptr, t, l, out, n, nh, nkv, hd, bs,
        n_table, window, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_paged_attention<bf16, bf16, bf16>(
        q, k_pages, v_pages, nullptr, nullptr, t, l, out, n, nh, nkv, hd, bs,
        n_table, window, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_paged_attention<float, bf16, float>(
        q, k_pages, v_pages, nullptr, nullptr, t, l, out, n, nh, nkv, hd, bs,
        n_table, window, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_paged_attention<bf16, float, bf16>(
        q, k_pages, v_pages, nullptr, nullptr, t, l, out, n, nh, nkv, hd, bs,
        n_table, window, s);
  return (int)cudaErrorInvalidValue;
}

// int8 pages with f32 per-row scales (P, bs, nkv); q_dtype as above.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_attention_quant_fwd(const void* q, const void* k_pages,
                                         const void* v_pages,
                                         const void* k_scales,
                                         const void* v_scales,
                                         const void* tables,
                                         const void* lengths, void* out,
                                         int n, int nh, int nkv, int hd,
                                         int bs, int n_table, int window,
                                         int q_dtype, void* stream) {
  const int32_t* t = static_cast<const int32_t*>(tables);
  const int32_t* l = static_cast<const int32_t*>(lengths);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_paged_attention<float, int8_t, float>(
        q, k_pages, v_pages, ks, vs, t, l, out, n, nh, nkv, hd, bs, n_table,
        window, s);
  if (q_dtype == 1)
    return launch_paged_attention<__nv_bfloat16, int8_t, __nv_bfloat16>(
        q, k_pages, v_pages, ks, vs, t, l, out, n, nh, nkv, hd, bs, n_table,
        window, s);
  return (int)cudaErrorInvalidValue;
}
