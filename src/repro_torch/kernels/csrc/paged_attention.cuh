// The attention phase of the fused decode layer (fused_decode.cu): paged
// attention for one decode token per lane, one CUDA block per (kv_head,
// lane).  It computes what paged_attention.cu's split-KV kernels compute
// (the same reference, ref.paged_attention_ref, with an f32 output here),
// in the design the decode entry points ran before they were split; the
// fused layer's redesign is to take over the split-KV attention.
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
//    registers (int8 values times their row's scale);
//  * each warp keeps its own online-softmax state (running max m,
//    denominator l, accumulator acc, all f32, in registers) with no
//    barrier inside the loop; at the end the warps' states are merged
//    through shared memory, rescaling each by exp(m_w - max_w m_w).
// What holds it back: 64 blocks at 8 lanes x 8 KV heads leave half the
// SMs idle while the longest lane's chain of load batches sets the time,
// and each (row, query head) pays a 5-shuffle warp sum.

#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroups = 8;            // query heads per KV head
constexpr float kNegInf = -1e30f;        // the TPU kernel's mask value

// DPL contiguous elements of a row as f32, in one vector load when the
// width allows it (8 or 16 bytes), else element by element.
template <typename T, int DPL>
struct alignas(sizeof(T) * DPL) Vec {
  T v[DPL];
};

template <typename T, int DPL>
__device__ __forceinline__ void load_f32(const T* __restrict__ p,
                                         float (&out)[DPL]) {
  const Vec<T, DPL> x = *reinterpret_cast<const Vec<T, DPL>*>(p);
#pragma unroll
  for (int j = 0; j < DPL; ++j) out[j] = to_f32(x.v[j]);
}

// TO: the output's type (TQ for the decode kernel; float for the fused
// decode layer, which keeps the attention row in f32).
// DPL: head dimensions per lane (head_dim <= 32 * DPL, a multiple of DPL);
// lane i holds dims [i*DPL, i*DPL + DPL).  kRows: rows per warp batch.
// TKV = int8_t reads k/v_scales (P, bs, nkv); other types ignore them.
template <typename TQ, typename TKV, typename TO, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q,             // (n, nh, hd)
                       const TKV* __restrict__ k_pages,      // (P, bs, nkv, hd)
                       const TKV* __restrict__ v_pages,      // (P, bs, nkv, hd)
                       const float* __restrict__ k_scales,   // (P, bs, nkv)
                       const float* __restrict__ v_scales,   // (P, bs, nkv)
                       const int32_t* __restrict__ tables,   // (n, n_table)
                       const int32_t* __restrict__ lengths,  // (n,)
                       TO* __restrict__ out,                 // (n, nh, hd)
                       int nkv, int hd, int bs, int n_table, int groups,
                       int window, float scale) {
  constexpr int kRows = DPL >= 8 ? 4 : 8;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  extern __shared__ float smem[];
  const int kvh = blockIdx.x;
  const int seq = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nh = nkv * groups;

  const int length = lengths[seq];
  const int hi = min(length, n_table * bs);          // rows [lo, hi) attend
  const int lo = window > 0 ? max(0, length - window) : 0;

  const TQ* q_seq = q + ((size_t)seq * nh + (size_t)kvh * groups) * hd;
  float qr[kMaxGroups][DPL];
  float acc[kMaxGroups][DPL];
  float m[kMaxGroups], l[kMaxGroups];
  const bool lane_on = lane * DPL < hd;     // lanes past head_dim idle
  const int dim0 = lane_on ? lane * DPL : 0;
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      qr[g][j] = (g < groups && lane_on) ? to_f32(q_seq[g * hd + dim0 + j])
                                          : 0.f;
      acc[g][j] = 0.f;
    }
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  const int32_t* table = tables + (size_t)seq * n_table;
  const size_t row_stride = (size_t)nkv * hd;        // elements per page row
  const size_t head_off = (size_t)kvh * hd;

  for (int base = lo + warp * kRows; base < hi; base += kWarps * kRows) {
    float kf[kRows][DPL], vf[kRows][DPL];
    bool valid[kRows];
    // lane r < kRows fetches row base+r's physical block (garbage block 0
    // past the end); shuffles broadcast it
    const int my_row = base + (lane < kRows ? lane : 0);
    const int my_phys = my_row < hi ? table[my_row / bs] : 0;
    float my_ks = 1.f, my_vs = 1.f;       // this lane's row scales (int8)
    if constexpr (kQuant) {
      const size_t srow = ((size_t)my_phys * bs + my_row % bs) * nkv + kvh;
      my_ks = k_scales[srow];
      my_vs = v_scales[srow];
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = base + r;
      valid[r] = row < hi;
      const int phys = __shfl_sync(0xffffffffu, my_phys, r);
      const size_t off = ((size_t)phys * bs + row % bs) * row_stride +
                         head_off + dim0;
      load_f32<TKV, DPL>(k_pages + off, kf[r]);
      load_f32<TKV, DPL>(v_pages + off, vf[r]);
      if constexpr (kQuant) {             // dequantize in registers
        const float ks = __shfl_sync(0xffffffffu, my_ks, r);
        const float vs = __shfl_sync(0xffffffffu, my_vs, r);
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          kf[r][j] *= ks;
          vf[r][j] *= vs;
        }
      }
      if (!(valid[r] && lane_on)) {
#pragma unroll
        for (int j = 0; j < DPL; ++j) kf[r][j] = vf[r][j] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g < groups) {                   // uniform across the block
        float s[kRows];
        float m_new = m[g];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float t = 0.f;
#pragma unroll
          for (int j = 0; j < DPL; ++j) t += qr[g][j] * kf[r][j];
          s[r] = warp_sum(t) * scale;
          if (valid[r]) m_new = fmaxf(m_new, s[r]);
        }
        const float alpha = expf(m[g] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] *= alpha;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = valid[r] ? expf(s[r] - m_new) : 0.f;
          psum += p;
#pragma unroll
          for (int j = 0; j < DPL; ++j) acc[g][j] += p * vf[r][j];
        }
        l[g] = l[g] * alpha + psum;
        m[g] = m_new;
      }
    }
  }

  // merge the warps' states: m_s, l_s (kWarps * groups), o_s (.. * hd)
  float* m_s = smem;
  float* l_s = m_s + kWarps * groups;
  float* o_s = l_s + kWarps * groups;
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    if (g < groups) {
      const int slot = warp * groups + g;
      if (lane == 0) {
        m_s[slot] = m[g];
        l_s[slot] = l[g];
      }
      if (lane_on) {
#pragma unroll
        for (int j = 0; j < DPL; ++j)
          o_s[(size_t)slot * hd + dim0 + j] = acc[g][j];
      }
    }
  }
  __syncthreads();
  TO* o_seq = out + ((size_t)seq * nh + (size_t)kvh * groups) * hd;
  for (int e = threadIdx.x; e < groups * hd; e += kThreads) {
    const int g = e / hd;
    const int d = e - g * hd;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * groups + g]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const int slot = w * groups + g;
      const float c = expf(m_s[slot] - mx);
      den += l_s[slot] * c;
      num += o_s[(size_t)slot * hd + d] * c;
    }
    o_seq[e] = from_f32<TO>(num / fmaxf(den, 1e-30f));
  }
}

template <typename TQ, typename TKV, typename TO, int DPL>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const float* k_scales, const float* v_scales,
                   const int32_t* tables, const int32_t* lengths, void* out,
                   int n, int nh, int nkv, int hd, int bs, int n_table,
                   int window, cudaStream_t stream) {
  const int groups = nh / nkv;
  const size_t smem = sizeof(float) * (size_t)kWarps * groups * (hd + 2);
  const dim3 grid(nkv, n);
  paged_attention_kernel<TQ, TKV, TO, DPL><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), k_scales, v_scales, tables, lengths,
      static_cast<TO*>(out), nkv, hd, bs, n_table, groups, window,
      1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

// Launch the kernel for TQ queries over TKV pages into a TO output,
// choosing DPL from head_dim.  Returns the launch's cudaError_t.
template <typename TQ, typename TKV, typename TO>
cudaError_t launch_paged_attention(const void* q, const void* k_pages,
                                   const void* v_pages,
                                   const float* k_scales,
                                   const float* v_scales,
                                   const int32_t* tables,
                                   const int32_t* lengths, void* out, int n,
                                   int nh, int nkv, int hd, int bs,
                                   int n_table, int window,
                                   cudaStream_t stream) {
  if (nkv < 1 || nh % nkv != 0 || nh / nkv > kMaxGroups || hd < 1 ||
      (hd > 32 && hd % (hd <= 64 ? 2 : hd <= 128 ? 4 : 8) != 0))
    return cudaErrorInvalidValue;
  if (hd <= 32)
    return launch<TQ, TKV, TO, 1>(q, k_pages, v_pages, k_scales, v_scales,
                                  tables, lengths, out, n, nh, nkv, hd, bs,
                                  n_table, window, stream);
  if (hd <= 64)
    return launch<TQ, TKV, TO, 2>(q, k_pages, v_pages, k_scales, v_scales,
                                  tables, lengths, out, n, nh, nkv, hd, bs,
                                  n_table, window, stream);
  if (hd <= 128)
    return launch<TQ, TKV, TO, 4>(q, k_pages, v_pages, k_scales, v_scales,
                                  tables, lengths, out, n, nh, nkv, hd, bs,
                                  n_table, window, stream);
  if (hd <= 256)
    return launch<TQ, TKV, TO, 8>(q, k_pages, v_pages, k_scales, v_scales,
                                  tables, lengths, out, n, nh, nkv, hd, bs,
                                  n_table, window, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
