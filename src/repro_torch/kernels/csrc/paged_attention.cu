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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroups = 8;            // query heads per KV head
constexpr float kNegInf = -1e30f;        // the TPU kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

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

// DPL: head dimensions per lane (head_dim <= 32 * DPL, a multiple of DPL);
// lane i holds dims [i*DPL, i*DPL + DPL).  kRows: rows per warp batch.
// TKV = int8_t reads k/v_scales (P, bs, nkv); other types ignore them.
template <typename TQ, typename TKV, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q,             // (n, nh, hd)
                       const TKV* __restrict__ k_pages,      // (P, bs, nkv, hd)
                       const TKV* __restrict__ v_pages,      // (P, bs, nkv, hd)
                       const float* __restrict__ k_scales,   // (P, bs, nkv)
                       const float* __restrict__ v_scales,   // (P, bs, nkv)
                       const int32_t* __restrict__ tables,   // (n, n_table)
                       const int32_t* __restrict__ lengths,  // (n,)
                       TQ* __restrict__ out,                 // (n, nh, hd)
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
  TQ* o_seq = out + ((size_t)seq * nh + (size_t)kvh * groups) * hd;
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
    o_seq[e] = from_f32<TQ>(num / fmaxf(den, 1e-30f));
  }
}

template <typename TQ, typename TKV, int DPL>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const float* k_scales, const float* v_scales,
                   const int32_t* tables, const int32_t* lengths, void* out,
                   int n, int nh, int nkv, int hd, int bs, int n_table,
                   int window, cudaStream_t stream) {
  const int groups = nh / nkv;
  const size_t smem = sizeof(float) * (size_t)kWarps * groups * (hd + 2);
  const dim3 grid(nkv, n);
  paged_attention_kernel<TQ, TKV, DPL><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), k_scales, v_scales, tables, lengths,
      static_cast<TQ*>(out), nkv, hd, bs, n_table, groups, window,
      1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch(const void* q, const void* k_pages, const void* v_pages,
                     const float* k_scales, const float* v_scales,
                     const int32_t* tables, const int32_t* lengths, void* out,
                     int n, int nh, int nkv, int hd, int bs, int n_table,
                     int window, cudaStream_t stream) {
  if (nkv < 1 || nh % nkv != 0 || nh / nkv > kMaxGroups || hd < 1 ||
      (hd > 32 && hd % (hd <= 64 ? 2 : hd <= 128 ? 4 : 8) != 0))
    return cudaErrorInvalidValue;
  if (hd <= 32)
    return launch<TQ, TKV, 1>(q, k_pages, v_pages, k_scales, v_scales,
                              tables, lengths, out, n, nh, nkv, hd, bs,
                              n_table, window, stream);
  if (hd <= 64)
    return launch<TQ, TKV, 2>(q, k_pages, v_pages, k_scales, v_scales,
                              tables, lengths, out, n, nh, nkv, hd, bs,
                              n_table, window, stream);
  if (hd <= 128)
    return launch<TQ, TKV, 4>(q, k_pages, v_pages, k_scales, v_scales,
                              tables, lengths, out, n, nh, nkv, hd, bs,
                              n_table, window, stream);
  if (hd <= 256)
    return launch<TQ, TKV, 8>(q, k_pages, v_pages, k_scales, v_scales,
                              tables, lengths, out, n, nh, nkv, hd, bs,
                              n_table, window, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

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
  if (q_dtype == 0 && kv_dtype == 0)
    return dispatch<float, float>(q, k_pages, v_pages, nullptr, nullptr, t, l,
                                  out, n, nh, nkv, hd, bs, n_table, window,
                                  s);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, t, l, out, n, nh, nkv, hd, bs,
        n_table, window, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return dispatch<float, __nv_bfloat16>(q, k_pages, v_pages, nullptr,
                                          nullptr, t, l, out, n, nh, nkv, hd,
                                          bs, n_table, window, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return dispatch<__nv_bfloat16, float>(q, k_pages, v_pages, nullptr,
                                          nullptr, t, l, out, n, nh, nkv, hd,
                                          bs, n_table, window, s);
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
    return dispatch<float, int8_t>(q, k_pages, v_pages, ks, vs, t, l, out, n,
                                   nh, nkv, hd, bs, n_table, window, s);
  if (q_dtype == 1)
    return dispatch<__nv_bfloat16, int8_t>(q, k_pages, v_pages, ks, vs, t, l,
                                           out, n, nh, nkv, hd, bs, n_table,
                                           window, s);
  return (int)cudaErrorInvalidValue;
}
