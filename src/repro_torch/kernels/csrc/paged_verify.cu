// Multi-query paged attention for speculative-decode verify, read through
// per-lane block tables, written for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_verify_lanes` / `_verify_kernel` in
// src/repro/kernels/paged_verify.py.  Computes what
// repro_torch.kernels.ref.paged_verify_ref defines: each lane carries k
// query positions; query i sits at logical row lengths[lane] + i (its own
// K/V row is already written) and attends the rows [0, lengths + i]
// (inclusive), inside the window when there is one.  For each (lane, KV
// head) the k * groups query rows (groups = nh / nkv) share the KV head's
// rows, as the TPU kernel's flattened (k * groups) row axis does; K/V row
// `row` lives in physical block tables[lane, row / bs] at offset row % bs;
// scores are q.k * 1/sqrt(hd) in f32, the softmax is online in f32, and
// the output is cast to q's dtype.
//
// What bounds it on an H100: the bytes.  A launch reads each lane's K/V
// rows [lo, lengths + k) once (2 * nkv * hd * itemsize bytes a row) and
// does ~4 * k * groups flops per element read, far below the card's ~295
// flop/byte ridge at k <= 8, so the floor is those bytes over 3.35 TB/s.
//
// Design (simple first):
//  * one CUDA block of 8 warps per (kv_head, lane), as the decode kernel
//    (paged_attention.cu): the TPU grid's (lane, kv_head) axes become
//    blockIdx.y / blockIdx.x, and its sequential logical-block axis a loop
//    over tiles of `tile` rows inside the block;
//  * every K/V row is read from device memory ONCE per block: the whole
//    block copies a tile of K and V rows into shared memory (16-byte
//    vector loads, all table loads of the tile issued before any page
//    load, every load unconditional at a valid address — rows past the
//    end read the garbage block 0 and are never scored), then every query
//    row is scored against the tile from shared memory;
//  * query rows are split across the warps (warp w owns rows w, w + 8, ...,
//    at most 8 each, so k * groups <= 64): each warp keeps its rows'
//    online-softmax state (running max m, denominator l, accumulator acc,
//    all f32) in registers, and lane i owns head dims [i*DPL, i*DPL+DPL);
//    a row's state never leaves its warp, so no merge is needed at the end
//    and shared memory holds only the two tiles (<= 32 KB, under the
//    48 KB a launch gets without opting in);
//  * each query row has its own inclusive limit lengths + row / groups
//    (and window start); a warp scores its row against the tile's rows
//    inside that range only, 8 rows at a time.
// The kernel allocates nothing: the caller passes the output buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;          // query rows one warp owns
constexpr int kMaxRows = kWarps * kRowsPerWarp;
constexpr int kBatch = 8;                // tile rows scored together
constexpr int kFill = 4;                 // 16-B vectors a thread copies
constexpr int kTileBytes = kFill * kThreads * 16;   // one K (or V) tile
constexpr float kNegInf = -1e30f;        // the TPU kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

template <typename T, int DPL>
struct alignas(sizeof(T) * DPL) Vec {
  T v[DPL];
};

template <typename T, int DPL>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[DPL]) {
  const Vec<T, DPL> x = *reinterpret_cast<const Vec<T, DPL>*>(p);
#pragma unroll
  for (int j = 0; j < DPL; ++j) out[j] = to_f32(x.v[j]);
}

// DPL: head dimensions per lane (head_dim <= 32 * DPL, a multiple of DPL);
// tile: K/V rows per shared-memory tile (tile * hd * sizeof(TKV) <=
// kTileBytes).
template <typename TQ, typename TKV, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const TQ* __restrict__ q,             // (n, k, nh, hd)
                    const TKV* __restrict__ k_pages,      // (P, bs, nkv, hd)
                    const TKV* __restrict__ v_pages,      // (P, bs, nkv, hd)
                    const int32_t* __restrict__ tables,   // (n, n_table)
                    const int32_t* __restrict__ lengths,  // (n,)
                    TQ* __restrict__ out,                 // (n, k, nh, hd)
                    int kq, int nkv, int hd, int bs, int n_table, int groups,
                    int window, int tile, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TKV* sk = reinterpret_cast<TKV*>(smem_raw);
  TKV* sv = sk + (size_t)tile * hd;
  const int kvh = blockIdx.x;
  const int seq = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nh = nkv * groups;
  const int rows = kq * groups;

  const int length = lengths[seq];
  // rows [lo, hi) of the lane that some query row attends
  const int hi = min(length + kq, n_table * bs);
  const int lo = window > 0 ? max(0, length - window + 1) : 0;

  const bool lane_on = lane * DPL < hd;     // lanes past head_dim idle
  const int dim0 = lane_on ? lane * DPL : 0;
  float qr[kRowsPerWarp][DPL];
  float acc[kRowsPerWarp][DPL];
  float m[kRowsPerWarp], l[kRowsPerWarp];
  int r_lo[kRowsPerWarp], r_hi[kRowsPerWarp];   // row range [r_lo, r_hi]
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    const int i = r / groups;               // query position of the row
    const int head = kvh * groups + (r - i * groups);
    const TQ* q_row = q + (((size_t)seq * kq + i) * nh + head) * hd + dim0;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      qr[rr][j] = (r < rows && lane_on) ? to_f32(q_row[j]) : 0.f;
      acc[rr][j] = 0.f;
    }
    m[rr] = kNegInf;
    l[rr] = 0.f;
    r_hi[rr] = length + i;
    r_lo[rr] = window > 0 ? max(0, length + i - window + 1) : 0;
  }

  const int32_t* table = tables + (size_t)seq * n_table;
  const size_t row_stride = (size_t)nkv * hd;        // elements per page row
  const size_t head_off = (size_t)kvh * hd;
  constexpr int kVec = 16 / sizeof(TKV);             // elements per vector
  const int vecs_per_row = hd / kVec;
  const int tile_vecs = tile * vecs_per_row;

  for (int base = lo; base < hi; base += tile) {
    __syncthreads();                  // every warp is done with the last tile
    // copy rows [base, base + tile) of this KV head into shared memory:
    // all table loads first, then all page loads, then the stores
    size_t off[kFill];
#pragma unroll
    for (int f = 0; f < kFill; ++f) {
      const int e = threadIdx.x + f * kThreads;
      const int r = e / vecs_per_row;
      const int row = base + r;
      const int phys = (e < tile_vecs && row < hi) ? table[row / bs] : 0;
      off[f] = ((size_t)phys * bs + row % bs) * row_stride + head_off +
               (size_t)(e - r * vecs_per_row) * kVec;
    }
    uint4 kx[kFill], vx[kFill];
#pragma unroll
    for (int f = 0; f < kFill; ++f) {
      if (threadIdx.x + f * kThreads < tile_vecs) {
        kx[f] = *reinterpret_cast<const uint4*>(k_pages + off[f]);
        vx[f] = *reinterpret_cast<const uint4*>(v_pages + off[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kFill; ++f) {
      const int e = threadIdx.x + f * kThreads;
      if (e < tile_vecs) {
        reinterpret_cast<uint4*>(sk)[e] = kx[f];
        reinterpret_cast<uint4*>(sv)[e] = vx[f];
      }
    }
    __syncthreads();
    const int n_here = min(tile, hi - base);

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      if (warp + rr * kWarps < rows) {          // uniform across the warp
        // tile rows this query row attends: [j0, j1)
        const int j0 = max(r_lo[rr] - base, 0);
        const int j1 = min(r_hi[rr] - base + 1, n_here);
        for (int jb = j0; jb < j1; jb += kBatch) {
          float s[kBatch];
          float m_new = m[rr];
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            const int j = jb + b < j1 ? jb + b : j0;   // stay on a real row
            float kf[DPL];
            load_f32<TKV, DPL>(sk + (size_t)j * hd + dim0, kf);
            float t = 0.f;
#pragma unroll
            for (int d = 0; d < DPL; ++d) t += qr[rr][d] * kf[d];
            s[b] = warp_sum(t) * scale;
            if (jb + b < j1) m_new = fmaxf(m_new, s[b]);
          }
          const float alpha = expf(m[rr] - m_new);
          float psum = 0.f;
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[rr][d] *= alpha;
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            if (jb + b < j1) {
              const float p = expf(s[b] - m_new);
              float vf[DPL];
              load_f32<TKV, DPL>(sv + (size_t)(jb + b) * hd + dim0, vf);
              psum += p;
#pragma unroll
              for (int d = 0; d < DPL; ++d) acc[rr][d] += p * vf[d];
            }
          }
          l[rr] = l[rr] * alpha + psum;
          m[rr] = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r < rows && lane_on) {
      const int i = r / groups;
      const int head = kvh * groups + (r - i * groups);
      TQ* o_row = out + (((size_t)seq * kq + i) * nh + head) * hd + dim0;
      const float den = fmaxf(l[rr], 1e-30f);
#pragma unroll
      for (int d = 0; d < DPL; ++d) o_row[d] = from_f32<TQ>(acc[rr][d] / den);
    }
  }
}

template <typename TKV>
int tile_rows(int hd) {
  int t = kTileBytes / (hd * (int)sizeof(TKV));
  t = t > 64 ? 64 : t;
  return t - t % 8;
}

template <typename TQ, typename TKV, int DPL>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int32_t* tables, const int32_t* lengths, void* out,
                   int n, int kq, int nh, int nkv, int hd, int bs,
                   int n_table, int window, cudaStream_t stream) {
  const int groups = nh / nkv;
  const int tile = tile_rows<TKV>(hd);
  if (tile < 8 || hd % DPL != 0) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)tile * hd * sizeof(TKV);
  const dim3 grid(nkv, n);
  paged_verify_kernel<TQ, TKV, DPL><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), tables, lengths,
      static_cast<TQ*>(out), kq, nkv, hd, bs, n_table, groups, window, tile,
      1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch(const void* q, const void* k_pages, const void* v_pages,
                     const int32_t* tables, const int32_t* lengths, void* out,
                     int n, int kq, int nh, int nkv, int hd, int bs,
                     int n_table, int window, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TKV);
  if (nkv < 1 || nh % nkv != 0 || kq < 1 || kq * (nh / nkv) > kMaxRows ||
      hd < 1 || hd % kVec != 0)
    return cudaErrorInvalidValue;
  if (hd <= 32)
    return launch<TQ, TKV, 1>(q, k_pages, v_pages, tables, lengths, out, n,
                              kq, nh, nkv, hd, bs, n_table, window, stream);
  if (hd <= 64)
    return launch<TQ, TKV, 2>(q, k_pages, v_pages, tables, lengths, out, n,
                              kq, nh, nkv, hd, bs, n_table, window, stream);
  if (hd <= 128)
    return launch<TQ, TKV, 4>(q, k_pages, v_pages, tables, lengths, out, n,
                              kq, nh, nkv, hd, bs, n_table, window, stream);
  if (hd <= 256)
    return launch<TQ, TKV, 8>(q, k_pages, v_pages, tables, lengths, out, n,
                              kq, nh, nkv, hd, bs, n_table, window, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// lengths: rows committed before the round (query i attends through row
// lengths + i).  Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_verify_fwd(const void* q, const void* k_pages,
                                const void* v_pages, const void* tables,
                                const void* lengths, void* out, int n, int kq,
                                int nh, int nkv, int hd, int bs, int n_table,
                                int window, int q_dtype, int kv_dtype,
                                void* stream) {
  const int32_t* t = static_cast<const int32_t*>(tables);
  const int32_t* l = static_cast<const int32_t*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return dispatch<float, float>(q, k_pages, v_pages, t, l, out, n, kq, nh,
                                  nkv, hd, bs, n_table, window, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, t, l, out, n, kq, nh, nkv, hd, bs, n_table,
        window, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return dispatch<float, __nv_bfloat16>(q, k_pages, v_pages, t, l, out, n,
                                          kq, nh, nkv, hd, bs, n_table,
                                          window, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return dispatch<__nv_bfloat16, float>(q, k_pages, v_pages, t, l, out, n,
                                          kq, nh, nkv, hd, bs, n_table,
                                          window, s);
  return (int)cudaErrorInvalidValue;
}
