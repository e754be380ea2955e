// Multi-query paged attention for speculative-decode verify, read through
// per-lane block tables, written for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_verify_lanes` / `_verify_kernel` in
// src/repro/kernels/paged_verify.py:81.  Computes what
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
// What bounds it on an H100: the bytes.  A call reads each lane's K/V
// rows [lo, lengths + k) once (2 * nkv * hd * itemsize bytes a row) and
// does ~4 * k * groups flops per element read: at the main path's k *
// groups = 8 rows that is ~16 flops per byte, under the ~20 of the f32
// CUDA-core ridge (67 TFLOP/s over 3.35 TB/s), so the floor is those bytes
// over 3.35 TB/s.  The products stay f32 on the CUDA cores; tensor cores
// (mma.sync m16n8k16 with the <= 16 query rows as one A tile) are the next
// step for k = 8.
//
// Design: split-KV, lane-per-key, asynchronous page tiles.  One op call is
// two CUDA launches (the wrapper counts it once):
//  1. verify_split_kernel, grid (kv_head, lane, split): each split covers
//     kSplit = 256 logical rows of a lane.  The number of splits comes
//     from n_table * bs, which the host knows, never from `lengths`
//     (reading those on the host would sync the device once a layer).  A
//     block whose split holds none of its lane's rows writes an empty
//     partial (m = -1e30, l = 0) and exits, so a long lane is spread over
//     many SMs and a short one costs a few idle blocks;
//     - the split's table entries are read first, once, into shared
//       memory as the element offset of each of its page rows; then its
//       page tiles (64 rows, or 32 where 64 do not fit in shared memory)
//       stream through a 2-stage cp.async ring, tile t + 1 loading while
//       tile t is scored, each thread's (row, chunk) pairs stepped without
//       a division.  Every copy is at a valid address: rows past the split
//       read the garbage block 0 and are masked;
//     - the lane's k * groups query rows (<= 64) sit in shared memory as
//       f32.  Scoring is lane-per-key: lane j scores keys j and j + 32 of
//       the tile against its warp's rows (warp w owns rows w, w + 4, ...:
//       2, 4 or 16 a warp, the fewest that hold k * groups),
//       reading its K row as 16-byte vectors (rows padded by 16 bytes, so
//       the lanes hit distinct banks) and the query rows as broadcasts —
//       one max reduction per row per tile instead of a 5-shuffle sum per
//       (row, key); the row sums stay per lane until the end;
//     - p.v runs with lanes owning head dims, reading the warp's
//       probabilities of a key from shared memory;
//     - each query row keeps its own inclusive limit lengths + i and
//       window start;
//     - each split writes its (m, l, acc) for every query row to f32
//       scratch that the wrapper allocates;
//  2. verify_merge_kernel, grid (kv_head, lane): one warp per query row
//     merges the splits in split order (loads issued four splits ahead),
//     so the result is the same from run to run; an empty split's m is
//     -1e30, never -inf, so exp(m_s - M) cannot give NaN, and its acc,
//     never written, is selected away, never multiplied.
// The kernels allocate nothing: the caller passes the output and scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"      // cp.async helpers

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 64;             // k * groups
constexpr int kSplit = 256;              // logical rows per split
constexpr int kMergeWarps = 8;
constexpr float kNegInf = -1e30f;        // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (flushes results below 2^-126 to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[N]) {
  const Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = to_f32(x.v[j]);
}

struct Shape {
  int kq, nkv, hd, bs, n_table, groups, window, n_split, tile;
  float sl2;                     // 1/sqrt(hd) * log2(e): scores in log2 units
};

// shared memory of a split block: query rows f32, the element offset of
// each of the split's page rows, two stages of K (rows padded by 16 bytes)
// and V, probabilities
template <typename TKV>
__host__ __device__ constexpr size_t split_smem(int rows, int hd, int tile,
                                                int rpw) {
  return (size_t)rows * hd * 4 + kSplit * 8 +
         2 * (size_t)tile * (hd + 16 / sizeof(TKV)) * sizeof(TKV) +
         2 * (size_t)tile * hd * sizeof(TKV) +
         (size_t)kWarps * tile * rpw * 4;
}

// DPL: head dims per lane in p.v (hd <= 32 * DPL); RPW: query rows per
// warp (rows <= kWarps * RPW).  Keys per lane: tile / 32 (1 or 2).  q is
// read once, into shared memory, so its dtype is a flag, not a template
// parameter.
template <typename TKV, int DPL, int RPW>
__global__ void __launch_bounds__(kThreads)
verify_split_kernel(const void* __restrict__ q,           // (n, k, nh, hd)
                    int q_bf16,
                    const TKV* __restrict__ k_pages,      // (P, bs, nkv, hd)
                    const TKV* __restrict__ v_pages,      // (P, bs, nkv, hd)
                    const int32_t* __restrict__ tables,   // (n, n_table)
                    const int32_t* __restrict__ lengths,  // (n,)
                    float2* __restrict__ part_ml,         // (n, nkv, S, R)
                    float* __restrict__ part_acc,         // (n, nkv, S, R, hd)
                    Shape a) {
  constexpr int kVec = 16 / sizeof(TKV);   // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = a.hd;
  const int rows = a.kq * a.groups;
  const int tile = a.tile;
  const int kpl = tile / 32;               // keys per lane
  const int k_stride = hd + kVec;          // padded K row in shared memory
  long long* roff = reinterpret_cast<long long*>(smem_raw);
  float* qs = reinterpret_cast<float*>(roff + kSplit);
  TKV* ks = reinterpret_cast<TKV*>(qs + rows * hd);
  TKV* vs = ks + 2 * tile * k_stride;
  float* ps = reinterpret_cast<float*>(vs + 2 * tile * hd);

  const int kvh = blockIdx.x;
  const int seq = blockIdx.y;
  const int split = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nh = a.nkv * a.groups;

  const int length = lengths[seq];
  const int hi = min(length + a.kq, a.n_table * a.bs);
  const int lo = a.window > 0 ? max(0, length - a.window + 1) : 0;
  const int s_lo = max(lo, split * kSplit);
  const int s_hi = min(hi, (split + 1) * kSplit);
  const size_t pbase =
      (((size_t)seq * a.nkv + kvh) * a.n_split + split) * rows;
  if (s_lo >= s_hi) {                      // none of the lane's rows here
    for (int r = threadIdx.x; r < rows; r += kThreads)
      part_ml[pbase + r] = make_float2(kNegInf, 0.f);
    return;
  }

  // the split's table entries, read once, as the element offset of each
  // page row of this KV head; and the query rows (f32)
  const size_t row_elems = (size_t)a.nkv * hd;       // a page row
  const size_t head_off = (size_t)kvh * hd;
  const int32_t* table = tables + (size_t)seq * a.n_table;
  for (int r = threadIdx.x; r < s_hi - s_lo; r += kThreads) {
    const int row = s_lo + r;
    const int blk = row / a.bs;
    roff[r] = (long long)(((size_t)table[blk] * a.bs + (row - blk * a.bs)) *
                              row_elems + head_off);
  }
  for (int e = threadIdx.x; e < rows * hd; e += kThreads) {
    const int r = e / hd;
    const int i = r / a.groups;
    const int head = kvh * a.groups + (r - i * a.groups);
    const size_t at = (((size_t)seq * a.kq + i) * nh + head) * hd + e - r * hd;
    qs[e] = q_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(q)[at])
                   : static_cast<const float*>(q)[at];
  }
  __syncthreads();

  // copy rows [base, base + tile) into stage st, 16 bytes a copy; rows
  // past the split read the garbage block 0 (row 0) and are masked.  A
  // thread's (row, chunk) pairs advance by a fixed step: no division
  const int vecs = hd / kVec;
  const int r_first = threadIdx.x / vecs;
  const int c_first = threadIdx.x - r_first * vecs;
  const int dr = kThreads / vecs, dc = kThreads - dr * vecs;
  auto load = [&](int base, int st) {
    int r = r_first, c = c_first;
    for (int e = threadIdx.x; e < tile * vecs; e += kThreads) {
      const int rel = base - s_lo + r;
      const long long off =
          (rel < s_hi - s_lo ? roff[rel] : (long long)head_off) + c * kVec;
      cp_async16(smem_u32(ks + (st * tile + r) * k_stride + c * kVec),
                 k_pages + off);
      cp_async16(smem_u32(vs + (st * tile + r) * hd + c * kVec),
                 v_pages + off);
      r += dr;
      c += dc;
      if (c >= vecs) {
        c -= vecs;
        ++r;
      }
    }
  };

  const bool lane_on = lane * DPL < hd;     // lanes past hd idle in p.v
  const int dim0 = lane_on ? lane * DPL : 0;
  float acc[RPW][DPL], m[RPW], lp[RPW];
  int r_hi[RPW], r_lo[RPW];                 // row range [r_lo, r_hi]
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int i = (warp + rr * kWarps) / a.groups;
    m[rr] = kNegInf;
    lp[rr] = 0.f;
    r_hi[rr] = length + i;
    r_lo[rr] = a.window > 0 ? length + i - a.window + 1 : 0;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[rr][d] = 0.f;
  }
  float* pw = ps + warp * tile * RPW;       // this warp's [key][row] probs

  const int n_tiles = (s_hi - s_lo + tile - 1) / tile;
  load(s_lo, 0);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int base = s_lo + t * tile;
    if (t + 1 < n_tiles) load(base + tile, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // scores of the warp's rows against keys lane and lane + 32
    float s[RPW][2];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) s[rr][0] = s[rr][1] = 0.f;
    const TKV* k_a = ks + (st * tile + lane) * k_stride;
    const TKV* k_b = ks + (st * tile + (kpl > 1 ? lane + 32 : lane)) * k_stride;
#pragma unroll 2
    for (int d = 0; d < hd; d += kVec) {
      float ka[kVec], kb[kVec];
      load_f32<TKV, kVec>(k_a + d, ka);
      load_f32<TKV, kVec>(k_b + d, kb);
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const int r = warp + rr * kWarps;
        if (r < rows) {                       // uniform across the warp
          const float* qrow = qs + r * hd + d;
#pragma unroll
          for (int j = 0; j < kVec; j += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qrow + j);
            s[rr][0] += qv.x * ka[j] + qv.y * ka[j + 1] + qv.z * ka[j + 2] +
                        qv.w * ka[j + 3];
            s[rr][1] += qv.x * kb[j] + qv.y * kb[j + 1] + qv.z * kb[j + 2] +
                        qv.w * kb[j + 3];
          }
        }
      }
    }

    // masks, online softmax, probabilities to shared memory
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      if (warp + rr * kWarps < rows) {
        float x[2];
        float mt = kNegInf;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kp = base + lane + 32 * c;
          const bool ok = c < kpl && kp < s_hi && kp <= r_hi[rr] &&
                          kp >= r_lo[rr];
          x[c] = ok ? s[rr][c] * a.sl2 : kNegInf;
          mt = fmaxf(mt, x[c]);
        }
        const float m_new = fmaxf(m[rr], warp_max(mt));
        // no visible key yet: subtract 0, so masked scores give 0
        const float mu = m_new == kNegInf ? 0.f : m_new;
        const float alpha = exp2_approx(m[rr] - mu);
        const float pa = exp2_approx(x[0] - mu);
        const float pb = exp2_approx(x[1] - mu);
        lp[rr] = lp[rr] * alpha + pa + pb;
        m[rr] = m_new;
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[rr][d] *= alpha;
        pw[lane * RPW + rr] = pa;
        if (kpl > 1) pw[(lane + 32) * RPW + rr] = pb;
      }
    }
    __syncwarp();

    // acc += p . v over the tile's rows
    const int n_here = min(tile, s_hi - base);
    const TKV* vt = vs + st * tile * hd + dim0;
    for (int j = 0; j < n_here; ++j) {
      float vv[DPL];
      load_f32<TKV, DPL>(vt + j * hd, vv);
#pragma unroll
      for (int r2 = 0; r2 < RPW; r2 += 2) {
        const float2 p2 = *reinterpret_cast<const float2*>(pw + j * RPW + r2);
#pragma unroll
        for (int d = 0; d < DPL; ++d) {
          acc[r2][d] += p2.x * vv[d];
          acc[r2 + 1][d] += p2.y * vv[d];
        }
      }
    }
    __syncthreads();                 // every warp is done with stage st
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp + rr * kWarps;
    if (r < rows) {
      const float l = warp_sum(lp[rr]);
      if (lane == 0) part_ml[pbase + r] = make_float2(m[rr], l);
      if (lane_on) {
        float* dst = part_acc + (pbase + r) * hd + dim0;
#pragma unroll
        for (int d = 0; d < DPL; ++d) dst[d] = acc[rr][d];
      }
    }
  }
}

// One warp per (lane, query row): merge the splits in split order.
template <typename TQ>
__global__ void __launch_bounds__(kMergeWarps * 32)
verify_merge_kernel(const float2* __restrict__ part_ml,
                    const float* __restrict__ part_acc,
                    TQ* __restrict__ out, Shape a) {
  const int kvh = blockIdx.x;
  const int seq = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rows = a.kq * a.groups;
  const int hd = a.hd;
  const int nh = a.nkv * a.groups;
  const size_t pb = ((size_t)seq * a.nkv + kvh) * a.n_split * rows;
  for (int r = warp; r < rows; r += kMergeWarps) {
    float big = kNegInf;
    for (int s = lane; s < a.n_split; s += 32)
      big = fmaxf(big, part_ml[pb + (size_t)s * rows + r].x);
    big = warp_max(big);
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    float den = 0.f;
    // four splits at a time, their loads issued before any is used; an
    // empty split (l = 0) adds nothing, and its acc, never written, is
    // selected away rather than multiplied by 0
    for (int s0 = 0; s0 < a.n_split; s0 += 4) {
      float2 ml[4];
      float v[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int s = min(s0 + u, a.n_split - 1);
        ml[u] = part_ml[pb + (size_t)s * rows + r];
        const float* src = part_acc + (pb + (size_t)s * rows + r) * hd;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v[u][k] = lane + 32 * k < hd ? src[lane + 32 * k] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (s0 + u < a.n_split && ml[u].y > 0.f) {   // uniform in the warp
          const float w = exp2_approx(ml[u].x - big);
          den += ml[u].y * w;
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] += v[u][k] * w;
        }
      }
    }
    const float inv = 1.f / fmaxf(den, 1e-30f);
    const int i = r / a.groups;
    const int head = kvh * a.groups + (r - i * a.groups);
    TQ* o_row = out + (((size_t)seq * a.kq + i) * nh + head) * hd;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (lane + 32 * k < hd) o_row[lane + 32 * k] = from_f32<TQ>(acc[k] * inv);
  }
}

template <typename TQ, typename TKV, int DPL, int RPW>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int32_t* tables, const int32_t* lengths, void* out,
                   void* part_ml, void* part_acc, int n, Shape a,
                   cudaStream_t stream) {
  const int rows = a.kq * a.groups;
  size_t smem = split_smem<TKV>(rows, a.hd, 64, RPW);
  a.tile = 64;
  if (smem > 227 * 1024) {
    a.tile = 32;
    smem = split_smem<TKV>(rows, a.hd, 32, RPW);
  }
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      verify_split_kernel<TKV, DPL, RPW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.nkv, n, a.n_split);
  verify_split_kernel<TKV, DPL, RPW><<<grid, kThreads, smem, stream>>>(
      q, sizeof(TQ) == 2, static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), tables, lengths,
      static_cast<float2*>(part_ml), static_cast<float*>(part_acc), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  verify_merge_kernel<TQ><<<dim3(a.nkv, n), kMergeWarps * 32, 0, stream>>>(
      static_cast<const float2*>(part_ml),
      static_cast<const float*>(part_acc), static_cast<TQ*>(out), a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int DPL>
cudaError_t by_rows(const void* q, const void* k_pages, const void* v_pages,
                    const int32_t* tables, const int32_t* lengths, void* out,
                    void* part_ml, void* part_acc, int n, const Shape& a,
                    cudaStream_t stream) {
  if (a.kq * a.groups <= kWarps * 2)
    return launch<TQ, TKV, DPL, 2>(q, k_pages, v_pages, tables, lengths, out,
                                   part_ml, part_acc, n, a, stream);
  if (a.kq * a.groups <= kWarps * 4)
    return launch<TQ, TKV, DPL, 4>(q, k_pages, v_pages, tables, lengths, out,
                                   part_ml, part_acc, n, a, stream);
  return launch<TQ, TKV, DPL, 16>(q, k_pages, v_pages, tables, lengths, out,
                                  part_ml, part_acc, n, a, stream);
}

template <typename TQ, typename TKV>
cudaError_t dispatch(const void* q, const void* k_pages, const void* v_pages,
                     const int32_t* tables, const int32_t* lengths, void* out,
                     void* part_ml, void* part_acc, int n, const Shape& a,
                     cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TKV);
  if (a.nkv < 1 || a.kq < 1 || a.groups < 1 ||
      a.kq * a.groups > kMaxRows || a.hd < 1 || a.hd % kVec != 0 ||
      a.bs < 1 || a.n_table < 0)
    return cudaErrorInvalidValue;
  if (a.hd <= 32)
    return by_rows<TQ, TKV, 1>(q, k_pages, v_pages, tables, lengths, out,
                               part_ml, part_acc, n, a, stream);
  if (a.hd <= 64)
    return by_rows<TQ, TKV, 2>(q, k_pages, v_pages, tables, lengths, out,
                               part_ml, part_acc, n, a, stream);
  if (a.hd <= 128)
    return by_rows<TQ, TKV, 4>(q, k_pages, v_pages, tables, lengths, out,
                               part_ml, part_acc, n, a, stream);
  if (a.hd <= 256)
    return by_rows<TQ, TKV, 8>(q, k_pages, v_pages, tables, lengths, out,
                               part_ml, part_acc, n, a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Number of splits a call with this table needs (the scratch's third axis;
// at least one, so an empty table still launches and writes zeros).
extern "C" int paged_verify_splits(int n_table, int bs) {
  return n_table * bs > 0 ? (n_table * bs + kSplit - 1) / kSplit : 1;
}

// dtype codes: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// lengths: rows committed before the round (query i attends through row
// lengths + i).  part_ml: n * nkv * splits * k * groups float2; part_acc:
// that many rows of hd floats (splits from paged_verify_splits).  Two
// launches (split, merge); returns the first failing cudaError_t (0 on
// success).
extern "C" int paged_verify_fwd(const void* q, const void* k_pages,
                                const void* v_pages, const void* tables,
                                const void* lengths, void* out,
                                void* part_ml, void* part_acc, int n, int kq,
                                int nh, int nkv, int hd, int bs, int n_table,
                                int window, int q_dtype, int kv_dtype,
                                void* stream) {
  const int32_t* t = static_cast<const int32_t*>(tables);
  const int32_t* l = static_cast<const int32_t*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nkv < 1 || nh % nkv != 0) return (int)cudaErrorInvalidValue;
  Shape a;
  a.kq = kq;
  a.nkv = nkv;
  a.hd = hd;
  a.bs = bs;
  a.n_table = n_table;
  a.groups = nh / nkv;
  a.window = window;
  a.n_split = paged_verify_splits(n_table, bs);
  a.tile = 64;
  a.sl2 = kLog2e / sqrtf((float)hd);
  if (q_dtype == 0 && kv_dtype == 0)
    return dispatch<float, float>(q, k_pages, v_pages, t, l, out, part_ml,
                                  part_acc, n, a, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, t, l, out, part_ml, part_acc, n, a, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return dispatch<float, __nv_bfloat16>(q, k_pages, v_pages, t, l, out,
                                          part_ml, part_acc, n, a, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return dispatch<__nv_bfloat16, float>(q, k_pages, v_pages, t, l, out,
                                          part_ml, part_acc, n, a, s);
  return (int)cudaErrorInvalidValue;
}
