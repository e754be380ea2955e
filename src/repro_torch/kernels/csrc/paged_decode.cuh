// Paged attention for one decode token per lane, read through per-lane
// block tables, written for Hopper (sm_90a): the split-KV kernel and its
// launch, shared by the decode entry points of paged_attention.cu and the
// attention phase of the fused decode layer (fused_decode.cu), whose merge
// writes f32 rows (the merge's output type is a template parameter).
//
// Replaces the TPU kernels `paged_attention_lanes` / `_paged_kernel` and
// `paged_attention_quant_lanes` / `_paged_quant_kernel` in
// src/repro/kernels/paged_attention.py.  Computes what
// repro_torch.kernels.ref.paged_attention_ref (fp pages) and
// paged_attention_quant_ref (int8 pages, each value int8 * scale[row,
// kv_head], f32 scales of shape (P, bs, nkv)) define: for each lane and KV
// head, the `groups = nh / nkv` query heads attend over the logical rows
// [max(0, length - window), length); K/V row `row` lives in physical block
// tables[lane, row / bs] at offset row % bs; scores are q.k * 1/sqrt(hd)
// in f32; the softmax is online in f32; the output is cast to q's dtype.
//
// What bounds it on an H100: the bytes.  A call reads each lane's
// attended K/V rows once (2 * nkv * hd * itemsize bytes a row, plus two
// f32 scales a row and KV head for int8) and does ~4 * groups flops per
// element read — 8 at qwen3-0.6b's 2 query heads per KV head, 48 at
// command-r-plus-104b's 12: per byte of bf16 pages that is 4 and 24, at
// or under the f32 CUDA-core ridge (~20 flops a byte at 67 TFLOP/s), so
// the floor is those bytes over 3.35 TB/s.  The products stay f32 on the
// CUDA cores: at <= 16 query rows a key, tensor cores would not help.
//
// What held the earlier one-block-per-(KV head, lane) design back: 8 x 8
// = 64 blocks at
// the serve inputs left 68 of the 132 SMs idle, and a block walked its
// lane's rows as a chain of dependent load batches, so the longest lane's
// memory latency set the time; each (row, query head) also paid a
// 5-shuffle warp sum.
//
// Design: split-KV, scoring a row per pair of lanes, asynchronous page
// tiles (the verify kernel's design, paged_verify.cu, at one query row
// per head).  One op call is two CUDA launches (the wrapper counts it
// once):
//  1. decode_split_kernel, grid (kv_head, lane, split), 4 warps a block:
//     each split covers kSplit = 128 logical rows of a lane.  The number
//     of splits comes from n_table * bs, which the host knows, never from
//     `lengths` (reading those on the host would sync the device once a
//     layer).  128 rows, because at the serve inputs (8 lanes of 88 to
//     890 rows, 58-block tables of 16 rows, 8 KV heads) that gives 200
//     working blocks of at most 64 KB each: more than one wave on 132
//     SMs, with every SM's share of the 11 MB in flight at once; 256-row
//     splits would give 128 blocks, under one wave, and 64-row splits
//     measured slower over bf16 pages (PERF.md §6).  A split that
//     holds none of its lane's rows, or lies wholly before the window
//     start, writes an empty partial (m = -1e30, l = 0) and exits;
//     - the block issues its lane's length, the table entries of its rows
//       (each lane reads the entry of the row it will score, once) and the
//       lane's query rows at once, so the table read does not wait for the
//       length; the query rows go to shared memory as f32;
//     - page tiles of 64 rows (16 a warp) then stream through a 2-stage
//       cp.async ring, tile t + 1 loading while tile t is scored (both
//       tiles of a 128-row split are in flight from the start).  Where two
//       stages would leave no room for a second block on the SM (f32 pages
//       at head_dim > 64, bf16 at > 128) the ring has one stage: with two,
//       f32 at head_dim 128 fit one block an SM and lost to the
//       one-block-per-lane kernel on 32 lanes.  A warp copies and reads
//       only its own rows of a tile, so the ring needs no block barrier,
//       only __syncwarp.  A lane computes its row's element offset, and the
//       warp's 16-byte copies take the offsets by shuffle.  Every copy is
//       at a valid address: rows outside the split, the lane or the window
//       read the garbage block 0 and are masked after the load, never by a
//       branch before it.  int8 tiles carry their rows' two f32 scales
//       (4-byte copies);
//     - scoring takes kLanesPerKey = 2 lanes a row: each lane dots its
//       half of the row's 16-byte K chunks (rows padded by 16 bytes, so
//       the lanes hit distinct banks) with the `groups` query rows
//       (broadcast reads) and one shuffle adds the halves — against a
//       5-shuffle sum per (query row, row) before, and one max reduction
//       per (query row, tile).  Two lanes a row halve each warp's serial
//       work against one, and measured faster at the serve inputs; four
//       measured no better there and slower on 32 int8 lanes (PERF.md
//       §6).  The row sums stay per lane until the split ends.  An
//       int8 row is dequantized in
//       registers: its K scale multiplies the score, its V scale the
//       probability, so no f32 copy of a page exists anywhere;
//     - p.v runs with lanes owning head dims, over only the rows inside
//       the split's range, reading the probabilities from shared memory;
//     - the warps' states merge through shared memory in warp order, and
//       the split writes its (m, l, acc) per query head to f32 scratch
//       that the wrapper allocates;
//  2. split_merge_kernel (split_kv.cuh, shared with verify), grid
//     (kv_head, lane): one warp per query head merges the splits in split
//     order, so a call repeats bit for bit.  It is a programmatic
//     dependent launch: its blocks are scheduled while the split kernel's
//     last blocks run and wait (griddepcontrol.wait) for all their
//     writes, which hides most of its launch.
// fp8 pages (the JAX package's kv_cache_dtype="float8_e4m3fn", which
// casts on write and upcasts on read): TKV = __nv_fp8_e4m3, 16 elements a
// 16-byte copy as for int8 (stage_bytes pads a K row by 16 elements =
// 16 bytes), each converted to f32 in registers as it is read, exactly
// (every e4m3 value is a half); no scales.  A page row is half a bf16
// row, so the byte floor halves.
// The kernels allocate nothing: the caller passes the output and scratch.
// (decode_splits gives the number of splits a table width needs.)


#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"      // cp.async helpers
#include "split_kv.cuh"    // Shape, the fixed-order merge

namespace {

constexpr int kLanesPerKey = 2;              // lanes scoring one row
constexpr int kKeys = 32 / kLanesPerKey;     // rows a warp takes per tile
constexpr int kWarps = 2 * kLanesPerKey;
constexpr int kThreads = kWarps * 32;
constexpr int kSplit = 128;                  // logical rows per split
constexpr int kTile = kWarps * kKeys;        // rows per tile (64)
constexpr int kTiles = kSplit / kTile;       // tiles per split
constexpr int kMaxGroups = 16;               // query heads per KV head
constexpr size_t kSmemMax = 227 * 1024;
constexpr size_t kSmemTwoStages = 113 * 1024;  // two blocks an SM at least

// shared memory of a split block: query rows f32, `stages` tiles of K
// (rows padded by 16 bytes) and V (and for int8 the rows' K and V scales)
// — after the last tile the warps' acc for the block's merge —, the
// warps' probabilities, the warps' (m, l)
template <typename TKV>
__host__ __device__ constexpr size_t stage_bytes(int hd, int stages) {
  return (size_t)stages * kTile *
         ((hd + 16 / sizeof(TKV)) * sizeof(TKV) + hd * sizeof(TKV) +
          (std::is_same<TKV, int8_t>::value ? 8 : 0));
}
template <typename TKV>
__host__ __device__ constexpr size_t decode_smem(int groups, int hd,
                                                 int stages, int gb) {
  const size_t ring = stage_bytes<TKV>(hd, stages);
  const size_t wacc = (size_t)kWarps * groups * hd * 4;
  return (size_t)groups * hd * 4 + (ring > wacc ? ring : wacc) +
         (size_t)kTile * gb * 4 + (size_t)2 * kWarps * gb * 4;
}

// DPL: head dims per lane in p.v (hd <= 32 * DPL); GB: query heads per KV
// head the registers hold (groups <= GB: 2, 8 or 16, see by_groups); S:
// ring stages.  q is read once,
// into shared memory, so its dtype is a flag, not a template parameter.
// TKV = int8_t reads k/v_scales; other types (float, bf16, fp8 e4m3)
// ignore them.
template <typename TKV, int DPL, int GB, int S>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const void* __restrict__ q,           // (n, nh, hd)
                    int q_bf16,
                    const TKV* __restrict__ k_pages,      // (P, bs, nkv, hd)
                    const TKV* __restrict__ v_pages,      // (P, bs, nkv, hd)
                    const float* __restrict__ k_scales,   // (P, bs, nkv)
                    const float* __restrict__ v_scales,   // (P, bs, nkv)
                    const int32_t* __restrict__ tables,   // (n, n_table)
                    const int32_t* __restrict__ lengths,  // (n,)
                    float2* __restrict__ part_ml,         // (n, nkv, S, g)
                    float* __restrict__ part_acc,         // (.., g, hd)
                    Shape a) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int kVec = 16 / sizeof(TKV);   // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = a.hd;
  const int groups = a.groups;
  const int k_stride = hd + kVec;          // padded K row in shared memory
  float* qs = reinterpret_cast<float*>(smem_raw);
  TKV* ks = reinterpret_cast<TKV*>(qs + groups * hd);
  TKV* vs = ks + S * kTile * k_stride;
  float* ksc = reinterpret_cast<float*>(vs + S * kTile * hd);
  float* vsc = ksc + (kQuant ? S * kTile : 0);
  const size_t ring = stage_bytes<TKV>(hd, S);
  const size_t wacc_bytes = (size_t)kWarps * groups * hd * 4;
  float* ps = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(ks) +
      (ring > wacc_bytes ? ring : wacc_bytes));
  float* wm = ps + kTile * GB;
  float* wl = wm + kWarps * GB;

  const int kvh = blockIdx.x;
  const int seq = blockIdx.y;
  const int split = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int key = lane % kKeys;            // the warp's row this lane scores
  const int part = lane / kKeys;           // ... over 16-byte chunks part,
                                           // part + kLanesPerKey, ...
  const int nh = a.nkv * groups;
  const int split0 = split * kSplit;
  grid_launch_dependents();                // the merge may be scheduled
  // this lane's row of tile t: split0 + t * kTile + warp * kKeys + key
  const int my0 = split0 + warp * kKeys + key;

  // issued together: the length, this lane's table entries, the q rows
  const int length = lengths[seq];
  const int32_t* table = tables + (size_t)seq * a.n_table;
  int phys[kTiles];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    const int blk = min((my0 + t * kTile) / a.bs, a.n_table - 1);
    phys[t] = blk >= 0 ? table[blk] : 0;
  }
  const size_t q0 = ((size_t)seq * nh + (size_t)kvh * groups) * hd;
  for (int e = threadIdx.x; e < groups * hd; e += kThreads)
    qs[e] = q_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(q)[q0 + e])
                   : static_cast<const float*>(q)[q0 + e];

  const int hi = min(length, a.n_table * a.bs);      // rows [lo, hi) attend
  const int lo = a.window > 0 ? max(0, length - a.window) : 0;
  const int s_lo = max(lo, split0);
  const int s_hi = min(hi, split0 + kSplit);
  const size_t pbase =
      (((size_t)seq * a.nkv + kvh) * a.n_split + split) * groups;
  if (s_lo >= s_hi) {                      // none of the lane's rows here
    if (threadIdx.x < groups)
      part_ml[pbase + threadIdx.x] = make_float2(kNegInf, 0.f);
    return;
  }

  // this lane's row of each tile: its scale index (row of the (P, bs,
  // nkv) scales) and page element offset; rows outside [s_lo, s_hi) read
  // the garbage block 0
  long long sidx[kTiles];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    const int row = my0 + t * kTile;
    const int p = row >= s_lo && row < s_hi ? phys[t] : 0;
    sidx[t] = ((long long)p * a.bs + row % a.bs) * a.nkv + kvh;
  }

  // copy this warp's kKeys rows of tile t into stage st, 16 bytes a
  // copy; a lane's (row, chunk) pairs advance by a fixed step: no division.
  // Every lane takes part in each shuffle (the last round's extra lanes
  // copy nothing)
  const int vecs = hd / kVec;
  const int copies = kKeys * vecs;
  const int r_first = lane / vecs;
  const int c_first = lane - r_first * vecs;
  const int dr = 32 / vecs, dc = 32 - dr * vecs;
  auto load = [&](int t, int st) {
    long long my_s = sidx[0];
#pragma unroll
    for (int i = 1; i < kTiles; ++i)
      if (t == i) my_s = sidx[i];
    const long long my_off = my_s * hd;
    TKV* kd = ks + (st * kTile + warp * kKeys) * k_stride;
    TKV* vd = vs + (st * kTile + warp * kKeys) * hd;
    int r = r_first, c = c_first;
    for (int e0 = 0; e0 < copies; e0 += 32) {
      const long long off =
          __shfl_sync(0xffffffffu, my_off, min(r, kKeys - 1)) + c * kVec;
      if (e0 + lane < copies) {
        cp_async16(smem_u32(kd + r * k_stride + c * kVec), k_pages + off);
        cp_async16(smem_u32(vd + r * hd + c * kVec), v_pages + off);
      }
      r += dr;
      c += dc;
      if (c >= vecs) {
        c -= vecs;
        ++r;
      }
    }
    if constexpr (kQuant) {
      if (part == 0) {
        const int at = st * kTile + warp * kKeys + key;
        cp_async4(smem_u32(ksc + at), k_scales + my_s);
        cp_async4(smem_u32(vsc + at), v_scales + my_s);
      }
    }
  };

  // the tiles that hold rows of [s_lo, s_hi)
  const int t_lo = (s_lo - split0) / kTile;
  const int t_hi = (s_hi - 1 - split0) / kTile + 1;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    if (t_lo + i < t_hi) load(t_lo + i, i);
    cp_async_commit();
  }
  __syncthreads();                         // the q rows are in place

  const bool lane_on = lane * DPL < hd;    // lanes past hd idle in p.v
  const int dim0 = lane_on ? lane * DPL : 0;
  float acc[GB][DPL], m[GB], lp[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    lp[g] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[g][d] = 0.f;
  }
  float* pw = ps + warp * kKeys * GB;      // this warp's [key][head] probs

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) % S;
    cp_async_wait<S - 1>();
    __syncwarp();
    const int base = split0 + t * kTile + warp * kKeys;   // the warp's row 0
    const int row = base + key;
    const bool ok = row >= s_lo && row < s_hi;

    // scores of this lane's row against the groups query rows: this
    // lane's chunks, then the sum over the row's kLanesPerKey lanes
    float s[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) s[g] = 0.f;
    const TKV* krow = ks + (st * kTile + warp * kKeys + key) * k_stride;
#pragma unroll 2
    for (int d = part * kVec; d < hd; d += kLanesPerKey * kVec) {
      float kv[kVec];
      load_f32<TKV, kVec>(krow + d, kv);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g < groups) {                  // uniform across the block
          const float* qrow = qs + g * hd + d;
#pragma unroll
          for (int j = 0; j < kVec; j += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qrow + j);
            s[g] += qv.x * kv[j] + qv.y * kv[j + 1] + qv.z * kv[j + 2] +
                    qv.w * kv[j + 3];
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < groups) {
#pragma unroll
        for (int o = kKeys; o < 32; o <<= 1)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      }
    }
    float kscale = 1.f, vscale = 1.f;
    if constexpr (kQuant) {
      kscale = ksc[st * kTile + warp * kKeys + key];
      vscale = vsc[st * kTile + warp * kKeys + key];
    }

    // masks, online softmax, probabilities to shared memory
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < groups) {
        const float x = ok ? s[g] * kscale * a.sl2 : kNegInf;
        const float m_new = fmaxf(m[g], warp_max(x));
        // no visible row yet: subtract 0, so masked scores give 0
        const float mu = m_new == kNegInf ? 0.f : m_new;
        const float alpha = exp2_approx(m[g] - mu);
        const float p = exp2_approx(x - mu);
        lp[g] = lp[g] * alpha + (part == 0 ? p : 0.f);
        m[g] = m_new;
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[g][d] *= alpha;
        if (part == 0) pw[key * GB + g] = p * vscale;
      }
    }
    __syncwarp();

    // acc += p . v over the warp's rows inside [s_lo, s_hi)
    const int j_lo = max(0, s_lo - base);
    const int j_hi = min(kKeys, s_hi - base);
    const TKV* vt = vs + (st * kTile + warp * kKeys) * hd + dim0;
    for (int j = j_lo; j < j_hi; ++j) {
      float vv[DPL];
      load_f32<TKV, DPL>(vt + j * hd, vv);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g < groups) {
          const float pj = pw[j * GB + g];
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[g][d] += pj * vv[d];
        }
      }
    }
    __syncwarp();                          // the warp is done with stage st
    if (t + S < t_hi) load(t + S, st);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // merge the warps' states, in warp order, into the split's partial
  float l[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) l[g] = g < groups ? warp_sum(lp[g]) : 0.f;
  __syncthreads();                         // every warp is done with the ring
  float* wacc = reinterpret_cast<float*>(ks);
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g < groups) {
      if (lane == 0) {
        wm[warp * GB + g] = m[g];
        wl[warp * GB + g] = l[g];
      }
      if (lane_on) {
#pragma unroll
        for (int d = 0; d < DPL; ++d)
          wacc[(warp * groups + g) * hd + dim0 + d] = acc[g][d];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < groups * hd; e += kThreads) {
    const int g = e / hd;
    const int d = e - g * hd;
    float big = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) big = fmaxf(big, wm[w * GB + g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2_approx(wm[w * GB + g] - big);
      den += wl[w * GB + g] * c;
      num += wacc[(w * groups + g) * hd + d] * c;
    }
    part_acc[(pbase + g) * hd + d] = num;
    if (d == 0) part_ml[pbase + g] = make_float2(big, den);
  }
}

template <typename TQ, typename TO, typename TKV, int DPL, int GB, int S>
cudaError_t launch_stages(const void* q, const void* k_pages,
                          const void* v_pages, const float* k_scales,
                          const float* v_scales, const int32_t* tables,
                          const int32_t* lengths, void* out, void* part_ml,
                          void* part_acc, int n, const Shape& a,
                          cudaStream_t stream) {
  const size_t smem = decode_smem<TKV>(a.groups, a.hd, S, GB);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<TKV, DPL, GB, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.nkv, n, a.n_split);
  decode_split_kernel<TKV, DPL, GB, S><<<grid, kThreads, smem, stream>>>(
      q, sizeof(TQ) == 2, static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), k_scales, v_scales, tables, lengths,
      static_cast<float2*>(part_ml), static_cast<float*>(part_acc), a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the merge as a programmatic dependent launch: its blocks are
  // scheduled while the split kernel's last blocks run and wait in
  // griddepcontrol.wait for all of its writes
  return launch_dependent(split_merge_kernel<TO>, dim3(a.nkv, n),
                          dim3(kMergeWarps * 32), 0, stream,
                          static_cast<const float2*>(part_ml),
                          static_cast<const float*>(part_acc),
                          static_cast<TO*>(out), a);
}

// two stages where a block leaves room for another on its SM, else one:
// f32 pages at head_dim > 64 and bf16 at head_dim > 128 (2 stages of f32
// at head_dim 128 took 133 KB, one block an SM, and ran the 32-lane sweep
// slower than the one-block-per-lane kernel)
template <typename TQ, typename TO, typename TKV, int DPL, int GB>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const float* k_scales, const float* v_scales,
                   const int32_t* tables, const int32_t* lengths, void* out,
                   void* part_ml, void* part_acc, int n, const Shape& a,
                   cudaStream_t stream) {
  if (decode_smem<TKV>(a.groups, a.hd, 2, GB) <= kSmemTwoStages)
    return launch_stages<TQ, TO, TKV, DPL, GB, 2>(
        q, k_pages, v_pages, k_scales, v_scales, tables, lengths, out,
        part_ml, part_acc, n, a, stream);
  if constexpr (sizeof(TKV) * DPL >= 16) {
    if (decode_smem<TKV>(a.groups, a.hd, 1, GB) <= kSmemMax)
      return launch_stages<TQ, TO, TKV, DPL, GB, 1>(
          q, k_pages, v_pages, k_scales, v_scales, tables, lengths, out,
          part_ml, part_acc, n, a, stream);
  }
  return cudaErrorInvalidValue;
}

// The register width GB by group count: 2 (qwen3-0.6b's 2 query heads a
// KV head), 8 (3 to 8: yi-34b's 7, qwen2.5-32b's 5), 16 (9 to 16:
// command-r-plus-104b's 12).  Rows past `groups` idle behind a branch
// that is uniform across the block.  Every query head of a KV head is
// scored against the same staged K/V tile, so the K/V rows are still read
// once per split whatever the group count.  At GB 16 and DPL 4 a thread
// holds 64 acc floats and 48 softmax and score floats; the shared
// accumulator term of decode_smem (kWarps * groups * hd * 4 bytes, 24 KB
// at 12 groups and head_dim 128) stays under the ring at that head_dim.
template <typename TQ, typename TO, typename TKV, int DPL>
cudaError_t by_groups(const void* q, const void* k_pages,
                      const void* v_pages, const float* k_scales,
                      const float* v_scales, const int32_t* tables,
                      const int32_t* lengths, void* out, void* part_ml,
                      void* part_acc, int n, const Shape& a,
                      cudaStream_t stream) {
  if (a.groups <= 2)
    return launch<TQ, TO, TKV, DPL, 2>(q, k_pages, v_pages, k_scales, v_scales,
                                   tables, lengths, out, part_ml, part_acc,
                                   n, a, stream);
  if (a.groups <= 8)
    return launch<TQ, TO, TKV, DPL, 8>(q, k_pages, v_pages, k_scales, v_scales,
                                   tables, lengths, out, part_ml, part_acc,
                                   n, a, stream);
  return launch<TQ, TO, TKV, DPL, kMaxGroups>(q, k_pages, v_pages, k_scales,
                                          v_scales, tables, lengths, out,
                                          part_ml, part_acc, n, a, stream);
}

template <typename TQ, typename TO, typename TKV>
cudaError_t dispatch(const void* q, const void* k_pages, const void* v_pages,
                     const float* k_scales, const float* v_scales,
                     const int32_t* tables, const int32_t* lengths,
                     void* out, void* part_ml, void* part_acc, int n,
                     const Shape& a, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TKV);
  const int dpl = a.hd <= 32 ? 1 : a.hd <= 64 ? 2 : a.hd <= 128 ? 4 : 8;
  if (a.nkv < 1 || a.groups < 1 || a.groups > kMaxGroups || a.hd < 1 ||
      a.hd > 256 || a.hd % kVec != 0 || a.hd % dpl != 0 || a.bs < 1 ||
      a.n_table < 0)
    return cudaErrorInvalidValue;
  if (dpl == 1)
    return by_groups<TQ, TO, TKV, 1>(q, k_pages, v_pages, k_scales, v_scales,
                                 tables, lengths, out, part_ml, part_acc, n,
                                 a, stream);
  if (dpl == 2)
    return by_groups<TQ, TO, TKV, 2>(q, k_pages, v_pages, k_scales, v_scales,
                                 tables, lengths, out, part_ml, part_acc, n,
                                 a, stream);
  if (dpl == 4)
    return by_groups<TQ, TO, TKV, 4>(q, k_pages, v_pages, k_scales, v_scales,
                                 tables, lengths, out, part_ml, part_acc, n,
                                 a, stream);
  return by_groups<TQ, TO, TKV, 8>(q, k_pages, v_pages, k_scales, v_scales,
                               tables, lengths, out, part_ml, part_acc, n, a,
                               stream);
}

Shape make_shape(int nh, int nkv, int hd, int bs, int n_table, int window,
                 int n_split) {
  Shape a;
  a.kq = 1;
  a.nkv = nkv;
  a.hd = hd;
  a.bs = bs;
  a.n_table = n_table;
  a.groups = nkv > 0 ? nh / nkv : 0;
  a.window = window;
  a.n_split = n_split;
  a.tile = kTile;
  a.sl2 = kLog2e / sqrtf((float)hd);
  return a;
}

// Number of splits a call with this table needs (the scratch's third axis;
// at least one, so an empty table still launches and writes zeros).
inline int decode_splits(int n_table, int bs) {
  return n_table * bs > 0 ? (n_table * bs + kSplit - 1) / kSplit : 1;
}

}  // namespace
