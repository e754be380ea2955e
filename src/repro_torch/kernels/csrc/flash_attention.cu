// GQA flash attention (causal or not, optional sliding window, online
// softmax in f32), written for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_bhsd` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py:74.  Computes what
// repro_torch.kernels.ref.flash_attention_ref defines: q (b, nh, sq, hd),
// k/v (b, nkv, sk, hd); query head h reads KV head h / (nh / nkv), never a
// repeated copy; query and key positions both start at 0, so for sq != sk
// the causal diagonal is top-left; key j is visible to query i iff j < sk,
// j <= i (causal) and j > i - window (window); scores q.k / sqrt(hd) in
// f32, softmax online in f32, output cast to q's dtype.  q, k, v and out
// are addressed through their (batch, head, seq) strides, so the layer
// layout (b, s, h, d) is read and written where it lies, with no
// transposed copies.  The kernels allocate nothing: the caller passes the
// output buffer.
//
// What bounds it on an H100.  At the eval shapes of qwen3-0.6b (b 2,
// sq = sk = 1024, 16/8 heads, hd 128, bf16, causal) a launch must move
// q, k, v and out once, ~25 MB (7.5 us at 3.35 TB/s), and do 4 * hd
// flops per visible (query, key) pair, ~8.6 GFLOP causal (8.7 us at the
// 989 TFLOP/s bf16 tensor-core rate): the floor is the flops, under ten
// microseconds, and only the tensor cores reach it.
//
// Two kernels, chosen by the dtype (a fixed dispatch, not a fallback):
//
// bf16 — flash_bf16_kernel, both products on the tensor cores (wgmma):
//  * one block of two consumer warpgroups (256 threads); each warpgroup
//    owns 64 query rows of one query head.  The rows of a KV head are
//    numbered (query tile, head of the group), head fastest, and a block
//    takes two consecutive ones: for GQA groups of 2 (qwen3) both heads of
//    the group over one query tile, for groups of 1 (zamba2) two
//    consecutive query tiles of one head.  Either way the block's two
//    warpgroups share every K/V tile it loads, so the group's K/V rows
//    are read once per query tile (groups of 4 or more load them once per
//    pair of heads: four warpgroups' registers do not fit beside each
//    other at hd 128);
//  * under a plain causal mask a block walks two such units in turn, the
//    j-th from the end and then the j-th from the start, so every block
//    does the same number of key tiles and the 128 blocks of the eval
//    shape fill the card in one wave; the grid is 1-D;
//  * S = Q.K^T by wgmma m64n64k16 (bf16 in, f32 accumulate) with Q (held
//    in shared memory for the whole key loop) and the K tile both K-major,
//    exactly as they lie ([row][hd]); O += P.V by wgmma m64nNk16 with P as
//    the A operand from registers — the S accumulator after the online
//    softmax, converted to bf16 (the f32 accumulator fragment of m64n64 is
//    the bf16 A fragment of four k16 steps) — and V as the B operand in
//    its [key][hd] layout, MN-major for this product, read with wgmma's
//    transpose flag;
//  * loads by TMA: thread 0 issues each K and V tile (64 x 64 boxes of a
//    4-D tensor map per operand, built on the host per call through
//    cudaGetDriverEntryPoint, so the build links no -lcuda) into a ring of
//    up to four stages in the 128-byte swizzle (hopper.cuh), with a "full"
//    mbarrier a stage that counts the bytes and an "empty" one that every
//    thread arrives on when it is done with the stage; no block-wide
//    barrier per tile, so the two warpgroups drift and one's softmax
//    overlaps the other's products.  A warpgroup's first thread loads its
//    Q tile the same way.  The tensor maps read q, k and v through their
//    strides (the layer layout's transposed views, no copies).  TMA, not
//    cp.async: with cp.async the 256 compute threads issue every 16-byte
//    copy themselves, tens of instructions each, several a tile; with TMA
//    one thread issues a few boxes and the hardware counts the bytes;
//  * for hd > 64 the loop is software-pipelined as on FlashAttention-3:
//    iteration t issues Q.K^T of tile t + 1 and P.V of tile t, then runs
//    tile t + 1's softmax while P.V is in flight.  Every path issues and
//    retires its wgmma groups in straight-line code, and O's rescale
//    comes before any wgmma is outstanding: ptxas serializes every wgmma
//    of a kernel that touches an outstanding wgmma's registers.  For
//    hd <= 64 each tile runs in turn, in at most 128 registers, so two
//    blocks share an SM;
//  * head dims: the contraction runs over ceil(hd / 16) k16 steps, and
//    TMA fills the columns from hd up to the next multiple of 64 (and the
//    rows past sq or sk) with zeros — a zero adds nothing to q.k — and the
//    output columns past hd are never stored, so every hd the wrapper
//    takes (a multiple of 8 up to 256) launches;
//  * online softmax in f32 registers: each thread holds two rows' scores;
//    exp2 with scale * log2(e) folded in, a running max and a per-thread
//    partial sum per row (reduced across the row's four threads once, at
//    the end), -1e30 as the mask value, as the TPU kernel; O is rescaled
//    only when a row's max moved; key tiles wholly above the causal
//    diagonal or outside the window are skipped, and only tiles that
//    straddle the diagonal, a window edge or sk are masked.  The epilogue
//    divides by max(l, 1e-30), casts to bf16, stages the tile in shared
//    memory and stores it in 16-byte pieces through the output strides;
//  * numbers: P enters the second product in bf16 (8 bits of mantissa),
//    where the plain version and the TPU kernel keep it in f32; the
//    difference is within the bf16 tolerance (tested on the CPU with P
//    rounded the same way).

// f32 — flash_f32_kernel, on the CUDA cores: no single-pass tensor-core
// product (bf16 or TF32) meets the f32 tolerance of 2e-5.
//  * one block of 8 warps per (64-row query tile, query head, batch);
//  * the block's 64 query rows are converted to f32 into shared memory
//    once; each warp owns 8 of them, with their online-softmax state in
//    registers;
//  * each key tile is copied into shared memory by the whole block (16-byte
//    vector loads; key rows past sk read row sk - 1 and are masked);
//  * scores: lane j computes keys j and j + 32 of the tile for the warp's
//    8 rows (K rows padded by 16 bytes so the lanes' vector reads hit
//    distinct banks); one max and one sum warp reduction per row per tile;
//  * p.v: each lane owns head dims [lane*DPL, lane*DPL + DPL) and walks
//    the tile's keys, reading the warp's 8 probabilities of a key as two
//    broadcast vectors from shared memory;
//  * key tiles wholly above the diagonal or outside the window are
//    skipped.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;                   // query rows one warp owns
constexpr int kTileQ = kWarps * kRows;     // 64 query rows per block
constexpr int kTileK = 64;                 // keys per shared-memory tile
constexpr float kNegInf = -1e30f;          // the TPU kernel's mask value

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long q_st[3], k_st[3], v_st[3], o_st[3];   // (batch, head, seq)
  int sq, sk, nh, nkv, hd, causal, window;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
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

// N consecutive elements of T (aligned to N * sizeof(T)) as floats
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[N]) {
  const Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = to_f32(x.v[j]);
}

// DPL: head dims per lane in p.v (hd <= 32 * DPL, a multiple of DPL).
// Shared memory: q tile f32 (kTileQ x hd), K tile in T (kTileK rows of
// hd + kVec, the pad keeps the lanes' row reads on distinct banks), V
// tile in T (kTileK x hd), probabilities f32 (kWarps x kTileK x kRows).
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(Args a) {
  constexpr int kVec = 16 / sizeof(T);     // elements per 16-byte vector
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = a.hd;
  const int k_stride = hd + kVec;          // K row stride in shared memory
  float* qs = reinterpret_cast<float*>(smem_raw);
  T* ks = reinterpret_cast<T*>(qs + kTileQ * hd);
  T* vs = ks + kTileK * k_stride;
  float* ps = reinterpret_cast<float*>(vs + kTileK * hd);

  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.nh / a.nkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_st[0] + h * a.q_st[1];
  const T* kb = static_cast<const T*>(a.k) + b * a.k_st[0] + kvh * a.k_st[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.v_st[0] + kvh * a.v_st[1];
  const int vecs = hd / kVec;              // 16-byte vectors per row

  // the block's query rows, as f32 (rows past sq read row sq - 1 and are
  // never stored)
  for (int e = threadIdx.x; e < kTileQ * vecs; e += kThreads) {
    const int r = e / vecs;
    const int c = (e - r * vecs) * kVec;
    const int row = min(q0 + r, a.sq - 1);
    float x[kVec];
    load_f32<T, kVec>(qb + row * a.q_st[2] + c, x);
#pragma unroll
    for (int j = 0; j < kVec; ++j) qs[r * hd + c + j] = x[j];
  }

  // the key tiles some row of this query tile sees
  const int q_last = min(q0 + kTileQ, a.sq) - 1;
  const int k_end = a.causal ? min(a.sk, q_last + 1) : a.sk;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int t_begin = k_begin / kTileK;
  const int t_end = (k_end + kTileK - 1) / kTileK;

  const bool lane_on = lane * DPL < hd;    // lanes past hd idle in p.v
  const int dim0 = lane_on ? lane * DPL : 0;
  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[r][d] = 0.f;
  }
  const float* q_rows = qs + warp * kRows * hd;
  float* pw = ps + warp * kTileK * kRows;  // this warp's [key][row] probs

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kTileK;
    __syncthreads();            // q stored / every warp done with the tile
    for (int e = threadIdx.x; e < kTileK * vecs; e += kThreads) {
      const int r = e / vecs;
      const int c = (e - r * vecs) * kVec;
      const int row = min(k0 + r, a.sk - 1);
      const uint4 kx = *reinterpret_cast<const uint4*>(kb + row * a.k_st[2] + c);
      const uint4 vx = *reinterpret_cast<const uint4*>(vb + row * a.v_st[2] + c);
      *reinterpret_cast<uint4*>(ks + r * k_stride + c) = kx;
      *reinterpret_cast<uint4*>(vs + r * hd + c) = vx;
    }
    __syncthreads();

    // scores of the warp's rows against keys lane and lane + 32
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    const T* k_a = ks + lane * k_stride;
    const T* k_b = ks + (lane + 32) * k_stride;
    for (int d = 0; d < hd; d += kVec) {
      float ka[kVec], kbv[kVec];
      load_f32<T, kVec>(k_a + d, ka);
      load_f32<T, kVec>(k_b + d, kbv);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int j = 0; j < kVec; j += 4) {
          const float4 qv =
              *reinterpret_cast<const float4*>(q_rows + r * hd + d + j);
          s[r][0] += qv.x * ka[j] + qv.y * ka[j + 1] + qv.z * ka[j + 2] +
                     qv.w * ka[j + 3];
          s[r][1] += qv.x * kbv[j] + qv.y * kbv[j + 1] + qv.z * kbv[j + 2] +
                     qv.w * kbv[j + 3];
        }
      }
    }

    // masks, online softmax, probabilities to shared memory
    float p_a[kRows], p_b[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + warp * kRows + r;
      bool valid[2];
      float mt = kNegInf;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kp = k0 + lane + 32 * c;
        valid[c] = kp < a.sk && (!a.causal || kp <= qp) &&
                   (a.window <= 0 || kp > qp - a.window);
        s[r][c] = valid[c] ? s[r][c] * a.scale : kNegInf;
        mt = fmaxf(mt, s[r][c]);
      }
      const float m_new = fmaxf(m[r], warp_max(mt));
      const float alpha = expf(m[r] - m_new);
      p_a[r] = valid[0] ? expf(s[r][0] - m_new) : 0.f;
      p_b[r] = valid[1] ? expf(s[r][1] - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p_a[r] + p_b[r]);
      m[r] = m_new;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[r][d] *= alpha;
    }
#pragma unroll
    for (int r = 0; r < kRows; r += 4) {
      *reinterpret_cast<float4*>(pw + lane * kRows + r) =
          make_float4(p_a[r], p_a[r + 1], p_a[r + 2], p_a[r + 3]);
      *reinterpret_cast<float4*>(pw + (lane + 32) * kRows + r) =
          make_float4(p_b[r], p_b[r + 1], p_b[r + 2], p_b[r + 3]);
    }
    __syncwarp();

    // acc += p . v over the tile's real keys
    const int n_here = min(kTileK, a.sk - k0);
    for (int j = 0; j < n_here; ++j) {
      float vv[DPL];
      load_f32<T, DPL>(vs + j * hd + dim0, vv);
      const float4 pa = *reinterpret_cast<const float4*>(pw + j * kRows);
      const float4 pb = *reinterpret_cast<const float4*>(pw + j * kRows + 4);
      const float pr[kRows] = {pa.x, pa.y, pa.z, pa.w,
                               pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[r][d] += pr[r] * vv[d];
      }
    }
  }

  T* ob = static_cast<T*>(a.out) + b * a.o_st[0] + h * a.o_st[1];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + warp * kRows + r;
    if (qp < a.sq && lane_on) {
      const float den = fmaxf(l[r], 1e-30f);
      T* o_row = ob + qp * a.o_st[2] + dim0;
#pragma unroll
      for (int d = 0; d < DPL; ++d) o_row[d] = from_f32<T>(acc[r][d] / den);
    }
  }
}

template <typename T, int DPL>
cudaError_t launch_f32(const Args& a, int batch, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const size_t smem = sizeof(float) * kTileQ * a.hd +
                      sizeof(T) * kTileK * (a.hd + kVec) +
                      sizeof(T) * kTileK * a.hd +
                      sizeof(float) * kWarps * kTileK * kRows;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<T, DPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kTileQ - 1) / kTileQ, a.nh, batch);
  flash_f32_kernel<T, DPL><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_f32(const Args& a, int batch, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (a.nkv < 1 || a.nh % a.nkv != 0 || a.hd < 1 || a.hd % kVec != 0 ||
      a.sq < 1 || a.sk < 1)
    return cudaErrorInvalidValue;
  if (a.hd <= 32) return launch_f32<T, 1>(a, batch, stream);
  if (a.hd <= 64) return launch_f32<T, 2>(a, batch, stream);
  if (a.hd <= 128) return launch_f32<T, 4>(a, batch, stream);
  if (a.hd <= 256) return launch_f32<T, 8>(a, batch, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16: both products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;              // one warpgroup
constexpr int kWgs = 2;                      // consumer warpgroups a block
constexpr int kTcThreads = kWgs * kWgThreads;
constexpr int kTcRows = 64;                  // query rows per warpgroup
constexpr int kTcKeys = 64;                  // keys per K/V tile
constexpr int kRegion = 64 * 128;            // 64 rows of 64 bf16, swizzled
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kMaxStages = 4;                // K/V stages of the ring

// K/V stages of the ring for NR regions a row: up to kMaxStages, as many
// as the 227 KB of shared memory a block can have hold
__host__ __device__ constexpr int tc_stages(int nr) {
  return ((227 * 1024 - 1024) / (nr * kRegion) - kWgs) / 2 < kMaxStages
             ? ((227 * 1024 - 1024) / (nr * kRegion) - kWgs) / 2
             : kMaxStages;
}

// bytes of dynamic shared memory for NR regions a row: Q of each
// warpgroup, the K and V stages, and 1 KB to align the base
__host__ __device__ constexpr int tc_smem_bytes(int nr) {
  return (kWgs + 2 * tc_stages(nr)) * nr * kRegion + 1024;
}

// A q, k or v operand as TMA sees it: a 4-D tensor map over (hd, and the
// seq, head and batch axes in order of stride), and where each of those
// three axes sits in it (1..3).  Boxes are 64 values of hd by 64 rows.
struct TmaOperand {
  int row_dim, head_dim, batch_dim;
};

// TMA load of rows [row0, row0 + 64) x columns [col0, col0 + 64) of head
// `head`, batch `bi` (out-of-range rows and columns arrive as zeros)
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        TmaOperand op, uint32_t bar,
                                        int col0, int row0, int head,
                                        int bi) {
  int c[4] = {col0, 0, 0, 0};
#pragma unroll
  for (int d = 1; d < 4; ++d)
    c[d] = d == op.row_dim ? row0 : d == op.head_dim ? head : bi;
  tma_load_4d(dst, map, bar, c[0], c[1], c[2], c[3]);
}

// 2^x on the special-function unit (flushes results below 2^-126 to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// barrier over the 128 threads of warpgroup `wg` only
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(wg + 1), "n"(kWgThreads)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// key tiles [t0, t1) that some row of the 64-row query tile at q0 sees
__device__ __forceinline__ void tile_range(const Args& a, int q0, int& t0,
                                           int& t1) {
  const int q_last = min(q0 + kTcRows, a.sq) - 1;
  const int k_end = a.causal ? min(a.sk, q_last + 1) : a.sk;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  t0 = k_begin / kTcKeys;
  t1 = k_begin < k_end ? (k_end + kTcKeys - 1) / kTcKeys : t0;
}

// NR: 64-wide column regions a row (hd <= 64 * NR); the P.V product is
// m64n(64 * NR)k16, its accumulator 32 * NR floats a thread.  Under a
// plain causal mask (`paired`) block j walks two units of work in turn,
// blk = n_blk - 1 - j and then blk = j, so every block does the same
// number of key tiles; otherwise (no mask, or a window, where the units
// cost about the same) block j does unit j alone.
template <int NR>
__global__ void __launch_bounds__(kTcThreads, NR == 1 ? 2 : 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, TmaOperand op_q,
                  TmaOperand op_k, TmaOperand op_v, Args a, int batch,
                  int n_blk, int paired) {
  constexpr int kN = 64 * NR;                // P.V output columns (padded)
  constexpr int kStages = tc_stages(NR);
  // hd > 64: Q.K^T of the next tile overlaps this tile's softmax; hd <= 64:
  // each tile in turn, in fewer registers, so two blocks share an SM
  constexpr bool kOverlap = NR >= 2;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  // per K/V stage a "full" barrier (TMA bytes of both tiles arrived) and
  // an "empty" one (every thread is done with the stage); per warpgroup a
  // barrier for its Q tile
  __shared__ __align__(8) uint64_t bars[2 * kStages + kWgs];
  const uint32_t raw = smem_u32(tc_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = tc_smem + (base - raw);
  const uint32_t q_sm = base;                          // kWgs x NR regions
  const uint32_t k_sm = base + kWgs * NR * kRegion;    // kStages x NR
  const uint32_t v_sm = k_sm + kStages * NR * kRegion; // kStages x NR

  const int g = a.nh / a.nkv;
  const int per = a.nkv * batch;                       // blocks per slot
  const int slot = blockIdx.x / per;       // which unit (pair) of work
  const int rest = blockIdx.x - slot * per;
  const int kvh = rest % a.nkv;
  const int b = rest / a.nkv;
  const int n_units = ((a.sq + kTcRows - 1) / kTcRows) * g;

  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads;
  const int wtid = tid - wg * kWgThreads;
  const int warp = wtid / 32;                // warp within the warpgroup
  const int lane = tid % 32;
  const int row_t = warp * 16 + lane / 4;    // this thread's rows: row_t
  const int col2 = 2 * (lane % 4);           // and row_t + 8 of the tile

  const float sl2 = a.scale * kLog2e;        // raw score -> log2 units
  const int ksteps = (a.hd + 15) / 16;
  const uint32_t full_bar0 = smem_u32(&bars[0]);          // + 8 * stage
  const uint32_t empty_bar0 = smem_u32(&bars[kStages]);   // + 8 * stage
  const uint32_t q_bar = smem_u32(&bars[2 * kStages + wg]);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 2 * kStages + kWgs; ++i)
      mbar_init(smem_u32(&bars[i]),
                i >= kStages && i < 2 * kStages ? kTcThreads : 1);
    mbar_init_fence();
  }
  __syncthreads();
  // the parity each barrier's next awaited phase completes with, per
  // thread (a stage starts empty: its first wait for "empty" passes)
  uint32_t full_phase = 0, empty_phase = ~0u, q_phase = 0;

  // (thread 0) K and V rows of key tile `tile` into stage st, once every
  // thread has released it: 2 * NR boxes on the stage's full barrier
  auto load_kv = [&](int tile, int st) {
    mbar_wait(empty_bar0 + 8 * st, (empty_phase >> st) & 1u);
    empty_phase ^= 1u << st;
    const uint32_t bar = full_bar0 + 8 * st;
    mbar_expect_tx(bar, 2 * NR * kRegion);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      tma_box(k_sm + (st * NR + r) * kRegion, &tm_k, op_k, bar, r * 64,
              tile * kTcKeys, kvh, b);
      tma_box(v_sm + (st * NR + r) * kRegion, &tm_v, op_v, bar, r * 64,
              tile * kTcKeys, kvh, b);
    }
  };
  // every thread waits for the K/V tile in stage st
  auto wait_kv = [&](int st) {
    mbar_wait(full_bar0 + 8 * st, (full_phase >> st) & 1u);
    full_phase ^= 1u << st;
  };

  for (int pass = 0; pass < 2; ++pass) {
    const int blk = paired && pass == 0 ? n_blk - 1 - slot : slot;
    if (pass == 1 && (!paired || blk == n_blk - 1 - slot)) break;
    if (pass == 1) {                         // pass 0 is done with smem
      fence_proxy_async();                   // its O writes, before TMA's
      __syncthreads();
    }

    // this warpgroup's rows, and the block's key-tile range (both units)
    const int unit = blk * kWgs + wg;
    const bool wg_on = unit < n_units;
    const int q0 = wg_on ? (unit / g) * kTcRows : 0;
    const int h = kvh * g + (wg_on ? unit % g : 0);
    int w_t0 = 0, w_t1 = 0;
    if (wg_on) tile_range(a, q0, w_t0, w_t1);
    int t_begin = 1 << 30, t_end = 0;
#pragma unroll
    for (int u = 0; u < kWgs; ++u) {
      const int uu = blk * kWgs + u;
      if (uu < n_units) {
        int t0, t1;
        tile_range(a, (uu / g) * kTcRows, t0, t1);
        if (t0 < t1) {
          t_begin = min(t_begin, t0);
          t_end = max(t_end, t1);
        }
      }
    }

    // prologue: each warpgroup's Q rows (its first thread) and the first
    // kStages - 1 K/V tiles (thread 0), all by TMA
    if (wg_on && wtid == 0) {
      mbar_expect_tx(q_bar, NR * kRegion);
#pragma unroll
      for (int r = 0; r < NR; ++r)
        tma_box(q_sm + (wg * NR + r) * kRegion, &tm_q, op_q, q_bar, r * 64,
                q0, h, b);
    }
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < kStages - 1; ++i)
        if (t_begin + i < t_end) load_kv(t_begin + i, i);
    }
    if (wg_on) {
      mbar_wait(q_bar, q_phase);
      q_phase ^= 1u;
    }

    float o[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) o[i] = 0.f;
    // running max (raw score units) and per-thread partial sums of the
    // thread's two rows; P of the current tile as bf16 A fragments, and
    // the factor O is to be scaled by before P.V
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    uint32_t pa[4][4];
    float alpha[2] = {1.f, 1.f};
    const uint32_t qa = q_sm + wg * NR * kRegion;

    // S = Q . K^T of the key tile in stage st into d (the first k16 step
    // overwrites d), issued and committed, not waited on
    auto issue_qk = [&](float (&d)[32], int st) {
      fence_regs(d);
      wgmma_fence();
      const uint32_t ka = k_sm + st * NR * kRegion;
      for (int ks = 0; ks < ksteps; ++ks) {
        const uint32_t off = (ks >> 2) * kRegion + (ks & 3) * 32;
        wgmma_ss(d, wgmma_desc(qa + off, 16, 1024),
                 wgmma_desc(ka + off, 16, 1024), ks > 0);
      }
      wgmma_commit();
    };

    // online softmax of key tile k0's scores x into p (P in f32): masks,
    // running max, alpha (the rescale of what came before), row sums.  x
    // is only read: it may be the accumulator of a wgmma group that has
    // retired while another is still in flight
    auto softmax = [&](const float (&sx)[32], float (&x)[32], int k0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = sx[i];
      // masks, only on tiles that straddle sk, the diagonal or a window
      // edge (a masked raw score is -1e30)
      if (k0 + kTcKeys > a.sk || (a.causal && k0 + kTcKeys - 1 > q0) ||
          (a.window > 0 && k0 <= q0 + kTcRows - 1 - a.window)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int kp = k0 + (i / 4) * 8 + col2 + (i & 1);
          const int qp = q0 + row_t + ((i & 2) ? 8 : 0);
          const bool ok = kp < a.sk && (!a.causal || kp <= qp) &&
                          (a.window <= 0 || kp > qp - a.window);
          x[i] = ok ? x[i] : kNegInf;
        }
      }
      // row maxima as a tree, then across the row's four threads; the
      // scale is positive, so the max of the raw scores is the max
      float mu[2], lsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float t8[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          t8[j] = fmaxf(x[4 * j + 2 * r], x[4 * j + 2 * r + 1]);
#pragma unroll
        for (int w = 4; w > 0; w >>= 1) {
#pragma unroll
          for (int j = 0; j < w; ++j) t8[j] = fmaxf(t8[j], t8[j + w]);
        }
        float mx = fmaxf(m[r], t8[0]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // a row with no visible key yet keeps m = -1e30: subtract 0 then,
        // so its masked scores give exp2(-1.4e30) = 0, not 1
        mu[r] = mx == kNegInf ? 0.f : mx * sl2;
        // (a product rounded as mu's, so an unmoved max gives exactly 1)
        alpha[r] = exp2_approx(__fmul_rn(m[r], sl2) - mu[r]);
        m[r] = mx;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = exp2_approx(fmaf(x[i], sl2, -mu[(i >> 1) & 1]));
        lsum[(i >> 1) & 1] += p;
        x[i] = p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], lsum[r]);
    };

    // P in f32 -> four bf16 A fragments (k16 steps over the tile's keys)
    auto to_frags = [&](const float (&x)[32]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
        pa[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
        pa[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
        pa[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
      }
    };

    // Iteration t multiplies P.V of tile t while the tensor cores also
    // run Q.K^T of tile t + 1, and runs tile t + 1's softmax while P.V of
    // tile t is still in flight; tiles t and t + 1 are resident.
    for (int t = t_begin; t < t_end; ++t) {
      const int st = (t - t_begin) % kStages;
      const int t_load = t + kStages - 1;    // into the stage freed last
      if (tid == 0 && t_load < t_end)
        load_kv(t_load, (t_load - t_begin) % kStages);
      if (t == t_begin) wait_kv(st);         // tiles t and t + 1 resident
      if (t + 1 < t_end) wait_kv((t + 1 - t_begin) % kStages);

      if (wg_on && t >= w_t0 && t < w_t1) {  // uniform across the warpgroup
        if (!kOverlap || t == w_t0) {        // scores of tile t, in turn
          float s0[32], p0[32];
          issue_qk(s0, st);
          wgmma_wait<0>();
          fence_regs(s0);
          softmax(s0, p0, t * kTcKeys);
          to_frags(p0);
        }
        // O's rescale comes before any wgmma is in flight, and each path
        // below issues and retires its wgmma groups in straight-line code:
        // ptxas serializes every wgmma of a kernel that touches an
        // outstanding wgmma's registers, or cannot tell that it does not
        if (alpha[0] != 1.f || alpha[1] != 1.f) {  // a row's max moved
#pragma unroll
          for (int i = 0; i < kN / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        }
        fence_regs(o);
        // O += P . V: V's [key][hd] tile is MN-major for this product
        const uint32_t va = v_sm + st * NR * kRegion;
        auto issue_pv = [&]() {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs(o, pa[kk],
                     wgmma_desc(va + kk * 16 * 128, kRegion, 1024));
          wgmma_commit();
        };
        if (kOverlap && t + 1 < w_t1) {
          float sn[32], pn[32];
          issue_qk(sn, (t + 1 - t_begin) % kStages);
          issue_pv();
          wgmma_wait<1>();                   // Q.K^T of tile t + 1
          softmax(sn, pn, (t + 1) * kTcKeys);  // while P.V of tile t runs
          wgmma_wait<0>();
          fence_regs(o);
          fence_regs(sn);
          to_frags(pn);
        } else {                             // P.V of tile t alone
          issue_pv();
          wgmma_wait<0>();
          fence_regs(o);
        }
      }
      mbar_arrive(empty_bar0 + 8 * st);      // done with tile t's stage
    }
    if (wg_on) {
      // O / l in bf16 into this warpgroup's Q regions (free once all its
      // threads are past their last wgmma), then out through 16-byte
      // stores, a row's chunks on neighbouring threads
      unsigned char* const o_sm = gbase + wg * NR * kRegion;
      wg_sync(wg);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int c8 = 0; c8 < kN / 8; ++c8)
          *reinterpret_cast<__nv_bfloat162*>(
              o_sm + (c8 >> 3) * kRegion + swz128(row_t + 8 * r, c8 & 7) +
              col2 * 2) = __floats2bfloat162_rn(o[4 * c8 + 2 * r] * inv,
                                                o[4 * c8 + 2 * r + 1] * inv);
      }
      wg_sync(wg);
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.out) +
                          b * a.o_st[0] + h * a.o_st[1];
      const int cpr = a.hd / 8;
      for (int e = wtid; e < kTcRows * cpr; e += kWgThreads) {
        const int r = e / cpr;
        const int cc = e - r * cpr;
        if (q0 + r < a.sq)
          *reinterpret_cast<uint4*>(ob + (q0 + r) * a.o_st[2] + cc * 8) =
              *reinterpret_cast<const uint4*>(o_sm + (cc >> 3) * kRegion +
                                              swz128(r, cc & 7));
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (the build links no
// -lcuda)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// The tensor map of a (batch, head, seq, hd) bf16 operand at `ptr` with
// element strides st (batch, head, seq; hd contiguous): dims (hd, then
// seq, head and batch in increasing order of stride), 64 x 64 boxes
// (one head, one batch), 128-byte swizzle, zeros out of range.
cudaError_t tensor_map(CUtensorMap* map, TmaOperand* op, const void* ptr,
                       int hd, int seq, int heads, int batch,
                       const long long* st) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  // axes 0 batch, 1 head, 2 seq, by increasing stride (stable)
  int order[3] = {2, 1, 0};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (st[order[j]] < st[order[i]]) {
        const int t = order[i];
        order[i] = order[j];
        order[j] = t;
      }
  const cuuint64_t extent[3] = {(cuuint64_t)batch, (cuuint64_t)heads,
                                (cuuint64_t)seq};
  cuuint64_t dims[4] = {(cuuint64_t)hd, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  for (int d = 1; d < 4; ++d) {
    const int axis = order[d - 1];
    dims[d] = extent[axis];
    strides[d - 1] = (cuuint64_t)st[axis] * sizeof(__nv_bfloat16);
    if (axis == 2) {
      box[d] = kTcKeys;
      op->row_dim = d;
    } else if (axis == 1) {
      op->head_dim = d;
    } else {
      op->batch_dim = d;
    }
  }
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int NR>
cudaError_t launch_bf16(const Args& a, int batch, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  TmaOperand op_q, op_k, op_v;
  cudaError_t err =
      tensor_map(&tm_q, &op_q, a.q, a.hd, a.sq, a.nh, batch, a.q_st);
  if (err == cudaSuccess)
    err = tensor_map(&tm_k, &op_k, a.k, a.hd, a.sk, a.nkv, batch, a.k_st);
  if (err == cudaSuccess)
    err = tensor_map(&tm_v, &op_v, a.v, a.hd, a.sk, a.nkv, batch, a.v_st);
  if (err != cudaSuccess) return err;
  const int smem = tc_smem_bytes(NR);
  err = cudaFuncSetAttribute(flash_bf16_kernel<NR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int n_units = ((a.sq + kTcRows - 1) / kTcRows) * (a.nh / a.nkv);
  const int n_blk = (n_units + kWgs - 1) / kWgs;    // units of two
  const int paired = a.causal && a.window <= 0;
  const int n_slots = paired ? (n_blk + 1) / 2 : n_blk;
  flash_bf16_kernel<NR><<<n_slots * a.nkv * batch, kTcThreads, smem,
                          stream>>>(tm_q, tm_k, tm_v, op_q, op_k, op_v, a,
                                    batch, n_blk, paired);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const Args& a, int batch, cudaStream_t stream) {
  if (a.nkv < 1 || a.nh % a.nkv != 0 || a.hd < 8 || a.hd % 8 != 0 ||
      a.sq < 1 || a.sk < 1)
    return cudaErrorInvalidValue;
  if (a.hd <= 64) return launch_bf16<1>(a, batch, stream);
  if (a.hd <= 128) return launch_bf16<2>(a, batch, stream);
  if (a.hd <= 192) return launch_bf16<3>(a, batch, stream);
  if (a.hd <= 256) return launch_bf16<4>(a, batch, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype code: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the
// tensor-core kernel); q, k, v and out share it.  strides: 12 element
// strides, (batch, head, seq) of q, k, v and out in that order; the
// head_dim axis must be contiguous.  window <= 0 means no window.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out,
                                   const long long* strides, int batch,
                                   int sq, int sk, int nh, int nkv, int hd,
                                   int causal, int window, int dtype,
                                   void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  for (int i = 0; i < 3; ++i) {
    a.q_st[i] = strides[i];
    a.k_st[i] = strides[3 + i];
    a.v_st[i] = strides[6 + i];
    a.o_st[i] = strides[9 + i];
  }
  a.sq = sq;
  a.sk = sk;
  a.nh = nh;
  a.nkv = nkv;
  a.hd = hd;
  a.causal = causal;
  a.window = window;
  a.scale = 1.0f / sqrtf((float)hd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_f32<float>(a, batch, s);
  if (dtype == 1) return (int)dispatch_bf16(a, batch, s);
  return (int)cudaErrorInvalidValue;
}
