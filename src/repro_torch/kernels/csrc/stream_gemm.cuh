// Weight-streaming products of the fused decode layer (fused_decode.cu)
// and of SwiGLU at few rows (swiglu.cu), written for Hopper (sm_90a):
// P[s] = X[:, ks] . W[ks, :] for the s-th slice ks of the depth, with f32
// sums, at n <= 32 activation rows (the decode lanes) a block.
//
// What bounds them on an H100: the weight bytes.  At 8 lanes a product
// does 2 x 8 flops per weight value read (8 per byte in bf16), far under
// the card's ridge, so the floor is the weights over 3.35 TB/s, and a
// design has to keep those bytes in flight all the time.
//
// Design.  A block owns kTileN = 64 weight columns, a depth slice and up
// to 32 rows; the depth is split across blocks so that a product puts ~2
// blocks on every SM (plan), and the slices' partial sums go to an f32
// workspace, which the next phase adds in slice order (a call repeats
// bit for bit).
//  - Weight ring: the block's weight tiles (64 depth rows of bf16, or 32
//    of f32: 8 KB) stream through a kStages-deep cp.async ring.  The first
//    kStages tiles are issued BEFORE griddepcontrol.wait: the weights do
//    not depend on the previous phase, so under a programmatic dependent
//    launch their loads run while that phase still computes.  Only then
//    does the block wait and stage its activations.
//  - bf16 weights run on the tensor cores with the operands swapped,
//    out^T = W^T . X^T: the weight tile is the A operand of
//    mma.sync.m16n8k16 (ldmatrix.trans from a 128-byte-swizzled tile; a
//    warp owns 16 columns) and the lanes are N = 8, 1 to 4 n-tiles, so no
//    product runs on padding rows of a 32-row tile.  The reference
//    multiplies upcast weights by f32 activations in f32; bf16 weights are
//    exact in bf16, so only the activation side is rounded: each
//    activation is split into x = hi + lo, both bf16 (hi = bf16(x), lo =
//    bf16(x - hi)), and two products are issued on the same weight
//    fragment.  hi + lo carries x to ~2^-17 relative (against 2^-9 for
//    plain bf16, 2^-11 for TF32); the byte bound leaves room for the
//    second product (kSplitActivation).  bf16 activations (SwiGLU's x) are
//    exact as they are: one product, no lo part.
//  - f32 weights stay on the CUDA cores (TF32 cannot meet the layer's
//    2e-4 tolerance).  They get the same ring and a row tile sized to the
//    lanes: 8 rows when n <= 8 (four groups of threads then split each
//    weight tile's depth and add their sums in group order), else 32.
//  - The activations come from the workspace, where the previous phase
//    wrote them (f32), or from the caller (SwiGLU's x: f32 or bf16, the
//    activation type a template parameter); a block stages its rows of
//    its depth slice once.
//
// Shapes the caller guarantees: K % 4 == 0, N % 8 == 0, W 16-byte
// aligned, row-major contiguous operands.

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace sg {

constexpr int kTileN = 64;          // weight columns per block
constexpr int kSliceK = 64;         // depth granule of a slice
constexpr int kStages = 4;          // weight tiles in flight per block
constexpr int kTargetBlocks = 264;  // ~2 blocks on each of the 132 SMs
constexpr int kMaxRows = 32;        // activation rows per block
// deepest slice: a block stages its rows of its slice in shared memory
// (32 rows of 1536 + pad: 197 KB in f32, beside the 32 KB ring; bf16
// the same at 4 n-tiles), so a wide product such as command-r-plus-104b's
// (d 12288, f 33792) takes more slices instead of a refused launch
constexpr int kMaxSliceK = 1536;
constexpr bool kSplitActivation = true;  // x = hi + lo: two bf16 products

// How a product of depth K is split across blocks: enough slices that the
// grid has ~kTargetBlocks blocks, each slice a whole number of granules
// and at most kMaxSliceK deep.
struct Split {
  int splits;
  int k_per_split;
};

inline Split plan(int K, int N, int n_mats, int row_tiles) {
  const int others = ((N + kTileN - 1) / kTileN) * n_mats * row_tiles;
  const int granules = (K + kSliceK - 1) / kSliceK;
  int s = (kTargetBlocks + others - 1) / others;
  s = s < 1 ? 1 : (s > granules ? granules : s);
  Split out;
  out.k_per_split = ((granules + s - 1) / s) * kSliceK;
  if (out.k_per_split > kMaxSliceK) out.k_per_split = kMaxSliceK;
  out.splits = (K + out.k_per_split - 1) / out.k_per_split;
  return out;
}

inline int row_tiles(int n) { return (n + kMaxRows - 1) / kMaxRows; }

// 4 consecutive activations of row r at depth k (k % 4 == 0)
__device__ __forceinline__ float4 load_act4(const float* x, int r, int k,
                                            int K) {
  return *reinterpret_cast<const float4*>(x + (size_t)r * K + k);
}
__device__ __forceinline__ float4 load_act4(const __nv_bfloat16* x, int r,
                                            int k, int K) {
  const uint2 raw = *reinterpret_cast<const uint2*>(x + (size_t)r * K + k);
  const float2 a = unpack_bf16x2(raw.x), b = unpack_bf16x2(raw.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

// blockIdx: x = column tile, y = depth slice s, z = mat * row_tiles + row
// tile (mat picks W0/P0 or W1/P1: the gate and up products share a launch)
struct Args {
  const void* x;       // the activations, (n, K), f32 or bf16
  const void* w0;
  const void* w1;
  float* p0;
  float* p1;
  int n, K, N, k_per_split, row_tiles;
};

// ---- bf16 weights: tensor cores ------------------------------------------

constexpr int kThreadsBf16 = 128;   // 4 warps x 16 columns
constexpr int kDepthBf16 = 64;      // depth rows of a ring tile (128 B each)

template <int NT>
__host__ __device__ constexpr size_t smem_bf16(int k_per_split) {
  return (size_t)kStages * kDepthBf16 * 128 +
         2 * (size_t)NT * 8 * (k_per_split + 8) * 2;
}

template <int NT, typename TX>
__global__ void __launch_bounds__(kThreadsBf16)
product_bf16_kernel(Args p) {
  constexpr int kRows = NT * 8;
  constexpr bool kSplit = kSplitActivation && sizeof(TX) == 4;
  const TX* __restrict__ X = static_cast<const TX*>(p.x);
  extern __shared__ __align__(128) unsigned char smem[];
  const int mat = blockIdx.z / p.row_tiles;
  const int r0 = (blockIdx.z - mat * p.row_tiles) * kRows;
  const __nv_bfloat16* __restrict__ W =
      static_cast<const __nv_bfloat16*>(mat ? p.w1 : p.w0);
  float* __restrict__ P = mat ? p.p1 : p.p0;
  const int c0 = blockIdx.x * kTileN;
  const int s = blockIdx.y;
  const int k_lo = s * p.k_per_split;
  const int k_hi = min(p.K, k_lo + p.k_per_split);
  const int chunks = (k_hi - k_lo + kDepthBf16 - 1) / kDepthBf16;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t ring = smem_u32(smem);
  // staged activations: kRows rows of (k_per_split + 8) bf16, hi then lo;
  // the 16-byte pad puts 8 consecutive rows on distinct banks for ldmatrix
  const int xstride = p.k_per_split + 8;
  __nv_bfloat16* xhi = reinterpret_cast<__nv_bfloat16*>(
      smem + kStages * kDepthBf16 * 128);
  __nv_bfloat16* xlo = xhi + kRows * xstride;

  // weight tile c (64 depth rows x 8 16-byte chunks) into stage st;
  // depth past the slice and columns past N read as 0
  auto load_w = [&](int c, int st) {
    for (int e = threadIdx.x; e < kDepthBf16 * 8; e += kThreadsBf16) {
      const int row = e >> 3, ch = e & 7;
      const int k = k_lo + c * kDepthBf16 + row;
      const int col = c0 + ch * 8;
      const bool ok = k < k_hi && col < p.N;
      cp_async16_zfill(ring + st * kDepthBf16 * 128 + swz128(row, ch),
                       ok ? W + (size_t)k * p.N + col : W, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < chunks) load_w(st, st);
    cp_async_commit();
  }
  grid_launch_dependents();
  grid_dependency_wait();          // the activations are written

  // stage rows r0.. of the slice's activations as bf16 hi and lo; rows
  // past n and depth past the slice are 0
  const int span4 = chunks * kDepthBf16 / 4;
  for (int e = threadIdx.x; e < kRows * span4; e += kThreadsBf16) {
    const int r = e / span4;
    const int kk = (e - r * span4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < p.n && k_lo + kk < k_hi)
      v = load_act4(X, r0 + r, k_lo + kk, p.K);
    const uint32_t h01 = pack_bf16x2(v.x, v.y), h23 = pack_bf16x2(v.z, v.w);
    *reinterpret_cast<uint2*>(xhi + r * xstride + kk) = make_uint2(h01, h23);
    if constexpr (kSplit) {
      const float2 f01 = unpack_bf16x2(h01), f23 = unpack_bf16x2(h23);
      *reinterpret_cast<uint2*>(xlo + r * xstride + kk) =
          make_uint2(pack_bf16x2(v.x - f01.x, v.y - f01.y),
                     pack_bf16x2(v.z - f23.x, v.w - f23.y));
    }
  }

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[t][j] = 0.f;
  const int mj = lane >> 3;        // the ldmatrix matrix this lane addresses
  const int mi = lane & 7;         // ... and its row
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 1>();
    __syncthreads();               // tile c (and the activations) in place
    const uint32_t stage = ring + (c % kStages) * kDepthBf16 * 128;
#pragma unroll
    for (int k16 = 0; k16 < kDepthBf16 / 16; ++k16) {
      // A = W^T (16 columns x 16 depth): matrices (depth 0-7, columns
      // 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15), transposed
      uint32_t a[4];
      ldmatrix_x4_trans(a, stage + swz128(k16 * 16 + (mj >> 1) * 8 + mi,
                                          warp * 2 + (mj & 1)));
      const int k0 = c * kDepthBf16 + k16 * 16 + (mj & 1) * 8;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        // B = X^T (16 depth x 8 rows): hi depth 0-7, 8-15, lo 0-7, 8-15
        uint32_t b[4];
        ldmatrix_x4(b, smem_u32((mj >> 1 ? xlo : xhi) +
                                (t * 8 + mi) * xstride + k0));
        mma_bf16_16816(acc[t], a, b[0], b[1]);
        if constexpr (kSplit) mma_bf16_16816(acc[t], a, b[2], b[3]);
      }
    }
    __syncthreads();               // every warp is done with stage c
    if (c + kStages < chunks) load_w(c + kStages, c % kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // D(columns, rows): lane 4g + q holds columns g, g + 8 of rows 2q, 2q+1
  float* Ps = P + (size_t)s * p.n * p.N;
  const int g = lane >> 2, q = lane & 3;
  const int col = c0 + warp * 16 + g;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int r = r0 + t * 8 + 2 * q;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rr = r + (j & 1);
      const int cc = col + (j >> 1) * 8;
      if (rr < p.n && cc < p.N) Ps[(size_t)rr * p.N + cc] = acc[t][j];
    }
  }
}

// ---- f32 weights: CUDA cores -----------------------------------------------

constexpr int kThreadsF32 = 256;
constexpr int kDepthF32 = 32;       // depth rows of a ring tile (256 B each)

template <int TM>
__host__ __device__ constexpr size_t smem_f32(int k_per_split) {
  return (size_t)kStages * kDepthF32 * kTileN * 4 +
         (size_t)TM * (k_per_split + 4) * 4;
}

// Thread (group kg, row tr, column quad tc) sums rows tr and tr + TM/2,
// columns 4 tc .. 4 tc + 3, over depth rows [kg, kg + 1) * kDepthF32 /
// groups of each tile.
template <int TM>
__global__ void __launch_bounds__(kThreadsF32)
product_f32_kernel(Args p) {
  constexpr int kRowThreads = TM / 2;
  constexpr int kGroups = kThreadsF32 / (16 * kRowThreads);
  constexpr int kGroupDepth = kDepthF32 / kGroups;
  static_assert(kGroups * 16 * kRowThreads == kThreadsF32, "thread layout");
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int xstride = p.k_per_split + 4;
  float* xs = ring + kStages * kDepthF32 * kTileN;
  const int mat = blockIdx.z / p.row_tiles;
  const int r0 = (blockIdx.z - mat * p.row_tiles) * TM;
  const float* __restrict__ W = static_cast<const float*>(mat ? p.w1 : p.w0);
  float* __restrict__ P = mat ? p.p1 : p.p0;
  const int c0 = blockIdx.x * kTileN;
  const int s = blockIdx.y;
  const int k_lo = s * p.k_per_split;
  const int k_hi = min(p.K, k_lo + p.k_per_split);
  const int chunks = (k_hi - k_lo + kDepthF32 - 1) / kDepthF32;

  auto load_w = [&](int c, int st) {
    for (int e = threadIdx.x; e < kDepthF32 * 16; e += kThreadsF32) {
      const int row = e >> 4, ch = e & 15;
      const int k = k_lo + c * kDepthF32 + row;
      const int col = c0 + ch * 4;
      const bool ok = k < k_hi && col < p.N;
      cp_async16_zfill(
          smem_u32(ring + (st * kDepthF32 + row) * kTileN + ch * 4),
          ok ? W + (size_t)k * p.N + col : W, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < chunks) load_w(st, st);
    cp_async_commit();
  }
  grid_launch_dependents();
  grid_dependency_wait();          // the activations are written

  const int span4 = chunks * kDepthF32 / 4;
  for (int e = threadIdx.x; e < TM * span4; e += kThreadsF32) {
    const int r = e / span4;
    const int kk = (e - r * span4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < p.n && k_lo + kk < k_hi)
      v = load_act4(static_cast<const float*>(p.x), r0 + r, k_lo + kk, p.K);
    *reinterpret_cast<float4*>(xs + r * xstride + kk) = v;
  }

  const int kg = threadIdx.x / (16 * kRowThreads);
  const int tr = (threadIdx.x / 16) % kRowThreads;
  const int tc = threadIdx.x % 16;
  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* wt = ring + (c % kStages) * kDepthF32 * kTileN;
    const float* x0 = xs + tr * xstride + c * kDepthF32;
    const float* x1 = x0 + kRowThreads * xstride;
#pragma unroll 8
    for (int kk = kg * kGroupDepth; kk < (kg + 1) * kGroupDepth; ++kk) {
      const float4 w = *reinterpret_cast<const float4*>(wt + kk * kTileN +
                                                        tc * 4);
      const float a0 = x0[kk], a1 = x1[kk];
      acc[0][0] += a0 * w.x;
      acc[0][1] += a0 * w.y;
      acc[0][2] += a0 * w.z;
      acc[0][3] += a0 * w.w;
      acc[1][0] += a1 * w.x;
      acc[1][1] += a1 * w.y;
      acc[1][2] += a1 * w.z;
      acc[1][3] += a1 * w.w;
    }
    __syncthreads();
    if (c + kStages < chunks) load_w(c + kStages, c % kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();

  float* Ps = P + (size_t)s * p.n * p.N;
  if constexpr (kGroups == 1) {
    const int c = c0 + tc * 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + tr + kRowThreads * i;
      if (r < p.n && c < p.N)
        *reinterpret_cast<float4*>(Ps + (size_t)r * p.N + c) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  } else {
    // the groups' sums through shared memory (the ring is free), added in
    // group order
    __syncthreads();
    float* red = ring;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        red[(kg * TM + tr + kRowThreads * i) * kTileN + tc * 4 + j] =
            acc[i][j];
    __syncthreads();
    for (int e = threadIdx.x; e < TM * kTileN; e += kThreadsF32) {
      const int r = e / kTileN, cc = e % kTileN;
      float v = 0.f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) v += red[(g * TM + r) * kTileN + cc];
      if (r0 + r < p.n && c0 + cc < p.N)
        Ps[(size_t)(r0 + r) * p.N + c0 + cc] = v;
    }
  }
}

// ---- launch ----------------------------------------------------------------

template <typename K>
cudaError_t launch_with_smem(K kernel, dim3 grid, int threads, size_t smem,
                             cudaStream_t stream, const Args& a,
                             bool dependent) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (!dependent) {
    kernel<<<grid, threads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  return launch_dependent(kernel, grid, dim3(threads), smem, stream, a);
}

// One product, as a programmatic dependent of the work before it on
// `stream` (or, `dependent` false, a plain launch: the first of a chain,
// whose weights the work before may have written): bf16 weights on the
// tensor cores (1, 2 or 4 n-tiles of 8 lanes; f32 or bf16 activations),
// f32 weights on the CUDA cores (8- or 32-row tiles; f32 activations).
template <typename TW, typename TX>
cudaError_t launch_product(const TX* x, const TW* w0, const TW* w1,
                           float* p0, float* p1, int n, int K, int N,
                           int n_mats, Split sk, cudaStream_t stream,
                           bool dependent = true) {
  Args a;
  a.x = x;
  a.w0 = w0;
  a.w1 = w1;
  a.p0 = p0;
  a.p1 = p1;
  a.n = n;
  a.K = K;
  a.N = N;
  a.k_per_split = sk.k_per_split;
  a.row_tiles = row_tiles(n);
  const dim3 grid((N + kTileN - 1) / kTileN, sk.splits,
                  n_mats * a.row_tiles);
  if constexpr (sizeof(TW) == 2) {
    if (n <= 8)
      return launch_with_smem(product_bf16_kernel<1, TX>, grid,
                              kThreadsBf16, smem_bf16<1>(sk.k_per_split),
                              stream, a, dependent);
    if (n <= 16)
      return launch_with_smem(product_bf16_kernel<2, TX>, grid,
                              kThreadsBf16, smem_bf16<2>(sk.k_per_split),
                              stream, a, dependent);
    return launch_with_smem(product_bf16_kernel<4, TX>, grid, kThreadsBf16,
                            smem_bf16<4>(sk.k_per_split), stream, a,
                            dependent);
  } else {
    static_assert(sizeof(TX) == 4, "f32 weights take f32 activations");
    if (n <= 8)
      return launch_with_smem(product_f32_kernel<8>, grid, kThreadsF32,
                              smem_f32<8>(sk.k_per_split), stream, a,
                              dependent);
    return launch_with_smem(product_f32_kernel<32>, grid, kThreadsF32,
                            smem_f32<32>(sk.k_per_split), stream, a,
                            dependent);
  }
}

}  // namespace sg
