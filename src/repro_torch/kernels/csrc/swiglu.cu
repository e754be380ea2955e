// The SwiGLU MLP silu(x @ Wg) * (x @ Wu) @ Wd, written for Hopper (sm_90a).
//
// Replaces the TPU kernel `swiglu_2d` / `_swiglu_kernel` in
// src/repro/kernels/swiglu.py.  Computes what
// repro_torch.kernels.ref.swiglu_ref defines: both products and the silu
// in f32 from x and weights of one type, f32 accumulation, one cast of the
// result to x's type.
//
// What bounds it on an H100: with m rows, 6 m d f flops against 3 d f
// weights read, so few rows (decode) are bound by the weight bytes and
// many rows (prefill, training) by the products.  Two routes, chosen by
// rows in the wrapper (swiglu.py), neither padding the rows:
//
// Few rows (route 0; bf16 m <= 32, stream_gemm.cuh's kMaxRows; f32 m <=
// 8, past which its CUDA-core products lose to route 1): the fused
// decode layer's MLP half, 4 launches — the gate and up products in one
// launch of the weight-streaming product kernels (weights through a
// cp.async ring; bf16 on mma.sync, f32 on the CUDA cores), silu(g) * u,
// the down product, and the sum of its depth slices cast to x's type,
// the last three programmatic dependent launches whose products issue
// their weight ring before griddepcontrol.wait.  The product kernels take
// x in its own type (a template parameter, no staging pass): bf16 x is
// exact as a bf16 operand, one product; the f32 hidden silu(g) * u is
// split into bf16 hi + lo, two products.
//
// Many rows (route 1): two launches of one tiled product kernel
// (tile_kernel), each block a BM x 64 tile of every matrix it multiplies:
//  1. gate and up: the same block accumulates X . Wg and X . Wu over the
//     same (rows, f) tile, applies silu(g) * u to the accumulators in
//     registers and writes the hidden once; it also zeroes the down
//     product's split counters;
//  2. down: hidden . Wd, cast to x's type in the epilogue; a programmatic
//     dependent of launch 1 that issues its first Wd tiles before
//     griddepcontrol.wait.  Where the output tiles would not fill the
//     132 SMs the depth is split across blocks: each writes its f32
//     partial tile, and the last of a tile's blocks to finish (a counter)
//     adds the partials in slice order — a call repeats bit for bit.
// A block is (BM / 32) x WN warps, each 32 rows x 64 / WN columns of
// every matrix on mma.sync m16n8k16 (WN 2; 4 for 64-row f32 blocks,
// whose three products a fragment want more warps in flight); its tiles
// (128-byte rows, 128-byte swizzle) arrive by 16-byte cp.async through a
// 3-deep ring (2 for the 128-row bf16 down blocks, whose hi + lo tiles
// would otherwise leave one block an SM), one barrier a stage.  BM is
// 128, 64 at most 64 rows.  Where launch 1's tiles would not fill the
// 132 SMs, a tile holds 32 columns of each of Wg and Wu (each warp's
// columns half gate, half up) instead of 64 + 64: twice the blocks.
// Rounding: bf16 x and weights are exact bf16 operands.  The f32 hidden
// is not: it is written as bf16 hi + lo (hi = bf16(h), lo = bf16(h -
// hi)), two products in the down launch — rounded once it would miss
// the bf16 tolerance where the output is small beside its row's scale.
// f32 operands are each split into bf16 hi + lo in registers and every
// product is three (hi.hi + hi.lo + lo.hi, f32 sums): ~2^-16 relative,
// inside the f32 tolerance 2e-4 where TF32 or two products are not
// (tests/test_torch_swiglu_model.py); the hidden stays f32.  The f32
// route thus issues 3 x 6 m d f tensor-core flops, the bf16 route
// 4 m d f + 2 x 2 m d f.
//
// The kernels allocate nothing: the wrapper passes out and a workspace
// (swiglu_workspace_bytes).

#include "mlp_blocks.cuh"     // silu * u, the sum of the depth slices
#include "stream_gemm.cuh"    // the weight-streaming products

namespace {

inline long long align256(long long x) { return (x + 255) & ~255ll; }

// ---- few rows: the weight-streaming chain ----------------------------------

struct StreamLayout {
  sg::Split gu, down;
  long long p_g, p_u, act, p_down, total;   // bytes
};

StreamLayout stream_layout(int m, int d, int f) {
  StreamLayout L;
  const int rt = sg::row_tiles(m);
  L.gu = sg::plan(d, f, 2, rt);
  L.down = sg::plan(f, d, 1, rt);
  long long at = 0;
  auto take = [&](long long floats) {
    const long long off = at;
    at = align256(at + floats * 4);
    return off;
  };
  L.p_g = take((long long)L.gu.splits * m * f);
  L.p_u = take((long long)L.gu.splits * m * f);
  L.act = take((long long)m * f);
  L.p_down = take((long long)L.down.splits * m * d);
  L.total = at;
  return L;
}

template <typename T>
cudaError_t stream_route(const T* x, const T* wg, const T* wu, const T* wd,
                         T* out, unsigned char* ws, int m, int d, int f,
                         cudaStream_t stream) {
  const StreamLayout L = stream_layout(m, d, f);
  float* p_g = reinterpret_cast<float*>(ws + L.p_g);
  float* p_u = reinterpret_cast<float*>(ws + L.p_u);
  float* act = reinterpret_cast<float*>(ws + L.act);
  float* p_down = reinterpret_cast<float*>(ws + L.p_down);
  cudaError_t err = sg::launch_product<T>(x, wg, wu, p_g, p_u, m, d, f, 2,
                                          L.gu, stream, false);
  if (err != cudaSuccess) return err;
  const long long nf = (long long)m * f;
  err = launch_dependent(mlp::silu_mul_kernel,
                         dim3(mlp::elementwise_blocks(nf)),
                         dim3(mlp::kThreads), 0, stream, p_g, p_u,
                         L.gu.splits, nf, act);
  if (err != cudaSuccess) return err;
  err = sg::launch_product<T>(act, wd, wd, p_down, p_down, m, f, d, 1,
                              L.down, stream);
  if (err != cudaSuccess) return err;
  const long long nd = (long long)m * d;
  return launch_dependent(mlp::sum_partials_kernel<T>,
                          dim3(mlp::elementwise_blocks(nd)),
                          dim3(mlp::kThreads), 0, stream,
                          static_cast<const float*>(nullptr), p_down,
                          L.down.splits, nd, out);
}

// ---- many rows: the tiled tensor-core products -----------------------------

constexpr int kBN = 64;             // columns of each matrix a block
constexpr int kTargetBlocks = 264;  // ~2 blocks on each of the 132 SMs
constexpr int kSMs = 132;
constexpr uint32_t kTileB = 8192;   // a matrix's tile a stage: 64 bf16 or
                                    // 32 f32 depth rows of 64 columns
// A block's shape: BM rows, WN warps across its 64 columns, a ring of
// STAGES stages.
template <int BM_, int WN_, int STAGES_>
struct Tiling {
  static constexpr int BM = BM_, WN = WN_, kStages = STAGES_;
  static constexpr int kThreads = BM * WN;        // (BM / 32) x WN warps
};
// 64-row f32 blocks (at most 64 rows: too few blocks to fill the card)
// put four warps across the columns: f32's three products a fragment
// want more warps in flight on each SM
constexpr int kWarpsNF32Small = 4;
constexpr int kStages = 3;          // tiles in flight: the ring's depth
constexpr int kStagesDownBf16 = 2;  // 128-row bf16 down blocks (hi + lo
                                    // tiles): two blocks an SM
template <typename T, int BM, int AP>
using TilingFor =
    Tiling<BM, (BM == 64 && sizeof(T) == 4) ? kWarpsNF32Small : 2,
           (BM == 128 && AP == 2) ? kStagesDownBf16 : kStages>;

struct TileArgs {
  const void* a;       // (M, K) of T: x, or the hidden (its hi part)
  const void* a_lo;    // (M, K) bf16: the hidden's lo part (AP 2)
  const void* b0;      // (K, N) of T: Wg or Wd
  const void* b1;      // (K, N) of T: Wu (NMATS 2)
  void* out;           // (M, N) of T: the hidden (hi part), or out
  void* out_lo;        // (M, N) bf16: the hidden's lo part (bf16 gate/up)
  float* part;         // (splits, M, N) f32 partial tiles (splits > 1)
  int* counters;       // a counter per output tile of the down product
  int n_counters;      // zeroed by the gate/up launch
  int M, K, N, k_per_split, splits;
};

__device__ __forceinline__ void split_bf16x2(float2 v, uint32_t& hi,
                                             uint32_t& lo) {
  hi = pack_bf16x2(v.x, v.y);
  const float2 h = unpack_bf16x2(hi);
  lo = pack_bf16x2(v.x - h.x, v.y - h.y);
}

__device__ __forceinline__ float silu(float g) {
  return g / (1.f + expf(-g));
}

// C[mat] = A . B[mat] over the block's depth slice for mat < NMATS.  T is
// the operands' type; bf16 A comes in AP parts (hi, and lo: the hidden),
// each a product.  NMATS 2 writes silu(C[0]) * C[1] (bf16: as hi + lo);
// NMATS 1 writes C[0] in T, or its partial tile.  A warp owns 32 rows x
// kBN / WN columns of every matrix (Tiling).  PAIR (NMATS 2 only): one
// 64-column tile holds 32 columns of each matrix, each warp's columns
// half gate, half up — twice the blocks of a 64 + 64 tile, for rows too
// few to fill the card.  grid: x = column tile, y = row tile, z = depth
// slice.
template <typename T, typename Cfg, int NMATS, int AP, bool PAIR>
__global__ void __launch_bounds__(Cfg::kThreads, 512 / Cfg::kThreads)
tile_kernel(TileArgs p) {
  constexpr int BM = Cfg::BM, WN = Cfg::WN;
  constexpr int kStages = Cfg::kStages;
  constexpr int kThreads = Cfg::kThreads;
  static_assert(!PAIR || NMATS == 2, "pairs are gate and up");
  constexpr int kMats = PAIR ? 1 : NMATS;         // B tiles a stage
  constexpr int kWarpCols = kBN / WN;           // 32 or 16
  constexpr int kNT = kWarpCols / 8;            // 8-column mma tiles
  constexpr bool kF32 = sizeof(T) == 4;
  static_assert(!kF32 || AP == 1, "f32 A is split in registers");
  constexpr int kBK = 128 / sizeof(T);          // depth of a stage
  constexpr uint32_t kTileA = BM * 128;
  constexpr uint32_t kStage = AP * kTileA + kMats * kTileB;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * (PAIR ? kBN / 2 : kBN);   // of each matrix
  const int k_lo = blockIdx.z * p.k_per_split;
  const int k_hi = min(p.K, k_lo + p.k_per_split);
  const int chunks = (k_hi - k_lo + kBK - 1) / kBK;

  if constexpr (NMATS == 2) {
    if (blockIdx.x == 0 && blockIdx.y == 0)
      for (int i = threadIdx.x; i < p.n_counters; i += kThreads)
        p.counters[i] = 0;
  }

  // B tiles of depth chunk c into stage st: bf16 64 rows x 8 chunks, f32
  // 32 rows x 16 chunks in two 128-byte regions of 32 columns; depth past
  // the slice and columns past N read as 0.  PAIR: tile column t of warp
  // slab t / kWarpCols is gate (first half of the slab) or up
  auto load_b = [&](int c, int st) {
    const int k0 = k_lo + c * kBK;
#pragma unroll
    for (int mat = 0; mat < kMats; ++mat) {
      const uint32_t dst = base + st * kStage + AP * kTileA + mat * kTileB;
      for (int e = threadIdx.x; e < 512; e += kThreads) {
        int row, cc;
        uint32_t off;
        if constexpr (kF32) {
          row = e >> 4;
          cc = e & 15;
          off = (cc >> 3) * (kBK * 128) + swz128(row, cc & 7);
        } else {
          row = e >> 3;
          cc = e & 7;
          off = swz128(row, cc);
        }
        const int k = k0 + row;
        int t = cc * (16 / (int)sizeof(T)), which = mat;
        if constexpr (PAIR) {
          constexpr int kHalf = kWarpCols / 2;
          which = t % kWarpCols / kHalf;
          t = t / kWarpCols * kHalf + t % kHalf;
        }
        const T* B = static_cast<const T*>(which ? p.b1 : p.b0);
        const int col = c0 + t;
        const bool ok = k < k_hi && col < p.N;
        cp_async16_zfill(dst + off, ok ? B + (size_t)k * p.N + col : B,
                         ok ? 16 : 0);
      }
    }
  };
  // A tiles: BM rows x 8 chunks a part; rows past M and depth past the
  // slice are 0
  auto load_a = [&](int c, int st) {
    const int k0 = k_lo + c * kBK;
#pragma unroll
    for (int part = 0; part < AP; ++part) {
      const T* A = static_cast<const T*>(part ? p.a_lo : p.a);
      const uint32_t dst = base + st * kStage + part * kTileA;
      for (int e = threadIdx.x; e < BM * 8; e += kThreads) {
        const int row = e >> 3, ch = e & 7;
        const int k = k0 + ch * (16 / (int)sizeof(T));
        const bool ok = r0 + row < p.M && k < k_hi;
        cp_async16_zfill(dst + swz128(row, ch),
                         ok ? A + (size_t)(r0 + row) * p.K + k : A,
                         ok ? 16 : 0);
      }
    }
  };

  // the weights first: they do not depend on the launch before, so the
  // down product's ring fills while the gate/up launch finishes
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st)
    if (st < chunks) load_b(st, st);
  grid_launch_dependents();
  grid_dependency_wait();          // the hidden is written
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < chunks) load_a(st, st);
    cp_async_commit();
  }

  float acc[kMats][2][kNT][4];
#pragma unroll
  for (int mat = 0; mat < kMats; ++mat)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mat][mt][nt][j] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();               // chunk c in place; stage c - 1 free
    const int nc = c + kStages - 1;
    if (nc < chunks) {
      load_b(nc, nc % kStages);
      load_a(nc, nc % kStages);
    }
    cp_async_commit();
    const uint32_t sa = (c % kStages) * kStage;   // offsets in smem
    const uint32_t sb = sa + AP * kTileA;
    if constexpr (!kF32) {
#pragma unroll
      for (int k16 = 0; k16 < kBK / 16; ++k16) {
        uint32_t a[AP][2][4];
#pragma unroll
        for (int part = 0; part < AP; ++part)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldmatrix_x4(a[part][mt],
                        base + sa + part * kTileA +
                            swz128(wm * 32 + mt * 16 + (lane & 15),
                                   k16 * 2 + (lane >> 4)));
#pragma unroll
        for (int mat = 0; mat < kMats; ++mat)
#pragma unroll
          for (int np = 0; np < kNT / 2; ++np) {
            uint32_t b[4];
            ldmatrix_x4_trans(
                b, base + sb + mat * kTileB +
                       swz128(k16 * 16 + (lane & 15),
                              wn * kWarpCols / 8 + np * 2 + (lane >> 4)));
#pragma unroll
            for (int part = AP - 1; part >= 0; --part)
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_bf16_16816(acc[mat][mt][2 * np], a[part][mt], b[0],
                               b[1]);
                mma_bf16_16816(acc[mat][mt][2 * np + 1], a[part][mt], b[2],
                               b[3]);
              }
          }
      }
    } else {
#pragma unroll
      for (int k16 = 0; k16 < kBK / 16; ++k16) {
        // A (g, 2q..), (g + 8, 2q..), (g, 2q + 8..), (g + 8, 2q + 8..)
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = wm * 32 + mt * 16 + g + (i & 1) * 8;
            const int k = k16 * 16 + 2 * q + (i >> 1) * 8;
            const float2 v = *reinterpret_cast<const float2*>(
                smem + sa + swz128(row, k >> 2) + (k & 3) * 4);
            split_bf16x2(v, ah[mt][i], al[mt][i]);
          }
        // B (2q..2q+1, g), (2q+8..2q+9, g) of column n (region n / 32)
        const int k = k16 * 16 + 2 * q;
        uint32_t bh[kMats][kNT][2], bl[kMats][kNT][2];
#pragma unroll
        for (int mat = 0; mat < kMats; ++mat)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const int n = wn * kWarpCols + nt * 8 + g;
            const unsigned char* col = smem + sb + mat * kTileB +
                                       (n >> 5) * (kBK * 128) +
                                       (n & 3) * 4;
            const int ch = (n & 31) >> 2;
            auto w_at = [&](int kk) {
              return *reinterpret_cast<const float*>(col + swz128(kk, ch));
            };
            split_bf16x2(make_float2(w_at(k), w_at(k + 1)), bh[mat][nt][0],
                         bl[mat][nt][0]);
            split_bf16x2(make_float2(w_at(k + 8), w_at(k + 9)),
                         bh[mat][nt][1], bl[mat][nt][1]);
          }
        // hi.lo, lo.hi, then hi.hi: every pass over independent sums
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int mat = 0; mat < kMats; ++mat)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int nt = 0; nt < kNT; ++nt) {
                const uint32_t(&av)[4] = term == 1 ? al[mt] : ah[mt];
                const uint32_t(&bv)[2] =
                    term == 0 ? bl[mat][nt] : bh[mat][nt];
                mma_bf16_16816(acc[mat][mt][nt], av, bv[0], bv[1]);
              }
      }
    }
  }
  cp_async_wait<0>();
  // D (g, 2q..2q+1) and (g + 8, 2q..2q+1) of each 16 x 8 tile; PAIR:
  // the gate's kNT / 2 tiles, each beside its up tile
  constexpr int kOutNT = PAIR ? kNT / 2 : kNT;
  constexpr int kOutCols = PAIR ? kWarpCols / 2 : kWarpCols;
  auto each = [&](auto&& fn) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kOutNT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + wm * 32 + mt * 16 + g + h * 8;
          const int col = c0 + wn * kOutCols + nt * 8 + 2 * q;
          if (row < p.M && col < p.N)
            fn((size_t)row * p.N + col, mt, nt, 2 * h);
        }
  };
  if constexpr (NMATS == 2) {
    each([&](size_t at, int mt, int nt, int j) {
      const float* gv = acc[0][mt][nt];
      const float* uv;
      if constexpr (PAIR)
        uv = acc[0][mt][nt + kOutNT];
      else
        uv = acc[kMats - 1][mt][nt];
      const float h0 = silu(gv[j]) * uv[j];
      const float h1 = silu(gv[j + 1]) * uv[j + 1];
      if constexpr (kF32) {
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) =
            make_float2(h0, h1);
      } else {
        uint32_t hi, lo;
        split_bf16x2(make_float2(h0, h1), hi, lo);
        *reinterpret_cast<uint32_t*>(static_cast<T*>(p.out) + at) = hi;
        *reinterpret_cast<uint32_t*>(static_cast<T*>(p.out_lo) + at) = lo;
      }
    });
    return;
  }
  auto store = [&](T* o, size_t at, float v0, float v1) {
    if constexpr (kF32)
      *reinterpret_cast<float2*>(o + at) = make_float2(v0, v1);
    else
      *reinterpret_cast<uint32_t*>(o + at) = pack_bf16x2(v0, v1);
  };
  T* out = static_cast<T*>(p.out);
  if (p.splits == 1) {
    each([&](size_t at, int mt, int nt, int j) {
      store(out, at, acc[0][mt][nt][j], acc[0][mt][nt][j + 1]);
    });
    return;
  }
  // split depth: this slice's partial tile, then the tile's last block
  // adds the slices in order
  float* P = p.part + (size_t)blockIdx.z * p.M * p.N;
  each([&](size_t at, int mt, int nt, int j) {
    *reinterpret_cast<float2*>(P + at) =
        make_float2(acc[0][mt][nt][j], acc[0][mt][nt][j + 1]);
  });
  __shared__ int last;
  __threadfence();                 // the partial tile is visible ...
  __syncthreads();
  if (threadIdx.x == 0)            // ... before the count says so
    last = atomicAdd(&p.counters[blockIdx.y * gridDim.x + blockIdx.x], 1) ==
           p.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int kPer = BM * kBN / 4 / kThreads;  // float4s a thread
  float4 v[kPer];
  size_t at[kPer];
  bool in[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int row = r0 + e / (kBN / 4);
    const int col = c0 + (e % (kBN / 4)) * 4;
    in[i] = row < p.M && col < p.N;
    at[i] = (size_t)row * p.N + col;
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int s = 0; s < p.splits; ++s) {       // each slice's loads at once
    const float* Ps = p.part + (size_t)s * p.M * p.N;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (in[i]) {
        const float4 t = __ldcg(reinterpret_cast<const float4*>(Ps + at[i]));
        v[i].x += t.x;
        v[i].y += t.y;
        v[i].z += t.z;
        v[i].w += t.w;
      }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (in[i]) {
      store(out, at[i], v[i].x, v[i].y);
      store(out, at[i] + 2, v[i].z, v[i].w);
    }
}

template <typename T, int BM, int NMATS, int AP, bool PAIR>
cudaError_t launch_tile(const TileArgs& a, bool dependent,
                        cudaStream_t stream) {
  using Cfg = TilingFor<T, BM, AP>;
  constexpr int kMats = PAIR ? 1 : NMATS;
  constexpr size_t smem = Cfg::kStages * (AP * BM * 128 + kMats * kTileB);
  constexpr int kThreads = Cfg::kThreads;
  constexpr int kCols = PAIR ? kBN / 2 : kBN;     // of each matrix
  auto kernel = tile_kernel<T, Cfg, NMATS, AP, PAIR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + kCols - 1) / kCols, (a.M + BM - 1) / BM, a.splits);
  if (!dependent) {
    kernel<<<grid, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  return launch_dependent(kernel, grid, dim3(kThreads), smem, stream, a);
}

int tiles(int M, int N, int bm) {
  return ((M + bm - 1) / bm) * ((N + kBN - 1) / kBN);
}

// 128-row blocks, 64 at most 64 rows (where a 128-row tile would be half
// padding); a 64-row block's warps each hold 32 real rows
int pick_bm(int M) { return M > 64 ? 128 : 64; }

struct TiledLayout {
  int bm_gu, bm_down, splits, k_per_split, n_counters;
  bool pair;                        // gate and up as pairs in one tile
  long long hidden, hidden_lo, part, counters, total;   // bytes
};

TiledLayout tiled_layout(int m, int d, int f, int itemsize) {
  TiledLayout L;
  L.bm_gu = pick_bm(m);
  L.bm_down = pick_bm(m);
  L.pair = tiles(m, f, L.bm_gu) < kSMs;   // twice the blocks
  L.n_counters = tiles(m, d, L.bm_down);
  const int bk = 128 / itemsize;
  const int chunks = (f + bk - 1) / bk;
  int s = L.n_counters >= kSMs ? 1 : kTargetBlocks / L.n_counters;
  s = s < 1 ? 1 : (s > chunks ? chunks : s);
  L.k_per_split = ((chunks + s - 1) / s) * bk;
  L.splits = (f + L.k_per_split - 1) / L.k_per_split;
  long long at = 0;
  auto take = [&](long long bytes) {
    const long long off = at;
    at = align256(at + bytes);
    return off;
  };
  L.hidden = take((long long)m * f * itemsize);
  L.hidden_lo = take(itemsize == 2 ? (long long)m * f * 2 : 0);
  L.part = take(L.splits > 1 ? (long long)L.splits * m * d * 4 : 0);
  L.counters = take((long long)L.n_counters * 4);
  L.total = at;
  return L;
}

template <typename T, int NMATS, int AP>
cudaError_t launch_bm(int bm, bool pair, const TileArgs& a, bool dependent,
                      cudaStream_t stream) {
  if constexpr (NMATS == 2) {
    if (pair)
      return bm == 128
                 ? launch_tile<T, 128, 2, AP, true>(a, dependent, stream)
                 : launch_tile<T, 64, 2, AP, true>(a, dependent, stream);
  }
  return bm == 128 ? launch_tile<T, 128, NMATS, AP, false>(a, dependent,
                                                           stream)
                   : launch_tile<T, 64, NMATS, AP, false>(a, dependent,
                                                          stream);
}

template <typename T>
cudaError_t tiled_route(const T* x, const T* wg, const T* wu, const T* wd,
                        T* out, unsigned char* ws, int m, int d, int f,
                        cudaStream_t stream) {
  constexpr int kHiddenParts = sizeof(T) == 4 ? 1 : 2;
  const TiledLayout L = tiled_layout(m, d, f, sizeof(T));
  int* counters = reinterpret_cast<int*>(ws + L.counters);
  TileArgs a = {};
  a.a = x;
  a.b0 = wg;
  a.b1 = wu;
  a.out = ws + L.hidden;
  a.out_lo = ws + L.hidden_lo;
  a.counters = counters;
  a.n_counters = L.n_counters;
  a.M = m;
  a.K = d;
  a.N = f;
  a.k_per_split = d;
  a.splits = 1;
  cudaError_t err = launch_bm<T, 2, 1>(L.bm_gu, L.pair, a, false, stream);
  if (err != cudaSuccess) return err;
  TileArgs b = {};
  b.a = ws + L.hidden;
  b.a_lo = ws + L.hidden_lo;
  b.b0 = wd;
  b.b1 = wd;
  b.out = out;
  b.part = reinterpret_cast<float*>(ws + L.part);
  b.counters = counters;
  b.M = m;
  b.K = f;
  b.N = d;
  b.k_per_split = L.k_per_split;
  b.splits = L.splits;
  return launch_bm<T, 1, kHiddenParts>(L.bm_down, false, b, true, stream);
}

}  // namespace

// Bytes of the workspace one call of `route` needs (dtype codes: 0 =
// float32, 1 = bfloat16).
extern "C" long long swiglu_workspace_bytes(int m, int d, int f, int dtype,
                                            int route) {
  if (route == 0) return stream_layout(m, d, f).total;
  return tiled_layout(m, d, f, dtype == 0 ? 4 : 2).total;
}

// route 0: the weight-streaming chain (few rows), 1: the tiled products
// (many rows); dtype codes: 0 = float32, 1 = bfloat16 (x, the weights and
// out share it).  Returns the first failing launch's cudaError_t (0 on
// success).
extern "C" int swiglu_fwd(const void* x, const void* wg, const void* wu,
                          const void* wd, void* out, void* workspace, int m,
                          int d, int f, int dtype, int route, void* stream) {
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define SWIGLU_ARGS(T)                                                     \
  static_cast<const T*>(x), static_cast<const T*>(wg),                     \
      static_cast<const T*>(wu), static_cast<const T*>(wd),                \
      static_cast<T*>(out), ws, m, d, f, s
  if (route == 0 && dtype == 0) return stream_route<float>(SWIGLU_ARGS(float));
  if (route == 0 && dtype == 1) return stream_route<bf16>(SWIGLU_ARGS(bf16));
  if (route == 1 && dtype == 0) return tiled_route<float>(SWIGLU_ARGS(float));
  if (route == 1 && dtype == 1) return tiled_route<bf16>(SWIGLU_ARGS(bf16));
#undef SWIGLU_ARGS
  return (int)cudaErrorInvalidValue;
}
