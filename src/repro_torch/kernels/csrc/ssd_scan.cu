// Mamba2 SSD chunked scan ("state-space duality": quadratic within a chunk,
// a linear recurrence across chunks), written for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_scan_bshpn` / `_ssd_kernel` in
// src/repro/kernels/ssd_scan.py.  Computes what the port's plain chunked
// version (repro_torch.kernels.ref.ssd_chunked_ref) defines, per (batch,
// head) and chunk of Q steps, with a_cum the inclusive cumsum of log_a over
// the chunk and the (p, n) f32 state S carried from chunk to chunk:
//
//   y[i]  = sum_{j <= i} (C_i . B_j) exp(a_cum[i] - a_cum[j]) x[j]
//         + exp(a_cum[i]) (C_i . S^T)
//   S'    = exp(a_tot) S + sum_j (x[j] exp(a_tot - a_cum[j]))^T B_j
//
// What bounds it on an H100: at zamba2's shape (Q 256, p = n = 64, B/C
// broadcast over 64 heads) the bytes — x read and y written once dwarf
// the Q^2 (n + p) + 2 Q p n multiply-adds per (batch, head, chunk) at the
// bf16 tensor-core rate; at the mLSTM's p = n = 512 the products.
//
// Both entries keep the TPU kernel's order: one block owns one (batch,
// head) and one 64-wide tile of p, walks the chunks in order and keeps its
// state tile (64, n) in f32 shared memory for the whole sequence (for p =
// n = 512, 128 KB).  The TPU kernel keeps the (Q, Q) decay matrix whole;
// here it is formed for each score tile as it is used, masked BEFORE the
// exp (the i < j half would overflow).
//
// bf16 (ssd_tc_kernel): every product on the tensor cores, mma.sync
// m16n8k16 with f32 sums, 8 warps.
// - Loads: a chunk's x (Q x 64 of the p tile), C and B (Q x 64 of an
//   n slice) arrive as 16-byte cp.async copies into 128-byte-swizzled bf16
//   tiles, read through the strides (x rows are h*p apart; broadcast B/C
//   have head stride 0 and are read as they are).  With one n slice (n <=
//   64) the tiles of chunk ci + 1 load into the second stage of a
//   two-stage ring while chunk ci computes; C is loaded once per chunk.
// - Rounding: x, B and C are bf16 already, so C.B^T is exact up to the
//   order of its f32 sums.  The operands the kernel forms in f32 — the
//   decayed scores, the carried state, x scaled by the state weights — are
//   each split into bf16 hi + lo (hi = bf16(v), lo = bf16(v - hi), ~2^-17
//   relative) and feed two products.  Rounded once to bf16 (as flash
//   attention's p) they would err ~2^-9 relative each, which a plain
//   model of the kernel puts outside the 2e-2 bound at the decay edge
//   log_a = 0 (where every score of the chunk adds up) and at the mLSTM
//   shape; with hi + lo it stays within 1e-3 of the oracle there
//   (tests/test_torch_ssd_scan.py).  The state itself stays f32 in shared
//   memory, so rounding never compounds across chunks.
// - Outputs: a warp owns query tiles t and 15 - t of 16 rows (the causal
//   halves balance).  C.S^T takes its A fragments from the C tile and its
//   B fragments from the f32 state as it is read.  C.B^T runs per 16-key
//   tile at or below the diagonal; the decay exp(a_cum[i] - a_cum[j]) and
//   the mask are applied to the accumulator fragments in registers, and
//   the scores go straight back in as the A operands of scores.x, as FA2
//   does.
// - State: S' = exp(a_tot) S + (x w)^T B as a product over the chunk's
//   rows, x scaled by w_j = exp(a_tot - a_cum[j]) in the A fragments; the
//   f32 state is updated in place.
// - n > 64 (the mLSTM): the n slices are walked in turn inside the block
//   (one stage: the state takes 128 KB); the score and state terms are
//   linear in the slices, so y sums each slice's terms in registers.
//
// f32 (ssd_f32_kernel): the products stay on the CUDA cores (the JAX
// test's 2e-4 rules out bf16 and TF32), 64 x 64 output tiles over 256
// threads, 4 x 4 a thread, from f32 tiles with rows padded to 65 floats.
// Tiles load as 16-byte vectors where the strides allow; with one n slice
// the C tile loads once per query tile, and each key tile's B and x tiles
// are fetched into registers while the tile before computes (a two-stage
// ring: registers, then shared memory).

#include "common.cuh"
#include "hopper.cuh"

namespace {

struct Strides {                  // element strides (b, s, h, last)
  long long x[4], a[3], b[4], c[4];
};

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// a_cum = the inclusive cumsum of `la` over [0, len), by one warp: each
// lane sums a run, then a shuffle scan adds the runs before it
__device__ __forceinline__ void warp_cumsum(const float* la, float* a_cum,
                                            int len, int lane) {
  const int per = ceil_div(len, 32);
  const int lo = min(lane * per, len), hi = min(lo + per, len);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += la[i];
    a_cum[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const float excl = incl - run;
  for (int i = lo; i < hi; ++i) a_cum[i] += excl;
  __syncwarp();
}

// ---- bf16: tensor cores --------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 256;
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kW = 64;            // p tile and n slice: one 128-byte bf16 row
constexpr int kMaxChunkTc = 256;  // query tiles a warp pair covers: 16 x 16

// a block's shared memory, in bytes: `stages` x (x, C, B tiles of qp
// 128-byte rows, and with one n slice the chunk's log decays), the f32
// state (64 x 64 ns), a_cum, the state weights w (with several n slices
// the log decays load there)
struct TcSmem {
  int qp, ns, stages;
  size_t tiles, stage, state, a_cum, w, total;
};

__host__ __device__ inline TcSmem tc_smem(int chunk, int n) {
  TcSmem m;
  m.qp = ceil_div(chunk, 16) * 16;
  m.ns = ceil_div(n, kW);
  m.stages = m.ns > 1 ? 1 : 2;
  m.tiles = (size_t)3 * m.qp * 128;
  m.stage = m.tiles +
            (m.ns > 1 ? 0 : ((size_t)m.qp * 4 + 127) / 128 * 128);
  m.state = (size_t)m.stages * m.stage;
  m.a_cum = m.state + (size_t)kW * m.ns * kW * 4;
  m.w = m.a_cum + (size_t)m.qp * 4;
  m.total = m.w + (size_t)m.qp * 4;
  return m;
}

// float offset of state element (row, col) in rows of `width` floats:
// bits 3-4 of the column are XORed with the row, so the float2 reads and
// writes of a half-warp (rows g..g+3, columns 2q..) hit distinct banks
__device__ __forceinline__ int state_at(int row, int col, int width) {
  return row * width + (col ^ ((row & 3) << 3));
}

// two f32 values as bf16x2 registers hi and lo, hi + lo carrying them to
// ~2^-17 relative: an operand the kernel forms in f32 (scores, the state,
// x w) feeds two products, one of each part
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  hi = pack_bf16x2(a, b);
  const float2 h = unpack_bf16x2(hi);
  lo = pack_bf16x2(a - h.x, b - h.y);
}

template <bool kBig>
__global__ void __launch_bounds__(kTcThreads, 1)
ssd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ log_a,
              const bf16* __restrict__ bm, const bf16* __restrict__ cm,
              bf16* __restrict__ y, Strides sd, int h, int s, int p, int n,
              int chunk) {
  constexpr int kAcc = kBig ? 2 : 1;   // query tiles a warp keeps summing
  extern __shared__ __align__(128) unsigned char smem[];
  const TcSmem L = tc_smem(chunk, n);
  const int qp = L.qp, mt = qp / 16, ns_count = L.ns;
  const int width = ns_count * kW;     // state row, floats
  float* state = reinterpret_cast<float*>(smem + L.state);
  float* a_cum = reinterpret_cast<float*>(smem + L.a_cum);
  float* w = reinterpret_cast<float*>(smem + L.w);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;   // mma fragment coordinates
  const int mj = lane >> 3, mi = lane & 7; // ldmatrix matrix and row
  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh % h;
  const int p0 = blockIdx.y * kW;
  const bf16* xb = x + bi * sd.x[0] + hi * sd.x[2];
  const float* ab = log_a + bi * sd.a[0] + hi * sd.a[2];
  const bf16* bb = bm + bi * sd.b[0] + hi * sd.b[2];
  const bf16* cb = cm + bi * sd.c[0] + hi * sd.c[2];

  auto tile = [&](int st, int which) {     // 0: x, 1: C, 2: B
    return smem_u32(smem + st * L.stage + (size_t)which * qp * 128);
  };
  auto decays = [&](int st) {              // the chunk's log decays
    return kBig ? w
                : reinterpret_cast<float*>(smem + st * L.stage + L.tiles);
  };
  // the copies of item `it` (chunk it / ns_count, n slice it % ns_count)
  // into stage st; rows past the chunk and columns past p or n read 0
  auto issue = [&](int it, int st) {
    const int ci = it / ns_count, ns = it - ci * ns_count;
    const long long t0 = (long long)ci * chunk;
    for (int e = tid; e < qp * 8; e += kTcThreads) {
      const int r = e >> 3, ch = e & 7;
      const int col = ns * kW + ch * 8;
      const bool ok = r < chunk && col < n;
      const uint32_t off = swz128(r, ch);
      cp_async16_zfill(tile(st, 1) + off,
                       ok ? cb + (t0 + r) * sd.c[1] + col : cb, ok ? 16 : 0);
      cp_async16_zfill(tile(st, 2) + off,
                       ok ? bb + (t0 + r) * sd.b[1] + col : bb, ok ? 16 : 0);
    }
    if (ns == 0) {
      for (int e = tid; e < qp * 8; e += kTcThreads) {
        const int r = e >> 3, ch = e & 7;
        const int col = p0 + ch * 8;
        const bool ok = r < chunk && col < p;
        cp_async16_zfill(tile(st, 0) + swz128(r, ch),
                         ok ? xb + (t0 + r) * sd.x[1] + col : xb,
                         ok ? 16 : 0);
      }
      float* la = decays(st);
      for (int r = tid; r < qp; r += kTcThreads)
        cp_async4_zfill(smem_u32(la + r),
                        r < chunk ? ab + (t0 + r) * sd.a[1] : ab,
                        r < chunk ? 4 : 0);
    }
  };

  for (int e = tid; e < kW * width; e += kTcThreads) state[e] = 0.f;
  float acc_d[kAcc][8][4], acc_o[kAcc][8][4];   // intra and state terms

  const int items = (s / chunk) * ns_count;
  issue(0, 0);
  cp_async_commit();
  for (int it = 0; it < items; ++it) {
    const int ci = it / ns_count, ns = it - ci * ns_count;
    const int st = kBig ? 0 : (it & 1);
    if constexpr (kBig) {
      cp_async_wait<0>();
    } else {
      if (it + 1 < items) issue(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    }
    __syncthreads();                       // item it's tiles in place
    if (ns == 0) {                         // a_cum and w of the chunk
      if (warp == 0) {
        warp_cumsum(decays(st), a_cum, qp, lane);  // rows past the chunk
        const float a_tot = a_cum[chunk - 1];      // add 0: a_cum = a_tot
        for (int j = lane; j < qp; j += 32) w[j] = expf(a_tot - a_cum[j]);
      }
      __syncthreads();
    }
    const uint32_t tX = tile(st, 0), tC = tile(st, 1), tB = tile(st, 2);
    const int n0 = ns * kW;

    // ---- outputs of the warp's query tiles --------------------------------
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = u == 0 ? warp : 2 * kTcWarps - 1 - warp;
      if (t >= mt) continue;               // uniform in the warp
      float(&ad)[8][4] = acc_d[kBig ? u : 0];
      float(&ao)[8][4] = acc_o[kBig ? u : 0];
      if (!kBig || ns == 0) {
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) ad[a][b] = ao[a][b] = 0.f;
      }
      const int i0 = t * 16;
      // C rows i0..i0+15 over the slice: A fragments of 4 depth steps
      uint32_t cf[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        ldmatrix_x4(cf[k], tC + swz128(i0 + (mj & 1) * 8 + mi,
                                       k * 2 + (mj >> 1)));
      // state term: C . S^T, the f32 state split into bf16 hi + lo as it
      // is read
#pragma unroll
      for (int pn = 0; pn < 8; ++pn) {
        const int row = pn * 8 + g;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int col = n0 + k * 16 + 2 * q;
          const float2 s0 = *reinterpret_cast<const float2*>(
              state + state_at(row, col, width));
          const float2 s1 = *reinterpret_cast<const float2*>(
              state + state_at(row, col + 8, width));
          uint32_t h0, l0, h1, l1;
          split_bf16x2(s0.x, s0.y, h0, l0);
          split_bf16x2(s1.x, s1.y, h1, l1);
          mma_bf16_16816(ao[pn], cf[k], h0, h1);
          mma_bf16_16816(ao[pn], cf[k], l0, l1);
        }
      }
      // intra-chunk term over the key tiles at or below the diagonal
      const float ai0 = a_cum[i0 + g], ai1 = a_cum[i0 + g + 8];
      for (int kt = 0; kt <= t; ++kt) {
        const int j0 = kt * 16;
        float sc[2][4] = {};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint32_t bf[4];
          ldmatrix_x4(bf, tB + swz128(j0 + (mj >> 1) * 8 + mi,
                                      k * 2 + (mj & 1)));
          mma_bf16_16816(sc[0], cf[k], bf[0], bf[1]);
          mma_bf16_16816(sc[1], cf[k], bf[2], bf[3]);
        }
        // decay, masked before the exp: element (row i, key j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + g + (e >> 1) * 8;
            const int j = j0 + hh * 8 + 2 * q + (e & 1);
            const float ai = (e >> 1) ? ai1 : ai0;
            sc[hh][e] *= __expf(i >= j ? ai - a_cum[j] : -1e30f);
          }
        }
        // the scores, split into bf16 hi + lo, as the A operands of
        // scores . x
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16x2(sc[r >> 1][(r & 1) * 2], sc[r >> 1][(r & 1) * 2 + 1],
                       ph[r], pl[r]);
#pragma unroll
        for (int pc = 0; pc < 4; ++pc) {
          uint32_t xf[4];
          ldmatrix_x4_trans(xf, tX + swz128(j0 + (mj & 1) * 8 + mi,
                                            pc * 2 + (mj >> 1)));
          mma_bf16_16816(ad[2 * pc], ph, xf[0], xf[1]);
          mma_bf16_16816(ad[2 * pc], pl, xf[0], xf[1]);
          mma_bf16_16816(ad[2 * pc + 1], ph, xf[2], xf[3]);
          mma_bf16_16816(ad[2 * pc + 1], pl, xf[2], xf[3]);
        }
      }
      if (ns == ns_count - 1) {            // y = intra + exp(a_cum) state
        const float e0 = expf(ai0), e1 = expf(ai1);
        const long long t0 = (long long)ci * chunk;
#pragma unroll
        for (int pn = 0; pn < 8; ++pn) {
          const int col = p0 + pn * 8 + 2 * q;
          if (col >= p) continue;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = i0 + g + hr * 8;
            if (i >= chunk) continue;
            const float e = hr ? e1 : e0;
            bf16* yr = y + (((long long)bi * s + t0 + i) * h + hi) * p + col;
            *reinterpret_cast<uint32_t*>(yr) =
                pack_bf16x2(ad[pn][2 * hr] + e * ao[pn][2 * hr],
                            ad[pn][2 * hr + 1] + e * ao[pn][2 * hr + 1]);
          }
        }
      }
    }
    __syncthreads();                       // every warp has read S

    // ---- state update of the slice: S = exp(a_tot) S + (x w)^T B ---------
    {
      const int m0 = (warp & 3) * 16;      // the warp's 16 state rows (p)
      const int nb = (warp >> 2) * 32;     // ... and 32 state columns (n)
      float su[4][4] = {};
      for (int kk = 0; kk < mt; ++kk) {
        const int j0 = kk * 16;
        // A = (x w)^T: matrices (rows j0.., p m0..), (j0.., m0+8..),
        // (j0+8.., m0..), (j0+8.., m0+8..), transposed, then scaled by w
        // in f32 and split into bf16 hi + lo
        uint32_t xf[4], ah[4], al[4];
        ldmatrix_x4_trans(xf, tX + swz128(j0 + (mj >> 1) * 8 + mi,
                                          m0 / 8 + (mj & 1)));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = j0 + (r >> 1) * 8 + 2 * q;
          const float2 v = unpack_bf16x2(xf[r]);
          split_bf16x2(v.x * w[j], v.y * w[j + 1], ah[r], al[r]);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, tB + swz128(j0 + (mj & 1) * 8 + mi,
                                            nb / 8 + hh * 2 + (mj >> 1)));
          mma_bf16_16816(su[2 * hh], ah, bf[0], bf[1]);
          mma_bf16_16816(su[2 * hh], al, bf[0], bf[1]);
          mma_bf16_16816(su[2 * hh + 1], ah, bf[2], bf[3]);
          mma_bf16_16816(su[2 * hh + 1], al, bf[2], bf[3]);
        }
      }
      const float g_tot = expf(a_cum[chunk - 1]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + nb + nt * 8 + 2 * q;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float2* sp = reinterpret_cast<float2*>(
              state + state_at(m0 + g + hr * 8, col, width));
          float2 v = *sp;
          v.x = g_tot * v.x + su[nt][2 * hr];
          v.y = g_tot * v.y + su[nt][2 * hr + 1];
          *sp = v;
        }
      }
    }
    __syncthreads();                       // stage st and the state done
    if (kBig && it + 1 < items) {
      issue(it + 1, 0);
      cp_async_commit();
    }
  }
}

// ---- f32: CUDA cores -----------------------------------------------------

constexpr int kThreads = 256;
constexpr int kT = 64;            // tile edge: query rows, key rows, p, n
constexpr int kPad = kT + 1;      // padded row stride of a shared tile

// dynamic shared memory (floats): a_cum, state, four 64 x 65 tiles
__host__ __device__ inline size_t smem_floats(int chunk, int n) {
  return (size_t)ceil_div(chunk, 4) * 4 + (size_t)kT * (n + 1)
      + 4 * (size_t)kT * kPad;
}

// A 64 x 64 tile of a (rows, last) operand in registers: thread tid holds
// rows tid / 16 + 16 k, columns 4 (tid % 16) .. + 3 (k = 0..3), zero
// outside [t_lo, t_hi) x [c_lo, c_hi); a 16-byte load where the columns
// are contiguous and aligned (`vec`), else four scalar ones.
struct TileRegs {
  float4 v[4];
};

__device__ __forceinline__ TileRegs fetch_tile(const float* base,
                                               long long s_t, long long s_c,
                                               int t_lo, int t_hi, int c_lo,
                                               int c_hi, bool vec) {
  TileRegs out;
  const int c = c_lo + (threadIdx.x % 16) * 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = t_lo + threadIdx.x / 16 + 16 * k;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < t_hi) {
      const float* row = base + t * s_t;
      if (vec && c + 3 < c_hi) {
        v = *reinterpret_cast<const float4*>(row + c);
      } else {
        if (c < c_hi) v.x = row[c * s_c];
        if (c + 1 < c_hi) v.y = row[(c + 1) * s_c];
        if (c + 2 < c_hi) v.z = row[(c + 2) * s_c];
        if (c + 3 < c_hi) v.w = row[(c + 3) * s_c];
      }
    }
    out.v[k] = v;
  }
  return out;
}

// the tile into shared memory (rows of kPad floats), each row optionally
// scaled by row_scale[row]
__device__ __forceinline__ void store_tile(float* dst, const TileRegs& r,
                                           const float* row_scale) {
  const int c = (threadIdx.x % 16) * 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = threadIdx.x / 16 + 16 * k;
    const float g = row_scale != nullptr ? row_scale[t] : 1.f;
    float* d = dst + t * kPad + c;
    d[0] = r.v[k].x * g;
    d[1] = r.v[k].y * g;
    d[2] = r.v[k].z * g;
    d[3] = r.v[k].w * g;
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_f32_kernel(const float* __restrict__ x, const float* __restrict__ log_a,
               const float* __restrict__ bm, const float* __restrict__ cm,
               float* __restrict__ y, Strides st, int h, int s, int p, int n,
               int chunk, bool vec_x, bool vec_b, bool vec_c) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* a_cum = reinterpret_cast<float*>(smem);         // (chunk,)
  float* state = a_cum + ceil_div(chunk, 4) * 4;         // (64, n + 1)
  float* sS = state + (size_t)kT * (n + 1);              // scores (i, j)
  float* sA = sS + kT * kPad;                            // C rows (i, n)
  float* sB = sA + kT * kPad;                            // B rows (j, n)
  float* sX = sB + kT * kPad;                            // x rows (j, p)

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh % h;
  const int p0 = blockIdx.y * kT;
  const bool one_slice = n <= kT;       // C loads once per query tile

  const float* xb = x + bi * st.x[0] + hi * st.x[2];
  const float* ab = log_a + bi * st.a[0] + hi * st.a[2];
  const float* bb = bm + bi * st.b[0] + hi * st.b[2];
  const float* cb = cm + bi * st.c[0] + hi * st.c[2];

  for (int e = tid; e < kT * (n + 1); e += kThreads) state[e] = 0.f;

  const int nc = s / chunk;
  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * chunk;
    const float* xc = xb + (long long)t0 * st.x[1];
    const float* bc = bb + (long long)t0 * st.b[1];
    const float* cc = cb + (long long)t0 * st.c[1];
    // --- a_cum: inclusive cumsum of the chunk's log decays -------------
    for (int i = tid; i < chunk; i += kThreads)
      a_cum[i] = ab[(long long)(t0 + i) * st.a[1]];
    __syncthreads();
    if (tid < 32) warp_cumsum(a_cum, a_cum, chunk, tid);
    __syncthreads();
    const float a_tot = a_cum[chunk - 1];

    // --- outputs, 64 query rows at a time ---------------------------------
    for (int q0 = 0; q0 < chunk; q0 += kT) {
      float acc[4][4] = {};
      // carried-state term: exp(a_cum[i]) * C_i . S^T
      for (int n0 = 0; n0 < n; n0 += kT) {
        __syncthreads();
        store_tile(sA, fetch_tile(cc, st.c[1], st.c[3], q0, chunk, n0, n,
                                  vec_c), nullptr);
        __syncthreads();
        const int kmax = min(kT, n - n0);
        for (int k = 0; k < kmax; ++k) {
          float av[4], sv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) av[r] = sA[(ty + 16 * r) * kPad + k];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            sv[c] = state[(tx + 16 * c) * (n + 1) + n0 + k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] += av[r] * sv[c];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = q0 + ty + 16 * r;
        const float g = i < chunk ? expf(a_cum[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= g;
      }
      // intra-chunk term, key tiles at or below the diagonal; with one n
      // slice the next key tile's B and x tiles are fetched into registers
      // while this one computes
      TileRegs nb, nx;
      if (one_slice) {
        nb = fetch_tile(bc, st.b[1], st.b[3], 0, chunk, 0, n, vec_b);
        nx = fetch_tile(xc, st.x[1], st.x[3], 0, chunk, p0, p, vec_x);
      }
      for (int k0 = 0; k0 <= q0 && k0 < chunk; k0 += kT) {
        float sc[4][4] = {};
        for (int n0 = 0; n0 < n; n0 += kT) {
          __syncthreads();
          if (one_slice) {
            store_tile(sB, nb, nullptr);
            store_tile(sX, nx, nullptr);
            if (k0 + kT <= q0 && k0 + kT < chunk) {
              nb = fetch_tile(bc, st.b[1], st.b[3], k0 + kT, chunk, 0, n,
                              vec_b);
              nx = fetch_tile(xc, st.x[1], st.x[3], k0 + kT, chunk, p0, p,
                              vec_x);
            }
          } else {
            store_tile(sA, fetch_tile(cc, st.c[1], st.c[3], q0, chunk, n0,
                                      n, vec_c), nullptr);
            store_tile(sB, fetch_tile(bc, st.b[1], st.b[3], k0, chunk, n0,
                                      n, vec_b), nullptr);
          }
          __syncthreads();
          const int kmax = min(kT, n - n0);
          for (int k = 0; k < kmax; ++k) {
            float av[4], bv[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) av[r] = sA[(ty + 16 * r) * kPad + k];
#pragma unroll
            for (int c = 0; c < 4; ++c) bv[c] = sB[(tx + 16 * c) * kPad + k];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) sc[r][c] += av[r] * bv[c];
          }
        }
        // decay, masked before the exp; scores to shared memory
        __syncthreads();
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = q0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = k0 + tx + 16 * c;
            const bool keep = i >= j && i < chunk && j < chunk;
            sS[(ty + 16 * r) * kPad + tx + 16 * c] =
                keep ? sc[r][c] * expf(a_cum[i] - a_cum[j]) : 0.f;
          }
        }
        if (!one_slice)
          store_tile(sX, fetch_tile(xc, st.x[1], st.x[3], k0, chunk, p0, p,
                                    vec_x), nullptr);
        __syncthreads();
        for (int k = 0; k < kT; ++k) {
          float sv[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) sv[r] = sS[(ty + 16 * r) * kPad + k];
#pragma unroll
          for (int c = 0; c < 4; ++c) xv[c] = sX[k * kPad + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] += sv[r] * xv[c];
        }
      }
      // store y (b, s, h, p) contiguous
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = q0 + ty + 16 * r;
        if (i >= chunk) continue;
        float* yr = y + (((long long)bi * s + t0 + i) * h + hi) * p;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int pp = p0 + tx + 16 * c;
          if (pp < p) yr[pp] = acc[r][c];
        }
      }
    }

    // --- state update: S' = exp(a_tot) S + (x w)^T B ----------------------
    // row weights w_j = exp(a_tot - a_cum[j]) in the chunk's a_cum slot
    // after it, one key tile at a time; the next tile's B and x fetched
    // while this one computes
    float* w = sS;
    const float g_tot = expf(a_tot);
    for (int n0 = 0; n0 < n; n0 += kT) {
      float up[4][4] = {};              // rows: p (ty + 16 r), cols: n
      TileRegs nb = fetch_tile(bc, st.b[1], st.b[3], 0, chunk, n0, n, vec_b);
      TileRegs nx = fetch_tile(xc, st.x[1], st.x[3], 0, chunk, p0, p, vec_x);
      for (int k0 = 0; k0 < chunk; k0 += kT) {
        __syncthreads();
        for (int j = tid; j < kT; j += kThreads)
          w[j] = k0 + j < chunk ? expf(a_tot - a_cum[k0 + j]) : 0.f;
        __syncthreads();
        store_tile(sX, nx, w);
        store_tile(sB, nb, nullptr);
        if (k0 + kT < chunk) {
          nb = fetch_tile(bc, st.b[1], st.b[3], k0 + kT, chunk, n0, n,
                          vec_b);
          nx = fetch_tile(xc, st.x[1], st.x[3], k0 + kT, chunk, p0, p,
                          vec_x);
        }
        __syncthreads();
        for (int k = 0; k < kT; ++k) {
          float xv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) xv[r] = sX[k * kPad + ty + 16 * r];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = sB[k * kPad + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) up[r][c] += xv[r] * bv[c];
        }
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* srow = state + (ty + 16 * r) * (n + 1);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int nn = n0 + tx + 16 * c;
          if (nn < n) srow[nn] = g_tot * srow[nn] + up[r][c];
        }
      }
    }
    __syncthreads();
  }
}

// 16-byte loads of a (.., rows, last) operand: unit last stride, a row
// stride of whole vectors, an aligned base
bool vec_ok(const void* base, long long row_stride, long long last_stride,
            int elem) {
  return last_stride == 1 && (row_stride * elem) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

cudaError_t launch_f32(const void* x, const void* log_a, const void* b,
                       const void* c, void* y, const Strides& st, int batch,
                       int s, int h, int p, int n, int chunk,
                       cudaStream_t stream) {
  const size_t smem = smem_floats(chunk, n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // every tile's rows start on a vector when the batch and head strides
  // are whole vectors too
  const bool vx = vec_ok(x, st.x[1], st.x[3], 4) && st.x[0] % 4 == 0 &&
                  st.x[2] % 4 == 0;
  const bool vb = vec_ok(b, st.b[1], st.b[3], 4) && st.b[0] % 4 == 0 &&
                  st.b[2] % 4 == 0;
  const bool vc = vec_ok(c, st.c[1], st.c[3], 4) && st.c[0] % 4 == 0 &&
                  st.c[2] % 4 == 0;
  dim3 grid(batch * h, ceil_div(p, kT));
  ssd_f32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(log_a),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<float*>(y), st, h, s, p, n, chunk, vx, vb, vc);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* x, const void* log_a, const void* b,
                        const void* c, void* y, const Strides& st, int batch,
                        int s, int h, int p, int n, int chunk,
                        cudaStream_t stream) {
  // the tensor-core kernel's copies need 16-byte rows: unit last strides,
  // every other stride and p, n whole vectors of 8, aligned bases (the
  // wrapper makes such a copy of an operand that is not)
  for (int i = 0; i < 3; ++i)
    if (st.x[i] % 8 || st.b[i] % 8 || st.c[i] % 8)
      return cudaErrorInvalidValue;
  if (st.x[3] != 1 || st.b[3] != 1 || st.c[3] != 1 || p % 8 || n % 8 ||
      chunk > kMaxChunkTc || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 ||
      reinterpret_cast<uintptr_t>(c) % 16)
    return cudaErrorInvalidValue;
  const TcSmem m = tc_smem(chunk, n);
  auto kernel = m.ns > 1 ? ssd_tc_kernel<true> : ssd_tc_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)m.total);
  if (err != cudaSuccess) return err;
  dim3 grid(batch * h, ceil_div(p, kW));
  kernel<<<grid, kTcThreads, m.total, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(log_a),
      static_cast<const bf16*>(b), static_cast<const bf16*>(c),
      static_cast<bf16*>(y), st, h, s, p, n, chunk);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block takes for (chunk, n) and the
// dtype (0 = float32, 1 = bfloat16): the wrapper checks it against the
// card's 227 KB before launching.
extern "C" long long ssd_scan_smem_bytes(int chunk, int n, int dtype) {
  if (dtype == 1) return (long long)tc_smem(chunk, n).total;
  return (long long)(smem_floats(chunk, n) * sizeof(float));
}

// x, b, c: (batch, s, h, p|n) of dtype (0 = float32, 1 = bfloat16) read
// through `strides` (15 int64 element strides: x's 4, log_a's 3, b's 4,
// c's 4); log_a: (batch, s, h) float32; y: (batch, s, h, p) contiguous,
// x's type.  s % chunk == 0; for bfloat16 also chunk <= 256, p and n
// multiples of 8, unit last strides, the other strides multiples of 8 and
// 16-byte aligned bases.  Returns the cudaError_t of the launch.
extern "C" int ssd_scan_fwd(const void* x, const void* log_a, const void* b,
                            const void* c, void* y,
                            const long long* strides, int batch, int s,
                            int h, int p, int n, int chunk, int dtype,
                            void* stream) {
  if (chunk < 1 || s % chunk != 0 || p < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 4; ++i) st.x[i] = strides[i];
  for (int i = 0; i < 3; ++i) st.a[i] = strides[4 + i];
  for (int i = 0; i < 4; ++i) st.b[i] = strides[7 + i];
  for (int i = 0; i < 4; ++i) st.c[i] = strides[11 + i];
  cudaStream_t str = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(x, log_a, b, c, y, st, batch, s, h, p, n, chunk, str);
  if (dtype == 1)
    return launch_bf16(x, log_a, b, c, y, st, batch, s, h, p, n, chunk, str);
  return (int)cudaErrorInvalidValue;
}
