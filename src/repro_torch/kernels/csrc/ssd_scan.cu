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
// What bounds it on an H100: at the shapes the models give it (zamba2:
// Q 256, p = n = 64; the mLSTM of xlstm-350m: p = n = 512), the products
// — Q^2 (n + p) + 2 Q p n multiply-adds per (batch, head, chunk) — put it
// above the card's ops-per-byte line once x, B, C are read once and y
// written once.  This first kernel runs them on the CUDA cores in f32
// (a tensor-core version is later work); its floor on this card is the
// bf16 tensor-core rate.
//
// Design (simple first):
// - The TPU kernel's grid walks the chunks in order on one core and keeps
//   the state in VMEM scratch.  Here one block owns one (batch, head) and
//   one 64-wide tile of p, and walks the chunks in order itself; the state
//   tile (64, n) stays in shared memory for the whole sequence.  Each
//   p-tile block recomputes C.B^T for its chunk — for p = n = 512 the
//   state (1 MB f32 per head) cannot live in one block.
// - The TPU kernel keeps the (Q, Q) decay matrix whole (256 KB at Q =
//   256); an SM has 227 KB.  Here query rows are taken 64 at a time, key
//   rows 64 at a time (only tiles at or below the diagonal), and the
//   decay exp(a_cum[i] - a_cum[j]) is formed for each 64 x 64 score tile
//   as it is used, masked BEFORE the exp (the i < j half would overflow).
// - Every product is a 64 x 64 output tile over 256 threads, 4 x 4 per
//   thread (rows ty + 16 r, columns tx + 16 c), from f32 tiles in shared
//   memory with rows padded to 65 floats so strided reads hit distinct
//   banks; n is walked in 64-wide slices.
// - a_cum comes from a warp-level scan of the chunk's log decays.
// - Inputs are read through their strides: B and C are broadcast over
//   heads by the Mamba2 block (head stride 0), and nothing is copied.
// - f32 throughout; y is cast to x's type at the store.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;            // tile edge: query rows, key rows, p, n
constexpr int kPad = kT + 1;      // padded row stride of a shared tile

struct Strides {                  // element strides (b, s, h, last)
  long long x[4], a[3], b[4], c[4];
};

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// dynamic shared memory (floats): a_cum, state, four 64 x 65 tiles
__host__ __device__ inline size_t smem_floats(int chunk, int n) {
  return (size_t)ceil_div(chunk, 4) * 4 + (size_t)kT * (n + 1)
      + 4 * (size_t)kT * kPad;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ log_a,
                const T* __restrict__ bm, const T* __restrict__ cm,
                T* __restrict__ y, Strides st, int h, int s, int p, int n,
                int chunk) {
  extern __shared__ float smem[];
  float* a_cum = smem;                                   // (chunk,)
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

  const T* xb = x + bi * st.x[0] + hi * st.x[2];
  const float* ab = log_a + bi * st.a[0] + hi * st.a[2];
  const T* bb = bm + bi * st.b[0] + hi * st.b[2];
  const T* cb = cm + bi * st.c[0] + hi * st.c[2];

  for (int e = tid; e < kT * (n + 1); e += kThreads) state[e] = 0.f;

  // a (rows x 64) tile of a (s, last) operand into shared memory, zero
  // outside [t_lo, t_hi) x [c_lo, c_hi); optional per-row scale
  auto load_tile = [&](float* dst, const T* base, long long s_t,
                       long long s_c, int t_lo, int t_hi, int c_lo,
                       int c_hi, const float* row_scale) {
    for (int e = tid; e < kT * kT; e += kThreads) {
      const int r = e / kT, c = e % kT;
      const int t = t_lo + r, cc = c_lo + c;
      float v = 0.f;
      if (t < t_hi && cc < c_hi) {
        v = to_f32(base[t * s_t + cc * s_c]);
        if (row_scale != nullptr) v *= row_scale[r];
      }
      dst[r * kPad + c] = v;
    }
  };

  const int nc = s / chunk;
  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * chunk;
    // --- a_cum: inclusive cumsum of the chunk's log decays -------------
    for (int i = tid; i < chunk; i += kThreads)
      a_cum[i] = ab[(long long)(t0 + i) * st.a[1]];
    __syncthreads();
    if (tid < 32) {
      const int per = ceil_div(chunk, 32);
      const int lo = min(tid * per, chunk), hi_ = min(lo + per, chunk);
      float run = 0.f;
      for (int i = lo; i < hi_; ++i) { run += a_cum[i]; a_cum[i] = run; }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float excl = incl - run;
      for (int i = lo; i < hi_; ++i) a_cum[i] += excl;
    }
    __syncthreads();
    const float a_tot = a_cum[chunk - 1];

    // --- outputs, 64 query rows at a time ---------------------------------
    for (int q0 = 0; q0 < chunk; q0 += kT) {
      float acc[4][4] = {};
      // carried-state term: exp(a_cum[i]) * C_i . S^T
      for (int n0 = 0; n0 < n; n0 += kT) {
        load_tile(sA, cb + (long long)t0 * st.c[1], st.c[1], st.c[3], q0,
                  chunk, n0, n, nullptr);
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
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = q0 + ty + 16 * r;
        const float g = i < chunk ? expf(a_cum[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= g;
      }
      // intra-chunk term, key tiles at or below the diagonal
      for (int k0 = 0; k0 <= q0 && k0 < chunk; k0 += kT) {
        float sc[4][4] = {};
        for (int n0 = 0; n0 < n; n0 += kT) {
          load_tile(sA, cb + (long long)t0 * st.c[1], st.c[1], st.c[3], q0,
                    chunk, n0, n, nullptr);
          load_tile(sB, bb + (long long)t0 * st.b[1], st.b[1], st.b[3], k0,
                    chunk, n0, n, nullptr);
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
          __syncthreads();
        }
        // decay, masked before the exp; scores to shared memory
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
        load_tile(sX, xb + (long long)t0 * st.x[1], st.x[1], st.x[3], k0,
                  chunk, p0, p, nullptr);
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
        __syncthreads();
      }
      // store y (b, s, h, p) contiguous
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = q0 + ty + 16 * r;
        if (i >= chunk) continue;
        T* yr = y + (((long long)bi * s + t0 + i) * h + hi) * p;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int pp = p0 + tx + 16 * c;
          if (pp < p) yr[pp] = from_f32<T>(acc[r][c]);
        }
      }
    }

    // --- state update: S' = exp(a_tot) S + (x w)^T B ----------------------
    // row weights w_j = exp(a_tot - a_cum[j]) into sS's first row
    float* w = sS;
    const float g_tot = expf(a_tot);
    for (int n0 = 0; n0 < n; n0 += kT) {
      float up[4][4] = {};              // rows: p (ty + 16 r), cols: n
      for (int k0 = 0; k0 < chunk; k0 += kT) {
        __syncthreads();
        for (int j = tid; j < kT; j += kThreads)
          w[j] = k0 + j < chunk ? expf(a_tot - a_cum[k0 + j]) : 0.f;
        __syncthreads();
        load_tile(sX, xb + (long long)t0 * st.x[1], st.x[1], st.x[3], k0,
                  chunk, p0, p, w);
        load_tile(sB, bb + (long long)t0 * st.b[1], st.b[1], st.b[3], k0,
                  chunk, n0, n, nullptr);
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

template <typename T>
cudaError_t launch(const void* x, const void* log_a, const void* b,
                   const void* c, void* y, const Strides& st, int batch,
                   int s, int h, int p, int n, int chunk,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(chunk, n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(batch * h, ceil_div(p, kT));
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(log_a),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<T*>(y), st, h, s, p, n, chunk);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block takes for (chunk, n): the
// wrapper checks it against the card's 227 KB before launching.
extern "C" long long ssd_scan_smem_bytes(int chunk, int n) {
  return (long long)(smem_floats(chunk, n) * sizeof(float));
}

// x, b, c: (batch, s, h, p|n) of dtype (0 = float32, 1 = bfloat16) read
// through `strides` (15 int64 element strides: x's 4, log_a's 3, b's 4,
// c's 4); log_a: (batch, s, h) float32; y: (batch, s, h, p) contiguous,
// x's type.  s % chunk == 0.  Returns the cudaError_t of the launch.
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
    return launch<float>(x, log_a, b, c, y, st, batch, s, h, p, n, chunk,
                         str);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, log_a, b, c, y, st, batch, s, h, p, n,
                                 chunk, str);
  return (int)cudaErrorInvalidValue;
}
