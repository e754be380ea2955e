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
// f32, softmax online in f32, output cast to q's dtype.
//
// What bounds it on an H100.  At the eval shapes of qwen3-0.6b (b 2,
// sq = sk = 1024, 16/8 heads, hd 128, bf16, causal) a launch must move
// q, k, v and out once, ~25 MB (7.5 us at 3.35 TB/s), and do 4 * hd
// flops per visible (query, key) pair, ~8.6 GFLOP causal (8.7 us at the
// 989 TFLOP/s bf16 tensor-core rate): the floor is the flops, under ten
// microseconds.  This kernel does its products in f32 on the CUDA cores,
// not on the tensor cores, so its own ceiling is the f32 rate (67
// TFLOP/s, ~0.13 ms for those flops) and, before that, the shared-memory
// reads that feed each FMA.  wgmma tiles and TMA loads are what would
// reach the bound; this first version is the right and simple one.
//
// Design:
//  * one CUDA block of 8 warps per (64-row query tile, query head,
//    batch): the TPU grid's (batch, kv_head, group, q_block) axes become
//    blockIdx.z / blockIdx.y / blockIdx.x, and its sequential kv_block
//    axis a loop over 64-key tiles inside the block;
//  * the block's 64 query rows are converted to f32 into shared memory
//    once; each warp owns 8 of them, with their online-softmax state
//    (running max m, denominator l, accumulator acc) in registers;
//  * each key tile is copied into shared memory by the whole block in the
//    input dtype (16-byte vector loads; every load unconditional at a
//    valid address — key rows past sk read row sk - 1 and are masked);
//  * scores: lane j computes keys j and j + 32 of the tile for the warp's
//    8 rows (the K rows are padded by 16 bytes so the lanes' vector reads
//    hit distinct banks; the query rows are broadcast reads); one max and
//    one sum warp reduction per row per tile, not per key;
//  * p.v: each lane owns head dims [lane*DPL, lane*DPL + DPL) and walks
//    the tile's keys, reading the warp's 8 probabilities of a key as two
//    broadcast vectors from shared memory;
//  * key tiles wholly above the causal diagonal of the query tile, or
//    wholly outside its window, are skipped (the TPU kernel visits and
//    masks them: the same function);
//  * q, k, v and out are addressed through their (batch, head, seq)
//    strides, so the layer layout (b, s, h, d) is read and written where
//    it lies, with no transposed copies.
// The kernel allocates nothing: the caller passes the output buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(Args a) {
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
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const size_t smem = sizeof(float) * kTileQ * a.hd +
                      sizeof(T) * kTileK * (a.hd + kVec) +
                      sizeof(T) * kTileK * a.hd +
                      sizeof(float) * kWarps * kTileK * kRows;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kTileQ - 1) / kTileQ, a.nh, batch);
  flash_attention_kernel<T, DPL><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (a.nkv < 1 || a.nh % a.nkv != 0 || a.hd < 1 || a.hd % kVec != 0 ||
      a.sq < 1 || a.sk < 1)
    return cudaErrorInvalidValue;
  if (a.hd <= 32) return launch<T, 1>(a, batch, stream);
  if (a.hd <= 64) return launch<T, 2>(a, batch, stream);
  if (a.hd <= 128) return launch<T, 4>(a, batch, stream);
  if (a.hd <= 256) return launch<T, 8>(a, batch, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// strides: 12 element strides, (batch, head, seq) of q, k, v and out in
// that order; the head_dim axis must be contiguous.  window <= 0 means
// no window.  Returns the cudaError_t of the launch (0 on success).
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
  if (dtype == 0) return (int)dispatch<float>(a, batch, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}
