// Flash attention forward (causal or not, GQA), bf16 or f32, for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_attention_pallas and
// computes what repro_torch/kernels/flash_attention/ref.py computes:
//
//   q [B, Hq, Sq, hd], k and v [B, Hkv, Sk, hd] -> out [B, Hq, Sq, hd] in q's
//   dtype; query head h reads KV head h / (Hq / Hkv); scores q.k / sqrt(hd);
//   causal keeps key t for query s iff t <= s + (Sk - Sq) (the oracle's offset
//   mask; the Pallas kernel's q_pos >= k_pos agrees with it only at Sq == Sk).
//
// q, k and v may be strided views (the model hands over [B, S, H, hd]
// tensors transposed to [B, H, S, hd]); only the head dim must be contiguous.
// The output is contiguous.
//
// Design, simple first: one block of 256 threads per (64-row q tile, query
// head, batch).  The block stages its Q tile in shared memory as f32,
// divided by sqrt(hd) in f32 as the oracle does (the Pallas wrapper scales q
// in q's own dtype instead; for hd = 64 the two agree exactly, the scale
// being 1/8).  It then walks 64-key tiles of K and V, each staged through
// shared memory in the input dtype: scores S = Q K^T as a 4 x 4 micro-tile
// a thread (f32 FMAs on the CUDA cores), an f32 online softmax (m, l) with
// four threads a row, the rescale of the f32 accumulators and O += P V as a
// 4 x (HD / 16) micro-tile a thread.  A tile wholly above the offset
// diagonal (first key > last query + Sk - Sq) is never loaded: the walk
// stops at the last live tile.  Masked scores are -inf, exp gives exact
// zeros, and the output is acc / max(l, 1e-30), so a row that sees no key
// (causal, Sq > Sk) gives 0.
//
// Head dims: template instances at 16, 32, 64 and 128 (HD); a head dim hd
// below its instance is zero-padded up to HD while Q, K and V are staged
// (the padded columns add zeros to every score and are never written), so
// every hd <= 128 runs, the reference's tested 16, 20 and 32 included.
//
// Bound: causal work 2 * B * Hq * Sq * Sk * hd flops (two products over the
// visible half) against bytes read once (q, k, v) and written once (out);
// at the model's shapes the flops bound it on tensor cores (989 TFLOP/s
// bf16).  This version runs its products on the CUDA cores in f32 and does
// not approach that bound; wgmma with TMA-staged tiles and warp
// specialisation is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 256;
constexpr int kSP = kBK + 1;   // padded score row (floats)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int HD>
struct Smem {
  // K rows padded so that the 16 keys a warp reads at one d fall in 16 banks
  static constexpr int kKP = HD + (sizeof(T) == 4 ? 1 : 2);
  static constexpr size_t kQ = (size_t)kBQ * HD * sizeof(float);
  static constexpr size_t kS = (size_t)kBQ * kSP * sizeof(float);
  static constexpr size_t kStats = 2 * kBQ * sizeof(float);   // corr, l
  static constexpr size_t kK = (size_t)kBK * kKP * sizeof(T);
  static constexpr size_t kV = (size_t)kBK * HD * sizeof(T);
  static constexpr size_t kBytes = kQ + kS + kStats + kK + kV;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int Hq, int Hkv, int Sq, int Sk,
    long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss,
    int hd, float sqrt_hd, int causal) {
  using L = Smem<T, HD>;
  constexpr int kKP = L::kKP;
  constexpr int kCW = HD / 16;   // output columns a thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                 // [BQ][HD]
  float* s_s = reinterpret_cast<float*>(smem + L::kQ);         // [BQ][SP]
  float* corr_s = reinterpret_cast<float*>(smem + L::kQ + L::kS);
  float* l_s = corr_s + kBQ;
  T* k_s = reinterpret_cast<T*>(smem + L::kQ + L::kS + L::kStats);  // [BK][KP]
  T* v_s = reinterpret_cast<T*>(smem + L::kQ + L::kS + L::kStats + L::kK);  // [BK][HD]

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  const int off = Sk - Sq;       // key t visible to query s iff t <= s + off

  // stage Q / sqrt(hd) in f32; rows past Sq and columns past hd are zeros
  // (computed, never written)
  for (int i = t; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int s = q0 + r;
    q_s[i] = s < Sq && d < hd ? to_f(qb[(long long)s * qss + d]) / sqrt_hd : 0.0f;
  }

  // live key tiles: every tile when not causal; else up to the one holding
  // the last key the block's last row sees
  int nk = (Sk + kBK - 1) / kBK;
  if (causal) {
    const int kmax = min(q0 + kBQ - 1, Sq - 1) + off;
    nk = kmax < 0 ? 0 : min(nk, kmax / kBK + 1);
  }

  const int ty = t / 16, tx = t % 16;          // micro-tiles: rows ty + 16 i
  const int srow = t / 4, spart = t % 4;       // softmax: 4 threads a row
  float m_run = -INFINITY, l_run = 0.0f;       // row srow's running max / sum
  float acc[4][kCW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCW; ++j) acc[i][j] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // Q staged; the previous tile's K, V and P consumed
    for (int i = t; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int key = k0 + r;
      const bool in = key < Sk && d < hd;
      k_s[r * kKP + d] = in ? kb[(long long)key * kss + d] : from_f<T>(0.0f);
      v_s[r * HD + d] = in ? vb[(long long)key * vss + d] : from_f<T>(0.0f);
    }
    __syncthreads();

    // S = (Q / sqrt(hd)) K^T for rows ty + 16 i, keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * HD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = to_f(k_s[(tx + 16 * j) * kKP + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int key = k0 + c;
        const bool ok = key < Sk && (!causal || key <= q0 + r + off);
        s_s[r * kSP + c] = ok ? sc[i][j] : -INFINITY;
      }
    __syncthreads();

    // online softmax of row srow over this tile; P overwrites S
    {
      float* row = s_s + srow * kSP;
      float mt = -INFINITY;
      for (int c = spart; c < kBK; c += 4) mt = fmaxf(mt, row[c]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m_run, mt);
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      float ls = 0.0f;
      for (int c = spart; c < kBK; c += 4) {
        const float p = expf(row[c] - m_safe);   // a masked score gives 0
        row[c] = p;
        ls += p;
      }
      ls += __shfl_xor_sync(0xffffffffu, ls, 1);
      ls += __shfl_xor_sync(0xffffffffu, ls, 2);
      const float corr = m_run == -INFINITY ? 0.0f : expf(m_run - m_safe);
      l_run = l_run * corr + ls;
      m_run = m_new;
      if (spart == 0) corr_s[srow] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P V for rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cr = corr_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCW; ++j) acc[i][j] *= cr;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4], vv[kCW];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(ty + 16 * i) * kSP + kk];
#pragma unroll
      for (int j = 0; j < kCW; ++j) vv[j] = to_f(v_s[kk * HD + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCW; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  if (spart == 0) l_s[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int s = q0 + r;
    if (s >= Sq) continue;
    const float inv = 1.0f / fmaxf(l_s[r], 1e-30f);
    T* o = out + (((long long)b * Hq + h) * Sq + s) * hd;
#pragma unroll
    for (int j = 0; j < kCW; ++j)
      if (tx + 16 * j < hd) o[tx + 16 * j] = from_f<T>(acc[i][j] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Hq,
           int Hkv, int Sq, int Sk, const long long (&st)[9], int hd, float sqrt_hd,
           int causal, cudaStream_t stream) {
  const size_t smem = Smem<T, HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Hq, Hkv, Sq, Sk, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], hd, sqrt_hd, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
             int Sq, int Sk, const long long (&st)[9], int hd, float sqrt_hd, int causal,
             cudaStream_t s) {
  if (hd <= 16) return launch<T, 16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, st, hd, sqrt_hd, causal, s);
  if (hd <= 32) return launch<T, 32>(q, k, v, out, B, Hq, Hkv, Sq, Sk, st, hd, sqrt_hd, causal, s);
  if (hd <= 64) return launch<T, 64>(q, k, v, out, B, Hq, Hkv, Sq, Sk, st, hd, sqrt_hd, causal, s);
  return launch<T, 128>(q, k, v, out, B, Hq, Hkv, Sq, Sk, st, hd, sqrt_hd, causal, s);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16; 1 <= hd <= 128 (the wrapper refuses anything else).
// (qsb, qsh, qss) etc.: the batch, head and row strides of q, k and v in
// elements; the head dim is contiguous.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int dtype, int B, int Hq, int Hkv, int Sq, int Sk,
                                   int hd, long long qsb, long long qsh, long long qss,
                                   long long ksb, long long ksh, long long kss,
                                   long long vsb, long long vsh, long long vss,
                                   float sqrt_hd, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || hd <= 0 || hd > 128)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(q, k, v, out, B, Hq, Hkv, Sq, Sk, st, hd, sqrt_hd, causal, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, st, hd, sqrt_hd, causal, s);
  return (int)cudaErrorInvalidValue;
}
