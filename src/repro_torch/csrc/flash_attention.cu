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
// The output is contiguous.  Masked scores are -inf, exp gives exact zeros,
// and the output is acc / max(l, 1e-30), so a row that sees no key (causal,
// Sq > Sk) gives 0.  A key tile wholly above the offset diagonal is never
// loaded.
//
// Bound (both variants): causal work 2 * B * Hq * Sq * Sk * hd flops (two
// products over the visible half) against bytes read once (q, k, v) and
// written once (out); at the models' shapes the flops bound it, at the bf16
// tensor-core rate (989 TFLOP/s).
//
// Two variants behind one entry point; the wrapper (kernels/flash_attention/
// ops.py:variant) picks one from the dtype and the head dim alone.
//
// "wgmma": bf16 at hd 64 or 128, the models' path.  One persistent block an
// SM walks work items of 64 * NWG query rows of one (batch, query head):
// NWG consumer warpgroups of 64 rows each (3 at hd 64, 2 at hd 128, where
// the accumulators need 240 registers a thread) and one producer
// warpgroup, of which one thread issues every load.  Against the four
// faults of the first version (the "simt" variant below):
//   - products on the tensor cores: S = Q K^T is wgmma m64n128k16 with Q and
//     K read from shared memory (both K-major), O += P V is wgmma m64n64k16
//     (one a 64-column half of the head dim) with P as the register A
//     operand and V read as stored, [keys, hd], which is MN-major (the
//     transpose bit).  bf16 in, f32 accumulate.  The f32 S accumulator of
//     m64nN has, pairwise, the register layout of the A operand, so P is
//     converted in place, with no shared-memory round trip.  P enters the
//     second product in bf16, as in standard flash practice and in the
//     port's own blockwise_attention (models/layers.py, pr.to(v.dtype)); the
//     Pallas kernel keeps P in f32.
//   - Q, K and V stay bf16 in shared memory, in the 128-byte swizzle that
//     the TMA writes and the wgmma descriptors name; a 64-column box a row
//     of 128 bytes, so hd 128 is two boxes.  Scores never leave registers.
//   - no block-wide barrier after the set-up: the online softmax runs in
//     registers, the row max and sum reduced across the 4 threads that share
//     a row of the accumulator layout by shuffles (the sum only once, at the
//     end).  The scores are scaled in f32, by log2(e) / sqrt(hd) folded into
//     the exp2's FMA (Q is never pre-scaled in bf16: 1/sqrt(128) is not
//     exact there).  Each warpgroup issues S_j = Q K_j^T and O += P V_{j-1}
//     together and runs tile j's softmax while the second product holds the
//     tensor cores; the warpgroups take turns, in a ring, to issue (one
//     named barrier each), so one's softmax overlaps another's products.
//   - loads are TMA copies (cp.async.bulk.tensor, 4-D tensor maps over
//     (hd, S, H, B) with the caller's strides, so the model's transposed
//     views load with no copy) into a ring of 3 K/V stages paced by
//     mbarriers: full barriers count the bytes, empty barriers the consumer
//     warps' releases.  The ring runs on across work items, and Q is
//     released after an item's last S, so the next item's Q and first tiles
//     load while the consumers finish this one.  The producer gives up
//     registers (setmaxnreg 24) to the consumers (240 at NWG 2, 160 at 3).
// Key tiles of 128; only the diagonal tiles and a ragged last tile apply the
// causal and key < Sk masks (TMA fills keys past Sk with zeros, which are not
// -inf); rows past Sq are loaded as zeros and never written.  Work items are
// numbered longest key walk first and dealt to the blocks in a snake (block
// x takes items x, 2G - 1 - x, 2G + x, ...), so the causal tail is short.
// Shared memory: Q 24 / 32 KiB and 3 x (K + V) 96 / 192 KiB at hd 64 / 128.

// "simt": f32 at any head dim and bf16 at the other head dims (the SMOKE
// configs' 16 and 20, the reference tests' 32).  The first, simple version:
// one block of 256 threads per (64-row q tile, query head, batch).  The
// block stages its Q tile in shared memory as f32, divided by sqrt(hd) in
// f32 as the oracle does.  It then walks 64-key tiles of K and V, each
// staged through shared memory in the input dtype: scores S = Q K^T as a
// 4 x 4 micro-tile a thread (f32 FMAs on the CUDA cores), an f32 online
// softmax (m, l) with four threads a row, the rescale of the f32
// accumulators and O += P V as a 4 x (HD / 16) micro-tile a thread.  Head
// dims: template instances at 16, 32, 64 and 128 (HD); a head dim below its
// instance is zero-padded up to HD while Q, K and V are staged (the padded
// columns add zeros to every score and are never written).  f32 stays here:
// its 1e-4 tolerance is below what TF32 tensor cores keep.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// ------------------------------------------------------------------ wgmma

constexpr int kTcBN = 128;                 // keys a tile
constexpr uint32_t kRowBytes = 128;        // a row of a TMA box: 64 bf16

// NWG consumer warpgroups of 64 query rows and one producer warpgroup;
// Q, K and V tiles are stored as 64-column boxes of 128-byte rows
template <int HD, int STAGES, int NWG>
struct Tc {
  static constexpr int kBM = 64 * NWG;                  // query rows a work item
  static constexpr int kConsumerWarps = 4 * NWG;
  static constexpr int kThreads = (NWG + 1) * 128;
  // registers a consumer thread gets from setmaxnreg; the producer keeps
  // 24, so that 24 * 128 + kRegs * 128 * NWG <= 65536
  static constexpr int kRegs = NWG == 2 ? 240 : 160;
  static constexpr int kBoxes = HD / 64;                // 64-column boxes a row
  static constexpr uint32_t kQBox = kBM * kRowBytes, kKVBox = kTcBN * kRowBytes;
  static constexpr uint32_t kQTile = kBoxes * kQBox, kKVTile = kBoxes * kKVBox;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kQTile;
  static constexpr uint32_t kV = kK + STAGES * kKVTile;
  static constexpr uint32_t kBars = kV + STAGES * kKVTile;  // q_full, q_empty, k_full[], v_full[], empty[]
  static constexpr uint32_t kBytes = kBars + (2 + 3 * STAGES) * 8 + 1024;   // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map (hd, S, H, B) into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(head),
      "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; byte offsets in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of wgmma registers across
// the asynchronous issue / wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define ACC8(i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),       \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64] (+)= A (64 x 16, smem, K-major) . B (16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] += A (64 x 16, registers) . B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD, int STAGES, int NWG>
__global__ void __launch_bounds__(Tc<HD, STAGES, NWG>::kThreads, 1) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out, int B, int Hq,
    int Hkv, int Sq, int Sk, float scale_log2, int causal) {
  using L = Tc<HD, STAGES, NWG>;
  constexpr int kBoxes = L::kBoxes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms sit on 1 KiB boundaries
  const uint32_t q_s = base + L::kQ;
  const uint32_t q_full = base + L::kBars, q_empty = q_full + 8;
  auto k_s = [&](int st) { return base + L::kK + st * L::kKVTile; };
  auto v_s = [&](int st) { return base + L::kV + st * L::kKVTile; };
  auto k_full = [&](int st) { return q_full + 8 * (2 + st); };
  auto v_full = [&](int st) { return q_full + 8 * (2 + STAGES + st); };
  auto empty = [&](int st) { return q_full + 8 * (2 + 2 * STAGES + st); };

  // Persistent: block x takes work items x, 2G - 1 - x, 2G + x, ... (G blocks;
  // a snake over rounds of G).  Items are numbered longest key walk first
  // (query tiles from the last), and the heads of one KV head are adjacent.
  const int off = Sk - Sq;   // key t visible to query s iff t <= s + off
  const int n_mb = (Sq + L::kBM - 1) / L::kBM;
  const int n_items = n_mb * B * Hq;
  auto item_at = [&](int r) {
    return r * (int)gridDim.x + ((r & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };
  // the query tile's first row and its number of key tiles (0: no row sees a key)
  auto tiles = [&](int item, int& q0) {
    q0 = (n_mb - 1 - item / (B * Hq)) * L::kBM;
    int nk = (Sk + kTcBN - 1) / kTcBN;
    if (causal) {
      const int kmax = min(q0 + L::kBM - 1, Sq - 1) + off;
      nk = kmax < 0 ? 0 : min(nk, kmax / kTcBN + 1);
    }
    return nk;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, L::kConsumerWarps);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), L::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= L::kConsumerWarps) {
    // producer warpgroup: one thread issues every load; the ring's tile count
    // c runs on across items, so the next item's Q and first K/V tiles load
    // while the consumers finish this one
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == L::kConsumerWarps && lane == 0) {
      int c = 0, qn = 0;
      for (int r = 0, item; (item = item_at(r)) < n_items; ++r) {
        int q0;
        const int nk = tiles(item, q0);
        if (nk == 0) continue;
        const int bh = item % (B * Hq), h = bh % Hq, b = bh / Hq, hk = h / (Hq / Hkv);
        if (qn > 0) mbar_wait(q_empty, (qn - 1) & 1);
        mbar_expect_tx(q_full, L::kQTile);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) tma_load(q_s + x * L::kQBox, &qmap, q_full, 64 * x, q0, h, b);
        ++qn;
        for (int j = 0; j < nk; ++j, ++c) {
          const int st = c % STAGES;
          if (c >= STAGES) mbar_wait(empty(st), ((c / STAGES) & 1) ^ 1);
          mbar_expect_tx(k_full(st), L::kKVTile);
#pragma unroll
          for (int x = 0; x < kBoxes; ++x)
            tma_load(k_s(st) + x * L::kKVBox, &kmap, k_full(st), 64 * x, j * kTcBN, hk, b);
          mbar_expect_tx(v_full(st), L::kKVTile);
#pragma unroll
          for (int x = 0; x < kBoxes; ++x)
            tma_load(v_s(st) + x * L::kKVBox, &vmap, v_full(st), 64 * x, j * kTcBN, hk, b);
        }
      }
    }
  } else {
    // consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::kRegs) : "memory");
    const int wg = warp / 4, g = lane / 4, t = lane % 4;
    float o[kBoxes][32];
    float m[2], l[2], corr[2];
    float s[64];                            // scores, then P in f32
    uint32_t p[kTcBN / 16][4];              // P in bf16, the A operand of O += P V
    int wg_row, row;                        // the warpgroup's first row; this thread's: row, row + 8

    // S = Q K^T of ring tile c into s, issued and committed (not waited for)
    auto issue_qk = [&](int c) {
      const int st = c % STAGES;
      mbar_wait(k_full(st), (c / STAGES) & 1);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t qa = q_s + (kk / 4) * L::kQBox + wg * 64 * kRowBytes + (kk % 4) * 32;
        const uint32_t ka = k_s(st) + (kk / 4) * L::kKVBox + (kk % 4) * 32;
        wgmma_m64n128k16_ss(s, smem_desc(qa, 16, 1024), smem_desc(ka, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of ring tile c, issued and committed (the fence covers O's rescale)
    auto issue_pv = [&](int c) {
      const int st = c % STAGES;
      mbar_wait(v_full(st), (c / STAGES) & 1);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) fence_regs(o[x]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcBN / 16; ++kk)
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          wgmma_m64n64k16_rs(o[x], p[kk],
                             smem_desc(v_s(st) + x * L::kKVBox + kk * 16 * kRowBytes, 1024, 1024));
      wgmma_commit();
    };
    // masks (diagonal and ragged tiles only) and the online softmax of the
    // item's key tile j, in the exp2 domain: s becomes P, corr the rescale of O
    auto softmax = [&](int j) {
      fence_regs(s);
      const int k0 = j * kTcBN;
      // s[i] holds row + 8 * ((i / 2) % 2), key k0 + 8 * (i / 4) + 2 * t + i % 2
      if (k0 + kTcBN > Sk || (causal && k0 + kTcBN - 1 > wg_row + off)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int key = k0 + 8 * (i / 4) + 2 * t + (i % 2);
          const int r = row + 8 * ((i / 2) % 2);
          if (key >= Sk || (causal && key > r + off)) s[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY}, shift[2], ls[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        shift[r] = m_new == -INFINITY ? 0.0f : m_new;
        corr[r] = m[r] == -INFINITY ? 0.0f : ex2(m[r] - shift[r]);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i / 2) % 2;
        s[i] = ex2(fmaf(s[i], scale_log2, -shift[r]));   // a masked score gives 0
        ls[r] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ls[r];   // this thread's columns
    };
    // O *= corr, then P in bf16: k-step kk takes accumulator columns 16kk..16kk+15
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[x][i] *= corr[(i / 2) % 2];
#pragma unroll
      for (int kk = 0; kk < kTcBN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    };
    auto arrive = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    auto wait_pv = [&](int c) {             // O += P V of tile c done: its stage is free
      wgmma_wait<0>();
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) fence_regs(o[x]);
      arrive(empty(c % STAGES));
    };

    // the warpgroups take turns, in a ring, to issue their products (named
    // barrier 1 + wg): one's softmax runs while another's products hold the
    // tensor cores; the last warpgroup lets warpgroup 0 go first
    auto turn = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory"); };
    auto pass = [&]() {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (wg + 1) % NWG) : "memory");
    };
    if (wg == NWG - 1) pass();

    int c = 0, qn = 0;                      // ring tiles and Q loads consumed so far
    for (int r = 0, item; (item = item_at(r)) < n_items; ++r) {
      int q0;
      const int nk = tiles(item, q0);
      const int bh = item % (B * Hq), h = bh % Hq, b = bh / Hq;
      wg_row = q0 + 64 * wg;
      row = wg_row + 16 * (warp % 4) + g;
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[x][i] = 0.0f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.0f;

      // both warpgroups walk the item's nk tiles (a tile above one's diagonal
      // is all -inf there and adds nothing); the softmax of tile j runs while
      // the tensor cores do O += P V_{j-1}; Q is released once the last S is in
      if (nk > 0) {
        mbar_wait(q_full, qn & 1);
        turn();
        issue_qk(c);
        pass();
        wgmma_wait<0>();
        if (nk == 1) arrive(q_empty);
        softmax(0);
        rescale_and_pack();
        for (int j = 1; j < nk; ++j) {
          turn();
          issue_qk(c + j);
          issue_pv(c + j - 1);
          pass();
          wgmma_wait<1>();                  // S_j is in; O += P V_{j-1} may still run
          if (j == nk - 1) arrive(q_empty);
          softmax(j);
          wait_pv(c + j - 1);
          rescale_and_pack();
        }
        turn();
        issue_pv(c + nk - 1);
        pass();
        wait_pv(c + nk - 1);
      }
      c += nk;
      qn += nk > 0;

      // out = O / l, l summed over the 4 threads of the row; rows past Sq not written
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const int s_row = row + 8 * i;
        if (s_row >= Sq) continue;
        const float inv = 1.0f / fmaxf(l[i], 1e-30f);
        __nv_bfloat16* o_row = out + (((long long)b * Hq + h) * Sq + s_row) * HD;
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
#pragma unroll
          for (int cc = 0; cc < 8; ++cc)
            *reinterpret_cast<__nv_bfloat162*>(o_row + 64 * x + 8 * cc + 2 * t) =
                __floats2bfloat162_rn(o[x][4 * cc + 2 * i] * inv, o[x][4 * cc + 2 * i + 1] * inv);
      }
    }
    if (wg == 0) turn();                    // the last warpgroup's last pass
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: reached through the runtime's
// entry-point query, so the library needs no -lcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// a 4-D map (hd, S, H, B) of bf16 with strides in elements; boxes of 64
// columns x `rows`.  S == 0 (no keys: no item loads a tile) leaves the map
// unused and zeroed.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int S, int H, int Bn, long long ss,
              long long sh, long long sb, int rows) {
  if (S == 0) {
    memset(map, 0, sizeof(*map));
    return true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)Bn};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int STAGES, int NWG>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int Hq,
                 int Hkv, int Sq, int Sk, const long long (&st)[9], float sqrt_hd, int causal,
                 cudaStream_t stream) {
  using L = Tc<HD, STAGES, NWG>;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, HD, Sq, Hq, B, st[2], st[1], st[0], L::kBM) ||
      !make_map(&km, k, HD, Sk, Hkv, B, st[5], st[4], st[3], kTcBN) ||
      !make_map(&vm, v, HD, Sk, Hkv, B, st[8], st[7], st[6], kTcBN))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)L::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<HD, STAGES, NWG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)((Sq + L::kBM - 1) / L::kBM) * Hq * B;
  if (items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(items < sms ? items : sms);   // one a streaming multiprocessor
  flash_fwd_wgmma<HD, STAGES, NWG><<<blocks, L::kThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), B, Hq, Hkv, Sq, Sk,
      1.4426950408889634f / sqrt_hd, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16; 1 <= hd <= 128 (the wrapper refuses anything else).
// (qsb, qsh, qss) etc.: the batch, head and row strides of q, k and v in
// elements; the head dim is contiguous.  variant: 0 = "simt", 1 = "wgmma"
// (bf16 and hd 64 or 128 only; the base pointers 16-byte aligned and every
// stride of a dim longer than 1 a positive multiple of 8 elements, as the
// TMA requires).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int dtype, int B, int Hq, int Hkv, int Sq, int Sk,
                                   int hd, long long qsb, long long qsh, long long qss,
                                   long long ksb, long long ksh, long long kss,
                                   long long vsb, long long vsh, long long vss,
                                   float sqrt_hd, int causal, int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || hd <= 0 || hd > 128)
    return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (hd == 64) return launch_wgmma<64, 3, 3>(q, k, v, out, B, Hq, Hkv, Sq, Sk, st, sqrt_hd, causal, s);
    if (hd == 128) return launch_wgmma<128, 3, 2>(q, k, v, out, B, Hq, Hkv, Sq, Sk, st, sqrt_hd, causal, s);
    return (int)cudaErrorInvalidValue;
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(q, k, v, out, B, Hq, Hkv, Sq, Sk, st, hd, sqrt_hd, causal, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, st, hd, sqrt_hd, causal, s);
  return (int)cudaErrorInvalidValue;
}
