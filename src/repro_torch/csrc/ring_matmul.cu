// Fused all-gather matmul on the stacked rank axis, for Hopper (sm_90a).
//
// Replaces repro/kernels/ring_matmul/kernel.py:ring_matmul_pallas and computes
// what repro_torch/kernels/ring_matmul/ref.py:ring_schedule_ref computes:
//
//   x_t [K, m] (every rank's), w [n, ks, N] (rank r's shard at w[r], K = n*ks),
//   out [n, m, N] f32 = for each rank r, x_t.T @ concat(w[0], ..., w[n-1]),
//   summed shard by shard in the rank's own ring order.
//
// The TPU kernel runs one program a chip.  Each of its n steps starts a
// remote DMA of the shard it holds to the right neighbour's other buffer
// slot, multiplies that same shard into its output while the DMA flies, and
// waits; a barrier with both neighbours guards the reuse of a slot.  Here the
// n ranks are rows of one device's tensors and every step is one launch of
// this kernel over all ranks, `ring_matmul_step`, called n times in stream
// order.  The launch boundary is the neighbour barrier: step i + 1 writes the
// slot step i read only after step i has finished.  Inside a launch the
// first `copy_blocks` blocks forward every rank's held shard,
//   buf[(r + 1) % n][(i + 1) % 2] = held_r,   held_r = i == 0 ? w[r] : buf[r][i % 2],
// and the other blocks multiply the held shard into the output:
//   out[r] (+)= x_t[j*ks : (j+1)*ks].T @ held_r,   j = (r - i) mod n,
// so the copy runs beside the partial products of the same step, on other
// SMs (the copy blocks are scheduled first).  Step 0 reads w in place, so
// slot 0 is first written by step 1.  The product is the kernel's own: no
// library call is on its path.
//
// Arithmetic: bf16 or f32 in, f32 accumulation, f32 out.  Each output tile
// of each rank belongs to one block in each step, which writes it (step 0)
// or adds to it (steps 1..n-1): no atomics, and the sum over shards is taken
// in the ring order.  Block tile 128 x 128 x 32, 256 threads.  The tiles are
// staged in shared memory as stored, [k][m] and [k][n].  bf16: 8 warps of
// 64 x 32, fragments by ldmatrix.trans, mma.sync m16n8k16 with f32
// accumulators.  f32: 8 x 8 outputs a thread by CUDA-core FMAs (the tensor
// cores' TF32 would round the inputs).  Any m, N and ks: ragged tiles are
// masked with zeros.
//
// Bound: operations.  Every rank computes its own Y, so the work is
// 2 * n * m * K * N flops at the bf16 tensor-core rate; the bytes that must
// move (x_t and w read once, out written once) take less at the training
// run's shapes.  The partial sums are read and written once a step, (2n - 1)
// passes over out: the price of one launch a step.  Not yet used here: TMA,
// wgmma, a pipelined k loop, keeping the accumulators in registers across
// steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kPad = 8;               // elements a row: ldmatrix rows on distinct banks
constexpr long long kMaxCopyBlocks = 264;

template <typename T>
struct alignas(16) Tile {
  T a[kBK][kBM + kPad];               // x_t rows k0.., columns m0..
  T b[kBK][kBN + kPad];               // the held shard's rows k0.., columns n0..
};

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [k0, k0 + kBK) of x_t's shard j (at x row x0) and of the held shard,
// columns [m0, m0 + kBM) and [n0, n0 + kBN); zeros past the edges
template <typename T>
__device__ __forceinline__ void load_tiles(Tile<T>& t, const T* __restrict__ x,
                                           const T* __restrict__ held, long long x0,
                                           long long k0, long long ks, long long m,
                                           long long N, long long m0, long long n0) {
  for (int e = threadIdx.x; e < kBK * kBM; e += kThreads) {
    const int k = e / kBM, c = e % kBM;
    const bool in = k0 + k < ks && m0 + c < m;
    t.a[k][c] = in ? x[(x0 + k0 + k) * m + m0 + c] : zero<T>();
  }
  for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
    const int k = e / kBN, c = e % kBN;
    const bool in = k0 + k < ks && n0 + c < N;
    t.b[k][c] = in ? held[(k0 + k) * N + n0 + c] : zero<T>();
  }
}

__device__ __forceinline__ void put(float* __restrict__ o, float v, bool add) {
  *o = add ? *o + v : v;
}

// the partial product of one 128 x 128 tile of rank r's output, bf16 inputs
__device__ void tile_bf16(Tile<__nv_bfloat16>& t, const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ held, float* __restrict__ out,
                          long long x0, long long ks, long long m, long long N,
                          long long m0, long long n0, bool add) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

  for (long long k0 = 0; k0 < ks; k0 += kBK) {
    load_tiles(t, x, held, x0, k0, ks, m, N, m0, n0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)      // A (m x k) from the [k][m] tile
        ldmatrix_x4_trans(af[mi], &t.a[kk + (lane & 7) + (lane >> 4) * 8]
                                       [wm + mi * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {    // B (k x n) for two n8 tiles
        uint32_t r[4];
        ldmatrix_x4_trans(r, &t.b[kk + (lane & 7) + ((lane >> 3) & 1) * 8]
                                 [wn + nj * 16 + (lane >> 4) * 8]);
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
    __syncthreads();
  }

  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + wm + mi * 16 + g + h * 8;
      if (row >= m) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const long long col = n0 + wn + ni * 8 + q * 2 + c;
          if (col < N) put(out + row * N + col, acc[mi][ni][h * 2 + c], add);
        }
    }
}

// the same tile, f32 inputs: 8 x 8 outputs a thread
__device__ void tile_f32(Tile<float>& t, const float* __restrict__ x,
                         const float* __restrict__ held, float* __restrict__ out,
                         long long x0, long long ks, long long m, long long N,
                         long long m0, long long n0, bool add) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (long long k0 = 0; k0 < ks; k0 += kBK) {
    load_tiles(t, x, held, x0, k0, ks, m, N, m0, n0);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&t.a[k][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&t.a[k][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&t.b[k][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&t.b[k][tx * 8 + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + ty * 8 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long col = n0 + tx * 8 + j;
      if (col < N) put(out + row * N + col, acc[i][j], add);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ring_step_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ buf,
    float* __restrict__ out, long long n, long long ks, long long m, long long N,
    long long step, long long copy_blocks, bool vec) {
  const long long shard = ks * N;     // elements of one rank's shard
  const long long slot = step % 2, nxt = (step + 1) % 2;
  if ((long long)blockIdx.x < copy_blocks) {
    // forward every rank's held shard to its right neighbour's other slot
    const long long stride = copy_blocks * kThreads;
    const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (vec) {
      const long long per = shard * (long long)sizeof(T) / 16;
      for (long long u = first; u < n * per; u += stride) {
        const long long r = u / per, off = u % per;
        const T* src = step == 0 ? w + r * shard : buf + (r * 2 + slot) * shard;
        T* dst = buf + (((r + 1) % n) * 2 + nxt) * shard;
        reinterpret_cast<uint4*>(dst)[off] = reinterpret_cast<const uint4*>(src)[off];
      }
    } else {
      for (long long u = first; u < n * shard; u += stride) {
        const long long r = u / shard, off = u % shard;
        const T* src = step == 0 ? w + r * shard : buf + (r * 2 + slot) * shard;
        buf[(((r + 1) % n) * 2 + nxt) * shard + off] = src[off];
      }
    }
    return;
  }
  __shared__ Tile<T> tile;
  const long long tiles_m = (m + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  const long long b = (long long)blockIdx.x - copy_blocks;
  const long long r = b / (tiles_m * tiles_n), rest = b % (tiles_m * tiles_n);
  const long long m0 = (rest / tiles_n) * kBM, n0 = (rest % tiles_n) * kBN;
  const long long j = ((r - step) % n + n) % n;    // the shard rank r holds at this step
  const T* held = step == 0 ? w + r * shard : buf + (r * 2 + slot) * shard;
  float* o = out + r * m * N;
  if constexpr (std::is_same<T, float>::value)
    tile_f32(tile, x, held, o, j * ks, ks, m, N, m0, n0, step > 0);
  else
    tile_bf16(tile, x, held, o, j * ks, ks, m, N, m0, n0, step > 0);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch(const void* x, const void* w, void* buf, float* out, long long n, long long ks,
           long long m, long long N, long long step, cudaStream_t s) {
  const long long tiles = n * ((m + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  long long copy_blocks = 0;
  bool vec = false;
  if (step < n - 1) {
    const long long bytes = ks * N * (long long)sizeof(T);
    vec = bytes % 16 == 0 && aligned16(w) && aligned16(buf);
    const long long units = n * (vec ? bytes / 16 : ks * N);
    copy_blocks = (units + kThreads - 1) / kThreads;
    if (copy_blocks > kMaxCopyBlocks) copy_blocks = kMaxCopyBlocks;
  }
  const long long blocks = copy_blocks + tiles;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  ring_step_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(buf), out, n, ks,
      m, N, step, copy_blocks, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// One ring step of out [n, m, N] f32 (+)= x_t [n*ks, m] . w [n, ks, N] for
// every rank.  dtype of x_t, w and buf: 0 = f32, 1 = bf16.  buf is the
// [n, 2, ks, N] double buffer (may be null when n == 1).  Every tensor is
// contiguous; n, ks, m, N >= 1; 0 <= step < n; steps run in order on `stream`.
extern "C" int ring_matmul_step(const void* x_t, const void* w, void* buf, void* out,
                                int dtype, long long n, long long ks, long long m,
                                long long N, long long step, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || ks <= 0 || m <= 0 || N <= 0 || step < 0 || step >= n ||
      (buf == nullptr && n > 1))
    return (int)cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch<float>(x_t, w, buf, o, n, ks, m, N, step, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x_t, w, buf, o, n, ks, m, N, step, s);
  return (int)cudaErrorInvalidValue;
}
