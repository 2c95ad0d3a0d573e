// Fused all-gather matmul on the stacked rank axis, for Hopper (sm_90a).
//
// Replaces repro/kernels/ring_matmul/kernel.py:74 (ring_matmul_pallas) and
// computes what repro_torch/kernels/ring_matmul/ref.py:ring_schedule_ref
// computes:
//
//   x_t [K, m] (every rank's), w [n, ks, N] (rank r's shard at w[r], K = n*ks),
//   out [n, m, N] f32 = for each rank r, x_t.T @ concat(w[0], ..., w[n-1]),
//   summed shard by shard in the rank's own ring order.
//
// The TPU kernel runs one program a chip.  Each of its n steps starts a
// remote DMA of the shard it holds to the right neighbour's other buffer
// slot, multiplies that same shard into its output while the DMA flies, and
// waits; a barrier with both neighbours guards the reuse of a slot.  At step
// i rank r holds shard j = (r - i) mod n and adds x_t[j*ks : (j+1)*ks].T @
// held_r to its output.
//
// Bound (both variants): operations.  Every rank computes its own Y, so the
// work is 2 * n * m * K * N flops at the bf16 tensor-core rate (989
// TFLOP/s); the bytes that must move (x_t and w read once, out written
// once, 356 MB at the training run's up projection) take less.
//
// Two variants behind one entry point; the wrapper (kernels/ring_matmul/
// ops.py:variant) picks one from the dtype, n and the TMA's preconditions
// alone.
//
// "wgmma": bf16, 1 <= n <= 8, tensors the TMA can load.  One launch a call.
// A thread-block cluster of n blocks is the ring: block r of a cluster
// holds rank r's copy of an output tile, and the hardware schedules a
// cluster's blocks together, so every party of a ring step is resident
// (one flat launch with flags in device memory would deadlock at n >= 4:
// a forward must wait for readers that are not yet resident).
//   TPU kernel                        here
//   n chips                           the n blocks of a cluster
//   the VMEM slots `buf`              a ring of shared-memory slots
//   make_async_remote_copy            cp.async.bulk into the right neighbour's slot
//   recv_sem                          the receiver's mbarrier, completed by the bytes
//   send_sem                          an arrival the receiver posts back on the sender's slot
//   _neighbor_barrier                 a credit the receiver posts when its slot is free
// Against the four faults of the first version (the "simt" variant below):
//   - the accumulators stay in registers across all n ring steps and out[r]'s
//     tile is written once, never read (streaming stores): one pass over out
//     instead of 2n - 1;
//   - products are wgmma m64nBNk16, bf16 in, f32 accumulate, by two
//     consumer warpgroups of 64 rows, both operands read from shared memory
//     in the 128-byte swizzle the TMA writes: A is x_t's rows of the held
//     shard as stored, [k][m], B the held block as stored, [k][n]; both are
//     MN-major, read through the transpose bits of 16-bit wgmma.  The k loop
//     of a chunk is unrolled (one instance a chunk height), so no register
//     moves come between the wgmmas;
//   - x_t comes by TMA through a 3-D map [n, ks, m], so a shard's ragged k
//     end loads as zeros (never the next shard's rows), into a ring of
//     `stages` chunks paced by mbarriers; the block's own shard's columns
//     w[r][:, n0 : n0 + BN] come by TMA at step 0;
//   - the forward never touches device memory: the held block travels in
//     chunks of KC rows through a ring of `slots` chunk slots (the double
//     buffer, generalised: at the down projection a whole held block, 160
//     KiB, does not fit twice).  Chunk t of a block's stream (ring step i,
//     chunk c) is forwarded to position t + nkr of the right neighbour (nkr
//     chunks a shard), and the products read only what the forward
//     delivered, never w[j] itself, so the ring stays the algorithm.  The
//     ring cannot stall for good as long as it holds a chunk more than a
//     step's (slots > nkr), and with one spare slot each forward waits on a
//     chain of neighbours' credits, so the plan keeps two where it can;
//     where a shard's rows need more than the shared memory holds, they are
//     taken in rounds, each a whole ring of n steps, and the sum then runs
//     round by round.
// Persistent: as many clusters as can be resident walk the output tiles,
// each on one stream of chunks, so one tile's chunks load and travel while
// the consumers finish the last.  Tiles are 128 x 256 where the ring fits
// (the up projection; x_t, which every tile column reads again through L2,
// is then read half as often), else 128 x 128.  Warp roles: warps 0-7 are
// the consumers; warps 8-11 one thread each: the loader (TMA), the
// forwarder (the copy into the neighbour, once its credit has come), the
// credit poster and the acker.  Each walks the stream in order and none
// waits on another's later work.  A parity wait is only sound on a barrier
// at most one phase ahead of its waiter, so each barrier has one waiter
// that sees all of its phases and gates the next one.  Every block waits
// at a cluster barrier before it leaves, so no neighbour writes to the
// shared memory of a block that has gone.  No setmaxnreg: the accumulators
// (64 or 128 a thread) fit the 168 registers of a 384-thread block.  The
// wrapper picks the plan (tile width, KC, stages, slots, rounds) from the
// shared-memory budget and checks the TMA's rules in Python.
//
// "simt": f32, n > 8 and shapes the TMA refuses (the first version).
// The n ranks are rows of one device's tensors and every step is one launch
// of this kernel over all ranks, `ring_step_kernel`, called n times in
// stream order.  The launch boundary is the neighbour barrier: step i + 1
// writes the slot step i read only after step i has finished.  Inside a
// launch the first `copy_blocks` blocks forward every rank's held shard,
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
// masked with zeros.  The partial sums are read and written once a step,
// (2n - 1) passes over out: the price of one launch a step.

#include <cuda.h>
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

// ------------------------------------------------------------------ wgmma

constexpr int kTcBM = 128;                  // output rows a block: 2 consumer warpgroups x 64
constexpr int kConsumerWarps = 8;
constexpr int kTcThreads = (kConsumerWarps + 4) * 32;   // + one warpgroup of four role warps
constexpr uint32_t kRowBytes = 128;         // a row of a TMA box: 64 bf16, 128-byte swizzle
constexpr uint32_t kMaxSmem = 232448;       // dynamic shared memory a block may have
constexpr int kMaxRanks = 8;                // the portable cluster size

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster, release / acquire
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// the address of this block's shared-memory word `addr` in cluster block `rank`
__device__ __forceinline__ uint32_t peer(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
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

// an arrival on a barrier of another block of the cluster (`bar` from `peer`)
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx_peer(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.release.cluster.shared::cluster.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// spin until the phase of parity `parity` has completed (acquire at cluster
// scope: some of the arrivals come from the neighbours)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-D tensor map (columns, rows, shard) into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int shard) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(shard)
      : "memory");
}

// `bytes` of this block's shared memory into a neighbour's (`dst`, `bar` from
// `peer`); completes on the neighbour's barrier
__device__ __forceinline__ void copy_to_peer(uint32_t dst, uint32_t src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; byte offsets in 16-byte
// units.  MN-major operands: lbo steps between 64-element column boxes, sbo
// between groups of 8 rows of k.
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

// d[64] += A (64 x 16, smem, MN-major) . B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16_tt(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "l"(da), "l"(db), "r"(1));
}

// d[128] += A (64 x 16, smem, MN-major) . B (16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_m64n256k16_tt(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56),
        ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96), ACC8(104), ACC8(112), ACC8(120)
      : "l"(da), "l"(db), "r"(1));
}

#undef ACC8

__device__ __forceinline__ void wgmma_tt(float (&d)[64], uint64_t da, uint64_t db) {
  wgmma_m64n128k16_tt(d, da, db);
}
__device__ __forceinline__ void wgmma_tt(float (&d)[128], uint64_t da, uint64_t db) {
  wgmma_m64n256k16_tt(d, da, db);
}

// The shared-memory plan of one launch (the wrapper computes it,
// kernels/ring_matmul/ops.py:plan): output tiles of 128 x bn; chunks of kc
// rows of the k dim; x_t's chunks (kc x 128) in a ring of `stages`, the held
// block's (kc x bn) in a ring of `slots`; a round is nkr chunks of every
// shard, and `rounds` of them cover ks.  `bytes` is the formula of
// ops.py:Plan.smem, which the wrapper's plan is sized by; a plan whose bytes
// exceed kMaxSmem is refused at launch.
struct Plan {
  int bn, kc, stages, slots, nkr, rounds;
  __host__ __device__ uint32_t box() const { return (uint32_t)kc * kRowBytes; }   // kc x 64 bf16
  __host__ __device__ uint32_t a_chunk() const { return 2 * box(); }
  __host__ __device__ uint32_t w_chunk() const { return (uint32_t)(bn / 64) * box(); }
  __host__ __device__ uint32_t bars() const {
    return (uint32_t)stages * a_chunk() + (uint32_t)slots * w_chunk();
  }
  __host__ __device__ uint32_t bytes() const { return bars() + 8u * (2 * stages + 4 * slots) + 1024u; }
};

// Persistent: cluster c of G walks output tiles c, c + G, c + 2G, ...
// (numbered m-tile by m-tile, so the G tiles in flight share x_t's columns
// in L2), all on one stream of chunks: chunk t of a block's stream is
// chunk tau = t % per_tile of the cluster's tile t / per_tile, and tau is
// round g, ring step i, chunk c of the round.  Rank r holds shard j =
// (r - i) mod n at step i.  Stream position t of rank r is forwarded to
// position t + nkr of rank r + 1 (if i < n - 1).  The next tile's chunks
// load and travel while the consumers finish this one.
template <int BN, int KC>
__global__ void __launch_bounds__(kTcThreads, 1) ring_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    float* __restrict__ out, int n, int m, int N, Plan p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms on 1 KiB
  // a chunk is 64-column boxes of kc rows: two of x_t's, BN / 64 of the held block's
  constexpr uint32_t box = KC * kRowBytes, a_chunk = 2 * box, w_chunk = BN / 64 * box;
  const int stages = p.stages, slots = p.slots, nkr = p.nkr;
  auto a_s = [&](int st) { return base + st * a_chunk; };
  auto w_s = [&](int sl) { return base + stages * a_chunk + sl * w_chunk; };
  const uint32_t bars = base + p.bars();
  auto a_full = [&](int st) { return bars + 8 * st; };
  auto a_empty = [&](int st) { return bars + 8 * (stages + st); };
  auto w_full = [&](int sl) { return bars + 8 * (2 * stages + sl); };
  auto w_empty = [&](int sl) { return bars + 8 * (2 * stages + slots + sl); };
  auto credit = [&](int sl) { return bars + 8 * (2 * stages + 2 * slots + sl); };
  auto tma_ok = [&](int sl) { return bars + 8 * (2 * stages + 3 * slots + sl); };

  const int r = (int)cluster_rank();
  const uint32_t right = (r + 1) % n, left = (r + n - 1) % n;
  const int tiles_n = (N + BN - 1) / BN, n_tiles = ((m + kTcBM - 1) / kTcBM) * tiles_n;
  const int G = gridDim.x / n, cid = blockIdx.x / n;
  const int my_tiles = cid < n_tiles ? (n_tiles - cid + G - 1) / G : 0;
  const int per_round = n * nkr, per_tile = p.rounds * per_round, total = my_tiles * per_tile;
  auto step = [&](int t) { return (t % per_round) / nkr; };
  auto row = [&](int t) {                                       // in the shard
    return ((t % per_tile / per_round) * nkr + t % nkr) * KC;
  };
  auto tile_m0 = [&](int t) { return (cid + t / per_tile * G) / tiles_n * kTcBM; };
  auto tile_n0 = [&](int t) { return (cid + t / per_tile * G) % tiles_n * BN; };

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(a_full(st), 1);
      mbar_init(a_empty(st), kConsumerWarps);
    }
    // w_empty: the consumer warps, one arrival for the way in (the acker)
    // and one for the way out (the right neighbour's acker, or the
    // forwarder where nothing is forwarded)
    for (int sl = 0; sl < slots; ++sl) {
      mbar_init(w_full(sl), 1);
      mbar_init(w_empty(sl), kConsumerWarps + 2);
      mbar_init(credit(sl), 1);
      mbar_init(tma_ok(sl), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();   // the neighbours' barriers exist before any arrival or copy reaches them

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumerWarps) {
    // four role warps, one thread each, every one in stream order; no role
    // waits on another's later work, so the ring cannot deadlock as long as
    // slots > nkr (the wrapper's plan).  A parity wait is only sound on a
    // barrier at most one phase ahead of its waiter, so every barrier has
    // one waiter that sees each of its phases and gates the next: w_full's
    // the acker (its arrival on w_empty lets a slot be refilled), w_empty's
    // the credit poster, credit's the forwarder, tma_ok's the loader.
    const int role = warp - kConsumerWarps;
    if (lane == 0 && role == 0) {
      // loader: x_t's chunk of the shard held at step i, and at step 0 the
      // block's own shard's chunk w[r][rows, n0 : n0 + BN]
      uint64_t phase = 0;                            // bit sl: parity of slot sl's next tma_ok
      for (int t = 0; t < total; ++t) {
        const int i = step(t), rw = row(t), st = t % stages;
        const int m0 = tile_m0(t), n0 = tile_n0(t);
        if (t >= stages) mbar_wait(a_empty(st), (t / stages - 1) & 1);
        mbar_expect_tx(a_full(st), a_chunk);
        const int j = (r - i + n) % n;
        tma_load(a_s(st), &xmap, a_full(st), m0, rw, j);
        tma_load(a_s(st) + box, &xmap, a_full(st), m0 + 64, rw, j);
        if (i == 0) {
          const int sl = t % slots;
          if (t >= slots) {
            mbar_wait(tma_ok(sl), (uint32_t)(phase >> sl) & 1);
            phase ^= 1ull << sl;
          }
          mbar_expect_tx(w_full(sl), w_chunk);
#pragma unroll
          for (int x = 0; x < BN / 64; ++x)
            tma_load(w_s(sl) + x * box, &wmap, w_full(sl), n0 + 64 * x, rw, r);
        }
      }
    } else if (lane == 0 && role == 1) {
      // forwarder (the TPU kernel's remote copy): once a chunk is here, copy
      // it into the right neighbour's slot for position t + nkr when that
      // slot's credit has come; a chunk of the last step goes nowhere
      uint64_t phase = 0;                            // bit sl: parity of slot sl's next credit
      for (int t = 0; t < total; ++t) {
        const int sl = t % slots;
        mbar_wait(w_full(sl), (t / slots) & 1);
        if (step(t) < n - 1) {
          const int u = t + nkr, dsl = u % slots;
          if (u >= slots) {
            mbar_wait(credit(dsl), (uint32_t)(phase >> dsl) & 1);
            phase ^= 1ull << dsl;
          }
          const uint32_t full = peer(w_full(dsl), right);
          mbar_expect_tx_peer(full, w_chunk);
          copy_to_peer(peer(w_s(dsl), right), w_s(sl), w_chunk, full);
        } else {
          mbar_arrive(w_empty(sl));                  // the way out
        }
      }
    } else if (lane == 0 && role == 2) {
      // credit (the TPU kernel's neighbour barrier): once a slot's last
      // chunk is released, its next may come: from the left neighbour (a
      // credit there) or, at step 0, from the loader
      for (int u = slots; u < total; ++u) {
        const int sl = u % slots;
        mbar_wait(w_empty(sl), (u / slots - 1) & 1);
        if (step(u) == 0)
          mbar_arrive(tma_ok(sl));
        else
          mbar_arrive_peer(peer(credit(sl), left));
      }
    } else if (lane == 0 && role == 3) {
      // acker (the TPU kernel's send semaphore): a chunk that arrived from
      // the left neighbour has been read out of its slot there
      for (int u = 0; u < total; ++u) {
        const int sl = u % slots;
        mbar_wait(w_full(sl), (u / slots) & 1);
        if (step(u) > 0) mbar_arrive_peer(peer(w_empty((u - nkr) % slots), left));
        mbar_arrive(w_empty(sl));                    // the way in
      }
    }
  } else {
    // two consumer warpgroups of 64 rows: a tile's accumulators for all n
    // ring steps, written once when its last chunk is in
    const int wg = warp / 4, g = lane / 4, q = lane % 4;
    float acc[BN / 2];
    auto release = [&](int t) {
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(a_empty(t % stages));
        mbar_arrive(w_empty(t % slots));
      }
    };
    float* o = out + (long long)r * m * N;
    for (int t0 = 0; t0 < total; t0 += per_tile) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      for (int t = t0; t < t0 + per_tile; ++t) {
        const int st = t % stages, sl = t % slots;
        mbar_wait(a_full(st), (t / stages) & 1);
        mbar_wait(w_full(sl), (t / slots) & 1);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk)   // unrolled: no register moves between the wgmmas
          wgmma_tt(acc, smem_desc(a_s(st) + wg * box + kk * 16 * kRowBytes, box, 1024),
                   smem_desc(w_s(sl) + kk * 16 * kRowBytes, box, 1024));
        wgmma_commit();
        if (t > t0) {
          wgmma_wait<1>();
          fence_regs(acc);
          release(t - 1);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(t0 + per_tile - 1);

      // acc[i] holds row 16 * (warp % 4) + g + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2q + i % 2
      const int m0 = tile_m0(t0), n0 = tile_n0(t0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = m0 + 64 * wg + 16 * (warp % 4) + g + 8 * h;
        if (rr >= m) continue;
        float* o_row = o + (long long)rr * N;
#pragma unroll
        for (int cc = 0; cc < BN / 8; ++cc) {
          const int col = n0 + 8 * cc + 2 * q;
          const float v0 = acc[4 * cc + 2 * h], v1 = acc[4 * cc + 2 * h + 1];
          if ((N & 1) == 0) {   // streaming stores: out is written once, never read here
            if (col < N) __stcs(reinterpret_cast<float2*>(o_row + col), make_float2(v0, v1));
          } else {
            if (col < N) o_row[col] = v0;
            if (col + 1 < N) o_row[col + 1] = v1;
          }
        }
      }
    }
  }
  __syncwarp();
  cluster_sync();   // no block leaves while a neighbour may still write to its shared memory
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

// a 3-D map (cols, rows, shards) of bf16, strides in elements; boxes of 64
// columns x kc rows, so rows past `rows` (a shard's ragged end) and columns
// past `cols` load as zeros
bool make_map(CUtensorMap* map, const void* ptr, long long cols, long long rows, long long shards,
              long long s_row, long long s_shard, int kc) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)shards};
  const cuuint64_t strides[2] = {(cuuint64_t)s_row * 2, (cuuint64_t)s_shard * 2};
  const cuuint32_t boxd[3] = {64, (cuuint32_t)kc, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                boxd, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int KC>
int launch_wgmma(const void* x, const void* w, float* out, long long n, long long ks, long long m,
                 long long N, const long long (&st)[4], const Plan& p, cudaStream_t s) {
  // a free slot beyond one step's chunks; two of each ring, since a consumer
  // holds one chunk while it waits for the next
  const bool ring_ok = n == 1 || p.slots > p.nkr;
  if (n > kMaxRanks || p.kc != KC || p.bn != BN || p.stages < 2 || p.slots < 2 ||
      p.slots > 64 || p.nkr < 1 || p.rounds < 1 || !ring_ok ||
      (long long)p.rounds * p.nkr * p.kc < ks || p.bytes() > kMaxSmem || m >= (1LL << 31) ||
      N >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = ((m + kTcBM - 1) / kTcBM) * ((N + BN - 1) / BN);
  // chunk counts of a block's stream stay in int
  if (n_tiles * p.rounds * n * p.nkr >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  CUtensorMap xm, wm;
  if (!make_map(&xm, x, m, ks, n, st[1], st[0], p.kc) ||
      !make_map(&wm, w, N, ks, n, st[3], st[2], p.kc))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ring_wgmma_kernel<BN, KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.bytes());
  if (err != cudaSuccess) return (int)err;
  // clusters of n blocks (rank r's copy of a tile in block r), as many as
  // can be resident at once (at most one a tile), each walking its tiles
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = p.bytes();
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;   // how many clusters of this shape can be resident at once
  err = cudaOccupancyMaxActiveClusters(&clusters, ring_wgmma_kernel<BN, KC>, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters <= 0) return (int)cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3((unsigned)(n * (n_tiles < clusters ? n_tiles : clusters)));
  err = cudaLaunchKernelEx(&cfg, ring_wgmma_kernel<BN, KC>, xm, wm, out, (int)n, (int)m, (int)N, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// one instance a tile width (128, 256) and chunk height (ops.py:CHUNK_ROWS)
int dispatch_wgmma(const void* x, const void* w, float* out, long long n, long long ks,
                   long long m, long long N, const long long (&st)[4], const Plan& p,
                   cudaStream_t s) {
#define RING_CASE(BN, KC) \
  if (p.bn == BN && p.kc == KC) return launch_wgmma<BN, KC>(x, w, out, n, ks, m, N, st, p, s);
  RING_CASE(128, 16) RING_CASE(128, 32) RING_CASE(128, 48) RING_CASE(128, 64)
  RING_CASE(256, 16) RING_CASE(256, 32) RING_CASE(256, 48) RING_CASE(256, 64)
#undef RING_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// out [n, m, N] f32 = every rank's x_t [n*ks, m] . w [n, ks, N].  dtype of
// x_t and w: 0 = f32, 1 = bf16; n, ks, m, N >= 1; every tensor contiguous.
// variant 0 ("simt"): one ring step `step` (0 <= step < n; steps run in
// order on `stream`); buf is the [n, 2, ks, N] double buffer (may be null
// when n == 1).  variant 1 ("wgmma"): the whole ring in one launch (bf16,
// n <= 8, step 0, buf unused); xs_* and ws_* are the shard and row strides,
// in elements, of the TMA maps of x_t [n, ks, m] and w [n, ks, N] (base
// 16-byte aligned, strides multiples of 8 elements); bn (128 or 256), kc,
// stages, slots, nkr, rounds the plan (ops.py:plan).
extern "C" int ring_matmul(const void* x_t, const void* w, void* buf, void* out, int dtype,
                           long long n, long long ks, long long m, long long N, long long step,
                           int variant, long long xs_shard, long long xs_row, long long ws_shard,
                           long long ws_row, int bn, int kc, int stages, int slots, int nkr,
                           int rounds, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || ks <= 0 || m <= 0 || N <= 0 || step < 0 || step >= n)
    return (int)cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  if (variant == 1) {
    if (dtype != 1 || step != 0) return (int)cudaErrorInvalidValue;
    const long long st[4] = {xs_shard, xs_row, ws_shard, ws_row};
    const Plan p{bn, kc, stages, slots, nkr, rounds};
    return dispatch_wgmma(x_t, w, o, n, ks, m, N, st, p, s);
  }
  if (variant != 0 || (buf == nullptr && n > 1)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x_t, w, buf, o, n, ks, m, N, step, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x_t, w, buf, o, n, ks, m, N, step, s);
  return (int)cudaErrorInvalidValue;
}
