// Paged attention over a page table, f32, for Hopper (sm_90a).
//
// Replaces two TPU kernels of repro/kernels/paged_attention/kernel.py and
// computes what repro_torch/kernels/paged_attention/ref.py computes:
//
//   paged_attention_pallas        q [m, Sq, hd], kv_pages [n_pages, pt, 2, hd]
//                                 (K and V interleaved), ids [m, k] int32
//                                 -> out [m, Sq, hd]; row (i, s) attends over
//                                 the pt*k tokens of pages ids[i, :].
//   paged_attention_shift_pallas  q [p, Sq, hd], kv_pages [p, n_pages, pt, 2,
//                                 hd], ids [p, k] -> out [p, Sq, hd]; rank r
//                                 attends over pages ids[r, :] of rank
//                                 (r + shift) mod p's pool.
//
// In both, id < 0 masks the page (the requester's id decides); a fully
// masked row gives 0 (acc / max(l, 1e-30)), never NaN; causal keeps key u
// iff u <= s + (Sk - Sq) with Sk = k*pt, masked pages counted.  The caller
// applies the softmax scale to q before the launch.
//
// Design: one block per query row with hd threads (hd % 32 == 0,
// hd <= 1024); both kernels share the row's page walk (`attend_row`).  The
// block walks j = 0..k-1 and reads its page id itself (the TPU kernel got
// it by scalar prefetch).  A masked page is skipped outright: it adds
// nothing, so it is not even read (the TPU still moved a clamped row because
// its schedule was static).  Per page, warp w computes the scores of tokens
// w, w+n_warps, ... with a shuffle reduction over the lanes' hd/32 slices of
// q.k; then every thread folds the page into an fp32 online softmax (m, l,
// acc) for its own output column, as _accumulate does in the TPU kernels.
// The shift kernel resolves the owner's pool inside the kernel, (r + shift)
// mod p: the TPU kernel's id swap and 2-slot stream of remote pages become
// reads of another rank's slice of the same array.
//
// Bound: the bytes it must read, valid pages x pt x 2 x hd x 4, at the
// card's memory rate; the arithmetic is ~4 flops per byte read.  This first
// version does not approach that bound when few rows are valid: each row's
// page walk is serial inside one block.  Making it fast — split-K over
// pages with a second reduction pass, cp.async/TMA staging of the next
// page, more than one query row per block — is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxChunks = 32;  // hd / 32 <= 32, i.e. hd <= 1024

// One query row s attends over the k pages ids_row[0..k) of `pool`
// [n_pages, pt, 2, hd]; q_row and out_row are that row's hd floats.
// `scores` holds pt floats of shared memory.  Every thread of the block
// calls it; control flow is uniform across the block.
__device__ __forceinline__ void attend_row(
    const float* __restrict__ q_row, const float* __restrict__ pool,
    const int32_t* __restrict__ id_row, float* __restrict__ out_row,
    float* scores, int s, int Sq, int hd, int n_pages, int pt, int k,
    int causal) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_warps = blockDim.x >> 5;
  const int chunks = hd >> 5;

  // this lane's slice of q for the warp dot products: q[c * 32 + lane]
  float q_reg[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c)
    q_reg[c] = (c < chunks) ? q_row[c * 32 + lane] : 0.0f;

  const int horizon = s + k * pt - Sq;  // causal: key u visible iff u <= horizon
  const size_t page_elems = (size_t)pt * 2 * hd;
  const size_t token_stride = (size_t)2 * hd;

  float m_run = kNegInf, l_run = 0.0f, acc = 0.0f;
  for (int j = 0; j < k; ++j) {
    int pid = id_row[j];  // the same for every thread: control flow is uniform
    if (pid < 0) continue;                   // masked page: adds nothing
    if (causal && j * pt > horizon) break;   // this and every later page masked
    if (pid >= n_pages) pid = n_pages - 1;   // clamp, as the reference does
    const float* page = pool + (size_t)pid * page_elems;
    const int n_vis = causal ? min(pt, horizon - j * pt + 1) : pt;

    // scores of the page's visible tokens: warp w takes w, w + n_warps, ...
    for (int u = warp; u < n_vis; u += n_warps) {
      const float* k_row = page + (size_t)u * token_stride;
      float d = 0.0f;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c)
        if (c < chunks) d += q_reg[c] * k_row[c * 32 + lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if (lane == 0) scores[u] = d;
    }
    __syncthreads();

    // online softmax step for this thread's output column t
    float m_pg = kNegInf;
    for (int u = 0; u < n_vis; ++u) m_pg = fmaxf(m_pg, scores[u]);
    const float m_new = fmaxf(m_run, m_pg);
    const float corr = expf(m_run - m_new);
    const float* v_col = page + hd + t;
    float p_sum = 0.0f, pv = 0.0f;
#pragma unroll 4
    for (int u = 0; u < n_vis; ++u) {
      const float p = expf(scores[u] - m_new);
      p_sum += p;
      pv += p * v_col[(size_t)u * token_stride];
    }
    l_run = l_run * corr + p_sum;
    acc = acc * corr + pv;
    m_run = m_new;
    __syncthreads();  // scores[] is rewritten by the next page
  }
  out_row[t] = acc / fmaxf(l_run, 1e-30f);
}

// pool-local: row (i, s) over pages ids[i, :] of the one pool
__global__ void paged_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ kv,
    const int32_t* __restrict__ ids, float* __restrict__ out,
    int Sq, int hd, int n_pages, int pt, int k, int causal) {
  extern __shared__ float scores[];  // [pt] scores of the current page
  const int row = blockIdx.x;        // i * Sq + s
  const int i = row / Sq;
  attend_row(q + (size_t)row * hd, kv, ids + (size_t)i * k,
             out + (size_t)row * hd, scores, row - i * Sq, Sq, hd, n_pages,
             pt, k, causal);
}

// cross-rank: row (r, s) over pages ids[r, :] of rank (r + off) mod p's
// pool, 0 <= off < p
__global__ void paged_attention_shift_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ kv,
    const int32_t* __restrict__ ids, float* __restrict__ out, int p, int off,
    int Sq, int hd, int n_pages, int pt, int k, int causal) {
  extern __shared__ float scores[];
  const int row = blockIdx.x;        // r * Sq + s
  const int r = row / Sq;
  int owner = r + off;
  if (owner >= p) owner -= p;
  const float* pool = kv + (size_t)owner * n_pages * pt * 2 * hd;
  attend_row(q + (size_t)row * hd, pool, ids + (size_t)r * k,
             out + (size_t)row * hd, scores, row - r * Sq, Sq, hd, n_pages,
             pt, k, causal);
}

}  // namespace

// C entry: pointers and the stream as void*, sizes as int.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int paged_attention_f32(const void* q, const void* kv_pages,
                                   const void* ids, void* out, int m, int Sq,
                                   int hd, int n_pages, int pt, int k,
                                   int causal, void* stream) {
  const int rows = m * Sq;
  if (rows == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)pt * sizeof(float);
  paged_attention_f32_kernel<<<rows, hd, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kv_pages),
      static_cast<const int32_t*>(ids), static_cast<float*>(out), Sq, hd,
      n_pages, pt, k, causal);
  return (int)cudaGetLastError();
}

// Cross-rank entry: rank r attends over pages ids[r] of pool
// (r + shift) mod p.  Returns cudaGetLastError() after the launch.
extern "C" int paged_attention_shift_f32(const void* q, const void* kv_pages,
                                         const void* ids, void* out, int p,
                                         int shift, int Sq, int hd,
                                         int n_pages, int pt, int k,
                                         int causal, void* stream) {
  const int rows = p * Sq;
  if (rows == 0) return (int)cudaSuccess;
  const int off = ((shift % p) + p) % p;
  const size_t smem = (size_t)pt * sizeof(float);
  paged_attention_shift_f32_kernel<<<rows, hd, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kv_pages),
      static_cast<const int32_t*>(ids), static_cast<float*>(out), p, off, Sq,
      hd, n_pages, pt, k, causal);
  return (int)cudaGetLastError();
}
