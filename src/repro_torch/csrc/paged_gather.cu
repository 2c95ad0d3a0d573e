// Cross-rank paged gather on the stacked rank axis, for Hopper (sm_90a).
//
// Replaces repro/kernels/paged_gather/kernel.py:paged_gather_pallas.
// Computes what repro_torch/kernels/paged_gather/ref.py computes:
//   pages [p, n_pages, w] 32-bit words, ids [p, k] int32 -> out [p, k, w],
//   out[r, j, :] = pages[(r + shift) mod p, clamp(ids[r, j], 0, n_pages-1), :]
// and, in hole mode, what rmem.pages.gather_shift computes: the same, but a
// row whose id is < 0 is written as zero words and never read (an id past
// the pool still clamps).  That is the reference's gather of the clamped ids
// followed by its mask of the holes, in one pass.
//
// The TPU kernel sends the requester's id list to the owner chip, the owner
// packs the rows into a staging block, and one remote DMA brings the block
// back.  Here every rank's pool is a slice of one array on this card, so
// the id message and the packed reply collapse into one pass: each output
// row is read once from the owner's pool and written once.  No staging
// block exists.
//
// Bound: bytes.  Every output row is written once and every distinct pool
// row it names read once (a hole reads nothing in hole mode), plus the ids.
// Design: persistent blocks (as many as the card holds at once), each dealt
// whole output rows (row q, q + grid, ...).  A row's id is read once, by
// lane 0 of each warp, clamped once and broadcast with the source row's
// offset by a shuffle, so no thread divides per element.  The block's 256
// threads copy the row in 16-byte vectors (single words where w is not a
// whole number of vectors or a pointer is not 16-byte aligned), kUnroll
// loads in flight per thread before their stores, which stream past L2
// (st.global.cs: the output is written once and not read again here).
// A TMA 1-D bulk copy (global -> shared -> global in 8 KiB chunks) was
// measured slower at the rendezvous pull's inputs (PERF.md) and dropped.

#include "rotate.cuh"

namespace {

constexpr int kUnroll = 4;         // vectors a thread has in flight

// The pool row (of its p * n_pages) that output row q reads, or -1 for a
// hole in hole mode: row q is rank r = q / k's, read from rank
// (r + off) mod p.
__device__ __forceinline__ long long source_row(const int32_t* __restrict__ ids,
                                                long long q, long long k, long long p,
                                                long long n_pages, long long off,
                                                bool holes) {
  int32_t id = ids[q];
  if (holes && id < 0) return -1;
  if (id < 0) id = 0;
  if ((long long)id >= n_pages) id = (int32_t)(n_pages - 1);
  long long src = q / k + off;
  if (src >= p) src -= p;
  return src * n_pages + id;
}

__device__ __forceinline__ void store_cs(uint4* p, uint4 v) { __stcs(p, v); }
__device__ __forceinline__ void store_cs(uint32_t* p, uint32_t v) { __stcs(p, v); }
__device__ __forceinline__ uint4 zero_of(uint4) { return make_uint4(0u, 0u, 0u, 0u); }
__device__ __forceinline__ uint32_t zero_of(uint32_t) { return 0u; }

// rows = p * k output rows of vw V-units each
template <typename V, bool HOLES>
__global__ void __launch_bounds__(kThreads) gather_rows(
    const V* __restrict__ pages, const int32_t* __restrict__ ids, V* __restrict__ out,
    long long rows, long long k, long long p, long long n_pages, int vw, long long off) {
  const int lane = threadIdx.x & 31;
  for (long long q = blockIdx.x; q < rows; q += gridDim.x) {
    long long row = 0;
    if (lane == 0) row = source_row(ids, q, k, p, n_pages, off, HOLES);
    row = __shfl_sync(0xffffffffu, row, 0);
    V* dst = out + q * vw;
    if (HOLES && row < 0) {
      for (int j = threadIdx.x; j < vw; j += kThreads) store_cs(dst + j, zero_of(V()));
      continue;
    }
    const V* src = pages + row * vw;
    for (int j0 = threadIdx.x; j0 < vw; j0 += kThreads * kUnroll) {
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kThreads;
        if (j < vw) v[u] = __ldg(src + j);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kThreads;
        if (j < vw) store_cs(dst + j, v[u]);
      }
    }
  }
}

// The persistent grid: as many blocks as the card holds at once (`per_sm`,
// looked up on the instance's first launch), no more than there are rows.
template <typename V, bool HOLES>
int launch(const void* pages, const int32_t* ids, void* out, long long rows, long long k,
           long long p, long long n_pages, long long vw, long long off, cudaStream_t s) {
  static int per_sm = 0;
  auto kernel = gather_rows<V, HOLES>;
  if (per_sm < 1 &&
      (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
           cudaSuccess ||
       per_sm < 1))
    per_sm = 1;
  const long long most = (long long)per_sm * sm_count();
  kernel<<<(int)(rows < most ? rows : most), kThreads, 0, s>>>(
      static_cast<const V*>(pages), ids, static_cast<V*>(out), rows, k, p, n_pages, (int)vw,
      off);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry: pointers and the stream as void*, sizes in 32-bit words as long
// long; holes 1 = hole mode.  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int paged_gather_shift(const void* pages, const void* ids, void* out, long long p,
                                  long long n_pages, long long w, long long k, long long shift,
                                  int holes, void* stream) {
  if (p < 0 || k < 0 || w < 0) return (int)cudaErrorInvalidValue;
  if (p * k * w == 0) return (int)cudaSuccess;
  if (n_pages < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long off = mod(shift, p);
  const long long rows = p * k;
  const bool vec = w % 4 == 0 && aligned16(pages) && aligned16(out);
  const int32_t* id = static_cast<const int32_t*>(ids);
  const long long vw = vec ? w / 4 : w;
  if (vw >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (vec)
    return holes ? launch<uint4, true>(pages, id, out, rows, k, p, n_pages, vw, off, s)
                 : launch<uint4, false>(pages, id, out, rows, k, p, n_pages, vw, off, s);
  return holes ? launch<uint32_t, true>(pages, id, out, rows, k, p, n_pages, vw, off, s)
               : launch<uint32_t, false>(pages, id, out, rows, k, p, n_pages, vw, off, s);
}
