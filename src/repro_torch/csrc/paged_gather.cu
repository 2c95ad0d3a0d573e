// Cross-rank paged gather on the stacked rank axis, for Hopper (sm_90a).
//
// Replaces repro/kernels/paged_gather/kernel.py:paged_gather_pallas.
// Computes what repro_torch/kernels/paged_gather/ref.py computes:
//   pages [p, n_pages, w] 32-bit words, ids [p, k] int32 -> out [p, k, w],
//   out[r, j, :] = pages[(r + shift) mod p, clamp(ids[r, j], 0, n_pages-1), :]
// (an id < 0 or >= n_pages reads a clamped row; the caller masks it, as
// rmem.pages.gather_shift does).
//
// The TPU kernel sends the requester's id list to the owner chip, the owner
// packs the rows into a staging block, and one remote DMA brings the block
// back.  Here every rank's pool is a slice of one array on this card, so
// the id message and the packed reply collapse into one pass: each output
// word is read once from the owner's pool and written once.  No staging
// block exists.
//
// Bound: bytes.  The gather reads p*k*w words and writes as many (plus the
// ids), so the least time is those bytes / the card's memory rate.  Design:
// one thread per output element (rows are pages of a few KiB, p*k of them),
// whose row and rank are two integer divisions; the row's id is read by
// every thread of the row and served from L1.  16-byte vectors when w is a
// whole number of 16-byte vectors and both pointers are 16-byte aligned;
// 32-bit indices while every index fits, 64-bit otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 2147483647LL;
// 32-bit indices while i + the grid's stride cannot pass 2^32
constexpr long long kMax32 = (1LL << 31) - 2 * kThreads;

inline int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// out row (r, j) = pages row (r + off) mod p, clamped id; sizes in V units,
// 0 <= off < p, n_pages >= 1
template <typename V, typename I>
__global__ void paged_gather_kernel(const V* __restrict__ pages,
                                    const int32_t* __restrict__ ids,
                                    V* __restrict__ out, I p, I n_pages, I w,
                                    I k, I off) {
  const I n = p * k * w;
  const I step = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    const I row = i / w;  // r * k + j
    const I r = row / k;
    int32_t id = ids[row];
    if (id < 0) id = 0;
    if ((I)id >= n_pages) id = (int32_t)(n_pages - 1);
    I src = r + off;
    if (src >= p) src -= p;
    out[i] = pages[(src * n_pages + (I)id) * w + (i - row * w)];
  }
}

}  // namespace

// C entry: pointers and the stream as void*, sizes in 32-bit words as long
// long.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int paged_gather_shift(const void* pages, const void* ids,
                                  void* out, long long p, long long n_pages,
                                  long long w, long long k, long long shift,
                                  void* stream) {
  if (p * k * w == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const long long off = ((shift % p) + p) % p;
  const bool vec = w % 4 == 0 && aligned16(pages) && aligned16(out);
  const long long vw = vec ? w / 4 : w;
  // the pool's p * n_pages rows and the output's p * k bound the index type
  const long long rows = n_pages > k ? n_pages : k;
  const bool small = p * rows * vw < kMax32;
  const int blocks = blocks_for(p * k * vw);
  const int32_t* id = static_cast<const int32_t*>(ids);
  if (vec) {
    const uint4* src = static_cast<const uint4*>(pages);
    uint4* dst = static_cast<uint4*>(out);
    if (small)
      paged_gather_kernel<uint4, uint32_t><<<blocks, kThreads, 0, s>>>(
          src, id, dst, (uint32_t)p, (uint32_t)n_pages, (uint32_t)vw,
          (uint32_t)k, (uint32_t)off);
    else
      paged_gather_kernel<uint4, uint64_t><<<blocks, kThreads, 0, s>>>(
          src, id, dst, (uint64_t)p, (uint64_t)n_pages, (uint64_t)vw,
          (uint64_t)k, (uint64_t)off);
  } else {
    const uint32_t* src = static_cast<const uint32_t*>(pages);
    uint32_t* dst = static_cast<uint32_t*>(out);
    if (small)
      paged_gather_kernel<uint32_t, uint32_t><<<blocks, kThreads, 0, s>>>(
          src, id, dst, (uint32_t)p, (uint32_t)n_pages, (uint32_t)vw,
          (uint32_t)k, (uint32_t)off);
    else
      paged_gather_kernel<uint32_t, uint64_t><<<blocks, kThreads, 0, s>>>(
          src, id, dst, (uint64_t)p, (uint64_t)n_pages, (uint64_t)vw,
          (uint64_t)k, (uint64_t)off);
  }
  return (int)cudaGetLastError();
}
