// The row rotation shared by the one-sided kernels (rma.cu) and the
// notified put (rmaq.cu): launch geometry (also the paged gather's,
// paged_gather.cu), the access / index type dispatch, and the per-element
// rotation of rank blocks.  Every rank lives
// on this card as one row block of a stacked array.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// One thread per element, so every element's load is in flight at once: a
// grid capped at 16 blocks an SM, each thread looping over ~20 elements, ran
// 4-5 % slower on an H100 (141.6 vs 135.2 us at the MILC halo, where
// Tensor.copy_ of the same bytes took 135.3 us).  The grid-stride loops only
// matter past 2^31 - 1 blocks.
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 2147483647LL;
// 32-bit indices while i + the grid's stride cannot pass 2^32
constexpr long long kMax32 = (1LL << 31) - 2 * kThreads;

inline int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

// The current device's SM count (a persistent grid's width), looked up once
// a device.
inline int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int n = dev >= 0 && dev < 64 ? cached[dev] : 0;
  if (n <= 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
    if (dev >= 0 && dev < 64) cached[dev] = n;
  }
  return n;
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// The last word a [p, row] input at rank stride `stride` reaches, plus one.
inline long long extent(long long p, long long row, long long stride) {
  const long long last = (p - 1) * stride + row;
  return last > p * row ? last : p * row;
}

// Calls f(V(), I()) with V the access type (uint4 when `vec`, else one
// word) and I the index type (32-bit when `words` fits, else 64-bit).
template <typename F>
void dispatch(bool vec, long long words, F f) {
  const bool small = (vec ? words / 4 : words) < kMax32;
  if (vec) {
    if (small) f(uint4(), uint32_t());
    else f(uint4(), uint64_t());
  } else {
    if (small) f(uint32_t(), uint32_t());
    else f(uint32_t(), uint64_t());
  }
}

// Element i of the contiguous [p, row] output: out row r = x row
// (r + off) mod p, read at rank stride `stride`; sizes in V units,
// 0 <= off < p.
template <typename V, typename I>
__device__ __forceinline__ void rotate_one(const V* __restrict__ x,
                                           V* __restrict__ out, I i, I p,
                                           I row, I stride, I off) {
  const I r = i / row;
  I src = r + off;
  if (src >= p) src -= p;
  out[i] = x[src * stride + (i - r * row)];
}

template <typename V, typename I>
__global__ void rotate_kernel(const V* __restrict__ x, V* __restrict__ out,
                              I p, I row, I stride, I off) {
  const I n = p * row;
  const I step = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step)
    rotate_one(x, out, i, p, row, stride, off);
}

inline long long mod(long long a, long long p) { return ((a % p) + p) % p; }

}  // namespace


