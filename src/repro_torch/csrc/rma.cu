// One-sided RMA on the stacked rank axis, for Hopper (sm_90a).
//
// Replaces the four kernels of repro/kernels/rma/kernel.py.  Rank r's block
// is `row` contiguous 32-bit words starting at word r * stride of the input
// (stride == row for a contiguous [p, W] array; larger for a halo slice of a
// bigger array, which is read in place), and every rank lives on this card.
// Outputs are contiguous [p, row]:
//
//   put_shift_pallas        out[(r + s) % p] = x[r]
//   get_shift_pallas        out[r] = x[(r + s) % p]
//   accumulate_shift_pallas out[r] = acc[r] + x[(r - s) % p]      (f32 only)
//   ring_all_gather_pallas  out[a, b] = x[b] for every receiver a, i.e.
//                           [p(receiver), p(source), W]: each receiver's copy
//
// The TPU kernels move a rank's block to its neighbour chip with a remote
// DMA between semaphore barriers.  Here a "remote" block is another row of
// the same array, so each kernel is one pass over the words: put and get
// rotate the row index by the shift, accumulate adds the owner's row in the
// same pass (the slot of the TPU kernel is never materialised), and the
// ring's p - 1 hops collapse into one broadcast copy.  Stream order on one
// card is the barrier: nothing replays the DMA / semaphore choreography.
// The output is always a fresh buffer: rotating in place would race.
//
// Bound: bytes.  Each word is read once and written once (accumulate reads
// two; the gather reads one and writes p), so the least time is bytes / the
// card's memory rate.  Design: one thread per output element (p can be 10^5
// ranks: the grid covers the tensor, not one block per rank), whose row is
// one integer division; 32-bit indices when every index fits, 64-bit
// otherwise; 16-byte vector accesses when rows and strides are whole 16-byte
// vectors and the pointers are 16-byte aligned, 4-byte words otherwise.

#include "rotate.cuh"

#include <type_traits>

namespace {

__device__ __forceinline__ float add4(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// out row r = acc row r + x row (r + off) mod p; V is float or float4
template <typename V, typename I>
__global__ void accumulate_kernel(const V* __restrict__ x,
                                  const V* __restrict__ acc,
                                  V* __restrict__ out, I p, I row,
                                  I x_stride, I acc_stride, I off) {
  const I n = p * row;
  const I step = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    const I r = i / row;
    const I j = i - r * row;
    I src = r + off;
    if (src >= p) src -= p;
    out[i] = add4(acc[r * acc_stride + j], x[src * x_stride + j]);
  }
}

// out[a, b] = x row b for every receiver a < p: each source element is read
// once and written p times
template <typename V, typename I>
__global__ void broadcast_kernel(const V* __restrict__ x, V* __restrict__ out,
                                 I p, I row, I stride) {
  const I n = p * row;
  const I step = (I)gridDim.x * blockDim.x;
  for (I j = (I)blockIdx.x * blockDim.x + threadIdx.x; j < n; j += step) {
    const I b = j / row;
    const V v = x[b * stride + (j - b * row)];
    for (I a = 0; a < p; ++a) out[a * n + j] = v;
  }
}

// out row r = x row (r + off) mod p, 0 <= off < p
int rotate(const void* x, void* out, long long p, long long row,
           long long stride, long long off, cudaStream_t s) {
  if (p * row == 0) return (int)cudaSuccess;
  const bool vec = row % 4 == 0 && stride % 4 == 0 && aligned16(x) && aligned16(out);
  const long long w = vec ? 4 : 1;
  dispatch(vec, extent(p, row, stride), [&](auto v, auto i) {
    using V = decltype(v);
    using I = decltype(i);
    rotate_kernel<V, I><<<blocks_for(p * row / w), kThreads, 0, s>>>(
        static_cast<const V*>(x), static_cast<V*>(out), (I)p, (I)(row / w),
        (I)(stride / w), (I)off);
  });
  return (int)cudaGetLastError();
}

}  // namespace

// C entries: pointers and the stream as void*, sizes and strides in 32-bit
// words as long long.  Each returns cudaGetLastError() after the launch
// (0 = launched).

// out[(r + shift) % p] = x[r]: the source of row r is (r - shift) mod p.
extern "C" int rma_put_shift(const void* x, void* out, long long p,
                             long long row_words, long long stride_words,
                             long long shift, void* stream) {
  return rotate(x, out, p, row_words, stride_words, mod(-shift, p),
                (cudaStream_t)stream);
}

// out[r] = x[(r + shift) % p]
extern "C" int rma_get_shift(const void* x, void* out, long long p,
                             long long row_words, long long stride_words,
                             long long shift, void* stream) {
  return rotate(x, out, p, row_words, stride_words, mod(shift, p),
                (cudaStream_t)stream);
}

// out[r] = acc[r] + x[(r - shift) % p], float32
extern "C" int rma_accumulate_shift_f32(const void* x, const void* acc,
                                        void* out, long long p,
                                        long long row_words,
                                        long long x_stride_words,
                                        long long acc_stride_words,
                                        long long shift, void* stream) {
  if (p * row_words == 0) return (int)cudaSuccess;
  const long long off = mod(-shift, p);
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = row_words % 4 == 0 && x_stride_words % 4 == 0 &&
                   acc_stride_words % 4 == 0 && aligned16(x) &&
                   aligned16(acc) && aligned16(out);
  const long long w = vec ? 4 : 1;
  const long long ex = extent(p, row_words, x_stride_words);
  const long long ea = extent(p, row_words, acc_stride_words);
  dispatch(vec, ex > ea ? ex : ea, [&](auto v, auto i) {
    using V = typename std::conditional<sizeof(decltype(v)) == 16, float4, float>::type;
    using I = decltype(i);
    accumulate_kernel<V, I><<<blocks_for(p * row_words / w), kThreads, 0, s>>>(
        static_cast<const V*>(x), static_cast<const V*>(acc),
        static_cast<V*>(out), (I)p, (I)(row_words / w),
        (I)(x_stride_words / w), (I)(acc_stride_words / w), (I)off);
  });
  return (int)cudaGetLastError();
}

// out [p, p, row] with out[a, b] = x[b]
extern "C" int rma_ring_all_gather(const void* x, void* out, long long p,
                                   long long row_words, long long stride_words,
                                   void* stream) {
  if (p * row_words == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = row_words % 4 == 0 && stride_words % 4 == 0 &&
                   aligned16(x) && aligned16(out);
  const long long w = vec ? 4 : 1;
  // the output's p * p * row words bound the index type too
  const long long ex = extent(p, row_words, stride_words);
  const long long eo = p * p * row_words;
  dispatch(vec, ex > eo ? ex : eo, [&](auto v, auto i) {
    using V = decltype(v);
    using I = decltype(i);
    broadcast_kernel<V, I><<<blocks_for(p * row_words / w), kThreads, 0, s>>>(
        static_cast<const V*>(x), static_cast<V*>(out), (I)p,
        (I)(row_words / w), (I)(stride_words / w));
  });
  return (int)cudaGetLastError();
}
