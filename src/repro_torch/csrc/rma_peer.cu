// One-sided RMA between processes, for Hopper (sm_90a): the peer forms of
// kernel rows 4-7.
//
// Replaces the same four kernels of repro/kernels/rma/kernel.py as rma.cu,
// in the form the TPU runs them: every rank its own process, its window in
// its own device memory.  Each rank allocates one block of a symmetric
// segment (rma_peer_alloc: cudaMalloc and a CUDA IPC handle); every peer
// maps it (rma_peer_open: cudaIpcOpenMemHandle; a rank's own entry is its
// local pointer, since a process cannot open its own handle) and keeps a
// device array `table` of the p base pointers.  A kernel addresses rank r's
// block as table[r] + off, so it does the remote loads and stores itself:
// the counterpart of pltpu.make_async_remote_copy.
//
//   put_shift_pallas        rma_peer_put: this rank's x into rank
//                           (rank + shift) mod p's block at off
//   get_shift_pallas        rma_peer_get: rank (rank + shift) mod p's block
//                           at off into this rank's out
//   accumulate_shift_pallas rma_peer_put into the owner's slot, then the
//                           owner's add rma_peer_accumulate_f32:
//                           out = acc + this rank's slot (f32)
//   ring_all_gather_pallas  rma_peer_ring_hop, p - 1 times: hop h stores
//                           slot (rank - h) mod p of the gather buffer (x at
//                           hop 0) into the same slot of the right
//                           neighbour's; the slots are p blocks from off
//
// The TPU kernels run a neighbour barrier before the DMA and wait on send
// and receive semaphores after it.  Here the wrapper orders the epoch on
// the host: the stores of a round are launched, the stream is synchronised
// and the ranks meet at a barrier of the bootstrap (`ProcMesh.fence`).  So
// no kernel spins on a flag another process sets: processes that share one
// card are time-sliced, and a spinning kernel would hold its time slice.
// A kernel that ends has performed its stores into the peer's memory, on
// one card as across NVLink.
//
// Bound: bytes.  Each word is read once and written once (the add reads two
// and writes one), so the least time is bytes / the memory rate (or the
// link's, across cards).  Design as rma.cu: one thread per element, 32-bit
// indices when they fit, 16-byte accesses when the word count, the offsets
// and the local pointers allow it (the table's bases come from cudaMalloc,
// so they are 256-byte aligned).

#include "rotate.cuh"

#include <cstring>
#include <type_traits>

namespace {

template <typename V>
__device__ __forceinline__ V* at(const unsigned long long* table, long long rank,
                                 long long off) {
  return reinterpret_cast<V*>(table[rank]) + off;
}

// dst (rank `dst_rank`'s block at `off`) = src, n elements
template <typename V, typename I>
__global__ void put_kernel(const V* __restrict__ x,
                           const unsigned long long* __restrict__ table,
                           long long dst_rank, long long off, I n) {
  V* dst = at<V>(table, dst_rank, off);
  const I step = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) dst[i] = x[i];
}

// out = rank `src_rank`'s block at `off`, n elements
template <typename V, typename I>
__global__ void get_kernel(V* __restrict__ out,
                           const unsigned long long* __restrict__ table,
                           long long src_rank, long long off, I n) {
  const V* src = at<V>(table, src_rank, off);
  const I step = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) out[i] = src[i];
}

__device__ __forceinline__ float add4(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// the owner's add: out = acc + this rank's slot at `off`
template <typename V, typename I>
__global__ void slot_add_kernel(const V* __restrict__ acc,
                                const unsigned long long* __restrict__ table,
                                long long rank, long long off, V* __restrict__ out, I n) {
  const V* slot = at<V>(table, rank, off);
  const I step = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step)
    out[i] = add4(acc[i], slot[i]);
}

// one ring hop: slot b of this rank's gather buffer (x itself at hop 0)
// into slot b of rank `right`'s, n elements a slot
template <typename V, typename I>
__global__ void ring_hop_kernel(const V* __restrict__ x,
                                const unsigned long long* __restrict__ table,
                                long long rank, long long right, bool from_x,
                                long long slot_off, I n) {
  const V* src = from_x ? x : at<V>(table, rank, slot_off);
  V* dst = at<V>(table, right, slot_off);
  const I step = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) dst[i] = src[i];
}

bool vec_ok(long long words, long long off_bytes, const void* a, const void* b) {
  return words % 4 == 0 && off_bytes % 16 == 0 && aligned16(a) && (b == nullptr || aligned16(b));
}

}  // namespace

// C entries: pointers and the stream as void*, sizes and offsets as long
// long (words are 32 bits; offsets are bytes into a rank's block).  Each
// returns a cudaError_t (0 = done / launched).

// rank (rank + shift) mod p's block at off_bytes = x, `words` words
extern "C" int rma_peer_put(const void* x, const void* table, long long p, long long rank,
                            long long shift, long long off_bytes, long long words,
                            void* stream) {
  if (words == 0) return (int)cudaSuccess;
  const long long dst = mod(rank + shift, p);
  const bool vec = vec_ok(words, off_bytes, x, nullptr);
  const long long w = vec ? 4 : 1;
  dispatch(vec, words, [&](auto v, auto i) {
    using V = decltype(v);
    using I = decltype(i);
    put_kernel<V, I><<<blocks_for(words / w), kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const V*>(x), static_cast<const unsigned long long*>(table), dst,
        off_bytes / (long long)sizeof(V), (I)(words / w));
  });
  return (int)cudaGetLastError();
}

// out = rank (rank + shift) mod p's block at off_bytes, `words` words
extern "C" int rma_peer_get(void* out, const void* table, long long p, long long rank,
                            long long shift, long long off_bytes, long long words,
                            void* stream) {
  if (words == 0) return (int)cudaSuccess;
  const long long src = mod(rank + shift, p);
  const bool vec = vec_ok(words, off_bytes, out, nullptr);
  const long long w = vec ? 4 : 1;
  dispatch(vec, words, [&](auto v, auto i) {
    using V = decltype(v);
    using I = decltype(i);
    get_kernel<V, I><<<blocks_for(words / w), kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<V*>(out), static_cast<const unsigned long long*>(table), src,
        off_bytes / (long long)sizeof(V), (I)(words / w));
  });
  return (int)cudaGetLastError();
}

// out = acc + this rank's slot at off_bytes, float32
extern "C" int rma_peer_accumulate_f32(const void* acc, const void* table, void* out,
                                       long long rank, long long off_bytes, long long words,
                                       void* stream) {
  if (words == 0) return (int)cudaSuccess;
  const bool vec = vec_ok(words, off_bytes, acc, out);
  const long long w = vec ? 4 : 1;
  dispatch(vec, words, [&](auto v, auto i) {
    using V = typename std::conditional<sizeof(decltype(v)) == 16, float4, float>::type;
    using I = decltype(i);
    slot_add_kernel<V, I><<<blocks_for(words / w), kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const V*>(acc), static_cast<const unsigned long long*>(table), rank,
        off_bytes / (long long)sizeof(V), static_cast<V*>(out), (I)(words / w));
  });
  return (int)cudaGetLastError();
}

// hop `hop` of the ring all-gather: the gather buffer holds p slots of
// `words` words from off_bytes in every rank's block
extern "C" int rma_peer_ring_hop(const void* x, const void* table, long long p,
                                 long long rank, long long hop, long long off_bytes,
                                 long long words, void* stream) {
  if (words == 0) return (int)cudaSuccess;
  // the slot this rank forwards: its own block at hop 0, then the one its
  // left neighbour stored at the hop before
  const long long b = mod(rank - hop, p);
  const long long slot_bytes = off_bytes + b * words * 4;
  const bool vec = vec_ok(words, slot_bytes, x, nullptr);
  const long long w = vec ? 4 : 1;
  dispatch(vec, words, [&](auto v, auto i) {
    using V = decltype(v);
    using I = decltype(i);
    ring_hop_kernel<V, I><<<blocks_for(words / w), kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const V*>(x), static_cast<const unsigned long long*>(table), rank,
        mod(rank + 1, p), hop == 0, slot_bytes / (long long)sizeof(V), (I)(words / w));
  });
  return (int)cudaGetLastError();
}

// The symmetric segment's memory.  rma_peer_alloc: `bytes` of zeroed device
// memory; writes its pointer (8 bytes) and its IPC handle (64 bytes) to the
// host buffer `out`.  The zeroing is finished before it returns, so a peer
// that maps the block never sees it half cleared.
extern "C" int rma_peer_alloc(long long bytes, void* out, void* stream) {
  void* ptr = nullptr;
  cudaError_t rc = cudaMalloc(&ptr, bytes > 0 ? bytes : 1);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaMemsetAsync(ptr, 0, bytes > 0 ? bytes : 1, (cudaStream_t)stream);
  if (rc == cudaSuccess) rc = cudaStreamSynchronize((cudaStream_t)stream);
  cudaIpcMemHandle_t handle;
  if (rc == cudaSuccess) rc = cudaIpcGetMemHandle(&handle, ptr);
  if (rc != cudaSuccess) {
    cudaFree(ptr);
    return (int)rc;
  }
  unsigned char* o = static_cast<unsigned char*>(out);
  memcpy(o, &ptr, sizeof(ptr));
  memcpy(o + 8, &handle, sizeof(handle));
  return (int)cudaSuccess;
}

// Maps a peer's block from its 64-byte handle; writes the pointer to `out`.
extern "C" int rma_peer_open(const void* handle, void* out, void* stream) {
  (void)stream;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  void* ptr = nullptr;
  cudaError_t rc = cudaIpcOpenMemHandle(&ptr, h, cudaIpcMemLazyEnablePeerAccess);
  if (rc == cudaSuccess) memcpy(out, &ptr, sizeof(ptr));
  return (int)rc;
}

// Unmaps a peer's block (after every use of it has finished).
extern "C" int rma_peer_close(void* ptr, void* stream) {
  (void)stream;
  return (int)cudaIpcCloseMemHandle(ptr);
}

// Frees this rank's block (after every peer has closed its mapping).
extern "C" int rma_peer_free(void* ptr, void* stream) {
  (void)stream;
  return (int)cudaFree(ptr);
}
