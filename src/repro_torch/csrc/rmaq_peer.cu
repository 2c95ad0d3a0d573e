// Notified access between processes, for Hopper (sm_90a): the peer forms of
// kernel rows 8-10.
//
// Replaces the three kernels of repro/kernels/rmaq/kernel.py as rmaq.cu
// does, in the form the TPU runs them: every rank its own process, its
// window in its own device memory.  The contract is rma_peer.cu's: a
// symmetric segment's blocks are mapped by every peer (CUDA IPC), and a
// kernel addresses rank r's block as table[r] + off through the device
// array `table` of the p base pointers.
//
//   notified_put_pallas       rmaq_peer_notified_put: this rank's payload
//                             into rank t = (rank + shift) mod p's block at
//                             off, then its count word into t's counter
//                             slot at cnt_off
//   notify_accumulate_pallas  rmaq_peer_count_store: the count into the
//                             owner's slot; after the epoch the owner's add
//                             rmaq_peer_count_add: out = local + its slot
//                             (as uint32: int32 addition that wraps), as
//                             rma_peer_accumulate_f32 does for row 6
//   queue_push_pallas         rmaq_peer_queue_push: read t's (head, tail)
//                             through the peer pointer, admit accept =
//                             min(k, cap - (tail - head)), store row j <
//                             accept into t's ring slot (tail + j) &
//                             (cap - 1) and accept into t's count slot;
//                             after the epoch the owner publishes
//                             rmaq_peer_queue_publish: tail += its slot
//
// Visibility is the epoch's, ordered on the host by the wrapper: the stores
// are launched, the stream drained and the ranks meet at a barrier of the
// bootstrap (`ProcMesh.fence`).  No kernel spins on a flag that another
// process sets: processes sharing one card are time-sliced, and a spinning
// kernel would hold its slice.  So "payload, then count visible" holds
// because no rank reads either before the epoch closes, by which time the
// kernel that stored both has ended; and the tail a queue_push read is
// current because the fence that opens its epoch follows every earlier
// publish.
//
// Precondition: a uniform shift, under which every target has exactly one
// producer (r -> (r + shift) mod p is a bijection; at shift 0 mod p a rank
// pushes into its own ring).  So no two processes store into one counter
// slot or ring slot in an epoch, and no cross-process atomic is needed.
// The shift is taken mod p (the reference's kernels hang at a shift past
// p), and the ring's counter arithmetic is uint32 (the reference's signed
// slot index writes out of bounds once a tail passes 2^31).
//
// A rejected message is never written: where the TPU kernel sends it to a
// trash row of a cap + 1 row ring (its interpret mode needs a static DMA
// schedule), here the admitted rows are the only stores, as in rmaq.cu.
//
// Bound: bytes for the payload of row 8 (read once, written once); the
// counts and rows of 9 and 10 are a few words, so those launches are bound
// by their latency.  Design: one thread an element in grid-stride loops
// (rotate.cuh's geometry), 16-byte vectors for row 8's payload where the
// word count, the offset and x allow; the count words by thread 0 of block 0.

#include "rotate.cuh"

#include <type_traits>

namespace {

template <typename T>
__device__ __forceinline__ T* at(const unsigned long long* table, long long rank,
                                 long long off_bytes) {
  return reinterpret_cast<T*>(reinterpret_cast<char*>(table[rank]) + off_bytes);
}

// row 8: n payload units into rank dst's block at off, then the count words
template <typename V, typename I>
__global__ void notified_put_kernel(const V* __restrict__ x, const int32_t* __restrict__ cnt,
                                    const unsigned long long* __restrict__ table,
                                    long long dst, long long off_bytes, long long cnt_off,
                                    long long n_cnt, I n) {
  V* d = at<V>(table, dst, off_bytes);
  const I step = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) d[i] = x[i];
  if (blockIdx.x == 0)
    for (long long j = threadIdx.x; j < n_cnt; j += blockDim.x)
      at<int32_t>(table, dst, cnt_off)[j] = cnt[j];
}

// row 9, the store: n count words into rank dst's slot at off
__global__ void count_store_kernel(const int32_t* __restrict__ cnt,
                                   const unsigned long long* __restrict__ table,
                                   long long dst, long long off_bytes, long long n) {
  int32_t* d = at<int32_t>(table, dst, off_bytes);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    d[i] = cnt[i];
}

// row 9, the owner's add: out = local + this rank's slot, as uint32
__global__ void count_add_kernel(const int32_t* __restrict__ local,
                                 const unsigned long long* __restrict__ table, long long rank,
                                 long long off_bytes, int32_t* __restrict__ out, long long n) {
  const uint32_t* slot = at<uint32_t>(table, rank, off_bytes);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = (int32_t)((uint32_t)local[i] + slot[i]);
}

// row 10, the producer: every block's thread 0 reads the target's (head,
// tail) and admits; the block's threads copy their share of the accepted
// rows' words; block 0 stores the accept count at the target and here
__global__ void queue_push_kernel(const uint32_t* __restrict__ msgs,
                                  const unsigned long long* __restrict__ buf_table,
                                  long long buf_off,
                                  const unsigned long long* __restrict__ ctr_table,
                                  long long ctr_off,
                                  const unsigned long long* __restrict__ cnt_table,
                                  long long cnt_off, int32_t* __restrict__ n_sent,
                                  long long dst, uint32_t cap, long long k, long long w) {
  __shared__ int32_t s_accept;
  __shared__ uint32_t s_tail;
  if (threadIdx.x == 0) {
    const uint32_t* c = at<uint32_t>(ctr_table, dst, ctr_off);
    const uint32_t head = c[0], tail = c[1];
    const int32_t free = (int32_t)(cap - (tail - head));     // as the reference's int32
    s_accept = free < (int32_t)k ? free : (int32_t)k;
    s_tail = tail;
  }
  __syncthreads();
  const long long accept = s_accept;
  const uint32_t tail = s_tail, mask = cap - 1u;
  uint32_t* ring = at<uint32_t>(buf_table, dst, buf_off);
  const long long n = accept > 0 ? accept * w : 0;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long j = e / w;
    const uint32_t slot = (tail + (uint32_t)j) & mask;
    ring[(long long)slot * w + (e - j * w)] = msgs[e];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *at<int32_t>(cnt_table, dst, cnt_off) = (int32_t)accept;
    *n_sent = (int32_t)accept;
  }
}

// row 10, the owner's publish after the epoch: tail += its slot (uint32)
__global__ void queue_publish_kernel(int32_t* __restrict__ ctr,
                                     const unsigned long long* __restrict__ cnt_table,
                                     long long rank, long long cnt_off,
                                     int32_t* __restrict__ n_notif) {
  const int32_t in = *at<int32_t>(cnt_table, rank, cnt_off);
  ctr[1] = (int32_t)((uint32_t)ctr[1] + (uint32_t)in);
  *n_notif = in;
}

inline int blocks_at_least_one(long long n) { return n > 0 ? blocks_for(n) : 1; }

}  // namespace

// C entries: pointers and the stream as void*, sizes and offsets as long
// long (words are 32 bits; offsets are bytes into a rank's block).  Each
// returns a cudaError_t (0 = launched).

// rank (rank + shift) mod p's block: `words` payload words at off_bytes,
// then `n_cnt` count words at cnt_off_bytes
extern "C" int rmaq_peer_notified_put(const void* x, const void* cnt, const void* table,
                                      long long p, long long rank, long long shift,
                                      long long off_bytes, long long cnt_off_bytes,
                                      long long words, long long n_cnt, void* stream) {
  if (p < 1 || words < 0 || n_cnt < 0) return (int)cudaErrorInvalidValue;
  const long long dst = mod(rank + shift, p);
  const bool vec = words % 4 == 0 && off_bytes % 16 == 0 && aligned16(x);
  const long long w = vec ? 4 : 1;
  dispatch(vec, words, [&](auto v, auto i) {
    using V = decltype(v);
    using I = decltype(i);
    notified_put_kernel<V, I><<<blocks_at_least_one(words / w), kThreads, 0,
                                (cudaStream_t)stream>>>(
        static_cast<const V*>(x), static_cast<const int32_t*>(cnt),
        static_cast<const unsigned long long*>(table), dst, off_bytes, cnt_off_bytes, n_cnt,
        (I)(words / w));
  });
  return (int)cudaGetLastError();
}

// `n` count words into rank (rank + shift) mod p's block at off_bytes
extern "C" int rmaq_peer_count_store(const void* cnt, const void* table, long long p,
                                     long long rank, long long shift, long long off_bytes,
                                     long long n, void* stream) {
  if (p < 1 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  count_store_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(cnt), static_cast<const unsigned long long*>(table),
      mod(rank + shift, p), off_bytes, n);
  return (int)cudaGetLastError();
}

// out = local + this rank's slot at off_bytes, `n` int32 words
extern "C" int rmaq_peer_count_add(const void* local, const void* table, void* out,
                                   long long rank, long long off_bytes, long long n,
                                   void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  count_add_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(local), static_cast<const unsigned long long*>(table), rank,
      off_bytes, static_cast<int32_t*>(out), n);
  return (int)cudaGetLastError();
}

// k messages of w words into the ring of t = (rank + shift) mod p: the ring
// [cap, w] at buf_off of buf_table's blocks, its (head, tail) at ctr_off of
// ctr_table's, the accept count to t's slot at cnt_off of cnt_table's and
// to n_sent here
extern "C" int rmaq_peer_queue_push(const void* msgs, const void* buf_table, long long buf_off,
                                    const void* ctr_table, long long ctr_off,
                                    const void* cnt_table, long long cnt_off, void* n_sent,
                                    long long p, long long rank, long long shift,
                                    long long cap, long long k, long long w, void* stream) {
  if (p < 1 || k < 0 || w < 1 || cap < 2 || (cap & (cap - 1)) || cap > (1LL << 31))
    return (int)cudaErrorInvalidValue;
  queue_push_kernel<<<blocks_at_least_one(k * w), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(msgs), static_cast<const unsigned long long*>(buf_table),
      buf_off, static_cast<const unsigned long long*>(ctr_table), ctr_off,
      static_cast<const unsigned long long*>(cnt_table), cnt_off,
      static_cast<int32_t*>(n_sent), mod(rank + shift, p), (uint32_t)cap, k, w);
  return (int)cudaGetLastError();
}

// the owner's publish: ctr [2] (head, tail) += its slot at cnt_off, which
// also goes to n_notif
extern "C" int rmaq_peer_queue_publish(void* ctr, const void* cnt_table, long long rank,
                                       long long cnt_off, void* n_notif, void* stream) {
  queue_publish_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      static_cast<int32_t*>(ctr), static_cast<const unsigned long long*>(cnt_table), rank,
      cnt_off, static_cast<int32_t*>(n_notif));
  return (int)cudaGetLastError();
}
