// Notified access on the stacked rank axis, for Hopper (sm_90a).
//
// Replaces the three kernels of repro/kernels/rmaq/kernel.py.  Every rank
// lives on this card as one row block of a stacked array:
//
//   notified_put_pallas       out[(r + s) % p] = x[r] and
//                             cnt_out[(r + s) % p] = cnt[r], in one launch
//   notify_accumulate_pallas  out[r] = local[r] + cnt[(r - s) % p]
//   queue_push_pallas         rank r's k messages into the ring of rank
//                             t = (r + s) % p: fetch t's (head, tail), admit
//                             accept = min(k, cap - (tail - head)), copy row
//                             j < accept to slot (tail + j) & (cap - 1),
//                             publish tail + accept
//
// The TPU kernels move the payload and the count word with remote DMAs and
// signal the target's semaphore (the doorbell); the receiver's wait is the
// notification.  Here a remote rank is another row of the same array and
// stream order on one card is the epoch: the count words travel in the
// payload's launch, so "payload and notification in one epoch" holds by
// construction, and nothing replays the DMA / semaphore choreography.
//
// notified_put — bound: bytes (the payload read once and written once, at
// the card's memory rate).  One grid-stride pass of 16-byte vectors over the
// flattened payload, the same per-element rotation as rma.cu's put_shift
// (rotate.cuh), with the p count words carried by the first p threads.
//
// notify_accumulate — bound: launch latency.  A doorbell is p words; one
// thread per rank does one add, and the launch costs far more than the
// bytes.
//
// queue_push — bound: launch latency at the queue's message sizes (k rows
// of a few words a rank).  Under a uniform shift every target has exactly
// one producer (r -> (r + s) mod p is a bijection; at s = 0 each rank pushes
// into its own ring), so one block per producer r owns its target t
// outright: it is the only block that reads or writes t's counters and
// ring.  Every counter fetch therefore precedes every tail publish without
// a grid-wide barrier, and the whole enqueue is one ordinary launch: thread
// 0 fetches (head, tail), the block copies the accepted rows, and after a
// block barrier thread 0 publishes the tail, n_sent[r] and n_notif[t].  The
// TPU kernel routes rejected rows to a trash row (its interpret mode needs
// a static DMA schedule); a GPU thread can simply skip them, so a rejected
// row is never written and no trash row exists.  The ring and counters are
// updated in place.  Counters are int32 words standing for uint32 values:
// all counter arithmetic is uint32 (signed overflow is undefined in C++),
// and slots are masked with & (cap - 1), which matches the reference
// oracle's uint32 view past tail = 2^31 (the Pallas kernel's signed rem
// does not).

#include "rotate.cuh"

namespace {

// payload as rma.cu's put_shift, plus the count words in the same launch
template <typename V, typename I>
__global__ void notified_put_kernel(const V* __restrict__ x, V* __restrict__ out,
                                    const uint32_t* __restrict__ cnt,
                                    uint32_t* __restrict__ cnt_out, I p, I row,
                                    I stride, I off) {
  const I n = p * row;
  const I step = (I)gridDim.x * blockDim.x;
  const I first = (I)blockIdx.x * blockDim.x + threadIdx.x;
  for (I i = first; i < n; i += step) rotate_one(x, out, i, p, row, stride, off);
  for (I i = first; i < p; i += step)
    rotate_one(cnt, cnt_out, i, p, (I)1, (I)1, off);
}

// out[r] = local[r] + cnt[(r + off) mod p], wrapping as int32 addition does
__global__ void notify_accumulate_kernel(const uint32_t* __restrict__ cnt,
                                         const uint32_t* __restrict__ local,
                                         uint32_t* __restrict__ out,
                                         long long p, long long off) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < p;
       r += step) {
    long long src = r + off;
    if (src >= p) src -= p;
    out[r] = local[r] + cnt[src];
  }
}

// one block per producer r (grid-stride over producers); ring [p, cap, w],
// ctr [p, 2] (head, tail), msgs [p, k, w], all contiguous 32-bit words
__global__ void queue_push_kernel(uint32_t* __restrict__ ring,
                                  uint32_t* __restrict__ ctr,
                                  const uint32_t* __restrict__ msgs,
                                  int32_t* __restrict__ n_sent,
                                  int32_t* __restrict__ n_notif, long long p,
                                  long long cap, long long k, long long w,
                                  long long off) {
  __shared__ uint32_t s_tail;
  __shared__ int32_t s_accept;
  const uint32_t mask = (uint32_t)cap - 1u;
  for (long long r = blockIdx.x; r < p; r += gridDim.x) {
    long long t = r + off;
    if (t >= p) t -= p;
    if (threadIdx.x == 0) {               // fetch the target's counters, admit
      const uint32_t head = ctr[2 * t], tail = ctr[2 * t + 1];
      const int32_t free_slots = (int32_t)((uint32_t)cap - (tail - head));
      s_accept = free_slots < (int32_t)k ? free_slots : (int32_t)k;
      s_tail = tail;
    }
    __syncthreads();
    const int32_t accept = s_accept;
    const uint32_t tail = s_tail;
    const long long words = (accept > 0 ? (long long)accept : 0LL) * w;
    uint32_t* dst = ring + t * cap * w;
    const uint32_t* src = msgs + r * k * w;
    for (long long i = threadIdx.x; i < words; i += blockDim.x) {
      const long long j = i / w;
      const uint32_t slot = (tail + (uint32_t)j) & mask;
      dst[(long long)slot * w + (i - j * w)] = src[i];
    }
    __syncthreads();                      // every row is in; s_* are free again
    if (threadIdx.x == 0) {               // publish the tail, notify
      ctr[2 * t + 1] = tail + (uint32_t)accept;
      n_sent[r] = accept;
      n_notif[t] = accept;
    }
  }
}

}  // namespace

// C entries: pointers and the stream as void*, sizes in 32-bit words as
// long long.  Each returns cudaGetLastError() after the launch (0 =
// launched).

// out[(r + shift) % p] = x[r] (row_words a rank, at rank stride
// stride_words), cnt_out[(r + shift) % p] = cnt[r]
extern "C" int rmaq_notified_put(const void* x, void* out, const void* cnt,
                                 void* cnt_out, long long p, long long row_words,
                                 long long stride_words, long long shift,
                                 void* stream) {
  if (p == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const long long off = mod(-shift, p);
  const bool vec = row_words % 4 == 0 && stride_words % 4 == 0 &&
                   aligned16(x) && aligned16(out);
  const long long w = vec ? 4 : 1;
  const long long n = p * row_words / w;
  const long long ex = extent(p, row_words, stride_words);
  dispatch(vec, ex > p ? ex : p, [&](auto v, auto i) {
    using V = decltype(v);
    using I = decltype(i);
    notified_put_kernel<V, I><<<blocks_for(n > p ? n : p), kThreads, 0, s>>>(
        static_cast<const V*>(x), static_cast<V*>(out),
        static_cast<const uint32_t*>(cnt), static_cast<uint32_t*>(cnt_out),
        (I)p, (I)(row_words / w), (I)(stride_words / w), (I)off);
  });
  return (int)cudaGetLastError();
}

// out[r] = local[r] + cnt[(r - shift) % p], int32 words
extern "C" int rmaq_notify_accumulate(const void* cnt, const void* local,
                                      void* out, long long p, long long shift,
                                      void* stream) {
  if (p == 0) return (int)cudaSuccess;
  notify_accumulate_kernel<<<blocks_for(p), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(cnt), static_cast<const uint32_t*>(local),
      static_cast<uint32_t*>(out), p, mod(-shift, p));
  return (int)cudaGetLastError();
}

// rank r's k messages into rank (r + shift) % p's ring, in place;
// n_sent [p] per producer, n_notif [p] per owner (int32)
extern "C" int rmaq_queue_push(void* ring, void* ctr, const void* msgs,
                               void* n_sent, void* n_notif, long long p,
                               long long cap, long long k, long long w,
                               long long shift, void* stream) {
  if (p == 0) return (int)cudaSuccess;
  long long threads = (k * w + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads > 256 ? 256 : threads;
  const long long blocks = p < kMaxBlocks ? p : kMaxBlocks;
  queue_push_kernel<<<(int)blocks, (int)threads, 0, (cudaStream_t)stream>>>(
      static_cast<uint32_t*>(ring), static_cast<uint32_t*>(ctr),
      static_cast<const uint32_t*>(msgs), static_cast<int32_t*>(n_sent),
      static_cast<int32_t*>(n_notif), p, cap, k, w, mod(shift, p));
  return (int)cudaGetLastError();
}
