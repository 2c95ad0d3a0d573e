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
// notify_accumulate — bound: launch latency.  A doorbell is p words: the
// call reads 8p bytes and writes 4p (48 KiB at p = 4096), which the card
// moves in well under a microsecond, so the launch is what costs, and the
// device side is sized to the work: at most one wave of blocks (one block
// an SM at most, 256 threads each taking a 16-byte vector of `local` and
// `out` where the pointers allow, and of `cnt` too where the rotation keeps
// its vectors whole: off and p multiples of 4), and the rotation done as two
// contiguous runs, out[0, p - off) from cnt[off, p) and out[p - off, p) from
// cnt[0, off), each a loop of its own, so no element asks which run it is
// in.  Words are added as uint32 (int32 addition that wraps).
//
// queue_push — bound: launch latency at the queue's message sizes (k rows
// of a few words a rank: at the DSDE queue's p = 4096, k = 6, w = 2 the call
// moves ~475 KB, 0.14 us at the memory rate).  Under a uniform shift every
// target has exactly one producer (r -> (r + s) mod p is a bijection; at
// s = 0 each rank pushes into its own ring), so one group of lanes per
// producer r owns its target t outright: it is the only group that reads or
// writes t's counters and ring.  Every counter fetch therefore precedes
// every tail publish without a grid-wide barrier, and the whole enqueue is
// one ordinary launch with no shared memory and no block barrier.  A group
// is the power of two of lanes that holds the k rows' vectors, at most a
// warp (8 lanes at the DSDE shape): what is left of the launch, past its
// floor, grows with the warps an SM starts (at p = 4096 on an H100, a warp
// a producer took 3.1 us queued, 8 lanes 2.8, against a 2.3 us floor).
// The group's lane 0 fetches t's (head, tail) in one 8-byte load where ctr
// is 8-byte aligned, admits accept = min(k, cap - (tail - head)) and
// broadcasts accept and tail by shuffle, while every lane reads its first
// vector ahead; the lanes copy the accepted rows, row j to slot
// (tail + j) & (cap - 1), each lane a fixed (row in a pass, vector in a
// row) pair worked out once, so no index is divided per word; vectors are
// the widest that w and both bases allow (16 bytes where w % 4 == 0 and
// ring and msgs are 16-byte aligned, 8 where w % 2 == 0 and 8-byte
// aligned, else words); after __syncwarp the group's lane 0 publishes the
// tail, n_sent[r] and n_notif[t].  Blocks of 8 warps, at most one wave of
// resident blocks, producers past the grid's groups taken by a grid-stride
// loop.  The TPU kernel routes rejected rows to a trash row (its interpret
// mode needs a static DMA schedule); a lane simply skips them, so a
// rejected row is never written and no trash row exists.  The ring and
// counters are updated in place.  Counters are int32 words standing for
// uint32 values: all counter arithmetic is uint32 (signed overflow is
// undefined in C++), and slots are masked with & (cap - 1), which matches
// the reference oracle's uint32 view past tail = 2^31 (the Pallas kernel's
// signed rem does not) and wraps with the tail past 2^32.  An over-full
// ring (tail - head > cap) admits accept <= 0 as the oracle does: nothing
// is copied and tail + accept is published.

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

// out[r] = local[r] + cnt[r + delta] for lo <= r < hi: 16-byte vectors of
// local and out over the run's whole vectors when VEC (cnt's too when CVEC:
// delta a multiple of 4), single words at the run's ragged ends (the whole
// run without VEC)
template <bool VEC, bool CVEC>
__device__ __forceinline__ void add_run(const uint32_t* __restrict__ cnt,
                                        const uint32_t* __restrict__ local,
                                        uint32_t* __restrict__ out, long long lo,
                                        long long hi, long long delta,
                                        long long tid, long long nt) {
  long long a = lo, b = lo;
  if (VEC) {
    a = (lo + 3) & ~3LL;
    if (a > hi) a = hi;
    b = hi & ~3LL;
    if (b < a) b = a;
    const uint4* l4 = reinterpret_cast<const uint4*>(local);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (long long v = a / 4 + tid; v < b / 4; v += nt) {
      const uint4 l = l4[v];
      const long long c0 = 4 * v + delta;
      uint4 c;
      if (CVEC) {
        c = reinterpret_cast<const uint4*>(cnt)[c0 / 4];
      } else {
        c = make_uint4(cnt[c0], cnt[c0 + 1], cnt[c0 + 2], cnt[c0 + 3]);
      }
      o4[v] = make_uint4(l.x + c.x, l.y + c.y, l.z + c.z, l.w + c.w);
    }
  }
  for (long long r = lo + tid; r < a; r += nt) out[r] = local[r] + cnt[r + delta];
  for (long long r = b + tid; r < hi; r += nt) out[r] = local[r] + cnt[r + delta];
}

// out[r] = local[r] + cnt[(r + off) mod p], 0 <= off < p: the two runs
template <bool VEC, bool CVEC>
__global__ void notify_accumulate_kernel(const uint32_t* __restrict__ cnt,
                                         const uint32_t* __restrict__ local,
                                         uint32_t* __restrict__ out,
                                         long long p, long long off) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nt = (long long)gridDim.x * blockDim.x;
  add_run<VEC, CVEC>(cnt, local, out, 0, p - off, off, tid, nt);
  add_run<VEC, CVEC>(cnt, local, out, p - off, p, off - p, tid, nt);
}

// a group of `group` lanes per producer r (a power of two <= 32; groups
// grid-stride over producers); ring [p, cap, w], ctr [p, 2] (head, tail),
// msgs [p, k, w], all contiguous 32-bit words; V the copy's vector (wv of
// them a row)
constexpr int kPushWarps = 8;             // warps a block

template <typename V>
__global__ void __launch_bounds__(kPushWarps * 32)
queue_push_kernel(uint32_t* __restrict__ ring, uint32_t* __restrict__ ctr,
                  const uint32_t* __restrict__ msgs, int32_t* __restrict__ n_sent,
                  int32_t* __restrict__ n_notif, long long p, long long cap,
                  long long k, int wv, int group, long long off, bool ctr8) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int g = lane & (group - 1);       // this lane's place in its group
  const int groups_a_warp = 32 / group;
  // a pass copies `per` rows of `span` lanes each (a row of >= `group`
  // vectors takes the whole group, vector by vector)
  const int span = wv < 1 ? 1 : wv < group ? wv : group;
  const int per = group / span;
  const int sub = g / span, col = g - sub * span;
  const bool mine = sub < per && sub < k && col < wv;   // a vector in the first pass
  const uint32_t mask = (uint32_t)cap - 1u;
  const long long row_words = (long long)wv * (long long)(sizeof(V) / 4);
  const long long step = (long long)gridDim.x * kPushWarps * groups_a_warp;
  // the loop runs alike in every lane of a warp (shuffles take all 32)
  for (long long base = ((long long)blockIdx.x * kPushWarps + (threadIdx.x >> 5)) *
                        groups_a_warp;
       base < p; base += step) {
    const long long r = base + lane / group;
    const bool live = r < p;
    long long t = r + off;
    if (t >= p) t -= p;
    const V* src = reinterpret_cast<const V*>(msgs + r * k * row_words);
    // the first pass's vector is read while the group's lane 0 fetches the
    // counters (a rejected row is read, never written)
    V first = V();
    if (live && mine) first = src[sub * wv + col];
    uint32_t tail = 0;
    int32_t accept = 0;
    if (live && g == 0) {                 // fetch the target's counters, admit
      uint32_t head;
      if (ctr8) {
        const uint2 ht = reinterpret_cast<const uint2*>(ctr)[t];
        head = ht.x;
        tail = ht.y;
      } else {
        head = ctr[2 * t];
        tail = ctr[2 * t + 1];
      }
      const int32_t free_slots = (int32_t)((uint32_t)cap - (tail - head));
      accept = free_slots < (int32_t)k ? free_slots : (int32_t)k;
    }
    accept = __shfl_sync(full, accept, 0, group);
    tail = __shfl_sync(full, tail, 0, group);
    if (live && sub < per) {
      V* dst = reinterpret_cast<V*>(ring + t * cap * row_words);
      for (int j = sub; j < accept; j += per) {
        V* d = dst + (long long)((tail + (uint32_t)j) & mask) * wv;
        const V* s = src + (long long)j * wv;
        int c = col;
        if (j == sub) {                   // the vector read ahead
          if (c < wv) d[c] = first;
          c += span;
        }
        for (; c < wv; c += span) d[c] = s[c];
      }
    }
    __syncwarp();                         // every row is in
    if (live && g == 0) {                 // publish the tail, notify
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
  const long long off = mod(-shift, p);
  const bool vec = aligned16(local) && aligned16(out);
  const bool cvec = vec && aligned16(cnt) && off % 4 == 0 && p % 4 == 0;
  const long long waves = sm_count();
  const long long want = blocks_for(vec ? (p + 3) / 4 : p);
  const int blocks = (int)(want < waves ? want : waves);
  const uint32_t* c = static_cast<const uint32_t*>(cnt);
  const uint32_t* l = static_cast<const uint32_t*>(local);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (cvec)
    notify_accumulate_kernel<true, true><<<blocks, kThreads, 0, s>>>(c, l, o, p, off);
  else if (vec)
    notify_accumulate_kernel<true, false><<<blocks, kThreads, 0, s>>>(c, l, o, p, off);
  else
    notify_accumulate_kernel<false, false><<<blocks, kThreads, 0, s>>>(c, l, o, p, off);
  return (int)cudaGetLastError();
}

// rank r's k messages into rank (r + shift) % p's ring, in place;
// n_sent [p] per producer, n_notif [p] per owner (int32)
extern "C" int rmaq_queue_push(void* ring, void* ctr, const void* msgs,
                               void* n_sent, void* n_notif, long long p,
                               long long cap, long long k, long long w,
                               long long shift, void* stream) {
  if (p == 0) return (int)cudaSuccess;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(ring) |
                          reinterpret_cast<uintptr_t>(msgs);
  const int vw = w % 4 == 0 && (bases & 15u) == 0 ? 4
                 : w % 2 == 0 && (bases & 7u) == 0 ? 2 : 1;
  const bool ctr8 = (reinterpret_cast<uintptr_t>(ctr) & 7u) == 0;
  const int wv = (int)(w / vw);
  // lanes a producer: the power of two that holds the first pass's vectors
  // (k rows of wv), at most a warp
  const long long vecs = k * wv;
  int group = 1;
  while (group < 32 && group < vecs) group *= 2;
  // one wave at most: 2048 threads an SM = 8 blocks of 8 warps
  const long long wave = (long long)sm_count() * (2048 / (kPushWarps * 32));
  const long long per_block = (long long)kPushWarps * (32 / group);
  const long long want = (p + per_block - 1) / per_block;
  const int blocks = (int)(want < wave ? want : wave);
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* rg = static_cast<uint32_t*>(ring);
  uint32_t* c = static_cast<uint32_t*>(ctr);
  const uint32_t* m = static_cast<const uint32_t*>(msgs);
  int32_t* ns = static_cast<int32_t*>(n_sent);
  int32_t* nn = static_cast<int32_t*>(n_notif);
  const long long off = mod(shift, p);
  if (vw == 4)
    queue_push_kernel<uint4><<<blocks, kPushWarps * 32, 0, s>>>(rg, c, m, ns, nn, p, cap,
                                                               k, wv, group, off, ctr8);
  else if (vw == 2)
    queue_push_kernel<uint2><<<blocks, kPushWarps * 32, 0, s>>>(rg, c, m, ns, nn, p, cap,
                                                               k, wv, group, off, ctr8);
  else
    queue_push_kernel<uint32_t><<<blocks, kPushWarps * 32, 0, s>>>(rg, c, m, ns, nn, p,
                                                                  cap, k, wv, group, off, ctr8);
  return (int)cudaGetLastError();
}
