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
// In both, id < 0 masks the page (the requester's id decides), an id at or
// past n_pages reads the last page; a fully masked row gives 0
// (acc / max(l, 1e-30)), never NaN; causal keeps key u iff
// u <= s + (Sk - Sq) with Sk = k*pt, masked pages counted.  The caller
// applies the softmax scale to q before the launch.
//
// What bounds it: the bytes of the visible pages, read once (~4 flops a
// byte, f32: far below the card's balance).  At the decode path's shapes
// that is a few MB, about a microsecond at 3.35 TB/s, so the kernel is
// bound by latency: how many pages are in flight at once, on how many SMs.
// The TPU kernels walk a row's pages in order, one grid step a page with a
// two-page DMA window; one block walking a row so would keep 2 of 132 SMs
// busy at the serving path's busiest step (2 valid rows of 64).
//
// Design: split the page walk, merge in the same launch.
//   * ops.plan (Python, from shapes alone) cuts each row's k entries into S
//     splits of P <= 32 consecutive entries (~64 KiB of pages each) and
//     deals the query rows (rows = m * Sq) to `groups` block groups: group
//     g serves rows g, g + groups, g + 2 * groups, ..., G = ceil(rows /
//     groups) of them, one after another, and the grid is groups x S
//     blocks.  One valid row of k = 128 pages spreads over 32 blocks, and
//     the fully masked rows of a decode step cost a block a handful of id
//     reads.  `groups` is odd where G > 1, so rows a power of two apart
//     (the same slot of two ranks, neighbouring rows, a row's Sq
//     positions) run on different blocks.
//   * A block reads its own ids: one warp ballot a row lists the visible
//     pages of its split (masked pages and pages past the causal horizon
//     are skipped, their ids and K/V never read).  A split with nothing
//     visible records l = 0 and reads no K or V.
//   * Each warp (8 a block) takes U tokens at a time of the row's listed
//     pages and loads their K and V rows at once (2U independent loads a
//     lane in flight; 16-byte vectors, neighbouring lanes on neighbouring
//     addresses, where hd % 128 == 0 and the pointers are 16-byte
//     aligned), reduces q.k with shuffles and folds the U scores into the
//     warp's online softmax (m, l, acc) in registers.  The block combines
//     its warps in order and writes the split's partial (m, l, acc[hd]) to
//     a workspace.
//   * Merge: every block bumps its group's ticket after a barrier and one
//     __threadfence(); the block that draws the last ticket merges each
//     row of the group,
//     out = sum_j e^(m_j - M) acc_j / max(sum_j e^(m_j - M) l_j, 1e-30), in
//     split order (warp w takes a fixed run of splits, the runs are summed
//     in warp order), so repeated calls are bit-equal.  That block then
//     resets the ticket to 0.  The wrapper keeps one zeroed ticket buffer
//     per (device, stream): calls on one stream run in order and each finds
//     every ticket at 0; calls on two streams never share a ticket.
//
// Both entries are one launch of the same kernel: the local form is the
// shift form with p = 1.
//
// The peer form of paged_attention_shift_pallas (paged_attention_peer_f32),
// for ranks that are processes of their own: the owner's pool lies in a
// symmetric segment that every peer maps (rma_peer.cu's contract), and the
// same split walk takes the owner's base from the segment's device table,
// table[(rank + shift) mod p] + off, instead of kv + owner * pool_stride;
// this rank's q rows are the launch's rows.  It computes what the TPU
// kernel computes (this rank attends over the owner's pages), but the
// reference's page requests and replies become one one-sided read: the
// K and V rows are loaded through the peer mapping, and the owner runs
// nothing.  The wrapper brackets the launch with the epoch's fences (the
// owner's writes visible before, every read done after).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;                     // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPages = 32;                 // entries a split: one ballot
constexpr int kMaxGroup = 32;                 // query rows a block
constexpr int kRowsPerWarp = kMaxGroup / kWarps;

struct Args {
  const float* q;          // [rows, hd], pre-scaled
  const float* kv;         // [p, n_pages, pt, 2, hd]
  const int32_t* ids;      // [m, k]
  float* out;              // [rows, hd]
  float* ws;               // (m, l) [rows * S][2], padded to 4 floats, then
                           // acc [rows * S][hd]
  int* tickets;            // [groups], 0 on entry, 0 on exit
  const unsigned long long* table;   // peer form: the segment's base pointers
  long long table_off;     // peer form: the pool's byte offset in a block
  int owner;               // peer form: the rank whose pool is read
  size_t pool_stride;      // floats between two ranks' pools
  int p, off;              // row i reads the pool of rank (i + off) % p
  int Sq, hd, n_pages, pt, k, causal;
  int P, S, groups, rows;  // entries a split, splits, block groups, m * Sq
  int G;                   // rows a block: ceil(rows / groups), set by run()
};

template <int VEC> struct VecOf;
template <> struct VecOf<4> { using T = float4; };
template <> struct VecOf<1> { using T = float; };

__device__ __forceinline__ void zero(float& a) { a = 0.0f; }
__device__ __forceinline__ void zero(float4& a) { a = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ float dot(float a, float b) { return a * b; }
__device__ __forceinline__ float dot(const float4& a, const float4& b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}
__device__ __forceinline__ void scale(float& a, float c) { a *= c; }
__device__ __forceinline__ void scale(float4& a, float c) {
  a.x *= c; a.y *= c; a.z *= c; a.w *= c;
}
__device__ __forceinline__ void axpy(float& a, float w, float v) { a = fmaf(w, v, a); }
__device__ __forceinline__ void axpy(float4& a, float w, const float4& v) {
  a.x = fmaf(w, v.x, a.x); a.y = fmaf(w, v.y, a.y);
  a.z = fmaf(w, v.z, a.z); a.w = fmaf(w, v.w, a.w);
}

// One block: split `split` of query rows group + g * groups, g < G.  A lane
// holds chunks c < ch of a row, VEC floats each, at (c * 32 + lane) * VEC.
template <int VEC, int NC>
__global__ void __launch_bounds__(kThreads) paged_attention_split(const Args a) {
  using V = typename VecOf<VEC>::T;
  constexpr int F = VEC * NC;                        // floats a lane holds
  constexpr int U = F >= 32 ? 1 : (32 / F > 8 ? 8 : 32 / F);   // tokens a warp loads at once
  extern __shared__ __align__(16) float s_acc[];     // [kWarps][hd]
  __shared__ int s_pid[kMaxGroup][kMaxPages];        // visible pages of each row
  __shared__ int s_nvis[kMaxGroup][kMaxPages];       // their visible tokens
  __shared__ int s_n[kMaxGroup];
  __shared__ float s_m[kWarps], s_l[kWarps];
  __shared__ float s_M[kMaxGroup];
  __shared__ int s_any[kMaxGroup];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = blockIdx.x / a.S, split = blockIdx.x - group * a.S;
  const int groups = a.groups;                     // rows a group apart share a block
  const int ch = a.hd / (32 * VEC);
  const int e0 = split * a.P;
  const int n_e = min(a.P, a.k - e0);
  const size_t page_elems = (size_t)a.pt * 2 * a.hd;
  const size_t hv = (size_t)a.hd / VEC;              // a row of K or V, in V
  float* const ml = a.ws;
  float* const pacc = a.ws + ((size_t)2 * a.rows * a.S + 3) / 4 * 4;   // 16-byte aligned

  // 1. the visible pages of this split, for each row: lane = entry.  All
  //    the rows' ids are loaded before the first ballot.
  int pid_r[kRowsPerWarp], nvis_r[kRowsPerWarp];
#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t) {
    const int g = warp + t * kWarps, r = group + g * groups;
    int nvis = 0, pid = 0;
    if (g < a.G && r < a.rows && lane < n_e) {
      const int i = r / a.Sq, s = r - i * a.Sq, e = e0 + lane;
      nvis = a.causal ? min(a.pt, s + (a.k - e) * a.pt - a.Sq + 1) : a.pt;
      if (nvis > 0) pid = __ldg(a.ids + (size_t)i * a.k + e);
    }
    pid_r[t] = pid;
    nvis_r[t] = nvis;
  }
#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t) {
    const int g = warp + t * kWarps;
    if (g >= a.G) break;
    int pid = pid_r[t], nvis = nvis_r[t];
    if (pid < 0) nvis = 0;                          // masked page: never read
    if (pid >= a.n_pages) pid = a.n_pages - 1;      // clamp, as the reference does
    const unsigned live = __ballot_sync(0xffffffffu, nvis > 0);
    if (nvis > 0) {
      const int at = __popc(live & ((1u << lane) - 1u));
      s_pid[g][at] = pid;
      s_nvis[g][at] = nvis;
    }
    if (lane == 0) s_n[g] = __popc(live);
  }
  __syncthreads();

  // 2. each row's partial over this split.  Warp w takes tokens
  //    [w*U, w*U + U), then [(w + kWarps)*U, ...) of the listed pages.
  for (int g = 0; g < a.G && group + g * groups < a.rows; ++g) {
    const int r = group + g * groups;
    const size_t slot = (size_t)r * a.S + split;
    const int n_tok = s_n[g] * a.pt;
    if (n_tok == 0) {                                // nothing visible: l = 0
      if (tid == 0) { ml[2 * slot] = kNegInf; ml[2 * slot + 1] = 0.0f; }
      continue;
    }
    const int i = r / a.Sq;
    const float* pool =
        a.table != nullptr
            ? reinterpret_cast<const float*>(reinterpret_cast<const char*>(a.table[a.owner]) +
                                             a.table_off)
            : a.kv + (size_t)((i + a.off) % a.p) * a.pool_stride;
    const V* qrow = reinterpret_cast<const V*>(a.q + (size_t)r * a.hd);
    V qv[NC], acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      zero(acc[c]);
      if (c < ch) qv[c] = __ldg(qrow + c * 32 + lane); else zero(qv[c]);
    }
    float m_w = kNegInf, l_w = 0.0f;
    for (int base = warp * U; base < n_tok; base += kWarps * U) {
      V kr[U][NC], vr[U][NC];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = base + u;
        const int pg = t < n_tok ? t / a.pt : 0;
        const int tk = t - pg * a.pt;
        ok[u] = t < n_tok && tk < s_nvis[g][pg];
        const V* kp = reinterpret_cast<const V*>(
            pool + (size_t)s_pid[g][pg] * page_elems + (size_t)tk * 2 * a.hd);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (ok[u] && c < ch) {
            kr[u][c] = __ldg(kp + c * 32 + lane);
            vr[u][c] = __ldg(kp + hv + c * 32 + lane);
          } else {
            zero(kr[u][c]);
            zero(vr[u][c]);
          }
        }
      }
      float sc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float d = 0.0f;
#pragma unroll
        for (int c = 0; c < NC; ++c) d += dot(qv[c], kr[u][c]);
        sc[u] = d;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u) sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o);
      float mb = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) mb = fmaxf(mb, sc[u]);
      const float m_new = fmaxf(m_w, mb);
      const float corr = expf(m_w - m_new);
      l_w *= corr;
#pragma unroll
      for (int c = 0; c < NC; ++c) scale(acc[c], corr);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
        const float pu = expf(sc[u] - m_new);
        l_w += pu;
#pragma unroll
        for (int c = 0; c < NC; ++c) axpy(acc[c], pu, vr[u][c]);
      }
      m_w = m_new;
    }
    // the warps' states, combined in warp order
    if (lane == 0) { s_m[warp] = m_w; s_l[warp] = l_w; }
    V* mine = reinterpret_cast<V*>(s_acc + warp * a.hd);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < ch) mine[c * 32 + lane] = acc[c];
    __syncthreads();
    float M = s_m[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, s_m[w]);
    float wt[kWarps], L = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      wt[w] = expf(s_m[w] - M);
      L = fmaf(wt[w], s_l[w], L);
    }
    for (int col = tid; col < a.hd; col += kThreads) {
      float x = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) x = fmaf(wt[w], s_acc[w * a.hd + col], x);
      pacc[slot * a.hd + col] = x;
    }
    if (tid == 0) { ml[2 * slot] = M; ml[2 * slot + 1] = L; }
    __syncthreads();                                 // s_m, s_acc serve the next row
  }

  // 3. the ticket: the group's last block merges.  The barrier orders the
  //    block's partials before thread 0's fence, which publishes them all
  //    (fences are cumulative) before the ticket; the merging block fences
  //    again before it reads the others' partials.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(a.tickets + group, 1) == a.S - 1;
    if (s_last) __threadfence();
  }
  __syncthreads();
  if (!s_last) return;

  // 3a. a warp a row: M over the splits that saw a token.  The first 32
  //     splits of all the warp's rows are loaded before the first reduction.
  const float2* ml2 = reinterpret_cast<const float2*>(ml);
  float2 first[kRowsPerWarp];
#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t) {
    const int g = warp + t * kWarps, r = group + g * groups;
    first[t] = g < a.G && r < a.rows && lane < a.S ? __ldcg(ml2 + (size_t)r * a.S + lane)
                                                   : make_float2(kNegInf, 0.0f);
  }
#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t) {
    const int g = warp + t * kWarps, r = group + g * groups;
    if (g >= a.G || r >= a.rows) break;
    float M = first[t].y > 0.0f ? first[t].x : kNegInf;
    bool any = first[t].y > 0.0f;
    for (int j = lane + 32; j < a.S; j += 32) {
      const float2 v = __ldcg(ml2 + (size_t)r * a.S + j);
      if (v.y > 0.0f) { M = fmaxf(M, v.x); any = true; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) { s_M[g] = M; s_any[g] = any; }
  }
  __syncthreads();

  // 3b. each row: warp w sums the run of splits [w*per, w*per + per) in
  //     order, the block sums the runs in warp order
  const int per = (a.S + kWarps - 1) / kWarps;
  const int j_lo = min(a.S, warp * per), j_hi = min(a.S, j_lo + per);
  const V* pacc_v = reinterpret_cast<const V*>(pacc);
  for (int g = 0; g < a.G && group + g * groups < a.rows; ++g) {
    const int r = group + g * groups;
    V* orow = reinterpret_cast<V*>(a.out + (size_t)r * a.hd);
    if (!s_any[g]) {                                 // every split empty: zeros
      V z;
      zero(z);
      for (int x = tid; x < (int)hv; x += kThreads) orow[x] = z;
      continue;
    }
    const float M = s_M[g];
    V acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) zero(acc[c]);
    float L = 0.0f;
    for (int j0 = j_lo; j0 < j_hi; j0 += U) {
      float2 mv[U];
      V av[U][NC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        const bool in = j < j_hi;
        mv[u] = in ? __ldcg(ml2 + (size_t)r * a.S + j) : make_float2(kNegInf, 0.0f);
        const V* src = pacc_v + ((size_t)r * a.S + (in ? j : j_lo)) * hv;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (in && c < ch) av[u][c] = __ldcg(src + c * 32 + lane); else zero(av[u][c]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!(mv[u].y > 0.0f)) continue;             // an empty split wrote no acc
        const float w = expf(mv[u].x - M);
        L = fmaf(w, mv[u].y, L);
#pragma unroll
        for (int c = 0; c < NC; ++c) axpy(acc[c], w, av[u][c]);
      }
    }
    if (lane == 0) s_l[warp] = L;
    V* mine = reinterpret_cast<V*>(s_acc + warp * a.hd);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < ch) mine[c * 32 + lane] = acc[c];
    __syncthreads();
    float Lt = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) Lt += s_l[w];
    const float denom = fmaxf(Lt, 1e-30f);
    for (int col = tid; col < a.hd; col += kThreads) {
      float x = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) x += s_acc[w * a.hd + col];
      a.out[(size_t)r * a.hd + col] = x / denom;
    }
    __syncthreads();
  }
  if (tid == 0) a.tickets[group] = 0;                // ready for the next call
}

template <int VEC, int NC>
int launch(const Args& a, int blocks, cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * a.hd * sizeof(float);
  paged_attention_split<VEC, NC><<<blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int run(Args a, cudaStream_t stream) {
  if (a.rows == 0) return (int)cudaSuccess;
  if (a.hd <= 0 || a.hd % 32 || a.hd > 1024 || a.k < 1 || a.pt < 1 ||
      a.P < 1 || a.P > kMaxPages || a.S != (a.k + a.P - 1) / a.P ||
      a.groups < 1 || (a.rows + a.groups - 1) / a.groups > kMaxGroup)
    return (int)cudaErrorInvalidValue;            // the plan is ops.plan's
  a.G = (a.rows + a.groups - 1) / a.groups;
  const long long blocks = (long long)a.groups * a.S;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int n = (int)blocks;
  // a segment's bases come from cudaMalloc (256-byte aligned)
  const bool kv16 = a.table != nullptr ? a.table_off % 16 == 0 : aligned16(a.kv);
  if (a.hd % 128 == 0 && aligned16(a.q) && kv16 && aligned16(a.out) && aligned16(a.ws)) {
    switch (a.hd / 128) {                          // float4 chunks a lane
      case 1: return launch<4, 1>(a, n, stream);
      case 2: return launch<4, 2>(a, n, stream);
      case 3: case 4: return launch<4, 4>(a, n, stream);
      default: return launch<4, 8>(a, n, stream);
    }
  }
  const int ch = a.hd / 32;                        // floats a lane
  if (ch == 1) return launch<1, 1>(a, n, stream);
  if (ch == 2) return launch<1, 2>(a, n, stream);
  if (ch <= 4) return launch<1, 4>(a, n, stream);
  if (ch <= 8) return launch<1, 8>(a, n, stream);
  if (ch <= 16) return launch<1, 16>(a, n, stream);
  return launch<1, 32>(a, n, stream);
}

}  // namespace

// C entries: pointers and the stream as void*, sizes as int.  `ws` holds
// ceil(2 * rows * S / 4) * 4 + rows * S * hd floats (ops.plan's
// `workspace`), `tickets` at least `groups` ints, all 0.  Each returns
// cudaGetLastError() after its one launch (0 = launched), or
// cudaErrorInvalidValue for a plan it refuses.
extern "C" int paged_attention_f32(const void* q, const void* kv_pages,
                                   const void* ids, void* out, void* ws,
                                   void* tickets, int m, int Sq, int hd,
                                   int n_pages, int pt, int k, int causal,
                                   int P, int S, int groups, void* stream) {
  const Args a{static_cast<const float*>(q), static_cast<const float*>(kv_pages),
               static_cast<const int32_t*>(ids), static_cast<float*>(out),
               static_cast<float*>(ws), static_cast<int*>(tickets), nullptr, 0, 0, 0, 1, 0,
               Sq, hd, n_pages, pt, k, causal, P, S, groups, m * Sq, 0};
  return run(a, (cudaStream_t)stream);
}

// Cross-rank entry: rank r attends over pages ids[r] of pool
// (r + shift) mod p.
extern "C" int paged_attention_shift_f32(const void* q, const void* kv_pages,
                                         const void* ids, void* out, void* ws,
                                         void* tickets, int p, int shift, int Sq,
                                         int hd, int n_pages, int pt, int k,
                                         int causal, int P, int S, int groups,
                                         void* stream) {
  if (p < 1) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(q), static_cast<const float*>(kv_pages),
               static_cast<const int32_t*>(ids), static_cast<float*>(out),
               static_cast<float*>(ws), static_cast<int*>(tickets), nullptr, 0, 0,
               (size_t)n_pages * pt * 2 * hd, p, ((shift % p) + p) % p,
               Sq, hd, n_pages, pt, k, causal, P, S, groups, p * Sq, 0};
  return run(a, (cudaStream_t)stream);
}

// Peer entry: this rank's q [1, Sq, hd] attends over pages ids [1, k] of
// rank (rank + shift) mod p's pool, [n_pages, pt, 2, hd] f32 at off_bytes of
// the segment whose base pointers `table` holds (device memory).
extern "C" int paged_attention_peer_f32(const void* q, const void* table, long long off_bytes,
                                        const void* ids, void* out, void* ws, void* tickets,
                                        int p, int rank, int shift, int Sq, int hd,
                                        int n_pages, int pt, int k, int causal, int P, int S,
                                        int groups, void* stream) {
  if (p < 1 || rank < 0 || rank >= p || off_bytes < 0) return (int)cudaErrorInvalidValue;
  const int owner = (int)((((long long)rank + shift) % p + p) % p);
  const Args a{static_cast<const float*>(q), nullptr,
               static_cast<const int32_t*>(ids), static_cast<float*>(out),
               static_cast<float*>(ws), static_cast<int*>(tickets),
               static_cast<const unsigned long long*>(table), off_bytes, owner, 0, 1, 0,
               Sq, hd, n_pages, pt, k, causal, P, S, groups, Sq, 0};
  return run(a, (cudaStream_t)stream);
}
