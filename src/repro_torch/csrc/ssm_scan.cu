// Selective scan (the Mamba recurrence), f32 state, for Hopper (sm_90a).
//
// Replaces repro/kernels/ssm_scan/kernel.py:ssm_scan_pallas and computes
// what repro_torch/kernels/ssm_scan/ref.py computes:
//
//   decay, drive [B, S, d, N] (f32 or bf16), c [B, S, N] f32,
//   h0 [B, d, N] f32 or none (zeros);
//   h_t = decay_t * h_{t-1} + drive_t from h_{-1} = h0 (f32 math),
//   y [B, S, d] = sum_N h_t * c_t in decay's dtype, h_last [B, d, N] f32 = h_{S-1}.
//
// The Pallas kernel walks a (B, d/block_d, S/block_t) grid with time
// innermost and a [block_d, N] state in VMEM scratch carried from one time
// block to the next; it asserts that block_d divides d and block_t divides S
// and starts from zero.  Here blocks run in no order, so nothing is carried
// between them: one thread owns one (b, channel, n) state for the whole
// sequence and walks time in a loop.  Any S >= 1 and any d; the wrapper
// casts c to f32 and checks N <= 32.
//
// Layout: a group of G lanes (G = the power of two >= N, at least 4) holds
// one channel's N states, so the N states of one step are G neighbouring
// elements and a warp reads 32 neighbouring elements of decay and drive a
// step.  The sum over N is a butterfly of shuffles within the group, and
// lane 0 of the group writes y.  The loads of the next kUnroll steps are
// issued before the current kUnroll steps are computed, so the serial
// recurrence always has loads in flight.
//
// Bound: bytes.  Each element of decay and drive is read once, c and y once
// each per (b, t), h0 and h_last once: 2*B*S*d*N + B*S*N + B*S*d elements
// plus the state.  The work is 3 flops an element (two FMAs and the shuffle
// adds), far below the card's rate.  At Jamba's shape (d 8192, N 16) one
// block of 128 threads covers 8 channels, so a 1024-token prompt launches
// 1024 blocks of one long serial loop each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(
    const T* __restrict__ decay, const T* __restrict__ drive,
    const float* __restrict__ c, const float* __restrict__ h0,
    T* __restrict__ y, float* __restrict__ h_last, long long S, long long d, int N) {
  constexpr int kChannels = kThreads / G;
  const int n = threadIdx.x % G;
  const long long ch = (long long)blockIdx.x * kChannels + threadIdx.x / G;
  const long long b = blockIdx.y;
  const bool active = ch < d && n < N;
  const long long dn = d * N;
  // element (b, t, ch, n) of decay / drive sits at base + t * dn
  const long long base = b * S * dn + ch * N + n;
  const long long cbase = b * S * N + n;

  float h = 0.0f;
  if (active && h0 != nullptr) h = h0[(b * d + ch) * N + n];

  float cur_d[kUnroll], cur_u[kUnroll], cur_c[kUnroll];
  float nxt_d[kUnroll], nxt_u[kUnroll], nxt_c[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const bool in = active && u < S;
    cur_d[u] = in ? to_f(decay[base + u * dn]) : 0.0f;
    cur_u[u] = in ? to_f(drive[base + u * dn]) : 0.0f;
    cur_c[u] = in ? c[cbase + u * N] : 0.0f;
  }
  for (long long t0 = 0; t0 < S; t0 += kUnroll) {
    // issue the next steps' loads before the current steps' recurrence
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long t = t0 + kUnroll + u;
      const bool in = active && t < S;
      nxt_d[u] = in ? to_f(decay[base + t * dn]) : 0.0f;
      nxt_u[u] = in ? to_f(drive[base + t * dn]) : 0.0f;
      nxt_c[u] = in ? c[cbase + t * N] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long t = t0 + u;
      if (t < S) {               // uniform across the block: every lane shuffles
        h = fmaf(cur_d[u], h, cur_u[u]);
        float p = h * cur_c[u];
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
        if (n == 0 && ch < d) y[(b * S + t) * d + ch] = from_f<T>(p);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      cur_d[u] = nxt_d[u];
      cur_u[u] = nxt_u[u];
      cur_c[u] = nxt_c[u];
    }
  }
  if (active && h_last != nullptr) h_last[(b * d + ch) * N + n] = h;
}

template <typename T, int G>
int launch(const void* decay, const void* drive, const float* c, const float* h0, void* y,
           float* h_last, long long B, long long S, long long d, int N, cudaStream_t s) {
  constexpr int kChannels = kThreads / G;
  dim3 grid((unsigned)((d + kChannels - 1) / kChannels), (unsigned)B);
  ssm_scan_kernel<T, G><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(decay), static_cast<const T*>(drive), c, h0,
      static_cast<T*>(y), h_last, S, d, N);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* decay, const void* drive, const float* c, const float* h0, void* y,
             float* h_last, long long B, long long S, long long d, int N, cudaStream_t s) {
  if (N <= 4) return launch<T, 4>(decay, drive, c, h0, y, h_last, B, S, d, N, s);
  if (N <= 8) return launch<T, 8>(decay, drive, c, h0, y, h_last, B, S, d, N, s);
  if (N <= 16) return launch<T, 16>(decay, drive, c, h0, y, h_last, B, S, d, N, s);
  return launch<T, 32>(decay, drive, c, h0, y, h_last, B, S, d, N, s);
}

}  // namespace

// dtype of decay, drive and y: 0 = f32, 1 = bf16.  c, h0 and h_last are f32;
// h0 and h_last may be null (zeros / not written).  Every tensor is
// contiguous.  1 <= N <= 32, B, S, d >= 1 and B < 65536.
extern "C" int ssm_scan_fwd(const void* decay, const void* drive, const void* c,
                            const void* h0, void* y, void* h_last, int dtype,
                            long long B, long long S, long long d, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B >= 65536 || S <= 0 || d <= 0 || N <= 0 || N > 32)
    return (int)cudaErrorInvalidValue;
  const float* cf = static_cast<const float*>(c);
  const float* h0f = static_cast<const float*>(h0);
  float* hl = static_cast<float*>(h_last);
  if (dtype == 0) return dispatch<float>(decay, drive, cf, h0f, y, hl, B, S, d, N, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(decay, drive, cf, h0f, y, hl, B, S, d, N, s);
  return (int)cudaErrorInvalidValue;
}
