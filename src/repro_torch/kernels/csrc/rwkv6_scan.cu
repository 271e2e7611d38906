// RWKV-6 linear-attention scan for NVIDIA Hopper (sm_90a), plain C interface.
//
// Built by repro_torch/kernels/build.py with the flags of masked_act.cu and
// loaded with ctypes.  The entry point launches on the stream it is given,
// allocates nothing, does not synchronise, and returns cudaGetLastError().
// It takes a route: 0 is route S, the token-serial kernel below; 1 is route
// C, the chunked kernel on the TF32 tensor cores (rwkv6_scan_sm90.cu).
//
//  * rwkv6_scan_kernel      <- src/repro/kernels/rwkv6_scan.py rwkv6_scan
//    For each (batch*head) row bh, over tokens t:
//      y_t = r_t . S_{t-1} + (r_t . (u (.) k_t)) v_t
//      S_t = diag(w_t) S_{t-1} + k_t^T v_t
//    r, k, w (BH, T, K), v (BH, T, V), state (BH, K, V), all float32.
//
// The TPU kernel chunks the recurrence so that its in-chunk part becomes
// two matrix products on the MXU; that form divides by the in-chunk decay
// product, which needs T % chunk == 0 and overflows float32 under strong
// decay.  Here the recurrence runs token by token, as public RWKV-6 CUDA
// kernels do: one block per bh, one thread per value column v, which keeps
// its column S[:, v] of the state in registers for the whole sequence, so
// the state is read once and written once.  Tokens are staged TC at a time
// in shared memory (r, k, w zero-padded to KMAX columns, so the inner loops
// need no predicates); every thread reads the same r/k/w word at once (a
// broadcast), and its y_t[v] store is coalesced across the block.  The
// bonus r_t . (u (.) k_t) is the same for every column and is computed once
// per token while staging, with u staged once per block.
//
// Bound on this card: bytes.  At the LM path's stacked shape
// (1280, 128, 64, 64) it moves about 230 MB (0.07 ms at 3.35 TB/s) and does
// 5 K V flops a token and row (3.4 GFLOP, 0.05 ms at the float32 rate);
// the serial loop makes it latency-bound in practice: 128 dependent token
// steps a block, with 1280 blocks of two warps resident at once.
//
// u is an (u_rows, K) table, row bh % u_rows: a per-head (H, K) table
// serves B*H rows without a copy, u_rows = 1 a stride-0 expanded row.  The
// initial state's row stride is K*V or 0 (one shared zero state).

#include <cuda_runtime.h>

namespace {

constexpr int kTC = 16;     // tokens staged per pass
constexpr int kVMax = 64;   // threads (value columns) per block

template <int KMAX>
__global__ void __launch_bounds__(kVMax)
    rwkv6_scan_kernel(const float* __restrict__ r,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ s0, float* __restrict__ y,
                      float* __restrict__ s_out, int T, int K, int V,
                      int u_rows, long long s0_stride) {
  // 16-byte aligned rows: the unrolled inner loops may read four words
  // per shared-memory load
  __shared__ __align__(16) float sr[kTC][KMAX];
  __shared__ __align__(16) float sk[kTC][KMAX];
  __shared__ __align__(16) float sw[kTC][KMAX];
  __shared__ __align__(16) float su[KMAX];
  __shared__ float sv[kTC][kVMax];
  __shared__ float sb[kTC];

  const long long bh = blockIdx.x;
  const int j = threadIdx.x;               // value column, j < V
  const float* ur = u + (long long)(bh % u_rows) * K;
  for (int kk = j; kk < KMAX; kk += V) su[kk] = kk < K ? ur[kk] : 0.0f;
  const long long seq_k = bh * T * K;      // start of row bh in r, k, w
  const long long seq_v = bh * T * V;      // start of row bh in v, y

  float S[KMAX];
  const float* s0r = s0 + bh * s0_stride;
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk)
    S[kk] = kk < K ? s0r[(long long)kk * V + j] : 0.0f;

  for (int t0 = 0; t0 < T; t0 += kTC) {
    const int n = min(kTC, T - t0);
    __syncthreads();                        // the last pass is done reading
    // unrolled so that several iterations' loads are in flight at once
#pragma unroll 4
    for (int i = j; i < n * KMAX; i += V) {
      const int t = i / KMAX, kk = i % KMAX;
      const bool in = kk < K;
      const long long g = seq_k + (long long)(t0 + t) * K + kk;
      sr[t][kk] = in ? r[g] : 0.0f;
      sk[t][kk] = in ? k[g] : 0.0f;
      sw[t][kk] = in ? w[g] : 0.0f;
    }
#pragma unroll 4
    for (int i = j; i < n * V; i += V)
      sv[i / V][i % V] = v[seq_v + (long long)t0 * V + i];
    __syncthreads();
    for (int t = j; t < n; t += V) {
      float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f, b3 = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KMAX; kk += 4) {
        b0 += sr[t][kk] * (su[kk] * sk[t][kk]);
        b1 += sr[t][kk + 1] * (su[kk + 1] * sk[t][kk + 1]);
        b2 += sr[t][kk + 2] * (su[kk + 2] * sk[t][kk + 2]);
        b3 += sr[t][kk + 3] * (su[kk + 3] * sk[t][kk + 3]);
      }
      sb[t] = (b0 + b1) + (b2 + b3);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vv = sv[t][j];
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KMAX; kk += 4) {
        a0 += sr[t][kk] * S[kk];
        a1 += sr[t][kk + 1] * S[kk + 1];
        a2 += sr[t][kk + 2] * S[kk + 2];
        a3 += sr[t][kk + 3] * S[kk + 3];
      }
      y[seq_v + (long long)(t0 + t) * V + j] = (a0 + a1) + (a2 + a3) +
                                               sb[t] * vv;
#pragma unroll
      for (int kk = 0; kk < KMAX; ++kk)
        S[kk] = sw[t][kk] * S[kk] + sk[t][kk] * vv;
    }
  }

  float* so = s_out + bh * (long long)K * V;
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk)
    if (kk < K) so[(long long)kk * V + j] = S[kk];
}

template <int KMAX>
void launch(const float* r, const float* k, const float* v, const float* w,
            const float* u, const float* s0, float* y, float* s_out, int BH,
            int T, int K, int V, int u_rows, long long s0_stride,
            cudaStream_t stream) {
  rwkv6_scan_kernel<KMAX><<<BH, V, 0, stream>>>(
      r, k, v, w, u, s0, y, s_out, T, K, V, u_rows, s0_stride);
}

}  // namespace

// route C, in rwkv6_scan_sm90.cu
int rwkv6_scan_tf32x3_launch(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             void* y, void* s_out, void* states, int BH,
                             int T, int K, int V, int u_rows,
                             long long s0_stride, cudaStream_t stream);

// K, V in [1, 64]; u_rows >= 1 divides BH; s0_stride is K*V or 0; route 0
// (S, token-serial) or 1 (C, chunked on the tensor cores).  states, null
// or BH * ceil(T / 16) tiles of 64 x 64 floats, takes the state entering
// each chunk of 16 tokens (route C only; the backward reads it).  A route
// that cannot take the call is refused, never replaced.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* s0,
                                 void* y, void* s_out, void* states, int BH,
                                 int T, int K, int V, int u_rows,
                                 long long s0_stride, int route,
                                 void* stream) {
  if (BH <= 0) return 0;
  if (T < 0 || K < 1 || K > 64 || V < 1 || V > kVMax || u_rows < 1 ||
      BH % u_rows || (route != 0 && route != 1) ||
      (route == 0 && states != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return rwkv6_scan_tf32x3_launch(r, k, v, w, u, s0, y, s_out, states, BH,
                                    T, K, V, u_rows, s0_stride, s);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (K <= 16)
    launch<16>(f(r), f(k), f(v), f(w), f(u), f(s0), o(y), o(s_out), BH, T, K,
               V, u_rows, s0_stride, s);
  else if (K <= 32)
    launch<32>(f(r), f(k), f(v), f(w), f(u), f(s0), o(y), o(s_out), BH, T, K,
               V, u_rows, s0_stride, s);
  else
    launch<64>(f(r), f(k), f(v), f(w), f(u), f(s0), o(y), o(s_out), BH, T, K,
               V, u_rows, s0_stride, s);
  return static_cast<int>(cudaGetLastError());
}
