// The gradient of the RWKV-6 scan for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Built by repro_torch/kernels/build.py with the flags of masked_act.cu and
// loaded with ctypes.  The entry point launches on the stream it is given,
// allocates nothing (the wrapper hands it the checkpoint scratch and the
// per-row partials of du), does not synchronise, and returns
// cudaGetLastError().
//
//  * rwkv6_scan_bwd_kernel  <- port-only: the gradient of
//    src/repro/kernels/rwkv6_scan.py rwkv6_scan (the reference has no
//    backward pallas_call; JAX differentiates its jnp scan).  For the
//    forward  S_t = diag(w_t) S_{t-1} + k_t^T v_t,
//             y_t = r_t S_{t-1} + (r_t . (u (.) k_t)) v_t,
//    walked backward with dS carried:
//      dS_{t-1} = diag(w_t) dS_t + r_t^T dy_t
//      dr_t = dy_t S_{t-1}^T + (dy_t . v_t)(u (.) k_t)
//      dk_t = dS_t v_t^T + (dy_t . v_t)(u (.) r_t)
//      dv_t = k_t dS_t + (r_t . (u (.) k_t)) dy_t
//      dw_t[k] = sum_v dS_t[k, v] S_{t-1}[k, v]
//      du += (dy_t . v_t)(r_t (.) k_t)
//    r, k, w (BH, T, K), v, dy (BH, T, V), state, ds_end, ds0 (BH, K, V),
//    float32; the plain version is kernels/ref.py rwkv6_scan_bwd_ref.
//  * rwkv6_du_reduce_kernel: du's per-row partials summed over the rows of
//    each head, in increasing row order (no atomics: a finetune repeats
//    bit for bit).
//
// Design.  One block of 256 threads per row bh.  Thread (i, q), i = tid / 4
// and q = tid % 4, owns row i of the 64 x 64 state and of dS at the columns
// j = 4c + q, c < 16, in registers.  A forward pass runs the recurrence and
// writes the state before every chunk of kCk = 8 tokens to a scratch buffer
// (BH x ceil(T / 8) x 64 x 64).  The reverse pass takes the chunks last to
// first: it stages the chunk's r, k, w, v and dy in shared memory, and for
// each token recomputes S_{t-1} from the chunk's checkpoint (at most 7
// steps of the thread's 16 elements), so no state is ever recovered by
// dividing by a decay, which is not finite under strong decay.  dr, dk and
// dw are sums along a row: 16 products a thread and two shuffles over its
// four column lanes.  dv is a sum down the columns: a three-level
// reduce-scatter over the warp's eight rows leaves each lane two column
// sums, which the eight warps add in order in shared memory, double
// buffered so that one barrier a token suffices.
//
// Bound on this card: at the LM path's stacked shape (1280, 128, 64, 64)
// the function reads r, k, v, w, dy and writes dr, dk, dv, dw (378 MB,
// 0.11 ms at 3.35 TB/s) and does 12 K V flops a token and row (8 GFLOP,
// 0.12 ms at the float32 rate).  The checkpoints add 2 x 335 MB of traffic
// that the L2 cache partly holds, the recompute about 3.5 state steps a
// token; a simple kernel that is right comes first.

#include <cuda_runtime.h>

namespace {

constexpr int kW = 64;          // K and V at most
constexpr int kCk = 8;          // tokens a checkpoint interval
constexpr int kThreads = 256;   // 64 rows x 4 column lanes
constexpr int kWarps = kThreads / 32;
constexpr int kCols = kW / 4;   // state columns a thread owns
static_assert(kWarps == kCk, "one warp forms each token's dot products");

__device__ __forceinline__ float sum4(float x) {
  // the same bits in all four lanes of a row: float addition commutes
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// the chunk's token rows in shared memory, zero-padded to kW columns
struct Stage {
  float r[kCk][kW], k[kCk][kW], w[kCk][kW], v[kCk][kW], dy[kCk][kW];
  float u[kW];
  float dyv[kCk], b[kCk];
  float dv[2][kWarps][kW];      // dv's per-warp partials, double buffered
};

__device__ __forceinline__ void stage_rows(float (*dst)[kW],
                                           const float* __restrict__ src,
                                           long long base, int t0, int n,
                                           int width) {
  for (int e = threadIdx.x; e < kCk * kW; e += kThreads) {
    const int t = e / kW, c = e % kW;
    dst[t][c] = (t < n && c < width)
                    ? src[base + (long long)(t0 + t) * width + c]
                    : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
    rwkv6_scan_bwd_kernel(const float* __restrict__ r,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ w,
                          const float* __restrict__ u,
                          const float* __restrict__ s0,
                          const float* __restrict__ dy,
                          const float* __restrict__ ds_end,
                          float* __restrict__ ck, float* __restrict__ dr,
                          float* __restrict__ dk, float* __restrict__ dv,
                          float* __restrict__ dw, float* __restrict__ du_row,
                          float* __restrict__ ds0, int T, int K, int V,
                          int u_rows, long long s0_stride) {
  __shared__ Stage sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid >> 2, q = tid & 3;
  const long long bh = blockIdx.x;
  const long long base_k = bh * T * K, base_v = bh * T * V;
  const int n_ck = (T + kCk - 1) / kCk;
  float* ckr = ck + bh * (long long)n_ck * kW * kW;
  const bool row_in = i < K;

  if (tid < kW) sm.u[tid] = tid < K ? u[(bh % u_rows) * K + tid] : 0.0f;

  float s[kCols];
  const float* s0r = s0 + bh * s0_stride;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = 4 * c + q;
    s[c] = (row_in && j < V) ? s0r[(long long)i * V + j] : 0.0f;
  }

  // ---- forward: the state before each chunk, to the scratch buffer
  for (int ch = 0; ch < n_ck; ++ch) {
    const int t0 = ch * kCk, n = min(kCk, T - t0);
    __syncthreads();
    stage_rows(sm.k, k, base_k, t0, n, K);
    stage_rows(sm.w, w, base_k, t0, n, K);
    stage_rows(sm.v, v, base_v, t0, n, V);
    __syncthreads();
    float* dst = ckr + (long long)ch * kW * kW + i * kW;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dst[4 * c + q] = s[c];
    for (int t = 0; t < n; ++t) {
      const float wi = sm.w[t][i], ki = sm.k[t][i];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        s[c] = fmaf(wi, s[c], ki * sm.v[t][4 * c + q]);
    }
  }

  // ---- backward, chunk by chunk, last to first
  float d[kCols];
  const float* dse = ds_end == nullptr ? nullptr : ds_end + bh * K * V;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = 4 * c + q;
    d[c] = (dse != nullptr && row_in && j < V) ? dse[(long long)i * V + j]
                                               : 0.0f;
  }
  float du_acc = 0.0f;
  int buf = 0;
  for (int ch = n_ck - 1; ch >= 0; --ch) {
    const int t0 = ch * kCk, n = min(kCk, T - t0);
    __syncthreads();             // the last token's dv readers are done
    stage_rows(sm.r, r, base_k, t0, n, K);
    stage_rows(sm.k, k, base_k, t0, n, K);
    stage_rows(sm.w, w, base_k, t0, n, K);
    stage_rows(sm.v, v, base_v, t0, n, V);
    stage_rows(sm.dy, dy, base_v, t0, n, V);
    __syncthreads();
    {
      // warp t forms token t's dy.v and r.(u (.) k)
      const int t = warp;
      float a = sm.dy[t][lane] * sm.v[t][lane] +
                sm.dy[t][lane + 32] * sm.v[t][lane + 32];
      float bb = sm.r[t][lane] * (sm.u[lane] * sm.k[t][lane]) +
                 sm.r[t][lane + 32] * (sm.u[lane + 32] * sm.k[t][lane + 32]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        bb += __shfl_xor_sync(0xffffffffu, bb, o);
      }
      if (lane == 0) {
        sm.dyv[t] = a;
        sm.b[t] = bb;
      }
    }
    float cp[kCols];
    const float* src = ckr + (long long)ch * kW * kW + i * kW;
#pragma unroll
    for (int c = 0; c < kCols; ++c) cp[c] = src[4 * c + q];
    __syncthreads();
    const float ui = sm.u[i];
    for (int t = n - 1; t >= 0; --t) {
      // S_{t-1}: the checkpoint, advanced through the chunk's tokens < t
      float sp[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) sp[c] = cp[c];
      for (int a = 0; a < t; ++a) {
        const float wa = sm.w[a][i], ka = sm.k[a][i];
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          sp[c] = fmaf(wa, sp[c], ka * sm.v[a][4 * c + q]);
      }
      const float ri = sm.r[t][i], ki = sm.k[t][i], wi = sm.w[t][i];
      const float yv = sm.dyv[t];
      float pr = 0.0f, pk = 0.0f, pw = 0.0f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float dyj = sm.dy[t][4 * c + q], vj = sm.v[t][4 * c + q];
        pr = fmaf(dyj, sp[c], pr);
        pk = fmaf(d[c], vj, pk);
        pw = fmaf(d[c], sp[c], pw);
      }
      pr = sum4(pr);
      pk = sum4(pk);
      pw = sum4(pw);
      if (row_in) {
        const long long o = base_k + (long long)(t0 + t) * K + i;
        if (q == 0)
          dr[o] = pr + yv * (ui * ki);
        else if (q == 1)
          dk[o] = pk + yv * (ui * ri);
        else if (q == 2)
          dw[o] = pw;
        else
          du_acc += yv * (ri * ki);
      }
      // dv's partial over the warp's eight rows: reduce-scatter on the lane
      // bits 4, 3, 2 (rows), two columns left in each lane
      float p16[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) p16[c] = ki * d[c];
      float p8[8], p4[4], p2[2];
      const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float keep = h16 ? p16[c + 8] : p16[c];
        const float send = h16 ? p16[c] : p16[c + 8];
        p8[c] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float keep = h8 ? p8[c + 4] : p8[c];
        const float send = h8 ? p8[c] : p8[c + 4];
        p4[c] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float keep = h4 ? p4[c + 2] : p4[c];
        const float send = h4 ? p4[c] : p4[c + 2];
        p2[c] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
      }
      const int c0 = (h16 ? 8 : 0) + (h8 ? 4 : 0) + (h4 ? 2 : 0);
      sm.dv[buf][warp][4 * c0 + q] = p2[0];
      sm.dv[buf][warp][4 * (c0 + 1) + q] = p2[1];
      // dS_{t-1}
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        d[c] = fmaf(wi, d[c], ri * sm.dy[t][4 * c + q]);
      __syncthreads();
      if (tid < V) {
        float acc = sm.dv[buf][0][tid];
#pragma unroll
        for (int g = 1; g < kWarps; ++g) acc += sm.dv[buf][g][tid];
        dv[base_v + (long long)(t0 + t) * V + tid] = acc + sm.b[t] * sm.dy[t][tid];
      }
      buf ^= 1;
    }
  }

  if (row_in && q == 3) du_row[bh * K + i] = du_acc;
  if (ds0 != nullptr && row_in) {
    float* o = ds0 + bh * (long long)K * V + (long long)i * V;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (4 * c + q < V) o[4 * c + q] = d[c];
  }
}

// du[h, k] = sum over b of du_row[b * H + h, k], b increasing
__global__ void rwkv6_du_reduce_kernel(const float* __restrict__ du_row,
                                       float* __restrict__ du, int BH, int H,
                                       int K) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= H * K) return;
  float acc = du_row[e];
  for (int b = 1; b < BH / H; ++b) acc += du_row[(long long)b * H * K + e];
  du[e] = acc;
}

}  // namespace

// K, V in [1, 64]; u_rows >= 1 and du_rows >= 1 divide BH; s0_stride is
// K*V or 0; ds_end and ds0 may be null.  ck holds BH * ceil(T / 8) * 64 * 64
// floats.  du is (du_rows, K): with du_rows == BH the rows are written
// straight into it (du_row may then be du itself), otherwise du_row
// (BH, K) takes the per-row partials and a second kernel sums them by head.
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, const void* dy, const void* ds_end,
    void* ck, void* du_row, void* dr, void* dk, void* dv, void* dw, void* du,
    void* ds0, int BH, int T, int K, int V, int u_rows, long long s0_stride,
    int du_rows, void* stream) {
  if (BH <= 0) return 0;
  if (T < 0 || K < 1 || K > kW || V < 1 || V > kW || u_rows < 1 ||
      BH % u_rows || du_rows < 1 || BH % du_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  float* rows = du_rows == BH ? o(du) : o(du_row);
  rwkv6_scan_bwd_kernel<<<BH, kThreads, 0, s>>>(
      f(r), f(k), f(v), f(w), f(u), f(s0), f(dy), f(ds_end), o(ck), o(dr),
      o(dk), o(dv), o(dw), rows, o(ds0), T, K, V, u_rows, s0_stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || du_rows == BH) return static_cast<int>(err);
  const int n = du_rows * K;
  rwkv6_du_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(rows, o(du), BH,
                                                        du_rows, K);
  return static_cast<int>(cudaGetLastError());
}
