// Fused gate -> matrix product for NVIDIA Hopper (sm_90a), plain C
// interface.  Built with the other sources by repro_torch/kernels/build.py
// and loaded with ctypes; the entry point launches on the stream it is
// given, allocates nothing, does not synchronise, and returns
// cudaGetLastError().
//
//  * gate_matmul_kernel     <- src/repro/kernels/masked_act.py
//                              masked_act_matmul_2d (:235) and
//                              masked_act_matmul_2d_batched (:299)
//    out = ((m*act(x) + (1-m)*x) [* mul]) @ w, the LM FFN's masked gate,
//    its up-branch product and its down-projection in one launch.
//    x and mul (rows, K) per candidate, mask (K,) per candidate, w (K, Nout)
//    shared by the candidates, out (rows, Nout) per candidate.
//
//    Bound by operations on this card: 2*rows*K*Nout flops against
//    (2*rows*K + K*Nout + rows*Nout) elements moved, about 360 flops a byte
//    in float32 and 720 in bfloat16 at the LM's shapes (4 x 1016 rows,
//    K = 5632, Nout = 2048), above the ridge of the float32 units (20) and
//    of the bfloat16 tensor cores (295).  This first version is float32 FMA
//    outside the tensor cores, so 67 TFLOP/s is its ceiling in both storage
//    types; a bfloat16 version on wgmma is a later change.
//    The Pallas kernel keeps whole (rows-block, K) and (K, Nout) blocks in
//    VMEM; here that is a tiled GEMM instead: a block owns a 128 x 128
//    output tile, 256 threads each accumulate an 8 x 8 micro-tile in
//    registers, and K advances 16 at a time through double-buffered shared
//    memory (the next step's global loads are issued before the current
//    step's FMAs and gated and stored only after them, so a step costs one
//    barrier).  The gate, and the product with mul, are applied to every
//    x element on its way into shared memory: the gated tensor never reaches
//    device memory, which is what the TPU kernel exists for.  Ragged edges in
//    rows, K and Nout are predicated loads that yield 0 and predicated
//    stores.  The candidate strides of x, mul and the mask are arguments
//    (0 = shared), which is all that separates the stacked kernel from the
//    single one: the first FFN after a cached prefix reads one shared x and
//    mul N times, and the (N, rows, K) broadcast is never written.
//
// Arithmetic is float32 whatever the storage type (float32 or bfloat16):
// the gate and the product with mul are rounded on their own, as the plain
// version rounds them, the sum runs in float32 and is rounded once, on the
// store.

#include "masked_act_common.cuh"

namespace {

constexpr int MM_BM = 128;   // rows per block
constexpr int MM_BN = 128;   // output columns per block
constexpr int MM_BK = 16;    // K per step
constexpr int MM_THREADS = 256;

struct MatmulGeom {
  long long rows;
  int K, Nout;
  long long x_cand_stride, mul_cand_stride, mask_cand_stride;
};

template <class T, int KIND, bool MUL>
__global__ void __launch_bounds__(MM_THREADS, 2)
gate_matmul_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                   const T* __restrict__ mul, const T* __restrict__ w,
                   T* __restrict__ out, const MatmulGeom g, const int vec_a,
                   const int vec_b) {
  __shared__ __align__(16) float As[2][MM_BK][MM_BM];
  __shared__ __align__(16) float Bs[2][MM_BK][MM_BN];

  const int tid = threadIdx.x;
  const long long cand = blockIdx.z;
  const long long m0 = (long long)blockIdx.x * MM_BM;
  const int n0 = blockIdx.y * MM_BN;
  const int KT = (g.K + MM_BK - 1) / MM_BK;

  // A loader: 8 consecutive k of one row per step
  const int a_row = tid & (MM_BM - 1);
  const int a_k0 = (tid >> 7) * 8;
  const long long a_m = m0 + a_row;
  const bool a_valid = a_m < g.rows;
  const T* xr = x + cand * g.x_cand_stride + (a_valid ? a_m : 0) * g.K;
  const T* ur = MUL ? mul + cand * g.mul_cand_stride +
                          (a_valid ? a_m : 0) * g.K
                    : nullptr;
  const float* mk = mask + cand * g.mask_cand_stride;

  // B loader: 8 consecutive output columns of one row of w per step
  const int b_k = tid / (MM_BN / 8);
  const int b_c = (tid % (MM_BN / 8)) * 8;

  // Raw values of the next step, as loaded: nothing is computed from them
  // until the current step's FMAs are done.  Out-of-range elements are
  // x = 0 (and mul = 0) under mask 0, which every kind gates to 0.
  Pack<T, 8> rx;
  Pack<T, 8> ru;
  Pack<float, 4> rm[2];
  Pack<T, 4> rw[2];

  auto issue_loads = [&](int kt) {
    const int k0 = kt * MM_BK + a_k0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      rx.v[j] = from_f<T>(0.0f);
      if (MUL) ru.v[j] = from_f<T>(0.0f);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) rm[0].v[j] = rm[1].v[j] = 0.0f;
    if (a_valid && k0 < g.K) {
      if (vec_a) {
        rx = *reinterpret_cast<const Pack<T, 8>*>(xr + k0);
        if (MUL) ru = *reinterpret_cast<const Pack<T, 8>*>(ur + k0);
        rm[0] = *reinterpret_cast<const Pack<float, 4>*>(mk + k0);
        rm[1] = *reinterpret_cast<const Pack<float, 4>*>(mk + k0 + 4);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (k0 + j < g.K) {
            rx.v[j] = xr[k0 + j];
            if (MUL) ru.v[j] = ur[k0 + j];
            rm[j >> 2].v[j & 3] = mk[k0 + j];
          }
      }
    }
    const int kb = kt * MM_BK + b_k;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + b_c + 4 * h;
#pragma unroll
      for (int j = 0; j < 4; ++j) rw[h].v[j] = from_f<T>(0.0f);
      if (kb < g.K && n < g.Nout) {
        const T* wp = w + (long long)kb * g.Nout + n;
        if (vec_b) {
          rw[h] = *reinterpret_cast<const Pack<T, 4>*>(wp);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < g.Nout) rw[h].v[j] = wp[j];
        }
      }
    }
  };

  // gate (and multiply) the raw values into shared-memory buffer `buf`
  auto commit_tiles = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = gate<KIND>(to_f(rx.v[j]), rm[j >> 2].v[j & 3]);
      if (MUL) v = __fmul_rn(v, to_f(ru.v[j]));
      As[buf][a_k0 + j][a_row] = v;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(&Bs[buf][b_k][b_c + 4 * h]) =
          make_float4(to_f(rw[h].v[0]), to_f(rw[h].v[1]), to_f(rw[h].v[2]),
                      to_f(rw[h].v[3]));
  };

  // compute mapping: rows ty*4..+3 and 64+ty*4..+3, columns tx*4..+3 and
  // 64+tx*4..+3
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  issue_loads(0);
  commit_tiles(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < KT;
    if (more) issue_loads(kt + 1);
#pragma unroll
    for (int k = 0; k < MM_BK; ++k) {
      const float4 a_lo =
          *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a_hi =
          *reinterpret_cast<const float4*>(&As[cur][k][64 + ty * 4]);
      const float4 b_lo =
          *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b_hi =
          *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tx * 4]);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                          a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float b[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                          b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read in the previous step, and every thread
    // has passed that step's barrier
    if (more) commit_tiles(cur ^ 1);
    __syncthreads();
  }

  T* out_c = out + cand * g.rows * g.Nout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= g.rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n >= g.Nout) continue;
      T* op = out_c + m * g.Nout + n;
      if (vec_b) {
        Pack<T, 4> res;
#pragma unroll
        for (int j = 0; j < 4; ++j) res.v[j] = from_f<T>(acc[i][4 * h + j]);
        *reinterpret_cast<Pack<T, 4>*>(op) = res;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < g.Nout) op[j] = from_f<T>(acc[i][4 * h + j]);
      }
    }
  }
}

template <class T, int KIND, bool MUL>
void launch_matmul(const void* x, const void* mask, const void* mul,
                   const void* w, void* out, int n_cand,
                   const MatmulGeom& g, cudaStream_t stream) {
  // 8 consecutive k of x (and mul) and mask in one load: K a multiple of 8
  // keeps every such load inside its row and aligned; 4 output columns
  // likewise for w and out
  const int vec_a =
      g.K % 8 == 0 && g.x_cand_stride % 8 == 0 &&
      g.mul_cand_stride % 8 == 0 && g.mask_cand_stride % 4 == 0 &&
      aligned_to(x, 8 * sizeof(T)) &&
      (!MUL || aligned_to(mul, 8 * sizeof(T))) && aligned16(mask);
  const int vec_b = g.Nout % 4 == 0 && aligned_to(w, 4 * sizeof(T)) &&
                    aligned_to(out, 4 * sizeof(T));
  dim3 grid((unsigned)((g.rows + MM_BM - 1) / MM_BM),
            (unsigned)((g.Nout + MM_BN - 1) / MM_BN), (unsigned)n_cand);
  gate_matmul_kernel<T, KIND, MUL><<<grid, MM_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mask),
      static_cast<const T*>(mul), static_cast<const T*>(w),
      static_cast<T*>(out), g, vec_a, vec_b);
}

template <class T, int KIND>
void dispatch_matmul_mul(const void* x, const void* mask, const void* mul,
                         const void* w, void* out, int n_cand,
                         const MatmulGeom& g, cudaStream_t stream) {
  if (mul != nullptr)
    launch_matmul<T, KIND, true>(x, mask, mul, w, out, n_cand, g, stream);
  else
    launch_matmul<T, KIND, false>(x, mask, mul, w, out, n_cand, g, stream);
}

template <class T>
bool dispatch_matmul_kind(int kind, const void* x, const void* mask,
                          const void* mul, const void* w, void* out,
                          int n_cand, const MatmulGeom& g,
                          cudaStream_t stream) {
  switch (kind) {
    case kRelu:
      dispatch_matmul_mul<T, kRelu>(x, mask, mul, w, out, n_cand, g, stream);
      return true;
    case kGelu:
      dispatch_matmul_mul<T, kGelu>(x, mask, mul, w, out, n_cand, g, stream);
      return true;
    case kSilu:
      dispatch_matmul_mul<T, kSilu>(x, mask, mul, w, out, n_cand, g, stream);
      return true;
    case kSqrelu:
      dispatch_matmul_mul<T, kSqrelu>(x, mask, mul, w, out, n_cand, g,
                                      stream);
      return true;
  }
  return false;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  kind: 0 relu, 1 gelu, 2 silu, 3 sqrelu.
// Strides are in elements; the mask is float32; mul may be null.

extern "C" int masked_act_matmul_launch(
    const void* x, const void* mask, const void* mul, const void* w,
    void* out, int n_cand, long long rows, int K, int Nout,
    long long x_cand_stride, long long mul_cand_stride,
    long long mask_cand_stride, int kind, int dtype, void* stream) {
  if (n_cand <= 0 || rows <= 0 || Nout <= 0) return 0;
  if (K <= 0 || n_cand > 65535 || (Nout + MM_BN - 1) / MM_BN > 65535 ||
      (rows + MM_BM - 1) / MM_BM > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  MatmulGeom g{rows, K, Nout, x_cand_stride, mul_cand_stride,
               mask_cand_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0)
    ok = dispatch_matmul_kind<float>(kind, x, mask, mul, w, out, n_cand, g,
                                     s);
  else if (dtype == 1)
    ok = dispatch_matmul_kind<__nv_bfloat16>(kind, x, mask, mul, w, out,
                                             n_cand, g, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
