// Fused gate -> matrix product for NVIDIA Hopper (sm_90a), plain C
// interface.  Built with the other sources by repro_torch/kernels/build.py
// and loaded with ctypes; the entry point launches on the stream it is
// given, allocates nothing, does not synchronise, and returns
// cudaGetLastError().
//
//  * masked_act_matmul_launch <- src/repro/kernels/masked_act.py
//                                masked_act_matmul_2d (:235) and
//                                masked_act_matmul_2d_batched (:299)
//    out = ((m*act(x) + (1-m)*x) [* mul]) @ w, the LM FFN's masked gate,
//    its up-branch product and its down-projection in one launch.
//    x and mul (rows, K) per candidate, mask (K,) per candidate, w (K, Nout)
//    shared by the candidates, out (rows, Nout) per candidate.  The candidate
//    strides of x, mul and the mask are arguments (0 = shared): the first FFN
//    after a cached prefix reads one shared x and mul N times, and the
//    (N, rows, K) broadcast is never written.  The gated tensor never reaches
//    device memory, which is what the TPU kernel exists for.
//
//    Two routes, chosen by the caller (kernels/masked_act.py matmul_route)
//    and refused here if they cannot take the call:
//      route A, bfloat16 on wgmma: masked_act_matmul_sm90.cu;
//      route B, gate_matmul_fma_kernel below: float32 FMA, for float32 and
//      for every shape route A does not take.
//
//  * gate_matmul_fma_kernel (route B)
//    Bound by operations on this card: 2*rows*K*Nout flops against
//    (2*rows*K + K*Nout + rows*Nout) elements moved, about 360 flops a byte
//    at the LM's shapes (4 x 1016 rows, K = 5632, Nout = 2048), far above
//    the ridge of the float32 units (67 TFLOP/s over 3.35 TB/s, 20).  It
//    stays exact float32 FMA, no TF32: the port runs float32 products in full
//    precision, and the fused suffix must select the blocks the batched
//    engine selects with gate + cuBLAS.  Its design is about keeping the FMA
//    units fed:
//      - a block owns a 64 x 128 output tile (1016 x 2048 gives 256 blocks;
//        64 KB of shared memory and at most 168 registers a thread let
//        three reside on an SM, beside each other's barriers), 128 threads
//        each accumulate an 8 x 8 micro-tile in registers and read it from
//        shared memory with conflict-free 16-byte loads (the A tile is
//        stored k-major so that 4 rows are one load);
//      - the raw x, mul, mask and w tiles of 16 k arrive by cp.async 16-byte
//        copies into a 3-stage ring, two stages ahead of the products;
//        nothing passes through registers on the way in;
//      - the gate (and the product with mul) is applied once per element in
//        shared memory, from the raw ring into a k-major A buffer, for the
//        next step while this step's copies are in flight, so a 16-k step
//        costs one barrier and the gate is off the FMA loop's path.
//    Ragged rows, K and Nout are zero-fill copies where K and Nout are
//    multiples of 4 and the operands 16-byte aligned, and predicated scalar
//    loads otherwise (and for bfloat16).  Summation is in a fixed order.
//
// Rounding: float32 as the plain version (the gate and the product with mul
// rounded on their own, no FMA contraction, the sum in float32).  In
// bfloat16 both routes round where the reference and the unfused route do:
// the gate to bfloat16, its product with mul to bfloat16 again, then the
// float32 sum once, on the store.

#include "masked_act_common.cuh"

namespace {

constexpr int FB_BM = 64;          // rows per block
constexpr int FB_BN = 128;         // output columns per block
constexpr int FB_BK = 16;          // k per step
constexpr int FB_STAGES = 3;       // raw stages in the ring
constexpr int FB_THREADS = 2 * FB_BM;
constexpr int FB_MIN_BLOCKS = 3;   // resident blocks per SM (64 KB each)
constexpr int FB_XLD = FB_BK + 4;   // raw row pitch: 80 bytes, conflict-free

struct FmaSmem {
  float x[FB_STAGES][FB_BM][FB_XLD];   // raw x, as copied
  float u[FB_STAGES][FB_BM][FB_XLD];   // raw mul
  float w[FB_STAGES][FB_BK][FB_BN];    // raw w, read by the products as is
  float m[FB_STAGES][FB_BK];           // the candidate's mask slice
  float a[2][FB_BK][FB_BM];            // gated A, k-major
};

struct MatmulGeom {
  long long rows;
  int K, Nout;
  long long x_cand_stride, mul_cand_stride, mask_cand_stride;
  int vec_a, vec_w, vec_out;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// the value the storage type holds (a no-op for float32)
template <class T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

template <class T, int KIND, bool MUL>
__global__ void __launch_bounds__(FB_THREADS, FB_MIN_BLOCKS)
gate_matmul_fma_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                       const T* __restrict__ mul, const T* __restrict__ w,
                       T* __restrict__ out, const MatmulGeom g) {
  extern __shared__ __align__(16) uint8_t fb_smem[];
  FmaSmem& sm = *reinterpret_cast<FmaSmem*>(fb_smem);

  const int tid = threadIdx.x;
  const long long cand = blockIdx.z;
  const long long m0 = (long long)blockIdx.x * FB_BM;
  const int n0 = blockIdx.y * FB_BN;
  const int KT = (g.K + FB_BK - 1) / FB_BK;
  const T* xc = x + cand * g.x_cand_stride;
  const T* uc = MUL ? mul + cand * g.mul_cand_stride : nullptr;
  const float* mk = mask + cand * g.mask_cand_stride;

  // 16-byte copies: this thread's rows of x and mul (ar and ar + 32 at k
  // offset ac) and of w (k rows wr + 4i at column offset wc), fixed for the
  // block; out-of-range rows and columns copy zeros
  constexpr int A_HALF = FB_BM / 2, W_STEP = FB_THREADS / 32;
  const int ar = tid >> 2, ac = 4 * (tid & 3);
  const bool a_ok0 = m0 + ar < g.rows, a_ok1 = m0 + ar + A_HALF < g.rows;
  const long long a_off0 = a_ok0 ? (m0 + ar) * g.K + ac : 0;
  const long long a_off1 = a_ok1 ? (m0 + ar + A_HALF) * g.K + ac : 0;
  const int wr = tid >> 5, wc = 4 * (tid & 31);
  const bool w_ok = n0 + wc < g.Nout;
  const T* wp = w + (w_ok ? (long long)wr * g.Nout + n0 + wc : 0);

  // copy stage kt of the raw tiles into its ring slot
  auto issue = [&](int kt) {
    if (kt >= KT) return;
    const int s = kt % FB_STAGES;
    const int k0 = kt * FB_BK;
    if (g.vec_a) {   // float32 only
      const bool kin = k0 + ac < g.K;
      const bool ok0 = a_ok0 && kin, ok1 = a_ok1 && kin;
      cp_async16(&sm.x[s][ar][ac], xc + (ok0 ? a_off0 + k0 : 0), ok0);
      cp_async16(&sm.x[s][ar + A_HALF][ac], xc + (ok1 ? a_off1 + k0 : 0),
                 ok1);
      if (MUL) {
        cp_async16(&sm.u[s][ar][ac], uc + (ok0 ? a_off0 + k0 : 0), ok0);
        cp_async16(&sm.u[s][ar + A_HALF][ac], uc + (ok1 ? a_off1 + k0 : 0),
                   ok1);
      }
      if (tid < FB_BK / 4) {
        const int c = 4 * tid;
        const bool ok = k0 + c < g.K;
        cp_async16(&sm.m[s][c], mk + (ok ? k0 + c : 0), ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < FB_BM * FB_BK / FB_THREADS; ++i) {
        const int idx = tid + FB_THREADS * i;
        const int r = idx / FB_BK, c = idx % FB_BK;
        const long long m = m0 + r;
        const bool ok = m < g.rows && k0 + c < g.K;
        sm.x[s][r][c] = ok ? to_f(xc[m * g.K + k0 + c]) : 0.0f;
        if (MUL) sm.u[s][r][c] = ok ? to_f(uc[m * g.K + k0 + c]) : 0.0f;
      }
      if (tid < FB_BK)
        sm.m[s][tid] = k0 + tid < g.K ? mk[k0 + tid] : 0.0f;
    }
    if (g.vec_w) {
#pragma unroll
      for (int i = 0; i < FB_BK / W_STEP; ++i) {
        const int r = wr + W_STEP * i;
        const bool ok = w_ok && k0 + r < g.K;
        cp_async16(&sm.w[s][r][wc],
                   ok ? wp + (long long)(k0 + W_STEP * i) * g.Nout : w, ok);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < FB_BK * FB_BN / FB_THREADS; ++i) {
        const int idx = tid + FB_THREADS * i;
        const int r = idx / FB_BN, c = idx % FB_BN;
        const bool ok = k0 + r < g.K && n0 + c < g.Nout;
        sm.w[s][r][c] =
            ok ? to_f(w[(long long)(k0 + r) * g.Nout + n0 + c]) : 0.0f;
      }
    }
  };

  // gate (and multiply) stage kt's raw x into A buffer `buf`, k-major:
  // thread = one row, k chunks gc and gc + 2 of 4 each; out-of-range
  // elements are x = 0 under mask 0, which every kind gates to 0
  const int gr = tid & (FB_BM - 1);
  const int gc = tid / FB_BM;
  auto gate_stage = [&](int kt, int buf) {
    const int s = kt % FB_STAGES;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 4 * (gc + 2 * h);
      const float4 x4 = *reinterpret_cast<const float4*>(&sm.x[s][gr][c]);
      const float4 m4 = *reinterpret_cast<const float4*>(&sm.m[s][c]);
      float v[4] = {x4.x, x4.y, x4.z, x4.w};
      const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
      gate_n<KIND, 4>(v, mv);
      float4 u4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (MUL) u4 = *reinterpret_cast<const float4*>(&sm.u[s][gr][c]);
      const float uv[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float g = round_to<T>(v[e]);
        if (MUL) g = round_to<T>(__fmul_rn(g, uv[e]));
        sm.a[buf][c + e][gr] = g;
      }
    }
  };

  // products: rows ty*4..+3 and 32+ty*4..+3, columns tx*4..+3 and
  // 64+tx*4..+3
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // stages 0 .. FB_STAGES-2 in flight; then stage 0 gated, stage 1 landed
#pragma unroll
  for (int st = 0; st < FB_STAGES - 1; ++st) {
    issue(st);
    cp_async_commit();
  }
  cp_async_wait<FB_STAGES - 2>();
  __syncthreads();
  gate_stage(0, 0);
  cp_async_wait<FB_STAGES - 3>();
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    // the slot of stage kt-1: its x was gated two steps ago and its w read
    // by the previous step's products, both before the last barrier
    issue(kt + FB_STAGES - 1);
    cp_async_commit();
    // the other A buffer was last read by the previous step's products
    if (kt + 1 < KT) gate_stage(kt + 1, (kt + 1) & 1);
    const float(*As)[FB_BM] = sm.a[kt & 1];
    const float(*Bs)[FB_BN] = sm.w[kt % FB_STAGES];
#pragma unroll
    for (int k = 0; k < FB_BK; ++k) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a_hi =
          *reinterpret_cast<const float4*>(&As[k][A_HALF + ty * 4]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b_hi =
          *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                          a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float b[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                          b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // stage kt+2 has landed (later ones may still be in flight)
    cp_async_wait<FB_STAGES - 3>();
    __syncthreads();
  }

  T* out_c = out + cand * g.rows * g.Nout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m =
        m0 + (i < 4 ? ty * 4 + i : A_HALF + ty * 4 + (i - 4));
    if (m >= g.rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n >= g.Nout) continue;
      T* op = out_c + m * g.Nout + n;
      if (g.vec_out) {
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
int launch_fma(const void* x, const void* mask, const void* mul,
               const void* w, void* out, int n_cand, MatmulGeom g,
               cudaStream_t stream) {
  const bool f32 = sizeof(T) == 4;
  // 16-byte copies of 4 k: K a multiple of 4 keeps each inside its row,
  // aligned, and wholly in or out of range; likewise 4 columns of w
  g.vec_a = f32 && g.K % 4 == 0 && g.x_cand_stride % 4 == 0 &&
            g.mul_cand_stride % 4 == 0 && g.mask_cand_stride % 4 == 0 &&
            aligned16(x) && (!MUL || aligned16(mul)) && aligned16(mask);
  g.vec_w = f32 && g.Nout % 4 == 0 && aligned16(w);
  g.vec_out = g.Nout % 4 == 0 && aligned_to(out, 4 * sizeof(T));
  auto kernel = gate_matmul_fma_kernel<T, KIND, MUL>;
  const int smem = (int)sizeof(FmaSmem);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((g.rows + FB_BM - 1) / FB_BM),
            (unsigned)((g.Nout + FB_BN - 1) / FB_BN), (unsigned)n_cand);
  kernel<<<grid, FB_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mask),
      static_cast<const T*>(mul), static_cast<const T*>(w),
      static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

template <class T, int KIND>
int launch_fma_mul(const void* x, const void* mask, const void* mul,
                   const void* w, void* out, int n_cand, const MatmulGeom& g,
                   cudaStream_t stream) {
  if (mul != nullptr)
    return launch_fma<T, KIND, true>(x, mask, mul, w, out, n_cand, g, stream);
  return launch_fma<T, KIND, false>(x, mask, mul, w, out, n_cand, g, stream);
}

template <class T>
int launch_fma_kind(int kind, const void* x, const void* mask,
                    const void* mul, const void* w, void* out, int n_cand,
                    const MatmulGeom& g, cudaStream_t stream) {
  switch (kind) {
    case kRelu:
      return launch_fma_mul<T, kRelu>(x, mask, mul, w, out, n_cand, g,
                                      stream);
    case kGelu:
      return launch_fma_mul<T, kGelu>(x, mask, mul, w, out, n_cand, g,
                                      stream);
    case kSilu:
      return launch_fma_mul<T, kSilu>(x, mask, mul, w, out, n_cand, g,
                                      stream);
    case kSqrelu:
      return launch_fma_mul<T, kSqrelu>(x, mask, mul, w, out, n_cand, g,
                                        stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// route A, in masked_act_matmul_sm90.cu
int masked_act_matmul_wgmma_launch(const void* x, const void* mask,
                                   const void* mul, const void* w, void* out,
                                   int n_cand, long long rows, int K,
                                   int Nout, long long x_cand_stride,
                                   long long mul_cand_stride,
                                   long long mask_cand_stride, int kind,
                                   cudaStream_t stream);

namespace {

// every y of [1, 2^126] (as bits, from lo): rcp_rn_fast(y) against 1.0f / y
__global__ void rcp_check_kernel(uint32_t lo, uint32_t count,
                                 unsigned long long* mismatches) {
  unsigned long long bad = 0;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += gridDim.x * blockDim.x) {
    const float y = __uint_as_float(lo + i);
    bad += __float_as_uint(rcp_rn_fast(y)) != __float_as_uint(__frcp_rn(y));
  }
  atomicAdd(mismatches, bad);
}

}  // namespace

// Counts the floats y of [1, 2^126] whose rcp_rn_fast(y), the silu gate's
// reciprocal, differs from the correctly rounded 1 / y; adds the count to
// *mismatches (a device pointer).
extern "C" int masked_act_rcp_check(void* mismatches, void* stream) {
  const uint32_t lo = 0x3F800000u, hi = 0x7E800000u;   // 1.0, 2^126
  rcp_check_kernel<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      lo, hi - lo + 1, static_cast<unsigned long long*>(mismatches));
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.  kind: 0 relu, 1 gelu, 2 silu, 3 sqrelu.
// route: 0 = B (float32 FMA, any shape), 1 = A (wgmma, bfloat16 with K and
// Nout multiples of 8 and 16-byte aligned operands).  Strides are in
// elements; the mask is float32; mul may be null.  A route that cannot take
// the call returns cudaErrorInvalidValue and launches nothing.

extern "C" int masked_act_matmul_launch(
    const void* x, const void* mask, const void* mul, const void* w,
    void* out, int n_cand, long long rows, int K, int Nout,
    long long x_cand_stride, long long mul_cand_stride,
    long long mask_cand_stride, int kind, int dtype, int route,
    void* stream) {
  if (n_cand <= 0 || rows <= 0 || Nout <= 0) return 0;
  if (K <= 0 || n_cand > 65535 || (Nout + FB_BN - 1) / FB_BN > 65535 ||
      (rows + FB_BM - 1) / FB_BM > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return masked_act_matmul_wgmma_launch(
        x, mask, mul, w, out, n_cand, rows, K, Nout, x_cand_stride,
        mul_cand_stride, mask_cand_stride, kind, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  MatmulGeom g{rows, K, Nout, x_cand_stride, mul_cand_stride,
               mask_cand_stride, 0, 0, 0};
  if (dtype == 0)
    return launch_fma_kind<float>(kind, x, mask, mul, w, out, n_cand, g, s);
  if (dtype == 1)
    return launch_fma_kind<__nv_bfloat16>(kind, x, mask, mul, w, out, n_cand,
                                          g, s);
  return (int)cudaErrorInvalidValue;
}
