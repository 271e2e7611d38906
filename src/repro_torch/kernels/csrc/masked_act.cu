// Masked-activation kernels for NVIDIA Hopper (sm_90a), plain C interface.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and loaded with ctypes.  Every entry point launches on the stream it is
// given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so that the Python wrapper can raise on a launch that
// was refused.
//
// Two kernels, four entry uses:
//
//  * gate_kernel            <- src/repro/kernels/masked_act.py
//                              masked_act_2d and masked_act_2d_batched
//    y = m*act(x) + (1-m)*lin,  lin = x  or  a*x^2 + b*x + c.
//    Bound by bytes on this card: one read of x, one write of y, the mask
//    read once per thread and kept in registers while the thread walks down
//    the rows.  16-byte loads and stores where the row length and the
//    pointers allow, a scalar path otherwise; no padding to block multiples.
//    The candidate stride of x may be 0: at the first gate after an
//    activation that all candidates share, the one copy is read N times and
//    the (N, ...) broadcast is never written to device memory.
//
//  * gate_conv3x3_kernel    <- src/repro/kernels/masked_act.py
//                              masked_act_conv3x3 and
//                              masked_act_conv3x3_batched
//    out = conv3x3_SAME(m*act(x) + (1-m)*x, w), stride 1 or 2.
//    Bound by operations (f32 FMA outside the tensor cores): an implicit
//    GEMM with M = B*Ho*Wo per candidate, K = 9*Cin, N = Cout.  A block owns
//    a 128 x BN output tile (BN = 128, or 64 for Cout <= 64) with
//    16 x BN/8 threads; per K step it stages a 128 x 16 slice of gated
//    input patches and a 16 x BN slice of w in shared memory, and each
//    thread accumulates an 8 x 8 micro-tile in registers.  The micro-tile
//    is 8 x 8 because shared-memory reads, not FMAs, were the limit of an
//    8 x 4 one: 16 values read per 64 FMAs instead of 12 per 32.  The gate
//    is applied to every input element on its way into shared memory, so
//    the gated tensor never reaches device memory; SAME edges are
//    predicated loads that yield 0.  Shared memory is double-buffered: the
//    next K step's global loads are issued before the current step's FMAs
//    and only gated and stored after them, so a step costs one barrier.
//    The launch bound keeps two 256-thread blocks (three 128-thread ones)
//    on an SM.  Candidate strides for x and the mask are arguments
//    (0 = shared), which is all that separates the stacked use from the
//    single one.  All nine taps are computed for every output; at 4 x 4
//    images 31 % of those products meet a zero from the padding.
//    This is route F ("fma") of the fused conv.  Route T ("tf32x3",
//    masked_act_conv_sm90.cu) takes every float32 call with B % 64 == 0,
//    Cin and Cout multiples of 8 and 16-byte aligned operands, on the
//    tensor cores; kernels/masked_act.py conv_route picks the route.
//
//  * gate_bwd_kernel         <- no TPU kernel: the gradient of the gate,
//    + poly_reduce_kernel        which the reference takes by autodiff of
//                                the plain gate (src/repro/core/linearize.py
//                                apply_masked_act), written for the port's
//                                training path (ops.MaskedActFn)
//    dx = (g*m)*act'(x) + (g*(1-m))*lin'(x),  lin' = 1 or 2a*x + b, and,
//    when poly is trained, dpoly = sum over rows of (g*(1-m))*(x^2, x, 1).
//    Derivatives at ties as JAX takes them (relu'(0) = 1/2; kernels/ref.py
//    states the conventions).  Bound by bytes like the forward gate: one
//    read of x and g, one write of dx, 16-byte accesses, the mask row in
//    registers.  The poly reduction is deterministic: a
//    thread sums its column's rows of one fixed stripe in order, the
//    stripes' partial sums go to scratch, and poly_reduce_kernel adds the
//    stripes in order; the stripe size is an argument, chosen from the row
//    count alone (kernels/masked_act.py bwd_stripes), so the order of every
//    sum is a function of the shape and nothing else — no atomics.
//    float32 or bfloat16 x, g and dx (8-byte accesses of four values in
//    bfloat16): float32 arithmetic, dx rounded once; the partial sums and
//    their reduction stay float32 and dpoly is rounded to poly's type once.
//
// Arithmetic is float32 whatever the storage type (float32 or bfloat16);
// results are rounded once, on the store.

#include "masked_act_common.cuh"

namespace {

// ------------------------------------------------------------------ gate

// grid.x * block.x covers the column vectors, grid.y * block.y strides over
// the rows, grid.z is the candidate.
template <class T, int KIND, bool POLY, int VEC>
__global__ void gate_kernel(const T* __restrict__ x,
                            const float* __restrict__ mask,
                            const float* __restrict__ poly,
                            T* __restrict__ out, long long rows,
                            long long cols, long long x_cand_stride) {
  const long long cvec =
      (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long col = cvec * VEC;
  if (col >= cols) return;
  const long long cand = blockIdx.z;
  const T* xc = x + cand * x_cand_stride + col;
  T* oc = out + cand * rows * cols + col;

  float m[VEC], pa[VEC], pb[VEC], pc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    m[j] = mask[cand * cols + col + j];
    if (POLY) {
      pa[j] = poly[col + j];
      pb[j] = poly[cols + col + j];
      pc[j] = poly[2 * cols + col + j];
    }
  }

  const long long row_step = (long long)gridDim.y * blockDim.y;
  for (long long r = (long long)blockIdx.y * blockDim.y + threadIdx.y;
       r < rows; r += row_step) {
    Pack<T, VEC> in = *reinterpret_cast<const Pack<T, VEC>*>(xc + r * cols);
    Pack<T, VEC> res;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float v = to_f(in.v[j]);
      float lin = v;
      if (POLY) {
        lin = __fadd_rn(
            __fadd_rn(__fmul_rn(__fmul_rn(pa[j], v), v), __fmul_rn(pb[j], v)),
            pc[j]);
      }
      res.v[j] = from_f<T>(blend(m[j], act<KIND>(v), lin));
    }
    *reinterpret_cast<Pack<T, VEC>*>(oc + r * cols) = res;
  }
}

template <class T, int KIND, bool POLY, int VEC>
void launch_gate(const void* x, const void* mask, const void* poly,
                 void* out, long long n_cand, long long rows, long long cols,
                 long long x_cand_stride, cudaStream_t stream) {
  const long long cvecs = cols / VEC;
  int bx = 1;
  while (bx < 256 && bx < cvecs) bx <<= 1;
  const int by = 256 / bx;
  const long long gx = (cvecs + bx - 1) / bx;
  // four rows a thread amortise the mask load and leave many blocks
  long long gy = (rows + (long long)by * 4 - 1) / ((long long)by * 4);
  if (gy < 1) gy = 1;
  if (gy > 65535) gy = 65535;
  dim3 block(bx, by, 1);
  dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)n_cand);
  gate_kernel<T, KIND, POLY, VEC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mask),
      static_cast<const float*>(poly), static_cast<T*>(out), rows, cols,
      x_cand_stride);
}

template <class T, int KIND, bool POLY>
void dispatch_gate_vec(const void* x, const void* mask, const void* poly,
                       void* out, long long n_cand, long long rows,
                       long long cols, long long x_cand_stride,
                       cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = cols % VEC == 0 && x_cand_stride % VEC == 0 &&
                   aligned16(x) && aligned16(out);
  if (vec)
    launch_gate<T, KIND, POLY, VEC>(x, mask, poly, out, n_cand, rows, cols,
                                    x_cand_stride, stream);
  else
    launch_gate<T, KIND, POLY, 1>(x, mask, poly, out, n_cand, rows, cols,
                                  x_cand_stride, stream);
}

template <class T, int KIND>
void dispatch_gate_poly(const void* x, const void* mask, const void* poly,
                        void* out, long long n_cand, long long rows,
                        long long cols, long long x_cand_stride,
                        cudaStream_t stream) {
  if (poly != nullptr)
    dispatch_gate_vec<T, KIND, true>(x, mask, poly, out, n_cand, rows, cols,
                                     x_cand_stride, stream);
  else
    dispatch_gate_vec<T, KIND, false>(x, mask, poly, out, n_cand, rows, cols,
                                      x_cand_stride, stream);
}

template <class T>
bool dispatch_gate_kind(int kind, const void* x, const void* mask,
                        const void* poly, void* out, long long n_cand,
                        long long rows, long long cols,
                        long long x_cand_stride, cudaStream_t stream) {
  switch (kind) {
    case kRelu:
      dispatch_gate_poly<T, kRelu>(x, mask, poly, out, n_cand, rows, cols,
                                   x_cand_stride, stream);
      return true;
    case kGelu:
      dispatch_gate_poly<T, kGelu>(x, mask, poly, out, n_cand, rows, cols,
                                   x_cand_stride, stream);
      return true;
    case kSilu:
      dispatch_gate_poly<T, kSilu>(x, mask, poly, out, n_cand, rows, cols,
                                   x_cand_stride, stream);
      return true;
    case kSqrelu:
      dispatch_gate_poly<T, kSqrelu>(x, mask, poly, out, n_cand, rows, cols,
                                     x_cand_stride, stream);
      return true;
  }
  return false;
}

// ------------------------------------------------------------- gate, bwd

// d act / dx as reference autodiff takes it (kernels/ref.py act_grad_ref);
// every product and sum rounded on its own
template <int KIND>
__device__ __forceinline__ float act_grad(float x) {
  if (KIND == kRelu) return x > 0.0f ? 1.0f : (x == 0.0f ? 0.5f : 0.0f);
  if (KIND == kGelu) {
    const float c = 0.7978845608028654f;
    const float x2 = __fmul_rn(x, x);
    const float t = tanhf(
        __fmul_rn(c, __fadd_rn(x, __fmul_rn(0.044715f, __fmul_rn(x2, x)))));
    const float left = __fmul_rn(0.5f, __fadd_rn(1.0f, t));
    // 0.134145 = 3 * 0.044715
    const float dz = __fmul_rn(c, __fadd_rn(1.0f, __fmul_rn(0.134145f, x2)));
    const float right = __fmul_rn(
        __fmul_rn(__fmul_rn(0.5f, x), __fsub_rn(1.0f, __fmul_rn(t, t))), dz);
    return __fadd_rn(left, right);
  }
  if (KIND == kSilu) {
    const float e = expf(-x);
    const float u = __fadd_rn(1.0f, e);
    return __fadd_rn(__fdiv_rn(1.0f, u),
                     __fmul_rn(x, __fdiv_rn(e, __fmul_rn(u, u))));
  }
  return x > 0.0f ? __fmul_rn(2.0f, x) : 0.0f;
}

// grid.x * block.x covers the column vectors, grid.y is the row stripe:
// rows [y * stripe, min((y + 1) * stripe, rows)), walked in order.  With
// DPOLY the thread's three running sums go to partial[y][0..2][cols], in
// float32 whatever T is.  x and g are read as T and widened, every
// operation is float32, and dx is rounded to T once, on the store.
template <class T, int KIND, bool POLY, bool DPOLY, int VEC>
__global__ void gate_bwd_kernel(const T* __restrict__ x,
                                const float* __restrict__ mask,
                                const float* __restrict__ poly,
                                const T* __restrict__ g,
                                T* __restrict__ dx,
                                float* __restrict__ partial, long long rows,
                                long long cols, long long stripe) {
  const long long col =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (col >= cols) return;
  float m[VEC], pa2[VEC], pb[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    m[j] = mask[col + j];
    if (POLY) {
      pa2[j] = __fmul_rn(2.0f, poly[col + j]);
      pb[j] = poly[cols + col + j];
    }
  }
  float sa[VEC], sb[VEC], sc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) sa[j] = sb[j] = sc[j] = 0.0f;

  const long long r0 = (long long)blockIdx.y * stripe;
  const long long r1 = r0 + stripe < rows ? r0 + stripe : rows;
  for (long long r = r0; r < r1; ++r) {
    const long long off = r * cols + col;
    const Pack<T, VEC> xv = *reinterpret_cast<const Pack<T, VEC>*>(x + off);
    const Pack<T, VEC> gv = *reinterpret_cast<const Pack<T, VEC>*>(g + off);
    Pack<T, VEC> res;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float v = to_f(xv.v[j]);
      const float gj = to_f(gv.v[j]);
      const float gm = __fmul_rn(gj, m[j]);
      const float g1m = __fmul_rn(gj, __fsub_rn(1.0f, m[j]));
      const float dlin =
          POLY ? __fmul_rn(g1m, __fadd_rn(__fmul_rn(pa2[j], v), pb[j])) : g1m;
      res.v[j] = from_f<T>(__fadd_rn(__fmul_rn(gm, act_grad<KIND>(v)), dlin));
      if (DPOLY) {
        const float gx = __fmul_rn(g1m, v);
        sa[j] = __fadd_rn(sa[j], __fmul_rn(gx, v));
        sb[j] = __fadd_rn(sb[j], gx);
        sc[j] = __fadd_rn(sc[j], g1m);
      }
    }
    *reinterpret_cast<Pack<T, VEC>*>(dx + off) = res;
  }
  if (DPOLY) {
    float* p = partial + (long long)blockIdx.y * 3 * cols + col;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      p[j] = sa[j];
      p[cols + j] = sb[j];
      p[2 * cols + j] = sc[j];
    }
  }
}

// dpoly[i] = sum over stripes s = 0, 1, ... of partial[s][i], in that order,
// in float32, rounded to P (poly's own type) once
template <class P>
__global__ void poly_reduce_kernel(const float* __restrict__ partial,
                                   P* __restrict__ dpoly, long long n,
                                   long long stripes) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (long long k = 0; k < stripes; ++k)
    s = __fadd_rn(s, partial[k * n + i]);
  dpoly[i] = from_f<P>(s);
}

template <class T, int KIND, bool POLY, bool DPOLY, int VEC>
void launch_gate_bwd(const void* x, const void* mask, const void* poly,
                     const void* g, void* dx, void* partial, long long rows,
                     long long cols, long long stripe, cudaStream_t stream) {
  const long long cvecs = cols / VEC;
  int bx = 32;
  while (bx < 256 && bx < cvecs) bx <<= 1;
  const long long gx = (cvecs + bx - 1) / bx;
  const long long gy = (rows + stripe - 1) / stripe;
  dim3 grid((unsigned)gx, (unsigned)gy, 1);
  gate_bwd_kernel<T, KIND, POLY, DPOLY, VEC><<<grid, bx, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mask),
      static_cast<const float*>(poly), static_cast<const T*>(g),
      static_cast<T*>(dx), static_cast<float*>(partial), rows, cols, stripe);
}

// four values a thread: 16-byte accesses in float32, 8-byte ones in
// bfloat16, where the row length and the pointers allow
template <class T, int KIND, bool POLY, bool DPOLY>
void dispatch_gate_bwd_vec(const void* x, const void* mask, const void* poly,
                           const void* g, void* dx, void* partial,
                           long long rows, long long cols, long long stripe,
                           cudaStream_t stream) {
  constexpr uintptr_t bytes = 4 * sizeof(T);
  const bool vec = cols % 4 == 0 && aligned_to(x, bytes) &&
                   aligned_to(g, bytes) && aligned_to(dx, bytes);
  if (vec)
    launch_gate_bwd<T, KIND, POLY, DPOLY, 4>(x, mask, poly, g, dx, partial,
                                             rows, cols, stripe, stream);
  else
    launch_gate_bwd<T, KIND, POLY, DPOLY, 1>(x, mask, poly, g, dx, partial,
                                             rows, cols, stripe, stream);
}

template <class T, int KIND>
void dispatch_gate_bwd_poly(const void* x, const void* mask, const void* poly,
                            const void* g, void* dx, void* partial,
                            long long rows, long long cols, long long stripe,
                            cudaStream_t stream) {
  if (poly == nullptr)
    dispatch_gate_bwd_vec<T, KIND, false, false>(x, mask, poly, g, dx,
                                                 partial, rows, cols, stripe,
                                                 stream);
  else if (partial == nullptr)
    dispatch_gate_bwd_vec<T, KIND, true, false>(x, mask, poly, g, dx,
                                                partial, rows, cols, stripe,
                                                stream);
  else
    dispatch_gate_bwd_vec<T, KIND, true, true>(x, mask, poly, g, dx, partial,
                                               rows, cols, stripe, stream);
}

template <class T>
bool dispatch_gate_bwd_kind(int kind, const void* x, const void* mask,
                            const void* poly, const void* g, void* dx,
                            void* partial, long long rows, long long cols,
                            long long stripe, cudaStream_t stream) {
  switch (kind) {
    case kRelu:
      dispatch_gate_bwd_poly<T, kRelu>(x, mask, poly, g, dx, partial, rows,
                                       cols, stripe, stream);
      return true;
    case kGelu:
      dispatch_gate_bwd_poly<T, kGelu>(x, mask, poly, g, dx, partial, rows,
                                       cols, stripe, stream);
      return true;
    case kSilu:
      dispatch_gate_bwd_poly<T, kSilu>(x, mask, poly, g, dx, partial, rows,
                                       cols, stripe, stream);
      return true;
    case kSqrelu:
      dispatch_gate_bwd_poly<T, kSqrelu>(x, mask, poly, g, dx, partial, rows,
                                         cols, stripe, stream);
      return true;
  }
  return false;
}

// ------------------------------------------------------- fused gate -> conv

constexpr int BM = 128;   // output positions per block
constexpr int BK = 16;    // input channels per K step (within one tap)

struct ConvGeom {
  int B, H, W, Cin, Cout, Ho, Wo, stride, pad_h, pad_w;
  long long x_cand_stride, mask_cand_stride;
};

// BN output channels per block (64 or 128); 16 x (BN / 8) threads, each
// accumulating 8 x 8 outputs.
template <class T, int KIND, int BN>
__global__ void __launch_bounds__(2 * BN, BN == 128 ? 2 : 3)
gate_conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                    const T* __restrict__ w, T* __restrict__ out,
                    const ConvGeom g, const int vec_a, const int vec_b) {
  constexpr int NT = 2 * BN;                      // threads per block
  constexpr int TXN = BN / 8;                     // threads across BN
  constexpr int A_GROUPS = BM * BK / (NT * 8);    // 8-channel loads a thread

  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int cand = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int M = g.B * g.Ho * g.Wo;
  const int nchunk = (g.Cin + BK - 1) / BK;
  const int KT = 9 * nchunk;

  // A loader: this thread gathers A_GROUPS groups of 8 consecutive channels
  // of one output position's patch per K step.
  const int a_row = tid & (BM - 1);
  const int a_k0 = (tid >> 7) * 8 * A_GROUPS;
  const int a_m = m0 + a_row;
  const bool a_valid = a_m < M;
  int a_b = 0, a_iy0 = 0, a_ix0 = 0;
  if (a_valid) {
    const int hw = g.Ho * g.Wo;
    a_b = a_m / hw;
    const int r = a_m - a_b * hw;
    const int oy = r / g.Wo;
    const int ox = r - oy * g.Wo;
    a_iy0 = oy * g.stride - g.pad_h;
    a_ix0 = ox * g.stride - g.pad_w;
  }
  const T* x_img = x + (long long)cand * g.x_cand_stride +
                   (long long)a_b * g.H * g.W * g.Cin;
  const float* m_img = mask + (long long)cand * g.mask_cand_stride;

  // B loader: 8 consecutive output channels of one input channel's row of w.
  const int b_k = tid / TXN;
  const int b_c = (tid % TXN) * 8;

  // Raw values of the next K step, as loaded: nothing is computed from them
  // until the current step's FMAs are done, so the loads stay in flight
  // behind the arithmetic.  Out-of-bounds elements are x = 0 under mask 0,
  // which every kind gates to 0.
  Pack<T, 8> rx[A_GROUPS];
  Pack<float, 4> rm[A_GROUPS][2];
  Pack<T, 4> rw[2];

  auto issue_loads = [&](int kt) {
    const int tap = kt / nchunk;
    const int cbase = (kt - tap * nchunk) * BK;
    const int ky = tap / 3;
    const int kx = tap - ky * 3;
    // ---- A: input patch and its mask
    const int iy = a_iy0 + ky;
    const int ix = a_ix0 + kx;
    const bool inb = a_valid && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
    const long long pix0 = ((long long)iy * g.W + ix) * g.Cin;
#pragma unroll
    for (int h = 0; h < A_GROUPS; ++h) {
      const int c0 = cbase + a_k0 + 8 * h;
#pragma unroll
      for (int j = 0; j < 8; ++j) rx[h].v[j] = from_f<T>(0.0f);
#pragma unroll
      for (int j = 0; j < 4; ++j) rm[h][0].v[j] = rm[h][1].v[j] = 0.0f;
      if (inb && c0 < g.Cin) {
        const T* xp = x_img + pix0 + c0;
        const float* mp = m_img + pix0 + c0;
        if (vec_a) {
          rx[h] = *reinterpret_cast<const Pack<T, 8>*>(xp);
          rm[h][0] = *reinterpret_cast<const Pack<float, 4>*>(mp);
          rm[h][1] = *reinterpret_cast<const Pack<float, 4>*>(mp + 4);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (c0 + j < g.Cin) {
              rx[h].v[j] = xp[j];
              rm[h][j >> 2].v[j & 3] = mp[j];
            }
        }
      }
    }
    // ---- B: weights, HWIO
    const int ci = cbase + b_k;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + b_c + 4 * h;
#pragma unroll
      for (int j = 0; j < 4; ++j) rw[h].v[j] = from_f<T>(0.0f);
      if (ci < g.Cin && n < g.Cout) {
        const T* wp = w + ((long long)tap * g.Cin + ci) * g.Cout + n;
        if (vec_b) {
          rw[h] = *reinterpret_cast<const Pack<T, 4>*>(wp);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < g.Cout) rw[h].v[j] = wp[j];
        }
      }
    }
  };

  // gate the raw values and put the tiles into shared-memory buffer `buf`
  auto commit_tiles = [&](int buf) {
#pragma unroll
    for (int h = 0; h < A_GROUPS; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        As[buf][a_k0 + 8 * h + j][a_row] =
            gate<KIND>(to_f(rx[h].v[j]), rm[h][j >> 2].v[j & 3]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(&Bs[buf][b_k][b_c + 4 * h]) =
          make_float4(to_f(rw[h].v[0]), to_f(rw[h].v[1]), to_f(rw[h].v[2]),
                      to_f(rw[h].v[3]));
  };

  // compute mapping: rows ty*4..+3 and 64+ty*4..+3, columns tx*4..+3 and
  // BN/2+tx*4..+3
  const int tx = tid % TXN;
  const int ty = tid / TXN;
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
    for (int k = 0; k < BK; ++k) {
      const float4 a_lo =
          *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a_hi =
          *reinterpret_cast<const float4*>(&As[cur][k][64 + ty * 4]);
      const float4 b_lo =
          *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b_hi =
          *reinterpret_cast<const float4*>(&Bs[cur][k][BN / 2 + tx * 4]);
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

  T* out_c = out + (long long)cand * M * g.Cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * (BN / 2) + tx * 4;
      if (n >= g.Cout) continue;
      T* op = out_c + (long long)m * g.Cout + n;
      if (vec_b) {
        Pack<T, 4> res;
#pragma unroll
        for (int j = 0; j < 4; ++j) res.v[j] = from_f<T>(acc[i][4 * h + j]);
        *reinterpret_cast<Pack<T, 4>*>(op) = res;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < g.Cout) op[j] = from_f<T>(acc[i][4 * h + j]);
      }
    }
  }
}

template <class T, int KIND>
void launch_conv(const void* x, const void* mask, const void* w, void* out,
                 int n_cand, const ConvGeom& g, cudaStream_t stream) {
  const int M = g.B * g.Ho * g.Wo;
  // 8 channels of x in one load: Cin a multiple of 8 keeps every such load
  // inside the tensor and aligned; 4 output channels likewise for w and out
  const int vec_a = g.Cin % 8 == 0 && g.x_cand_stride % 8 == 0 &&
                    g.mask_cand_stride % 4 == 0 &&
                    aligned_to(x, 8 * sizeof(T)) && aligned16(mask);
  const int vec_b = g.Cout % 4 == 0 && aligned16(w) && aligned16(out);
  const T* xp = static_cast<const T*>(x);
  const float* mp = static_cast<const float*>(mask);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (g.Cout > 64) {
    dim3 grid((M + BM - 1) / BM, (g.Cout + 127) / 128, n_cand);
    gate_conv3x3_kernel<T, KIND, 128><<<grid, 256, 0, stream>>>(
        xp, mp, wp, op, g, vec_a, vec_b);
  } else {
    dim3 grid((M + BM - 1) / BM, 1, n_cand);
    gate_conv3x3_kernel<T, KIND, 64><<<grid, 128, 0, stream>>>(
        xp, mp, wp, op, g, vec_a, vec_b);
  }
}

template <class T>
bool dispatch_conv_kind(int kind, const void* x, const void* mask,
                        const void* w, void* out, int n_cand,
                        const ConvGeom& g, cudaStream_t stream) {
  switch (kind) {
    case kRelu:
      launch_conv<T, kRelu>(x, mask, w, out, n_cand, g, stream);
      return true;
    case kGelu:
      launch_conv<T, kGelu>(x, mask, w, out, n_cand, g, stream);
      return true;
    case kSilu:
      launch_conv<T, kSilu>(x, mask, w, out, n_cand, g, stream);
      return true;
    case kSqrelu:
      launch_conv<T, kSqrelu>(x, mask, w, out, n_cand, g, stream);
      return true;
  }
  return false;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  kind: 0 relu, 1 gelu, 2 silu, 3 sqrelu.
// Strides are in elements.  mask and poly are float32.

extern "C" int masked_act_gate_launch(const void* x, const void* mask,
                                      const void* poly, void* out,
                                      long long n_cand, long long rows,
                                      long long cols,
                                      long long x_cand_stride, int kind,
                                      int dtype, void* stream) {
  if (n_cand <= 0 || rows <= 0 || cols <= 0) return 0;
  if (n_cand > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0)
    ok = dispatch_gate_kind<float>(kind, x, mask, poly, out, n_cand, rows,
                                   cols, x_cand_stride, s);
  else if (dtype == 1)
    ok = dispatch_gate_kind<__nv_bfloat16>(kind, x, mask, poly, out, n_cand,
                                           rows, cols, x_cand_stride, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The gate's gradient.  dtype (of x, g and dx): 0 = float32, 1 =
// bfloat16; dpoly_dtype (poly's own type, of dpoly): the same codes.
// mask and poly are float32.  poly may be null (identity replacement).
// partial and dpoly are both null (no dpoly) or both set: partial holds
// ceil(rows / stripe) * 3 * cols floats of scratch, dpoly 3 * cols values.
// Every stripe-size choice gives a deterministic result; the caller keeps
// it a function of the shape.
extern "C" int masked_act_gate_bwd_launch(const void* x, const void* mask,
                                          const void* poly, const void* g,
                                          void* dx, void* partial,
                                          void* dpoly, long long rows,
                                          long long cols, long long stripe,
                                          int kind, int dtype,
                                          int dpoly_dtype, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (stripe <= 0 || (rows + stripe - 1) / stripe > 65535 ||
      (partial == nullptr) != (dpoly == nullptr) ||
      (partial != nullptr && poly == nullptr) ||
      (dpoly_dtype != 0 && dpoly_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0)
    ok = dispatch_gate_bwd_kind<float>(kind, x, mask, poly, g, dx, partial,
                                       rows, cols, stripe, s);
  else if (dtype == 1)
    ok = dispatch_gate_bwd_kind<__nv_bfloat16>(kind, x, mask, poly, g, dx,
                                               partial, rows, cols, stripe,
                                               s);
  if (!ok) return (int)cudaErrorInvalidValue;
  if (dpoly != nullptr) {
    const long long n = 3 * cols;
    const long long stripes = (rows + stripe - 1) / stripe;
    const unsigned blocks = (unsigned)((n + 255) / 256);
    const float* part = static_cast<const float*>(partial);
    if (dpoly_dtype == 0)
      poly_reduce_kernel<float><<<blocks, 256, 0, s>>>(
          part, static_cast<float*>(dpoly), n, stripes);
    else
      poly_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
          part, static_cast<__nv_bfloat16*>(dpoly), n, stripes);
  }
  return (int)cudaGetLastError();
}

// route T, in masked_act_conv_sm90.cu
int masked_act_conv3x3_tf32x3_launch(
    const void* x, const void* mask, const void* w, void* scratch, void* out,
    int n_cand, int B, int H, int W, int Cin, int Cout, int Ho, int Wo,
    int stride, int pad_h, int pad_w, long long x_cand_stride,
    long long mask_cand_stride, int kind, cudaStream_t stream);

// route: 0 = F (float32 FMA, any shape, float32 or bfloat16), 1 = T (the
// tensor cores, float32 only; scratch holds 2 * Cout * 9 * Cin floats).  A
// route that cannot take the call is refused, never replaced.
extern "C" int masked_act_conv3x3_launch(
    const void* x, const void* mask, const void* w, void* scratch, void* out,
    int n_cand, int B, int H, int W, int Cin, int Cout, int Ho, int Wo,
    int stride, int pad_h, int pad_w, long long x_cand_stride,
    long long mask_cand_stride, int kind, int dtype, int route,
    void* stream) {
  if (n_cand <= 0 || B <= 0 || Ho <= 0 || Wo <= 0 || Cout <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 0) return (int)cudaErrorInvalidValue;
    return masked_act_conv3x3_tf32x3_launch(
        x, mask, w, scratch, out, n_cand, B, H, W, Cin, Cout, Ho, Wo, stride,
        pad_h, pad_w, x_cand_stride, mask_cand_stride, kind, s);
  }
  if (route != 0 || n_cand > 65535 || (Cout + 63) / 64 > 65535 ||
      (long long)B * Ho * Wo > 2147483647LL - BM)
    return (int)cudaErrorInvalidValue;
  ConvGeom g{B, H, W, Cin, Cout, Ho, Wo, stride, pad_h, pad_w,
             x_cand_stride, mask_cand_stride};
  bool ok = false;
  if (dtype == 0)
    ok = dispatch_conv_kind<float>(kind, x, mask, w, out, n_cand, g, s);
  else if (dtype == 1)
    ok = dispatch_conv_kind<__nv_bfloat16>(kind, x, mask, w, out, n_cand, g,
                                           s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* masked_act_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
