// Device helpers shared by the masked-activation kernels (masked_act.cu,
// masked_act_matmul.cu): the four activation kinds, the gate blend, and
// the float32 <-> storage-type conversions.  Everything is in an anonymous
// namespace, so each translation unit gets its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind { kRelu = 0, kGelu = 1, kSilu = 2, kSqrelu = 3 };

// 1/y correctly rounded for 1 <= y <= 2^126: the hardware's approximate
// reciprocal and one FMA refinement, with no branch (a division's slow
// path is a branch per element, which keeps the compiler from
// interleaving the elements).  masked_act_rcp_check (masked_act_matmul.cu)
// holds it to 1.0f / y for every float in that range; chip_smoke.py runs it.
__device__ __forceinline__ float rcp_rn_fast(float y) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  return __fmaf_rn(r, __fmaf_rn(-y, r, 1.0f), r);
}
constexpr float kRcpFastMax = 0x1p126f;

// 1/y for y >= 1 (or not a number), without a call: above 2^126 the
// quotient is below the normal range and is taken as rcp(y/4)/4, which may
// differ from 1/y in its last (subnormal) bit; 1/inf = 0.
__device__ __forceinline__ float rcp_ge1(float y) {
  const bool fast = y <= kRcpFastMax;
  const float r = rcp_rn_fast(fast ? y : 0.25f * y);
  return fast ? r : (isinf(y) ? 0.0f : 0.25f * r);
}

template <int KIND>
__device__ __forceinline__ float act(float x) {
  if (KIND == kRelu) return fmaxf(x, 0.0f);
  if (KIND == kGelu) {
    // tanh approximation, as the reference computes it
    const float c = 0.7978845608028654f;
    return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
  }
  if (KIND == kSilu) {
    // x * (1 / (1 + exp(-x))), each step rounded on its own
    const float y = __fadd_rn(1.0f, expf(-x));
    return __fmul_rn(x, rcp_ge1(y));
  }
  const float r = fmaxf(x, 0.0f);
  return r * r;
}

// m*y + (1-m)*lin with every product and sum rounded on its own (no FMA
// contraction), so float32 results equal the plain three-pass version's.
__device__ __forceinline__ float blend(float m, float y, float lin) {
  return __fadd_rn(__fmul_rn(m, y), __fmul_rn(__fsub_rn(1.0f, m), lin));
}

template <int KIND>
__device__ __forceinline__ float gate(float x, float m) {
  return blend(m, act<KIND>(x), x);
}

// gate<KIND> of N values at once, bit for bit: silu's reciprocal takes the
// short path for all N, and the rare value out of its range (x below about
// -87, or not a number) sends the N through rcp_ge1
template <int KIND, int N>
__device__ __forceinline__ void gate_n(float (&v)[N], const float (&m)[N]) {
  if (KIND == kSilu) {
    float a[N];
    bool rare = false;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float y = __fadd_rn(1.0f, expf(-v[i]));
      rare |= !(y <= kRcpFastMax);
      a[i] = __fmul_rn(v[i], rcp_rn_fast(y));
    }
    if (rare) {
#pragma unroll
      for (int i = 0; i < N; ++i) a[i] = act<kSilu>(v[i]);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = blend(m[i], a[i], v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = gate<KIND>(v[i], m[i]);
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <class T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

inline bool aligned_to(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}
inline bool aligned16(const void* p) { return aligned_to(p, 16); }

}  // namespace
