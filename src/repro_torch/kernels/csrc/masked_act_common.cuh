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

template <int KIND>
__device__ __forceinline__ float act(float x) {
  if (KIND == kRelu) return fmaxf(x, 0.0f);
  if (KIND == kGelu) {
    // tanh approximation, as the reference computes it
    const float c = 0.7978845608028654f;
    return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
  }
  if (KIND == kSilu) return x * (1.0f / (1.0f + expf(-x)));
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
