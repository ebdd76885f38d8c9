// Device helpers shared by the port's kernels: storage-type loads and
// stores with f32 arithmetic, the align-corners lerp and the ELU.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace umt {

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// a + w * (b - a), each operation rounded on its own (no FMA contraction),
// as the plain PyTorch upsample computes it
__device__ __forceinline__ float lerp(float a, float b, float w) {
  return __fadd_rn(a, __fmul_rn(w, __fsub_rn(b, a)));
}

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : expm1f(v);
}

}  // namespace umt
