// Storage types of the port's kernels: fp32 or bf16 in memory, fp32 in
// registers. Shared by the GRU-sequence, GRU-backward and chunk-decoder
// sources, each of which is instantiated for both types (the bf16 ones
// serve the JAX package's compute_dtype: bfloat16). Conversions go
// through the intrinsics, so every rounding (round to nearest even) is
// explicit in the source.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

// A host-side cache slot for the device this thread launches on. A
// kernel's attributes (cudaFuncSetAttribute) and its occupancy hold for one
// device, so what a source caches after setting them it caches per device:
// a process may launch on several cards (a mesh's threads, one a card).
// -1 past kMaxDevices: the caller then sets them at every launch.
constexpr int kMaxDevices = 16;
inline int device_slot() {
  int d = -1;
  return cudaGetDevice(&d) == cudaSuccess && d >= 0 && d < kMaxDevices ? d
                                                                       : -1;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename Elt>
__device__ __forceinline__ Elt from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// the value x has once stored as an Elt
template <typename Elt>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<Elt>(x));
}
// four consecutive values as floats (16-byte aligned for fp32, 8 for bf16)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]), b = __bfloat1622float2(q[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
template <typename Elt>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<Elt, float>::value;
}
