// The streamed-operand types of the port's kernels: X (and A-optimality's
// shared solve W) arrive in f32 or bf16 storage and are upcast to f32
// right after the load; every accumulation is f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The zero of a storage type: the fill of a masked (out-of-range) load.
template <typename T>
__device__ __forceinline__ T stream_zero();
template <>
__device__ __forceinline__ float stream_zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 stream_zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

}  // namespace repro_torch
