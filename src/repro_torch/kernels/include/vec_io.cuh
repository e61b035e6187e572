// Helpers shared by the port's CUDA sources: conversion between the storage
// types (fp32, bf16) and fp32, and vector loads and stores of VEC elements
// as one access of VEC * sizeof(T) bytes (the caller keeps the pointer
// aligned to that width).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <string.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// An unsigned type of each access width, for one vector load through the
// read-only cache.
template <int BYTES> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[VEC]) {
  using R = typename Raw<VEC * sizeof(T)>::type;
  R raw = __ldg(reinterpret_cast<const R*>(p));
  T v[VEC];
  memcpy(v, &raw, sizeof(R));
#pragma unroll
  for (int i = 0; i < VEC; ++i) x[i] = to_f32(v[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&x)[VEC]) {
  using R = typename Raw<VEC * sizeof(T)>::type;
  T v[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = from_f32<T>(x[i]);
  R raw;
  memcpy(&raw, v, sizeof(R));
  *reinterpret_cast<R*>(p) = raw;
}

}  // namespace
