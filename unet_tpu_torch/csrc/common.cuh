// Shared helpers of the hand-written kernels: element conversions between
// the storage type (float or bf16) and the float the arithmetic runs in,
// and an aligned vector type for wide loads and stores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// Round a float to the storage type and back: the value a tensor of type T
// would hold.  The identity for float.
template <typename T> __device__ __forceinline__ float round_to(float v) {
    return to_float<T>(from_float<T>(v));
}

// V elements of T, aligned so that one load or store moves all of them.
template <typename T, int V> struct alignas(sizeof(T) * V) Vec {
    T v[V];
};
