// bf16 storage for the kernels that take it (B2 and B3 in 3D): a source
// that widens each load to f32 and a store that rounds each f32 result to
// bf16 (round to nearest even) once. Device-only: host tests of the walks
// pass their own source and store of the same shape.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "plane.cuh"

namespace hyteg {

// src[i] -> float, src + k: what the walks' Src parameter needs.
struct BF16Src {
  const __nv_bfloat16* p;
  __device__ __forceinline__ float operator[](int i) const {
    return __bfloat162float(p[i]);
  }
  __device__ __forceinline__ BF16Src operator+(long long k) const {
    return {p + k};
  }
};

// The store of plane.cuh's walks (CellStore's interface) on a bf16 block:
// single stores round one value; quad writes 4 slots as one 8-byte store,
// i at an 8-byte boundary, so store_run's zero runs stay store-only.
struct BF16CellStore {
  __nv_bfloat16* dst;
  __device__ __forceinline__ void operator()(int i, float v) const {
    dst[i] = __float2bfloat16_rn(v);
  }
  // slots from i to the next one at an 8-byte boundary (0 to 3)
  __device__ __forceinline__ int to_aligned(int i) const {
    const unsigned half = (unsigned)(reinterpret_cast<uintptr_t>(dst + i) >> 1);
    return (int)((0u - half) & 3u);
  }
  __device__ __forceinline__ void quad(int i, float a, float b, float c,
                                       float d) const {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
    uint2 v;
    v.x = *reinterpret_cast<const unsigned*>(&lo);
    v.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(dst + i) = v;
  }
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The source and store of a block of storage type T.
template <typename T> struct Storage;
template <> struct Storage<float> {
  static __device__ __forceinline__ const float* src(const float* p) {
    return p;
  }
  static __device__ __forceinline__ CellStore store(float* p) { return {p}; }
};
template <> struct Storage<__nv_bfloat16> {
  static __device__ __forceinline__ BF16Src src(const __nv_bfloat16* p) {
    return {p};
  }
  static __device__ __forceinline__ BF16CellStore store(__nv_bfloat16* p) {
    return {p};
  }
};

}  // namespace hyteg
