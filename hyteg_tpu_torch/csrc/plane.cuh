// What the 3D kernels B2 and B5 share: one thread block of kPlaneWarps
// warps per plane x of a cell (const_apply_plane, p2_const_apply_plane),
// writing the cell's block through a store. On the card the store is
// CellStore; a host harness passes its own, to count each slot's writes.
#pragma once

#include <stdint.h>

#ifndef HYTEG_DEVICE
#define HYTEG_DEVICE __device__ __forceinline__
#endif

namespace hyteg {

constexpr int kPlaneWarps = 8;  // warps of a plane's thread block

struct CellStore {
  float* dst;  // the cell's block; i < 2^31 is a slot's offset in it
  HYTEG_DEVICE void operator()(int i, float v) const { dst[i] = v; }
  // slots from i to the next one at a 16-byte boundary (0 to 3)
  HYTEG_DEVICE int to_aligned(int i) const {
    const unsigned word = (unsigned)(reinterpret_cast<uintptr_t>(dst + i) >> 2);
    return (int)((0u - word) & 3u);
  }
  // a and b into slots i and i + 1, i at an 8-byte boundary
  HYTEG_DEVICE void pair(int i, float a, float b) const {
#ifdef __CUDACC__
    *reinterpret_cast<float2*>(dst + i) = make_float2(a, b);
#else
    dst[i] = a;
    dst[i + 1] = b;
#endif
  }
  // zeros into slots i .. i + 3, i at a 16-byte boundary
  HYTEG_DEVICE void zero4(int i) const {
#ifdef __CUDACC__
    *reinterpret_cast<float4*>(dst + i) = make_float4(0.f, 0.f, 0.f, 0.f);
#else
    dst[i] = dst[i + 1] = dst[i + 2] = dst[i + 3] = 0.f;
#endif
  }
};

// Zeros into the slots [i0, i1) of a cell, shared by nlanes >= 4 threads
// (this one is lane): 16-byte stores from the first slot at a 16-byte
// boundary on, single stores for the fewer than 4 slots before it and
// after the last whole quad. A store-only pass: full 32-byte sectors
// wherever the run covers them.
template <class Out>
HYTEG_DEVICE void zero_run(const Out& out, int i0, int i1, int lane,
                           int nlanes) {
  if (i1 <= i0) return;
  int a = i0 + out.to_aligned(i0);
  if (a > i1) a = i1;
  const int nq = (i1 - a) >> 2;
  const int b = a + 4 * nq;
  if (lane < a - i0) out(i0 + lane, 0.f);
  if (lane < i1 - b) out(b + lane, 0.f);
  for (int q = lane; q < nq; q += nlanes) out.zero4(a + 4 * q);
}

}  // namespace hyteg
