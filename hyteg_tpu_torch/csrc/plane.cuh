// What the walks of the kernels share: one thread block of kPlaneWarps
// warps per plane x of a cell (const_apply_plane, p2_const_apply_plane,
// pair_apply_plane, ...) or per band of rows of a face, writing the block
// through a store. On the card the store is CellStore; a host harness
// passes its own, to count each slot's writes.
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
  // a, b, c, d into slots i .. i + 3, i at a 16-byte boundary
  HYTEG_DEVICE void quad(int i, float a, float b, float c, float d) const {
#ifdef __CUDACC__
    *reinterpret_cast<float4*>(dst + i) = make_float4(a, b, c, d);
#else
    dst[i] = a;
    dst[i + 1] = b;
    dst[i + 2] = c;
    dst[i + 3] = d;
#endif
  }
};

// val(k) into the slots i0 + k of [i0, i1), shared by nlanes >= 4
// threads (this one is lane): 16-byte stores (Out::quad) from the first
// slot at a 16-byte boundary on, single stores for the fewer than 4 slots
// before it and after the last whole quad. No loads: full 32-byte sectors
// wherever the run covers them.
template <class Out, class Val>
HYTEG_DEVICE void store_run(const Out& out, int i0, int i1, const Val& val,
                            int lane, int nlanes) {
  if (i1 <= i0) return;
  int a = i0 + out.to_aligned(i0);
  if (a > i1) a = i1;
  const int nq = (i1 - a) >> 2;
  const int b = a + 4 * nq;
  if (lane < a - i0) out(i0 + lane, val(lane));
  if (lane < i1 - b) out(b + lane, val(b - i0 + lane));
  for (int q = lane; q < nq; q += nlanes) {
    const int k = a - i0 + 4 * q;
    out.quad(a + 4 * q, val(k), val(k + 1), val(k + 2), val(k + 3));
  }
}

// Zeros into the slots [i0, i1) of a cell: a store-only run (store_run).
template <class Out>
HYTEG_DEVICE void zero_run(const Out& out, int i0, int i1, int lane,
                           int nlanes) {
  store_run(out, i0, i1, [](int) { return 0.f; }, lane, nlanes);
}

}  // namespace hyteg
