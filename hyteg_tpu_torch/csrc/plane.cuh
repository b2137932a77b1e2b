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
#ifndef HYTEG_QUAD_HOOK  // a host harness checks each 16-byte access here
#define HYTEG_QUAD_HOOK(p)
#endif

namespace hyteg {

constexpr int kPlaneWarps = 8;  // warps of a plane's thread block

// floats from p to the next 16-byte boundary (0 to 3)
HYTEG_DEVICE int floats_to_aligned(const float* p) {
  const unsigned word = (unsigned)(reinterpret_cast<uintptr_t>(p) >> 2);
  return (int)((0u - word) & 3u);
}

struct CellStore {
  float* dst;  // the cell's block; i < 2^31 is a slot's offset in it
  HYTEG_DEVICE void operator()(int i, float v) const { dst[i] = v; }
  // slots from i to the next one at a 16-byte boundary (0 to 3)
  HYTEG_DEVICE int to_aligned(int i) const { return floats_to_aligned(dst + i); }
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
    HYTEG_QUAD_HOOK(dst + i);
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

// Loads of a copy run that a thread issues before its stores.
constexpr int kCopyQuads = 4;

struct Quad {
  float a, b, c, d;
};

// The 4 floats at p, a 16-byte boundary.
HYTEG_DEVICE Quad load_quad(const float* p) {
  HYTEG_QUAD_HOOK(p);
#ifdef __CUDACC__
  const float4 v = *reinterpret_cast<const float4*>(p);
  return {v.x, v.y, v.z, v.w};
#else
  return {p[0], p[1], p[2], p[3]};
#endif
}

// src[k] into slot i0 + k for the slots [i0, i1) of a cell, shared by
// nlanes >= 4 threads (this one is lane). Where src and slot i0 lie alike
// against 16-byte boundaries: 16-byte loads and stores (Out::quad) from
// the first slot at a boundary on, each thread's kCopyQuads loads issued
// before its stores, so that they are in flight together, and single
// ones for the fewer than 4 slots before and after; else single loads
// and stores.
template <class Out>
HYTEG_DEVICE void copy_run(const float* src, const Out& out, int i0, int i1,
                           int lane, int nlanes) {
  const int len = i1 - i0;
  if (len <= 0) return;
  const int head = out.to_aligned(i0);
  if (head != floats_to_aligned(src)) {
    for (int k = lane; k < len; k += nlanes) out(i0 + k, src[k]);
    return;
  }
  const int a = head < len ? head : len;
  const int nq = (len - a) >> 2;
  const int b = a + 4 * nq;
  if (lane < a) out(i0 + lane, src[lane]);
  if (lane < len - b) out(i0 + b + lane, src[b + lane]);
  for (int q0 = lane; q0 < nq; q0 += kCopyQuads * nlanes) {
    Quad v[kCopyQuads] = {};
#pragma unroll
    for (int k = 0; k < kCopyQuads; ++k)
      if (q0 + k * nlanes < nq) v[k] = load_quad(src + a + 4 * (q0 + k * nlanes));
#pragma unroll
    for (int k = 0; k < kCopyQuads; ++k)
      if (q0 + k * nlanes < nq)
        out.quad(i0 + a + 4 * (q0 + k * nlanes), v[k].a, v[k].b, v[k].c,
                 v[k].d);
  }
}

// Zeros into the slots [i0, i1) of a cell: a store-only run (store_run).
template <class Out>
HYTEG_DEVICE void zero_run(const Out& out, int i0, int i1, int lane,
                           int nlanes) {
  store_run(out, i0, i1, [](int) { return 0.f; }, lane, nlanes);
}

}  // namespace hyteg
