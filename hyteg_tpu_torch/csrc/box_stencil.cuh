// Per-point arithmetic of the box 15-point stencil apply (kernel B1).
//
// Kept apart from the kernel in box_stencil.cu so that the math is a set
// of plain functions of (weights, point): the kernel only maps threads to
// points and picks the storage type. Layout and weights follow
// hyteg_tpu_torch/kernels/box_stencil.py:
//   u block: (X, L), L = Y * Z, lane = y * Z + z;
//   w (3, 15, L) f32: row class c (0 interior rows, 1 row 0, 2 row X-1),
//   direction s, lane.
#pragma once

#ifndef HYTEG_DEVICE
#define HYTEG_DEVICE __device__ __forceinline__
#endif

namespace hyteg {

constexpr int kBoxDirs = 15;  // the monotone cube diagonals, incl. 0

// Direction s in the order of structured/kuhn.py::stencil_dirs (sorted):
// s = 7 is 0; s > 7 has the bits of k = s - 7 as (dx, dy, dz) =
// (bit 2, bit 1, bit 0); s < 7 is the negation of direction 14 - s.
HYTEG_DEVICE int box_dir(int s, int axis) {
  const int k = s >= 7 ? s - 7 : 7 - s;
  const int bit = (k >> (2 - axis)) & 1;
  return s >= 7 ? bit : -bit;
}

// Row class of row x: 1 for row 0, 2 for row X-1, else 0.
HYTEG_DEVICE int box_row_class(int x, int X) {
  return x == 0 ? 1 : (x == X - 1 ? 2 : 0);
}

// y[x, lane] = sum_s w[s] * u[x + dx_s, lane + dy_s * Z + dz_s], with f32
// weights and an f32 accumulator. Reads are bounds-checked on the row and
// on the flat lane axis and read 0 outside: no read leaves the block.
// load(i) returns element i of the flat block as f32 (upcast on load).
template <class Load>
HYTEG_DEVICE float box_point(const Load& load, const float (&w)[kBoxDirs],
                             int x, int lane, int X, int L, int Z) {
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < kBoxDirs; ++s) {
    const int xs = x + box_dir(s, 0);
    const int ls = lane + box_dir(s, 1) * Z + box_dir(s, 2);
    float v = 0.f;
    if (xs >= 0 && xs < X && ls >= 0 && ls < L)
      v = load((long long)xs * L + ls);
    acc = fmaf(w[s], v, acc);
  }
  return acc;
}

// The 15 weights of row class c at one lane.
template <class LoadW>
HYTEG_DEVICE void box_load_weights(const LoadW& load_w, float (&w)[kBoxDirs],
                                   int c, int lane, int L) {
#pragma unroll
  for (int s = 0; s < kBoxDirs; ++s)
    w[s] = load_w((long long)(c * kBoxDirs + s) * L + lane);
}

}  // namespace hyteg
