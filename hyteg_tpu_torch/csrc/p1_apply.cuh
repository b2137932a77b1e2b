// Per-point arithmetic of the general elementwise P1 apply (kernel B4),
// kept apart from the kernel in p1_apply.cu like p1_diag.cuh. Layout
// follows hyteg_tpu_torch/kernels/p1_stencil.py:
//   elmats of one cell: (6, 4, 4) f32, one matrix per micro-tet
//   congruence class t; src, coeff and dst blocks: (N, L), L = N * pitch.
#pragma once

#ifndef HYTEG_DEVICE
#define HYTEG_DEVICE __device__ __forceinline__
#endif

namespace hyteg {

constexpr int kApplyClasses = 6;  // micro-tet congruence classes
constexpr int kApplyVerts = 4;    // vertices per micro-tet

// micro.TET_OFFSETS[c][a][d] and micro.TET_BASE_MARGIN[c]. Kept here as
// code so that, with every loop unrolled, each offset is a compile-time
// constant and the neighbour values below stay in registers.
HYTEG_DEVICE int tet_off(int c, int a, int d) {
  const int off[kApplyClasses][kApplyVerts][3] = {
      {{0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {0, 0, 1}},   // up
      {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}, {1, 0, 1}},   // octahedral A
      {{1, 0, 0}, {0, 1, 0}, {1, 1, 0}, {1, 0, 1}},   // octahedral B
      {{0, 1, 0}, {0, 0, 1}, {1, 0, 1}, {0, 1, 1}},   // octahedral C
      {{0, 1, 0}, {1, 1, 0}, {1, 0, 1}, {0, 1, 1}},   // octahedral D
      {{1, 1, 0}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1}}};  // down
  return off[c][a][d];
}

HYTEG_DEVICE int tet_margin(int c) {
  const int margin[kApplyClasses] = {1, 2, 2, 2, 2, 3};
  return margin[c];
}

// Index of a difference vector d in {-1, 0, 1}^3 into a 27-entry cube.
HYTEG_DEVICE int cube27(int dx, int dy, int dz) {
  return (dx + 1) * 9 + (dy + 1) * 3 + (dz + 1);
}

// Per-vertex term of the coefficient mean (operators/averaging.py): mode
// 0 arithmetic (the value), 1 harmonic (its inverse), 2 geometric (its
// log); values clamped at 1e-30 as the JAX package does.
HYTEG_DEVICE float coeff_term(float r, int mode) {
  if (mode == 0) return r;
  const float c = r > 1e-30f ? r : 1e-30f;
  return mode == 1 ? 1.f / c : logf(c);
}

// The mean from the sum s of nv per-vertex terms (nv = 3 for a triangle).
HYTEG_DEVICE float coeff_finish(float s, int mode, int nv = kApplyVerts) {
  if (mode == 0) return s / nv;
  if (mode == 1) return nv / s;
  return expf(s / nv);
}

// dst[x, lane] of one cell, in gather form: for every class c and vertex
// a whose element base q = p - off[c][a] is valid (all q_i >= 0 and
// S(q) <= n - margin[c]), add mean_c(coeff) * sum_b elm[c,a,b] *
// src[q + off[c][b]]. q + off[c][b] = p + (off[c][b] - off[c][a]) lies in
// the 15-point neighbourhood of p, so the 15 src values (and coefficient
// terms) are read once. Reads beyond the block are 0, as in
// flat.shift_read; a valid base never reads there. 0 outside the tet and
// on padding lanes. coeff may be null.
HYTEG_DEVICE float p1_apply_point(const float* src, const float* coeff,
                                  int x, int lane, int N, int pitch,
                                  const float* elm, int mode) {
  const int n = N - 1;
  const int L = N * pitch;
  const int y = lane / pitch;
  const int z = lane - y * pitch;
  if (z >= N || x + y + z > n) return 0.f;
  bool used[27] = {};
#pragma unroll
  for (int c = 0; c < kApplyClasses; ++c)
#pragma unroll
    for (int a = 0; a < kApplyVerts; ++a)
#pragma unroll
      for (int b = 0; b < kApplyVerts; ++b)
        used[cube27(tet_off(c, b, 0) - tet_off(c, a, 0),
                    tet_off(c, b, 1) - tet_off(c, a, 1),
                    tet_off(c, b, 2) - tet_off(c, a, 2))] = true;
  float u[27], k[27];
#pragma unroll
  for (int i = 0; i < 27; ++i) {
    u[i] = 0.f;
    k[i] = 0.f;
    if (!used[i]) continue;
    const int xx = x + i / 9 - 1;
    const int ll = lane + ((i / 3) % 3 - 1) * pitch + (i % 3 - 1);
    if (xx < 0 || xx >= N || ll < 0 || ll >= L) continue;
    const long long at = (long long)xx * L + ll;
    u[i] = src[at];
    if (coeff) k[i] = coeff_term(coeff[at], mode);
  }
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kApplyClasses; ++c) {
#pragma unroll
    for (int a = 0; a < kApplyVerts; ++a) {
      const int qx = x - tet_off(c, a, 0);
      const int qy = y - tet_off(c, a, 1);
      const int qz = z - tet_off(c, a, 2);
      if (qx < 0 || qy < 0 || qz < 0 || qx + qy + qz > n - tet_margin(c))
        continue;
      float inner = 0.f, csum = 0.f;
#pragma unroll
      for (int b = 0; b < kApplyVerts; ++b) {
        const int i = cube27(tet_off(c, b, 0) - tet_off(c, a, 0),
                             tet_off(c, b, 1) - tet_off(c, a, 1),
                             tet_off(c, b, 2) - tet_off(c, a, 2));
        inner += elm[(c * kApplyVerts + a) * kApplyVerts + b] * u[i];
        csum += k[i];
      }
      acc += coeff ? inner * coeff_finish(csum, mode) : inner;
    }
  }
  return acc;
}

}  // namespace hyteg
