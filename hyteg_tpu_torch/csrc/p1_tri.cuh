// Per-point arithmetic of the 2D forms of kernels B3 (partial diagonal /
// lumped row sum) and B4 (general elementwise apply) on macro-faces, kept
// apart from the kernels in p1_tri.cu like p1_diag.cuh and p1_apply.cuh.
// Layout follows hyteg_tpu_torch/kernels/p1_stencil.py:
//   elmats of one face: (2, 3, 3) f32, one matrix per micro-triangle
//   class t (up, down); src, coeff and dst blocks: (N, N), lane = z.
#pragma once

#ifndef HYTEG_DEVICE
#define HYTEG_DEVICE __device__ __forceinline__
#endif

#include "p1_apply.cuh"  // coeff_term, coeff_finish

namespace hyteg {

constexpr int kTriClasses = 2;  // micro-triangle classes (up, down)
constexpr int kTriVerts = 3;    // vertices per micro-triangle

// micro.TRI_OFFSETS[c][a][d] and micro.TRI_BASE_MARGIN[c], as code so that
// with every loop unrolled each offset is a compile-time constant.
HYTEG_DEVICE int tri_off(int c, int a, int d) {
  const int off[kTriClasses][kTriVerts][2] = {
      {{0, 0}, {1, 0}, {0, 1}},   // up
      {{1, 0}, {0, 1}, {1, 1}}};  // down
  return off[c][a][d];
}

HYTEG_DEVICE int tri_margin(int c) { return c == 0 ? 1 : 2; }

// Index of a difference vector d in {-1, 0, 1}^2 into a 9-entry square.
HYTEG_DEVICE int square9(int dx, int dz) { return (dx + 1) * 3 + (dz + 1); }

// w[t*3 + a] = elMat[t,a,a], or sum_b elMat[t,a,b] when lumped.
HYTEG_DEVICE void tri_diag_fold_weights(const float* elm, int lumped, float* w,
                                        int tid, int nthreads) {
  for (int i = tid; i < kTriClasses * kTriVerts; i += nthreads) {
    const float* row = elm + i * kTriVerts;
    const int a = i % kTriVerts;
    w[i] = lumped ? (row[0] + row[1]) + row[2] : row[a];
  }
}

// dst[x, z] of one face, in gather form: the sum over classes t and
// vertices a of w[t,a] (times the coefficient mean over the element's 3
// vertices) for every element whose base q = p - off[t,a] is valid (q_i
// >= 0, qx + qz <= n - margin[t]). 0 outside the triangle. coeff may be
// null; mode 0 arithmetic, 1 harmonic, 2 geometric.
HYTEG_DEVICE float diag_point_2d(const float* coeff, int x, int z, int N,
                                 const float* w, int mode) {
  const int n = N - 1;
  if (x + z > n) return 0.f;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kTriClasses; ++c) {
#pragma unroll
    for (int a = 0; a < kTriVerts; ++a) {
      const int qx = x - tri_off(c, a, 0);
      const int qz = z - tri_off(c, a, 1);
      if (qx < 0 || qz < 0 || qx + qz > n - tri_margin(c)) continue;
      float v = w[c * kTriVerts + a];
      if (coeff) {
        float s = 0.f;
#pragma unroll
        for (int b = 0; b < kTriVerts; ++b)
          s += coeff_term(coeff[(long long)(qx + tri_off(c, b, 0)) * N +
                                qz + tri_off(c, b, 1)],
                          mode);
        v *= coeff_finish(s, mode, kTriVerts);
      }
      acc += v;
    }
  }
  return acc;
}

// dst[x, z] of one face, in gather form: for every class c and vertex a
// whose element base q = p - off[c][a] is valid, add mean_c(coeff) *
// sum_b elm[c,a,b] * src[q + off[c][b]]. q + off[c][b] lies in the
// 7-point neighbourhood of p, so those src values (and coefficient terms)
// are read once. Reads beyond the block are 0, as in flat.shift_read; a
// valid base never reads there. 0 outside the triangle. coeff may be null.
HYTEG_DEVICE float p1_apply_point_2d(const float* src, const float* coeff,
                                     int x, int z, int N, const float* elm,
                                     int mode) {
  const int n = N - 1;
  if (x + z > n) return 0.f;
  bool used[9] = {};
#pragma unroll
  for (int c = 0; c < kTriClasses; ++c)
#pragma unroll
    for (int a = 0; a < kTriVerts; ++a)
#pragma unroll
      for (int b = 0; b < kTriVerts; ++b)
        used[square9(tri_off(c, b, 0) - tri_off(c, a, 0),
                     tri_off(c, b, 1) - tri_off(c, a, 1))] = true;
  float u[9], k[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    u[i] = 0.f;
    k[i] = 0.f;
    if (!used[i]) continue;
    const int xx = x + i / 3 - 1;
    const int zz = z + i % 3 - 1;
    if (xx < 0 || xx >= N || zz < 0 || zz >= N) continue;
    const long long at = (long long)xx * N + zz;
    u[i] = src[at];
    if (coeff) k[i] = coeff_term(coeff[at], mode);
  }
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kTriClasses; ++c) {
#pragma unroll
    for (int a = 0; a < kTriVerts; ++a) {
      const int qx = x - tri_off(c, a, 0);
      const int qz = z - tri_off(c, a, 1);
      if (qx < 0 || qz < 0 || qx + qz > n - tri_margin(c)) continue;
      float inner = 0.f, csum = 0.f;
#pragma unroll
      for (int b = 0; b < kTriVerts; ++b) {
        const int i = square9(tri_off(c, b, 0) - tri_off(c, a, 0),
                              tri_off(c, b, 1) - tri_off(c, a, 1));
        inner += elm[(c * kTriVerts + a) * kTriVerts + b] * u[i];
        csum += k[i];
      }
      acc += coeff ? inner * coeff_finish(csum, mode, kTriVerts) : inner;
    }
  }
  return acc;
}

}  // namespace hyteg
