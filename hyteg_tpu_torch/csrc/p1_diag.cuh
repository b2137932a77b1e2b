// Per-point arithmetic of the P1 partial diagonal / lumped row sum
// (kernel B3), kept apart from the kernel in p1_diag.cu like
// p1_const_stencil.cuh. Layout follows
// hyteg_tpu_torch/kernels/p1_stencil.py:
//   elmats of one cell: (6, 4, 4) f32 element matrices, one per micro-tet
//   congruence class t; dst and coeff blocks: (N, L), L = N * pitch.
#pragma once

#ifndef HYTEG_DEVICE
#define HYTEG_DEVICE __device__ __forceinline__
#endif

namespace hyteg {

constexpr int kClasses = 6;   // micro-tet congruence classes
constexpr int kVerts = 4;     // vertices per micro-tet

struct DiagTables {
  int off[kClasses][kVerts][3];  // vertex offsets from the class's base
  int margin[kClasses];          // base region: x+y+z <= n - margin[t]
};

// w[t*4 + a] = elMat[t,a,a], or sum_b elMat[t,a,b] when lumped.
HYTEG_DEVICE void diag_fold_weights(const float* elm, int lumped, float* w,
                                    int tid, int nthreads) {
  for (int i = tid; i < kClasses * kVerts; i += nthreads) {
    const float* row = elm + i * kVerts;
    const int a = i % kVerts;
    w[i] = lumped ? ((row[0] + row[1]) + row[2]) + row[3] : row[a];
  }
}

// Mean of the nodal coefficient over the vertices of the class-t element
// based at (qx, qy, qz): mode 0 arithmetic, 1 harmonic, 2 geometric
// (values clamped away from zero, as operators/averaging.py does).
HYTEG_DEVICE float diag_coeff_mean(const float* coeff, int qx, int qy, int qz,
                                   const int (*off)[3], int L, int pitch,
                                   int mode) {
  float s = 0.f;
  for (int b = 0; b < kVerts; ++b) {
    const float r = coeff[(long long)(qx + off[b][0]) * L +
                          (qy + off[b][1]) * pitch + (qz + off[b][2])];
    if (mode == 0)
      s += r;
    else if (mode == 1)
      s += 1.f / fmaxf(r, 1e-30f);
    else
      s += logf(fmaxf(r, 1e-30f));
  }
  if (mode == 0) return s / kVerts;
  if (mode == 1) return kVerts / s;
  return expf(s / kVerts);
}

// dst[x, lane] of one cell, in gather form: the sum over classes t and
// vertices a of w[t,a] (times the coefficient mean) for every element
// whose base q = p - off[t,a] is valid (all q_i >= 0, S(q) <= n - margin).
// 0 outside the tet and on padding lanes. coeff may be null.
HYTEG_DEVICE float diag_point(const float* coeff, int x, int lane, int N,
                              int pitch, const DiagTables& t, const float* w,
                              int mode) {
  const int n = N - 1;
  const int L = N * pitch;
  const int y = lane / pitch;
  const int z = lane - y * pitch;
  if (z >= N || x + y + z > n) return 0.f;
  float acc = 0.f;
  for (int c = 0; c < kClasses; ++c) {
    for (int a = 0; a < kVerts; ++a) {
      const int qx = x - t.off[c][a][0];
      const int qy = y - t.off[c][a][1];
      const int qz = z - t.off[c][a][2];
      if (qx < 0 || qy < 0 || qz < 0 || qx + qy + qz > n - t.margin[c])
        continue;
      float v = w[c * kVerts + a];
      if (coeff) v *= diag_coeff_mean(coeff, qx, qy, qz, t.off[c], L, pitch, mode);
      acc += v;
    }
  }
  return acc;
}

}  // namespace hyteg
