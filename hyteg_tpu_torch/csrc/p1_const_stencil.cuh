// Per-point arithmetic of the constant-stencil P1 apply (kernel B2).
//
// Kept apart from the kernel in p1_const_stencil.cu so that the math is a
// set of plain functions of (cell weights, point): the kernel only maps
// threads to points. Layout and weights follow
// hyteg_tpu_torch/kernels/p1_const_stencil.py:
//   src block of one cell: (N, L) f32, L = N * pitch, lane = y * pitch + z;
//   A (15, 2): shell-resolved stencil weights A[s, j];
//   E (7, 2, 15): signed face corrections E[G, j, s].
#pragma once

#ifndef HYTEG_DEVICE
#define HYTEG_DEVICE __device__ __forceinline__
#endif

namespace hyteg {

constexpr int kConstDirs = 15;    // stencil directions (incl. 0)
constexpr int kConstGroups = 7;   // coordinate-face subsets G
constexpr int kConstShells = 2;   // j levels (one diagonal shell)

struct ConstTables {
  int dx[kConstDirs];             // x offset of direction s
  int dl[kConstDirs];             // lane offset dy * pitch + dz
  int gmask[kConstGroups];        // bit i set <=> coordinate i in G
};

// Per-cell weights folded for the two cases of the diagonal shell:
//   off the shell (S < n): w_in[s]  = A[s,0] + A[s,1],  e_in[G,s] = E[G,0,s] + E[G,1,s]
//   on the shell (S == n): w_sh[s]  = A[s,0],           e_sh[G,s] = E[G,0,s]
HYTEG_DEVICE void const_fold_weights(const float* A, const float* E,
                                     float* w_in, float* w_sh,
                                     float* e_in, float* e_sh,
                                     int tid, int nthreads) {
  for (int s = tid; s < kConstDirs; s += nthreads) {
    const float a0 = A[s * kConstShells], a1 = A[s * kConstShells + 1];
    w_in[s] = a0 + a1;
    w_sh[s] = a0;
  }
  for (int i = tid; i < kConstGroups * kConstDirs; i += nthreads) {
    const int g = i / kConstDirs, s = i - g * kConstDirs;
    const float e0 = E[(g * kConstShells) * kConstDirs + s];
    const float e1 = E[(g * kConstShells + 1) * kConstDirs + s];
    e_in[i] = e0 + e1;
    e_sh[i] = e0;
  }
}

// dst[x, lane] of one cell:
//   0 outside the tet (S > n) and on padding lanes (z >= N);
//   else sum_s c_s * src[p + s], with
//   c_s = A[s,0] + A[s,1] - sh * A[s,1]
//         - sum_G sigma_G * (E[G,0,s] + E[G,1,s] - sh * E[G,1,s]),
//   sh = [S == n], sigma_G = prod_{i in G} [coord_i == 0].
// Reads are bounds-checked on x and on the flat lane axis and zero-filled
// beyond the block (the flat.shift_read semantics).
HYTEG_DEVICE float const_apply_point(const float* src, int x, int lane,
                                     int N, int pitch, const ConstTables& t,
                                     const float* w_in, const float* w_sh,
                                     const float* e_in, const float* e_sh) {
  const int n = N - 1;
  const int L = N * pitch;
  const int y = lane / pitch;
  const int z = lane - y * pitch;
  const int S = x + y + z;
  if (z >= N || S > n) return 0.f;
  const bool shell = (S == n);
  const float* w = shell ? w_sh : w_in;
  const float* e = shell ? e_sh : e_in;
  const int faces = (x == 0) | ((y == 0) << 1) | ((z == 0) << 2);
  float acc = 0.f;
  for (int s = 0; s < kConstDirs; ++s) {
    float c = w[s];
    if (faces) {
      for (int g = 0; g < kConstGroups; ++g)
        if ((faces & t.gmask[g]) == t.gmask[g]) c -= e[g * kConstDirs + s];
    }
    const int xs = x + t.dx[s];
    const int ls = lane + t.dl[s];
    float v = 0.f;
    if (xs >= 0 && xs < N && ls >= 0 && ls < L)
      v = src[(long long)xs * L + ls];
    acc = fmaf(c, v, acc);
  }
  return acc;
}

}  // namespace hyteg
