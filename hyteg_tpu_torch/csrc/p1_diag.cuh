// Per-point arithmetic of the P1 partial diagonal / lumped row sum
// (kernel B3), and the kernel's walk over one plane of a cell, kept apart
// from the kernel in p1_diag.cu like p1_const_stencil.cuh. Layout follows
// hyteg_tpu_torch/kernels/p1_stencil.py:
//   elmats of one cell: (6, 4, 4) f32 element matrices, one per micro-tet
//   congruence class t; dst and coeff blocks: (N, L), L = N * pitch,
//   lane = y * pitch + z.
// The walks store through a template Out: f32 (CellStore) or, without a
// coefficient, bf16 storage that rounds the f32 class value once
// (p1_diag.cu's BF16CellStore); the weights are f32 either way.
#pragma once

#include <utility>

#include "plane.cuh"

#ifndef HYTEG_DEVICE
#define HYTEG_DEVICE __device__ __forceinline__
#endif
#ifndef HYTEG_HD
#ifdef __CUDACC__
#define HYTEG_HD __host__ __device__
#else
#define HYTEG_HD
#endif
#endif

namespace hyteg {

constexpr int kClasses = 6;   // micro-tet congruence classes
constexpr int kVerts = 4;     // vertices per micro-tet

// The micro-tet classes, as indexing/micro.py's TET_OFFSETS and
// TET_BASE_MARGIN: vertex offsets from the element's base q, and the base
// region x + y + z <= n - margin[t]. The launcher refuses tables that
// differ.
constexpr int kDiagOff[kClasses][kVerts][3] = {
    {{0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {0, 0, 1}},
    {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}, {1, 0, 1}},
    {{1, 0, 0}, {0, 1, 0}, {1, 1, 0}, {1, 0, 1}},
    {{0, 1, 0}, {0, 0, 1}, {1, 0, 1}, {0, 1, 1}},
    {{0, 1, 0}, {1, 1, 0}, {1, 0, 1}, {0, 1, 1}},
    {{1, 1, 0}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1}}};
constexpr int kDiagMargin[kClasses] = {1, 2, 2, 2, 2, 3};

// The position class of an in-tet slot p = (x, y, z), S = x + y + z <= n.
// Vertex a of class t at p has its base at q = p - off[t,a], valid iff
// q_i >= 0 for each i and S(q) = S - |off[t,a]| <= n - margin[t]. Every
// offset is 0 or 1, so the first test fails iff p_i = 0 for some i with
// off[t,a,i] = 1: it depends only on the face set f of p (bit i set iff
// p_i = 0). The gap margin[t] - |off[t,a]| is 0 or 1 for all 24 (t, a)
// (checked below), so the second test reads S <= n - gap: always true at
// gap 0, and at gap 1 false only on the shell S = n. So which of the 24
// weights a slot sums depends only on (f, [S == n]): 16 classes, row
// f * 2 + sh, the same as B2's folded rows (15 occur: f = 7 is the
// origin, never on the shell for n >= 1).
HYTEG_HD constexpr int diag_vmask(int t, int a) {
  return kDiagOff[t][a][0] | (kDiagOff[t][a][1] << 1) |
         (kDiagOff[t][a][2] << 2);
}
HYTEG_HD constexpr int diag_gap(int t, int a) {
  return kDiagMargin[t] -
         (kDiagOff[t][a][0] + kDiagOff[t][a][1] + kDiagOff[t][a][2]);
}
HYTEG_HD constexpr bool diag_class_rule_holds() {
  for (int t = 0; t < kClasses; ++t)
    for (int a = 0; a < kVerts; ++a) {
      if (diag_gap(t, a) != 0 && diag_gap(t, a) != 1) return false;
      for (int i = 0; i < 3; ++i)
        if (kDiagOff[t][a][i] != 0 && kDiagOff[t][a][i] != 1) return false;
    }
  return true;
}
static_assert(diag_class_rule_holds(),
              "the diagonal's weights depend on more than (face set, shell)");
constexpr int kDiagRows = 16;  // 8 face sets x 2 shell flags

// Vertex a of class t as compile-time constants (device code reads the
// tables above only in constant expressions): its offset, the class's
// margin, its face mask (bit i: off_i = 1) and its gap.
template <int T, int A>
struct DiagVert {
  static constexpr int ox = kDiagOff[T][A][0];
  static constexpr int oy = kDiagOff[T][A][1];
  static constexpr int oz = kDiagOff[T][A][2];
  static constexpr int margin = kDiagMargin[T];
  static constexpr int vmask = diag_vmask(T, A);
  static constexpr int gap = diag_gap(T, A);
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

template <int I>
HYTEG_DEVICE void diag_class_term(float& acc, int f, int sh, const float* w) {
  using V = DiagVert<I / kVerts, I % kVerts>;
  if ((f & V::vmask) == 0 && !(sh && V::gap == 1)) acc += w[I];
}

template <int... I>
HYTEG_DEVICE float diag_class_value(int f, int sh, const float* w,
                                    std::integer_sequence<int, I...>) {
  float acc = 0.f;
  (diag_class_term<I>(acc, f, sh, w), ...);
  return acc;
}

// The 16 class values from the 24 weights w: value (f * 2 + sh) sums
// w[t*4 + a] over the (t, a) whose base is valid in that class, classes
// then vertices ascending, the order of diag_point.
HYTEG_DEVICE void diag_fold_classes(const float* w, float* cls, int tid,
                                    int nthreads) {
  for (int k = tid; k < kDiagRows; k += nthreads)
    cls[k] = diag_class_value(k >> 1, k & 1, w,
                              std::make_integer_sequence<int, kClasses * kVerts>{});
}

// The transform of a coefficient value that a mean sums: mode 0
// arithmetic r, 1 harmonic 1 / r, 2 geometric log r (values clamped away
// from zero, as operators/averaging.py does), and the mean of 4 such sums.
HYTEG_DEVICE float diag_coeff_term(float r, int mode) {
  if (mode == 0) return r;
  if (mode == 1) return 1.f / fmaxf(r, 1e-30f);
  return logf(fmaxf(r, 1e-30f));
}
HYTEG_DEVICE float diag_coeff_mean_of(float s, int mode) {
  if (mode == 0) return s / kVerts;
  if (mode == 1) return kVerts / s;
  return expf(s / kVerts);
}

// Mean of the nodal coefficient over the vertices of the class-T element
// whose base lies at offset q of the cell's block.
template <int T>
HYTEG_DEVICE float diag_coeff_mean(const float* coeff, int q, int L,
                                   int pitch, int mode) {
  float s = 0.f;
  s += diag_coeff_term(coeff[q + DiagVert<T, 0>::ox * L +
                             DiagVert<T, 0>::oy * pitch + DiagVert<T, 0>::oz],
                       mode);
  s += diag_coeff_term(coeff[q + DiagVert<T, 1>::ox * L +
                             DiagVert<T, 1>::oy * pitch + DiagVert<T, 1>::oz],
                       mode);
  s += diag_coeff_term(coeff[q + DiagVert<T, 2>::ox * L +
                             DiagVert<T, 2>::oy * pitch + DiagVert<T, 2>::oz],
                       mode);
  s += diag_coeff_term(coeff[q + DiagVert<T, 3>::ox * L +
                             DiagVert<T, 3>::oy * pitch + DiagVert<T, 3>::oz],
                       mode);
  return diag_coeff_mean_of(s, mode);
}

template <int I>
HYTEG_DEVICE void diag_point_term(float& acc, const float* coeff, int x,
                                  int y, int z, int n, int L, int pitch,
                                  const float* w, int mode) {
  using V = DiagVert<I / kVerts, I % kVerts>;
  const int qx = x - V::ox, qy = y - V::oy, qz = z - V::oz;
  if (qx < 0 || qy < 0 || qz < 0 || qx + qy + qz > n - V::margin) return;
  float v = w[I];
  if (coeff)
    v *= diag_coeff_mean<I / kVerts>(coeff, qx * L + qy * pitch + qz, L,
                                     pitch, mode);
  acc += v;
}

template <int... I>
HYTEG_DEVICE float diag_point_seq(const float* coeff, int x, int y, int z,
                                  int N, int pitch, const float* w, int mode,
                                  std::integer_sequence<int, I...>) {
  float acc = 0.f;
  (diag_point_term<I>(acc, coeff, x, y, z, N - 1, N * pitch, pitch, w, mode),
   ...);
  return acc;
}

// dst at an in-tet slot (x, y, z) of one cell, in gather form: the sum
// over classes t and vertices a of w[t,a] (times the coefficient mean)
// for every element whose base q = p - off[t,a] is valid (all q_i >= 0,
// S(q) <= n - margin), each base tested. coeff may be null. The kernel's
// path for slots on a coordinate face or the shell when it has a
// coefficient.
HYTEG_DEVICE float diag_point(const float* coeff, int x, int y, int z, int N,
                              int pitch, const float* w, int mode) {
  return diag_point_seq(coeff, x, y, z, N, pitch, w, mode,
                        std::make_integer_sequence<int, kClasses * kVerts>{});
}

// -- a slot off the faces and the shell, with a coefficient ----------------
// A slot with x, y, z >= 1 and S <= n - 1 has all 24 bases valid, and the
// vertices of their elements are the slot's 15-point neighbourhood
// p + off[t,b] - off[t,a], every one in the tet (each move has a
// coordinate sum of -1, 0 or 1, and no coordinate falls below 0). Cube
// index of a move d in {-1, 0, 1}^3: (dx + 1) * 9 + (dy + 1) * 3 + dz + 1.
HYTEG_HD constexpr int diag_nbr(int t, int a, int b) {
  return (kDiagOff[t][b][0] - kDiagOff[t][a][0] + 1) * 9 +
         (kDiagOff[t][b][1] - kDiagOff[t][a][1] + 1) * 3 +
         (kDiagOff[t][b][2] - kDiagOff[t][a][2] + 1);
}
HYTEG_HD constexpr bool diag_nbr_used(int k) {
  for (int t = 0; t < kClasses; ++t)
    for (int a = 0; a < kVerts; ++a)
      for (int b = 0; b < kVerts; ++b)
        if (diag_nbr(t, a, b) == k) return true;
  return false;
}

// g[K] = the transformed coefficient at move K, for the 15 moves used.
template <int MODE, int K>
HYTEG_DEVICE void diag_load_nbr(float (&g)[27], const float* p, int L,
                                int pitch) {
  if constexpr (diag_nbr_used(K))
    g[K] = diag_coeff_term(p[(K / 9 - 1) * L + (K / 3 % 3 - 1) * pitch +
                             (K % 3 - 1)],
                           MODE);
}

// acc += w[I] * the mean of element (t, a) = (I / 4, I % 4), its four
// transformed values summed in vertex order, as diag_coeff_mean does.
template <int MODE, int I>
HYTEG_DEVICE void diag_elem_term(float& acc, const float (&g)[27],
                                 const float* w) {
  constexpr int t = I / kVerts, a = I % kVerts;
  constexpr int k0 = diag_nbr(t, a, 0), k1 = diag_nbr(t, a, 1);
  constexpr int k2 = diag_nbr(t, a, 2), k3 = diag_nbr(t, a, 3);
  float s = 0.f;
  s += g[k0];
  s += g[k1];
  s += g[k2];
  s += g[k3];
  acc += w[I] * diag_coeff_mean_of(s, MODE);
}

template <int MODE, int... K, int... I>
HYTEG_DEVICE float diag_interior_coeff_seq(const float* p, int L, int pitch,
                                           const float* w,
                                           std::integer_sequence<int, K...>,
                                           std::integer_sequence<int, I...>) {
  float g[27];
  (diag_load_nbr<MODE, K>(g, p, L, pitch), ...);
  float acc = 0.f;
  (diag_elem_term<MODE, I>(acc, g, w), ...);
  return acc;
}

// dst at a slot off the faces and the shell (x, y, z >= 1, S <= n - 1),
// p pointing at its coefficient: the 15 neighbours read once and
// transformed once, the 24 element means formed from compile-time vertex
// lists, no tests. The same terms in the same order as diag_point.
template <int MODE>
HYTEG_DEVICE float diag_interior_coeff(const float* p, int L, int pitch,
                                       const float* w) {
  return diag_interior_coeff_seq<MODE>(
      p, L, pitch, w, std::make_integer_sequence<int, 27>{},
      std::make_integer_sequence<int, kClasses * kVerts>{});
}

// -- the walks: every slot of plane x of one cell, each written once ------
// A thread block's share of kernel B3, run by thread (warp, lane) of
// nwarps warps, as const_apply_plane walks B2's plane: row (x, y) meets
// the tet in r = n + 1 - x - y slots, z < r, from z = 0 in chunks of 32
// lanes; its lanes r <= z < pitch (padding lanes included) and the rows
// y > n - x past the tet are store-only zero runs (zero_run). All
// offsets are 32-bit: a cell holds N * L <= 2^31 slots.

// Without a coefficient: each in-tet slot stores its class's value (cls:
// the 16 values of diag_fold_classes in shared memory). No loads.
template <class Out>
HYTEG_DEVICE void diag_plane(const Out& out, int x, int N, int pitch,
                             const float* cls, int warp, int lane,
                             int nwarps) {
  const int L = N * pitch;
  const int ry = N - 1 - x;  // last row that meets the tet
  for (int y = warp; y <= ry; y += nwarps) {
    const int r = ry + 1 - y, row = x * L + y * pitch;
    const int fxy = (x == 0) | ((y == 0) << 1);
    for (int z = lane; z < r; z += 32)
      out(row + z, cls[(fxy | ((z == 0) << 2)) * 2 + (z == r - 1)]);
    zero_run(out, row + r, row + pitch, lane, 32);
  }
  zero_run(out, x * L + (ry + 1) * pitch, (x + 1) * L, warp * 32 + lane,
           nwarps * 32);
}

// With a coefficient (mean MODE), coeff the cell's block, w the 24
// weights in shared memory:
//  - Plane x = 0 is all face: warps take rows, each slot through
//    diag_point.
//  - Else row y = 0 is face: its chunks of 32 slots go to the warps in
//    turn, through diag_point. Rows y = 1 + warp, 1 + warp + nwarps, ...:
//    slots z = 1 .. r - 2 run diag_interior_coeff; their face slot z = 0
//    and shell slot z = r - 1 go through diag_point as one list over all
//    threads, so the row chunks hold neither.
template <int MODE, class Out>
HYTEG_DEVICE void diag_plane_coeff(const float* coeff, const Out& out, int x,
                                   int N, int pitch, const float* w, int warp,
                                   int lane, int nwarps) {
  const int L = N * pitch;
  const int ry = N - 1 - x;
  const int tid = warp * 32 + lane, nthreads = nwarps * 32;
  if (x == 0) {
    for (int y = warp; y <= ry; y += nwarps) {
      const int r = ry + 1 - y, row = y * pitch;
      for (int z = lane; z < r; z += 32)
        out(row + z, diag_point(coeff, 0, y, z, N, pitch, w, MODE));
      zero_run(out, row + r, row + pitch, lane, 32);
    }
  } else {
    const int row0 = x * L;
    for (int z = tid; z <= ry; z += nthreads)
      out(row0 + z, diag_point(coeff, x, 0, z, N, pitch, w, MODE));
    zero_run(out, row0 + ry + 1, row0 + pitch, tid, nthreads);
    for (int y = 1 + warp; y <= ry; y += nwarps) {
      const int r = ry + 1 - y, row = x * L + y * pitch;
      for (int z = 1 + lane; z - lane <= r - 2; z += 32)
        if (z <= r - 2)
          out(row + z, diag_interior_coeff<MODE>(coeff + row + z, L, pitch, w));
      zero_run(out, row + r, row + pitch, lane, 32);
    }
    // the face slot z = 0 and the shell slot z = r - 1 of rows 1 .. ry
    for (int i = tid; i < 2 * ry; i += nthreads) {
      const int y = 1 + (i >> 1), r = ry + 1 - y;
      const int z = (i & 1) ? r - 1 : 0;
      if ((i & 1) && z == 0) continue;  // r = 1: one slot, both
      out(x * L + y * pitch + z, diag_point(coeff, x, y, z, N, pitch, w, MODE));
    }
  }
  zero_run(out, x * L + (ry + 1) * pitch, (x + 1) * L, tid, nthreads);
}

}  // namespace hyteg
