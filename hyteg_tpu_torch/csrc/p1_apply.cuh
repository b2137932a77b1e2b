// Per-point arithmetic of the general elementwise P1 apply (kernel B4),
// and the kernel's walk over one plane of a cell, kept apart from the
// kernel in p1_apply.cu like p1_diag.cuh. Layout follows
// hyteg_tpu_torch/kernels/p1_stencil.py:
//   elmats of one cell: (6, 4, 4) f32, one matrix per micro-tet
//   congruence class t; src, coeff and dst blocks: (N, L), L = N * pitch.
// The source and the coefficient are template parameters Src and Co,
// read as p[i] -> float and p + k (and a coefficient tested as a
// pointer is): a plain const float* for f32 storage, or bf16.cuh's
// BF16Src, which widens each bf16 load (a missing coefficient is Co{}).
// Every sum and mean is f32; the store (Out) rounds once for bf16.
#pragma once

#include <utility>

#ifndef HYTEG_DEVICE
#define HYTEG_DEVICE __device__ __forceinline__
#endif

// A host harness may count the coefficient transforms (kind 0) and the
// means finished (kind 1); empty in the kernels.
#ifndef HYTEG_COEFF_HOOK
#define HYTEG_COEFF_HOOK(kind)
#endif

#include "p1_diag.cuh"  // kDiagOff, kDiagMargin, DiagVert, diag_nbr, plane.cuh

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
  HYTEG_COEFF_HOOK(0);
  if (mode == 0) return r;
  const float c = r > 1e-30f ? r : 1e-30f;
  return mode == 1 ? 1.f / c : logf(c);
}

// The mean from the sum s of nv per-vertex terms (nv = 3 for a triangle).
HYTEG_DEVICE float coeff_finish(float s, int mode, int nv = kApplyVerts) {
  HYTEG_COEFF_HOOK(1);
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
template <class Src, class Co>
HYTEG_DEVICE float p1_apply_point(Src src, Co coeff, int x, int lane, int N,
                                  int pitch, const float* elm, int mode) {
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

// -- the walk of kernel B4 over one plane x of a cell ----------------------
// One thread block of kApplyThreads threads per (cell, plane x), as B2's
// and B3's plane walks (const_apply_plane, diag_plane_coeff): row (x, y)
// meets the tet in r = n + 1 - x - y slots, z < r; its lanes r <= z <
// pitch (padding lanes included) and the rows y > n - x past the tet are
// store-only zero runs. A slot off the coordinate faces and the shell (x,
// y, z >= 1, S <= n - 1) has all 24 element bases valid, and its
// elements' vertices are its 15-point neighbourhood, every one in the
// tet: it runs one untested sum from compile-time neighbour and vertex
// lists (diag_nbr). Face and shell slots run the tested p1_apply_point.
// Offsets are 32-bit: a cell holds N * L <= 2^31 slots.

constexpr int kApplyThreads = kPlaneWarps * 32;

// Row I = t * 4 + a of the cell's element matrices, elm in shared memory
// at a 16-byte boundary: one 16-byte load on the card.
struct ElmRow {
  float e0, e1, e2, e3;
};
HYTEG_DEVICE ElmRow elm_row(const float* elm, int I) {
#ifdef __CUDACC__
  // a volatile load: read where it is used, not hoisted with the other
  // 23 rows into registers (96 live values spilled the sum)
  ElmRow r;
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(r.e0), "=f"(r.e1), "=f"(r.e2), "=f"(r.e3)
               : "r"((unsigned)__cvta_generic_to_shared(elm + 4 * I)));
  return r;
#else
  return {elm[4 * I], elm[4 * I + 1], elm[4 * I + 2], elm[4 * I + 3]};
#endif
}

// v[K] = p[move K], for the 15 moves used; transformed by MODE when
// MODE >= 0 (a coefficient), as read when MODE < 0 (src).
template <int MODE, int K, class P>
HYTEG_DEVICE void apply_load_nbr(float (&v)[27], P p, int L, int pitch) {
  if constexpr (diag_nbr_used(K)) {
    const float r = p[(K / 9 - 1) * L + (K / 3 % 3 - 1) * pitch + (K % 3 - 1)];
    if constexpr (MODE < 0)
      v[K] = r;
    else
      v[K] = coeff_term(r, MODE);
  }
}

// sum_b elm[t,a,b] * src at vertex b of element (t, a) = (I / 4, I % 4),
// summed as p1_apply_point sums it.
template <int I>
HYTEG_DEVICE float apply_inner(const float (&u)[27], const float* elm) {
  constexpr int t = I / kVerts, a = I % kVerts;
  constexpr int k0 = diag_nbr(t, a, 0), k1 = diag_nbr(t, a, 1);
  constexpr int k2 = diag_nbr(t, a, 2), k3 = diag_nbr(t, a, 3);
  const ElmRow e = elm_row(elm, I);
  float inner = 0.f;
  inner += e.e0 * u[k0];
  inner += e.e1 * u[k1];
  inner += e.e2 * u[k2];
  inner += e.e3 * u[k3];
  return inner;
}

// acc += element (t, a)'s term; its mean from the four transformed
// values g, summed in vertex order (operators/averaging.py's order).
template <int MODE, int I>
HYTEG_DEVICE void apply_elem_term(float& acc, const float (&u)[27],
                                  const float (&g)[27], const float* elm) {
  const float inner = apply_inner<I>(u, elm);
  if constexpr (MODE < 0) {
    acc += inner;
  } else {
    constexpr int t = I / kVerts, a = I % kVerts;
    constexpr int k0 = diag_nbr(t, a, 0), k1 = diag_nbr(t, a, 1);
    constexpr int k2 = diag_nbr(t, a, 2), k3 = diag_nbr(t, a, 3);
    float s = 0.f;
    s += g[k0];
    s += g[k1];
    s += g[k2];
    s += g[k3];
    acc += inner * coeff_finish(s, MODE);
  }
}

template <int MODE, class Src, class Co, int... K, int... I>
HYTEG_DEVICE float apply_interior_seq(Src p, Co k, int L, int pitch,
                                      const float* elm,
                                      std::integer_sequence<int, K...>,
                                      std::integer_sequence<int, I...>) {
  float u[27], g[27];
  (apply_load_nbr<-1, K>(u, p, L, pitch), ...);
  if constexpr (MODE >= 0) (apply_load_nbr<MODE, K>(g, k, L, pitch), ...);
  float acc = 0.f;
  (apply_elem_term<MODE, I>(acc, u, g, elm), ...);
  return acc;
}

// dst at a slot off the faces and the shell, p and k pointing at its src
// and coefficient (k unused for MODE -1, no coefficient): the 15
// neighbours read once, each coefficient value transformed once, the 24
// element means formed from compile-time vertex lists, no tests. The
// same terms in the same order as p1_apply_point.
template <int MODE, class Src, class Co>
HYTEG_DEVICE float apply_interior(Src p, Co k, int L, int pitch,
                                  const float* elm) {
  return apply_interior_seq<MODE>(
      p, k, L, pitch, elm, std::make_integer_sequence<int, 27>{},
      std::make_integer_sequence<int, kClasses * kVerts>{});
}

// p1_apply_point as a call of its own on the card: inlined into the walk,
// its 27-entry gathers share the interior sum's registers and spill them.
#ifdef __CUDACC__
#define HYTEG_NOINLINE __device__ __noinline__
#else
#define HYTEG_NOINLINE inline
#endif
template <int MODE, class Src, class Co>
HYTEG_NOINLINE float apply_point_rim(Src src, Co coeff, int x, int lane,
                                     int N, int pitch, const float* elm) {
  return p1_apply_point(src, coeff, x, lane, N, pitch, elm, MODE);
}

// Every slot of plane x but the interior ones of rows y >= 1, for thread
// tid of nthreads: plane x = 0 is all face, its rows to the warps in
// turn; else row y = 0 is face, its slots to all threads, and the face
// slot z = 0 and the shell slot z = r - 1 of rows 1 .. n - x form one list
// over all threads, so that no row waits on them. Then the zero runs.
template <int MODE, class Src, class Co, class Out>
HYTEG_DEVICE void apply_plane_rim(Src src, Co coeff, const Out& out, int x,
                                  int N, int pitch,
                                  const float* elm, int tid, int nthreads) {
  const int L = N * pitch;
  const int ry = N - 1 - x;  // last row that meets the tet
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  if (x == 0) {
    for (int y = warp; y <= ry; y += nwarps)
      for (int z = lane; z <= ry - y; z += 32)
        out(y * pitch + z,
            apply_point_rim<MODE>(src, coeff, 0, y * pitch + z, N, pitch, elm));
  } else {
    for (int z = tid; z <= ry; z += nthreads)
      out(x * L + z, apply_point_rim<MODE>(src, coeff, x, z, N, pitch, elm));
    for (int i = tid; i < 2 * ry; i += nthreads) {
      const int y = 1 + (i >> 1), r = ry + 1 - y;
      const int z = (i & 1) ? r - 1 : 0;
      if ((i & 1) && z == 0) continue;  // r = 1: one slot, both
      out(x * L + y * pitch + z, apply_point_rim<MODE>(
                                     src, coeff, x, y * pitch + z, N, pitch,
                                     elm));
    }
  }
  for (int y = warp; y <= ry; y += nwarps)
    zero_run(out, x * L + y * pitch + ry + 1 - y, x * L + (y + 1) * pitch,
             lane, 32);
  zero_run(out, x * L + (ry + 1) * pitch, (x + 1) * L, tid, nthreads);
}

// Kernel B4's block (cell, plane x), thread (warp, lane) of nwarps: the
// rim, then rows y = 1 + warp, 1 + warp + nwarps, ... whose slots z = 1
// .. r - 2 run apply_interior, 32 lanes at a time.
// coeff may be missing (Co{}) when MODE < 0.
template <int MODE, class Src, class Co, class Out>
HYTEG_DEVICE void apply_plane(Src src, Co coeff, const Out& out, int x,
                              int N, int pitch,
                              const float* elm, int warp, int lane,
                              int nwarps) {
  const int L = N * pitch;
  const int ry = N - 1 - x;
  apply_plane_rim<MODE>(src, coeff, out, x, N, pitch, elm, warp * 32 + lane,
                        nwarps * 32);
  if (x == 0) return;
  for (int y = 1 + warp; y <= ry; y += nwarps) {
    const int row = x * L + y * pitch, zl = ry - 1 - y;  // zl = r - 2
    for (int z = 1 + lane; z - lane <= zl; z += 32)
      if (z <= zl)
        out(row + z, apply_interior<MODE>(src + row + z,
                                          coeff ? coeff + row + z : Co{},
                                          L, pitch, elm));
  }
}

}  // namespace hyteg
