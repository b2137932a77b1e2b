// Per-point arithmetic of the 2D forms of kernels B3 (partial diagonal /
// lumped row sum) and B4 (general elementwise apply) on macro-faces, and
// their walks over one band of rows of a face, kept apart from the
// kernels in p1_tri.cu like p1_diag.cuh and p1_apply.cuh.
// Layout follows hyteg_tpu_torch/kernels/p1_stencil.py:
//   elmats of one face: (2, 3, 3) f32, one matrix per micro-triangle
//   class t (up, down); src, coeff and dst blocks: (N, N), lane = z.
// The source and the coefficient are template parameters (Src, Co; P
// where either one is read), as in p1_apply.cuh: a const float*, or
// bf16.cuh's BF16Src, which widens each load (a missing coefficient is
// Co{}). Every sum, mean and staged value is f32; the store (Out) rounds
// once for bf16.
#pragma once

#ifndef HYTEG_DEVICE
#define HYTEG_DEVICE __device__ __forceinline__
#endif

#include <utility>

#include "p1_apply.cuh"  // coeff_term, coeff_finish, kApplyThreads

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
template <class Co>
HYTEG_DEVICE float diag_point_2d(Co coeff, int x, int z, int N,
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
template <class Src, class Co>
HYTEG_DEVICE float p1_apply_point_2d(Src src, Co coeff, int x, int z, int N,
                                     const float* elm, int mode) {
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

// -- the walk of kernel B4-2D over one band of rows of a face --------------
// One thread block of kApplyThreads threads per (face, band of
// kApplyR2 rows x0 .. x0 + kApplyR2 - 1), as B2-2D's band walk
// (const_apply_band_2d): a warp per row, lanes on consecutive z. Row x
// meets the triangle in r = N - x slots, z < r; the slots z = r .. N - 1
// are a store-only zero run. A slot off the edges and the shell (x, z >=
// 1, S = x + z <= n - 1) has all 6 element bases valid and its elements'
// vertices are its 7-point neighbourhood, every one in the triangle: it
// runs one untested sum from compile-time lists; edge and shell slots
// run the tested p1_apply_point_2d.

// The micro-triangle classes, as indexing/micro.py's TRI_OFFSETS and
// TRI_BASE_MARGIN (the launcher refuses tables that differ), and the
// move from vertex a to vertex b of class t as a square9 index.
constexpr int kTriOff[kTriClasses][kTriVerts][2] = {{{0, 0}, {1, 0}, {0, 1}},
                                                    {{1, 0}, {0, 1}, {1, 1}}};
constexpr int kTriMargin[kTriClasses] = {1, 2};
HYTEG_HD constexpr int tri_nbr(int t, int a, int b) {
  return (kTriOff[t][b][0] - kTriOff[t][a][0] + 1) * 3 +
         (kTriOff[t][b][1] - kTriOff[t][a][1] + 1);
}
HYTEG_HD constexpr bool tri_nbr_used(int k) {
  for (int t = 0; t < kTriClasses; ++t)
    for (int a = 0; a < kTriVerts; ++a)
      for (int b = 0; b < kTriVerts; ++b)
        if (tri_nbr(t, a, b) == k) return true;
  return false;
}
template <int T, int A>
struct TriVert {
  static constexpr int ox = kTriOff[T][A][0];
  static constexpr int oz = kTriOff[T][A][1];
  static constexpr int margin = kTriMargin[T];
};

// v[K] = p[move K], for the 7 moves used; transformed by MODE >= 0.
template <int MODE, int K, class P>
HYTEG_DEVICE void tri_load_nbr(float (&v)[9], P p, int N) {
  if constexpr (tri_nbr_used(K)) {
    const float r = p[(K / 3 - 1) * N + (K % 3 - 1)];
    if constexpr (MODE < 0)
      v[K] = r;
    else
      v[K] = coeff_term(r, MODE);
  }
}

// sum_b elm[t,a,b] * src at vertex b of element (t, a) = (I / 3, I % 3),
// summed as p1_apply_point_2d sums it.
template <int I>
HYTEG_DEVICE float tri_inner(const float (&u)[9], const float* elm) {
  constexpr int t = I / kTriVerts, a = I % kTriVerts;
  constexpr int k0 = tri_nbr(t, a, 0), k1 = tri_nbr(t, a, 1);
  constexpr int k2 = tri_nbr(t, a, 2);
  const float* e = elm + I * kTriVerts;
  float inner = 0.f;
  inner += e[0] * u[k0];
  inner += e[1] * u[k1];
  inner += e[2] * u[k2];
  return inner;
}

template <int MODE, int I>
HYTEG_DEVICE void tri_elem_term(float& acc, const float (&u)[9],
                                const float (&g)[9], const float* elm) {
  const float inner = tri_inner<I>(u, elm);
  if constexpr (MODE < 0) {
    acc += inner;
  } else {
    constexpr int t = I / kTriVerts, a = I % kTriVerts;
    constexpr int k0 = tri_nbr(t, a, 0), k1 = tri_nbr(t, a, 1);
    constexpr int k2 = tri_nbr(t, a, 2);
    float s = 0.f;
    s += g[k0];
    s += g[k1];
    s += g[k2];
    acc += inner * coeff_finish(s, MODE, kTriVerts);
  }
}

template <int MODE, class Src, class Co, int... K, int... I>
HYTEG_DEVICE float tri_interior_seq(Src p, Co k, int N, const float* elm,
                                    std::integer_sequence<int, K...>,
                                    std::integer_sequence<int, I...>) {
  float u[9], g[9];
  (tri_load_nbr<-1, K>(u, p, N), ...);
  if constexpr (MODE >= 0) (tri_load_nbr<MODE, K>(g, k, N), ...);
  float acc = 0.f;
  (tri_elem_term<MODE, I>(acc, u, g, elm), ...);
  return acc;
}

// dst at a slot off the edges and the shell, p and k pointing at its src
// and coefficient (k unused for MODE -1): 7 neighbours read once, each
// coefficient value transformed once, the 6 means from compile-time
// vertex lists, no tests. The same terms in the same order as
// p1_apply_point_2d.
template <int MODE, class Src, class Co>
HYTEG_DEVICE float tri_interior(Src p, Co k, int N, const float* elm) {
  return tri_interior_seq<MODE>(
      p, k, N, elm, std::make_integer_sequence<int, 9>{},
      std::make_integer_sequence<int, kTriClasses * kTriVerts>{});
}

constexpr int kApplyR2 = kPlaneWarps;  // rows of a band: a warp each

// p1_apply_point_2d as a call of its own on the card (as apply_point_rim).
template <int MODE, class Src, class Co>
HYTEG_NOINLINE float tri_point_rim(Src src, Co coeff, int x, int z, int N,
                                   const float* elm) {
  return p1_apply_point_2d(src, coeff, x, z, N, elm, MODE);
}

// Every slot of the band but the interior ones, for thread tid of
// nthreads, point(x, z) giving a slot's value: row 0 (all edge) to all
// threads; the edge slot z = 0 and the shell slot z = r - 1 of the band's
// other rows as one list over all threads; then each row's zero run, a
// warp a row.
template <class Out, class Point>
HYTEG_DEVICE void tri_band_rim(const Out& out, int x0, int N,
                               const Point& point, int tid, int nthreads) {
  const int x1 = x0 + kApplyR2 < N ? x0 + kApplyR2 : N;
  const int xs = x0 == 0 ? 1 : x0;
  if (x0 == 0)
    for (int z = tid; z < N; z += nthreads) out(z, point(0, z));
  for (int i = tid; i < 2 * (x1 - xs); i += nthreads) {
    const int x = xs + (i >> 1), r = N - x;
    const int z = (i & 1) ? r - 1 : 0;
    if ((i & 1) && z == 0) continue;  // r = 1: one slot, both
    out(x * N + z, point(x, z));
  }
  const int warp = tid >> 5, lane = tid & 31;
  for (int x = x0 + warp; x < x1; x += nthreads >> 5)
    zero_run(out, x * N + N - x, (x + 1) * N, lane, 32);
}

// Chunks of 32 slots a lane of the direct form takes at a time on a row,
// their loads all in flight before their stores.
constexpr int kApplyChunks2D = 2;

// Row x0 + warp's slots z = 1 .. r - 2 (x >= 1), 32 lanes at a time,
// kApplyChunks2D chunks in flight: slot(row, z) gives the value at offset
// row + z of the face, row = x * N. Each caller forms its own pointers:
// on the card B4-2D's arithmetic kernel ran 4% slower from src + (row +
// z) than from src + row + z, and B3-2D's 26% slower the other way.
template <class Out, class Slot>
HYTEG_DEVICE void tri_band_interior(const Out& out, int x0, int N,
                                    const Slot& slot, int warp, int lane) {
  const int x = x0 + warp;
  if (x < 1 || x >= N) return;
  const int row = x * N, zl = N - x - 2;  // zl = r - 2
  for (int z0 = 1; z0 <= zl; z0 += 32 * kApplyChunks2D) {
    float acc[kApplyChunks2D];
#pragma unroll
    for (int u = 0; u < kApplyChunks2D; ++u) {
      const int z = z0 + lane + 32 * u;
      acc[u] = z <= zl ? slot(row, z) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kApplyChunks2D; ++u) {
      const int z = z0 + lane + 32 * u;
      if (z <= zl) out(row + z, acc[u]);
    }
  }
}

// Kernel B4-2D's block (face, band x0) in its direct form, thread (warp,
// lane) of kApplyR2 warps: the rim, then row x0 + warp's slots z = 1 ..
// r - 2 through tri_interior. coeff may be missing (Co{}) when MODE < 0.
template <int MODE, class Src, class Co, class Out>
HYTEG_DEVICE void tri_apply_band(Src src, Co coeff, const Out& out, int x0,
                                 int N, const float* elm, int warp,
                                 int lane) {
  tri_band_rim(
      out, x0, N,
      [&](int x, int z) {
        return tri_point_rim<MODE>(src, coeff, x, z, N, elm);
      },
      warp * 32 + lane, kApplyThreads);
  tri_band_interior(
      out, x0, N,
      [&](int row, int z) {
        return tri_interior<MODE>(src + row + z,
                                  coeff ? coeff + row + z : Co{}, N, elm);
      },
      warp, lane);
}

// -- the staged form: each coefficient value transformed once per tile ---
// The interior slots of the band's rows and z0 .. z0 + Z - 1 (z0 >= 1) form
// a tile. Their elements' vertices lie in rows x0 - 1 .. x0 + R and z0 - 1
// .. z0 + Z. The block stages G (R + 2, Z + 2) in shared memory: the
// transformed coefficient at each of those vertices in the triangle (the
// others are never read: a valid base's vertices all lie in it, so no
// value past the triangle reaches a mean). Each interior slot then reads
// its 7 transformed neighbours from G and forms its 6 means as the direct
// form does. Per tile (R = 8, Z = 256): 2,580 transforms for up to 2,048
// slots, instead of 7 per slot. Staging the element means too (once per
// band instead of once per vertex) ran no faster on the card.
// Whether mode 0, 1, 2 (arithmetic, harmonic, geometric) runs the staged
// form, in B4-2D and B3-2D alike: the arithmetic mean, whose transform is
// the value itself, runs the direct form, which was the faster for it on
// the card in both. In B3-2D the staged form transforms 1.28 values per
// slot at level 11 instead of 7.01 and beat the direct form by 14%
// (harmonic) and 27% (geometric).
constexpr bool kApplyStaged2D[3] = {false, true, true};
HYTEG_HD constexpr bool tri_apply_staged(int mode) {
  return mode >= 0 && kApplyStaged2D[mode];
}
constexpr int kApplyZ2 = 256;  // tile slots per row: 8 per lane
constexpr int kApplyGX2 = kApplyR2 + 2, kApplyGZ2 = kApplyZ2 + 2;
constexpr int kApplyG2 = kApplyGX2 * kApplyGZ2;

// g[K] = the staged transformed coefficient at move K; gp points at the
// slot's own position in G.
template <int K>
HYTEG_DEVICE void tri_staged_nbr(float (&g)[9], const float* gp) {
  if constexpr (tri_nbr_used(K))
    g[K] = gp[(K / 3 - 1) * kApplyGZ2 + (K % 3 - 1)];
}

template <int MODE, class Src, int... K, int... I>
HYTEG_DEVICE float tri_interior_staged_seq(Src p, const float* gp, int N,
                                           const float* elm,
                                           std::integer_sequence<int, K...>,
                                           std::integer_sequence<int, I...>) {
  float u[9], g[9];
  (tri_load_nbr<-1, K>(u, p, N), ...);
  (tri_staged_nbr<K>(g, gp), ...);
  float acc = 0.f;
  (tri_elem_term<MODE, I>(acc, u, g, elm), ...);
  return acc;
}

// A block (face, band x0) in the staged form (MODE >= 0). team runs the
// block: team.each(fn) calls fn(tid) for each of its kApplyThreads
// threads and team.sync() is the block's barrier, so the same walk runs
// on the card (one call per thread) and on the host (a loop over the
// threads); team.fresh(p, count) marks the tile's G as not yet written (a
// no-op on the card). gs: kApplyG2 floats of shared memory. The rim as in
// the direct form (point(x, z)), then tiles of kApplyZ2 slots from z = 1,
// each staged, then summed (two barriers a tile): slot(i, gp) gives the
// interior slot at offset i of the face, gp its position in G.
template <int MODE, class Team, class Co, class Out, class Point,
          class Slot>
HYTEG_DEVICE void tri_band_staged(Team& team, Co coeff, const Out& out,
                                  int x0, int N, float* gs,
                                  const Point& point, const Slot& slot) {
  static_assert(MODE >= 0, "the staged form needs a coefficient");
  const int n = N - 1;
  team.each([&](int tid) { tri_band_rim(out, x0, N, point, tid, kApplyThreads); });
  const int zmax = N - (x0 == 0 ? 1 : x0) - 2;  // last interior z, first row
  for (int z0 = 1; z0 <= zmax; z0 += kApplyZ2) {
    team.fresh(gs, kApplyG2);
    team.each([&](int tid) {
      for (int i = tid; i < kApplyG2; i += kApplyThreads) {
        const int gx = i / kApplyGZ2, gz = i - gx * kApplyGZ2;
        const int xx = x0 - 1 + gx, zz = z0 - 1 + gz;
        if (xx >= 0 && xx + zz <= n)
          gs[i] = coeff_term(coeff[xx * N + zz], MODE);
      }
    });
    team.sync();
    team.each([&](int tid) {
      const int warp = tid >> 5, lane = tid & 31, x = x0 + warp;
      if (x < 1 || x >= N) return;
      const int row = x * N, zl = N - x - 2;
#pragma unroll
      for (int j = 0; j < kApplyZ2 / 32; ++j) {
        const int lz = lane + 32 * j, z = z0 + lz;
        if (z <= zl)
          out(row + z, slot(row + z, gs + (warp + 1) * kApplyGZ2 + lz + 1));
      }
    });
    team.sync();  // G is restaged next
  }
}

// Kernel B4-2D's block (face, band x0) in its staged form (MODE >= 0).
template <int MODE, class Team, class Src, class Co, class Out>
HYTEG_DEVICE void tri_apply_band_staged(Team& team, Src src, Co coeff,
                                        const Out& out, int x0, int N,
                                        const float* elm, float* gs) {
  tri_band_staged<MODE>(
      team, coeff, out, x0, N, gs,
      [&](int x, int z) {
        return tri_point_rim<MODE>(src, coeff, x, z, N, elm);
      },
      [&](int i, const float* gp) {
        return tri_interior_staged_seq<MODE>(
            src + i, gp, N, elm, std::make_integer_sequence<int, 9>{},
            std::make_integer_sequence<int, kTriClasses * kTriVerts>{});
      });
}

// -- the walk of kernel B3-2D over one band of rows of a face --------------
// One thread block of kApplyThreads threads per (face, band of kApplyR2
// rows), a warp per row, lanes on consecutive z, as B4-2D's band walk.
//
// Without a coefficient the diagonal at an in-triangle slot p = (x, z)
// depends only on its edge set f (bit 0: x = 0, bit 1: z = 0) and on
// whether it lies on the shell S = x + z = n: vertex a of class t has its
// base at q = p - off[t,a], valid iff q_i >= 0 (fails iff p_i = 0 where
// off[t,a,i] = 1: a test of f alone) and S - |off[t,a]| <= n - margin[t],
// i.e. S <= n - gap with gap = margin[t] - |off[t,a]| in {0, 1} (checked
// below): always true at gap 0, false only on the shell at gap 1. So each
// face has 8 class values, row f * 2 + sh, folded once per block; each
// slot stores its class's value and loads nothing (the origin, f = 3, is
// never on the shell for n >= 1).
HYTEG_HD constexpr int tri_vmask(int t, int a) {
  return kTriOff[t][a][0] | (kTriOff[t][a][1] << 1);
}
HYTEG_HD constexpr int tri_gap(int t, int a) {
  return kTriMargin[t] - (kTriOff[t][a][0] + kTriOff[t][a][1]);
}
HYTEG_HD constexpr bool tri_class_rule_holds() {
  for (int t = 0; t < kTriClasses; ++t)
    for (int a = 0; a < kTriVerts; ++a) {
      if (tri_gap(t, a) != 0 && tri_gap(t, a) != 1) return false;
      for (int i = 0; i < 2; ++i)
        if (kTriOff[t][a][i] != 0 && kTriOff[t][a][i] != 1) return false;
    }
  return true;
}
static_assert(tri_class_rule_holds(),
              "the 2D diagonal's weights depend on more than (edge set, shell)");
constexpr int kTriDiagRows = 8;  // 4 edge sets x 2 shell flags

template <int I>
HYTEG_DEVICE void tri_class_term(float& acc, int f, int sh, const float* w) {
  constexpr int vmask = tri_vmask(I / kTriVerts, I % kTriVerts);
  constexpr int gap = tri_gap(I / kTriVerts, I % kTriVerts);
  if ((f & vmask) == 0 && !(sh && gap == 1)) acc += w[I];
}

template <int... I>
HYTEG_DEVICE float tri_class_value(int f, int sh, const float* w,
                                   std::integer_sequence<int, I...>) {
  float acc = 0.f;
  (tri_class_term<I>(acc, f, sh, w), ...);
  return acc;
}

// The 8 class values from the 6 weights w (tri_diag_fold_weights): value
// (f * 2 + sh) sums w[t*3 + a] over the (t, a) whose base is valid in that
// class, classes then vertices ascending, the order of diag_point_2d, so
// each slot's value is diag_point_2d's bit for bit.
HYTEG_DEVICE void tri_fold_classes(const float* w, float* cls, int tid,
                                   int nthreads) {
  for (int k = tid; k < kTriDiagRows; k += nthreads)
    cls[k] = tri_class_value(
        k >> 1, k & 1, w,
        std::make_integer_sequence<int, kTriClasses * kTriVerts>{});
}

// Without a coefficient: row x0 + warp, every slot z < N, each its class's
// value (cls: the 8 values in shared memory) or 0 past the triangle, as
// one store-only run of 16-byte stores.
template <class Out>
HYTEG_DEVICE void tri_diag_band(const Out& out, int x0, int N,
                                const float* cls, int warp, int lane) {
  const int x = x0 + warp;
  if (x >= N) return;
  const int r = N - x, fx = x == 0;
  const float ve = cls[(fx | 2) * 2 + (r == 1)];  // z = 0
  const float vi = cls[fx * 2];                   // 1 <= z <= r - 2
  const float vs = cls[fx * 2 + 1];               // z = r - 1 >= 1
  store_run(
      out, x * N, (x + 1) * N,
      [&](int z) {
        return z == 0 ? ve : (z < r - 1 ? vi : (z == r - 1 ? vs : 0.f));
      },
      lane, 32);
}

// With a coefficient (mean MODE), at a slot off the edges and the shell
// (x, z >= 1, S <= n - 1): all 6 bases are valid and their elements'
// vertices are the slot's 7-point neighbourhood, all in the triangle. k
// points at the slot's coefficient: each neighbour read and transformed
// once, each mean summed in vertex order and each term added as
// diag_point_2d adds it, no tests.
template <int MODE, int I>
HYTEG_DEVICE void tri_diag_term(float& acc, const float (&g)[9],
                                const float* w) {
  constexpr int t = I / kTriVerts, a = I % kTriVerts;
  constexpr int k0 = tri_nbr(t, a, 0), k1 = tri_nbr(t, a, 1);
  constexpr int k2 = tri_nbr(t, a, 2);
  float s = 0.f;
  s += g[k0];
  s += g[k1];
  s += g[k2];
  float v = w[I];
  v *= coeff_finish(s, MODE, kTriVerts);
  acc += v;
}

// g: the 7 transformed neighbours, read directly (STAGED false: k points
// at the slot's coefficient) or from the staged tile (STAGED true: k
// points at the slot's position in G).
template <int MODE, bool STAGED, class P, int... K, int... I>
HYTEG_DEVICE float tri_diag_interior_seq(P k, int N, const float* w,
                                         std::integer_sequence<int, K...>,
                                         std::integer_sequence<int, I...>) {
  float g[9];
  if constexpr (STAGED)
    (tri_staged_nbr<K>(g, k), ...);
  else
    (tri_load_nbr<MODE, K>(g, k, N), ...);
  float acc = 0.f;
  (tri_diag_term<MODE, I>(acc, g, w), ...);
  return acc;
}

template <int MODE, bool STAGED = false, class P>
HYTEG_DEVICE float tri_diag_interior(P k, int N, const float* w) {
  return tri_diag_interior_seq<MODE, STAGED>(
      k, N, w, std::make_integer_sequence<int, 9>{},
      std::make_integer_sequence<int, kTriClasses * kTriVerts>{});
}

// Kernel B3-2D's block (face, band x0) with a coefficient (mean MODE), w
// the 6 weights in shared memory: the edge and shell slots through
// diag_point_2d as one list (tri_band_rim), the interior slots through
// tri_diag_interior, in the staged form where tri_apply_staged says so (gs:
// kApplyG2 floats of shared memory), else row x0 + warp's a warp at a
// time. team as in tri_band_staged.
template <int MODE, class Team, class Co, class Out>
HYTEG_DEVICE void tri_diag_band_coeff(Team& team, Co coeff, const Out& out,
                                      int x0, int N, const float* w,
                                      float* gs) {
  static_assert(MODE >= 0, "the coefficient walk needs a mean");
  auto point = [&](int x, int z) {
    return diag_point_2d(coeff, x, z, N, w, MODE);
  };
  if constexpr (tri_apply_staged(MODE)) {
    tri_band_staged<MODE>(team, coeff, out, x0, N, gs, point,
                          [&](int, const float* gp) {
                            return tri_diag_interior<MODE, true>(gp, N, w);
                          });
  } else {
    team.each([&](int tid) {
      tri_band_rim(out, x0, N, point, tid, kApplyThreads);
      tri_band_interior(
          out, x0, N,
          [&](int row, int z) {
            return tri_diag_interior<MODE>(coeff + (row + z), N, w);
          },
          tid >> 5, tid & 31);
    });
  }
}

}  // namespace hyteg
