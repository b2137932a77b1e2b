// Per-point arithmetic of the constant-stencil P1 apply (kernel B2).
//
// The walks (3D and 2D) and their point functions take the source as a
// template parameter Src, read as src[i] -> float (and src + k): a plain const
// float* for f32 storage, or an object that widens bf16 storage to f32 on
// each load (the kernel's BF16Src; the host tests' own). The store is a
// template parameter as well (CellStore, or a bf16 store that rounds to
// nearest even). Weights and every sum stay f32 whatever the storage, so
// a bf16 result is rounded once, on its store.
//
// Kept apart from the kernel in p1_const_stencil.cu so that the math, and
// the 3D kernel's walk over one plane of a cell (const_apply_plane), are
// plain functions that the host C++ compiler also builds: the kernels only
// stage weights and pick the plane or point. Layout and weights follow
// hyteg_tpu_torch/kernels/p1_const_stencil.py:
//   3D: src block of one cell: (N, L) f32, L = N * pitch,
//       lane = y * pitch + z; A (15, 2): shell-resolved stencil weights
//       A[s, j]; E (7, 2, 15): signed face corrections E[G, j, s];
//   2D: src block of one macro-face: (N, N) f32, lane = z; A (7, 2);
//       E (3, 2, 7) over the edge groups {x = 0}, {z = 0}, both.
#pragma once

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

constexpr int kConstDirs = 15;    // stencil directions (incl. 0)
constexpr int kConstGroups = 7;   // coordinate-face subsets G
constexpr int kConstShells = 2;   // j levels (one diagonal shell)

constexpr int kConst2Dirs = 7;    // 2D stencil directions (incl. 0)
constexpr int kConst2Groups = 3;  // 2D coordinate-edge subsets G

struct ConstTables {
  static constexpr int kDirs = kConstDirs, kGroups = kConstGroups;
  int dx[kConstDirs];             // x offset of direction s
  int dl[kConstDirs];             // lane offset dy * pitch + dz
  int gmask[kConstGroups];        // bit i set <=> coordinate i in G
};

struct ConstTables2D {
  static constexpr int kDirs = kConst2Dirs, kGroups = kConst2Groups;
  int gmask[kConst2Groups];       // bit 0: x = 0, bit 1: z = 0
};

// The 7 directions (dx, dz) of the 2D stencil in the order of
// micro.stencil_directions(2): (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1),
// (1, -1), (1, 0). Compile-time, so that each tap of an unrolled sum
// reads at a row pointer plus an immediate; the launcher refuses other
// tables.
HYTEG_HD constexpr int const2_dx(int s) { return s < 2 ? -1 : (s < 5 ? 0 : 1); }
HYTEG_HD constexpr int const2_dz(int s) {
  return s == 1 || s == 4 ? 1 : (s == 2 || s == 5 ? -1 : 0);
}

// The folded weight rows of the stencil, one per position class (f, sh):
// face set f (3D: bit 0 x == 0, bit 1 y == 0, bit 2 z == 0; 2D: bit 0
// x == 0, bit 1 z == 0) and shell flag sh = [S == n], row (f * 2 + sh):
//   c_s = A[s,0] + (1 - sh) A[s,1]
//         - sum_{G <= f} (E[G,0,s] + (1 - sh) E[G,1,s]),
// the groups subtracted in ascending order (row 0 is the interior row,
// row 1 the shell row off the faces). 16 rows of 15 in 3D, 8 of 7 in 2D.
// Computed once per thread block.
constexpr int kConstRows = 16;   // 8 face sets x 2 shell flags
constexpr int kConst2Rows = 8;   // 4 edge sets x 2 shell flags

template <class Tables>
HYTEG_DEVICE void const_fold_rows(const float* A, const float* E,
                                  const Tables& t, float* rows, int tid,
                                  int nthreads) {
  constexpr int kDirs = Tables::kDirs, kGroups = Tables::kGroups;
  for (int i = tid; i < 2 * (kGroups + 1) * kDirs; i += nthreads) {
    const int k = i / kDirs, s = i - k * kDirs;
    const int f = k >> 1, sh = k & 1;
    const float a0 = A[s * kConstShells], a1 = A[s * kConstShells + 1];
    float c = sh ? a0 : a0 + a1;
    for (int g = 0; g < kGroups; ++g) {
      if ((f & t.gmask[g]) != t.gmask[g]) continue;
      const float e0 = E[(g * kConstShells) * kDirs + s];
      const float e1 = E[(g * kConstShells + 1) * kDirs + s];
      c -= sh ? e0 : e0 + e1;
    }
    rows[i] = c;
  }
}

// dst at an in-tet slot (x, y, z) (S = x + y + z <= n), any position:
// sum_s c_s * src[p + s] over the 15 directions with the folded row of
// its class (const_fold_rows), the reads bounds-checked on x and on the
// flat lane axis and zero-filled beyond the block (the flat.shift_read
// semantics). The kernel's path for slots on a coordinate face.
template <class Src>
HYTEG_DEVICE float const_apply_point(const Src& src, int x, int y, int z,
                                     int N, int pitch, const ConstTables& t,
                                     const float* rows) {
  const int L = N * pitch;
  const int lane = y * pitch + z;
  const int f = (x == 0) | ((y == 0) << 1) | ((z == 0) << 2);
  const float* c = rows + (f * 2 + (x + y + z == N - 1)) * kConstDirs;
  float acc = 0.f;
  for (int s = 0; s < kConstDirs; ++s) {
    const int xs = x + t.dx[s];
    const int ls = lane + t.dl[s];
    float v = 0.f;
    if (xs >= 0 && xs < N && ls >= 0 && ls < L) v = src[xs * L + ls];
    acc = fmaf(c[s], v, acc);
  }
  return acc;
}

// dst at a slot off the coordinate faces (x, y, z >= 1, S <= n), w its
// folded row (row 0, or row 1 on the shell S == n), p pointing at it: all
// 15 neighbours lie in the block, on the slot's own lane row or the next
// ones, so no read is tested. The same terms in the same order as
// const_apply_point.
template <class Src>
HYTEG_DEVICE float const_apply_interior(const Src& p, const float* w,
                                        const ConstTables& t, int L) {
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < kConstDirs; ++s)
    acc = fmaf(w[s], p[t.dx[s] * L + t.dl[s]], acc);
  return acc;
}

// Every slot of plane x of one cell, each written once through out (i:
// the slot's offset in the cell, < N * L): a thread block's share of
// kernel B2, run by thread (warp, lane) of nwarps warps. Row (x, y) meets
// the tet in r = n + 1 - x - y slots, z < r; its lanes r <= z < pitch
// (padding lanes included) are a zero run (zero_run: no loads).
//  - Plane x = 0 is all coordinate face: warps take rows warp,
//    warp + nwarps, ..., each slot through const_apply_point.
//  - Else row y = 0 is face: its chunks of 32 slots go to the warps in
//    turn. Rows y = 1 + warp, 1 + warp + nwarps, ...: slots z = 1 .. r - 1
//    run const_apply_interior in chunks of 32 from z = 1, the last one
//    (the shell, S = n) on the shell row; their face slots z = 0 go
//    through const_apply_point as one list over all threads, so the row
//    chunks hold no face lane.
//  - Rows y > n - x lie past the tet: one zero run over all threads.
// rows: the 16 folded rows (const_fold_rows) in shared memory. All
// offsets are 32-bit: a cell holds N * L <= 2^31 slots.
template <class Src, class Out>
HYTEG_DEVICE void const_apply_plane(const Src& src, const Out& out, int x,
                                    int N, int pitch, const ConstTables& t,
                                    const float* rows, int warp, int lane,
                                    int nwarps) {
  const int L = N * pitch;
  const int ry = N - 1 - x;  // last row that meets the tet
  const int tid = warp * 32 + lane, nthreads = nwarps * 32;
  if (x == 0) {
    for (int y = warp; y <= ry; y += nwarps) {
      const int r = ry + 1 - y, row = y * pitch;
      for (int z = lane; z < r; z += 32)
        out(row + z, const_apply_point(src, 0, y, z, N, pitch, t, rows));
      zero_run(out, row + r, row + pitch, lane, 32);
    }
  } else {
    const int row0 = x * L;
    for (int z = warp * 32 + lane; z <= ry; z += nthreads)
      out(row0 + z, const_apply_point(src, x, 0, z, N, pitch, t, rows));
    zero_run(out, row0 + ry + 1, row0 + pitch, tid, nthreads);
    for (int y = 1 + warp; y <= ry; y += nwarps) {
      const int r = ry + 1 - y, row = x * L + y * pitch;
      for (int z = 1 + lane; z - lane <= r - 1; z += 32)
        if (z <= r - 1)
          out(row + z, const_apply_interior(
                           src + row + z, rows + (z == r - 1) * kConstDirs,
                           t, L));
      zero_run(out, row + r, row + pitch, lane, 32);
    }
    for (int y = 1 + tid; y <= ry; y += nthreads)
      out(x * L + y * pitch,
          const_apply_point(src, x, y, 0, N, pitch, t, rows));
  }
  zero_run(out, x * L + (ry + 1) * pitch, (x + 1) * L, tid, nthreads);
}

// dst at an in-triangle slot (x, z) (S = x + z <= n) of one macro-face,
// any position, the 2D form of const_apply_point: sum_s c_s * src[p + s]
// over the 7 directions with the folded row of its class (face bits
// [x == 0], [z == 0]; shell S == n), the reads bounds-checked on x and z
// and zero-filled beyond the block (flat.shift_read's 2D semantics). The
// 2D kernel's path for slots on an edge (row x = 0, column z = 0).
template <class Src>
HYTEG_DEVICE float const_apply_point_2d(Src src, int x, int z, int N,
                                        const float* rows) {
  const int f = (x == 0) | ((z == 0) << 1);
  const float* c = rows + (f * 2 + (x + z == N - 1)) * kConst2Dirs;
  float acc = 0.f;
  for (int s = 0; s < kConst2Dirs; ++s) {
    const int xs = x + const2_dx(s);
    const int zs = z + const2_dz(s);
    float v = 0.f;
    if (xs >= 0 && xs < N && zs >= 0 && zs < N) v = src[xs * N + zs];
    acc = fmaf(c[s], v, acc);
  }
  return acc;
}

// Rows x of a 2D thread block: one per warp.
constexpr int kBandRows2DP1 = kPlaneWarps;
// Chunks of 32 slots a lane takes at a time on a row, their loads all in
// flight before their stores.
constexpr int kChunks2DP1 = 2;

// Every slot of the band of rows x0 .. x0 + kBandRows2DP1 - 1 (those < N)
// of one face, each written once through out: a thread block's share of
// kernel B2's 2D form, run by thread (warp, lane) of nwarps warps, lanes
// on consecutive z. rows: the face's 8 folded rows (const_fold_rows) in
// shared memory. Row x meets the triangle in r = N - x slots, z < r.
//  - Row 0 is all edge: its chunks of 32 slots go to the warps in turn,
//    every slot through const_apply_point_2d. The other rows of the band
//    go to the warps one after another.
//  - Row x >= 1: lane 0 takes the edge slot z = 0 (const_apply_point_2d);
//    the slots z = 1 .. r - 1 run one unrolled 7-tap sum with no tests,
//    kChunks2DP1 chunks at a time, on the interior row, or the shell row
//    at z = r - 1 (S = n), read from shared memory at each tap (held in
//    registers, the 14 weights cost the kernel half its blocks per SM).
//    No tap leaves the block: z >= 1 and x + z <= n give x <= n - 1, and
//    x >= 1 gives z <= n - 1, so x + dx and z + dz lie in [0, n] for
//    every |dx|, |dz| <= 1. The same terms in the same order as
//    const_apply_point_2d.
//  - The slots z = r .. N - 1, past the triangle, are a store-only zero
//    run (zero_run: 16-byte stores, no loads).
// Rows x +- 1 are re-read by the warps of the band next to each other
// and hit L1; offsets are 32-bit (a face holds N * N <= 2^31 slots).
template <class Src, class Out>
HYTEG_DEVICE void const_apply_band_2d(Src src, const Out& out,
                                      int x0, int N, const float* rows,
                                      int warp, int lane, int nwarps) {
  const volatile float* vrows = rows;
  if (x0 == 0)
    for (int z = warp * 32 + lane; z < N; z += nwarps * 32)
      out(z, const_apply_point_2d(src, 0, z, N, rows));
  const int x1 = x0 + kBandRows2DP1 < N ? x0 + kBandRows2DP1 : N;
  for (int x = (x0 == 0 ? 1 : x0) + warp; x < x1; x += nwarps) {
    const int row = x * N, r = N - x;
    if (lane == 0) out(row, const_apply_point_2d(src, x, 0, N, rows));
    for (int z0 = 1; z0 <= r - 1; z0 += 32 * kChunks2DP1) {
      float acc[kChunks2DP1];
#pragma unroll
      for (int u = 0; u < kChunks2DP1; ++u) {
        const int z = z0 + lane + 32 * u;
        acc[u] = 0.f;
        if (z <= r - 1) {
          const auto p = src + (row + z);
          const volatile float* w = vrows + (z == r - 1) * kConst2Dirs;
#pragma unroll
          for (int s = 0; s < kConst2Dirs; ++s)
            acc[u] = fmaf(w[s], p[const2_dx(s) * N + const2_dz(s)], acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kChunks2DP1; ++u) {
        const int z = z0 + lane + 32 * u;
        if (z <= r - 1) out(row + z, acc[u]);
      }
    }
    zero_run(out, row + r, row + N, lane, 32);
  }
}

}  // namespace hyteg
