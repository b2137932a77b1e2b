// Per-point arithmetic of the parity-resolved P2 constant stencil (kernel
// B5), kept apart from the kernel in p2_const_stencil.cu like
// p1_const_stencil.cuh. Layout follows
// hyteg_tpu_torch/kernels/p2_const_stencil.py:
//   src and dst of one cell: (M, L) f32 node blocks, L = M * pitch,
//   lane = y * pitch + z, M = 2n + 1;
//   W of one cell: (192, 65) f32 folded weights, row
//   (f * 8 + par) * 3 + k for the node's face set f (bit i: coordinate i
//   is 0), parity par = 4 (x&1) + 2 (y&1) + (z&1) and shell key
//   k = min(2, 2n - x - y - z);
//   the rows off the coordinate faces (face set 0: rows par * 3 + k,
//   the first 24) are also staged apart;
//   2D (macro-faces): (M, M) node blocks, lane = z; W (48, 19), row
//   (f * 4 + par) * 3 + k with f = [x == 0] | [z == 0] << 1,
//   par = 2 (x&1) + (z&1), k = min(2, 2n - x - z).
#pragma once

#include <utility>

#include "plane.cuh"

#ifndef HYTEG_DEVICE
#define HYTEG_DEVICE __device__ __forceinline__
#endif

namespace hyteg {

constexpr int kP2Dirs = 65;   // node-grid stencil directions
constexpr int kP2Rows = 192;  // 8 face sets x 8 parities x 3 shell keys

constexpr int kP2Dirs2D = 19;  // 2D node-grid stencil directions
constexpr int kP2Rows2D = 48;  // 4 face sets x 4 parities x 3 shell keys

struct P2Tables2D {
  int dx[kP2Dirs2D];  // x offset of direction s
  int dz[kP2Dirs2D];  // z (lane) offset of direction s
};

// Weight row of an in-tet node (3D).
HYTEG_DEVICE int p2_row(int x, int y, int z, int M) {
  const int f = (x == 0) | ((y == 0) << 1) | ((z == 0) << 2);
  const int par = ((x & 1) << 2) | ((y & 1) << 1) | (z & 1);
  const int k = M - 1 - (x + y + z);
  return (f * 8 + par) * 3 + (k < 2 ? k : 2);
}

// The 65 node-grid directions (dx, dy, dz), in the order of
// kernels/p2_const_stencil.py::p2_stencil_tables(3), and for each parity
// the directions whose weight is structurally nonzero in some shell slot
// (_nz_tables(3)): 28.75 of 65 per node on average. Every node runs only
// these, unrolled at compile time: every other weight of any row of its
// parity is exactly 0.
constexpr int kP2DirList[kP2Dirs][3] = {
    {-2, 0, 0},  {-2, 0, 1},  {-2, 0, 2},  {-2, 1, -1}, {-2, 1, 0},
    {-2, 1, 1},  {-2, 2, -2}, {-2, 2, -1}, {-2, 2, 0},  {-1, -1, 0},
    {-1, -1, 1}, {-1, -1, 2}, {-1, 0, -1}, {-1, 0, 0},  {-1, 0, 1},
    {-1, 0, 2},  {-1, 1, -2}, {-1, 1, -1}, {-1, 1, 0},  {-1, 1, 1},
    {-1, 2, -2}, {-1, 2, -1}, {-1, 2, 0},  {0, -2, 0},  {0, -2, 1},
    {0, -2, 2},  {0, -1, -1}, {0, -1, 0},  {0, -1, 1},  {0, -1, 2},
    {0, 0, -2},  {0, 0, -1},  {0, 0, 0},   {0, 0, 1},   {0, 0, 2},
    {0, 1, -2},  {0, 1, -1},  {0, 1, 0},   {0, 1, 1},   {0, 2, -2},
    {0, 2, -1},  {0, 2, 0},   {1, -2, 0},  {1, -2, 1},  {1, -2, 2},
    {1, -1, -1}, {1, -1, 0},  {1, -1, 1},  {1, -1, 2},  {1, 0, -2},
    {1, 0, -1},  {1, 0, 0},   {1, 0, 1},   {1, 1, -2},  {1, 1, -1},
    {1, 1, 0},   {2, -2, 0},  {2, -2, 1},  {2, -2, 2},  {2, -1, -1},
    {2, -1, 0},  {2, -1, 1},  {2, 0, -2},  {2, 0, -1},  {2, 0, 0}};
constexpr int kP2NTaps[8] = {65, 27, 19, 27, 27, 19, 27, 19};
constexpr int kP2TapList[8][kP2Dirs] = {
    {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
     17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
     34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50,
     51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64},
    {1,  4,  7,  10, 13, 14, 17, 18, 21, 24, 27, 28, 31, 32,
     33, 36, 37, 40, 43, 46, 47, 50, 51, 54, 57, 60, 63},
    {4, 13, 14, 17, 18, 27, 28, 29, 31, 32, 33, 35, 36, 37, 46, 47, 50, 51,
     60},
    {3,  4,  5,  12, 13, 14, 17, 18, 19, 26, 27, 28, 31, 32,
     33, 36, 37, 38, 45, 46, 47, 50, 51, 52, 59, 60, 61},
    {13, 14, 15, 17, 18, 19, 20, 21, 22, 27, 28, 29, 31, 32,
     33, 35, 36, 37, 42, 43, 44, 45, 46, 47, 49, 50, 51},
    {12, 13, 14, 17, 18, 21, 27, 28, 31, 32, 33, 36, 37, 43, 46, 47, 50, 51,
     52},
    {9,  10, 11, 12, 13, 14, 16, 17, 18, 27, 28, 29, 31, 32,
     33, 35, 36, 37, 46, 47, 48, 50, 51, 52, 53, 54, 55},
    {10, 13, 14, 17, 18, 19, 27, 28, 31, 32, 33, 36, 37, 45, 46, 47, 50, 51,
     54}};

// Tap I of parity PAR as compile-time constants: its direction index s
// and the direction (dx, dy, dz).
template <int PAR, int I>
struct P2Tap {
  static constexpr int s = kP2TapList[PAR][I];
  static constexpr int dx = kP2DirList[s][0];
  static constexpr int dy = kP2DirList[s][1];
  static constexpr int dz = kP2DirList[s][2];
};

// w is read at each use (volatile): hoisted out of the row loop, the 92
// weights of a parity pair would pin 92 registers for the kernel's life.
template <int PAR, int... I>
HYTEG_DEVICE float p2_interior_taps(const float* p, int L, int pitch,
                                    const volatile float* w,
                                    std::integer_sequence<int, I...>) {
  float acc = 0.f;
  ((acc += w[P2Tap<PAR, I>::s] *
           p[P2Tap<PAR, I>::dx * L + P2Tap<PAR, I>::dy * pitch +
             P2Tap<PAR, I>::dz]),
   ...);
  return acc;
}

// One tap of a face node at (x, lane), skipped where its weight is 0, the
// read taken as 0 beyond the block on the x axis and on the flat lane axis
// (flat.shift_read's rule).
template <int PAR, int I>
HYTEG_DEVICE void p2_face_tap(float& acc, const float* src, int x, int lane,
                              int M, int L, int pitch, const float* w) {
  using T = P2Tap<PAR, I>;
  const float ws = w[T::s];
  const int xx = x + T::dx, ll = lane + T::dy * pitch + T::dz;
  if (ws != 0.f && xx >= 0 && xx < M && ll >= 0 && ll < L)
    acc += ws * src[xx * L + ll];
}

template <int PAR, int... I>
HYTEG_DEVICE float p2_face_taps(const float* src, int x, int lane, int M,
                                int L, int pitch, const float* w,
                                std::integer_sequence<int, I...>) {
  float acc = 0.f;
  (p2_face_tap<PAR, I>(acc, src, x, lane, M, L, pitch, w), ...);
  return acc;
}

// dst at an in-tet node on a coordinate face (x, y or z is 0), on its own
// row of the cell's W (Wc): the sum over the node's parity's structural
// taps, the only directions where any row of that parity can be nonzero
// (the face corrections E add none), each read tested. Lanes of one
// parity run one unrolled list; the parity is a runtime switch, uniform
// across a warp wherever the walk keeps it so.
HYTEG_DEVICE float p2_face_point(const float* src, int x, int y, int z, int M,
                                 int pitch, const float* Wc) {
  const int L = M * pitch, lane = y * pitch + z;
  const float* w = Wc + p2_row(x, y, z, M) * kP2Dirs;
#define HYTEG_P2_FACE(P)                                          \
  case P:                                                         \
    return p2_face_taps<P>(src, x, lane, M, L, pitch, w,          \
                           std::make_integer_sequence<int, kP2NTaps[P]>{});
  switch (((x & 1) << 2) | ((y & 1) << 1) | (z & 1)) {
    HYTEG_P2_FACE(0) HYTEG_P2_FACE(1) HYTEG_P2_FACE(2) HYTEG_P2_FACE(3)
    HYTEG_P2_FACE(4) HYTEG_P2_FACE(5) HYTEG_P2_FACE(6)
    default:
      return p2_face_taps<7>(src, x, lane, M, L, pitch, w,
                             std::make_integer_sequence<int, kP2NTaps[7]>{});
  }
#undef HYTEG_P2_FACE
}

// The face nodes z = z0 .. r - 1 of row (x, y) (x or y is 0) from its
// offset row, shared by nlanes threads (this one is lane): each thread
// takes the pair 2 lane, 2 lane + 1 of a stride of 2 nlanes, one node
// after the other, so that at each step the lanes hold one parity.
template <class Out>
HYTEG_DEVICE void p2_face_row(const float* src, const float* Wc,
                              const Out& out, int x, int y, int row, int r,
                              int M, int pitch, int lane, int nlanes) {
  for (int z = 2 * lane; z < r; z += 2 * nlanes) {
    out(row + z, p2_face_point(src, x, y, z, M, pitch, Wc));
    if (z + 1 < r)
      out(row + z + 1, p2_face_point(src, x, y, z + 1, M, pitch, Wc));
  }
}

// dst at a node of parity PAR off the coordinate faces (x, y, z >= 1, any
// shell key), p pointing at it, w at its row: the parity's structural
// taps in ascending s (the row's other weights are exactly 0). Such a
// node's taps all land in [0, M)^3, on its own lane row or the next ones
// (an odd coordinate moves by at most 1, an even one, then >= 2, by at
// most 2, and S <= M - 1 with y, z >= 1 bounds x + 2), so no read is
// tested.
template <int PAR>
HYTEG_DEVICE float p2_interior_node(const float* p, int L, int pitch,
                                    const volatile float* w) {
  return p2_interior_taps<PAR>(p, L, pitch, w,
                               std::make_integer_sequence<int, kP2NTaps[PAR]>{});
}

// The nodes z = 1 .. r - 1 of row (x, y), x, y >= 1, with parities
// PX = x & 1 and PY = y & 1 (the row starts at offset row): lane l of a
// warp takes the node pair za = z0 + 2 l (odd z) and zb = za + 1 (even z),
// z0 = 1, 65, ..., so the pair's two parity lists are the same for the
// whole warp; a node's shell key k = min(2, r - 1 - z) picks its row in
// wr (the staged rows par * 3 + k).
template <int PX, int PY, class Out>
HYTEG_DEVICE void p2_interior_row(const float* src, const float* wr,
                                  const Out& out, int row, int r, int L,
                                  int pitch, int lane) {
  constexpr int pa = 4 * PX + 2 * PY + 1, pb = pa - 1;
  for (int z0 = 1; z0 <= r - 1; z0 += 64) {
    const int za = z0 + 2 * lane, zb = za + 1;
    if (za <= r - 1) {
      const int k = r - 1 - za < 2 ? r - 1 - za : 2;
      out(row + za, p2_interior_node<pa>(src + row + za, L, pitch,
                                         wr + (pa * 3 + k) * kP2Dirs));
    }
    if (zb <= r - 1) {
      const int k = r - 1 - zb < 2 ? r - 1 - zb : 2;
      out(row + zb, p2_interior_node<pb>(src + row + zb, L, pitch,
                                         wr + (pb * 3 + k) * kP2Dirs));
    }
  }
}

// Every node of plane x of one cell, each written once through out: a
// thread block's share of kernel B5, run by thread (warp, lane) of nwarps
// warps. Wc: the cell's 192 x 65 rows; wr: its first 24 (face set 0),
// staged. Row (x, y) meets the tet in r = M - x - y nodes, z < r; its
// lanes r <= z < pitch are a zero run (zero_run: no loads).
//  - Plane x = 0 is all coordinate face: warps take rows warp,
//    warp + nwarps, ..., through p2_face_row.
//  - Else row y = 0 is face: p2_face_row over all threads. The other rows
//    go to the warps in pairs of one odd and one even y (1 + 2 warp and
//    2 + 2 warp, then on by 2 nwarps: at even x an even-y row's pairs take
//    92 taps and an odd-y row's 46, so each warp gets both) and run
//    p2_interior_row on z >= 1, one of four compile-time cases by
//    (x & 1, y & 1); their face nodes z = 0 go through p2_face_point as
//    one list over all threads.
//  - Rows y > M - 1 - x lie past the tet: one zero run over all threads.
template <class Out>
HYTEG_DEVICE void p2_const_apply_plane(const float* src, const float* Wc,
                                       const float* wr, const Out& out, int x,
                                       int M, int pitch, int warp, int lane,
                                       int nwarps) {
  const int L = M * pitch;
  const int ry = M - 1 - x;  // last row that meets the tet
  const int tid = warp * 32 + lane, nthreads = nwarps * 32;
  if (x == 0) {
    for (int y = warp; y <= ry; y += nwarps) {
      const int r = ry + 1 - y, row = y * pitch;
      p2_face_row(src, Wc, out, 0, y, row, r, M, pitch, lane, 32);
      zero_run(out, row + r, row + pitch, lane, 32);
    }
  } else {
    const int row0 = x * L;
    p2_face_row(src, Wc, out, x, 0, row0, ry + 1, M, pitch, tid, nthreads);
    zero_run(out, row0 + ry + 1, row0 + pitch, tid, nthreads);
    for (int y0 = 1 + 2 * warp; y0 <= ry; y0 += 2 * nwarps)
      for (int y = y0; y <= y0 + 1 && y <= ry; ++y) {
        const int r = ry + 1 - y, row = x * L + y * pitch;
        switch (((x & 1) << 1) | (y & 1)) {
          case 0: p2_interior_row<0, 0>(src, wr, out, row, r, L, pitch, lane); break;
          case 1: p2_interior_row<0, 1>(src, wr, out, row, r, L, pitch, lane); break;
          case 2: p2_interior_row<1, 0>(src, wr, out, row, r, L, pitch, lane); break;
          default: p2_interior_row<1, 1>(src, wr, out, row, r, L, pitch, lane);
        }
        zero_run(out, row + r, row + pitch, lane, 32);
      }
    // the face nodes z = 0 of rows 1 .. ry, odd y first, then even y, so
    // that a warp's lanes mostly share a parity
    const int n_odd = (ry + 1) >> 1;
    for (int k = tid; k < ry; k += nthreads) {
      const int y = k < n_odd ? 1 + 2 * k : 2 + 2 * (k - n_odd);
      out(x * L + y * pitch, p2_face_point(src, x, y, 0, M, pitch, Wc));
    }
  }
  zero_run(out, x * L + (ry + 1) * pitch, (x + 1) * L, tid, nthreads);
}

// Weight row of an in-triangle node of a 2D block (x + z <= M - 1).
HYTEG_DEVICE int p2_row_2d(int x, int z, int M) {
  const int f = (x == 0) | ((z == 0) << 1);
  const int par = ((x & 1) << 1) | (z & 1);
  const int k = M - 1 - (x + z);
  return (f * 4 + par) * 3 + (k < 2 ? k : 2);
}

// dst[x, z] of one face: 0 outside the triangle, else sum_s w[row, s] *
// src[x + dx[s], z + dz[s]] over the row of the node's class (w points at
// the cell's 48 x 19 rows), reads zero beyond the block on x and z.
HYTEG_DEVICE float p2_point_2d(const float* src, int x, int z, int M,
                               const P2Tables2D& t, const float* W) {
  if (x + z > M - 1) return 0.f;
  const float* w = W + p2_row_2d(x, z, M) * kP2Dirs2D;
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < kP2Dirs2D; ++s) {
    const float ws = w[s];
    const int xx = x + t.dx[s];
    const int zz = z + t.dz[s];
    if (ws != 0.f && xx >= 0 && xx < M && zz >= 0 && zz < M)
      acc += ws * src[(long long)xx * M + zz];
  }
  return acc;
}

}  // namespace hyteg
