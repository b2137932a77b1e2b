// Per-point arithmetic of the parity-resolved P2 constant stencil (kernel
// B5), kept apart from the kernel in p2_const_stencil.cu like
// p1_const_stencil.cuh. The walks take the source as a template parameter
// Src, read as src[i] -> float (and src + k): a plain const float* for
// f32 storage, or an object that widens bf16 storage on each load (the
// kernel's BF16Src; the host tests' own), which also offers the 2D pair
// loads (load2, pair_parity). The 3D face nodes read their weight rows
// through a parameter of the same kind (f32 or bf16 W). Weights staged in
// shared memory and every sum stay f32, so a bf16 result is rounded once,
// on its store. Layout follows
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
#ifndef HYTEG_HD
#ifdef __CUDACC__
#define HYTEG_HD __host__ __device__
#else
#define HYTEG_HD
#endif
#endif
// A host harness may define it to check each pair load's address.
#ifndef HYTEG_PAIR_LOAD_HOOK
#define HYTEG_PAIR_LOAD_HOOK(q)
#endif

namespace hyteg {

constexpr int kP2Dirs = 65;   // node-grid stencil directions
constexpr int kP2Rows = 192;  // 8 face sets x 8 parities x 3 shell keys

constexpr int kP2Dirs2D = 19;  // 2D node-grid stencil directions
constexpr int kP2Rows2D = 48;  // 4 face sets x 4 parities x 3 shell keys

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
template <int PAR, class Src, int... I>
HYTEG_DEVICE float p2_interior_taps(Src p, int L, int pitch,
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
template <int PAR, int I, class Src, class Wt>
HYTEG_DEVICE void p2_face_tap(float& acc, Src src, int x, int lane,
                              int M, int L, int pitch, Wt w) {
  using T = P2Tap<PAR, I>;
  const float ws = w[T::s];
  const int xx = x + T::dx, ll = lane + T::dy * pitch + T::dz;
  if (ws != 0.f && xx >= 0 && xx < M && ll >= 0 && ll < L)
    acc += ws * src[xx * L + ll];
}

template <int PAR, class Src, class Wt, int... I>
HYTEG_DEVICE float p2_face_taps(Src src, int x, int lane, int M,
                                int L, int pitch, Wt w,
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
template <class Src, class Wt>
HYTEG_DEVICE float p2_face_point(Src src, int x, int y, int z, int M,
                                 int pitch, Wt Wc) {
  const int L = M * pitch, lane = y * pitch + z;
  const auto w = Wc + p2_row(x, y, z, M) * kP2Dirs;
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
template <class Src, class Wt, class Out>
HYTEG_DEVICE void p2_face_row(Src src, Wt Wc,
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
template <int PAR, class Src>
HYTEG_DEVICE float p2_interior_node(Src p, int L, int pitch,
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
template <int PX, int PY, class Src, class Out>
HYTEG_DEVICE void p2_interior_row(Src src, const float* wr,
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
template <class Src, class Wt, class Out>
HYTEG_DEVICE void p2_const_apply_plane(Src src, Wt Wc,
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

// ---------------------------------------------------------------------------
// 2D (macro-faces): the (M, M) block of one face, lane = z, the triangle
// x + z <= M - 1.
// ---------------------------------------------------------------------------

// The 19 node-grid directions (dx, dz), in the order of
// kernels/p2_const_stencil.py::p2_stencil_tables(2), and for each parity
// par = 2 (x&1) + (z&1) the directions whose weight is structurally
// nonzero in some shell slot (_nz_tables(2)): 19, 9, 9, 9. No face
// correction adds a direction, so every weight of any row of a parity off
// its list is exactly 0.
constexpr int kP2DirList2D[kP2Dirs2D][2] = {
    {-2, 0}, {-2, 1}, {-2, 2}, {-1, -1}, {-1, 0}, {-1, 1}, {-1, 2},
    {0, -2}, {0, -1}, {0, 0},  {0, 1},   {0, 2},  {1, -2}, {1, -1},
    {1, 0},  {1, 1},  {2, -2}, {2, -1},  {2, 0}};
constexpr int kP2NTaps2D[4] = {19, 9, 9, 9};
constexpr int kP2TapList2D[4][kP2Dirs2D] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18},
    {1, 4, 5, 8, 9, 10, 13, 14, 17},
    {4, 5, 6, 8, 9, 10, 12, 13, 14},
    {3, 4, 5, 8, 9, 10, 13, 14, 15}};
constexpr int kBandRows2D = 2 * kPlaneWarps;  // rows x of a thread block

// Tap I of parity PAR in 2D as compile-time constants.
template <int PAR, int I>
struct P2Tap2D {
  static constexpr int s = kP2TapList2D[PAR][I];
  static constexpr int dx = kP2DirList2D[s][0];
  static constexpr int dz = kP2DirList2D[s][1];
};

// The weights of parity PAR's taps, in list order, from one row of 19.
template <int PAR>
struct P2Weights2D {
  float v[kP2NTaps2D[PAR]];
};

template <int PAR, int... I>
HYTEG_DEVICE P2Weights2D<PAR> p2_weights_2d(const float* row,
                                            std::integer_sequence<int, I...>) {
  return P2Weights2D<PAR>{{row[P2Tap2D<PAR, I>::s]...}};
}

template <int PAR>
HYTEG_DEVICE P2Weights2D<PAR> p2_weights_2d(const float* row) {
  return p2_weights_2d<PAR>(row,
                            std::make_integer_sequence<int, kP2NTaps2D[PAR]>{});
}

// Parity PAR's taps, untested, at the node p points at (row stride M),
// in ascending s.
template <int PAR, class Src, int... I>
HYTEG_DEVICE float p2_taps_2d(Src p, int M, const P2Weights2D<PAR>& w,
                              std::integer_sequence<int, I...>) {
  float acc = 0.f;
  ((acc += w.v[I] * p[P2Tap2D<PAR, I>::dx * M + P2Tap2D<PAR, I>::dz]), ...);
  return acc;
}

// dst at a node of parity PAR off the faces (x, z >= 1, x + z <= M - 1,
// any shell key), p pointing at it, w its row's weights. Every tap lands
// in [0, M)^2, so no read is tested:
//  - low side: an odd coordinate moves by at most 1 (no list of an odd-x
//    parity, 2 and 3, holds dx = -2; none of an odd-z one, 1 and 3, holds
//    dz = -2), and an even coordinate that is >= 1 is >= 2;
//  - high side: z >= 1 gives x <= M - 2, and x >= 1 gives z <= M - 2, so
//    a move by 1 stays inside. A move by +2 occurs on x only at even x
//    (parities 0, 1), and then z >= 1 gives x <= M - 2, which is odd
//    (M is odd): x <= M - 3. A move by +2 on z occurs only at even z
//    (parities 0, 2): likewise z <= M - 3.
template <int PAR, class Src>
HYTEG_DEVICE float p2_interior_node_2d(Src p, int M,
                                       const P2Weights2D<PAR>& w) {
  return p2_taps_2d<PAR>(p, M, w,
                         std::make_integer_sequence<int, kP2NTaps2D[PAR]>{});
}

// One tap of a face node at (x, z), skipped where its weight is 0, the
// read taken as 0 beyond the block (flat.shift_read's rule).
template <int PAR, int I, class Src>
HYTEG_DEVICE void p2_face_tap_2d(float& acc, Src src, int x, int z,
                                 int M, const float* w) {
  using T = P2Tap2D<PAR, I>;
  const float ws = w[T::s];
  const int xx = x + T::dx, zz = z + T::dz;
  if (ws != 0.f && xx >= 0 && xx < M && zz >= 0 && zz < M)
    acc += ws * src[xx * M + zz];
}

template <int PAR, class Src, int... I>
HYTEG_DEVICE float p2_face_taps_2d(Src src, int x, int z, int M,
                                   const float* w,
                                   std::integer_sequence<int, I...>) {
  float acc = 0.f;
  (p2_face_tap_2d<PAR, I>(acc, src, x, z, M, w), ...);
  return acc;
}

// dst at an in-triangle node on a face (x or z is 0) of the face block
// src, on its own row of the face's 48 (W): row (f * 4 + par) * 3 + k,
// f = [x == 0] | [z == 0] << 1, k = min(2, M - 1 - x - z); the sum over
// the parity's structural taps, each read tested.
template <class Src>
HYTEG_DEVICE float p2_face_point_2d(Src src, int x, int z, int M,
                                    const float* W) {
  const int f = (x == 0) | ((z == 0) << 1);
  const int par = ((x & 1) << 1) | (z & 1);
  const int k = M - 1 - x - z < 2 ? M - 1 - x - z : 2;
  const float* w = W + ((f * 4 + par) * 3 + k) * kP2Dirs2D;
#define HYTEG_P2_FACE_2D(P)                                  \
  case P:                                                    \
    return p2_face_taps_2d<P>(src, x, z, M, w,               \
                              std::make_integer_sequence<int, kP2NTaps2D[P]>{});
  switch (par) {
    HYTEG_P2_FACE_2D(0) HYTEG_P2_FACE_2D(1) HYTEG_P2_FACE_2D(2)
    default:
      return p2_face_taps_2d<3>(src, x, z, M, w,
                                std::make_integer_sequence<int, kP2NTaps2D[3]>{});
  }
#undef HYTEG_P2_FACE_2D
}

// -- the node pair's row windows (2D) ---------------------------------------
// A lane's pair (za odd, zb = za + 1) of row x needs, of row x + dx, the
// elements za + dz for each tap (dx, dz) of za's parity list and
// za + 1 + dz for each of zb's: one window [lo, hi] relative to za. The
// window is read with 8-byte pair loads from the first element at an
// 8-byte boundary at or before za + lo, so at most one element more on
// each side. Whether za + lo is at such a boundary is a compile-time
// case: A = the parity of the address of (x, za) in slots of the storage
// type (p2_pair_parity), the same for every lane and chunk of the row (M
// and z0 are odd, lanes step by 2). The windows count elements, so one
// rule serves both types: a pair is 8 bytes in f32 and 4 in bf16.

// lo (hi == false) or hi of the pair's window in row x + dx, PX = x & 1;
// lo > hi when neither list has a tap with that dx.
template <int PX>
HYTEG_HD constexpr int p2_pair_reach_2d(int dx, bool hi) {
  int r = hi ? -99 : 99;
  for (int side = 0; side < 2; ++side) {
    const int par = 2 * PX + 1 - side;  // za's list, then zb's
    for (int i = 0; i < kP2NTaps2D[par]; ++i) {
      const int s = kP2TapList2D[par][i];
      const int d = kP2DirList2D[s][1] + side;
      if (kP2DirList2D[s][0] == dx && (hi ? d > r : d < r)) r = d;
    }
  }
  return r;
}

template <int PX, int A, int DX>
struct P2Window2D {
  static constexpr int lo = p2_pair_reach_2d<PX>(DX, false);
  static constexpr int hi = p2_pair_reach_2d<PX>(DX, true);
  // first element read, at an 8-byte boundary; n pair loads
  static constexpr int start = ((A + DX + lo) & 1) ? lo - 1 : lo;
  static constexpr int n = (hi - start) / 2 + 1;
};

struct P2Pair {
  float a, b;
};

// Two floats from an 8-byte boundary (one 8-byte load on the card).
HYTEG_DEVICE P2Pair p2_load_pair(const float* q) {
  HYTEG_PAIR_LOAD_HOOK(q);
#ifdef __CUDACC__
  const float2 t = *reinterpret_cast<const float2*>(q);
  return {t.x, t.y};
#else
  return {q[0], q[1]};
#endif
}

// Two elements of a widening source from a pair boundary (bf16: one
// 4-byte load), widened.
template <class Src>
HYTEG_DEVICE P2Pair p2_load_pair(Src q) {
  HYTEG_PAIR_LOAD_HOOK(q.p);
  const auto t = q.load2();
  return {t.x, t.y};
}

// 0 where a pair load may start at q (f32: an 8-byte boundary), else 1.
HYTEG_DEVICE int p2_pair_parity(const float* q) {
  return (int)((reinterpret_cast<uintptr_t>(q) >> 2) & 1);
}
template <class Src>
HYTEG_DEVICE int p2_pair_parity(Src q) {
  return q.pair_parity();
}

// acc += the taps of list PAR with dx == DX, v holding row x + DX from
// element (za + OFF) on.
template <int PAR, int DX, int OFF, int I>
HYTEG_DEVICE void p2_window_tap(float& acc, const float* v,
                                const P2Weights2D<PAR>& w) {
  if constexpr (P2Tap2D<PAR, I>::dx == DX)
    acc += w.v[I] * v[P2Tap2D<PAR, I>::dz - OFF];
}

template <int PAR, int DX, int OFF, int... I>
HYTEG_DEVICE void p2_window_taps(float& acc, const float* v,
                                 const P2Weights2D<PAR>& w,
                                 std::integer_sequence<int, I...>) {
  (p2_window_tap<PAR, DX, OFF, I>(acc, v, w), ...);
}

// The pair's taps in row x + DX from its window.
template <int PX, int A, int DX, class Src>
HYTEG_DEVICE void p2_pair_dx_2d(Src p, int M,
                                const P2Weights2D<2 * PX + 1>& wa,
                                const P2Weights2D<2 * PX>& wb, float& acc_a,
                                float& acc_b) {
  using Win = P2Window2D<PX, A, DX>;
  if constexpr (Win::lo <= Win::hi) {
    constexpr int pa = 2 * PX + 1, pb = 2 * PX;
    float v[2 * Win::n];
    const auto q = p + (DX * M + Win::start);
#pragma unroll
    for (int k = 0; k < Win::n; ++k) {
      const P2Pair t = p2_load_pair(q + 2 * k);
      v[2 * k] = t.a;
      v[2 * k + 1] = t.b;
    }
    p2_window_taps<pa, DX, Win::start>(
        acc_a, v, wa, std::make_integer_sequence<int, kP2NTaps2D[pa]>{});
    p2_window_taps<pb, DX, Win::start - 1>(
        acc_b, v, wb, std::make_integer_sequence<int, kP2NTaps2D[pb]>{});
  }
}

// dst at the pair za, za + 1 (both off the faces, shell key 2), p
// pointing at za: rows x - 2 .. x + 2 each through its window, the taps
// of each node in ascending s (the lists are ordered by dx first).
template <int PX, int A, class Src>
HYTEG_DEVICE P2Pair p2_pair_2d(Src p, int M,
                               const P2Weights2D<2 * PX + 1>& wa,
                               const P2Weights2D<2 * PX>& wb) {
  float acc_a = 0.f, acc_b = 0.f;
  p2_pair_dx_2d<PX, A, -2>(p, M, wa, wb, acc_a, acc_b);
  p2_pair_dx_2d<PX, A, -1>(p, M, wa, wb, acc_a, acc_b);
  p2_pair_dx_2d<PX, A, 0>(p, M, wa, wb, acc_a, acc_b);
  p2_pair_dx_2d<PX, A, 1>(p, M, wa, wb, acc_a, acc_b);
  p2_pair_dx_2d<PX, A, 2>(p, M, wa, wb, acc_a, acc_b);
  return {acc_a, acc_b};
}

// The nodes z = 1 .. r - 1 of row x >= 1 (r = M - x), PX = x & 1, A the
// pair parity of src's (x, 1) (p2_pair_parity), the row starting at
// offset row: lane l of the warp takes the node pair za = z0 + 2 l (odd
// z) and zb = za + 1 (even z), z0 = 1, 65, ..., so the warp needs the two
// parity lists pa = 2 PX + 1 and pb = 2 PX only. The shell-key-2 rows of
// both (W off the faces, rows par * 3 + 2) are held in registers for the
// whole row. A pair with both nodes at shell key 2 (zb <= r - 3) reads
// its rows through pair windows (p2_pair_2d) and is stored with one
// pair store (8 bytes in f32, 4 in bf16) where (x, za) of dst is at a
// pair boundary (Out::to_aligned even); the nodes
// at shell keys 1 and 0 (the last two) run p2_interior_node_2d on their
// rows of W.
template <int PX, int A, class Src, class Out>
HYTEG_DEVICE void p2_interior_row_2d(Src src, const float* W,
                                     const Out& out, int row, int r, int M,
                                     int lane) {
  constexpr int pa = 2 * PX + 1, pb = 2 * PX;
  const P2Weights2D<pa> wa = p2_weights_2d<pa>(W + (pa * 3 + 2) * kP2Dirs2D);
  const P2Weights2D<pb> wb = p2_weights_2d<pb>(W + (pb * 3 + 2) * kP2Dirs2D);
  const bool pair_store = out.to_aligned(row + 1) % 2 == 0;
  for (int z0 = 1; z0 < r; z0 += 64) {
    const int za = z0 + 2 * lane, zb = za + 1;
    if (zb < r - 2) {
      const P2Pair y = p2_pair_2d<PX, A>(src + row + za, M, wa, wb);
      if (pair_store) {
        out.pair(row + za, y.a, y.b);
      } else {
        out(row + za, y.a);
        out(row + zb, y.b);
      }
      continue;
    }
    if (za < r)
      out(row + za, p2_interior_node_2d<pa>(
                        src + row + za, M,
                        za < r - 2 ? wa : p2_weights_2d<pa>(
                            W + (pa * 3 + r - 1 - za) * kP2Dirs2D)));
    if (zb < r)
      out(row + zb, p2_interior_node_2d<pb>(
                        src + row + zb, M,
                        p2_weights_2d<pb>(W + (pb * 3 + r - 1 - zb) * kP2Dirs2D)));
  }
}

// Every slot of rows x0 .. x0 + kBandRows2D - 1 (those < M) of one face,
// each written once through out: a thread block's share of kernel B5's
// 2D form, run by thread (warp, lane) of kPlaneWarps warps. W: the face's
// 48 x 19 rows (staged in shared memory by the kernel). Warp w takes the
// rows x0 + 2 w (even) and x0 + 2 w + 1 (odd), so each warp runs one
// 28-tap and one 18-tap pair list (x0 is even).
//  - Row 0 is all face: its nodes go through p2_face_point_2d in pairs
//    (2 lane, 2 lane + 1 of a stride of 64), one node after the other so
//    that at each step the lanes hold one parity.
//  - Row x >= 1 meets the triangle in r = M - x nodes: lane 0 takes the
//    face node z = 0, p2_interior_row_2d the nodes z = 1 .. r - 1 (one of
//    four compile-time cases by x & 1 and the row's alignment A), and the
//    slots z = r .. M - 1 are a store-only zero run (zero_run).
template <class Src, class Out>
HYTEG_DEVICE void p2_const_apply_band_2d(Src src, const float* W,
                                         const Out& out, int x0, int M,
                                         int warp, int lane) {
  for (int x = x0 + 2 * warp; x <= x0 + 2 * warp + 1 && x < M; ++x) {
    const int row = x * M, r = M - x;
    if (x == 0) {
      for (int z = 2 * lane; z < M; z += 64) {
        out(z, p2_face_point_2d(src, 0, z, M, W));
        if (z + 1 < M) out(z + 1, p2_face_point_2d(src, 0, z + 1, M, W));
      }
      continue;
    }
    if (lane == 0) out(row, p2_face_point_2d(src, x, 0, M, W));
    const int A = p2_pair_parity(src + (row + 1));
    switch (((x & 1) << 1) | A) {
      case 0: p2_interior_row_2d<0, 0>(src, W, out, row, r, M, lane); break;
      case 1: p2_interior_row_2d<0, 1>(src, W, out, row, r, M, lane); break;
      case 2: p2_interior_row_2d<1, 0>(src, W, out, row, r, M, lane); break;
      default: p2_interior_row_2d<1, 1>(src, W, out, row, r, M, lane);
    }
    zero_run(out, row + r, row + M, lane, 32);
  }
}

}  // namespace hyteg
