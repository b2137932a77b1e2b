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
//   2D (macro-faces): (M, M) node blocks, lane = z; W (48, 19), row
//   (f * 4 + par) * 3 + k with f = [x == 0] | [z == 0] << 1,
//   par = 2 (x&1) + (z&1), k = min(2, 2n - x - z).
#pragma once

#ifndef HYTEG_DEVICE
#define HYTEG_DEVICE __device__ __forceinline__
#endif

namespace hyteg {

constexpr int kP2Dirs = 65;   // node-grid stencil directions
constexpr int kP2Rows = 192;  // 8 face sets x 8 parities x 3 shell keys

constexpr int kP2Dirs2D = 19;  // 2D node-grid stencil directions
constexpr int kP2Rows2D = 48;  // 4 face sets x 4 parities x 3 shell keys

struct P2Tables {
  int dx[kP2Dirs];  // x offset of direction s
  int dl[kP2Dirs];  // flat lane offset dy * pitch + dz of direction s
};

struct P2Tables2D {
  int dx[kP2Dirs2D];  // x offset of direction s
  int dz[kP2Dirs2D];  // z (lane) offset of direction s
};

// True where (x, y, z) is a node of the tet (then also z < M).
HYTEG_DEVICE bool p2_inside(int x, int y, int z, int M) {
  return z < M && x + y + z <= M - 1;
}

// Weight row of an in-tet node.
HYTEG_DEVICE int p2_row(int x, int y, int z, int M) {
  const int f = (x == 0) | ((y == 0) << 1) | ((z == 0) << 2);
  const int par = ((x & 1) << 2) | ((y & 1) << 1) | (z & 1);
  const int k = M - 1 - (x + y + z);
  return (f * 8 + par) * 3 + (k < 2 ? k : 2);
}

// sum_s w[s] * src[x + dx[s], lane + dl[s]] for an in-tet node, the read
// taken as 0 beyond the block on the x axis and on the flat lane axis
// (flat.shift_read's rule); zero weights are skipped, their product
// being 0 for any finite read.
HYTEG_DEVICE float p2_point(const float* src, int x, int lane, int M, int L,
                            const P2Tables& t, const float* w) {
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < kP2Dirs; ++s) {
    const float ws = w[s];
    const int xx = x + t.dx[s];
    const int ll = lane + t.dl[s];
    if (ws != 0.f && xx >= 0 && xx < M && ll >= 0 && ll < L)
      acc += ws * src[(long long)xx * L + ll];
  }
  return acc;
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
