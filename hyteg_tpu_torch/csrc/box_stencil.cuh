// The thread walk and arithmetic of the box 15-point stencil apply
// (kernel B1).
//
// Kept apart from the kernel in box_stencil.cu so that a host harness can
// run each thread's whole walk (box_apply_thread): the kernel only binds
// threads and blocks to it and picks the storage type. Layout and
// weights follow
// hyteg_tpu_torch/kernels/box_stencil.py:
//   u block: (X, L), L = Y * Z, lane = y * Z + z;
//   w (3, 15, L) f32: row class c (0 interior rows, 1 row 0, 2 row X-1),
//   direction s, lane.
#pragma once

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

constexpr int kBoxDirs = 15;  // the monotone cube diagonals, incl. 0

// Direction s in the order of structured/kuhn.py::stencil_dirs (sorted):
// s = 7 is 0; s > 7 has the bits of k = s - 7 as (dx, dy, dz) =
// (bit 2, bit 1, bit 0); s < 7 is the negation of direction 14 - s.
HYTEG_DEVICE int box_dir(int s, int axis) {
  const int k = s >= 7 ? s - 7 : 7 - s;
  const int bit = (k >> (2 - axis)) & 1;
  return s >= 7 ? bit : -bit;
}

// Row class of row x: 1 for row 0, 2 for row X-1, else 0.
HYTEG_DEVICE int box_row_class(int x, int X) {
  return x == 0 ? 1 : (x == X - 1 ? 2 : 0);
}

// The 15 weights of row class c at one lane.
template <class LoadW>
HYTEG_DEVICE void box_load_weights(const LoadW& load_w, float (&w)[kBoxDirs],
                                   int c, int lane, int L) {
#pragma unroll
  for (int s = 0; s < kBoxDirs; ++s)
    w[s] = load_w((long long)(c * kBoxDirs + s) * L + lane);
}

// What a lane reads of one row: the values at lane offsets 0, +1, +Z,
// +Z+1, -1, -Z, -Z-1 (row x of a point uses all seven, row x + 1 the
// first four, row x - 1 the first and the last three); 0 where the
// offset leaves [0, L) or the row leaves [0, X).
struct BoxRow {
  float c, p1, pz, pz1, m1, mz, mz1;
};

// Which of a lane's six offsets stay in [0, L): fixed for its whole walk.
struct BoxLane {
  int lane;
  bool p1, pz, pz1, m1, mz, mz1;
  HYTEG_DEVICE BoxLane(int l, int L, int Z)
      : lane(l), p1(l + 1 < L), pz(l + Z < L), pz1(l + Z + 1 < L),
        m1(l >= 1), mz(l >= Z), mz1(l >= Z + 1) {}
};

template <class Load>
HYTEG_DEVICE BoxRow box_load_row(const Load& load, const BoxLane& ln, int r,
                                 int X, int L, int Z) {
  BoxRow v{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (r >= 0 && r < X) {
    const long long i = (long long)r * L + ln.lane;
    v.c = load(i);
    if (ln.p1) v.p1 = load(i + 1);
    if (ln.pz) v.pz = load(i + Z);
    if (ln.pz1) v.pz1 = load(i + Z + 1);
    if (ln.m1) v.m1 = load(i - 1);
    if (ln.mz) v.mz = load(i - Z);
    if (ln.mz1) v.mz1 = load(i - Z - 1);
  }
  return v;
}

// y[x, lane] = sum_s w[s] * u[x + dx_s, lane + dy_s * Z + dz_s] from the
// lane's reads of rows x - 1 (a), x (b) and x + 1 (c), f32 weights and an
// f32 accumulator, in the order s = 0 .. 14 of box_dir (s < 7: the
// negated monotone directions, -(dx, dy, dz) with the bits of 7 - s;
// s = 7: the point; s > 7: the bits of s - 7). Reads outside the block
// are 0 (box_load_row).
HYTEG_DEVICE float box_sum(const float (&w)[kBoxDirs], const BoxRow& a,
                           const BoxRow& b, const BoxRow& c) {
  float acc = 0.f;
  acc = fmaf(w[0], a.mz1, acc);  // (-1, -1, -1)
  acc = fmaf(w[1], a.mz, acc);   // (-1, -1,  0)
  acc = fmaf(w[2], a.m1, acc);   // (-1,  0, -1)
  acc = fmaf(w[3], a.c, acc);    // (-1,  0,  0)
  acc = fmaf(w[4], b.mz1, acc);  // ( 0, -1, -1)
  acc = fmaf(w[5], b.mz, acc);   // ( 0, -1,  0)
  acc = fmaf(w[6], b.m1, acc);   // ( 0,  0, -1)
  acc = fmaf(w[7], b.c, acc);    // ( 0,  0,  0)
  acc = fmaf(w[8], b.p1, acc);   // ( 0,  0,  1)
  acc = fmaf(w[9], b.pz, acc);   // ( 0,  1,  0)
  acc = fmaf(w[10], b.pz1, acc); // ( 0,  1,  1)
  acc = fmaf(w[11], c.c, acc);   // ( 1,  0,  0)
  acc = fmaf(w[12], c.p1, acc);  // ( 1,  0,  1)
  acc = fmaf(w[13], c.pz, acc);  // ( 1,  1,  0)
  acc = fmaf(w[14], c.pz1, acc); // ( 1,  1,  1)
  return acc;
}

constexpr int kBoxRows = 64;   // rows x of one lane's walk: a block's chunk
constexpr int kBoxTileZ = 32;  // z of a thread block's tile: one warp
constexpr int kBoxTileY = 8;   // y of a thread block's tile: one row per warp
constexpr int kBoxAhead = 2;   // rows loaded ahead of the point summed
constexpr int kBoxRing = kBoxAhead + 2;  // rows x - 1 .. x + kBoxAhead

// Kernel B1's walk of one lane down the rows x0 .. x1 - 1: the lane's 15
// interior weights in registers for the whole walk (rows 0 and X - 1 load
// their own class); each row is loaded once, its seven values carried in
// a ring of kBoxRing rows, and the loads of row x + kBoxAhead issued
// before the sum of row x. Rows x0 - 1 .. x0 + kBoxAhead - 1 are loaded
// first. load(i) returns element i of the flat (X, L) block as f32;
// store(i, v) writes (and rounds) element i; w: the (3, 15, L) weights.
// The ring's slots are compile-time: the loop over x is unrolled by
// kBoxRing, row x - 1 in slot j of step j, row x + kBoxAhead in slot
// j - 1 (mod kBoxRing).
template <class Load, class LoadW, class Store>
HYTEG_DEVICE void box_lane_walk(const Load& load, const LoadW& load_w,
                                const Store& store, int lane, int x0, int x1,
                                int X, int L, int Z) {
  const BoxLane ln(lane, L, Z);
  float wi[kBoxDirs];
  box_load_weights(load_w, wi, 0, lane, L);
  BoxRow ring[kBoxRing];
#pragma unroll
  for (int j = 0; j < kBoxRing - 1; ++j)
    ring[j] = box_load_row(load, ln, x0 - 1 + j, X, L, Z);
  for (int xb = x0; xb < x1; xb += kBoxRing) {
#pragma unroll
    for (int j = 0; j < kBoxRing; ++j) {
      const int x = xb + j;
      if (x >= x1) break;
      ring[(j + kBoxRing - 1) % kBoxRing] =
          box_load_row(load, ln, x + kBoxAhead, X, L, Z);
      const BoxRow& a = ring[j];
      const BoxRow& b = ring[(j + 1) % kBoxRing];
      const BoxRow& c = ring[(j + 2) % kBoxRing];
      const int cls = box_row_class(x, X);
      float acc;
      if (cls != 0) {
        float wb[kBoxDirs];
        box_load_weights(load_w, wb, cls, lane, L);
        acc = box_sum(wb, a, b, c);
      } else {
        acc = box_sum(wi, a, b, c);
      }
      store((long long)x * L + lane, acc);
    }
  }
}

// Rows of a chunk for a block of X rows: a lane's walk loads
// kBoxAhead + 1 rows before its first sum, 4.7% of a 64-row chunk's
// loads; from X = 513 on (levels >= 8 on m = 2) chunks of 128 rows halve
// that, while below it they would leave too few thread blocks to fill
// the card (box level 7: 891 blocks of 256 threads for 132 SMs).
HYTEG_HD constexpr int box_chunk_rows(int X) {
  return X > 512 ? 2 * kBoxRows : kBoxRows;
}

// Thread (tz, ty) of thread block (bz, by, bx) of kernel B1: tile
// (bz, by) of kBoxTileZ x kBoxTileY lanes (y, z), chunk bx of `rows`
// rows (the kernel passes box_chunk_rows(X)). Walks lane y * Z + z down
// the chunk; a thread past the block (z >= Z or y >= Y) does nothing. A
// warp is 32 consecutive z of one y, and the 8 warps of a block are 8
// consecutive y, so the reads at lane offsets +-Z of one warp are the
// reads at offset 0 of its neighbours in the block (L1 hits).
template <class Load, class LoadW, class Store>
HYTEG_DEVICE void box_apply_thread(const Load& load, const LoadW& load_w,
                                   const Store& store, int bz, int by, int bx,
                                   int tz, int ty, int rows, int X, int Y,
                                   int Z) {
  const int z = bz * kBoxTileZ + tz, y = by * kBoxTileY + ty;
  if (z >= Z || y >= Y) return;
  const int x0 = bx * rows, x1 = x0 + rows < X ? x0 + rows : X;
  box_lane_walk(load, load_w, store, y * Z + z, x0, x1, X, Y * Z, Z);
}

}  // namespace hyteg
