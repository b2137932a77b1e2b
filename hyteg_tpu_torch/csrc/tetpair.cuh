// Per-point arithmetic of the paired-tet kernels B6 (apply), B7 (install)
// and B8 (extract).
//
// Kept apart from the kernels in tetpair.cu so that a host build can run
// it: the math is a set of plain functions of (one pair's data, one point
// or lane), and B6's tile walk (pair_apply_tile) is written against a team
// of threads that the card or a host loop provides. The kernels only map
// blocks to tiles and lanes and stage the weights. Layout follows
// hyteg_tpu_torch/kernels/tetpair.py and tetpair/plan.py; per pair:
//   u, dst: (N, L) f32, L = N * P, lane l = ly * P + lz;
//   xf (2, L), yf (2, N, P), zf (2, N, N), df (2, L) f32 face arrays;
//   W (120, 7) f32: row kind * 15 + d, kinds [VA TA V0A T0A VB TB V0B T0B],
//   columns against the lane masks [1, yA, zA, yzA, yB, zB, yzB].
// Position classes, with s = x + ly + lz and n = N - 1:
//   tet A   in_a = s <= n            shell sh_a = s == n
//   tet B   in_b = s >= 2n, lz <= n  shell sh_b = s == 2n, lz <= n
// (B is point-reflected into the upper corner of the block).
#pragma once

#ifndef HYTEG_DEVICE
#define HYTEG_DEVICE __device__ __forceinline__
#endif

namespace hyteg {

constexpr int kPairDirs = 15;      // stencil directions (incl. 0)
constexpr int kPairMaskCols = 7;   // lane-mask columns of W
constexpr int kPairVec = 8 * kPairDirs;
constexpr int kPairW = kPairVec * kPairMaskCols;  // floats of W per pair
constexpr int kVA = 0, kV0A = 2, kVB = 4;  // V0 = V + 2, T = V + 1

struct PairTables {
  int dx[kPairDirs], dy[kPairDirs], dz[kPairDirs];
  int tail_a, tail_b;  // bit d set <=> direction d carries a shell tail
};

// dirs: (15, 3) int directions in the order of tetpair/plan.py::dir_tables.
inline PairTables pair_make_tables(const int* dirs, int tail_a, int tail_b) {
  PairTables t;
  for (int d = 0; d < kPairDirs; ++d) {
    t.dx[d] = dirs[3 * d];
    t.dy[d] = dirs[3 * d + 1];
    t.dz[d] = dirs[3 * d + 2];
  }
  t.tail_a = tail_a;
  t.tail_b = tail_b;
  return t;
}

template <typename T>
struct PairFaces {  // one pair's face arrays
  T* xf;
  T* yf;
  T* zf;
  T* df;
};

// Face arrays of pair c: xf (2, L), yf (2, N, P), zf (2, N, N), df (2, L).
template <typename T>
HYTEG_DEVICE PairFaces<T> pair_faces_of(T* xf, T* yf, T* zf, T* df, int c,
                                        int N, int P) {
  const long long L = (long long)N * P;
  return {xf + c * 2 * L, yf + c * 2LL * N * P, zf + c * 2LL * N * N,
          df + c * 2 * L};
}

// Where the value of position (x, ly, lz), all in range, lives after the
// face arrays are installed: the x-face (row 0 where s <= n, row n where
// s >= 2n, padding lanes included) over the y-face, over the z-face, over
// the diagonal shell, over the block. Written as a chain of selects from
// the lowest precedence up, so that a warp whose lanes meet different
// classes does not branch.
HYTEG_DEVICE const float* pair_source(const float* u,
                                      const PairFaces<const float>& f, int x,
                                      int ly, int lz, int N, int P) {
  const int n = N - 1;
  const int L = N * P;
  const int l = ly * P + lz;
  const int s = x + ly + lz;
  const bool in_a = s <= n;
  const bool in_b = s >= 2 * n && lz <= n;
  const float* p = u + (long long)x * L + l;
  if (s == 2 * n && lz <= n) p = f.df + L + l;
  if (s == n) p = f.df + l;
  if (lz == n && in_b) p = f.zf + (N + x) * N + ly;
  if (lz == 0 && in_a) p = f.zf + x * N + ly;
  if (ly == n && in_b) p = f.yf + (N + x) * P + lz;
  if (ly == 0 && in_a) p = f.yf + x * P + lz;
  if (x == n && s >= 2 * n) p = f.xf + L + l;
  if (x == 0 && in_a) p = f.xf + l;
  return p;
}

HYTEG_DEVICE float pair_installed(const float* u, const PairFaces<const float>& f,
                                  int x, int ly, int lz, int N, int P) {
  return *pair_source(u, f, x, ly, lz, N, P);
}

// Lane masks [1, yA, zA, yzA, yB, zB, yzB] of lane (ly, lz).
HYTEG_DEVICE void pair_lane_masks(int ly, int lz, int n,
                                  float (&m)[kPairMaskCols]) {
  m[0] = 1.f;
  m[1] = ly == 0 ? 1.f : 0.f;
  m[2] = lz == 0 ? 1.f : 0.f;
  m[3] = m[1] * m[2];
  m[4] = ly == n ? 1.f : 0.f;
  m[5] = lz == n ? 1.f : 0.f;
  m[6] = m[4] * m[5];
}

// Row `row` of W against the lane masks, summed in column order.
HYTEG_DEVICE float pair_lane_weight(const float* Wc, int row,
                                    const float (&m)[kPairMaskCols]) {
  const float* w = Wc + row * kPairMaskCols;
  float v = w[0] * m[0];
#pragma unroll
  for (int j = 1; j < kPairMaskCols; ++j) v = fmaf(w[j], m[j], v);
  return v;
}

HYTEG_DEVICE bool pair_face_lane(int ly, int lz, int n) {
  return ly == 0 || ly == n || lz == 0 || lz == n;
}

// Weights of one point of half h (0 = A, 1 = B): (edge ? V0 : V) minus,
// on the half's diagonal shell, (edge ? T0 : T) in the tail directions.
// The edge row is row 0 for A and row n for B. Off the y/z faces every
// mask but the first is 0, so the weight is column 0 of W.
HYTEG_DEVICE void pair_point_weights(const float* Wc, int ly, int lz, int n,
                                     int h, bool edge, bool shell, int tails,
                                     float (&w)[kPairDirs]) {
  const int kv = (h ? kVB : kVA) + (edge ? kV0A - kVA : 0);
  if (pair_face_lane(ly, lz, n)) {
    float m[kPairMaskCols];
    pair_lane_masks(ly, lz, n, m);
#pragma unroll
    for (int d = 0; d < kPairDirs; ++d) {
      w[d] = pair_lane_weight(Wc, kv * kPairDirs + d, m);
      if (shell && ((tails >> d) & 1))
        w[d] -= pair_lane_weight(Wc, (kv + 1) * kPairDirs + d, m);
    }
  } else {
#pragma unroll
    for (int d = 0; d < kPairDirs; ++d) {
      w[d] = Wc[(kv * kPairDirs + d) * kPairMaskCols];
      if (shell && ((tails >> d) & 1))
        w[d] -= Wc[((kv + 1) * kPairDirs + d) * kPairMaskCols];
    }
  }
}

// sum_d w[d] * get(dx_d, dy_d, dz_d), get(dx, dy, dz) being the installed
// value at row x + dx, flat lane l + dy * P + dz of the point's row x and
// lane l.
template <class Get>
HYTEG_DEVICE float pair_stencil(const Get& get, const PairTables& t,
                                const float (&w)[kPairDirs]) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < kPairDirs; ++d)
    acc = fmaf(w[d], get(t.dx[d], t.dy[d], t.dz[d]), acc);
  return acc;
}

// Extract map, per row: the y- and z-face slots of lane (ly, lz) at row x
// take val where the position is in the face's half, else 0.
HYTEG_DEVICE void pair_store_face_row(const PairFaces<float>& o, int x, int ly,
                                      int lz, float val, int N, int P) {
  const int n = N - 1;
  const int s = x + ly + lz;
  const bool in_a = s <= n;
  const bool in_b = s >= 2 * n && lz <= n;
  if (ly == 0) o.yf[x * P + lz] = in_a ? val : 0.f;
  if (ly == n) o.yf[(N + x) * P + lz] = in_b ? val : 0.f;
  if (lz == 0) o.zf[x * N + ly] = in_a ? val : 0.f;
  if (lz == n) o.zf[(N + x) * N + ly] = in_b ? val : 0.f;
}

// Extract map, per lane: the x-face slots take the values v0 (row 0) and
// vn (row n), the diagonal slots va (row n - s) and vb (row 2n - s), each
// where the x-face / shell test of the position holds, else 0.
HYTEG_DEVICE void pair_store_lane(const PairFaces<float>& o, int ly, int lz,
                                  int N, int P, float v0, float vn, float va,
                                  float vb) {
  const int n = N - 1;
  const int L = N * P;
  const int l = ly * P + lz;
  const int s = ly + lz;
  o.xf[l] = s <= n ? v0 : 0.f;
  o.xf[L + l] = s >= n ? vn : 0.f;
  o.df[l] = s <= n ? va : 0.f;
  o.df[L + l] = (s >= n && s <= 2 * n && lz <= n) ? vb : 0.f;
}

// B8 for one lane: the face arrays of block u.
HYTEG_DEVICE void pair_extract_lane(const float* u, const PairFaces<float>& o,
                                    int ly, int lz, int N, int P) {
  const int n = N - 1;
  const int L = N * P;
  const int l = ly * P + lz;
  const int s = ly + lz;
  const float va = s <= n ? u[(long long)(n - s) * L + l] : 0.f;
  const float vb = (s >= n && s <= 2 * n && lz <= n)
                       ? u[(long long)(2 * n - s) * L + l] : 0.f;
  pair_store_lane(o, ly, lz, N, P, u[l], u[(long long)n * L + l], va, vb);
  if (pair_face_lane(ly, lz, n))
    for (int x = 0; x < N; ++x)
      pair_store_face_row(o, x, ly, lz, u[(long long)x * L + l], N, P);
}

// Position class of (x, ly, lz): 0 for tet A, 1 for tet B, -1 for
// neither (the middle of the block and padding lanes).
HYTEG_DEVICE int pair_half(int x, int ly, int lz, int n) {
  const int s = x + ly + lz;
  return s <= n ? 0 : ((s >= 2 * n && lz <= n) ? 1 : -1);
}

// Weights of a point of half h (pair_half) at row x.
HYTEG_DEVICE void pair_weights_at(const float* Wc, const PairTables& t, int x,
                                  int ly, int lz, int n, int h,
                                  float (&w)[kPairDirs]) {
  const int s = x + ly + lz;
  if (h == 0)
    pair_point_weights(Wc, ly, lz, n, 0, x == 0, s == n, t.tail_a, w);
  else
    pair_point_weights(Wc, ly, lz, n, 1, x == n, s == 2 * n, t.tail_b, w);
}

// The extract map at one point of dst: its y- and z-face slots, and the
// lane's x-face and diagonal slots where this row is theirs (the x-face
// rows 0 and n; the lane's shell row, or row 0 for a lane without one).
HYTEG_DEVICE void pair_store_point(const PairFaces<float>& o, int x, int ly,
                                   int lz, float val, int N, int P) {
  const int n = N - 1;
  const int L = N * P;
  const int l = ly * P + lz;
  const int s = ly + lz;
  if (pair_face_lane(ly, lz, n)) pair_store_face_row(o, x, ly, lz, val, N, P);
  if (x == 0) o.xf[l] = s <= n ? val : 0.f;
  if (x == n) o.xf[L + l] = s >= n ? val : 0.f;
  const bool has_a = s <= n;
  const bool has_b = s >= n && s <= 2 * n && lz <= n;
  if (has_a ? x == n - s : x == 0) o.df[l] = has_a ? val : 0.f;
  if (has_b ? x == 2 * n - s : x == 0) o.df[L + l] = has_b ? val : 0.f;
}

// B6 tiles: a block owns kTileY x kTileZ lanes (ly, lz) of one pair, one
// thread per lane, and walks its rows.
constexpr int kTileY = 16, kTileZ = 16;
constexpr int kTileThreads = kTileY * kTileZ;
constexpr int kRimZ = kTileZ + 2;
constexpr int kStaged = (kTileY + 2) * kRimZ;  // tile plus its one-lane rim
constexpr int kStageSlots = (kStaged + kTileThreads - 1) / kTileThreads;

inline int pair_tiles(int N, int P) {  // tiles per pair: B6's grid.x
  return ((N + kTileY - 1) / kTileY) * ((P + kTileZ - 1) / kTileZ);
}

// One thread's registers in the walk: its lane (ly, lz) and that lane's
// place `at` in a staged row, its staged positions (flat lane, -1 outside
// the block), and the row it has loaded but not yet stored.
struct PairTileThread {
  int ly, lz, at;
  int sl[kStageSlots], sy[kStageSlots], sz[kStageSlots];
  float next[kStageSlots];
};

// B6 on tile `tile` of one pair: u and f its block and faces, dst and o
// its outputs, Wc its 120 x 7 weights. team.each(fn) runs
// fn(thread, PairTileThread&) for each of the block's kTileThreads
// threads and team.sync() is the block's barrier, so the same walk runs
// on the card (one call per thread, shared memory) and on the host (a
// loop over the threads, a plain array).
//
// Installed rows of the tile and its rim are staged in `ring`, four rows
// that the stencil of row x reads as rows x - 1 .. x + 1; the fourth row
// lets one barrier per row suffice. Staged lanes are flat: the rim's
// z-neighbours past lz = P - 1 are the next y-row's first lanes, and a
// position outside the rows or lanes of the block stages 0 (the plain
// version's flat.shift_read rule). Row x + 2 is loaded into registers
// before the stencil of row x and stored one row later, so the loads
// overlap it. A tile walks only the rows where it meets a tet (tet A on
// rows 0 .. n - min s, tet B on rows 2n - max s .. n) and writes zeros on
// the rows between.
template <class Team>
HYTEG_DEVICE void pair_apply_tile(Team& team, float (*ring)[kStaged], int tile,
                                  const float* u,
                                  const PairFaces<const float>& f,
                                  const float* Wc, const PairTables& t,
                                  float* dst, const PairFaces<float>& o, int N,
                                  int P) {
  const int n = N - 1;
  const int L = N * P;
  const int tiles_z = (P + kTileZ - 1) / kTileZ;
  const int ty0 = (tile / tiles_z) * kTileY;
  const int tz0 = (tile % tiles_z) * kTileZ;
  team.each([&](int tid, PairTileThread& r) {
    r.ly = ty0 + tid / kTileZ;
    r.lz = tz0 + tid % kTileZ;
    r.at = (tid / kTileZ + 1) * kRimZ + tid % kTileZ + 1;
#pragma unroll
    for (int k = 0; k < kStageSlots; ++k) {
      const int j = tid + k * kTileThreads;
      const int l = (ty0 - 1 + j / kRimZ) * P + tz0 - 1 + j % kRimZ;
      const bool ok = j < kStaged && l >= 0 && l < L;
      r.sl[k] = ok ? l : -1;
      r.sy[k] = ok ? l / P : 0;
      r.sz[k] = ok ? l - r.sy[k] * P : 0;
    }
  });
  auto fetch = [&](int x) {  // installed row x, 0 beyond the block
    team.each([&](int, PairTileThread& r) {
#pragma unroll
      for (int k = 0; k < kStageSlots; ++k)
        r.next[k] = (r.sl[k] >= 0 && x >= 0 && x < N)
                        ? *pair_source(u, f, x, r.sy[k], r.sz[k], N, P)
                        : 0.f;
    });
  };
  auto put = [&](int x) {
    team.each([&](int tid, PairTileThread& r) {
#pragma unroll
      for (int k = 0; k < kStageSlots; ++k) {
        const int j = tid + k * kTileThreads;
        if (j < kStaged) ring[x & 3][j] = r.next[k];
      }
    });
  };
  auto finish = [&](const PairTileThread& r, int x, float val) {
    if (r.ly >= N || r.lz >= P) return;
    dst[(long long)x * L + r.ly * P + r.lz] = val;
    pair_store_point(o, x, r.ly, r.lz, val, N, P);
  };
  auto walk = [&](int x0, int x1) {  // rows x0 .. x1 through the stencil
    fetch(x0 - 1);
    put(x0 - 1);
    fetch(x0);
    put(x0);
    fetch(x0 + 1);
    for (int x = x0; x <= x1; ++x) {
      put(x + 1);
      fetch(x + 2);
      team.sync();
      team.each([&](int, PairTileThread& r) {
        const int h = (r.ly < N && r.lz < P) ? pair_half(x, r.ly, r.lz, n)
                                              : -1;
        float val = 0.f;
        if (h >= 0) {
          float w[kPairDirs];
          pair_weights_at(Wc, t, x, r.ly, r.lz, n, h, w);
          val = pair_stencil(
              [&](int dx, int dy, int dz) {
                return ring[(x + dx) & 3][r.at + dy * kRimZ + dz];
              },
              t, w);
        }
        finish(r, x, val);
      });
    }
  };

  // rows of tet A: 0 .. n - s_min; of tet B: 2n - s_max .. n
  const int s_min = ty0 + tz0;
  const int zb = tz0 + kTileZ - 1 < n ? tz0 + kTileZ - 1 : n;
  const int yb = ty0 + kTileY - 1 < n ? ty0 + kTileY - 1 : n;
  const int s_max = tz0 <= n ? yb + zb : -1;
  const int a_hi = s_min <= n ? n - s_min : -1;
  const int b_lo = s_max >= n ? (2 * n - s_max > 0 ? 2 * n - s_max : 0) : N;
  if (a_hi + 1 >= b_lo) {
    walk(0, n);
  } else {
    if (a_hi >= 0) walk(0, a_hi);
    for (int x = a_hi + 1; x < b_lo; ++x)
      team.each([&](int, PairTileThread& r) { finish(r, x, 0.f); });
    if (b_lo <= n) {
      team.sync();  // the ring is restaged
      walk(b_lo, n);
    }
  }
}

}  // namespace hyteg
