// Per-point arithmetic of the paired-tet kernels B6 (apply), B7 (install)
// and B8 (extract), and their walks: B6's and B7's over one plane of a
// pair, B8's over a run of a pair's face entries.
//
// Kept apart from the kernels in tetpair.cu so that a host build can run
// it: the math is a set of plain functions of (one pair's data, one
// point), and the walks (pair_apply_plane, pair_install_copy and
// pair_install_patch, pair_extract_range) write through store objects, so
// a host harness runs the kernels' own walks thread by thread and counts
// each slot's writes. Layout follows
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
#ifndef HYTEG_NOINLINE
#ifdef __CUDACC__
#define HYTEG_NOINLINE __device__ __noinline__
#else
#define HYTEG_NOINLINE inline
#endif
#endif

namespace hyteg {

constexpr int kPairDirs = 15;      // stencil directions (incl. 0)
constexpr int kPairMaskCols = 7;   // lane-mask columns of W
constexpr int kPairVec = 8 * kPairDirs;
constexpr int kPairW = kPairVec * kPairMaskCols;  // floats of W per pair
constexpr int kVA = 0, kV0A = 2, kVB = 4;  // V0 = V + 2, T = V + 1

// The 15 directions (dx, dy, dz) in the order of tetpair/plan.py::
// dir_tables: (-1,0,0) (-1,0,1) (-1,1,-1) (-1,1,0) (0,-1,0) (0,-1,1)
// (0,0,-1) (0,0,0) (0,0,1) (0,1,-1) (0,1,0) (1,-1,0) (1,-1,1) (1,0,-1)
// (1,0,0). Compile-time, so that each tap of an unrolled sum reads at a
// row pointer plus a constant offset; the launcher refuses other tables.
HYTEG_HD constexpr int pair_dx(int d) { return d < 4 ? -1 : (d < 11 ? 0 : 1); }
HYTEG_HD constexpr int pair_dy(int d) {
  return (d == 2 || d == 3 || d == 9 || d == 10)
             ? 1
             : ((d == 4 || d == 5 || d == 11 || d == 12) ? -1 : 0);
}
HYTEG_HD constexpr int pair_dz(int d) {
  return (d == 1 || d == 5 || d == 8 || d == 12)
             ? 1
             : ((d == 2 || d == 6 || d == 9 || d == 13) ? -1 : 0);
}

// dirs: (15, 3) int directions, as tetpair/plan.py::dir_tables gives
// them: true when they are the compiled ones.
inline bool pair_dirs_match(const int* dirs) {
  for (int d = 0; d < kPairDirs; ++d)
    if (dirs[3 * d] != pair_dx(d) || dirs[3 * d + 1] != pair_dy(d) ||
        dirs[3 * d + 2] != pair_dz(d))
      return false;
  return true;
}

struct PairTables {
  int tail_a, tail_b;  // bit d set <=> direction d carries a shell tail
};

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

// One pair's face arrays as outputs, each written through a store (on the
// card a CellStore; a host harness passes its own to count writes).
template <class S>
struct PairStores {
  S xf, yf, zf, df;
};

HYTEG_DEVICE PairStores<CellStore> pair_stores_of(float* xf, float* yf,
                                                  float* zf, float* df, int c,
                                                  int N, int P) {
  const PairFaces<float> f = pair_faces_of(xf, yf, zf, df, c, N, P);
  return {CellStore{f.xf}, CellStore{f.yf}, CellStore{f.zf}, CellStore{f.df}};
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

// Weight d of one point of half h (0 = A, 1 = B): (edge ? V0 : V) minus,
// on the half's diagonal shell, (edge ? T0 : T) in the tail directions.
// The edge row is row 0 for A and row n for B. Off the y/z faces every
// mask but the first is 0, so the weight is column 0 of W.
HYTEG_DEVICE float pair_point_weight(const float* Wc, int ly, int lz, int n,
                                     int h, bool edge, bool shell, int tails,
                                     int d) {
  const int kv = (h ? kVB : kVA) + (edge ? kV0A - kVA : 0);
  const bool tail = shell && ((tails >> d) & 1);
  if (pair_face_lane(ly, lz, n)) {
    float m[kPairMaskCols];
    pair_lane_masks(ly, lz, n, m);
    float w = pair_lane_weight(Wc, kv * kPairDirs + d, m);
    if (tail) w -= pair_lane_weight(Wc, (kv + 1) * kPairDirs + d, m);
    return w;
  }
  float w = Wc[(kv * kPairDirs + d) * kPairMaskCols];
  if (tail) w -= Wc[((kv + 1) * kPairDirs + d) * kPairMaskCols];
  return w;
}

// All 15 weights of one point (pair_point_weight).
HYTEG_DEVICE void pair_point_weights(const float* Wc, int ly, int lz, int n,
                                     int h, bool edge, bool shell, int tails,
                                     float (&w)[kPairDirs]) {
#pragma unroll
  for (int d = 0; d < kPairDirs; ++d)
    w[d] = pair_point_weight(Wc, ly, lz, n, h, edge, shell, tails, d);
}

// sum_d w[d] * get(dx_d, dy_d, dz_d), get(dx, dy, dz) being the installed
// value at row x + dx, flat lane l + dy * P + dz of the point's row x and
// lane l. With pair_weights_at and pair_source, the per-point math B6's
// walk reproduces: the host tests hold every slot of the walk against
// it.
template <class Get>
HYTEG_DEVICE float pair_stencil(const Get& get, const float (&w)[kPairDirs]) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < kPairDirs; ++d)
    acc = fmaf(w[d], get(pair_dx(d), pair_dy(d), pair_dz(d)), acc);
  return acc;
}

// Extract map, per row: the y- and z-face slots of lane (ly, lz) at row x
// take val where the position is in the face's half, else 0.
template <class S>
HYTEG_DEVICE void pair_store_face_row(const PairStores<S>& o, int x, int ly,
                                      int lz, float val, int N, int P) {
  const int n = N - 1;
  const int s = x + ly + lz;
  const bool in_a = s <= n;
  const bool in_b = s >= 2 * n && lz <= n;
  if (ly == 0) o.yf(x * P + lz, in_a ? val : 0.f);
  if (ly == n) o.yf((N + x) * P + lz, in_b ? val : 0.f);
  if (lz == 0) o.zf(x * N + ly, in_a ? val : 0.f);
  if (lz == n) o.zf((N + x) * N + ly, in_b ? val : 0.f);
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
// Each face entry is written at exactly one position (x, ly, lz), so a
// walk that calls this once at every position where it writes anything
// writes every entry once. It writes nothing at a position off the y/z
// faces, off rows 0 and n and off both shells.
template <class S>
HYTEG_DEVICE void pair_store_point(const PairStores<S>& o, int x, int ly,
                                   int lz, float val, int N, int P) {
  const int n = N - 1;
  const int L = N * P;
  const int l = ly * P + lz;
  const int s = ly + lz;
  if (pair_face_lane(ly, lz, n)) pair_store_face_row(o, x, ly, lz, val, N, P);
  if (x == 0) o.xf(l, s <= n ? val : 0.f);
  if (x == n) o.xf(L + l, s >= n ? val : 0.f);
  const bool has_a = s <= n;
  const bool has_b = s >= n && s <= 2 * n && lz <= n;
  if (has_a ? x == n - s : x == 0) o.df(l, has_a ? val : 0.f);
  if (has_b ? x == 2 * n - s : x == 0) o.df(L + l, has_b ? val : 0.f);
}

// -- kernel B6: the walk over one plane x of a pair ------------------------
// Warps on the rows ly of a plane, lanes on consecutive lz, as B2's plane
// walk (const_apply_plane). Row (x, ly) meets tet A in lz = 0 .. n - x -
// ly and tet B in lz = max(0, 2n - x - ly) .. n (when x + ly >= n); the
// lanes between and the padding lanes n < lz < P are store-only zero runs.
//
// Each tet has four installed faces: tet A x = 0, ly = 0, lz = 0 and its
// shell s = n; tet B x = n, ly = n, lz = n and s = 2n. Every direction
// moves each coordinate and s by at most 1, so
//  - a slot at distance >= 2 from all four (x, ly, lz >= 2 and s <= n - 2
//    in A; x, ly, lz <= n - 2 and s >= 2n + 2 in B) is interior: its 15
//    neighbours are plain block values, its weights the half's interior
//    ones (column 0 of the VA or VB rows, the same 15 numbers for the
//    whole pair);
//  - a slot at distance 1 from exactly one face and >= 2 from the others
//    is a layer slot of that face: its weights are the interior ones too,
//    and the 4 neighbours that move onto the face are that face array's
//    values, the others plain block values;
//  - a slot on exactly one face and >= 2 from the others is a face slot:
//    its weights are those of its face's class, the 7 neighbours on the
//    face are that face array's values, the 4 beyond an x or y face are 0
//    (past the block) and the others plain block values (beyond a z face
//    or a shell the block's own slots: the next row's or the middle's);
//  - every other in-tet slot (on or near two faces: the tet's edges) is
//    rim and runs the tested per-point math (pair_rim_slot).
// Interior, layer and face slots run one untested sum (pair_kind_slot)
// whose reads are fixed at compile time by the slot's kind; face slots
// then store through the tested extract map (pair_store_point).
// The rows of each tet: a row on or near two faces (A: x, ly <= 1; B: x,
// ly >= n - 1) is all rim. In every other row, with first lane F and last
// lane E, the lanes F + 2 .. E - 2 are of one kind: face or layer slots of
// the x face (A: x = 0, 1; B: x = n, n - 1), else of the y face (A: ly =
// 0, 1; B: ly = n, n - 1), else interior, a warp a row. Lanes F, F + 1,
// E - 1, E are the z face, its layer, the shell's layer and the shell
// (B: the shell, its layer, the z face's layer and the z face) where the
// row is off and not next to the x and y faces and E - F >= 3, else rim.
// These four lanes of the block's rows and the slots of its rim rows are
// one list over all the block's threads (see pair_apply_plane), so no row
// waits on them.
//
// A position outside both tets calls pair_store_point with 0 where that
// writes a face entry (planes 0 and n, rows 0 and n, lanes 0 and n), so
// every face entry is written once, as the extract map decides.

// The plane of block row `y` of the grid: 0, n, 1, n - 1, then 2 .. n - 2,
// so the planes with the most rim and layer slots start first (in the
// natural order B6 ran 25% slower at level 7 on the card: those blocks
// ended last).
HYTEG_HD constexpr int pair_plane_of(int y, int N) {
  return y == 0 ? 0 : (y == 1 ? N - 1 : (y == 2 ? 1 : (y == 3 ? N - 2 : y - 2)));
}

// One pair's outputs: dst and the four face arrays, each through a store.
template <class S>
struct PairOut {
  S dst;
  PairStores<S> faces;
};

// The weights of the classes of in-tet slot, those of a block's plane
// folded once per block: the 15 weights of pair_weights_at depend on a
// slot only through its half h, its edge-row flag, its shell flag and its
// lane's face classes cy, cz (0: ly (lz) = 0, 2: = n, 1: neither), which
// fix its lane masks. Entry pair_class(...) * kPairDirs + d of tab is
// weight d of that class, computed by pair_point_weight at a lane of the
// class, so a slot's weights are pair_weights_at's bit for bit.
constexpr int kPairClasses = 2 * 2 * 2 * 9;  // h, edge, shell, (cy, cz)
constexpr int kPairTab = kPairClasses * kPairDirs;

HYTEG_DEVICE int pair_lane_class(int l, int n) {
  return l == 0 ? 0 : (l == n ? 2 : 1);
}

// The class of in-tet slot (x, ly, lz) of half h.
HYTEG_DEVICE int pair_class(int x, int ly, int lz, int n, int h) {
  const int s = x + ly + lz;
  const bool edge = h ? x == n : x == 0;
  const bool shell = h ? s == 2 * n : s == n;
  return ((h * 2 + edge) * 2 + shell) * 9 + pair_lane_class(ly, n) * 3 +
         pair_lane_class(lz, n);
}

// The classes of plane x in tab (kPairTab floats) from the pair's W (on
// the card staged in shared memory first), one entry (class, d) per
// thread in turn, for thread tid of nthreads. A half's slots in plane x
// share its edge flag (A: x == 0, B: x == n), and their lane classes cy,
// cz are 0 or 1 in A and 1 or 2 in B, but on A's plane 0 and B's plane n,
// which meet all three; so a plane forms 16 of the 72 classes, 26 on
// planes 0 and n.
HYTEG_DEVICE void pair_weight_table(const float* Wc, const PairTables& t,
                                    int n, int x, float* tab, int tid,
                                    int nthreads) {
  const int ca = x == 0 ? 3 : 2, cb = x == n ? 3 : 2;  // lane classes
  const int na = 2 * ca * ca * kPairDirs;
  for (int e = tid; e < na + 2 * cb * cb * kPairDirs; e += nthreads) {
    const int h = e >= na, c = h ? cb : ca, r = h ? e - na : e;
    const int k = r / kPairDirs, d = r - k * kPairDirs;  // k < 2 c^2
    const int shell = k / (c * c), cyz = k - shell * c * c;
    const int lo = h ? 3 - c : 0;  // the half's first lane class
    const int cy = lo + cyz / c, cz = lo + cyz % c;
    const int edge = h ? x == n : x == 0;
    const int ly = cy == 0 ? 0 : (cy == 2 ? n : 1);
    const int lz = cz == 0 ? 0 : (cz == 2 ? n : 1);
    tab[(((h * 2 + edge) * 2 + shell) * 9 + cy * 3 + cz) * kPairDirs + d] =
        pair_point_weight(Wc, ly, lz, n, h, edge, shell,
                          h ? t.tail_b : t.tail_a, d);
  }
}

// Reads of a rim slot found, then issued, together: with all 15 at once
// the walk needed 128 registers (two blocks per SM); with groups of 5 it
// ran 11% faster on the card at three blocks per SM.
constexpr int kRimLoads = 5;
static_assert(kPairDirs % kRimLoads == 0, "groups of reads cover the stencil");

// An in-tet slot through the tested math: its weights pair_weights_at's
// (from the block's table), its 15 reads pair_source's (flat lanes, 0
// beyond the block, as flat.shift_read), summed as pair_stencil sums
// them, its value stored in dst and the face arrays. The sources of a
// group of kRimLoads reads are found first and read together, so their
// loads are in flight at once (read one after another, each behind a
// test, they cost the latency of memory 15 times per slot). A call of its
// own on the card, so that its pointers and select chains do not take the
// interior sum's registers.
template <class Out>
HYTEG_NOINLINE void pair_rim_slot(const float* u, PairFaces<const float> f,
                                  const float* tab, Out out, int x, int ly,
                                  int lz, int N, int P) {
  const int n = N - 1;
  float v[kPairDirs];
#pragma unroll
  for (int d0 = 0; d0 < kPairDirs; d0 += kRimLoads) {
    const float* src[kRimLoads];
    bool ok[kRimLoads];
#pragma unroll
    for (int g = 0; g < kRimLoads; ++g) {
      const int d = d0 + g;
      const int xs = x + pair_dx(d);
      int sy = ly + pair_dy(d), sz = lz + pair_dz(d);
      sy += sz < 0 ? -1 : (sz >= P ? 1 : 0);
      sz += sz < 0 ? P : (sz >= P ? -P : 0);
      ok[g] = xs >= 0 && xs < N && sy >= 0 && sy < N;
      src[g] = pair_source(u, f, ok[g] ? xs : 0, ok[g] ? sy : 0, sz, N, P);
    }
#pragma unroll
    for (int g = 0; g < kRimLoads; ++g) v[d0 + g] = ok[g] ? *src[g] : 0.f;
  }
  const float* w =
      tab + pair_class(x, ly, lz, n, pair_half(x, ly, lz, n)) * kPairDirs;
  float val = 0.f;
#pragma unroll
  for (int d = 0; d < kPairDirs; ++d) val = fmaf(w[d], v[d], val);
  out.dst(x * N * P + ly * P + lz, val);
  pair_store_point(out.faces, x, ly, lz, val, N, P);
}

// Slot kinds of the untested sum, for half h (0: A, 1: B) and face k (0:
// x, 1: y, 2: z, 3: the shell): a layer slot of face k is h * 4 + k, a
// face slot 8 + h * 4 + k, an interior slot 16 + h.
constexpr int kPairLayer = 0, kPairFace = 8, kPairInner = 16;

HYTEG_HD constexpr int pair_kind_half(int kind) {
  return kind >= kPairInner ? kind - kPairInner : (kind >> 2) & 1;
}

// The change of the coordinate that face k of a kind measures under
// direction d, and its sign away from the tet (A: x, y, z -1, shell +1;
// B: the opposite).
HYTEG_HD constexpr int pair_kind_step(int kind, int d) {
  return (kind & 3) == 0 ? pair_dx(d)
         : (kind & 3) == 1 ? pair_dy(d)
         : (kind & 3) == 2 ? pair_dz(d)
         : pair_dx(d) + pair_dy(d) + pair_dz(d);
}
HYTEG_HD constexpr int pair_kind_out(int kind) {
  return ((kind & 3) == 3) == (pair_kind_half(kind) == 0) ? 1 : -1;
}

// Where tap d of a slot of `kind` reads: 0 the block, 1 the face array of
// the kind's face, 2 nothing (0: past the block).
HYTEG_HD constexpr int pair_tap(int kind, int d) {
  return kind >= kPairInner ? 0
         : kind < kPairFace
             ? (pair_kind_step(kind, d) == pair_kind_out(kind) ? 1 : 0)
             : (pair_kind_step(kind, d) == 0
                    ? 1
                    : (pair_kind_step(kind, d) == pair_kind_out(kind) &&
                               (kind & 3) < 2
                           ? 2
                           : 0));
}

// The class (pair_class) of the slots of `kind`: interior and layer slots
// that of the half off its faces; a face slot that of its face, off the
// others.
HYTEG_HD constexpr int pair_kind_class(int kind) {
  const int h = pair_kind_half(kind), k = kind & 3;
  const int edge = kind >= kPairFace && kind < kPairInner && k == 0;
  const int shell = kind >= kPairFace && kind < kPairInner && k == 3;
  const int face = h ? 2 : 0;
  const int cy = kind >= kPairFace && kind < kPairInner && k == 1 ? face : 1;
  const int cz = kind >= kPairFace && kind < kPairInner && k == 2 ? face : 1;
  return ((h * 2 + edge) * 2 + shell) * 9 + cy * 3 + cz;
}

// The face-array slot of face position (xs, ys, zs) of face k of half h:
// pair_source's choice there (a slot of a layer or face kind is >= 2 from
// the other faces, which keeps every higher-precedence face away).
template <int KIND>
HYTEG_DEVICE const float* pair_face_slot(const PairFaces<const float>& f,
                                         int xs, int ys, int zs, int N,
                                         int P) {
  constexpr int h = pair_kind_half(KIND), k = KIND & 3;
  if constexpr (k == 0) return f.xf + h * N * P + ys * P + zs;
  if constexpr (k == 1) return f.yf + (h * N + xs) * P + zs;
  if constexpr (k == 2) return f.zf + (h * N + xs) * N + ys;
  return f.df + h * N * P + ys * P + zs;
}

// The slot (x, ly, lz) of `KIND` into dst (and, for a face slot, into
// the face arrays through pair_store_point): 15 reads fixed at compile
// time (pair_tap), weights from the block's table at the kind's class
// (volatile, so that each tap reads shared memory where it is used: held
// in registers the 15 weights would cost the walk occupancy), the same
// terms in the same order as pair_stencil with pair_weights_at and
// pair_source, no tests.
template <int KIND, class Out>
HYTEG_DEVICE void pair_kind_slot(const float* u,
                                 const PairFaces<const float>& f,
                                 const float* tab, const Out& out, int x,
                                 int ly, int lz, int N, int P) {
  const volatile float* w = tab + pair_kind_class(KIND) * kPairDirs;
  const int L = N * P;
  const float* p = u + x * L + ly * P + lz;
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < kPairDirs; ++d) {
    const int t = pair_tap(KIND, d);
    const float v =
        t == 1 ? *pair_face_slot<KIND>(f, x + pair_dx(d), ly + pair_dy(d),
                                       lz + pair_dz(d), N, P)
        : t == 2 ? 0.f
                 : p[pair_dx(d) * L + pair_dy(d) * P + pair_dz(d)];
    acc = fmaf(w[d], v, acc);
  }
  out.dst(x * L + ly * P + lz, acc);
  if constexpr (KIND >= kPairFace && KIND < kPairInner)
    pair_store_point(out.faces, x, ly, lz, acc, N, P);
}

// Lanes lo .. hi of row (x, ly), all of `KIND`, 32 at a time.
template <int KIND, class Out>
HYTEG_DEVICE void pair_kind_run(const float* u,
                                const PairFaces<const float>& f,
                                const float* tab, const Out& out, int x,
                                int ly, int lo, int hi, int N, int P,
                                int lane) {
  for (int lz = lo + lane; lz <= hi; lz += 32)
    pair_kind_slot<KIND>(u, f, tab, out, x, ly, lz, N, P);
}

// Face entries of the positions (x, ly, lz0 .. lz1 - 1), all outside both
// tets, for lane of 32: pair_store_point with 0 wherever it writes one.
// Off planes 0 and n and rows 0 and n that is the z-face entry of lane 0
// or lane n, which these stores write directly.
template <class S>
HYTEG_DEVICE void pair_zero_faces(const PairStores<S>& o, int x, int ly,
                                  int lz0, int lz1, int N, int P, int lane) {
  const int n = N - 1;
  if (x == 0 || x == n || ly == 0 || ly == n) {
    for (int lz = lz0 + lane; lz < lz1; lz += 32)
      pair_store_point(o, x, ly, lz, 0.f, N, P);
  } else if (lane == 0 && lz0 == 0 && lz1 > 0) {
    o.zf(x * N + ly, 0.f);
  } else if (lane == 1 && lz0 <= n && n < lz1) {
    o.zf((N + x) * N + ly, 0.f);
  }
}

// Every slot of plane x of one pair and the face entries it owns, each
// written once through out, run by thread (warp, lane) of nwarps warps.
// u, f: the pair's block and faces; tab: its class weights
// (pair_weight_table for plane x), in shared memory. Offsets are 32-bit:
// a pair's block holds N * L <= 2^31 slots.
template <class Out>
HYTEG_DEVICE void pair_apply_plane(const float* u,
                                   const PairFaces<const float>& f,
                                   const float* tab, const Out& out, int x,
                                   int N, int P, int warp, int lane,
                                   int nwarps) {
  const int n = N - 1;
  const int L = N * P;
  const int nthreads = nwarps * 32;
  // the list below starts at the last warp, the rows at the first, so
  // that a small plane spreads its work over the block
  const int tid = nthreads - 1 - (warp * 32 + lane);
  auto rim = [&](int ly, int lz) {
    pair_rim_slot(u, f, tab, out, x, ly, lz, N, P);
  };
  // tet A's rows 0 .. n - x, all rim below a_rim; tet B's rows n - x ..
  // n, all rim from b_rim on
  const int a_rows = n - x + 1;
  const int a_rim = x <= 1 ? (a_rows < 2 ? a_rows : 2) : 0;
  const int b_lo = n - x;
  const int b_rim = x >= n - 1 ? (b_lo > n - 1 ? b_lo : n - 1) : N;
  const int a_part = a_rows - a_rim;  // rows a_rim .. n - x
  const int b_part = b_rim - b_lo;    // rows b_lo .. b_rim - 1

  // middles of the other rows, and zero runs: row ly to warp ly % nwarps
  for (int ly = warp; ly < N; ly += nwarps) {
    const int row = x * L + ly * P;
    const int a_end = n - x - ly;  // last lane of tet A, < 0: none
    const int b_beg = x + ly >= n ? (2 * n - x - ly > 0 ? 2 * n - x - ly : 0)
                                  : N;  // first lane of tet B, N: none
    if (ly >= a_rim && ly <= n - x) {
      const int lo = 2, hi = a_end - 2;
      if (x == 0)
        pair_kind_run<kPairFace>(u, f, tab, out, x, ly, lo, hi, N, P, lane);
      else if (x == 1)
        pair_kind_run<kPairLayer>(u, f, tab, out, x, ly, lo, hi, N, P, lane);
      else if (ly == 0)
        pair_kind_run<kPairFace + 1>(u, f, tab, out, x, ly, lo, hi, N, P,
                                     lane);
      else if (ly == 1)
        pair_kind_run<kPairLayer + 1>(u, f, tab, out, x, ly, lo, hi, N, P,
                                      lane);
      else
        pair_kind_run<kPairInner>(u, f, tab, out, x, ly, lo, hi, N, P, lane);
    }
    if (ly >= b_lo && ly < b_rim) {
      const int lo = b_beg + 2, hi = n - 2;
      if (x == n)
        pair_kind_run<kPairFace + 4>(u, f, tab, out, x, ly, lo, hi, N, P,
                                     lane);
      else if (x == n - 1)
        pair_kind_run<kPairLayer + 4>(u, f, tab, out, x, ly, lo, hi, N, P,
                                      lane);
      else if (ly == n)
        pair_kind_run<kPairFace + 5>(u, f, tab, out, x, ly, lo, hi, N, P,
                                     lane);
      else if (ly == n - 1)
        pair_kind_run<kPairLayer + 5>(u, f, tab, out, x, ly, lo, hi, N, P,
                                      lane);
      else
        pair_kind_run<kPairInner + 1>(u, f, tab, out, x, ly, lo, hi, N, P,
                                      lane);
    }
    const int z0 = a_end + 1 > 0 ? a_end + 1 : 0;
    const int z1 = b_beg < N ? b_beg : P;
    zero_run(out.dst, row + z0, row + z1, lane, 32);
    pair_zero_faces(out.faces, x, ly, z0, z1, N, P, lane);
    if (b_beg < N) {
      zero_run(out.dst, row + N, row + P, lane, 32);
      pair_zero_faces(out.faces, x, ly, N, P, N, P, lane);
    }
  }

  // The lanes F, F + 1, E - 1, E of the other rows and every slot of the
  // rim rows, one list over all the block's threads: first the lanes of
  // the inner rows (off and not next to the x and y faces, E - F >= 3: A's
  // rows 2 .. n - x - 3 when x >= 2, B's rows n - x + 3 .. n - 2 when x <=
  // n - 2), which are the z face, its layer, the shell's layer and the
  // shell (B: the shell, its layer, the z face's layer and the z face),
  // each of the four in its own run of rows; then the rim: those lanes of
  // the other rows, then the rim rows. So the lanes of a warp take slots
  // of one kind, and the rim's slots fill whole warps.
  const int in_a = x >= 2 && n - x - 4 > 0 ? n - x - 4 : 0;
  const int in_b = x <= n - 2 && x - 4 > 0 ? x - 4 : 0;
  const int ia0 = 2, ib0 = n - x + 3;  // first inner rows
  const int out_a = a_part - in_a, out_b = b_part - in_b;
  // the other rows: those before the inner ones, then those after
  const int ca = in_a ? ia0 - a_rim : a_part, cb = in_b ? ib0 - b_lo : b_part;
  const int n_kind = 4 * (in_a + in_b);
  const int n_lanes = n_kind + 4 * (out_a + out_b);
  int n_all = n_lanes;
  for (int ly = 0; ly < a_rim; ++ly) n_all += n - x - ly + 1;
  for (int ly = b_rim; ly <= n; ++ly)
    n_all += n + 1 - (2 * n - x - ly > 0 ? 2 * n - x - ly : 0);
  for (int i = tid; i < n_all; i += nthreads) {
    if (i >= n_lanes) {  // a slot of a rim row
      int r = i - n_lanes, ly = 0;
      for (; ly < a_rim && r > n - x - ly; ++ly) r -= n - x - ly + 1;
      if (ly < a_rim) {
        rim(ly, r);
        continue;
      }
      for (ly = b_rim;; ++ly) {
        const int first = 2 * n - x - ly > 0 ? 2 * n - x - ly : 0;
        if (r <= n - first) {
          rim(ly, first + r);
          break;
        }
        r -= n + 1 - first;
      }
      continue;
    }
    const bool kind = i < n_kind;
    const int r = kind ? i : i - n_kind;
    const int m4a = 4 * (kind ? in_a : out_a);
    const bool ha = r < m4a;
    const int j = ha ? r : r - m4a;
    const int m = kind ? (ha ? in_a : in_b) : (ha ? out_a : out_b);
    const int s = j / m, t = j - s * m;
    const int ly = kind ? (ha ? ia0 : ib0) + t
                 : ha ? (t < ca ? a_rim + t : ia0 + in_a + t - ca)
                      : (t < cb ? b_lo + t : ib0 + in_b + t - cb);
    const int first = ha ? 0 : 2 * n - x - ly, last = ha ? n - x - ly : n;
    const int lz = s < 2 ? first + s : last - 3 + s;
    if (!kind) {
      if (s < 2 ? lz <= last : lz >= first + 2) rim(ly, lz);  // short rows
    } else if (ha) {
      if (s == 0)
        pair_kind_slot<kPairFace + 2>(u, f, tab, out, x, ly, lz, N, P);
      else if (s == 1)
        pair_kind_slot<kPairLayer + 2>(u, f, tab, out, x, ly, lz, N, P);
      else if (s == 2)
        pair_kind_slot<kPairLayer + 3>(u, f, tab, out, x, ly, lz, N, P);
      else
        pair_kind_slot<kPairFace + 3>(u, f, tab, out, x, ly, lz, N, P);
    } else {
      if (s == 0)
        pair_kind_slot<kPairFace + 7>(u, f, tab, out, x, ly, lz, N, P);
      else if (s == 1)
        pair_kind_slot<kPairLayer + 7>(u, f, tab, out, x, ly, lz, N, P);
      else if (s == 2)
        pair_kind_slot<kPairLayer + 6>(u, f, tab, out, x, ly, lz, N, P);
      else
        pair_kind_slot<kPairFace + 6>(u, f, tab, out, x, ly, lz, N, P);
    }
  }
}

// -- kernel B7: copy, then the lines of the plane ---------------------------
// The lines of plane x: rows ly = 0 and ly = n (all P lanes), lanes lz =
// 0 and lz = n (rows 1 .. n - 1), and the points of the two shell lines
// off those rows and lanes: ly + lz = n - x (lz = 1 .. n - x - 1) and ly +
// lz = 2n - x (lz = n - x + 1 .. n - 1); pair_lines(x) positions, each
// once. pair_source picks a face array other than an x-face only on the
// lines: it returns u's slot unless one of its eight tests holds, and
//  - ly == 0, ly == n hold only on rows 0 and n, lz == 0, lz == n only on
//    lanes 0 and n;
//  - s == n is the line ly + lz = n - x, whose positions off rows 0, n and
//    lanes 0, n are lz = 1 .. n - x - 1 (ly = n - x - lz, from 1 to n - x -
//    1);
//  - s == 2n with lz <= n is the line ly + lz = 2n - x with lz <= n; as ly
//    <= n, lz >= n - x there, and off row n and lane n it is lz = n - x + 1
//    .. n - 1 (ly = 2n - x - lz, from n - x + 1 to n - 1);
//  - x == 0 and x == n (the x-faces) hold only on planes 0 and n.
// So B7 copies every plane from u, but the x-faces' lanes of planes 0 and
// n from xf (phase 1), and then rewrites the lines through pair_installed
// (phase 2). The host tests check the claim at every position of a block.

// The number of positions of plane x's lines.
HYTEG_HD constexpr int pair_lines(int x, int N, int P) {
  return 2 * P + 2 * (N - 2) + (N - 2 - x > 0 ? N - 2 - x : 0) +
         (x - 1 > 0 ? x - 1 : 0);
}

// The position (ly, lz) of entry k of plane x's lines.
HYTEG_DEVICE void pair_line_at(int x, int k, int N, int P, int& ly,
                               int& lz) {
  const int n = N - 1;
  if (k < 2 * P) {  // rows 0 and n
    ly = k < P ? 0 : n;
    lz = k < P ? k : k - P;
  } else if (k < 2 * P + 2 * (N - 2)) {  // lanes 0 and n, rows 1 .. n - 1
    k -= 2 * P;
    lz = k < N - 2 ? 0 : n;
    ly = 1 + (k < N - 2 ? k : k - (N - 2));
  } else {  // the shell lines: lz = 1 .. n - x - 1, then n - x + 1 .. n - 1
    k -= 2 * P + 2 * (N - 2);
    const int na = n - x - 1 > 0 ? n - x - 1 : 0;
    lz = k < na ? 1 + k : n - x + 1 + (k - na);
    ly = (k < na ? n : 2 * n) - x - lz;
  }
}

// B7's threads per block, a compile-time argument of its kernel: 512
// where a plane holds at least kInstallWide slots, else 256; and the
// reads a thread of phase 2 issues before its stores (one after another,
// each would wait on the latency of memory in turn): 4 in a block of 512,
// 2 in one of 256, where the kernel then fits 32 registers and 8 blocks of
// small planes fit an SM. On the card (PR 12's variants), blocks of 256
// with 2 reads ran 48% slower at cube level 7 than 512 with 4, and blocks
// of 512 twice as slow as 256 on the shell at level 5.
constexpr int kInstallWide = 4096;
HYTEG_HD constexpr int pair_install_threads(int N, int P) {
  return N * P >= kInstallWide ? 512 : 256;
}
HYTEG_HD constexpr int pair_install_loads(int threads) {
  return threads >= 512 ? 4 : 2;
}

// Kernel B7, phase 1, for plane x of one pair, thread tid of nthreads:
// every slot of the plane from u, but on planes 0 and n the x-face's
// lanes from xf (plane 0: s <= n; plane n: s >= 2n, padding lanes
// included). An inner plane is one run over all threads; planes 0 and n
// two runs a row, a warp a run (copy_run: 16-byte loads and stores).
// Offsets are 32-bit: a pair's block holds N * L <= 2^31 slots.
template <class Out>
HYTEG_DEVICE void pair_install_copy(const float* u, const float* xf,
                                    const Out& out, int x, int N, int P,
                                    int tid, int nthreads) {
  const int n = N - 1, L = N * P;
  const bool edge = x == 0 || x == n;
  const int width = edge ? 32 : nthreads;
  for (int r = edge ? tid / 32 : 0; r < (edge ? 2 * N : 1);
       r += nthreads / width) {
    const int row = x * L + (r >> 1) * P;
    const int cut = row + (x == 0 ? n + 1 : n) - (r >> 1);  // x-face border
    const int i0 = edge ? ((r & 1) ? cut : row) : x * L;
    const int i1 = edge ? ((r & 1) ? row + P : cut) : (x + 1) * L;
    const bool face = edge && (r & 1) == (x == 0 ? 0 : 1);
    copy_run(face ? xf + (x == 0 ? 0 : L) + (i0 - x * L) : u + i0, out, i0,
             i1, tid % width, width);
  }
}

// A batch of phase 2 for one thread: LOADS positions of the lines and
// their installed values.
template <int LOADS>
struct PatchBatch {
  int at[LOADS];
  float v[LOADS];
};

// The reads of the batch from line entry k0 on (entries k0 + j *
// nthreads, up to end) through the tested map pair_installed, so that the
// precedence of the face arrays is pair_source's.
template <int LOADS>
HYTEG_DEVICE void pair_patch_read(const float* u,
                                  const PairFaces<const float>& f, int x,
                                  int k0, int end, int N, int P,
                                  int nthreads, PatchBatch<LOADS>& b) {
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    b.at[j] = 0;
    b.v[j] = 0.f;
    if (k0 + j * nthreads < end) {
      int ly, lz;
      pair_line_at(x, k0 + j * nthreads, N, P, ly, lz);
      b.at[j] = (x * N + ly) * P + lz;
      b.v[j] = pair_installed(u, f, x, ly, lz, N, P);
    }
  }
}

// Kernel B7, phase 2 (after all of phase 1's stores in the block): every
// position of plane x's lines rewritten. The thread's first batch was
// read before phase 1 (first), so that its loads were in flight with the
// copy's; it is stored here, then any further batches read and stored.
template <int LOADS, class Out>
HYTEG_DEVICE void pair_install_patch(const float* u,
                                     const PairFaces<const float>& f,
                                     const Out& out, int x, int N, int P,
                                     int tid, int nthreads,
                                     const PatchBatch<LOADS>& first) {
  const int end = pair_lines(x, N, P);
  PatchBatch<LOADS> b = first;
  for (int k0 = tid; k0 < end; k0 += LOADS * nthreads) {
    if (k0 != tid) pair_patch_read(u, f, x, k0, end, N, P, nthreads, b);
#pragma unroll
    for (int j = 0; j < LOADS; ++j)
      if (k0 + j * nthreads < end) out(b.at[j], b.v[j]);
  }
}

// -- kernel B8: a load for each face entry -----------------------------------
// The face arrays of a pair laid end to end: xf (2L), yf (2NP), zf (2N^2),
// df (2L) entries; the first entry of each array after xf, and the end.
struct PairFaceLayout {
  int yf, zf, df, end;
};
HYTEG_HD constexpr PairFaceLayout pair_face_layout(int N, int P) {
  return {2 * N * P, 4 * N * P, 4 * N * P + 2 * N * N, 6 * N * P + 2 * N * N};
}
HYTEG_HD constexpr int pair_face_entries(int N, int P) {
  return pair_face_layout(N, P).end;
}

// The extract map, gathered: the block slot x * L + ly * P + lz whose value
// face entry e of a pair takes, or -1 where the entry is 0 (its position
// lies outside the face's half). pair_store_point, which B6's walk stores
// through, scatters the same map; the host tests hold the two against
// each other at every entry.
//   xf: A on row 0 where s <= n, B on row n where s >= n (padding lanes
//       included), s = ly + lz;
//   yf (2, N, P): A at (x, 0, lz) where x + lz <= n, B at (x, n, lz) where
//       x + lz >= n, lz <= n;
//   zf (2, N, N): A at (x, ly, 0) where x + ly <= n, B at (x, ly, n) where
//       x + ly >= n;
//   df: A at row n - s where s <= n, B at row 2n - s where n <= s <= 2n,
//       lz <= n.
HYTEG_DEVICE int pair_entry_source(int e, int N, int P) {
  const int n = N - 1, L = N * P;
  const PairFaceLayout lay = pair_face_layout(N, P);
  if (e < lay.yf) {
    const int h = e >= L, l = e - h * L, ly = l / P, s = l - ly * P + ly;
    return (h ? s >= n : s <= n) ? h * n * L + l : -1;
  }
  if (e < lay.zf) {
    const int i = e - lay.yf, h = i >= L, r = i - h * L, x = r / P,
              lz = r - x * P;
    return (h ? x + lz >= n && lz <= n : x + lz <= n)
               ? x * L + h * n * P + lz : -1;
  }
  if (e < lay.df) {
    const int i = e - lay.zf, h = i >= N * N, r = i - h * N * N, x = r / N,
              ly = r - x * N;
    return (h ? x + ly >= n : x + ly <= n) ? x * L + ly * P + h * n : -1;
  }
  e -= lay.df;
  const int h = e >= L, l = e - h * L, ly = l / P, lz = l - ly * P;
  const int s = ly + lz;
  if (h) return s >= n && s <= 2 * n && lz <= n ? (2 * n - s) * L + l : -1;
  return s <= n ? (n - s) * L + l : -1;
}

// Face entry e of a pair (the arrays laid end to end) into its array.
template <class S>
HYTEG_DEVICE void pair_store_entry(const PairStores<S>& o, int e, float v,
                                   int N, int P) {
  const PairFaceLayout lay = pair_face_layout(N, P);
  if (e < lay.yf)
    o.xf(e, v);
  else if (e < lay.zf)
    o.yf(e - lay.yf, v);
  else if (e < lay.df)
    o.zf(e - lay.zf, v);
  else
    o.df(e - lay.df, v);
}

// B8: threads per block, the face entries of a pair per block (grid rows:
// the pair's entries over this, rounded up), and the reads a thread
// issues before its stores.
constexpr int kExtractThreads = 256;
constexpr int kExtractChunk = 1024;
constexpr int kExtractLoads = 4;

// Kernel B8 for face entries e0 .. e1 - 1 of one pair, thread tid of
// nthreads: each entry from its slot of u (pair_entry_source), or 0. The
// stores of consecutive threads are consecutive entries; the loads of the
// z-face lanes and the shells are a 32-byte sector each. A thread reads
// kExtractLoads entries before it stores them.
template <class S>
HYTEG_DEVICE void pair_extract_range(const float* u, const PairStores<S>& o,
                                     int e0, int e1, int N, int P, int tid,
                                     int nthreads) {
  for (int j0 = e0 + tid; j0 < e1; j0 += kExtractLoads * nthreads) {
    float v[kExtractLoads] = {};
#pragma unroll
    for (int k = 0; k < kExtractLoads; ++k)
      if (j0 + k * nthreads < e1) {
        const int src = pair_entry_source(j0 + k * nthreads, N, P);
        if (src >= 0) v[k] = u[src];
      }
#pragma unroll
    for (int k = 0; k < kExtractLoads; ++k)
      if (j0 + k * nthreads < e1)
        pair_store_entry(o, j0 + k * nthreads, v[k], N, P);
  }
}

}  // namespace hyteg
