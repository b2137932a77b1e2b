// Per-point arithmetic of the stripped-stencil probes (kernels P2).
//
// The probes take kernels B1 (box_stencil.cu) and B2 (p1_const_stencil.cu)
// apart: each computes a stencil sum over cyclic reads and nothing else,
// so the gap between a probe's time and the real kernel's time on the same
// block is the cost of what the probe leaves out. They are wrong at shells
// and faces by design. Layouts and tap orders follow
// hyteg_tpu_torch/kernels/probes.py:
//
// box_variant (the box probe of scripts/prof_r5.py::bench_box_variants):
//   y[x, l] = sum_{k < n_taps} w[s_k, l] * u[x, (l + ls_k) mod L],
//   u (X, L), L = Y * Z; w (15, L); s_k is tap k in the script's order
//   (box_probe_dir) and ls_k = dy * Z + dz of direction s_k. Without the
//   shift every tap reads u[x, l]. The x axis is never shifted.
// tet_stripped (the tet probes of scripts/prof_r5b.py::bench_fma and
// scripts/kernel_probe.py::make_stripped):
//   y[c, x, l] = M * sum_{s < n_taps} w[c, s] *
//                u[c, (x + dx_s) mod N, (l + dy_s * pitch + dz_s) mod L],
//   u (C, N, L), L = N * pitch; w (C, 15) per-cell weights; M = 1, K0, or
//   K0 without the diagonal shell (see tet_probe_point).
#pragma once

#include <type_traits>

#ifndef HYTEG_DEVICE
#define HYTEG_DEVICE __device__ __forceinline__
#endif

#include "box_stencil.cuh"

namespace hyteg {

constexpr int kProbeDirs = 15;   // stencil directions of both stencils
constexpr int kProbeShells = 1;  // n_j - 1 diagonal shells of the P1 stencil

enum ProbeMask : int { kMaskNone = 0, kMaskK0 = 1, kMaskK0Shells = 2 };

// Tap k of the box probe -> direction s of structured/kuhn.py's
// stencil_dirs: the lane classes dy * Z + dz in ascending order
// (-Z-1, -Z, -1, 0, 1, Z, Z+1 for Z >= 2), then the direction index.
HYTEG_DEVICE int box_probe_dir(int k) {
  switch (k) {
    case 0: return 0;
    case 1: return 4;
    case 2: return 1;
    case 3: return 5;
    case 4: return 2;
    case 5: return 6;
    case 6: return 3;
    case 7: return 7;
    case 8: return 11;
    case 9: return 8;
    case 10: return 12;
    case 11: return 9;
    case 12: return 13;
    case 13: return 10;
    default: return 14;
  }
}

// i + d wrapped into [0, n), for |d| < n, where the sign of d (sgn) is a
// compile-time constant once the tap loop is unrolled: one add, one
// compare and one conditional subtract (or add), no remainder.
HYTEG_DEVICE int wrap_signed(int i, int d, int sgn, int n) {
  int j = i + d;
  if (sgn > 0) {
    if (j >= n) j -= n;
  } else if (sgn < 0) {
    if (j < 0) j += n;
  }
  return j;
}

// i + d wrapped into [0, n) for a run-time |d| < n: two compares, as B2's
// bounds check on one axis has.
HYTEG_DEVICE int wrap_any(int i, int d, int n) {
  int j = i + d;
  if (j < 0) j += n;
  if (j >= n) j -= n;
  return j;
}

// The n_taps weights of one lane, w[k] = w_lanes[s_k, lane], loaded once
// for a tile of rows, as B1 keeps its 15 interior weights.
template <int kTaps, class LoadW>
HYTEG_DEVICE void box_probe_weights(const LoadW& load_w, float (&w)[kTaps],
                                    int lane, int L) {
#pragma unroll
  for (int k = 0; k < kTaps; ++k)
    w[k] = load_w((long long)box_probe_dir(k) * L + lane);
}

// y[x, lane] of the box probe; row = x * L. The taps of one lane class
// read the same element (x is never shifted), so the element is loaded
// once per class, as the Pallas probe rolls once per class; without the
// shift it is loaded once and every tap is a multiply-add. Left out
// against B1: the x-axis neighbours, the row-class weight switch at rows
// 0 and X-1 and the bounds checks.
template <bool kShift, int kTaps, class Load>
HYTEG_DEVICE float box_probe_point(const Load& load, const float (&w)[kTaps],
                                   long long row, int lane, int L, int Z) {
  float acc = 0.f, v = 0.f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const int s = box_probe_dir(k);
    const int dy = box_dir(s, 1), dz = box_dir(s, 2);
    bool fresh = k == 0;
    if (kShift && k > 0) {
      const int p = box_probe_dir(k - 1);
      fresh = box_dir(p, 1) != dy || box_dir(p, 2) != dz;
    }
    if (fresh)
      v = load(row + (kShift ? wrap_signed(lane, dy * Z + dz,
                                           dy != 0 ? dy : dz, L)
                             : lane));
    acc = fmaf(w[k], v, acc);
  }
  return acc;
}

struct ProbeTables {
  int dx[kProbeDirs];  // x offset of direction s
  int dl[kProbeDirs];  // lane offset dy * pitch + dz
};

// Host: the tables of the (15, 3) int32 directions at one pitch.
inline ProbeTables probe_tables(const int* dirs, int pitch) {
  ProbeTables t;
  for (int s = 0; s < kProbeDirs; ++s) {
    t.dx[s] = dirs[3 * s];
    t.dl[s] = dirs[3 * s + 1] * pitch + dirs[3 * s + 2];
  }
  return t;
}

// y[x, lane] of one cell of the tet probe, with w the cell's weights.
// kMaskNone: M = 1, every slot sums its taps (no y, z index work).
// kMaskK0: M = K0 = [S <= n and z < N], S = x + y + z; a slot outside K0
//   returns 0 before any load, as B2 returns 0 outside the tet.
// kMaskK0Shells: M = K0 * prod_{m < n_j-1} (1 - [S == n - m]); the
//   diagonal shell returns 0 as well.
// Left out against B2: the shell-resolved weights (w_in / w_sh), the
// per-point face-group corrections (the 7 face sets and their e weights)
// and the zero fill beyond the block (cyclic reads instead).
template <int kMask, int kTaps>
HYTEG_DEVICE float tet_probe_point(const float* src, int x, int lane, int N,
                                   int pitch, const ProbeTables& t,
                                   const float* w) {
  const int L = N * pitch;
  if (kMask != kMaskNone) {
    const int n = N - 1;
    const int y = lane / pitch;
    const int z = lane - y * pitch;
    const int S = x + y + z;
    if (z >= N || S > n) return 0.f;
    if (kMask == kMaskK0Shells && S > n - kProbeShells) return 0.f;
  }
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < kTaps; ++s) {
    const int xs = wrap_any(x, t.dx[s], N);
    const int ls = wrap_any(lane, t.dl[s], L);
    acc = fmaf(w[s], src[(long long)xs * L + ls], acc);
  }
  return acc;
}

// Host: calls f(std::integral_constant<int, n_taps>{}) for the tap counts
// the probes use (1, 6, 15); false for any other count.
template <int V>
using ProbeInt = std::integral_constant<int, V>;

template <class F>
inline bool probe_with_taps(int n_taps, F&& f) {
  switch (n_taps) {
    case 1: f(ProbeInt<1>{}); return true;
    case 6: f(ProbeInt<6>{}); return true;
    case 15: f(ProbeInt<15>{}); return true;
    default: return false;
  }
}

// Host: calls f(std::integral_constant<int, mask>{}) for a ProbeMask.
template <class F>
inline bool probe_with_mask(int mask, F&& f) {
  switch (mask) {
    case kMaskNone: f(ProbeInt<kMaskNone>{}); return true;
    case kMaskK0: f(ProbeInt<kMaskK0>{}); return true;
    case kMaskK0Shells: f(ProbeInt<kMaskK0Shells>{}); return true;
    default: return false;
  }
}

}  // namespace hyteg
