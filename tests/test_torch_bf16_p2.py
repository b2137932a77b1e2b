"""The bf16 P2 path of the PyTorch port against the JAX package: kernel
B5's bf16 form in 3D and 2D (its plain version here; the kernel's walks
compiled with the host C++ compiler, bf16 emulated), the bf16 P2
operator's tables and applies (ROADMAP C-ref14), the bf16 P2 GMG stacks
(3D and 2D) cycle by cycle, an f32 iterative refinement around them, and
the dtype contract of B5 and B2.

The JAX side runs as its own CPU tests run it: ``p2_const_apply_xla``,
the Pallas kernel in interpret mode, and its operators' plain applies.
Its stacks take the port's eigenvalue bounds (``eigs=``) and element
matrices; each JAX level callable is jitted once, and the JAX package's
own ``GeometricMultigridSolver.cycle`` drives them.

Tolerances:
- bf16 results within one bf16 ulp of the f32 result of the same bf16
  values: |d| <= 2^-7 |ref| + 1e-6 max|ref| elementwise (``ulp_excess``,
  tests/test_torch_mixed_precision.py);
- against the JAX package's bf16 applies, which accumulate in bf16
  (C-ref11): |d| <= (16 + 2 TABLE_ULPS) 2^-8 of the terms' magnitudes
  (the apply of |W| or |elMat| to |u|), the bf16 accumulation plus the two
  packages' table gap;
- the bf16 tables of the two packages (C-ref14): within TABLE_ULPS bf16
  ulps (2^-7 each) of each weight's sum of |terms|; element matrices
  within one bf16 ulp of their value (two roundings of f32 values); each
  plus CANCEL of the largest, for entries that are 0 up to the assembly's
  rounding (1e-18 in one package, 1e-9 in the other);
- bf16 GMG cycles: one cycle takes both stacks to the floor that the
  bf16 rounding of the iterate sets (2.5e-3 to 1.9e-2 of r0 here), where
  the JAX stack's bf16 sums (C-ref11) sit higher (2.4x in 3D). Gated after
  each of the first CYCLES cycles: the two iterates within ITERATE_REL =
  4 2^-8 relative L2 (2.1 2^-8 read), the port's residual (in f32, on the
  f32 stack's operator) at most (1 + CYCLE_REL) x the JAX stack's, and
  the first cycle's residuals below FIRST_CYCLE_MAX of r0;
- refinement: within 2x the f32 stack's own plateau and below 0.1x the
  bf16-only loop, as tests/test_torch_mixed_precision.py.
"""

import ctypes
import dataclasses
import math
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.functions.p2 import P2Space as JP2Space
from hyteg_tpu.kernels import p2_const_stencil as jk
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import p2_elementwise as jop
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu.solvers.gmg import GeometricMultigridSolver as JGMG
from hyteg_tpu.solvers.templates import make_p2_gmg as jmake_p2_gmg
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.types import FLAG_INNER
from hyteg_tpu_torch.functions.p2 import P2Space
from hyteg_tpu_torch.kernels import p1_const_stencil as tk2
from hyteg_tpu_torch.kernels import p2_const_stencil as tk
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.operators import p2_elementwise as top
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.solvers.refinement import iterative_refinement
from hyteg_tpu_torch.solvers.templates import make_p2_gmg

from tests.test_torch_const_stencil import CSRC
from tests.test_torch_mixed_precision import (BF16_ULP, CANCEL, XLA_BOUND,
                                              round_bf16, ulp_excess)

torch.set_num_threads(1)

bf16 = torch.bfloat16
KINDS = ("laplace", "mass")
TABLE_ULPS = 2
CYCLES = 3
ITERATE_REL = 4 * 2.0 ** -8
CYCLE_REL = 0.1
FIRST_CYCLE_MAX = 0.05

# ---------------------------------------------------------------------------
# the walks in bf16, compiled for the host (also used by test_torch_bf16_2d)
# ---------------------------------------------------------------------------

HOST_HARNESS = r"""
#include <cmath>
#include <cstdint>
#include <cstring>
// Pair loads (B5-2D's windows) must start at a 4-byte boundary and
// overlap the face they serve; pair stores start at 4 bytes, quads at 8.
static const uint16_t* g_face_lo;
static const uint16_t* g_face_hi;
static long long g_bad;
static void check_pair_load(const void* q) {
  const uint16_t* h = static_cast<const uint16_t*>(q);
  if ((reinterpret_cast<uintptr_t>(h) & 3) != 0 || h + 1 < g_face_lo ||
      h >= g_face_hi)
    ++g_bad;
}
#define HYTEG_PAIR_LOAD_HOOK(q) check_pair_load(q)
#define HYTEG_DEVICE inline
#include "p1_const_stencil.cuh"
#include "p1_tri.cuh"
#include "p2_const_stencil.cuh"
using namespace hyteg;
// bf16 as the card stores it: the top 16 bits of an f32.
static float bf2f(uint16_t h) {
  uint32_t u = (uint32_t)h << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// f32 -> bf16, round to nearest even (the card's __float2bfloat16_rn).
static uint16_t f2bf(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (uint16_t)((u >> 16) | 0x40u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}
struct F2 {
  float x, y;
};
// The walks' source (csrc/bf16.cuh's BF16Src): widens each load.
struct HostBF16Src {
  const uint16_t* p;
  float operator[](long long i) const { return bf2f(p[i]); }
  HostBF16Src operator+(long long k) const { return {p + k}; }
  F2 load2() const { return {bf2f(p[0]), bf2f(p[1])}; }
  int pair_parity() const {
    return (int)((reinterpret_cast<uintptr_t>(p) >> 1) & 1);
  }
};
// The walks' store (BF16CellStore): rounds once, counts each write.
struct HostBF16Store {
  uint16_t* dst;
  int* count;
  void operator()(int i, float v) const {
    dst[i] = f2bf(v);
    ++count[i];
  }
  int to_aligned(int i) const {
    const unsigned half = (unsigned)(reinterpret_cast<uintptr_t>(dst + i) >> 1);
    return (int)((0u - half) & 3u);
  }
  void pair(int i, float a, float b) const {
    if (reinterpret_cast<uintptr_t>(dst + i) % 4) ++g_bad;
    (*this)(i, a);
    (*this)(i + 1, b);
  }
  void quad(int i, float a, float b, float c, float d) const {
    if (reinterpret_cast<uintptr_t>(dst + i) % 8) ++g_bad;
    (*this)(i, a);
    (*this)(i + 1, b);
    (*this)(i + 2, c);
    (*this)(i + 3, d);
  }
};
// Kernel B5's bf16 thread blocks (3D) one after another: per cell the
// widened staging of the 24 rows off the faces, per plane x every thread
// of the block through p2_const_apply_plane, face rows read from W.
// Returns the accesses that broke their rule.
extern "C" long long b5_bf16(const uint16_t* src, const uint16_t* W,
                             uint16_t* dst, int C, int M, int pitch,
                             int* count) {
  g_bad = 0;
  float wr[24 * kP2Dirs];
  const long long cell = (long long)M * M * pitch;
  for (int c = 0; c < C; ++c) {
    const uint16_t* Wc = W + (long long)c * kP2Rows * kP2Dirs;
    for (int i = 0; i < 24 * kP2Dirs; ++i) wr[i] = bf2f(Wc[i]);
    for (int x = 0; x < M; ++x)
      for (int tid = 0; tid < kPlaneWarps * 32; ++tid)
        p2_const_apply_plane(HostBF16Src{src + c * cell}, HostBF16Src{Wc}, wr,
                             HostBF16Store{dst + c * cell, count + c * cell},
                             x, M, pitch, tid >> 5, tid & 31, kPlaneWarps);
  }
  return g_bad;
}
// Kernel B5's bf16 2D thread blocks: per face the widened 48 rows, per
// band every thread through p2_const_apply_band_2d.
extern "C" long long b5_2d_bf16(const uint16_t* src, const uint16_t* W,
                                uint16_t* dst, int C, int M, int* count) {
  g_bad = 0;
  constexpr int nW = kP2Rows2D * kP2Dirs2D;
  float w[nW];
  const long long face = (long long)M * M;
  for (int c = 0; c < C; ++c) {
    for (int i = 0; i < nW; ++i) w[i] = bf2f(W[c * nW + i]);
    g_face_lo = src + c * face;
    g_face_hi = g_face_lo + face;
    for (int x0 = 0; x0 < M; x0 += kBandRows2D)
      for (int tid = 0; tid < kPlaneWarps * 32; ++tid)
        p2_const_apply_band_2d(HostBF16Src{src + c * face}, w,
                               HostBF16Store{dst + c * face, count + c * face},
                               x0, M, tid >> 5, tid & 31);
  }
  return g_bad;
}
// Kernel B2's bf16 2D thread blocks: the widened weights folded per face,
// every thread of every band through const_apply_band_2d.
extern "C" long long b2_2d_bf16(const uint16_t* src, const uint16_t* A,
                                const uint16_t* E, uint16_t* dst, int C,
                                int N, const int* gmask, int* count) {
  g_bad = 0;
  ConstTables2D t;
  for (int g = 0; g < kConst2Groups; ++g) t.gmask[g] = gmask[g];
  constexpr int nA = kConst2Dirs * kConstShells;
  constexpr int nE = kConst2Groups * kConstShells * kConst2Dirs;
  float a[nA], e[nE], rows[kConst2Rows * kConst2Dirs];
  const long long face = (long long)N * N;
  for (int c = 0; c < C; ++c) {
    for (int i = 0; i < nA; ++i) a[i] = bf2f(A[c * nA + i]);
    for (int i = 0; i < nE; ++i) e[i] = bf2f(E[c * nE + i]);
    const_fold_rows(a, e, t, rows, 0, 1);
    for (int x0 = 0; x0 < N; x0 += kBandRows2DP1)
      for (int tid = 0; tid < kPlaneWarps * 32; ++tid)
        const_apply_band_2d(HostBF16Src{src + c * face},
                            HostBF16Store{dst + c * face, count + c * face},
                            x0, N, rows, tid >> 5, tid & 31, kPlaneWarps);
  }
  return g_bad;
}
// Kernel B3's bf16 2D thread blocks (no coefficient): the widened element
// matrices folded into 6 weights and 8 class values per face, every
// thread of every band through tri_diag_band.
extern "C" long long b3_2d_bf16(const uint16_t* elm, uint16_t* dst, int C,
                                int N, int lumped, int* count) {
  g_bad = 0;
  constexpr int kElm = kTriClasses * kTriVerts * kTriVerts;
  float e[kElm], w[kTriClasses * kTriVerts], cls[kTriDiagRows];
  const long long face = (long long)N * N;
  for (int c = 0; c < C; ++c) {
    for (int i = 0; i < kElm; ++i) e[i] = bf2f(elm[c * kElm + i]);
    tri_diag_fold_weights(e, lumped, w, 0, 1);
    tri_fold_classes(w, cls, 0, 1);
    for (int x0 = 0; x0 < N; x0 += kApplyR2)
      for (int tid = 0; tid < kApplyThreads; ++tid)
        tri_diag_band(HostBF16Store{dst + c * face, count + c * face}, x0, N,
                      cls, tid >> 5, tid & 31);
  }
  return g_bad;
}
"""


def build_host_bf16(tmp_path_factory):
    """The harness above as a shared library (skips without a host C++
    compiler)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_bf16_walks")
    (d / "harness.cpp").write_text(HOST_HARNESS)
    so = d / "libhost_bf16_walks.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (("b5_bf16", [P, P, P, I, I, I, P]),
                       ("b5_2d_bf16", [P, P, P, I, I, P]),
                       ("b2_2d_bf16", [P, P, P, P, I, I, P, P]),
                       ("b3_2d_bf16", [P, P, I, I, I, P])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = LL
    return lib


@pytest.fixture(scope="module")
def host_bf16(tmp_path_factory):
    return build_host_bf16(tmp_path_factory)


def _mesh(mod, name):
    return {"tet": mod.mesh_single_tet, "cube1": lambda: mod.mesh_unit_cube(1),
            "rect": lambda: mod.mesh_rectangle(nx=2, ny=2)}[name]()


def _bf16_space_op(name, level, kind, pitch=None):
    """The port's bf16 P2 space and operator, and its f32 operator."""
    st = CellStorage(_mesh(tmi, name))
    sp16 = P2Space(st, level, device="cpu", dtype=bf16, pitch=pitch)
    sp32 = P2Space(st, level, device="cpu", pitch=pitch)
    return (sp16, top.P2ElementwiseOperator(sp16, kind),
            top.P2ElementwiseOperator(sp32, kind))


def _source(sp, seed):
    """A seeded bf16 block on the simplex, replicas consistent."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(sp.block_shape, generator=g) * sp.vertex_mask_t.float()
    return sp.exchange_rep(x).to(bf16)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,level,pitch", [
    ("cube1", 1, None), ("cube1", 2, None), ("cube1", 2, 17), ("tet", 3, 17),
    ("rect", 1, None), ("rect", 3, None), ("rect", 4, None)])
def test_host_b5_bf16_walk(host_bf16, name, level, pitch, kind):
    """Kernel B5's bf16 walk (3D plane walk; 2D band walk with its pair
    windows and pair stores) on a bf16 operator's W: every slot written
    once, every pair load, pair store and quad at its boundary, 0 outside
    the simplex, within one bf16 ulp of the f32 apply of the same bf16
    values and of the plain bf16 version. Pitch 17 makes the 3D rows
    alternate their 4-byte alignment, as pitch 129 does on the card."""
    sp, op, _ = _bf16_space_op(name, level, kind, pitch)
    W = op.stencil_folded
    src = _source(sp, 10 + level)
    dst = torch.full_like(src, float("nan"))
    count = torch.zeros(src.shape, dtype=torch.int32)
    C, M = src.shape[0], sp.M
    if sp.dim == 3:
        bad = host_bf16.b5_bf16(src.data_ptr(), W.data_ptr(), dst.data_ptr(),
                                C, M, sp.pitch, count.data_ptr())
    else:
        bad = host_bf16.b5_2d_bf16(src.data_ptr(), W.data_ptr(),
                                   dst.data_ptr(), C, M, count.data_ptr())
    assert bad == 0
    assert (count == 1).all()
    assert (dst[:, ~sp.vertex_mask_t.bool()] == 0).all()
    exact = tk.p2_const_apply_torch(src.float(), W.float(), level, sp.pitch,
                                    sp.dim)
    assert ulp_excess(dst, exact.numpy()) <= 1.0
    plain = tk.p2_const_apply(src, W, level, sp.pitch, sp.dim)
    assert plain.dtype == bf16
    assert ulp_excess(dst, plain.float().numpy()) <= 1.0


# ---------------------------------------------------------------------------
# B5's plain bf16 version against the JAX package's
# ---------------------------------------------------------------------------


def _jax_space(name, level, dtype=jnp.float32):
    return JP2Space(JStorage(_mesh(jmi, name)), level, dtype=dtype)


def _abs_terms(elmats, dim):
    """The folded rows of |elMat|: every term of every weight of W taken
    in absolute value (A and E summed from |elMat|, E's signs dropped)."""
    ea = elmats.abs()
    groups, rows, cols, _ = tk.p2_face_tables(dim)
    dirs, _, _, n_par, n_j = tk.p2_stencil_tables(dim)
    C = ea.shape[0]
    E = torch.zeros(C, len(groups) * n_par * dirs.shape[0] * n_j).index_add_(
        1, torch.as_tensor(cols), ea.reshape(C, -1)[:, rows])
    E = E.reshape(C, len(groups), n_par, dirs.shape[0], n_j)
    A = tk.p2_stencil_weights(ea, dim)
    # the fold subtracts E: its absolute terms add
    return A, E, tk.p2_folded_weights(A, -E)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,level", [("tet", 1), ("rect", 2)])
def test_b5_plain_bf16_vs_jax(name, level, kind):
    """The port's plain bf16 B5 against the JAX package's on the same bf16
    source and bf16 tables A, E (its f32 element matrices rounded once):
    within one bf16 ulp of the f32 result of the port's own bf16 W; within
    (16 + 2 TABLE_ULPS) 2^-8 of the terms' magnitudes of the JAX plain bf16
    apply, which accumulates in bf16 (C-ref11), and in 2D of the Pallas
    kernel in interpret mode (in 3D its interpret mode takes ~20 s on the
    CPU; the JAX package's own tests hold it to ``p2_const_apply_xla``);
    f32 W with a bf16 source gives the same result as bf16 W."""
    jsp = _jax_space(name, level)
    dim = jsp.dim
    elm = np.asarray(jop.compute_p2_elmats(jsp, kind))
    et = torch.tensor(elm)
    A, E = tk.p2_stencil_weights(et, dim), tk.p2_face_weights(et, dim)
    Ab, Eb = round_bf16(A.numpy()), round_bf16(E.numpy())
    W = tk.p2_folded_weights(A, E).to(bf16)
    rng = np.random.default_rng(20 + level)
    xb = round_bf16(rng.standard_normal(jsp.block_shape)
                    * jsp.vertex_mask[None])
    x = torch.as_tensor(xb).to(bf16)
    got = tk.p2_const_apply(x, W, level, jsp.pitch, dim)
    assert got.dtype == bf16
    exact = tk.p2_const_apply_torch(x.float(), W.float(), level, jsp.pitch,
                                    dim)
    assert ulp_excess(got, exact.numpy()) <= 1.0
    assert torch.equal(tk.p2_const_apply(x, W.float(), level, jsp.pitch, dim),
                       got)
    terms = tk.p2_const_apply_torch(x.float().abs(), _abs_terms(et, dim)[2],
                                    level, jsp.pitch, dim).numpy()
    bound = (XLA_BOUND + 2 * TABLE_ULPS * 2.0 ** -8) * terms
    j16 = lambda a: jnp.asarray(a, dtype=jnp.bfloat16)
    refs = [jk.p2_const_apply_xla(j16(xb), j16(Ab), j16(Eb), level, dim,
                                  jsp.pitch)]
    if dim == 2:
        refs.append(jk.p2_const_apply_pallas(j16(xb), j16(Ab), j16(Eb), level,
                                             dim, jsp.pitch, interpret=True))
    for ref in refs:
        ref = np.asarray(ref.astype(jnp.float32))
        assert (np.abs(got.float().numpy() - ref) <= bound).all()


# ---------------------------------------------------------------------------
# the bf16 P2 operator against the JAX package's (C-ref14)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,level", [("tet", 1), ("rect", 2)])
def test_bf16_p2_operator_tables_vs_jax(name, level, kind):
    """Both packages' bf16 P2 operators on one mesh (ROADMAP C-ref14): the
    JAX package rounds its f32 element matrices to bf16 and sums A and E
    from them in bf16; the port sums A, E and W from its f32 matrices in
    f32 and rounds each once. Element matrices within one bf16 ulp; A, E
    and W (the JAX tables folded in f32, interop.p2_tables_from_reference)
    within TABLE_ULPS bf16 ulps of each weight's sum of |terms|; the
    diagonals and the applies of one bf16 source within (16 + 2
    TABLE_ULPS) 2^-8 of their terms' magnitudes."""
    jsp = _jax_space(name, level, jnp.bfloat16)
    jo = jop.P2ElementwiseOperator(jsp, kind)
    sp16, o16, o32 = _bf16_space_op(name, level, kind)
    dim = sp16.dim
    j = lambda a: torch.tensor(interop.host_array(a))
    e32 = o32.elmats

    def within(gap, ulps, scale):
        return bool((gap <= ulps * BF16_ULP * scale
                     + CANCEL * scale.max()).all())

    assert o16.elmats.dtype == bf16 and o16.stencil_folded.dtype == bf16
    assert within((j(jo.elmats) - o16.elmats.float()).abs(), 1, e32.abs())
    A_abs, E_abs, W_abs = _abs_terms(e32, dim)
    port = {"A": tk.p2_stencil_weights(e32, dim).to(bf16),
            "E": tk.p2_face_weights(e32, dim).to(bf16),
            "W": o16.stencil_folded}
    ref = {"A": j(jo.stencil), "E": j(jo.stencil_face),
           "W": interop.p2_tables_from_reference(jo.stencil, jo.stencil_face,
                                                 device="cpu")}
    for name_, terms in (("A", A_abs), ("E", E_abs), ("W", W_abs)):
        gap = (ref[name_] - port[name_].float()).abs()
        assert within(gap, TABLE_ULPS, terms), name_
    assert torch.equal(port["W"], tk.p2_folded_weights(
        tk.p2_stencil_weights(e32, dim), tk.p2_face_weights(e32, dim)).to(bf16))
    rel = XLA_BOUND + 2 * TABLE_ULPS * 2.0 ** -8
    # diagonals: the JAX package sums in bf16, the port in f32
    dj = j(jo.diagonal_raw())
    d = o16.diagonal_raw()
    assert d.dtype == bf16
    dterms = sp16.exchange_add(top.p2_diagonal_local(
        e32.abs(), level, dim, sp16.block_shape, sp16.pitch))
    assert ((dj - d.float()).abs() <= rel * dterms).all()
    rng = np.random.default_rng(30 + level)
    xb = round_bf16(rng.standard_normal(jsp.block_shape)
                    * jsp.vertex_mask[None])
    x = torch.as_tensor(xb).to(bf16)
    yj = j(jo.apply_raw(jnp.asarray(xb, dtype=jnp.bfloat16)))
    y = o16.apply_raw(x)
    assert y.dtype == bf16
    terms = sp16.exchange_add(top.p2_apply_local(x.float().abs(), e32.abs(),
                                                 level, dim, sp16.pitch))
    assert ((yj - y.float()).abs() <= rel * terms).all()


# ---------------------------------------------------------------------------
# the bf16 P2 GMG stacks
# ---------------------------------------------------------------------------

GMG_CASES = {"3d": ("tet", 0, 1), "2d": ("rect", 0, 2)}
COARSE_ITERS = 20


def _jitted_cycle(jstack, pre, post):
    """The JAX stack's V(pre, post) cycle through the JAX package's own
    GeometricMultigridSolver.cycle, over its levels' callables each jitted
    once: a level's ``pre`` (= ``post``) smoothing steps are one jitted
    call of its own scanned repeat (GeometricMultigridSolver._repeat_smooth),
    so the smoother compiles once per level, not once in each of the
    unrolled pre and post scans of a whole jitted cycle."""
    assert pre == post
    g = jstack.gmg

    def level(L):
        rep = jax.jit(lambda x, b, s=L.smooth: JGMG._repeat_smooth(s, x, b,
                                                                   pre))
        jit = lambda f: None if f is None else jax.jit(f)
        return dataclasses.replace(
            L, smooth=rep, apply=jax.jit(L.apply), restrict=jit(L.restrict),
            prolongate_add=jit(L.prolongate_add), residual=jit(L.residual))

    return JGMG({l: level(L) for l, L in g.levels.items()},
                jax.jit(g.coarse_solve), g.min_level, g.max_level, 1, 1).cycle


@pytest.fixture(scope="module", params=sorted(GMG_CASES))
def gmg_pair(request):
    """The port's bf16 P2 stack on the JAX package's bf16 element matrices
    (carried across) with its own power-iteration eigenvalue bounds, the
    JAX package's bf16 stack with those bounds, the port's f32 stack, and
    a seeded consistent rhs."""
    name, lo, hi = GMG_CASES[request.param]
    st, js = CellStorage(_mesh(tmi, name)), JStorage(_mesh(jmi, name))
    kw = dict(coarse_iters=COARSE_ITERS, device="cpu")
    s32 = make_p2_gmg(st, lo, hi, **kw)
    jelm = {l: jop.compute_p2_elmats(JP2Space(js, l, dtype=jnp.bfloat16),
                                     "laplace") for l in range(lo, hi + 1)}
    s16 = make_p2_gmg(st, lo, hi, dtype=bf16, elmats={
        l: interop.elmats_from_reference(e, device="cpu")
        for l, e in jelm.items()}, **kw)
    assert s16.space().dtype == bf16
    assert all(d.dtype == bf16 for d in s16.inv_diags.values())
    jstack = jmake_p2_gmg(js, lo, hi, coarse_iters=COARSE_ITERS,
                          dtype=jnp.bfloat16,
                          eigs=interop.eigs_from_reference(s16.eigs))
    for l in range(lo, hi + 1):
        np.testing.assert_array_equal(
            interop.host_array(jstack.operators[l].elmats),
            s16.operators[l].elmats.float().numpy())
    sp = s32.space()
    g = torch.Generator().manual_seed(5)
    b = sp.exchange_rep(torch.randn(sp.block_shape, generator=g)
                        * sp.vertex_mask_t)
    b = s32.residual(torch.zeros_like(b), b)
    return s32, s16, jstack, b


def test_bf16_p2_gmg_vs_jax(gmg_pair):
    """CYCLES V(3,3) cycles of both packages' bf16 P2 stacks from 0 on one
    bf16 rhs: after each cycle the iterates within ITERATE_REL, the port's
    residual (of the iterate in f32, on the f32 stack's operator) not above
    (1 + CYCLE_REL) x the JAX stack's, the first cycle's below
    FIRST_CYCLE_MAX of r0."""
    s32, s16, jstack, b = gmg_pair
    b16 = b.to(bf16)
    cycle = _jitted_cycle(jstack, 3, 3)
    jb = jnp.asarray(b16.float().numpy(), dtype=jnp.bfloat16)
    x, jx = s16.space().zeros(), jnp.zeros_like(jb)
    r0 = float(s32.residual_norm(torch.zeros_like(b), b))
    res, jres = [], []
    for _ in range(CYCLES):
        x = s16.gmg.cycle(x, b16)
        jx = cycle(jx, jb)
        assert x.dtype == bf16 and jx.dtype == jnp.bfloat16
        res.append(float(s32.residual_norm(x.float(), b)) / r0)
        jxt = interop.block_from_reference(jx, device="cpu")
        jres.append(float(s32.residual_norm(jxt, b)) / r0)
        assert (x.float() - jxt).norm() <= ITERATE_REL * jxt.norm()
    for r, jr in zip(res, jres):
        assert r <= (1 + CYCLE_REL) * jr, (res, jres)
    assert max(res[0], jres[0]) < FIRST_CYCLE_MAX, (res, jres)


def test_refinement_around_a_bf16_p2_vcycle(gmg_pair):
    """An f32 outer loop around one bf16 V(3,3) cycle of the bf16 P2 stack
    reaches within 2x of the f32 stack's own plateau and below 0.1x the
    bf16-only loop (the card's mixed_precision_p2 gates, at a CPU size)."""
    s32, s16, _, b = gmg_pair
    top_ = max(s32.spaces)
    sp, sd = s32.space(), s32.sd()
    r0 = float(s32.residual_norm(sp.zeros(), b))
    x = sp.zeros()
    res = []
    for _ in range(8):
        x = s32.gmg.cycle(x, b)
        res.append(float(s32.residual_norm(x, b)))
    plateau = sum(res[-3:]) / 3
    inner = lambda r: s16.gmg.cycle(s16.space().zeros(), r)
    apply_hi = lambda v: s32.operators[top_].apply_inner(v, sd, FLAG_INNER)
    xr = iterative_refinement(apply_hi, inner, b, sp.zeros(), 8)
    rel = float(s32.residual_norm(xr, b))
    x16, b16 = s16.space().zeros(), b.to(bf16)
    for _ in range(8):
        x16 = x16 + inner(s16.residual(x16, b16))
    rel16 = float(s32.residual_norm(x16.float(), b))
    assert rel <= 2 * plateau and rel < 0.1 * rel16, (rel, plateau, rel16, r0)


# ---------------------------------------------------------------------------
# the dtype contract (B5, B2), the same on every device
# ---------------------------------------------------------------------------


def test_b5_and_b2_dtype_contract():
    """A bf16 source takes bf16 or f32 weights (rounded as the Pallas
    kernels round them: the same result); other weight types with a bf16
    source, and bf16 weights with an f32 source, raise; the source is
    never cast. The card's bf16_refusals phase checks the same calls."""
    sp, op, o32 = _bf16_space_op("cube1", 1, "laplace")
    x = _source(sp, 40)
    W = o32.stencil_folded
    assert torch.equal(tk.p2_const_apply(x, W, 1, sp.pitch),
                       tk.p2_const_apply(x, W.to(bf16), 1, sp.pitch))
    for bad_src, bad_W in ((x, W.double()), (x.float(), W.to(bf16)),
                           (x, W.half())):
        with pytest.raises(ValueError, match="bf16"):
            tk.p2_const_apply(bad_src, bad_W, 1, sp.pitch)
    A = torch.zeros(x.shape[0], 15, 2)
    E = torch.zeros(A.shape[0], 7, 2, 15)
    with pytest.raises(ValueError, match="bf16"):
        tk2.p1_const_apply(x, A.double(), E.double(), 1, 3, sp.pitch)
    with pytest.raises(ValueError, match="bf16"):
        tk2.p1_const_apply(x.float(), A.to(bf16), E.to(bf16), 1, 3,
                           sp.pitch)


def test_interop_carries_bf16_exactly():
    """The JAX package's bf16 arrays cross as their f32 values and round
    back to the same bits: element matrices, blocks, eigenvalue bounds."""
    jsp = _jax_space("tet", 1, jnp.bfloat16)
    elm = jop.compute_p2_elmats(jsp, "laplace")
    assert elm.dtype == jnp.bfloat16
    t = interop.elmats_from_reference(elm, device="cpu", dtype=bf16)
    assert t.dtype == bf16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(elm.astype(jnp.float32)))
    blk = jnp.asarray(np.random.default_rng(1).standard_normal(
        jsp.block_shape), dtype=jnp.bfloat16)
    tb = interop.block_from_reference(blk, device="cpu", dtype=bf16)
    np.testing.assert_array_equal(tb.float().numpy(),
                                  np.asarray(blk.astype(jnp.float32)))
    eigs = interop.eigs_from_reference({0: jnp.asarray(1.71875, jnp.bfloat16),
                                        1: np.float32(2.5)})
    assert eigs == {0: 1.71875, 1: 2.5}
    assert math.isfinite(sum(eigs.values()))
