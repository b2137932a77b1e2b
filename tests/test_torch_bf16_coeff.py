"""The bf16 variable-coefficient P1 path of the PyTorch port against the
JAX package: kernels B4 and B3 with a coefficient in bf16, 3D and 2D
(their plain versions here; the kernels' walks compiled with the host C++
compiler, bf16 emulated), the bf16 operator with a coefficient (apply,
inverse and lumped inverse diagonal, one Chebyshev step), the f32
coefficient V-cycle that chip_smoke.py's ``coeff_stack`` builds from
make_p1_gmg's pieces against the same composition in the JAX package, and
the f32 iterative refinement around the bf16 coefficient cycle.

The JAX side runs as its own CPU tests run it: eagerly, through its plain
XLA path (``pallas_available()`` is false on the CPU), on the same inputs.
Its coefficient cycle, composed from its pieces, takes the port's
eigenvalue bounds and runs as one jitted function.

Tolerances (BF16_ULP = 2^-7, one bf16 ulp of a value at most):
- the port's plain bf16 B4 / B3 with a coefficient within one bf16 ulp of
  the JAX package's f32 result on the same bf16 values (``ulp_excess`` <=
  1: both round an f32 sum once);
- against the JAX package's bf16 result, which sums and takes the means in
  bf16: within BF16_SUM_BOUND = 20 2^-8 of the terms' magnitudes (the
  apply of |elMat| to |x| scaled by the mean; for the diagonal the entries'
  magnitudes so scaled), plus CANCEL of the largest (ROADMAP C-ref16 holds
  the measured gap);
- the kernels' walks within one bf16 ulp of the plain bf16 versions,
  every slot written once, 0 outside the simplex, every 8-byte store at
  its boundary;
- the operator: its apply within (BF16_SUM_BOUND + TABLE_ULPS 2^-7) of the
  exchanged terms (the two packages' bf16 element matrices may differ in
  one rounding: C-ref12); its inverse diagonals within BF16_SUM_BOUND +
  2 2^-8 of the JAX package's, relative (the JAX diagonal's bf16 sums and
  means, then one rounding of 1 / d on each side); one Chebyshev step
  within STEP_TERMS 2^-8 of its terms, the step's recurrence run on
  magnitudes;
- the f32 coefficient cycle: after each of two cycles the iterates of the
  two packages within CYCLE_REL relative L2, their residuals within
  CYCLE_REL of each other, and the port's rate <= RATE_MAX (the main
  path's gate; both packages reach it here);
- refinement: within 2x the f32 coefficient stack's own plateau and below
  0.1x the bf16-only loop, as tests/test_torch_mixed_precision.py.
"""

import ctypes
import math
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.core.types import FLAG_INNER as JINNER
from hyteg_tpu.functions.p1 import P1Space as JP1Space
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import forms as jforms
from hyteg_tpu.operators import p1_elementwise as jop
from hyteg_tpu.primitives.storage import CellStorage as JCellStorage
from hyteg_tpu.solvers.gmg import GeometricMultigridSolver as JGMG
from hyteg_tpu.solvers.krylov import cg_solve_fixed as j_cg_fixed
from hyteg_tpu.solvers.smoothers import chebyshev_smooth as j_chebyshev
from hyteg_tpu.solvers.templates import make_p1_gmg as jmake_p1_gmg
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.types import (BoundaryCondition, DoFType,
                                        FLAG_INNER)
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.kernels import p1_stencil as tk
from hyteg_tpu_torch.mesh import meshinfo as mi
from hyteg_tpu_torch.operators import forms
from hyteg_tpu_torch.operators.averaging import MODES
from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.solvers.refinement import iterative_refinement
from hyteg_tpu_torch.solvers.smoothers import chebyshev_smooth
from hyteg_tpu_torch.solvers.templates import make_p1_gmg

import chip_smoke
from tests.test_torch_const_stencil import CSRC
from tests.test_torch_mixed_precision import (BF16_ULP, CANCEL, round_bf16,
                                              ulp_excess)

torch.set_num_threads(1)

bf16 = torch.bfloat16
BF16_SUM_BOUND = 20 * 2.0 ** -8
TABLE_ULPS = 2
STEP_TERMS = 8
CYCLE_REL = 1e-4
COARSE_ITERS = 10  # CG on the coarsest level's 1 (3D) or 9 (2D) unknowns
OUTER = 6  # f32 cycles and refinement steps (both reach the plateau)
MESHES = {3: ("mesh_unit_cube", {"n": 1}), 2: ("mesh_rectangle",
                                               {"nx": 2, "ny": 2})}
LEVELS = {3: (1, 3), 2: (1, 4)}  # the P1 levels of each dimension's stack
# the JAX cycle's compile grows with the 3D top level: (1, 2) there
JAX_CYCLE_LEVELS = {3: (1, 2), 2: (1, 4)}


def _storages(dim):
    name, kw = MESHES[dim]
    return (JCellStorage(getattr(jmi, name)(**kw), num_shards=1),
            CellStorage(getattr(mi, name)(**kw)))


def _source(sp, seed):
    """A seeded bf16 block on the simplex, replicas consistent."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(sp.block_shape, generator=g) * sp.vertex_mask_t.float()
    return sp.exchange_rep(x).to(bf16)


def _coeffs(sp, seed):
    """The linear k = 1 + x + 0.5 y and a seeded random k in [0.5, 1.5),
    each 0 off the simplex and rounded to bf16 once."""
    g = torch.Generator().manual_seed(seed)
    lin = sp.interpolate(chip_smoke.linear_coeff, sp.zeros(), DoFType.ALL)
    rnd = sp.exchange_rep((0.5 + torch.rand(sp.block_shape, generator=g))
                          * sp.vertex_mask_t.float()).to(bf16)
    return {"linear": lin, "random": rnd}


def _j(t, dtype=jnp.float32):
    return jnp.asarray(t.float().numpy(), dtype=dtype)


def _np(a):
    return interop.host_array(a)


def _j_diag(elm, coeff, *, level, dim, block_shape, pitch, mode, lumped):
    """The JAX package's diagonal (p1_diagonal_local) or lumped diagonal in
    the mean ``mode`` (its p1_lumped_local takes the arithmetic mean only:
    ROADMAP C-ref17)."""
    entry = ((lambda e, t, a: e[:, t, a, :].sum(-1)) if lumped
             else (lambda e, t, a: e[:, t, a, a]))
    return jop._p1_diag_local(elm, level, dim, block_shape, pitch, coeff,
                              entry, mode)


# ---------------------------------------------------------------------------
# (a), (b): the plain bf16 B4 and B3 with a coefficient against the JAX
# package's f32 and bf16 results on the same bf16 values
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dim", [3, 2])
def test_plain_bf16_coeff_vs_jax(dim, mode):
    """On a bf16 source, bf16 Laplace and mass element matrices and the
    two bf16 coefficients: the port's B4 (CPU: the plain version) within
    one bf16 ulp of the JAX package's f32 apply of those values, and
    within BF16_SUM_BOUND of the terms of its bf16 apply; B3 with the
    coefficient (Laplace diagonal, mass lumped) the same against the JAX
    package's f32 and bf16 diagonals."""
    _, tst = _storages(dim)
    level = LEVELS[dim][1]
    sp = P1Space(tst, level, device="cpu", dtype=bf16)
    jsp = JP1Space(_storages(dim)[0], level)
    lap = P1ElementwiseOperator(sp, forms.laplace_form).elmats
    mass = P1ElementwiseOperator(sp, forms.mass_form).elmats
    x = _source(sp, 10 + dim)
    args = (level, dim, sp.pitch)
    static = dict(level=level, dim=dim, pitch=sp.pitch)
    for kind, k in _coeffs(sp, 20 + dim).items():
        got = tk.p1_apply_local(x, lap, *args, k, mode)
        assert got.dtype == bf16
        f32 = _np(jop.p1_apply_local(_j(x), _j(lap), coeff=_j(k),
                                     coeff_avg=mode, **static))
        assert ulp_excess(got, round_bf16(f32)) <= 1.0, kind
        j16 = _np(jop.p1_apply_local(
            _j(x, jnp.bfloat16), _j(lap, jnp.bfloat16),
            coeff=_j(k, jnp.bfloat16), coeff_avg=mode,
            **static).astype(jnp.float32))
        terms = tk.p1_apply_local_torch(x.float().abs(), lap.float().abs(),
                                        *args, k.float(), mode).numpy()
        assert (np.abs(got.float().numpy() - j16)
                <= BF16_SUM_BOUND * terms + CANCEL * terms.max()).all(), kind
        for elm, lumped in ((lap, False), (mass, True)):
            d = tk.p1_diagonal_local(elm, *args, lumped, k, mode)
            assert d.dtype == bf16
            dk = dict(level=level, dim=dim, block_shape=jsp.block_shape,
                      pitch=jsp.pitch, mode=mode, lumped=lumped)
            f32 = _np(_j_diag(_j(elm), _j(k), **dk))
            assert ulp_excess(d, round_bf16(f32)) <= 1.0, (kind, lumped)
            j16 = _np(_j_diag(_j(elm, jnp.bfloat16), _j(k, jnp.bfloat16),
                              **dk).astype(jnp.float32))
            terms = tk.p1_diagonal_local_torch(
                elm.float().abs(), *args, lumped, k.float(), mode).numpy()
            if lumped:  # the row sums' terms: every entry's magnitude
                terms = tk.p1_apply_local_torch(
                    sp.vertex_mask_t.float().expand(sp.block_shape),
                    elm.float().abs(), *args, k.float(), mode).numpy()
            assert (np.abs(d.float().numpy() - j16)
                    <= BF16_SUM_BOUND * terms
                    + CANCEL * terms.max()).all(), (kind, lumped)


# ---------------------------------------------------------------------------
# (c): the four kernels' bf16 walks, compiled for the host
# ---------------------------------------------------------------------------

HOST_HARNESS = r"""
#include <cmath>
#include <cstdint>
#include <cstring>
#define HYTEG_DEVICE inline
#include "p1_apply.cuh"
#include "p1_tri.cuh"
using namespace hyteg;
static long long g_bad;  // 8-byte stores off their boundary
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
// The walks' source and coefficient (csrc/bf16.cuh's BF16Src): widens each
// load; Src16{} is a missing coefficient.
struct Src16 {
  const uint16_t* p;
  float operator[](long long i) const { return bf2f(p[i]); }
  Src16 operator+(long long k) const { return {p + k}; }
  explicit operator bool() const { return p != nullptr; }
};
// The walks' store (BF16CellStore): rounds once, counts each write.
struct Store16 {
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
  void quad(int i, float a, float b, float c, float d) const {
    if (reinterpret_cast<uintptr_t>(dst + i) % 8) ++g_bad;
    (*this)(i, a);
    (*this)(i + 1, b);
    (*this)(i + 2, c);
    (*this)(i + 3, d);
  }
};
// The staged walks' team: the block's threads one after another; a
// tile's G starts as NaN, so a value the tile did not stage shows.
struct HostTeam {
  template <class F> void each(F&& fn) {
    for (int tid = 0; tid < kApplyThreads; ++tid) fn(tid);
  }
  void sync() {}
  void fresh(float* p, int n) {
    for (int i = 0; i < n; ++i) p[i] = NAN;
  }
};
static Src16 co_at(const uint16_t* coeff, long long off) {
  return coeff ? Src16{coeff + off} : Src16{};
}
template <int MODE>
static void b4_cell(const uint16_t* src, const uint16_t* coeff,
                    const float* e, uint16_t* dst, int* count, int N,
                    int pitch) {
  for (int x = 0; x < N; ++x)
    for (int tid = 0; tid < kApplyThreads; ++tid)
      apply_plane<MODE>(Src16{src}, co_at(coeff, 0), Store16{dst, count}, x,
                        N, pitch, e, tid >> 5, tid & 31, kPlaneWarps);
}
// Kernel B4's bf16 blocks (cell, plane x) one after another: the element
// matrices widened per cell, every thread through apply_plane.
extern "C" long long b4_bf16(const uint16_t* src, const uint16_t* coeff,
                             const uint16_t* elm, uint16_t* dst, int C,
                             int N, int pitch, int mode, int* count) {
  g_bad = 0;
  alignas(16) float e[96];
  const long long cell = (long long)N * N * pitch;
  for (int c = 0; c < C; ++c) {
    for (int i = 0; i < 96; ++i) e[i] = bf2f(elm[c * 96 + i]);
    const uint16_t* s = src + c * cell;
    const uint16_t* k = coeff ? coeff + c * cell : nullptr;
    uint16_t* d = dst + c * cell;
    int* n = count + c * cell;
    if (!coeff) b4_cell<-1>(s, k, e, d, n, N, pitch);
    else if (mode == 0) b4_cell<0>(s, k, e, d, n, N, pitch);
    else if (mode == 1) b4_cell<1>(s, k, e, d, n, N, pitch);
    else b4_cell<2>(s, k, e, d, n, N, pitch);
  }
  return g_bad;
}
template <int MODE>
static void b3_cell(const uint16_t* coeff, const float* w, uint16_t* dst,
                    int* count, int N, int pitch) {
  for (int x = 0; x < N; ++x)
    for (int tid = 0; tid < kApplyThreads; ++tid)
      diag_plane_coeff<MODE>(Src16{coeff}, Store16{dst, count}, x, N, pitch,
                             w, tid >> 5, tid & 31, kPlaneWarps);
}
// Kernel B3's bf16 blocks with a coefficient: per cell the widened element
// matrices folded into 24 weights, every thread through diag_plane_coeff.
extern "C" long long b3_bf16(const uint16_t* elm, const uint16_t* coeff,
                             uint16_t* dst, int C, int N, int pitch,
                             int lumped, int mode, int* count) {
  g_bad = 0;
  float e[96], w[24];
  const long long cell = (long long)N * N * pitch;
  for (int c = 0; c < C; ++c) {
    for (int i = 0; i < 96; ++i) e[i] = bf2f(elm[c * 96 + i]);
    diag_fold_weights(e, lumped, w, 0, 1);
    const uint16_t* k = coeff + c * cell;
    if (mode == 0) b3_cell<0>(k, w, dst + c * cell, count + c * cell, N, pitch);
    else if (mode == 1) b3_cell<1>(k, w, dst + c * cell, count + c * cell, N, pitch);
    else b3_cell<2>(k, w, dst + c * cell, count + c * cell, N, pitch);
  }
  return g_bad;
}
template <int MODE>
static void b4_face(const uint16_t* src, const uint16_t* coeff,
                    const float* e, uint16_t* dst, int* count, int N) {
  static float gs[kApplyG2];
  for (int x0 = 0; x0 < N; x0 += kApplyR2) {
    if constexpr (tri_apply_staged(MODE)) {
      HostTeam team;
      tri_apply_band_staged<MODE>(team, Src16{src}, co_at(coeff, 0),
                                  Store16{dst, count}, x0, N, e, gs);
    } else {
      for (int tid = 0; tid < kApplyThreads; ++tid)
        tri_apply_band<MODE>(Src16{src}, co_at(coeff, 0), Store16{dst, count},
                             x0, N, e, tid >> 5, tid & 31);
    }
  }
}
// Kernel B4-2D's bf16 blocks (face, band of rows): the direct or staged
// band walk per the mode, as the kernel compiles it.
extern "C" long long b4_2d_bf16(const uint16_t* src, const uint16_t* coeff,
                                const uint16_t* elm, uint16_t* dst, int C,
                                int N, int mode, int* count) {
  g_bad = 0;
  float e[18];
  const long long face = (long long)N * N;
  for (int c = 0; c < C; ++c) {
    for (int i = 0; i < 18; ++i) e[i] = bf2f(elm[c * 18 + i]);
    const uint16_t* s = src + c * face;
    const uint16_t* k = coeff ? coeff + c * face : nullptr;
    uint16_t* d = dst + c * face;
    int* n = count + c * face;
    if (!coeff) b4_face<-1>(s, k, e, d, n, N);
    else if (mode == 0) b4_face<0>(s, k, e, d, n, N);
    else if (mode == 1) b4_face<1>(s, k, e, d, n, N);
    else b4_face<2>(s, k, e, d, n, N);
  }
  return g_bad;
}
template <int MODE>
static void b3_face(const uint16_t* coeff, const float* w, uint16_t* dst,
                    int* count, int N) {
  static float gs[kApplyG2];
  for (int x0 = 0; x0 < N; x0 += kApplyR2) {
    HostTeam team;
    tri_diag_band_coeff<MODE>(team, Src16{coeff}, Store16{dst, count}, x0, N,
                              w, gs);
  }
}
// Kernel B3-2D's bf16 blocks with a coefficient: per face the widened
// element matrices folded into 6 weights, every band through
// tri_diag_band_coeff.
extern "C" long long b3_2d_bf16(const uint16_t* elm, const uint16_t* coeff,
                                uint16_t* dst, int C, int N, int lumped,
                                int mode, int* count) {
  g_bad = 0;
  float e[18], w[6];
  const long long face = (long long)N * N;
  for (int c = 0; c < C; ++c) {
    for (int i = 0; i < 18; ++i) e[i] = bf2f(elm[c * 18 + i]);
    tri_diag_fold_weights(e, lumped, w, 0, 1);
    const uint16_t* k = coeff + c * face;
    if (mode == 0) b3_face<0>(k, w, dst + c * face, count + c * face, N);
    else if (mode == 1) b3_face<1>(k, w, dst + c * face, count + c * face, N);
    else b3_face<2>(k, w, dst + c * face, count + c * face, N);
  }
  return g_bad;
}
"""


@pytest.fixture(scope="module")
def host_coeff16(tmp_path_factory):
    """The harness above as a shared library (skips without a host C++
    compiler)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_bf16_coeff_walks")
    (d / "harness.cpp").write_text(HOST_HARNESS)
    so = d / "libhost_bf16_coeff.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (("b4_bf16", [P, P, P, P, I, I, I, I, P]),
                       ("b3_bf16", [P, P, P, I, I, I, I, I, P]),
                       ("b4_2d_bf16", [P, P, P, P, I, I, I, P]),
                       ("b3_2d_bf16", [P, P, P, I, I, I, I, P])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = LL
    return lib


def _walk_gate(dst, count, plain, sp):
    outside = ~sp.vertex_mask_t.bool()
    assert (count == 1).all()
    assert (dst[:, outside] == 0).all()
    assert ulp_excess(dst, plain.float().numpy()) <= 1.0


WALK_CASES = [(dim, level, pitch, mode)
              for dim, level, pitch in ((3, 1, None), (3, 2, None),
                                        (3, 3, None), (3, 3, 17),
                                        (2, 1, None), (2, 3, None),
                                        (2, 4, None))
              for mode in (None,) + MODES] + [
    (2, 9, None, "arithmetic"), (2, 9, None, "harmonic")]


@pytest.mark.parametrize("dim,level,pitch,mode", WALK_CASES)
def test_host_bf16_coeff_walks(host_coeff16, dim, level, pitch, mode):
    """Kernels B4 and B3 (with a coefficient) in bf16, 3D plane walk and 2D
    band walk (direct, or staged in the harmonic and geometric means, whose
    tiles hold the transformed values in f32; level 9 spans several tiles),
    on a bf16 operator's element matrices, a bf16 source and both bf16
    coefficients: every slot written once, every 8-byte store at its
    boundary, 0 outside the simplex, within one bf16 ulp of the plain bf16
    version; B3 plain (Laplace) and lumped (mass). Pitch 17 makes the 3D
    rows alternate their 4-byte alignment, as pitch 129 does on the card.
    ``mode`` None: B4 without a coefficient; level 9 runs one direct and
    one staged mean."""
    _, tst = _storages(dim)
    sp = P1Space(tst, level, device="cpu", dtype=bf16, pitch=pitch)
    lap = P1ElementwiseOperator(sp, forms.laplace_form).elmats
    mass = P1ElementwiseOperator(sp, forms.mass_form).elmats
    x = _source(sp, 30 + level)
    C, N = sp.block_shape[0], sp.N
    ks = _coeffs(sp, 40 + level)
    m = MODES.index(mode or "arithmetic")
    for kind, k in ((None, None),) if mode is None else ks.items():
        dst = torch.full_like(x, float("nan"))
        count = torch.zeros(x.shape, dtype=torch.int32)
        kp = None if k is None else k.data_ptr()
        if dim == 3:
            bad = host_coeff16.b4_bf16(x.data_ptr(), kp, lap.data_ptr(),
                                       dst.data_ptr(), C, N, sp.pitch, m,
                                       count.data_ptr())
        else:
            bad = host_coeff16.b4_2d_bf16(x.data_ptr(), kp, lap.data_ptr(),
                                          dst.data_ptr(), C, N, m,
                                          count.data_ptr())
        assert bad == 0
        plain = tk.p1_apply_local(x, lap, level, dim, sp.pitch, k,
                                  mode or "arithmetic")
        _walk_gate(dst, count, plain, sp)
        if k is None:
            continue
        for elm, lumped in ((lap, False), (mass, True)):
            dst = torch.full_like(x, float("nan"))
            count.zero_()
            if dim == 3:
                bad = host_coeff16.b3_bf16(elm.data_ptr(), kp, dst.data_ptr(),
                                           C, N, sp.pitch, int(lumped), m,
                                           count.data_ptr())
            else:
                bad = host_coeff16.b3_2d_bf16(elm.data_ptr(), kp,
                                              dst.data_ptr(), C, N,
                                              int(lumped), m,
                                              count.data_ptr())
            assert bad == 0
            plain = tk.p1_diagonal_local(elm, level, dim, sp.pitch, lumped, k,
                                         mode)
            _walk_gate(dst, count, plain, sp)


# ---------------------------------------------------------------------------
# the dtype contract of B3 and B4 with bf16 blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [3, 2])
def test_bf16_coeff_dtype_contract(dim):
    """The block's type decides the form (B4: the source's; B3: the element
    matrices'): f32 element matrices and an f32 coefficient beside a bf16
    block give the bits of bf16 ones, as the Pallas kernels cast them; a
    bf16 coefficient or bf16 element matrices beside an f32 block, and f64
    inputs beside a bf16 block, raise. No source is cast."""
    _, tst = _storages(dim)
    sp = P1Space(tst, 2, device="cpu", dtype=bf16)
    elm = P1ElementwiseOperator(sp, forms.laplace_form).elmats
    x, k = _source(sp, 50), _coeffs(sp, 51)["random"]
    args = (2, dim, sp.pitch)
    for m in MODES:
        assert torch.equal(tk.p1_apply_local(x, elm.float(), *args, k.float(),
                                             m),
                           tk.p1_apply_local(x, elm, *args, k, m))
        for lumped in (False, True):
            assert torch.equal(
                tk.p1_diagonal_local(elm, *args, lumped, k.float(), m),
                tk.p1_diagonal_local(elm, *args, lumped, k, m))
    for call in (lambda: tk.p1_apply_local(x.float(), elm.float(), *args, k),
                 lambda: tk.p1_apply_local(x.float(), elm, *args),
                 lambda: tk.p1_apply_local(x, elm.double(), *args),
                 lambda: tk.p1_apply_local(x, elm, *args, k.double()),
                 lambda: tk.p1_diagonal_local(elm.float(), *args, False, k),
                 lambda: tk.p1_diagonal_local(elm, *args, False, k.double())):
        with pytest.raises(ValueError, match="bf16"):
            call()


def test_bf16_space_interpolates_at_f32_points():
    """A bf16 space evaluates a field at f32 coordinates and rounds each
    value once: the f32 space's interpolant rounded to bf16, bit for bit
    (the JAX package rounds its reference coordinates to bf16 first), at a
    level whose coordinates bf16 cannot hold."""
    for dim in (3, 2):
        _, tst = _storages(dim)
        lv = 9 if dim == 2 else 5
        s16 = P1Space(tst, lv, device="cpu", dtype=bf16)
        s32 = P1Space(tst, lv, device="cpu")
        f = lambda p: 1.0 + p[..., 0] + 0.5 * p[..., 1] + p[..., 2] ** 2
        got = s16.interpolate(f, s16.zeros(), DoFType.ALL)
        assert got.dtype == bf16 and s16.coords().dtype == torch.float32
        assert torch.equal(got, s32.interpolate(f, s32.zeros(),
                                                DoFType.ALL).to(bf16))


# ---------------------------------------------------------------------------
# (d): the bf16 operator with a coefficient against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[3, 2])
def operators(request):
    """Both packages' bf16 spaces and Laplace operators at the top level of
    the dimension's stack (arithmetic mean), a bf16 source and the linear
    bf16 coefficient."""
    dim = request.param
    jst, tst = _storages(dim)
    level = LEVELS[dim][1]
    jsp = JP1Space(jst, level, dtype=jnp.bfloat16)
    sp = P1Space(tst, level, device="cpu", dtype=bf16)
    bc = BoundaryCondition.all_dirichlet()
    jo = jop.P1ElementwiseOperator(jsp, jforms.laplace_form)
    op = P1ElementwiseOperator(sp, forms.laplace_form)
    from hyteg_tpu.core.types import BoundaryCondition as JBC
    jsd = jsp.resolve_sd(JBC.all_dirichlet())
    jms = jop.P1ElementwiseOperator(jsp, jforms.mass_form)
    # the JAX operators' calls, each jitted once
    jcalls = {
        "apply": jax.jit(lambda x, k: jo.apply_raw(x, coeff=k, sd=jsd)),
        "inv": jax.jit(lambda k: jo.inverse_diagonal(coeff=k, sd=jsd)),
        "lumped_inv": jax.jit(
            lambda k: jms.lumped_inverse_diagonal(coeff=k, sd=jsd)),
        "cheb": jax.jit(lambda b, x, k: j_chebyshev(
            lambda v: jsp.restore_rows(jo.apply_raw(v, coeff=k, sd=jsd),
                                       jsp.zeros(), JINNER, jsd),
            jo.inverse_diagonal(coeff=k, sd=jsd), b, x, 2.0, order=4))}
    return (dim, level, jcalls, sp, sp.resolve_sd(bc), op,
            P1ElementwiseOperator(sp, forms.mass_form), _source(sp, 60 + dim),
            _coeffs(sp, 61 + dim)["linear"])


def _terms(sp, sd, x, op, k):
    """The exchanged terms' magnitudes of the coefficient apply at x."""
    return sp.exchange_add(tk.p1_apply_local_torch(
        x.float().abs(), op.elmats.float().abs(), sp.level, sp.dim, sp.pitch,
        k.float(), op.coeff_avg), sd)


def test_bf16_coeff_operator_vs_jax(operators):
    """The bf16 operator with the coefficient: its apply within
    (BF16_SUM_BOUND + TABLE_ULPS 2^-7) of the terms of the JAX package's
    bf16 apply; its inverse diagonal and lumped inverse diagonal (mass)
    within BF16_SUM_BOUND + 2 2^-8 of the JAX package's, relative: the JAX
    diagonal sums its 24 (6) terms and their means in bf16 (C-ref16), all
    of one sign here, then each side rounds 1 / d once."""
    dim, level, jcalls, sp, sd, op, ms, x, k = operators
    kj = _j(k, jnp.bfloat16)
    y = op.apply_raw(x, coeff=k, sd=sd)
    assert y.dtype == bf16
    yj = _np(jcalls["apply"](_j(x, jnp.bfloat16), kj))
    bound = (BF16_SUM_BOUND + TABLE_ULPS * BF16_ULP) * _terms(
        sp, sd, x, op, k).numpy()
    assert (np.abs(y.float().numpy() - yj) <= bound + CANCEL).all()
    inv = op.inverse_diagonal(coeff=k, sd=sd)
    assert inv.dtype == bf16
    invj = _np(jcalls["inv"](kj))
    assert (np.abs(inv.float().numpy() - invj)
            <= (BF16_SUM_BOUND + 2 * 2.0 ** -8) * np.abs(invj)).all()
    lin = ms.lumped_inverse_diagonal(coeff=k, sd=sd)
    assert lin.dtype == bf16
    linj = _np(jcalls["lumped_inv"](kj))
    assert (np.abs(lin.float().numpy() - linj)
            <= (BF16_SUM_BOUND + 2 * 2.0 ** -8) * np.abs(linj)).all()


def _cheb_terms(sp, sd, op, k, inv, b, x, eig, order):
    """The magnitudes of a Chebyshev step's terms: the step's recurrence
    on |x|, |b|, |D^-1| and |A_k| (every difference a sum of magnitudes;
    the polynomial's coefficients are positive), in f32."""
    absA = lambda v: -_terms(sp, sd, v, op, k)
    return chebyshev_smooth(absA, inv.float().abs(), b.float().abs(),
                            x.float().abs(), eig, order=order)


def test_bf16_coeff_chebyshev_step_vs_jax(operators):
    """One Chebyshev step (order 4) with the coefficient of each package on
    its own bf16 operator, inverse diagonal with the coefficient, from the
    same bf16 x and rhs b: within STEP_TERMS 2^-8 of the step's terms (its
    recurrence on magnitudes, _cheb_terms), entry by entry."""
    dim, level, jcalls, sp, sd, op, _, x, k = operators
    b = _source(sp, 62)
    eig = 2.0  # as the jitted JAX step's
    inv = op.inverse_diagonal(coeff=k, sd=sd)
    ap = lambda v: op.apply_inner(v, sd, FLAG_INNER, coeff=k)
    got = chebyshev_smooth(ap, inv, b, x, eig, order=4)
    assert got.dtype == bf16
    ref = _np(jcalls["cheb"](_j(b, jnp.bfloat16), _j(x, jnp.bfloat16),
                             _j(k, jnp.bfloat16)))
    terms = _cheb_terms(sp, sd, op, k, inv, b, x, eig, 4).numpy()
    assert (np.abs(got.float().numpy() - ref)
            <= STEP_TERMS * 2.0 ** -8 * terms + CANCEL).all()


def test_jax_lumped_diagonal_takes_the_arithmetic_mean():
    """ROADMAP C-ref17: the JAX operator's lumped_inverse_diagonal calls
    p1_lumped_local, which has no averaging argument, so with a
    coefficient it takes the arithmetic mean whatever ``coeff_avg`` the
    operator was built with (hyteg_tpu/operators/p1_elementwise.py:
    352-358, p1_lumped_local at :279), while its inverse_diagonal takes
    it; its Pallas kernel B3 and the port's operator take the operator's
    mean in both."""
    jst, tst = _storages(2)
    jsp = JP1Space(jst, 1)
    sp = P1Space(tst, 1, device="cpu")
    k = _coeffs(sp, 70)["random"].float()
    jo = jop.P1ElementwiseOperator(jsp, jforms.mass_form)
    jsd = jsp.resolve_sd(None)  # built outside the traces

    def diagonals():  # traced afresh: coeff_avg is read at the call
        return [_np(jax.jit(f)(_j(k))) for f in (
            lambda k: jo.lumped_inverse_diagonal(coeff=k, sd=jsd),
            lambda k: jo.inverse_diagonal(coeff=k, sd=jsd))]

    lumped_a, inv_a = diagonals()
    jo.coeff_avg = "harmonic"
    lumped_h, inv_h = diagonals()
    assert np.array_equal(lumped_a, lumped_h)  # the mean is ignored
    assert not np.array_equal(inv_a, inv_h)  # the diagonal takes it
    ha = P1ElementwiseOperator(sp, forms.mass_form, coeff_avg="harmonic")
    ar = P1ElementwiseOperator(sp, forms.mass_form)
    assert not torch.equal(ha.lumped_inverse_diagonal(coeff=k),
                           ar.lumped_inverse_diagonal(coeff=k))


# ---------------------------------------------------------------------------
# (e): the f32 coefficient cycle against the same composition in the JAX
# package; (f): the bf16 refinement around it
# ---------------------------------------------------------------------------


def _jax_coeff_cycle(jst, coeffs, eigs, lo, hi):
    """chip_smoke.coeff_stack's composition from the JAX package's pieces,
    as one jitted V(3,3) cycle (x, b) -> x: its P1Space, operator and
    P1Transfer per level, restrict and prolongate_and_add wrapped as its
    make_p1_gmg wraps them (hyteg_tpu/solvers/templates.py:177-197; its
    make_p1_gmg itself builds constant-coefficient diagonals eagerly, a
    minute of small compiles here), each level's apply, residual, inverse
    diagonal and Chebyshev (order 4) with k_l, the coarse CG on the
    coefficient apply, its GeometricMultigridSolver."""
    from hyteg_tpu.core.types import BoundaryCondition as JBC
    from hyteg_tpu.operators.transfer import P1Transfer as JP1Transfer
    from hyteg_tpu.solvers.gmg import GMGLevel as JGMGLevel

    bc, pitch = JBC.all_dirichlet(), (1 << hi) + 1
    sps = {l: JP1Space(jst, l, pitch=pitch) for l in range(lo, hi + 1)}
    sds = {l: sp.shard_data(0, bc) for l, sp in sps.items()}
    ops = {l: jop.P1ElementwiseOperator(sp, jforms.laplace_form)
           for l, sp in sps.items()}
    trs = {l: JP1Transfer(sps[l - 1], sps[l]) for l in range(lo + 1, hi + 1)}

    def level(l):
        sp, sd, op, k = sps[l], sds[l], ops[l], coeffs[l]
        ap = lambda v: op.apply_inner(v, sd, JINNER, coeff=k)
        inv = op.inverse_diagonal(coeff=k, sd=sd)

        def restrict(r):
            rc = trs[l].restrict(r, sd, sds[l - 1], None)
            return sps[l - 1].restore_rows(rc, jnp.zeros_like(rc), JINNER,
                                           sds[l - 1])

        def residual(v, b):
            r = op.residual(v, b, coeff=k, sd=sd)
            return sp.restore_rows(r, jnp.zeros_like(r), JINNER, sd)

        return JGMGLevel(
            apply=ap, dot=lambda u, v: sp.dot(u, v, JINNER, sd, None),
            smooth=lambda v, b: sp.restore_rows(
                j_chebyshev(ap, inv, b, v, eigs[l], order=4), v, JINNER, sd),
            zeros=sp.zeros, restrict=restrict if l > lo else None,
            prolongate_add=(lambda xc, xf: sp.restore_rows(
                trs[l].prolongate_and_add(xc, xf, sd, None), xf, JINNER, sd))
            if l > lo else None, residual=residual)

    def cycle(x, b):
        lev = {l: level(l) for l in sps}
        return JGMG(lev, lambda b, x0: j_cg_fixed(lev[lo].apply, lev[lo].dot,
                                                  b, x0, COARSE_ITERS),
                    lo, hi, 3, 3).cycle(x, b)

    return jax.jit(cycle)


@pytest.mark.parametrize("dim", [3, 2])
def test_f32_coeff_cycle_vs_jax(dim):
    """Two V(3,3) cycles of the f32 coefficient hierarchy (coeff_stack on
    make_p1_gmg, k = 1 + x + 0.5 y) against the same composition of the JAX
    package's pieces (_jax_coeff_cycle, on the port's k_l and eigenvalue
    bounds; P1 levels JAX_CYCLE_LEVELS), from the manufactured start: the iterates within CYCLE_REL
    relative L2 after each cycle, the residuals within CYCLE_REL of r0 of
    each other, and the port's rate per cycle <= RATE_MAX."""
    jst, tst = _storages(dim)
    lo, hi = JAX_CYCLE_LEVELS[dim]
    s32 = chip_smoke.coeff_stack(make_p1_gmg(tst, lo, hi, device="cpu",
                                             coarse_iters=COARSE_ITERS),
                                 chip_smoke.linear_coeff)
    jcycle = _jax_coeff_cycle(jst, {l: _j(k) for l, k in s32.coeffs.items()},
                              s32.eigs, lo, hi)
    x, b, _ = chip_smoke.manufactured(s32)
    xj, bj = _j(x), _j(b)
    res = [s32.residual_norm(x, b).item()]
    for _ in range(2):
        x, xj = s32.gmg.cycle(x, b), jcycle(xj, bj)
        xn = np.array(_np(xj))
        rel = np.linalg.norm(x.numpy() - xn) / np.linalg.norm(xn)
        assert rel <= CYCLE_REL, rel
        res.append(s32.residual_norm(x, b).item())
        rj = s32.residual_norm(torch.as_tensor(xn), b).item()
        assert abs(res[-1] - rj) <= CYCLE_REL * res[0], (res, rj)
        assert res[-1] <= chip_smoke.RATE_MAX * res[-2], res


@pytest.mark.parametrize("dim", [3, 2])
def test_refinement_around_a_bf16_coeff_vcycle(dim):
    """The card's mixed_precision_coeff at a CPU size: an f32 outer loop
    (the f32 coefficient apply, B4) around one bf16 V(3,3) cycle of
    coeff_stack on make_p1_gmg(dtype=bf16) (B4-bf16, B3-bf16 with the
    coefficient at set-up, bf16 transfers, Chebyshev on the f32 stack's
    bounds, CG coarse solve), OUTER steps, reaches within 2x of the f32
    coefficient stack's own plateau (the mean of its last 3 of OUTER
    cycles) and below 0.1x the bf16-only loop; the bf16
    stack's coefficients, inverse diagonals and blocks are bf16. (The JAX
    package's bf16 P1 cycle cannot run: C-ref13.)"""
    _, tst = _storages(dim)
    lo, hi = LEVELS[dim]
    s32 = chip_smoke.coeff_stack(make_p1_gmg(tst, lo, hi, device="cpu",
                                             coarse_iters=COARSE_ITERS),
                                 chip_smoke.linear_coeff)
    s16 = chip_smoke.coeff_stack(make_p1_gmg(tst, lo, hi, device="cpu",
                                             coarse_iters=COARSE_ITERS,
                                             dtype=bf16),
                                 chip_smoke.linear_coeff, eigs=s32.eigs)
    assert all(t.dtype == bf16 for d in (s16.coeffs, s16.inv_diags)
               for t in d.values())
    for l, k in s16.coeffs.items():  # k_l: f32 at f32 points, rounded once
        assert torch.equal(k, s32.coeffs[l].to(bf16))
    x0, b, _ = chip_smoke.manufactured(s32)
    x, res = x0, []
    for _ in range(OUTER):
        x = s32.gmg.cycle(x, b)
        res.append(s32.residual_norm(x, b).item())
    plateau = sum(res[-3:]) / 3
    sp16, op, sd = s16.space(), s32.operators[hi], s32.sd()
    inner = lambda r: s16.gmg.cycle(sp16.zeros(), r)
    apply_hi = lambda v: op.apply_inner(v, sd, FLAG_INNER,
                                        coeff=s32.coeffs[hi])
    xr = iterative_refinement(apply_hi, inner, b, x0, OUTER)
    assert xr.dtype == torch.float32
    rel = s32.residual_norm(xr, b).item()
    x16, b16 = x0.to(bf16), b.to(bf16)
    for _ in range(2):  # the bf16 floor, reached in one cycle
        x16 = x16 + inner(s16.residual(x16, b16))
        assert x16.dtype == bf16
    rel16 = s32.residual_norm(x16.float(), b).item()
    assert math.isfinite(rel) and rel <= 2 * plateau and rel < 0.1 * rel16, (
        rel, plateau, rel16)


def test_coeff_trees_refuses_without_cuda():
    """The parent-against-change timing tool of B3 and B4
    (``python -m hyteg_tpu_torch.probes.coeff_trees``) runs only on the
    card: without CUDA it exits 1 before building anything."""
    from hyteg_tpu_torch.probes import coeff_trees

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert coeff_trees.main(["."]) == 1
