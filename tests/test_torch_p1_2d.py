"""The 2D arm of the PyTorch port's P1 path (macro-faces): the space, the
element matrices, kernels B2, B3 and B4 in their 2D form (plain versions,
and their CUDA per-point math compiled with the host C++ compiler), the
grid transfers and the GMG stack, against the JAX package on identical
numpy-seeded inputs.

The JAX side runs as its own CPU tests run it: ``p1_const_apply_xla``,
the Pallas kernel in interpret mode (levels <= 3), the elementwise
``p1_apply_local(unroll=True)`` and ``p1_diagonal_local`` /
``p1_lumped_local``; element matrices and eigenvalue bounds are carried
over through hyteg_tpu_torch.interop where a test compares solvers.

Meshes: the reference's 2D cases (tests/test_const_stencil.py:36-37):
``mesh_rectangle((0, 0), (1, 1), 2, 1)`` at level 3 (4 faces) and
``mesh_annulus(0.5, 1, 6, 1)`` at level 2 (12 faces, every face's weights
general), and the GMG regression mesh ``mesh_rectangle(nx=2, ny=2)``
(tests/test_gmg_regression.py:46-52).

Tolerances (f32, sums taken in another order): masks, maps and slot
tables exact; element matrices and stencil tables 1e-6 of their largest
entry; applies 1e-5 * max|y|; diagonals 1e-6 of the larger of max|d| and
max|elmats|; transfers and R = P^T 1e-6; the GMG residual history as in
tests/test_torch_gmg.py: the initial residual 1e-6, cycle 1 1e-3,
later cycles 5e-2 relative or 1e-6 * ||r0|| (near the f32 floor the
packages' summation orders dominate).
"""

import ctypes
import functools
import math
import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.core import types as jt
from hyteg_tpu.functions.p1 import P1Space as JSpace
from hyteg_tpu.kernels import p1_const_stencil as jk
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import forms as jforms
from hyteg_tpu.operators import p1_elementwise as jop
from hyteg_tpu.operators.transfer import P1Transfer as JTransfer
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu.solvers import smoothers as jsm
from hyteg_tpu.solvers.templates import make_p1_gmg as j_make_p1_gmg
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core import types as tt
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.indexing import flat, micro
from hyteg_tpu_torch.kernels import p1_const_stencil as tk
from hyteg_tpu_torch.kernels import p1_stencil as tk3
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.operators import forms as tforms
from hyteg_tpu_torch.operators.averaging import MODES
from hyteg_tpu_torch.operators.p1_elementwise import (P1ElementwiseOperator,
                                                      compute_elmats)
from hyteg_tpu_torch.operators.transfer import P1Transfer
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.solvers import smoothers as tsm
from hyteg_tpu_torch.solvers.templates import make_p1_gmg

torch.set_num_threads(1)

T = functools.partial(interop.block_from_reference, device="cpu")
N_ = interop.block_to_numpy
FORMS = {"laplace": (jforms.laplace_form, tforms.laplace_form),
         "mass": (jforms.mass_form, tforms.mass_form)}
MESHES = {"rect": lambda m: m.mesh_rectangle((0, 0), (1, 1), 2, 1),
          "annulus": lambda m: m.mesh_annulus(0.5, 1.0, 6, 1),
          "rect22": lambda m: m.mesh_rectangle(nx=2, ny=2)}
CASES = [("rect", 3), ("annulus", 2)]


@functools.lru_cache(maxsize=None)
def _storages(name):
    return JStorage(MESHES[name](jmi)), CellStorage(MESHES[name](tmi))


@functools.lru_cache(maxsize=None)
def _spaces(name, level):
    js, ts = _storages(name)
    return JSpace(js, level), P1Space(ts, level, device="cpu")


@functools.lru_cache(maxsize=None)
def _elmats(name, level, form):
    jsp, _ = _spaces(name, level)
    return np.asarray(jop.compute_elmats(jsp, FORMS[form][0],
                                         jnp.asarray(jsp.cell_vertices(0))))


def _rand(shape, mask, seed, lo=None):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(shape) if lo is None
         else rng.uniform(lo, 2.0, shape))
    return (v * mask[None]).astype(np.float32)


def _close(got, ref, rtol, scale=None):
    got = N_(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max() if scale is None else scale
    assert np.abs(got - ref).max() <= rtol * scale


# ---------------------------------------------------------------------------
# indexing, storage maps and the space
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", [2, 3])
def test_2d_shifts_match_jax(level):
    """flat.shift_read / shift_write on (C, N, N) blocks, every stencil
    direction, against the JAX package's (the 2D lane axis is z itself)."""
    from hyteg_tpu.indexing import flat as jflat

    N = (1 << level) + 1
    u = _rand((3, N, N), np.ones((N, N)), level)
    for d in micro.stencil_directions(2):
        off = tuple(int(v) for v in d)
        _close(flat.shift_read(T(u), off, N, 2),
               jflat.shift_read(jnp.asarray(u), off, N, 2), 0.0, 1.0)
        _close(flat.shift_write(T(u), off, N, 2),
               jflat.shift_write(jnp.asarray(u), off, N, 2), 0.0, 1.0)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_2d_masks_match_jax(level):
    from hyteg_tpu.indexing import micro as jmicro

    N = (1 << level) + 1
    for fn in ("vertex_mask_flat", "interior_mask_flat",
               "boundary_facet_masks_flat"):
        assert np.array_equal(getattr(micro, fn)(level, 2, N),
                              getattr(jmicro, fn)(level, 2, N))
    for t in range(micro.num_classes(2)):
        assert np.array_equal(micro.elem_base_mask_flat(level, t, 2, N),
                              jmicro.elem_base_mask_flat(level, t, 2, N))


@pytest.mark.parametrize("name,level", CASES + [("rect22", 3)])
def test_2d_level_maps_match_jax(name, level):
    js, ts = _storages(name)
    jm, tm = js.p1_level_maps(level), ts.p1_level_maps(level)
    for field in ("slot_flat", "slot_gid", "slot_meshflag", "ifc_meshflag",
                  "ifc_rep_dev", "ifc_rep_slot", "ifc_mult"):
        assert np.array_equal(getattr(tm, field), getattr(jm, field)), field
    assert (tm.num_ifc, tm.num_global_dofs) == (jm.num_ifc, jm.num_global_dofs)


def test_2d_full_size_dof_count():
    """mesh_rectangle(nx=4, ny=4) at level 11: (4 * 2^11 + 1)^2 =
    67,125,249 DoFs, the 2D card run's size, in both packages."""
    jm = JStorage(jmi.mesh_rectangle(nx=4, ny=4)).p1_level_maps(11)
    tm = CellStorage(tmi.mesh_rectangle(nx=4, ny=4)).p1_level_maps(11)
    assert tm.num_global_dofs == jm.num_global_dofs == (4 * 2 ** 11 + 1) ** 2


@pytest.mark.parametrize("name,level", CASES)
def test_2d_space_matches_jax(name, level):
    jsp, tsp = _spaces(name, level)
    assert tsp.block_shape == jsp.block_shape == (tsp.C_loc, tsp.N, tsp.N)
    assert tsp.lanes == tsp.N == tsp.pitch
    assert np.array_equal(tsp.vertex_mask, jsp.vertex_mask)
    assert np.array_equal(tsp.interior_mask, jsp.interior_mask)
    assert tsp.num_global_dofs() == jsp.num_global_dofs()
    # a shared GMG pitch is ignored in 2D, as the JAX package ignores it
    wide = P1Space(_storages(name)[1], level, device="cpu", pitch=65)
    assert wide.pitch == tsp.N and wide.block_shape == tsp.block_shape
    _close(tsp.coords(), jsp.coords(), 1e-6)


@pytest.mark.parametrize("name,level", CASES)
def test_2d_interpolate_dot_exchange_match_jax(name, level):
    jsp, tsp = _spaces(name, level)
    bc_j, bc_t = jt.BoundaryCondition.all_dirichlet(), \
        tt.BoundaryCondition.all_dirichlet()
    fj = lambda p: jnp.sin(3 * p[..., 0]) * jnp.cos(2 * p[..., 1]) + p[..., 0]
    ft = lambda p: torch.sin(3 * p[..., 0]) * torch.cos(2 * p[..., 1]) + p[..., 0]
    u0 = _rand(jsp.block_shape, jsp.vertex_mask, 1)
    for fl in ("ALL", "INNER", "DIRICHLET"):
        ref = jsp.interpolate(fj, jnp.asarray(u0), getattr(jt.DoFType, fl), bc_j)
        got = tsp.interpolate(ft, T(u0), getattr(tt.DoFType, fl), bc_t)
        _close(got, ref, 1e-6)
    u = _rand(jsp.block_shape, jsp.vertex_mask, 2)
    v = _rand(jsp.block_shape, jsp.vertex_mask, 3)
    for fl in ("ALL", "INNER", "DIRICHLET"):
        ref = float(jsp.dot(jnp.asarray(u), jnp.asarray(v),
                            getattr(jt.DoFType, fl)))
        got = float(tsp.dot(T(u), T(v), getattr(tt.DoFType, fl)))
        assert abs(got - ref) <= 1e-5 * max(abs(ref), 1.0)
    _close(tsp.exchange_add(T(u)), jsp.exchange_add(jnp.asarray(u)), 1e-6)
    _close(tsp.exchange_rep(T(u)), jsp.exchange_rep(jnp.asarray(u)), 0.0, 1.0)


def test_p1_space_still_refuses_multi_shard():
    with pytest.raises(NotImplementedError, match="A8"):
        P1Space(CellStorage(tmi.mesh_rectangle(nx=2, ny=2), num_shards=2), 2,
                device="cpu")


# ---------------------------------------------------------------------------
# element matrices and stencil tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,level", CASES)
def test_2d_elmats_and_tables_match_jax(name, level, form):
    _, tsp = _spaces(name, level)
    elm = _elmats(name, level, form)
    got = compute_elmats(tsp, FORMS[form][1],
                         torch.as_tensor(tsp.cell_vertices(0)))
    assert got.shape == elm.shape == (tsp.C_loc, 2, 3, 3)
    _close(got, elm, 1e-6)
    et = interop.elmats_from_reference(elm, device="cpu")
    for jf, tf in ((jk.stencil_weights, tk.stencil_weights),
                   (jk.face_weights_full, tk.face_weights_full)):
        ref = np.asarray(jf(jnp.asarray(elm), 2))
        _close(tf(et, 2), ref, 1e-6)
    dirs, tab, n_j = tk.stencil_tables(2)
    jdirs, jtab, jn_j = jk.stencil_tables(2)
    assert dirs.shape == (7, 2) and n_j == jn_j == 2
    assert np.array_equal(dirs, jdirs) and np.array_equal(tab, jtab)
    assert tk.face_tables_full(2)[0] == ((0,), (1,), (0, 1))


# ---------------------------------------------------------------------------
# kernel B2-2D (plain version)
# ---------------------------------------------------------------------------

_xla_apply = jax.jit(jk.p1_const_apply_xla,
                     static_argnames=("level", "dim", "pitch"))


def _b2_inputs(name, level, form, seed):
    jsp, tsp = _spaces(name, level)
    elm = _elmats(name, level, form)
    x = _rand(jsp.block_shape, jsp.vertex_mask, seed)
    et = interop.elmats_from_reference(elm, device="cpu")
    return jsp, tsp, elm, x, tk.stencil_weights(et, 2), tk.face_weights_full(
        et, 2)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,level", CASES)
def test_plain_b2_2d_matches_xla(name, level, form):
    jsp, tsp, elm, x, A, E = _b2_inputs(name, level, form, level)
    jA, jE = jk.stencil_weights(jnp.asarray(elm), 2), jk.face_weights_full(
        jnp.asarray(elm), 2)
    ref = np.asarray(_xla_apply(jnp.asarray(x), jA, level=level, dim=2,
                                pitch=jsp.pitch, E=jE))
    got = tk.p1_const_apply(T(x), A, E, level, 2, tsp.pitch)
    _close(got, ref, 1e-5)
    assert not N_(got)[:, ~tsp.vertex_mask].any()


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,level", CASES)
def test_plain_b2_2d_matches_pallas_interpret(name, level, form):
    jsp, tsp, elm, x, A, E = _b2_inputs(name, level, form, 10 + level)
    ref = np.asarray(jk.p1_const_apply_pallas(
        jnp.asarray(x), jk.stencil_weights(jnp.asarray(elm), 2),
        jk.face_weights_full(jnp.asarray(elm), 2), level, 2, jsp.pitch,
        interpret=True))
    _close(tk.p1_const_apply_torch(T(x), A, level, 2, tsp.pitch, E=E), ref,
           1e-5)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,level", CASES)
def test_2d_operator_matches_jax(name, level, form):
    jsp, tsp = _spaces(name, level)
    elm = _elmats(name, level, form)
    x = _rand(jsp.block_shape, jsp.vertex_mask, 20 + level)
    jo = jop.P1ElementwiseOperator(jsp, FORMS[form][0], elmats=jnp.asarray(elm))
    to = P1ElementwiseOperator(tsp, FORMS[form][1],
                               elmats=interop.elmats_from_reference(
                                   elm, device="cpu"))
    _close(to.apply_raw(T(x)), jo.apply_raw(jnp.asarray(x)), 1e-5)
    _close(to.apply_inner(T(x), None, tt.FLAG_INNER),
           jo.apply_inner(jnp.asarray(x), None, jt.FLAG_INNER), 1e-5)
    _close(to.inverse_diagonal(), jo.inverse_diagonal(), 1e-6)


# ---------------------------------------------------------------------------
# kernels B3-2D and B4-2D (plain versions)
# ---------------------------------------------------------------------------


def _coeff(jsp, seed):
    return _rand(jsp.block_shape, jsp.vertex_mask, seed, lo=0.5)


@pytest.mark.parametrize("mode", [None] + list(MODES))
@pytest.mark.parametrize("lumped", [False, True])
@pytest.mark.parametrize("name,level", CASES)
def test_plain_b3_2d_matches_jax(name, level, lumped, mode):
    jsp, tsp = _spaces(name, level)
    elm = _elmats(name, level, "mass")
    coeff = None if mode is None else _coeff(jsp, 3)
    jc = None if coeff is None else jnp.asarray(coeff)
    args = (jnp.asarray(elm), level, 2, jsp.block_shape, jsp.pitch, jc)
    if not lumped:
        ref = jop.p1_diagonal_local(*args, coeff_avg=mode or "arithmetic")
    else:  # the JAX lumped entry point takes no coeff_avg (C-ref4)
        ref = jop._p1_diag_local(*args, lambda e, t, a: e[:, t, a, :].sum(-1),
                                 mode or "arithmetic")
    got = tk3.p1_diagonal_local(
        interop.elmats_from_reference(elm, device="cpu"), level, 2, tsp.pitch,
        lumped, None if coeff is None else T(coeff), mode or "arithmetic")
    ref = np.asarray(ref)
    _close(got, ref, 1e-6, max(np.abs(ref).max(), np.abs(elm).max()))


@pytest.mark.parametrize("mode", [None] + list(MODES))
@pytest.mark.parametrize("name,level", CASES)
def test_plain_b4_2d_matches_jax_unrolled(name, level, mode):
    jsp, tsp = _spaces(name, level)
    elm = _elmats(name, level, "laplace")
    x = _rand(jsp.block_shape, jsp.vertex_mask, 4)
    coeff = None if mode is None else _coeff(jsp, 5)
    ref = np.asarray(jop.p1_apply_local(
        jnp.asarray(x), jnp.asarray(elm), level, 2, jsp.pitch,
        None if coeff is None else jnp.asarray(coeff),
        coeff_avg=mode or "arithmetic", unroll=True))
    got = tk3.p1_apply_local(T(x), interop.elmats_from_reference(
        elm, device="cpu"), level, 2, tsp.pitch,
        None if coeff is None else T(coeff), mode or "arithmetic")
    _close(got, ref, 1e-5)
    assert not N_(got)[:, ~tsp.vertex_mask].any()


def test_2d_wrappers_reject_non_cpu_non_cuda_tensors():
    _, tsp = _spaces("rect", 3)
    et = interop.elmats_from_reference(_elmats("rect", 3, "laplace"),
                                       device="cpu").to("meta")
    x = torch.empty(tsp.block_shape, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.p1_const_apply(x, tk.stencil_weights(et, 2),
                          tk.face_weights_full(et, 2), 3, 2, tsp.pitch)
    with pytest.raises(ValueError, match="CUDA"):
        tk3.p1_diagonal_local(et, 3, 2, tsp.pitch)
    with pytest.raises(ValueError, match="CUDA"):
        tk3.p1_apply_local(x, et, 3, 2, tsp.pitch)


# ---------------------------------------------------------------------------
# the CUDA kernels' 2D per-point math, compiled for the host
# ---------------------------------------------------------------------------

CSRC = pathlib.Path(tk.__file__).resolve().parent.parent / "csrc"
HOST_HARNESS = r"""
#include <cmath>
#define HYTEG_DEVICE inline
// transforms (0) and means finished (1) by coeff_term / coeff_finish
static long long coeff_work[2];
#define HYTEG_COEFF_HOOK(kind) (++coeff_work[kind])
#include "p1_const_stencil.cuh"
#include "p1_tri.cuh"
using namespace hyteg;
// Counts each slot's writes beside the store.
struct CountStore {
  CellStore cell;
  int* count;
  void operator()(int i, float v) const { cell(i, v); ++count[i]; }
  int to_aligned(int i) const { return cell.to_aligned(i); }
  void quad(int i, float a, float b, float c, float d) const {
    cell.quad(i, a, b, c, d);
    for (int k = 0; k < 4; ++k) ++count[i + k];
  }
};
// The launchers' check of the class tables (offs (2, 3, 2), margins (2,)).
static bool tables_match(const int* offs, const int* margins) {
  for (int t = 0; t < kTriClasses; ++t) {
    if (margins[t] != kTriMargin[t]) return false;
    for (int a = 0; a < kTriVerts; ++a)
      for (int d = 0; d < 2; ++d)
        if (offs[(t * kTriVerts + a) * 2 + d] != kTriOff[t][a][d]) return false;
  }
  return true;
}
// Kernel B2's 2D launcher and thread blocks one after another: the
// direction check, per face the weight fold, per band of rows every
// thread (warp, lane) of the block through the same walk
// (const_apply_band_2d). count: null, or one int per slot. Returns the
// launcher's error (11, cudaErrorInvalidValue) for directions it
// refuses, else 0.
extern "C" int const_apply_2d(const float* src, const float* A,
                              const float* E, float* dst, int C, int N,
                              const int* dirs, const int* gmask, int* count) {
  for (int s = 0; s < kConst2Dirs; ++s)
    if (dirs[2 * s] != const2_dx(s) || dirs[2 * s + 1] != const2_dz(s))
      return 11;
  ConstTables2D t;
  for (int g = 0; g < kConst2Groups; ++g) t.gmask[g] = gmask[g];
  float rows[kConst2Rows * kConst2Dirs];
  const long long face = (long long)N * N;
  for (int c = 0; c < C; ++c) {
    const_fold_rows(A + c * kConst2Dirs * kConstShells,
                    E + c * kConst2Groups * kConstShells * kConst2Dirs, t,
                    rows, 0, 1);
    for (int x0 = 0; x0 < N; x0 += kBandRows2DP1)
      for (int tid = 0; tid < kPlaneWarps * 32; ++tid) {
        if (count)
          const_apply_band_2d(src + c * face,
                              CountStore{CellStore{dst + c * face},
                                         count + c * face},
                              x0, N, rows, tid >> 5, tid & 31, kPlaneWarps);
        else
          const_apply_band_2d(src + c * face, CellStore{dst + c * face}, x0,
                              N, rows, tid >> 5, tid & 31, kPlaneWarps);
      }
  }
  return 0;
}
extern "C" void diag_2d(const float* elm, const float* coeff, float* dst,
                        int C, int N, int lumped, int mode) {
  const int kElm = kTriClasses * kTriVerts * kTriVerts;
  float w[kTriClasses * kTriVerts];
  const long long cell = (long long)N * N;
  for (int c = 0; c < C; ++c) {
    tri_diag_fold_weights(elm + c * kElm, lumped, w, 0, 1);
    for (long long q = 0; q < cell; ++q)
      dst[c * cell + q] = diag_point_2d(coeff ? coeff + c * cell : nullptr,
                                        (int)(q / N), (int)(q % N), N, w,
                                        mode);
  }
}
// The staged walks' team on the host: the block's threads one after
// another; a tile's G starts as NaN, so a read of a value the tile did
// not stage shows in the result.
struct HostTeam {
  template <class F> void each(F&& fn) {
    for (int tid = 0; tid < kApplyThreads; ++tid) fn(tid);
  }
  void sync() {}
  void fresh(float* p, int n) {
    for (int i = 0; i < n; ++i) p[i] = NAN;
  }
};
// One B3-2D thread block (face, band x0): the class values folded once
// and every thread through tri_diag_band, or the block's team through
// tri_diag_band_coeff in the mean MODE.
template <int MODE, class Out>
static void diag_band(const float* coeff, const Out& out, int x0, int N,
                      const float* w) {
  if constexpr (MODE < 0) {
    float cls[kTriDiagRows];
    tri_fold_classes(w, cls, 0, 1);
    for (int tid = 0; tid < kApplyThreads; ++tid)
      tri_diag_band(out, x0, N, cls, tid >> 5, tid & 31);
  } else {
    static float gs[kApplyG2];
    HostTeam team;
    tri_diag_band_coeff<MODE>(team, coeff, out, x0, N, w, gs);
  }
}
template <class Out>
static void diag_band_mode(const float* coeff, const Out& out, int x0, int N,
                           const float* w, int mode) {
  if (!coeff)
    diag_band<-1>(coeff, out, x0, N, w);
  else if (mode == 0)
    diag_band<0>(coeff, out, x0, N, w);
  else if (mode == 1)
    diag_band<1>(coeff, out, x0, N, w);
  else
    diag_band<2>(coeff, out, x0, N, w);
}
// Kernel B3-2D's launcher and thread blocks (face, band of rows) one after
// another: the table check, per face the weight fold, then every block
// through the band walk. count: null, or one int per slot. work: null, or
// the transforms and means of the run. Returns the launcher's error (11,
// cudaErrorInvalidValue) for tables it refuses, else 0.
extern "C" int diag_walk_2d(const float* elm, const float* coeff, float* dst,
                            int C, int N, int lumped, int mode,
                            const int* offs, const int* margins, int* count,
                            long long* work) {
  if (!tables_match(offs, margins)) return 11;
  coeff_work[0] = coeff_work[1] = 0;
  const int kElm = kTriClasses * kTriVerts * kTriVerts;
  float w[kTriClasses * kTriVerts];
  const long long face = (long long)N * N;
  for (int c = 0; c < C; ++c) {
    tri_diag_fold_weights(elm + c * kElm, lumped, w, 0, 1);
    const float* co = coeff ? coeff + c * face : nullptr;
    for (int x0 = 0; x0 < N; x0 += kApplyR2) {
      if (count)
        diag_band_mode(co, CountStore{CellStore{dst + c * face},
                                      count + c * face},
                       x0, N, w, mode);
      else
        diag_band_mode(co, CellStore{dst + c * face}, x0, N, w, mode);
    }
  }
  if (work) {
    work[0] = coeff_work[0];
    work[1] = coeff_work[1];
  }
  return 0;
}
extern "C" void apply_2d(const float* src, const float* coeff,
                         const float* elm, float* dst, int C, int N,
                         int mode) {
  const int kElm = kTriClasses * kTriVerts * kTriVerts;
  const long long cell = (long long)N * N;
  for (int c = 0; c < C; ++c)
    for (long long q = 0; q < cell; ++q)
      dst[c * cell + q] = p1_apply_point_2d(
          src + c * cell, coeff ? coeff + c * cell : nullptr, (int)(q / N),
          (int)(q % N), N, elm + c * kElm, mode);
}
// One thread block (face, band x0) in the form the kernel runs for MODE.
template <int MODE, class Out>
static void apply_band(const float* src, const float* coeff, const Out& out,
                       int x0, int N, const float* elm) {
  if constexpr (tri_apply_staged(MODE)) {
    static float gs[kApplyG2];
    HostTeam team;
    tri_apply_band_staged<MODE>(team, src, coeff, out, x0, N, elm, gs);
  } else {
    for (int tid = 0; tid < kApplyThreads; ++tid)
      tri_apply_band<MODE>(src, coeff, out, x0, N, elm, tid >> 5, tid & 31);
  }
}
template <class Out>
static void apply_band_mode(const float* src, const float* coeff,
                            const Out& out, int x0, int N, const float* elm,
                            int mode) {
  if (!coeff)
    apply_band<-1>(src, coeff, out, x0, N, elm);
  else if (mode == 0)
    apply_band<0>(src, coeff, out, x0, N, elm);
  else if (mode == 1)
    apply_band<1>(src, coeff, out, x0, N, elm);
  else
    apply_band<2>(src, coeff, out, x0, N, elm);
}
// Kernel B4-2D's launcher and thread blocks (face, band of rows) one after
// another: the table check, then every block through the band walk.
// count: null, or one int per slot. work: null, or the transforms and
// means of the run. Returns the launcher's error (11,
// cudaErrorInvalidValue) for tables it refuses, else 0.
extern "C" int apply_walk_2d(const float* src, const float* coeff,
                             const float* elm, float* dst, int C, int N,
                             int mode, const int* offs, const int* margins,
                             int* count, long long* work) {
  if (!tables_match(offs, margins)) return 11;
  const long long face = (long long)N * N;
  const int ne = kTriClasses * kTriVerts * kTriVerts;
  coeff_work[0] = coeff_work[1] = 0;
  for (int c = 0; c < C; ++c) {
    const float* co = coeff ? coeff + c * face : nullptr;
    for (int x0 = 0; x0 < N; x0 += kApplyR2) {
      if (count)
        apply_band_mode(src + c * face, co,
                        CountStore{CellStore{dst + c * face}, count + c * face},
                        x0, N, elm + c * ne, mode);
      else
        apply_band_mode(src + c * face, co, CellStore{dst + c * face}, x0, N,
                        elm + c * ne, mode);
    }
  }
  if (work) {
    work[0] = coeff_work[0];
    work[1] = coeff_work[1];
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """The 2D kernels' per-point functions (csrc/*.cuh) built with the
    host C++ compiler: the arithmetic that runs on the card, checked here
    against the plain versions without a GPU."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_kernels_2d")
    (d / "harness.cpp").write_text(HOST_HARNESS)
    so = d / "libhost_kernels_2d.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.const_apply_2d.argtypes = [P, P, P, P, I, I, P, P, P]
    lib.diag_2d.argtypes = [P, P, P, I, I, I, I]
    lib.apply_2d.argtypes = [P, P, P, P, I, I, I]
    lib.apply_walk_2d.argtypes = [P, P, P, P, I, I, I, P, P, P, P]
    lib.diag_walk_2d.argtypes = [P, P, P, I, I, I, I, P, P, P, P]
    return lib


def test_kernel_tables_2d():
    """The launcher's 2D tables, and the triangle constants hard-coded in
    csrc/p1_tri.cuh, are the micro tables."""
    dirs, gmask = tk._kernel_tables(2)
    assert dirs.shape == (7, 2) and list(gmask) == [1, 2, 3]
    text = (CSRC / "p1_tri.cuh").read_text()
    assert "{{0, 0}, {1, 0}, {0, 1}}" in text and "{{1, 0}, {0, 1}, {1, 1}}" in text
    assert micro.TRI_OFFSETS.tolist() == [[[0, 0], [1, 0], [0, 1]],
                                          [[1, 0], [0, 1], [1, 1]]]
    assert micro.TRI_BASE_MARGIN.tolist() == [1, 2]


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,level", CASES + [("rect22", 4)])
def test_kernel_2d_point_math_matches_plain(host_kernels, name, level, form):
    _, tsp = _spaces(name, level)
    et = compute_elmats(tsp, FORMS[form][1],
                        torch.as_tensor(tsp.cell_vertices(0))).contiguous()
    C, N = tsp.C_loc, tsp.N
    xt = T(_rand(tsp.block_shape, tsp.vertex_mask, 30 + level))
    outside = ~tsp.vertex_mask_t.bool()
    A = tk.stencil_weights(et, 2).contiguous()
    E = tk.face_weights_full(et, 2).contiguous()
    ref = tk.p1_const_apply_torch(xt, A, level, 2, tsp.pitch, E=E)
    out = torch.full_like(xt, float("nan"))
    dirs, gmask = tk._kernel_tables(2)
    assert host_kernels.const_apply_2d(
        xt.data_ptr(), A.data_ptr(), E.data_ptr(), out.data_ptr(), C, N,
        dirs.ctypes.data, gmask.ctypes.data, None) == 0
    _close(out, ref, 1e-5)
    assert not out[:, outside].any()

    coeff = T(_rand(tsp.block_shape, tsp.vertex_mask, level, lo=0.5))
    for co, mode in [(None, "arithmetic")] + [(coeff, m) for m in MODES]:
        ptr = None if co is None else co.data_ptr()
        for lumped in (False, True):
            ref = tk3.p1_diagonal_local_torch(et, level, 2, tsp.pitch, lumped,
                                              co, mode)
            out = torch.full_like(ref, float("nan"))
            host_kernels.diag_2d(et.data_ptr(), ptr, out.data_ptr(), C, N,
                                 int(lumped), MODES.index(mode))
            _close(out, ref, 1e-6, max(ref.abs().max().item(),
                                       et.abs().max().item()))
            assert not out[:, outside].any()
        ref = tk3.p1_apply_local_torch(xt, et, level, 2, tsp.pitch, co, mode)
        out = torch.full_like(ref, float("nan"))
        host_kernels.apply_2d(xt.data_ptr(), ptr, et.data_ptr(),
                              out.data_ptr(), C, N, MODES.index(mode))
        _close(out, ref, 1e-5)
        assert not out[:, outside].any()


@functools.lru_cache(maxsize=None)
def _torch_space(name, level):
    return P1Space(_storages(name)[1], level, device="cpu")


# levels 0-5 on both meshes, and rect at 6 and 7, whose rows hold more
# than one step of a lane's chunks (2 x 32 slots)
WALK_CASES_2D = ([(name, lv) for name in ("rect", "annulus")
                  for lv in range(6)] + [("rect", 6), ("rect", 7)])


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,level", WALK_CASES_2D)
def test_kernel_2d_walk_writes_every_slot_once(host_kernels, name, level,
                                               form):
    """Kernel B2's 2D walk over all its thread blocks (band of rows, face)
    through a counting store: every slot of the face block written exactly
    once, the slots past the triangle exactly 0 whatever the source holds
    there, and, for a source that is 0 there (as the operator keeps it:
    the shell's taps past the triangle carry zero weight), every slot
    equal to the plain version."""
    tsp = _torch_space(name, level)
    et = compute_elmats(tsp, FORMS[form][1],
                        torch.as_tensor(tsp.cell_vertices(0))).contiguous()
    C, N = tsp.C_loc, tsp.N
    A = tk.stencil_weights(et, 2).contiguous()
    E = tk.face_weights_full(et, 2).contiguous()
    xt = T(_rand(tsp.block_shape, tsp.vertex_mask, 50 + level))
    ref = tk.p1_const_apply_torch(xt, A, level, 2, tsp.pitch, E=E)
    outside = ~tsp.vertex_mask_t.bool().expand(xt.shape)
    dirs, gmask = tk._kernel_tables(2)
    for src in (xt, xt.masked_fill(outside, float("nan"))):
        out = torch.full_like(xt, float("nan"))
        count = torch.zeros(xt.shape, dtype=torch.int32)
        assert host_kernels.const_apply_2d(
            src.data_ptr(), A.data_ptr(), E.data_ptr(), out.data_ptr(), C, N,
            dirs.ctypes.data, gmask.ctypes.data, count.data_ptr()) == 0
        assert (count == 1).all()
        assert (out[outside] == 0).all()
        if src is xt:
            _close(out, ref, 1e-5)


def test_kernel_2d_launcher_refuses_other_dirs(host_kernels):
    """The B2-2D launcher (mirrored by the host harness) takes only the
    direction table its walk was compiled with, micro.stencil_directions(2)
    in its order."""
    tsp = _torch_space("rect", 1)
    et = compute_elmats(tsp, tforms.laplace_form,
                        torch.as_tensor(tsp.cell_vertices(0))).contiguous()
    A = tk.stencil_weights(et, 2).contiguous()
    E = tk.face_weights_full(et, 2).contiguous()
    x = torch.zeros(tsp.block_shape)
    dirs, gmask = tk._kernel_tables(2)
    for d in (dirs[::-1].copy(), dirs + 1):
        assert host_kernels.const_apply_2d(
            x.data_ptr(), A.data_ptr(), E.data_ptr(), x.data_ptr(),
            tsp.C_loc, tsp.N, d.ctypes.data, gmask.ctypes.data, None) == 11

# kernel B4-2D's band walk

# None: no coefficient
WALK_MODES = (None,) + tuple(MODES)


def _b4_inputs(name, level, seed):
    """The face space, its element matrices (Laplace), a random src, the
    linear coefficient k = 1 + x + 0.5 y and a random one in [0.5, 2),
    both 0 past the triangle."""
    tsp = _torch_space(name, level)
    et = compute_elmats(tsp, tforms.laplace_form,
                        torch.as_tensor(tsp.cell_vertices(0))).contiguous()
    mask = tsp.vertex_mask_t
    p = tsp.coords()
    ks = {"linear": ((1.0 + p[..., 0] + 0.5 * p[..., 1]) * mask)
          .to(torch.float32).contiguous(),
          "random": T(_rand(tsp.block_shape, tsp.vertex_mask, seed, lo=0.5))}
    src = torch.as_tensor(np.random.default_rng(seed + 1).standard_normal(
        tsp.block_shape).astype(np.float32))
    return tsp, et, src, ks


def _host_walk_2d(lib, src, co, et, N, mode, tables=None, count=None,
                  work=None):
    offs, margins = tables or tk3._kernel_tables(2)
    out = torch.full_like(src, float("nan"))
    assert lib.apply_walk_2d(
        src.data_ptr(), None if co is None else co.data_ptr(), et.data_ptr(),
        out.data_ptr(), src.shape[0], N, MODES.index(mode or "arithmetic"),
        offs.ctypes.data, margins.ctypes.data, None if count is None else count.data_ptr(),
        None if work is None else work.ctypes.data) == 0
    return out


@pytest.mark.parametrize("mode", WALK_MODES)
@pytest.mark.parametrize("name,level", [(name, lv)
                                        for name in ("rect", "annulus")
                                        for lv in (2, 3, 4, 5)]
                         + [("rect", 9)])
def test_kernel_2d_apply_walk_writes_every_slot_once(host_kernels, name,
                                                     level, mode):
    """Kernel B4-2D's band walk over all its thread blocks (face, band of
    rows) through a counting store, on the rectangle and on the 12-face
    annulus (general weights) at levels 2-5 and the rectangle at level 9
    (rows of more than one staged tile of 256 slots), without a
    coefficient and in each mean (the arithmetic one in the direct form,
    the harmonic and geometric ones staged), on a linear and a random
    coefficient: every slot written exactly once,
    exactly 0 past the triangle, every slot equal to the plain version
    within 1e-5 * max|y|; and the same result, bit for bit, when src and
    the coefficient hold NaN past the triangle (neither is read there)."""
    tsp, et, src, ks = _b4_inputs(name, level, 60 + level)
    outside = ~tsp.vertex_mask_t.bool().expand(src.shape)
    for kind in ("linear", "random") if mode is not None else (None,):
        co = None if kind is None else ks[kind]
        ref = tk3.p1_apply_local_torch(src, et, level, 2, tsp.pitch, co,
                                       mode or "arithmetic")
        count = torch.zeros(src.shape, dtype=torch.int32)
        out = _host_walk_2d(host_kernels, src, co, et, tsp.N, mode,
                            count=count)
        assert (count == 1).all()
        assert (out[outside] == 0).all()
        _close(out, ref, 1e-5)
        again = _host_walk_2d(
            host_kernels, src.masked_fill(outside, float("nan")),
            None if co is None else co.masked_fill(outside, float("nan")),
            et, tsp.N, mode)
        assert torch.equal(again, out)


@pytest.mark.parametrize("mode", WALK_MODES)
@pytest.mark.parametrize("name,level", [("rect", 4), ("annulus", 3)])
def test_kernel_2d_interior_sum_matches_point_math(host_kernels, name, level,
                                                   mode):
    """The band walk's untested interior sum (the transformed neighbours
    read directly, or from the staged tile) against p1_apply_point_2d at every slot: within 2 ulps (the same
    terms in the same order), equal on the edge and shell slots, which run
    p1_apply_point_2d itself."""
    tsp, et, src, ks = _b4_inputs(name, level, 70 + level)
    co = None if mode is None else ks["random"]
    out = _host_walk_2d(host_kernels, src, co, et, tsp.N, mode)
    point = torch.empty_like(src)
    host_kernels.apply_2d(src.data_ptr(),
                          None if co is None else co.data_ptr(),
                          et.data_ptr(), point.data_ptr(), tsp.C_loc, tsp.N,
                          MODES.index(mode or "arithmetic"))
    a, b = out.numpy(), point.numpy()
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    assert (np.abs(a - b) <= 2 * ulp).all()
    N = tsp.N
    bx, bz = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    rim = tsp.vertex_mask & ((bx == 0) | (bz == 0) | (bx + bz == N - 1))
    assert np.array_equal(a[:, rim], b[:, rim])


def test_kernel_2d_apply_launcher_refuses_other_tables(host_kernels):
    """The B4-2D launcher (mirrored by the host harness) takes the JAX
    package's micro.offsets(2) and micro.base_margin(2), the tables its
    walk was compiled with, and refuses any other."""
    from hyteg_tpu.indexing import micro as jmicro

    offs = np.ascontiguousarray(jmicro.offsets(2), dtype=np.int32)
    margins = np.ascontiguousarray(jmicro.base_margin(2), dtype=np.int32)
    tsp, et, src, _ = _b4_inputs("rect", 1, 0)
    _host_walk_2d(host_kernels, src, None, et, tsp.N, None,
                  tables=(offs, margins))
    out = torch.empty_like(src)
    for o, m in ((offs[::-1].copy(), margins), (offs, margins + 1),
                 (offs[:, [1, 0, 2]].copy(), margins)):
        assert host_kernels.apply_walk_2d(
            src.data_ptr(), None, et.data_ptr(), out.data_ptr(), tsp.C_loc,
            tsp.N, 0, o.ctypes.data, m.ctypes.data, None, None) == 11


def _work_per_slot_2d(lib, level, mode):
    """Coefficient transforms and means finished per in-triangle slot of
    one face (random element matrices and coefficient)."""
    N = (1 << level) + 1
    rng = np.random.default_rng(level)
    inside = np.add.outer(np.arange(N), np.arange(N)) <= N - 1
    src = torch.as_tensor(rng.standard_normal((1, N, N)).astype(np.float32))
    et = torch.as_tensor(rng.standard_normal((1, 2, 3, 3)).astype(np.float32))
    co = torch.as_tensor((rng.uniform(0.5, 2.0, (1, N, N)) * inside)
                         .astype(np.float32))
    work = np.zeros(2, np.int64)
    _host_walk_2d(lib, src, co, et, N, mode, work=work)
    return work / int(inside.sum())


@pytest.mark.parametrize("mode,expected", [("arithmetic", [7.0, 5.99]),
                                           ("harmonic", [1.27, 5.99]),
                                           ("geometric", [1.27, 5.99])])
def test_kernel_2d_staged_work_per_slot(host_kernels, mode, expected):
    """What B4-2D's staged form saves, counted on one face at level 11 (the
    level chip_smoke.py times): per in-triangle slot, the direct form,
    which the arithmetic mean runs, transforms 7.00 values and finishes
    5.99 means (7 and 6 at an interior slot); the staged form of the
    harmonic and geometric means transforms 1.27, the edge and shell
    slots' tested gathers included, and finishes as many means."""
    assert np.round(_work_per_slot_2d(host_kernels, 11, mode), 2).tolist() \
        == expected


# kernel B3-2D's band walk

def _host_diag_walk_2d(lib, et, co, N, lumped, mode, tables=None,
                       count=None, work=None):
    offs, margins = tables or tk3._kernel_tables(2)
    out = torch.full((et.shape[0], N, N), float("nan"))
    assert lib.diag_walk_2d(
        et.data_ptr(), None if co is None else co.data_ptr(), out.data_ptr(),
        et.shape[0], N, int(lumped), MODES.index(mode or "arithmetic"),
        offs.ctypes.data, margins.ctypes.data,
        None if count is None else count.data_ptr(),
        None if work is None else work.ctypes.data) == 0
    return out


@pytest.mark.parametrize("name,level", [("rect", lv) for lv in (2, 3, 4, 5)]
                         + [("annulus", 4)])
def test_kernel_b3_2d_host_output_unchanged(host_kernels, name, level):
    """B3-2D's band walk (the class values without a coefficient, the
    untested interior sum and the tested edge and shell slots with one),
    run through its launcher and every thread block on the host, equals
    its per-point math diag_point_2d compiled in the same harness bit for
    bit: on the Laplace element matrices, a coefficient uniform in [0.5, 2)
    from numpy's default_rng(level), lumped 0 and 1, without a coefficient
    and in the three means; and the plain version within 1e-6 of the
    larger of max|d| and max|elmats|."""
    tsp = _torch_space(name, level)
    et = compute_elmats(tsp, tforms.laplace_form,
                        torch.as_tensor(tsp.cell_vertices(0))).contiguous()
    k = torch.as_tensor((np.random.default_rng(level).uniform(
        0.5, 2.0, tsp.block_shape) * tsp.vertex_mask[None]).astype(np.float32))
    for lumped in (0, 1):
        for mode in (None,) + tuple(MODES):
            co = None if mode is None else k
            point = torch.zeros(tsp.block_shape)
            host_kernels.diag_2d(et.data_ptr(),
                                 None if co is None else co.data_ptr(),
                                 point.data_ptr(), tsp.C_loc, tsp.N, lumped,
                                 MODES.index(mode or "arithmetic"))
            out = _host_diag_walk_2d(host_kernels, et, co, tsp.N, lumped,
                                     mode)
            assert np.array_equal(out.numpy(), point.numpy())
            ref = tk3.p1_diagonal_local_torch(et, level, 2, tsp.pitch,
                                              bool(lumped), co,
                                              mode or "arithmetic")
            _close(out, ref, 1e-6, max(ref.abs().max().item(),
                                       et.abs().max().item()))


@pytest.mark.parametrize("mode", WALK_MODES)
@pytest.mark.parametrize("name,level", [(name, lv)
                                        for name in ("rect", "annulus")
                                        for lv in (0, 1, 2, 3, 4, 5)]
                         + [("rect", 9)])
def test_kernel_2d_diag_walk_writes_every_slot_once(host_kernels, name,
                                                    level, mode):
    """Kernel B3-2D's band walk over all its thread blocks (face, band of
    rows) through a counting store, on the rectangle and on the 12-face
    annulus (general weights) at levels 0-5 and the rectangle at level 9
    (rows of many 16-byte runs), without a coefficient and in each mean:
    every slot written exactly once, exactly 0 past the triangle, the
    plain version within 1e-6 of the larger of max|d| and max|elmats|,
    lumped or not; and the same result, bit for bit, when the coefficient
    holds NaN past the triangle (it is not read there)."""
    tsp, et, _, ks = _b4_inputs(name, level, 80 + level)
    outside = ~tsp.vertex_mask_t.bool().expand(tsp.block_shape)
    co = None if mode is None else ks["random"]
    for lumped in (False, True):
        count = torch.zeros(tsp.block_shape, dtype=torch.int32)
        out = _host_diag_walk_2d(host_kernels, et, co, tsp.N, lumped, mode,
                                 count=count)
        assert (count == 1).all()
        assert (out[outside] == 0).all()
        ref = tk3.p1_diagonal_local_torch(et, level, 2, tsp.pitch, lumped,
                                          co, mode or "arithmetic")
        _close(out, ref, 1e-6, max(ref.abs().max().item(),
                                   et.abs().max().item()))
        if co is not None:
            again = _host_diag_walk_2d(host_kernels, et,
                                       co.masked_fill(outside, float("nan")),
                                       tsp.N, lumped, mode)
            assert torch.equal(again, out)


def test_kernel_2d_diag_launcher_refuses_other_tables(host_kernels):
    """The B3-2D launcher (mirrored by the host harness) takes the JAX
    package's micro.offsets(2) and micro.base_margin(2), the tables its
    class rule and interior sum were compiled with, and refuses any
    other."""
    from hyteg_tpu.indexing import micro as jmicro

    offs = np.ascontiguousarray(jmicro.offsets(2), dtype=np.int32)
    margins = np.ascontiguousarray(jmicro.base_margin(2), dtype=np.int32)
    tsp, et, _, _ = _b4_inputs("rect", 1, 0)
    _host_diag_walk_2d(host_kernels, et, None, tsp.N, False, None,
                       tables=(offs, margins))
    out = torch.empty(tsp.block_shape)
    for o, m in ((offs[::-1].copy(), margins), (offs, margins + 1),
                 (offs[:, [1, 0, 2]].copy(), margins)):
        assert host_kernels.diag_walk_2d(
            et.data_ptr(), None, out.data_ptr(), tsp.C_loc, tsp.N, 0, 0,
            o.ctypes.data, m.ctypes.data, None, None) == 11


@pytest.mark.parametrize("mode,expected", [("arithmetic", [7.01, 5.99]),
                                           ("harmonic", [1.28, 5.99]),
                                           ("geometric", [1.28, 5.99])])
def test_kernel_2d_diag_staged_work_per_slot(host_kernels, mode, expected):
    """What B3-2D's staged form saves, counted on one face at level 11 (the
    level chip_smoke.py times): per in-triangle slot, the direct form,
    which the arithmetic mean runs, transforms 7.01 coefficient values and
    finishes 5.99 means (7 and 6 at an interior slot; the edge and shell
    slots' tested gathers transform each element's 3 vertices); the staged
    form of the harmonic and geometric means transforms 1.28 and finishes
    as many means."""
    N = (1 << 11) + 1
    rng = np.random.default_rng(11)
    inside = np.add.outer(np.arange(N), np.arange(N)) <= N - 1
    et = torch.as_tensor(rng.standard_normal((1, 2, 3, 3)).astype(np.float32))
    co = torch.as_tensor((rng.uniform(0.5, 2.0, (1, N, N)) * inside)
                         .astype(np.float32))
    work = np.zeros(2, np.int64)
    _host_diag_walk_2d(host_kernels, et, co, N, False, mode, work=work)
    assert np.round(work / int(inside.sum()), 2).tolist() == expected

# ---------------------------------------------------------------------------
# grid transfers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _transfer_pair(name, clevel):
    js, ts = _storages(name)
    # a GMG stack passes its shared pitch; 2D spaces ignore it
    pitch = (1 << (clevel + 1)) + 1
    return (JTransfer(JSpace(js, clevel, pitch=pitch),
                      JSpace(js, clevel + 1, pitch=pitch)),
            P1Transfer(P1Space(ts, clevel, device="cpu", pitch=pitch),
                       P1Space(ts, clevel + 1, device="cpu", pitch=pitch)))


@pytest.mark.parametrize("name,clevel", [("rect", 1), ("rect", 2),
                                         ("annulus", 1)])
def test_2d_transfers_match_jax(name, clevel):
    jtr, ttr = _transfer_pair(name, clevel)
    uc = _rand(jtr.coarse.block_shape, jtr.coarse.vertex_mask, clevel)
    uf = _rand(jtr.fine.block_shape, jtr.fine.vertex_mask, clevel + 7)
    _close(ttr.prolongate_and_add(T(uc), T(uf)),
           jtr.prolongate_and_add(jnp.asarray(uc), jnp.asarray(uf)), 1e-6)
    rf = _rand(jtr.fine.block_shape, jtr.fine.vertex_mask, clevel + 1)
    _close(ttr.restrict(T(rf)), jtr.restrict(jnp.asarray(rf)), 1e-6)
    _close(ttr.restrict_injection(T(rf)),
           jtr.restrict_injection(jnp.asarray(rf)), 1e-6)


@pytest.mark.parametrize("name", ["rect", "annulus"])
def test_2d_restriction_is_transpose(name):
    """Dense P and R over global DoFs (ids from the JAX space, whose
    layout the port shares): R = P^T."""
    jtr, ttr = _transfer_pair(name, 1)
    gc, gf = jtr.coarse.global_ids(), jtr.fine.global_ids()
    nc, nf = gc.max() + 1, gf.max() + 1

    def to_blocks(g, v):
        out = np.zeros(g.shape, np.float32)
        out[g >= 0] = v[g[g >= 0]]
        return T(out)

    def from_blocks(g, blk, n):
        v, blk = np.zeros(n), N_(blk)
        v[g[g >= 0]] = blk[g >= 0]
        return v

    P = np.stack([from_blocks(gf, ttr.prolongate(to_blocks(gc, e)), nf)
                  for e in np.eye(nc)], axis=1)
    R = np.stack([from_blocks(gc, ttr.restrict(to_blocks(gf, e)), nc)
                  for e in np.eye(nf)], axis=1)
    assert np.abs(R - P.T).max() <= 1e-6 * np.abs(P).max()


# ---------------------------------------------------------------------------
# the 2D GMG stack (tests/test_gmg_regression.py:46-52)
# ---------------------------------------------------------------------------


def _u_jax(p):
    return jnp.sin(jnp.pi * p[..., 0]) * jnp.sin(jnp.pi * p[..., 1])


@functools.lru_cache(maxsize=None)
def _gmg_histories(smoother):
    """Residual histories of the JAX stack and the port's on the
    regression case, same element matrices, eigenvalue bounds, x0, b."""
    jstack = j_make_p1_gmg(_storages("rect22")[0], min_level=2, max_level=3,
                           smoother=smoother)
    eigs = {l: jsm.p1_stencil_eig_fourier(np.asarray(op.stencil), 2)
            for l, op in jstack.operators.items()}
    tstack = make_p1_gmg(
        _storages("rect22")[1], 2, 3, smoother=smoother, eigs=eigs,
        elmats={l: interop.elmats_from_reference(np.asarray(op.elmats),
                                                 device="cpu")
                for l, op in jstack.operators.items()}, device="cpu")
    sp, bc = jstack.space(), jt.BoundaryCondition.all_dirichlet()
    mass = jop.P1ElementwiseOperator(sp, jforms.mass_form)
    x = sp.interpolate(_u_jax, sp.zeros(), jt.DoFType.DIRICHLET, bc)
    f = sp.interpolate(lambda p: 2 * jnp.pi ** 2 * _u_jax(p), sp.zeros(),
                       jt.DoFType.ALL, bc)
    b = sp.restore_rows(mass.apply_raw(f), sp.zeros(), jt.FLAG_INNER, bc)
    xt, bt = T(np.asarray(x)), T(np.asarray(b))
    cycle = jax.jit(jstack.gmg.cycle)
    ref = [float(jstack.residual_norm(x, b))]
    got = [float(tstack.residual_norm(xt, bt))]
    for _ in range(6):
        x, xt = cycle(x, b), tstack.gmg.cycle(xt, bt)
        ref.append(float(jstack.residual_norm(x, b)))
        got.append(float(tstack.residual_norm(xt, bt)))
    return ref, got, tstack, eigs


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_2d_gmg_residual_history_matches_jax(smoother):
    ref, got, _, _ = _gmg_histories(smoother)
    assert abs(got[0] - ref[0]) <= 1e-6 * ref[0]
    assert abs(got[1] - ref[1]) <= 1e-3 * ref[1]
    for k in range(2, len(ref)):
        assert abs(got[k] - ref[k]) <= max(5e-2 * ref[k], 1e-6 * ref[0])
    # the reference test's own gate (tests/test_gmg_regression.py:46-52)
    assert all(math.isfinite(r) for r in got)
    assert got[-1] < 1e-4 and got[-1] <= got[0]


def test_2d_gmg_eig_bounds_match_jax():
    """The port's default Chebyshev bounds (Fourier symbol of each
    level's 2D stencil) equal the JAX package's."""
    _, _, tstack, eigs = _gmg_histories("chebyshev")
    for l, op in tstack.operators.items():
        assert abs(tsm.p1_stencil_eig_fourier(op.stencil, 2) - eigs[l]) \
            <= 1e-6 * eigs[l]
