"""Kernels B2 (constant-stencil apply) and B3 (partial diagonal) of the
PyTorch port, in their plain versions, and the operator built on them,
against the JAX package on identical inputs.

The JAX side runs as its own CPU tests run it: the XLA formulation
``p1_const_apply_xla``, the Pallas kernel in interpret mode (levels <= 3)
and the elementwise ``p1_diagonal_local``/``p1_lumped_local``. Element
matrices are carried over through hyteg_tpu_torch.interop.

The CUDA kernels' per-point functions (csrc/*.cuh) are also compiled
with the host C++ compiler and held against the plain versions, so the
arithmetic that runs on the card is checked here without a GPU.

Tolerances (f32 sums taken in another order): stencil tables 1e-6 of
their largest entry; applies 1e-5 * max|y|; diagonals 1e-6 of the larger
of max|d| and max|elmats| (lumped Laplace row sums cancel to ~0).
"""

import ctypes
import functools
import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.core.types import FLAG_INNER as J_FLAG_INNER
from hyteg_tpu.functions.p1 import P1Space as JSpace
from hyteg_tpu.kernels import p1_const_stencil as jk
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import forms as jforms
from hyteg_tpu.operators import p1_elementwise as jop
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.types import FLAG_INNER
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.kernels import p1_const_stencil as tk
from hyteg_tpu_torch.kernels import p1_stencil as tk3
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.operators import forms as tforms
from hyteg_tpu_torch.operators.averaging import MODES
from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
from hyteg_tpu_torch.primitives.storage import CellStorage

torch.set_num_threads(1)

FORMS = {"laplace": (jforms.laplace_form, tforms.laplace_form),
         "mass": (jforms.mass_form, tforms.mass_form)}


def _mesh(mod, name):
    return mod.mesh_single_tet() if name == "tet" else mod.mesh_unit_cube(
        int(name[-1]))


@functools.lru_cache(maxsize=None)
def _spaces(name, level, pitch):
    return (JSpace(JStorage(_mesh(jmi, name)), level, pitch=pitch),
            P1Space(CellStorage(_mesh(tmi, name)), level, device="cpu",
                    pitch=pitch))


def _setup(name, level, pitch=None, form="laplace", seed=0):
    jsp, tsp = _spaces(name, level, pitch)
    elm = np.asarray(jop.compute_elmats(
        jsp, FORMS[form][0], jnp.asarray(jsp.cell_vertices(0))))
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(jsp.block_shape)
         * jsp.vertex_mask[None]).astype(np.float32)
    return jsp, tsp, elm, x


def _assert_close(got, ref, scale, rtol):
    got = interop.block_to_numpy(got) if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * scale


_xla_apply = jax.jit(jk.p1_const_apply_xla,
                     static_argnames=("level", "dim", "pitch"))

APPLY_CASES = ([("tet", l, None) for l in (1, 2, 3, 4)]
               + [("cube1", l, None) for l in (1, 2, 3, 4)]
               + [("cube2", 3, 17)])


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,level,pitch", APPLY_CASES)
def test_stencil_tables_match(name, level, pitch, form):
    _, _, elm, _ = _setup(name, level, pitch, form)
    et = interop.elmats_from_reference(elm, device="cpu")
    for jf, tf in ((jk.stencil_weights, tk.stencil_weights),
                   (jk.face_weights_full, tk.face_weights_full)):
        ref = np.asarray(jf(jnp.asarray(elm), 3))
        _assert_close(tf(et, 3), ref, np.abs(ref).max(), 1e-6)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,level,pitch", APPLY_CASES)
def test_plain_apply_matches_xla(name, level, pitch, form):
    jsp, tsp, elm, x = _setup(name, level, pitch, form, seed=level)
    A, E = jk.stencil_weights(jnp.asarray(elm), 3), jk.face_weights_full(
        jnp.asarray(elm), 3)
    ref = np.asarray(_xla_apply(jnp.asarray(x), A, level=level, dim=3,
                                pitch=jsp.pitch, E=E))
    et = interop.elmats_from_reference(elm, device="cpu")
    got = tk.p1_const_apply(interop.block_from_reference(x, device="cpu"),
                            tk.stencil_weights(et, 3),
                            tk.face_weights_full(et, 3), level, 3, tsp.pitch)
    _assert_close(got, ref, np.abs(ref).max(), 1e-5)


@pytest.mark.parametrize("name,level,pitch",
                         [("tet", 2, None), ("cube1", 1, None),
                          ("cube1", 2, None), ("cube1", 3, None),
                          ("cube1", 2, 9)])
def test_plain_apply_matches_pallas_interpret(name, level, pitch):
    jsp, tsp, elm, x = _setup(name, level, pitch, seed=10 + level)
    A, E = jk.stencil_weights(jnp.asarray(elm), 3), jk.face_weights_full(
        jnp.asarray(elm), 3)
    ref = np.asarray(jk.p1_const_apply_pallas(
        jnp.asarray(x), A, E, level, 3, jsp.pitch, interpret=True))
    et = interop.elmats_from_reference(elm, device="cpu")
    got = tk.p1_const_apply_torch(interop.block_from_reference(x, device="cpu"),
                                  tk.stencil_weights(et, 3), level, 3,
                                  tsp.pitch, E=tk.face_weights_full(et, 3))
    _assert_close(got, ref, np.abs(ref).max(), 1e-5)


@pytest.mark.parametrize("mode", [None, "arithmetic", "harmonic", "geometric"])
@pytest.mark.parametrize("lumped", [False, True])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_plain_diagonal_matches_jax(form, lumped, mode):
    jsp, tsp, elm, _ = _setup("cube1", 3, 17, form)
    rng = np.random.default_rng(3)
    coeff = None
    if mode is not None:
        coeff = (rng.uniform(0.5, 2.0, jsp.block_shape)
                 * jsp.vertex_mask[None]).astype(np.float32)
    jc = None if coeff is None else jnp.asarray(coeff)
    args = (jnp.asarray(elm), 3, 3, jsp.block_shape, jsp.pitch, jc)
    if not lumped:
        ref = jop.p1_diagonal_local(*args, coeff_avg=mode or "arithmetic")
    elif mode in (None, "arithmetic"):
        ref = jop.p1_lumped_local(*args)
    else:  # the JAX package's lumped entry point has no coeff_avg argument
        ref = jop._p1_diag_local(*args, lambda e, t, a: e[:, t, a, :].sum(-1),
                                 mode)
    got = tk3.p1_diagonal_local(
        interop.elmats_from_reference(elm, device="cpu"), 3, 3, tsp.pitch, lumped,
        None if coeff is None else interop.block_from_reference(coeff, device="cpu"),
        mode or "arithmetic")
    ref = np.asarray(ref)
    _assert_close(got, ref, max(np.abs(ref).max(), np.abs(elm).max()), 1e-6)


OP_CASES = [("cube1", 3, None), ("cube2", 2, None), ("cube1", 2, 9),
            ("tet", 3, None)]


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,level,pitch", OP_CASES)
def test_operator_matches_jax(name, level, pitch, form):
    jsp, tsp, elm, x = _setup(name, level, pitch, form, seed=20 + level)
    jo = jop.P1ElementwiseOperator(jsp, FORMS[form][0],
                                   elmats=jnp.asarray(elm))
    to = P1ElementwiseOperator(tsp, FORMS[form][1],
                               elmats=interop.elmats_from_reference(elm, device="cpu"))
    xt = interop.block_from_reference(x, device="cpu")
    ref = np.asarray(jo.apply_raw(jnp.asarray(x)))
    _assert_close(to.apply_raw(xt), ref, np.abs(ref).max(), 1e-5)
    ref = np.asarray(jo.apply_inner(jnp.asarray(x), None, J_FLAG_INNER))
    _assert_close(to.apply_inner(xt, None, FLAG_INNER), ref,
                  np.abs(ref).max(), 1e-5)
    ref = np.asarray(jo.inverse_diagonal())
    _assert_close(to.inverse_diagonal(), ref, np.abs(ref).max(), 1e-6)
    if form == "mass":
        ref = np.asarray(jo.lumped_inverse_diagonal())
        _assert_close(to.lumped_inverse_diagonal(), ref, np.abs(ref).max(),
                      1e-6)


def test_operator_computes_same_elmats():
    jsp, tsp, elm, x = _setup("cube1", 2)
    to = P1ElementwiseOperator(tsp, tforms.laplace_form)
    _assert_close(to.elmats, elm, np.abs(elm).max(), 1e-6)
    assert set(dict(to.named_buffers())) == {"elmats", "stencil",
                                             "stencil_face"}


def test_apply_with_coefficient_is_not_ported():
    """The coefficient apply, once unported, is kernel B4 now: with k = 1
    the operator's coefficient apply (B4's plain version) equals its
    constant-stencil apply (B2's)."""
    _, tsp, _, x = _setup("cube1", 2)
    op = P1ElementwiseOperator(tsp, tforms.laplace_form)
    xt = tsp.exchange_rep(interop.block_from_reference(x, device="cpu"))
    ref = op.apply_raw(xt)
    _assert_close(op.apply_raw(xt, coeff=torch.ones_like(xt)), ref,
                  ref.abs().max().item(), 1e-5)


def test_wrappers_reject_non_cpu_non_cuda_tensors():
    _, tsp, elm, x = _setup("cube1", 1)
    et = interop.elmats_from_reference(elm, device="cpu").to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.p1_const_apply(torch.empty(tsp.block_shape, device="meta"),
                          tk.stencil_weights(et, 3),
                          tk.face_weights_full(et, 3), 1, 3, tsp.pitch)
    with pytest.raises(ValueError, match="CUDA"):
        tk3.p1_diagonal_local(et, 1, 3, tsp.pitch)


def test_count_launch_counts_by_level():
    """The launch count of a wrapper, in total and by level, per dim."""
    from hyteg_tpu_torch.kernels import build
    from hyteg_tpu_torch.kernels import p2_const_stencil as tk5

    for w in (tk.p1_const_apply, tk3.p1_apply_local, tk3.p1_diagonal_local,
              tk5.p2_const_apply):
        assert (w.launches_by_level, w.launches_by_level_2d) == ({}, {})

    def wrapper():
        pass

    wrapper.launches = wrapper.launches_2d = 0
    wrapper.launches_by_level, wrapper.launches_by_level_2d = {}, {}
    for dim, level in ((3, 7), (3, 2), (3, 7), (2, 11)):
        build.count_launch(wrapper, dim, level)
    assert (wrapper.launches, wrapper.launches_2d) == (3, 1)
    assert wrapper.launches_by_level == {7: 2, 2: 1}
    assert wrapper.launches_by_level_2d == {11: 1}


# ---------------------------------------------------------------------------
# the CUDA kernels' per-point math, compiled for the host
# ---------------------------------------------------------------------------

CSRC = pathlib.Path(tk.__file__).resolve().parent.parent / "csrc"
HOST_HARNESS = r"""
#include <cmath>
#define HYTEG_DEVICE inline
#include "p1_const_stencil.cuh"
#include "p1_diag.cuh"
using namespace hyteg;
static ConstTables const_tables(int pitch, const int* dirs, const int* gmask) {
  ConstTables t;
  for (int s = 0; s < kConstDirs; ++s) {
    t.dx[s] = dirs[3 * s];
    t.dl[s] = dirs[3 * s + 1] * pitch + dirs[3 * s + 2];
  }
  for (int g = 0; g < kConstGroups; ++g) t.gmask[g] = gmask[g];
  return t;
}
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
// Kernel B2's thread blocks one after another: per cell the weight fold,
// per plane x every thread (warp, lane) of the block through the same walk
// (const_apply_plane). count: null, or one int per slot of the block.
extern "C" void const_apply(const float* src, const float* A, const float* E,
                            float* dst, int C, int N, int pitch,
                            const int* dirs, const int* gmask, int* count) {
  const ConstTables t = const_tables(pitch, dirs, gmask);
  float rows[kConstRows * kConstDirs];
  const long long cell = (long long)N * N * pitch;
  for (int c = 0; c < C; ++c) {
    const_fold_rows(A + c * kConstDirs * kConstShells,
                    E + c * kConstGroups * kConstShells * kConstDirs, t, rows,
                    0, 1);
    for (int x = 0; x < N; ++x)
      for (int tid = 0; tid < kPlaneWarps * 32; ++tid) {
        if (count)
          const_apply_plane(src + c * cell,
                            CountStore{CellStore{dst + c * cell}, count + c * cell}, x,
                            N, pitch, t, rows, tid >> 5, tid & 31,
                            kPlaneWarps);
        else
          const_apply_plane(src + c * cell, CellStore{dst + c * cell}, x, N,
                            pitch, t, rows, tid >> 5, tid & 31, kPlaneWarps);
      }
  }
}
// The two paths of the walk, each at every in-tet slot it can take: off
// the coordinate faces (x, y, z >= 1; the shell S = n on its own row)
// through const_apply_interior into interior[], every face slot through
// const_apply_point into boundary[]; other slots are left as they are.
extern "C" void const_paths(const float* src, const float* A, const float* E,
                            float* interior, float* boundary, int C, int N,
                            int pitch, const int* dirs, const int* gmask) {
  const ConstTables t = const_tables(pitch, dirs, gmask);
  float rows[kConstRows * kConstDirs];
  const int L = N * pitch, n = N - 1;
  const long long cell = (long long)N * L;
  for (int c = 0; c < C; ++c) {
    const_fold_rows(A + c * kConstDirs * kConstShells,
                    E + c * kConstGroups * kConstShells * kConstDirs, t, rows,
                    0, 1);
    const float* u = src + c * cell;
    for (int x = 0; x <= n; ++x)
      for (int y = 0; x + y <= n; ++y)
        for (int z = 0; x + y + z <= n; ++z) {
          const int q = x * L + y * pitch + z;
          if (x > 0 && y > 0 && z > 0)
            interior[c * cell + q] = const_apply_interior(
                u + q, rows + (x + y + z == n) * kConstDirs, t, L);
          else
            boundary[c * cell + q] =
                const_apply_point(u, x, y, z, N, pitch, t, rows);
        }
  }
}
// Thread tid of kernel B3's block for plane x, through the walk the
// kernel's mode takes (diag_plane, or diag_plane_coeff in the mean mode).
template <class Out>
static void diag_block(const float* coeff, const Out& out, int x, int N,
                       int pitch, const float* w, const float* cls, int mode,
                       int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  if (!coeff)
    diag_plane(out, x, N, pitch, cls, warp, lane, kPlaneWarps);
  else if (mode == 0)
    diag_plane_coeff<0>(coeff, out, x, N, pitch, w, warp, lane, kPlaneWarps);
  else if (mode == 1)
    diag_plane_coeff<1>(coeff, out, x, N, pitch, w, warp, lane, kPlaneWarps);
  else
    diag_plane_coeff<2>(coeff, out, x, N, pitch, w, warp, lane, kPlaneWarps);
}
// Kernel B3's launcher and thread blocks one after another: the table
// check, per cell the weight and class folds, per plane x every thread of
// the block. count: null, or one int per slot of the block. Returns the
// launcher's error (11, cudaErrorInvalidValue) for tables it refuses,
// else 0.
extern "C" int diag(const float* elm, const float* coeff, float* dst, int C,
                    int N, int pitch, int lumped, int mode, const int* offs,
                    const int* margins, int* count) {
  for (int t = 0; t < kClasses; ++t) {
    if (margins[t] != kDiagMargin[t]) return 11;
    for (int a = 0; a < kVerts; ++a)
      for (int d = 0; d < 3; ++d)
        if (offs[(t * kVerts + a) * 3 + d] != kDiagOff[t][a][d]) return 11;
  }
  float w[kClasses * kVerts], cls[kDiagRows];
  const long long cell = (long long)N * N * pitch;
  for (int c = 0; c < C; ++c) {
    diag_fold_weights(elm + c * kClasses * kVerts * kVerts, lumped, w, 0, 1);
    diag_fold_classes(w, cls, 0, 1);
    const float* co = coeff ? coeff + c * cell : nullptr;
    for (int x = 0; x < N; ++x)
      for (int tid = 0; tid < kPlaneWarps * 32; ++tid) {
        if (count)
          diag_block(co, CountStore{CellStore{dst + c * cell}, count + c * cell},
                     x, N, pitch, w, cls, mode, tid);
        else
          diag_block(co, CellStore{dst + c * cell}, x, N, pitch, w, cls, mode,
                     tid);
      }
  }
  return 0;
}
// The 16 folded class values of each cell (diag_fold_classes), row
// f * 2 + sh.
extern "C" void diag_classes(const float* elm, int C, int lumped,
                             float* cls) {
  float w[kClasses * kVerts];
  for (int c = 0; c < C; ++c) {
    diag_fold_weights(elm + c * kClasses * kVerts * kVerts, lumped, w, 0, 1);
    diag_fold_classes(w, cls + c * kDiagRows, 0, 1);
  }
}
// The header's compile-time class tables: (6, 4, 3) offsets, (6,) margins.
extern "C" void diag_tables(int* off, int* margin) {
  for (int t = 0; t < kClasses; ++t) {
    margin[t] = kDiagMargin[t];
    for (int a = 0; a < kVerts; ++a)
      for (int d = 0; d < 3; ++d) off[(t * kVerts + a) * 3 + d] = kDiagOff[t][a][d];
  }
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """The kernels' per-point functions (csrc/*.cuh) built with the host
    C++ compiler: the arithmetic that runs on the card, checked here
    against the plain versions without a GPU."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_kernels")
    (d / "harness.cpp").write_text(HOST_HARNESS)
    so = d / "libhost_kernels.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.const_apply.argtypes = [P, P, P, P, I, I, I, P, P, P]
    lib.const_paths.argtypes = [P, P, P, P, P, I, I, I, P, P]
    lib.diag.argtypes = [P, P, P, I, I, I, I, I, P, P, P]
    lib.diag_classes.argtypes = [P, I, I, P]
    lib.diag_tables.argtypes = [P, P]
    return lib


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,level,pitch",
                         [("tet", 3, None), ("cube1", 3, None),
                          ("cube1", 3, 17), ("cube2", 2, 9)])
def test_kernel_point_math_matches_plain(host_kernels, name, level, pitch,
                                         form):
    _, tsp, elm, x = _setup(name, level, pitch, form, seed=30 + level)
    et = interop.elmats_from_reference(elm, device="cpu")
    A = tk.stencil_weights(et, 3).contiguous()
    E = tk.face_weights_full(et, 3).contiguous()
    xt = interop.block_from_reference(x, device="cpu")
    ref = tk.p1_const_apply_torch(xt, A, level, 3, tsp.pitch, E=E)
    out = torch.empty_like(xt)
    dirs, gmask = tk._kernel_tables()
    host_kernels.const_apply(xt.data_ptr(), A.data_ptr(), E.data_ptr(),
                             out.data_ptr(), xt.shape[0], tsp.N, tsp.pitch,
                             dirs.ctypes.data, gmask.ctypes.data, None)
    _assert_close(out, ref, ref.abs().max().item(), 1e-5)
    assert not out[:, ~tsp.vertex_mask_t.bool()].any()

    offs, margins = tk3._kernel_tables()
    rng = np.random.default_rng(level)
    coeff = interop.block_from_reference(
        (rng.uniform(0.5, 2.0, tsp.block_shape)
         * tsp.vertex_mask[None]).astype(np.float32), device="cpu")
    for lumped in (False, True):
        for co, mode in [(None, "arithmetic")] + [(coeff, m) for m in MODES]:
            ref = tk3.p1_diagonal_local_torch(et, level, 3, tsp.pitch, lumped,
                                              co, mode)
            out = torch.empty_like(ref)
            assert host_kernels.diag(
                et.data_ptr(), None if co is None else co.data_ptr(),
                out.data_ptr(), et.shape[0], tsp.N, tsp.pitch, int(lumped),
                MODES.index(mode), offs.ctypes.data, margins.ctypes.data,
                None) == 0
            scale = max(ref.abs().max().item(), np.abs(elm).max())
            _assert_close(out, ref, scale, 1e-6)


def block_coords(N, pitch):
    """(x, y, z) of every slot of one cell's (N, N * pitch) block."""
    x = np.broadcast_to(np.arange(N)[:, None], (N, N * pitch))
    lane = np.broadcast_to(np.arange(N * pitch)[None, :], (N, N * pitch))
    return x, lane // pitch, lane % pitch


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,level,pitch",
                         [("tet", 3, None), ("cube1", 3, 17),
                          ("cube2", 2, 9), ("tet", 4, 33)])
def test_kernel_paths_match_plain_on_their_slots(host_kernels, name, level,
                                                 pitch, form):
    """The 3D kernel's unrolled, untested sum at every slot off the
    coordinate faces (the shell on its own row), and its boundary path at
    every face slot, each against the plain version there."""
    _, tsp, elm, x = _setup(name, level, pitch, form, seed=40 + level)
    et = interop.elmats_from_reference(elm, device="cpu")
    A = tk.stencil_weights(et, 3).contiguous()
    E = tk.face_weights_full(et, 3).contiguous()
    xt = interop.block_from_reference(x, device="cpu")
    ref = tk.p1_const_apply_torch(xt, A, level, 3, tsp.pitch, E=E)
    interior = torch.full_like(xt, float("nan"))
    boundary = torch.full_like(xt, float("nan"))
    dirs, gmask = tk._kernel_tables()
    host_kernels.const_paths(xt.data_ptr(), A.data_ptr(), E.data_ptr(),
                             interior.data_ptr(), boundary.data_ptr(),
                             xt.shape[0], tsp.N, tsp.pitch, dirs.ctypes.data,
                             gmask.ctypes.data)
    cx, cy, cz = block_coords(tsp.N, tsp.pitch)
    S = cx + cy + cz
    inside = (cz < tsp.N) & (S <= tsp.n)
    inner = inside & (cx > 0) & (cy > 0) & (cz > 0)
    scale = ref.abs().max().item()
    for got, mask in ((interior, inner), (boundary, inside & ~inner)):
        assert mask.any()
        m = torch.as_tensor(mask)
        d = (got[:, m] - ref[:, m]).abs().max().item()
        assert d <= 1e-5 * scale
        assert torch.isnan(got[:, ~m]).all()


@pytest.mark.parametrize("pitch_of", ["gmg", "own"])
@pytest.mark.parametrize("level", [2, 3, 4, 5, 6, 7])
def test_kernel_walk_writes_every_slot_once(host_kernels, level, pitch_of):
    """The 3D kernel's walk over its thread blocks (plane x, cell) at each
    level a P1 GMG stack launches, at the stack's shared pitch 129 and at
    the level's own pitch N: every slot of the block is written exactly
    once, and exactly 0 outside the tet and on padding lanes, whatever
    the source holds there."""
    N = (1 << level) + 1
    pitch = 129 if pitch_of == "gmg" else N
    rng = np.random.default_rng(level)
    src = torch.as_tensor(
        rng.standard_normal((1, N, N * pitch)).astype(np.float32))
    A = torch.as_tensor(rng.standard_normal((1, 15, 2)).astype(np.float32))
    E = torch.as_tensor(rng.standard_normal((1, 7, 2, 15)).astype(np.float32))
    dst = torch.full_like(src, float("nan"))
    count = torch.zeros(src.shape, dtype=torch.int32)
    dirs, gmask = tk._kernel_tables()
    host_kernels.const_apply(src.data_ptr(), A.data_ptr(), E.data_ptr(),
                             dst.data_ptr(), 1, N, pitch, dirs.ctypes.data,
                             gmask.ctypes.data, count.data_ptr())
    assert (count == 1).all()
    cx, cy, cz = block_coords(N, pitch)
    outside = torch.as_tensor((cz >= N) | (cx + cy + cz > N - 1))
    assert (dst[:, outside] == 0).all()
    assert torch.isfinite(dst).all() and dst[:, ~outside].ne(0).any()


@pytest.mark.parametrize("mode", [None] + list(MODES))
@pytest.mark.parametrize("lumped", [False, True])
@pytest.mark.parametrize("pitch_of", ["gmg", "own"])
@pytest.mark.parametrize("level", [1, 2, 3, 4, 5, 6])
def test_diag_walk_writes_every_slot_once(host_kernels, level, pitch_of,
                                          lumped, mode):
    """Kernel B3's walk over all its thread blocks (plane x, cell) through
    a counting store, at the GMG stack's shared pitch 129 and at the
    level's own pitch N (levels 5 and 6: rows longer than one chunk of 32
    lanes), without a coefficient and in each mean: every
    slot written exactly once, exactly 0 outside the tet and on padding
    lanes, every slot equal to the plain version; and the same result
    whatever the coefficient holds outside the tet (it is not read
    there)."""
    N = (1 << level) + 1
    pitch = 129 if pitch_of == "gmg" else N
    rng = np.random.default_rng(200 + level)
    elm = torch.as_tensor(
        rng.standard_normal((2, 6, 4, 4)).astype(np.float32))
    cx, cy, cz = block_coords(N, pitch)
    inside = torch.as_tensor((cz < N) & (cx + cy + cz <= N - 1))
    co = None
    if mode is not None:
        co = torch.as_tensor(
            rng.uniform(0.5, 2.0, (2, N, N * pitch)).astype(np.float32))
        co = co * inside
    avg = mode or "arithmetic"
    ref = tk3.p1_diagonal_local_torch(elm, level, 3, pitch, lumped, co, avg)
    offs, margins = tk3._kernel_tables()
    outs = []
    for c in ([co, co.masked_fill(~inside, float("nan"))] if co is not None
              else [None]):
        out = torch.full_like(ref, float("nan"))
        count = torch.zeros(ref.shape, dtype=torch.int32)
        assert host_kernels.diag(
            elm.data_ptr(), None if c is None else c.data_ptr(),
            out.data_ptr(), 2, N, pitch, int(lumped), MODES.index(avg),
            offs.ctypes.data, margins.ctypes.data, count.data_ptr()) == 0
        assert (count == 1).all()
        assert (out[:, ~inside] == 0).all()
        outs.append(out)
    _assert_close(outs[0], ref, ref.abs().max().item(), 1e-6)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


def test_diag_launcher_refuses_other_tables(host_kernels):
    """The B3 launcher (mirrored by the host harness) takes only the class
    tables its walk was compiled with."""
    offs, margins = tk3._kernel_tables()
    elm = torch.zeros((1, 6, 4, 4))
    out = torch.empty((1, 3, 9))
    for o, m in ((offs[::-1].copy(), margins), (offs, margins + 1)):
        assert host_kernels.diag(elm.data_ptr(), None, out.data_ptr(), 1, 3,
                                 3, 0, 0, o.ctypes.data, m.ctypes.data,
                                 None) == 11


@pytest.mark.parametrize("lumped", [False, True])
def test_diag_class_rule_matches_jax(host_kernels, lumped):
    """The rule kernel B3 stores by: from the JAX package's micro tables,
    margin[t] - |off[t, a]| is 0 or 1 and every offset 0 or 1, so which
    element bases are valid at an in-tet slot depends only on its face set
    f and [S == n]; the header's compile-time tables are the JAX ones; and
    the 16 folded class values equal the JAX plain diagonal at one slot of
    each of the 15 classes that occur (level 3, random element
    matrices)."""
    from hyteg_tpu.indexing import micro as jmicro

    offs, margins = jmicro.offsets(3), jmicro.base_margin(3)
    gap = margins[:, None] - offs.sum(-1)
    assert np.isin(gap, (0, 1)).all() and np.isin(offs, (0, 1)).all()
    off_h = np.zeros((6, 4, 3), np.int32)
    margin_h = np.zeros(6, np.int32)
    host_kernels.diag_tables(off_h.ctypes.data, margin_h.ctypes.data)
    assert (off_h == offs).all() and (margin_h == margins).all()

    level, C = 3, 2
    n = 1 << level
    N = n + 1
    rng = np.random.default_rng(7 + lumped)
    elm = rng.standard_normal((C, 6, 4, 4)).astype(np.float32)
    args = (jnp.asarray(elm), level, 3, (C, N, N * N), N, None)
    if lumped:
        ref = jop._p1_diag_local(*args, lambda e, t, a: e[:, t, a, :].sum(-1),
                                 "arithmetic")
    else:
        ref = jop.p1_diagonal_local(*args)
    ref = np.asarray(ref).reshape(C, N, N, N)
    cls = np.zeros((C, 16), np.float32)
    host_kernels.diag_classes(elm.ctypes.data, C, int(lumped), cls.ctypes.data)
    seen = {}
    for x in range(N):
        for y in range(N - x):
            for z in range(N - x - y):
                f = (x == 0) | ((y == 0) << 1) | ((z == 0) << 2)
                k = 2 * f + (x + y + z == n)
                # the rule itself: the valid (t, a) at this slot
                valid = tuple(bool((np.array((x, y, z)) >= offs[t, a]).all()
                                   and x + y + z - offs[t, a].sum()
                                   <= n - margins[t])
                              for t in range(6) for a in range(4))
                assert seen.setdefault(k, (x, y, z, valid))[3] == valid
    assert sorted(seen) == [k for k in range(16) if k != 15]
    scale = max(np.abs(ref).max(), np.abs(elm).max())
    for k, (x, y, z, _) in seen.items():
        assert np.abs(cls[:, k] - ref[:, x, y, z]).max() <= 1e-6 * scale
