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
            P1Space(CellStorage(_mesh(tmi, name)), level, pitch=pitch))


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
    et = interop.elmats_from_reference(elm)
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
    et = interop.elmats_from_reference(elm)
    got = tk.p1_const_apply(interop.block_from_reference(x),
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
    et = interop.elmats_from_reference(elm)
    got = tk.p1_const_apply_torch(interop.block_from_reference(x),
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
        interop.elmats_from_reference(elm), 3, 3, tsp.pitch, lumped,
        None if coeff is None else interop.block_from_reference(coeff),
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
                               elmats=interop.elmats_from_reference(elm))
    xt = interop.block_from_reference(x)
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
    _, tsp, _, x = _setup("cube1", 2)
    op = P1ElementwiseOperator(tsp, tforms.laplace_form)
    xt = interop.block_from_reference(x)
    with pytest.raises(NotImplementedError, match="B4"):
        op.apply_raw(xt, coeff=torch.ones_like(xt))


def test_wrappers_reject_non_cpu_non_cuda_tensors():
    _, tsp, elm, x = _setup("cube1", 1)
    et = interop.elmats_from_reference(elm).to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.p1_const_apply(torch.empty(tsp.block_shape, device="meta"),
                          tk.stencil_weights(et, 3),
                          tk.face_weights_full(et, 3), 1, 3, tsp.pitch)
    with pytest.raises(ValueError, match="CUDA"):
        tk3.p1_diagonal_local(et, 1, 3, tsp.pitch)


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
// Runs the per-point functions the kernels run, one point after another.
extern "C" void const_apply(const float* src, const float* A, const float* E,
                            float* dst, int C, int N, int pitch,
                            const int* dirs, const int* gmask) {
  ConstTables t;
  for (int s = 0; s < kConstDirs; ++s) {
    t.dx[s] = dirs[3 * s];
    t.dl[s] = dirs[3 * s + 1] * pitch + dirs[3 * s + 2];
  }
  for (int g = 0; g < kConstGroups; ++g) t.gmask[g] = gmask[g];
  float w_in[kConstDirs], w_sh[kConstDirs];
  float e_in[kConstGroups * kConstDirs], e_sh[kConstGroups * kConstDirs];
  const int L = N * pitch;
  const long long cell = (long long)N * L;
  for (int c = 0; c < C; ++c) {
    const_fold_weights(A + c * kConstDirs * kConstShells,
                       E + c * kConstGroups * kConstShells * kConstDirs,
                       w_in, w_sh, e_in, e_sh, 0, 1);
    for (long long q = 0; q < cell; ++q)
      dst[c * cell + q] = const_apply_point(src + c * cell, (int)(q / L),
                                            (int)(q % L), N, pitch, t, w_in,
                                            w_sh, e_in, e_sh);
  }
}
extern "C" void diag(const float* elm, const float* coeff, float* dst, int C,
                     int N, int pitch, int lumped, int mode, const int* offs,
                     const int* margins) {
  DiagTables t;
  for (int c = 0; c < kClasses; ++c) {
    t.margin[c] = margins[c];
    for (int a = 0; a < kVerts; ++a)
      for (int d = 0; d < 3; ++d) t.off[c][a][d] = offs[(c * 4 + a) * 3 + d];
  }
  float w[kClasses * kVerts];
  const int L = N * pitch;
  const long long cell = (long long)N * L;
  for (int c = 0; c < C; ++c) {
    diag_fold_weights(elm + c * kClasses * kVerts * kVerts, lumped, w, 0, 1);
    for (long long q = 0; q < cell; ++q)
      dst[c * cell + q] = diag_point(coeff ? coeff + c * cell : nullptr,
                                     (int)(q / L), (int)(q % L), N, pitch, t,
                                     w, mode);
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
    lib.const_apply.argtypes = [P, P, P, P, I, I, I, P, P]
    lib.diag.argtypes = [P, P, P, I, I, I, I, I, P, P]
    return lib


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,level,pitch",
                         [("tet", 3, None), ("cube1", 3, None),
                          ("cube1", 3, 17), ("cube2", 2, 9)])
def test_kernel_point_math_matches_plain(host_kernels, name, level, pitch,
                                         form):
    _, tsp, elm, x = _setup(name, level, pitch, form, seed=30 + level)
    et = interop.elmats_from_reference(elm)
    A = tk.stencil_weights(et, 3).contiguous()
    E = tk.face_weights_full(et, 3).contiguous()
    xt = interop.block_from_reference(x)
    ref = tk.p1_const_apply_torch(xt, A, level, 3, tsp.pitch, E=E)
    out = torch.empty_like(xt)
    dirs, gmask = tk._kernel_tables()
    host_kernels.const_apply(xt.data_ptr(), A.data_ptr(), E.data_ptr(),
                             out.data_ptr(), xt.shape[0], tsp.N, tsp.pitch,
                             dirs.ctypes.data, gmask.ctypes.data)
    _assert_close(out, ref, ref.abs().max().item(), 1e-5)
    assert not out[:, ~tsp.vertex_mask_t.bool()].any()

    offs, margins = tk3._kernel_tables()
    rng = np.random.default_rng(level)
    coeff = interop.block_from_reference(
        (rng.uniform(0.5, 2.0, tsp.block_shape)
         * tsp.vertex_mask[None]).astype(np.float32))
    for lumped in (False, True):
        for co, mode in [(None, "arithmetic")] + [(coeff, m) for m in MODES]:
            ref = tk3.p1_diagonal_local_torch(et, level, 3, tsp.pitch, lumped,
                                              co, mode)
            out = torch.empty_like(ref)
            host_kernels.diag(et.data_ptr(),
                              None if co is None else co.data_ptr(),
                              out.data_ptr(), et.shape[0], tsp.N, tsp.pitch,
                              int(lumped), MODES.index(mode),
                              offs.ctypes.data, margins.ctypes.data)
            scale = max(ref.abs().max().item(), np.abs(elm).max())
            _assert_close(out, ref, scale, 1e-6)
