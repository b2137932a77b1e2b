"""Kernel B4 of the PyTorch port, the general elementwise P1 apply with a
nodal coefficient, in its plain version, and the variable-coefficient
operator built on it, against the JAX package on identical inputs.

The JAX side runs ``p1_apply_local`` in both of its forms: the default
``lax.scan`` over classes with cyclic rolls, and ``unroll=True``, the
zero-filled shifts that ``p1_apply_local_torch`` ports. The CUDA kernel's
per-point function (csrc/p1_apply.cuh) is compiled with the host C++
compiler and held against the plain version.

Tolerance: 1e-5 * max|y| (f32 sums of 96 terms, and the coefficient
means, taken in another order).
"""

import ctypes
import functools
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.functions.p1 import P1Space as JSpace
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import forms as jforms
from hyteg_tpu.operators import p1_elementwise as jop
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.kernels import p1_const_stencil as tk2
from hyteg_tpu_torch.kernels import p1_stencil as tk
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.operators import forms as tforms
from hyteg_tpu_torch.operators.averaging import MODES
from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
from hyteg_tpu_torch.primitives.storage import CellStorage

from tests.test_torch_const_stencil import CSRC, FORMS, _assert_close, _mesh

torch.set_num_threads(1)

CASES = [("tet", 2, None), ("cube1", 2, 9), ("cube1", 3, None)]


@functools.lru_cache(maxsize=None)
def _spaces(name, level, pitch):
    return (JSpace(JStorage(_mesh(jmi, name)), level, pitch=pitch),
            P1Space(CellStorage(_mesh(tmi, name)), level, device="cpu",
                    pitch=pitch))


def _setup(name, level, pitch, form="laplace", seed=0):
    """Spaces, element matrices, a random block and a coefficient
    k = 1 + x + 0.5 y (the JAX package's tests/test_operator.py) times a
    seeded random factor in [0.5, 1.5), both masked to the tet."""
    jsp, tsp = _spaces(name, level, pitch)
    elm = np.asarray(jop.compute_elmats(
        jsp, FORMS[form][0], jnp.asarray(jsp.cell_vertices(0))))
    rng = np.random.default_rng(seed)
    mask = jsp.vertex_mask[None]
    x = (rng.standard_normal(jsp.block_shape) * mask).astype(np.float32)
    p = np.asarray(jsp.coords(0))
    k = (1.0 + p[..., 0] + 0.5 * p[..., 1]) * rng.uniform(0.5, 1.5,
                                                           jsp.block_shape)
    return jsp, tsp, elm, x, (k * mask).astype(np.float32)


@pytest.mark.parametrize("mode", (None,) + MODES)
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,level,pitch", CASES)
def test_plain_apply_matches_jax(name, level, pitch, form, mode):
    jsp, tsp, elm, x, k = _setup(name, level, pitch, form, seed=level)
    co = None if mode is None else k
    jc = None if co is None else jnp.asarray(co)
    got = tk.p1_apply_local(
        interop.block_from_reference(x, device="cpu"),
        interop.elmats_from_reference(elm, device="cpu"),
        level, 3, tsp.pitch,
        None if co is None else interop.block_from_reference(co, device="cpu"),
        mode or "arithmetic")
    for unroll in (False, True):
        ref = np.asarray(jop.p1_apply_local(
            jnp.asarray(x), jnp.asarray(elm), level, 3, jsp.pitch, jc,
            mode or "arithmetic", unroll=unroll))
        _assert_close(got, ref, np.abs(ref).max(), 1e-5)
    assert not got[:, ~tsp.vertex_mask_t.bool()].any()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,level,pitch", CASES)
def test_operator_with_coefficient_matches_jax(name, level, pitch, mode):
    jsp, tsp, elm, x, k = _setup(name, level, pitch, seed=10 + level)
    x = np.asarray(jsp.exchange_rep(jnp.asarray(x)))
    jo = jop.P1ElementwiseOperator(jsp, jforms.laplace_form,
                                   elmats=jnp.asarray(elm), coeff_avg=mode)
    to = P1ElementwiseOperator(tsp, tforms.laplace_form,
                               elmats=interop.elmats_from_reference(elm, device="cpu"),
                               coeff_avg=mode)
    kt = interop.block_from_reference(k, device="cpu")
    ref = np.asarray(jo.apply_raw(jnp.asarray(x), coeff=jnp.asarray(k)))
    _assert_close(to.apply_raw(interop.block_from_reference(x, device="cpu"),
                               coeff=kt),
                  ref, np.abs(ref).max(), 1e-5)
    ref = np.asarray(jo.inverse_diagonal(coeff=jnp.asarray(k)))
    _assert_close(to.inverse_diagonal(coeff=kt), ref, np.abs(ref).max(), 1e-6)


def test_unit_coefficient_equals_constant_stencil():
    """B4 with k = 1 is B2's operator (plain versions)."""
    jsp, tsp, elm, x, _ = _setup("cube1", 3, 17, seed=4)
    et = interop.elmats_from_reference(elm, device="cpu")
    xt = interop.block_from_reference(x, device="cpu")
    ones = tsp.vertex_mask_t.expand(tsp.block_shape).contiguous()
    got = tk.p1_apply_local(xt, et, 3, 3, tsp.pitch, ones)
    ref = tk2.p1_const_apply(xt, tk2.stencil_weights(et, 3),
                             tk2.face_weights_full(et, 3), 3, 3, tsp.pitch)
    _assert_close(got, ref, ref.abs().max().item(), 1e-5)


def test_wrapper_rejects_non_cpu_non_cuda_tensors():
    _, tsp, elm, _, _ = _setup("cube1", 2, None)
    et = interop.elmats_from_reference(elm, device="cpu").to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.p1_apply_local(torch.empty(tsp.block_shape, device="meta"), et, 2,
                          3, tsp.pitch)
    with pytest.raises(ValueError, match="averaging mode"):
        tk.p1_apply_local(torch.empty(tsp.block_shape, device="meta"), et, 2,
                          3, tsp.pitch, coeff_avg="median")


# ---------------------------------------------------------------------------
# the CUDA kernel's per-point math, compiled for the host
# ---------------------------------------------------------------------------

HOST_HARNESS = r"""
#include <cmath>
#define HYTEG_DEVICE inline
#include "p1_apply.cuh"
using namespace hyteg;
// Runs the per-point function kernel B4 runs, one slot after another.
extern "C" void p1_apply(const float* src, const float* coeff,
                         const float* elmats, float* dst, int C, int N,
                         int pitch, int mode) {
  const int L = N * pitch;
  const long long cell = (long long)N * L;
  const int elm = kApplyClasses * kApplyVerts * kApplyVerts;
  for (int c = 0; c < C; ++c)
    for (long long q = 0; q < cell; ++q)
      dst[c * cell + q] = p1_apply_point(
          src + c * cell, coeff ? coeff + c * cell : nullptr, (int)(q / L),
          (int)(q % L), N, pitch, elmats + c * elm, mode);
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_p1_apply")
    (d / "harness.cpp").write_text(HOST_HARNESS)
    so = d / "libhost_p1_apply.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.p1_apply.argtypes = [P, P, P, P, I, I, I, I]
    return lib


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name,level,pitch", CASES + [("cube2", 2, 9)])
def test_kernel_point_math_matches_plain(host_kernel, name, level, pitch,
                                         form):
    _, tsp, elm, x, k = _setup(name, level, pitch, form, seed=20 + level)
    et = interop.elmats_from_reference(elm, device="cpu")
    xt = interop.block_from_reference(x, device="cpu")
    kt = interop.block_from_reference(k, device="cpu")
    for co, mode in [(None, "arithmetic")] + [(kt, m) for m in MODES]:
        ref = tk.p1_apply_local_torch(xt, et, level, 3, tsp.pitch, co, mode)
        out = torch.empty_like(xt)
        host_kernel.p1_apply(xt.data_ptr(),
                             None if co is None else co.data_ptr(),
                             et.data_ptr(), out.data_ptr(), xt.shape[0],
                             tsp.N, tsp.pitch, MODES.index(mode))
        _assert_close(out, ref, ref.abs().max().item(), 1e-5)
