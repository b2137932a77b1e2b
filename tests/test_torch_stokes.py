"""The P2-P1 Taylor-Hood Stokes composite of the PyTorch port against the
JAX package on identical inputs: the divergence element matrices, the
divergence and gradient applies, the block apply, the pressure mean
projection, the block-diagonal preconditioner (kernel B3's plain version
for the lumped pressure mass) and the element matrices carried over with
interop. tests/test_torch_stokes_krylov.py holds MINRES and the Stokes PCG,
tests/test_torch_stokes_epsilon.py the epsilon operator with a variable
viscosity, tests/test_torch_stokes_gmg.py the Uzawa smoother and the GMG
cycle, tests/test_torch_stokes_solvers.py GMRES, GKB and the sparse
assembly; they share this file's helpers.

Meshes: mesh_rectangle 2 x 2 (8 faces) and mesh_unit_cube(1) (6 tets), P2
levels 1 and 2. Inputs are made with numpy from a seed, made consistent
across interface replicas, and carried over with hyteg_tpu_torch.interop.
The JAX side runs as its own CPU tests run it (plain XLA: no Pallas kernel
is reached on the CPU).

Tolerances (float32; sums taken in another order): element matrices 1e-6
of their largest entry; applies, projections, preconditioner 1e-5 *
max|y|; dots 1e-5 relative; the adjoint identity 1e-5 relative.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.composites.stokes import P2P1TaylorHoodStokes as JStokes
from hyteg_tpu.composites.stokes import TaylorHoodVec as JVec
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.composites.stokes import P2P1TaylorHoodStokes, TaylorHoodVec
from hyteg_tpu_torch.core.types import DoFType, FLAG_INNER
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.operators.mixed import compute_divergence_elmats
from hyteg_tpu_torch.primitives.storage import CellStorage

torch.set_num_threads(1)

MESHES = {"rect": lambda m: m.mesh_rectangle((0, 0), (1, 1), 2, 2),
          "cube": lambda m: m.mesh_unit_cube(1)}
CASES = [("rect", 1), ("rect", 2), ("cube", 1), ("cube", 2)]
CASE_IDS = [f"{m}-{lv}" for m, lv in CASES]


@functools.lru_cache(maxsize=None)
def storages(name):
    return (JStorage(MESHES[name](jmi), num_shards=1),
            CellStorage(MESHES[name](tmi)))


@functools.lru_cache(maxsize=None)
def composites(name, level, **kw):
    js, ts = storages(name)
    return JStokes(js, level, **kw), P2P1TaylorHoodStokes(ts, level,
                                                          device="cpu", **kw)


def assert_close(got, want, rtol, what=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rtol * scale, (what, err, scale)


def assert_vec_close(tx: TaylorHoodVec, jx: JVec, rtol, what=""):
    vel, pre = interop.taylor_hood_to_numpy(tx)
    for d, (v, jv) in enumerate(zip(vel, jx.vel)):
        assert_close(v, jv, rtol, f"{what} vel[{d}]")
    assert_close(pre, jx.pre, rtol, f"{what} pre")


def rand_vec(st: P2P1TaylorHoodStokes, seed: int) -> TaylorHoodVec:
    """A seeded random Taylor-Hood vector: replicas consistent, velocity
    0 on Dirichlet rows (test_stokes.py's rand_vec)."""
    rng = np.random.default_rng(seed)
    vsp, psp = st.vel_space, st.pre_space
    vel = rng.standard_normal((st.dim,) + tuple(vsp.block_shape))
    pre = rng.standard_normal(psp.block_shape)
    x = interop.taylor_hood_from_reference(
        vel * vsp.vertex_mask[None], pre * psp.vertex_mask[None], device="cpu")
    vel = torch.stack([vsp.exchange_rep(v, st._vel_sd) for v in x.vel])
    return TaylorHoodVec(st._restore_vel_(vel, None, FLAG_INNER),
                         psp.exchange_rep(x.pre, st._pre_sd))


def to_jax(x: TaylorHoodVec) -> JVec:
    vel, pre = interop.taylor_hood_to_numpy(x)
    return JVec(tuple(jnp.asarray(v) for v in vel), jnp.asarray(pre))


# -- the divergence / gradient pair ----------------------------------------


@pytest.mark.parametrize("name,level", CASES, ids=CASE_IDS)
def test_divergence_elmats(name, level):
    js, ts = composites(name, level)
    got = compute_divergence_elmats(ts.vel_space)
    assert got.shape == ts.B.elmats.shape
    assert_close(got, js.B.elmats, 1e-6, "divergence elmats")
    assert_close(ts.B.elmats, js.B.elmats, 1e-6, "composite's elmats")


@pytest.mark.parametrize("name,level", CASES, ids=CASE_IDS)
def test_div_and_gradient(name, level):
    js, ts = composites(name, level)
    x = rand_vec(ts, 1)
    jx = to_jax(x)
    div = ts.B.apply_div_local(x.vel.unbind(0))
    assert_close(div, js.B.apply_div_local(jx.vel), 1e-5, "div")
    grad = ts.B.apply_gradient_local(x.pre)
    for d in range(ts.dim):
        jg = js.B.apply_gradient_component_local(jx.pre, d)
        assert_close(grad[d], jg, 1e-5, f"grad[{d}]")
        assert_close(ts.B.apply_gradient_component_local(x.pre, d), jg, 1e-5,
                     f"grad component {d}")
        assert_close(ts.B.apply_component_local(x.vel[d], d),
                     js.B.apply_component_local(jx.vel[d], d), 1e-5,
                     f"div component {d}")


@pytest.mark.parametrize("name,level", CASES, ids=CASE_IDS)
def test_gradient_is_adjoint_of_divergence(name, level):
    """<q, B u> = <B^T q, u> over global DoFs, after the exchanges."""
    _, ts = composites(name, level)
    x, y = rand_vec(ts, 2), rand_vec(ts, 3)
    u, q = x.vel, y.pre
    bu = ts.pre_space.exchange_add(ts.B.apply_div_local(u.unbind(0)),
                                   ts._pre_sd)
    btq = ts._exchange_vel_(ts.B.apply_gradient_local(q))
    lhs = float(ts.pre_space.dot(q, bu, DoFType.ALL, ts._pre_sd))
    rhs = sum(float(ts.vel_space.dot(btq[d], u[d], DoFType.ALL, ts._vel_sd))
              for d in range(ts.dim))
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), abs(rhs)), (lhs, rhs)


# -- the block operator ------------------------------------------------------


@pytest.mark.parametrize("name,level", CASES, ids=CASE_IDS)
def test_apply_raw_and_inner(name, level):
    js, ts = composites(name, level)
    x = rand_vec(ts, 4)
    jx = to_jax(x)
    assert_vec_close(ts.apply_raw(x), js.apply_raw(jx), 1e-5, "apply_raw")
    assert_vec_close(ts.apply_inner(x), js.apply_inner(jx), 1e-5,
                     "apply_inner")
    k = ts.apply_K(x.vel)
    for d, jk in enumerate(js.apply_K(jx.vel)):
        assert_close(k[d], jk, 1e-5, f"apply_K[{d}]")


@pytest.mark.parametrize("name,level", CASES, ids=CASE_IDS)
def test_dot_and_project_mean(name, level):
    js, ts = composites(name, level)
    a, b = rand_vec(ts, 5), rand_vec(ts, 6)
    got, want = float(ts.dot(a, b)), float(js.dot(to_jax(a), to_jax(b)))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    assert math.isclose(float(ts.norm(a)), float(js.norm(to_jax(a))),
                        rel_tol=1e-5)
    p = a.pre + 0.75 * ts.pre_space.vertex_mask_t  # a mean to remove
    pm = ts.project_mean(p)
    assert_close(pm, js.project_mean(jnp.asarray(p.numpy())), 1e-5,
                 "project_mean")
    assert abs(float(ts.pre_space.dof_sum(pm))) <= 1e-5 * float(
        pm.abs().sum())


@pytest.mark.parametrize("name,level", CASES, ids=CASE_IDS)
def test_block_diag_preconditioner(name, level):
    js, ts = composites(name, level)
    r = rand_vec(ts, 7)
    assert_vec_close(ts.block_diag_preconditioner()(r),
                     js.block_diag_preconditioner()(to_jax(r)), 1e-5,
                     "preconditioner")


def test_taylor_hood_vec_arithmetic():
    _, ts = composites("rect", 1)
    a, b = rand_vec(ts, 8), rand_vec(ts, 9)
    s = torch.tensor(-1.5)
    for got, vel, pre in ((a + b, a.vel + b.vel, a.pre + b.pre),
                          (a - b, a.vel - b.vel, a.pre - b.pre),
                          (2.0 * a, 2.0 * a.vel, 2.0 * a.pre),
                          (a * 2.0, 2.0 * a.vel, 2.0 * a.pre),
                          (s * a, s * a.vel, s * a.pre),
                          (a * s, s * a.vel, s * a.pre)):
        assert isinstance(got, TaylorHoodVec)
        assert torch.equal(got.vel, vel) and torch.equal(got.pre, pre)
    z = a.zeros_like()
    assert not z.vel.any() and not z.pre.any()
    assert z.vel.shape == a.vel.shape and z.pre.shape == a.pre.shape


def test_composite_refuses_blending():
    """Blended geometry is ported (tests/test_torch_blended_stokes.py
    holds it against the JAX package): the composite refuses only a gmap
    that is no geometry map, and builds the blended operators for one."""
    from hyteg_tpu_torch.geometry.maps import RadialMap
    from hyteg_tpu_torch.operators.p2_blended_stokes import (
        P2BlendedEpsilonOperator)

    _, ts = storages("rect")
    with pytest.raises(TypeError):
        P2P1TaylorHoodStokes(ts, 1, device="cpu", gmap=object())
    st = P2P1TaylorHoodStokes(ts, 1, device="cpu", gmap=RadialMap())
    assert isinstance(st.K_eps, P2BlendedEpsilonOperator)


def test_stokes_elmats_carried_over():
    """The composite built from the JAX composite's element matrices
    (interop) applies as the JAX composite does."""
    js, _ = composites("cube", 1)
    _, tstor = storages("cube")
    from hyteg_tpu.operators import forms as jforms
    from hyteg_tpu.operators.p1_elementwise import P1ElementwiseOperator

    jmass = P1ElementwiseOperator.from_shard_data(js.pre_space,
                                                  jforms.mass_form, js._pre_sd)
    elm = interop.stokes_elmats_from_reference(
        {"laplace": js.K.elmats, "div": js.B.elmats,
         "p1_mass": jmass.elmats}, device="cpu")
    ts = P2P1TaylorHoodStokes(tstor, 1, device="cpu", elmats=elm)
    for k, want in (("laplace", js.K.elmats), ("div", js.B.elmats)):
        got = ts.K.elmats if k == "laplace" else ts.B.elmats
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(ts.pmass.elmats.numpy(), np.asarray(jmass.elmats))
    x = rand_vec(ts, 15)
    assert_vec_close(ts.apply_inner(x), js.apply_inner(to_jax(x)), 1e-5,
                     "apply_inner")
    with pytest.raises(ValueError):
        interop.stokes_elmats_from_reference({"lap": js.K.elmats},
                                             device="cpu")
