"""The P2 vector epsilon operator of the PyTorch port
(hyteg_tpu_torch/operators/p2_epsilon.py) against the JAX package's, and
the Taylor-Hood composite's epsilon branch (a nodal viscosity field, the
epsilon form at constant viscosity, the full-viscous term) and the Stokes
GMG stack with a viscosity, on
mesh_rectangle 2 x 2 and mesh_unit_cube(1) at P2 levels 1 and 2, with the
viscosity 1 + 2x + 0.5y^2 of tests/test_epsilon.py.

Tolerances (float32): element matrices 1e-6 of their largest entry;
applies and an Uzawa sweep 1e-5 * max|y|; inverse diagonals and the
interpolated viscosity 1e-6 * max.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from hyteg_tpu.composites.stokes import P2P1TaylorHoodStokes as JStokes
from hyteg_tpu.operators import p2_epsilon as jeps
from hyteg_tpu.solvers import uzawa as juzawa
from hyteg_tpu_torch.composites.stokes import P2P1TaylorHoodStokes
from hyteg_tpu_torch.core.types import DoFType
from hyteg_tpu_torch.operators import p2_epsilon as teps
from hyteg_tpu_torch.solvers.uzawa import make_stokes_gmg

from tests.test_torch_stokes import (CASES, assert_close, assert_vec_close,
                                     composites, rand_vec, storages, to_jax)

torch.set_num_threads(1)

SOLVER_CASES = [("rect", 2), ("cube", 1)]
SOLVER_IDS = [f"{m}-{lv}" for m, lv in SOLVER_CASES]


MU = lambda p: 1.0 + 2.0 * p[..., 0] + 0.5 * p[..., 1] ** 2  # test_epsilon.py
EPS_CASES = [(m, lv, full) for m, lv in CASES for full in (False, True)]
EPS_IDS = [f"{m}-{lv}-{'full' if f else 'sym'}" for m, lv, f in EPS_CASES]


@functools.lru_cache(maxsize=None)
def eps_ops(name, level, full):
    js, ts = composites(name, level)
    jop = jeps.P2VectorEpsilonOperator(js.vel_space, full=full)
    top = teps.P2VectorEpsilonOperator(ts.vel_space, full=full)
    return jop, top


@pytest.mark.parametrize("name,level,full", EPS_CASES, ids=EPS_IDS)
def test_epsilon_elmats(name, level, full):
    jop, top = eps_ops(name, level, full)
    assert_close(top.elmats, jop.elmats, 1e-6, "epsilon elmats")


@pytest.mark.parametrize("name,level,full", EPS_CASES, ids=EPS_IDS)
def test_epsilon_apply_and_diagonal(name, level, full):
    js, ts = composites(name, level)
    jop, top = eps_ops(name, level, full)
    mu = ts.vel_space.interpolate(MU, ts.vel_space.zeros(), DoFType.ALL,
                                  ts._vel_sd)
    jmu = jnp.asarray(mu.numpy())
    x = rand_vec(ts, 13)
    jx = to_jax(x)
    for coeff, jcoeff in ((None, None), (mu, jmu)):
        ys = top.apply_raw(x.vel, coeff=coeff, sd=ts._vel_sd)
        jys = jop.apply_raw(jx.vel, coeff=jcoeff, sd=js._vel_sd)
        inv = top.inverse_diagonal(coeff=coeff, sd=ts._vel_sd)
        jinv = jop.inverse_diagonal(coeff=jcoeff, sd=js._vel_sd)
        for d in range(ts.dim):
            assert_close(ys[d], jys[d], 1e-5, f"epsilon apply[{d}]")
            assert_close(inv[d], jinv[d], 1e-6, f"epsilon inverse diag[{d}]")
    yi = top.apply_inner(x.vel, ts._vel_sd, coeff=mu)
    jyi = jop.apply_inner(jx.vel, js._vel_sd, coeff=jmu)
    for d in range(ts.dim):
        assert_close(yi[d], jyi[d], 1e-5, f"epsilon apply_inner[{d}]")


@pytest.mark.parametrize("kw", [dict(mu_field=MU), dict(epsilon=True),
                                dict(full_viscous=True, mu_field=MU)],
                         ids=["mu_field", "epsilon", "full_viscous"])
@pytest.mark.parametrize("name,level", SOLVER_CASES, ids=SOLVER_IDS)
def test_composite_epsilon_branch(name, level, kw):
    """The composite with the epsilon viscous block: block apply, the
    block-diagonal preconditioner and K with a per-call viscosity."""
    js_, ts_ = storages(name)
    jmu = kw.get("mu_field")
    js = JStokes(js_, level, viscosity=2.0,
                 **{k: v for k, v in kw.items() if k != "mu_field"},
                 mu_field=None if jmu is None else (
                     lambda p: 1.0 + 2.0 * p[..., 0] + 0.5 * p[..., 1] ** 2))
    ts = P2P1TaylorHoodStokes(ts_, level, viscosity=2.0, device="cpu", **kw)
    assert ts.use_epsilon and ts.K is None
    x = rand_vec(ts, 14)
    jx = to_jax(x)
    assert_vec_close(ts.apply_raw(x), js.apply_raw(jx), 1e-5, "apply_raw")
    assert_vec_close(ts.block_diag_preconditioner()(x),
                     js.block_diag_preconditioner()(jx), 1e-5,
                     "preconditioner")
    mu2 = 0.5 + ts.vel_space.coords()[..., 0]
    ks = ts.apply_K(x.vel, mu=mu2)
    jks = js.apply_K(jx.vel, mu=jnp.asarray(mu2.numpy()))
    for d in range(ts.dim):
        assert_close(ks[d], jks[d], 1e-5, f"apply_K(mu)[{d}]")




def test_make_stokes_gmg_with_viscosity():
    """make_stokes_gmg(mu=...): every level's composite runs the epsilon
    block on the interpolated viscosity (1e-6 of its largest value), and
    one Uzawa sweep at level 2 (2D) equals the JAX package's with the same
    eig_max (1e-5 * max)."""
    js, ts = storages("rect")
    kw = dict(mu=MU, eigs={1: 2.0, 2: 2.0}, omega_p=0.4)
    stack = make_stokes_gmg(ts, 1, 2, device="cpu", **kw)
    jstokes, jgmg = juzawa.make_stokes_gmg(js, 1, 2, **kw)
    for lv, st in stack.stokes.items():
        assert st.use_epsilon and st.K is None
        assert_close(st.mu_field, jstokes[lv].mu_field, 1e-6, "mu field")
    st = stack.stokes[2]
    x, b = rand_vec(st, 40), st.apply_inner(rand_vec(st, 41))
    jy = jax.jit(jgmg.levels[2].smooth)(to_jax(x), to_jax(b))
    assert_vec_close(stack.smoothers[2](x, b), jy, 1e-5, "Uzawa sweep")
