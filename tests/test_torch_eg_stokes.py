"""EG-P0 Stokes of the PyTorch port (operators/eg_stokes.py, the epsilon
form of operators/eg_ops.py) against the JAX package on identical inputs;
mirrors tests/test_eg_stokes.py.

Tolerances: the div, grad and coupled applies to 1e-5 of max|y| (f32, the
same per-element terms in the same order); the structural identities with
the JAX test's bounds (adjoint 1e-4, symmetry 1e-3, kernels 1e-4 / 1e-5).
The manufactured convergence run is ``slow``, as the JAX test is.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.operators.eg_stokes import EGP0StokesFunction as JStokesFn
from hyteg_tpu.operators.eg_stokes import EGP0StokesOperator as JStokesOp
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.types import (BoundaryCondition, DoFType,
                                        FLAG_INNER)
from hyteg_tpu_torch.functions.eg import EGFunction
from hyteg_tpu_torch.operators import forms
from hyteg_tpu_torch.operators.eg_ops import EGLaplaceOperator
from hyteg_tpu_torch.operators.eg_stokes import (EGP0StokesFunction,
                                                 EGP0StokesOperator)
from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
from hyteg_tpu_torch.solvers.krylov import minres_solve

from tests.test_eg_stokes import _vel_l2_error
from tests.test_torch_eg import assert_eg_close, rand_eg, spaces

torch.set_num_threads(1)


def _pressure(jsp, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(jsp.p0.block_shape)
            * jsp.p0._valid_weight).astype(np.float32)


def _close(got, want, rtol):
    want = np.asarray(want)
    d = np.abs(interop.block_to_numpy(got) - want).max()
    assert d <= rtol * max(np.abs(want).max(), 1e-30), d


@pytest.mark.parametrize("level", [1, 2])
def test_blocks_match(level):
    jsp, tsp = spaces(level)
    jop, top = JStokesOp(jsp), EGP0StokesOperator(tsp)
    ju, tu = rand_eg(jsp, tsp, 20 + level)
    q = _pressure(jsp, 30 + level)
    tq = interop.volume_block_from_reference(q, device="cpu")
    _close(top.apply_div(tu), jop.apply_div(ju), 1e-5)
    assert_eg_close(top.apply_divT(tq), jop.apply_divT(jnp.asarray(q)), 1e-5)
    jy = jop.apply(JStokesFn(ju, jnp.asarray(q)))
    ty = top.apply(EGP0StokesFunction(tu, tq))
    assert_eg_close(ty.u, jy.u, 1e-5)
    _close(ty.p, jy.p, 1e-5)
    _close(top.project_pressure_mean(tq),
           jop.project_pressure_mean(jnp.asarray(q)), 1e-5)


def test_epsilon_symmetric_psd():
    jsp, tsp = spaces(2)
    op = EGLaplaceOperator(tsp, form="epsilon")
    (_, u), (_, v) = rand_eg(jsp, tsp, 0), rand_eg(jsp, tsp, 1)
    lhs, rhs = float(tsp.dot(op.apply(u), v)), float(tsp.dot(u, op.apply(v)))
    assert abs(lhs - rhs) < 1e-3 * max(abs(lhs), 1.0)
    assert float(tsp.dot(op.apply(u), u)) > 0.0


def test_epsilon_rigid_modes_in_kernel():
    """Constants and linearized rotations are in the epsilon form's
    kernel."""
    _, tsp = spaces(2)
    op = EGLaplaceOperator(tsp, form="epsilon")
    sd = tsp.p1.resolve_sd(None)
    rot = (lambda p: p[..., 1], lambda p: -p[..., 0],
           lambda p: torch.zeros_like(p[..., 0]))
    u = EGFunction(tuple(tsp.p1.interpolate(f, tsp.p1.zeros(), DoFType.ALL,
                                            sd) for f in rot),
                   tsp.p0.zeros(), tsp)
    Au = op.apply(u)
    ref = max(float(v.abs().max()) for v in u.vel)
    for v in Au.vel + (Au.enr,):
        assert float(v.abs().max()) < 1e-4 * ref


def test_div_adjoint():
    """<B u, q> == <u, B^T q>."""
    jsp, tsp = spaces(2)
    op = EGP0StokesOperator(tsp, form="epsilon")
    _, u = rand_eg(jsp, tsp, 3)
    q = interop.volume_block_from_reference(_pressure(jsp, 7), device="cpu")
    lhs = float(torch.sum(op.apply_div(u) * q))
    rhs = float(tsp.dot(u, op.apply_divT(q)))
    assert abs(lhs - rhs) < 1e-4 * max(abs(lhs), 1.0)


def test_div_exact_on_linear():
    _, tsp = spaces(2)
    op = EGP0StokesOperator(tsp)
    sd = tsp.p1.resolve_sd(None)
    aff = (lambda p: p[..., 0] - 2.0 * p[..., 1],
           lambda p: p[..., 1] + p[..., 2],
           lambda p: -2.0 * p[..., 2] + p[..., 0])
    u = EGFunction(tuple(tsp.p1.interpolate(f, tsp.p1.zeros(), DoFType.ALL,
                                            sd) for f in aff),
                   tsp.p0.zeros(), tsp)
    assert float(op.apply_div(u).abs().max()) < 1e-5


def test_coupled_symmetric():
    jsp, tsp = spaces(1)
    op = EGP0StokesOperator(tsp, form="epsilon")
    sd = tsp.p1.resolve_sd(None)
    xs = []
    for seed in (0, 2):
        _, u = rand_eg(jsp, tsp, seed)
        vel = tuple(tsp.p1.restore_rows(c, torch.zeros_like(c), FLAG_INNER,
                                        sd) for c in u.vel)
        q = interop.volume_block_from_reference(_pressure(jsp, seed + 1),
                                                device="cpu")
        xs.append(EGP0StokesFunction(EGFunction(vel, u.enr, tsp), q))
    u, v = xs
    lhs, rhs = float(op.dot(op.apply(u), v)), float(op.dot(u, op.apply(v)))
    assert abs(lhs - rhs) < 1e-3 * max(abs(lhs), 1.0)


def _solve(level, iters):
    """tests/test_eg_stokes.py::_solve in the port: u = (y^2, z^2, x^2),
    p = x + y + z - 3/4, f = -lap u + grad p = (-1, -1, -1); the Dirichlet
    data lifted by the interpolant, MINRES on the correction with the
    same block equilibration."""
    _, sp = spaces(level)
    op = EGP0StokesOperator(sp, form="epsilon")
    sd = sp.p1.resolve_sd(BoundaryCondition.all_dirichlet())
    mass = P1ElementwiseOperator(sp.p1, forms.mass_form)
    ex = (lambda p: p[..., 1] ** 2, lambda p: p[..., 2] ** 2,
          lambda p: p[..., 0] ** 2)
    u0 = EGFunction(tuple(sp.p1.interpolate(f, sp.p1.zeros(), DoFType.ALL,
                                            sd) for f in ex),
                    sp.p0.zeros(), sp)
    a0 = op.visc.apply(u0)
    fd = sp.p1.interpolate(-1.0, sp.p1.zeros(), DoFType.ALL, sd)
    bvel = tuple(sp.p1.restore_rows(mass.apply_raw(fd) - a0.vel[d],
                                    sp.p1.zeros(), FLAG_INNER, sd)
                 for d in range(3))
    b = EGP0StokesFunction(EGFunction(bvel, -a0.enr, sp), -op.apply_div(u0))
    h = 1.0 / (1 << level)
    vol = sp.p0.elem_volumes + 1e-30

    def apply_fn(x):
        y = op.apply(EGP0StokesFunction(x.u, op.project_pressure_mean(x.p)),
                     FLAG_INNER)
        return EGP0StokesFunction(y.u, op.project_pressure_mean(y.p))

    def prec_fn(r):
        return EGP0StokesFunction(
            (1.0 / h) * r.u,
            op.project_pressure_mean(r.p / vol * sp.p0.valid_weight_t))

    x, _, _ = minres_solve(apply_fn, op.dot, b,
                           EGP0StokesFunction(sp.zeros(), sp.p0.zeros()),
                           iters, rtol=1e-8, prec_fn=prec_fn)
    return x.u + u0


@pytest.mark.slow
def test_eg_stokes_converges_second_order():
    """Velocity L2 error of the epsilon-form EG-P0 Stokes solve drops
    > 2.5x per refinement (the JAX test's gate), measured with the JAX
    test's quadrature on the port's solution."""
    errs = {}
    for lvl, iters in ((2, 700), (3, 1600)):
        u = _solve(lvl, iters)
        jsp, _ = spaces(lvl)
        x = types.SimpleNamespace(u=types.SimpleNamespace(
            vel=tuple(interop.block_to_numpy(v) for v in u.vel),
            enr=interop.block_to_numpy(u.enr)))
        errs[lvl] = _vel_l2_error(jsp, x)
    assert errs[2] / errs[3] > 2.5, errs
