"""The EG (enriched Galerkin) space and vector Laplace of the PyTorch port
(functions/eg.py, operators/eg_ops.py) against the JAX package on
identical inputs; mirrors tests/test_eg.py (single macro-tet, as the
operator requires in both packages).

Tolerances: the applies to 1e-5 of max|y| (f32; the same per-element
terms, scattered in the same order); the manufactured solve's total L2
error within 2% of the JAX package's at level 2, and the JAX test's gate
(drop > 2.5x from level 2 to 3) on the port.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.core.types import BoundaryCondition as JBC
from hyteg_tpu.core.types import DoFType as JDoF, FLAG_INNER as JINNER
from hyteg_tpu.functions.eg import EGFunction as JEGFunction
from hyteg_tpu.functions.eg import EGSpace as JEGSpace
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import forms as jforms
from hyteg_tpu.operators.eg_ops import EGLaplaceOperator as JEGLaplace
from hyteg_tpu.operators.p1_elementwise import P1ElementwiseOperator as JP1Op
from hyteg_tpu.primitives.storage import CellStorage as JCellStorage
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.types import (BoundaryCondition, DoFType,
                                        FLAG_INNER)
from hyteg_tpu_torch.functions.eg import EGFunction, EGSpace
from hyteg_tpu_torch.mesh import meshinfo as mi
from hyteg_tpu_torch.operators import forms
from hyteg_tpu_torch.operators.eg_ops import EGLaplaceOperator
from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.solvers.krylov import cg_solve

from tests.test_eg import _total_l2_error

torch.set_num_threads(1)


def spaces(level):
    return (JEGSpace(JCellStorage(jmi.mesh_single_tet(), num_shards=1), level),
            EGSpace(CellStorage(mi.mesh_single_tet()), level, device="cpu"))


def rand_eg(jsp, tsp, seed, with_enr=True):
    """The same random EG field in both packages: consistent CG blocks
    (exchange_rep) and a masked enrichment."""
    rng = np.random.default_rng(seed)
    m = jsp.p1.vertex_mask[None]
    vel = tuple(np.asarray(jsp.p1.exchange_rep(jnp.asarray(
        (rng.standard_normal(jsp.p1.block_shape) * m).astype(np.float32))))
        for _ in range(jsp.dim))
    enr = (rng.standard_normal(jsp.p0.block_shape) * jsp.p0._valid_weight
           if with_enr else np.zeros(jsp.p0.block_shape)).astype(np.float32)
    return (JEGFunction(tuple(jnp.asarray(v) for v in vel), jnp.asarray(enr),
                        jsp),
            interop.eg_from_reference(vel, enr, tsp, device="cpu"))


def assert_eg_close(got, want, rtol):
    parts = list(zip(got.vel, want.vel)) + [(got.enr, want.enr)]
    scale = max(float(np.abs(np.asarray(w)).max()) for _, w in parts)
    for g, w in parts:
        d = np.abs(interop.block_to_numpy(g) - np.asarray(w)).max()
        assert d <= rtol * max(scale, 1e-30), (d, scale)


@pytest.mark.parametrize("form", ["laplace", "epsilon"])
@pytest.mark.parametrize("level", [1, 2])
def test_apply_matches(level, form):
    jsp, tsp = spaces(level)
    jop, top = JEGLaplace(jsp, form=form), EGLaplaceOperator(tsp, form=form)
    for name in ("g", "vol", "a_s", "a_n", "Pss", "Psn", "vb_s", "vb_n",
                 "gn", "gnn", "pen", "nrm", "gB"):
        want = np.asarray(getattr(jop, name))
        got = interop.block_to_numpy(getattr(top, name))
        assert np.abs(got - want).max() <= 1e-6 * max(np.abs(want).max(), 1)
    ju, tu = rand_eg(jsp, tsp, 10 + level)
    assert_eg_close(top.apply(tu), jop.apply(ju), 1e-5)
    assert_eg_close(top.apply_inner(tu), jop.apply_inner(ju), 1e-5)


def test_symmetric_and_psd():
    jsp, tsp = spaces(2)
    op = EGLaplaceOperator(tsp)
    _, u = rand_eg(jsp, tsp, 0)
    _, v = rand_eg(jsp, tsp, 1)
    lhs, rhs = float(tsp.dot(op.apply(u), v)), float(tsp.dot(u, op.apply(v)))
    assert abs(lhs - rhs) < 1e-3 * max(abs(lhs), 1.0)
    assert float(tsp.dot(op.apply(u), u)) > 0.0


def test_constants_in_kernel():
    _, tsp = spaces(2)
    op = EGLaplaceOperator(tsp)
    ones = EGFunction(tuple(tsp.p1.vertex_mask_t[None].clone()
                            for _ in range(3)), tsp.p0.zeros(), tsp)
    Au = op.apply(ones)
    for v in Au.vel + (Au.enr,):
        assert float(v.abs().max()) < 1e-4


def _solve_port(level, cg_iters=400):
    """tests/test_eg.py::_solve in the port: vector Poisson with the tet
    bubble solution (zero trace), CG on the interior rows."""
    _, sp = spaces(level)
    op = EGLaplaceOperator(sp)
    sd = sp.p1.resolve_sd(BoundaryCondition.all_dirichlet())
    f = lambda p: 2.0 * (p[..., 0] * p[..., 1] + p[..., 1] * p[..., 2]
                         + p[..., 0] * p[..., 2])
    mass = P1ElementwiseOperator(sp.p1, forms.mass_form)
    fh = sp.p1.interpolate(f, sp.p1.zeros(), DoFType.ALL, sd)
    bvel = sp.p1.restore_rows(mass.apply_raw(fh), sp.p1.zeros(), FLAG_INNER,
                              sd)
    b = EGFunction((bvel,) * 3, sp.p0.zeros(), sp)
    res = cg_solve(lambda x: op.apply_inner(x, FLAG_INNER), sp.dot, b,
                   sp.zeros(), cg_iters, rtol=1e-7)
    return res.x


def _solve_jax(level, cg_iters=400):
    """The same solve in the JAX package: its jitted apply, the CG loop
    on the host."""
    jsp, _ = spaces(level)
    op = JEGLaplace(jsp)
    apply_inner = jax.jit(op.apply_inner)
    sd = jsp.p1.resolve_sd(JBC.all_dirichlet())
    f = lambda p: 2.0 * (p[..., 0] * p[..., 1] + p[..., 1] * p[..., 2]
                         + p[..., 0] * p[..., 2])
    mass = JP1Op(jsp.p1, jforms.mass_form)
    fh = jsp.p1.interpolate(f, jsp.p1.zeros(), JDoF.ALL, sd)
    bvel = jsp.p1.restore_rows(mass.apply_raw(fh), jsp.p1.zeros(), JINNER, sd)
    b = JEGFunction((bvel,) * 3, jsp.p0.zeros(), jsp)
    x = jsp.zeros()
    r = b - apply_inner(x)
    p, rr = r, float(jsp.dot(r, r))
    tol2 = 1e-14 * rr
    for _ in range(cg_iters):
        if rr <= tol2:
            break
        ap = apply_inner(p)
        alpha = rr / float(jsp.dot(p, ap))
        x, r = x + alpha * p, r - alpha * ap
        rr_new = float(jsp.dot(r, r))
        p, rr = r + (rr_new / rr) * p, rr_new
    return x


def _error(level, x):
    jsp, _ = spaces(level)
    bub = lambda p: (p[..., 0] * p[..., 1] * p[..., 2]
                     * (1.0 - p[..., 0] - p[..., 1] - p[..., 2]))
    xs = types.SimpleNamespace(
        vel=tuple(interop.block_to_numpy(v) if isinstance(v, torch.Tensor)
                  else np.asarray(v) for v in x.vel),
        enr=(interop.block_to_numpy(x.enr) if isinstance(x.enr, torch.Tensor)
             else np.asarray(x.enr)))
    return _total_l2_error(jsp, xs, bub)


def test_poisson_converges_second_order():
    """The JAX test's gate on the port (total L2 error drops > 2.5x from
    level 2 to 3), and the level-2 error within 2% of the JAX package's
    own solve (tests/test_eg.py gates the JAX side at both levels; its
    jitted apply compiles for ~25 s a level)."""
    e2, e3 = (_error(lv, _solve_port(lv)) for lv in (2, 3))
    assert e3 < e2 / 2.5, (e2, e3)
    je2 = _error(2, _solve_jax(2))
    assert abs(e2 - je2) <= 0.02 * je2, (e2, je2)
