"""Colored Gauss-Seidel, FAS and the flexible multigrid solver of the
PyTorch port (solvers/{colored_gs,fas,gmg}.py) against the JAX package;
mirrors the colored-GS and FAS cases of tests/test_solvers_extra.py
(its GMRES cases are covered by tests/test_torch_stokes_krylov.py).

The solvers are control flow over injected callables: both packages'
``FlexibleMultigridSolver`` and ``FASSolver`` run on the same numpy
callables and must return the same bits. On the P1 problem
(mesh_unit_cube(1), levels <= 2) one colored-GS sweep matches the JAX
package's to 1e-5 of max|x| (8 applies of f32 stencils) and the solvers
meet the JAX test's gates; FAS stays within 5% of the linear V-cycle's
residual in every cycle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.core.types import BoundaryCondition as JBC
from hyteg_tpu.core.types import FLAG_INNER as JINNER
from hyteg_tpu.operators.p1_elementwise import P1ElementwiseOperator as JP1Op
from hyteg_tpu.operators import forms as jforms
from hyteg_tpu.solvers import colored_gs as jcgs
from hyteg_tpu.solvers import fas as jfas
from hyteg_tpu.solvers import gmg as jgmg
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.types import (BoundaryCondition, DoFType,
                                        FLAG_INNER)
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.mesh import meshinfo as mi
from hyteg_tpu_torch.operators import forms
from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
from hyteg_tpu_torch.operators.transfer import P1Transfer
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.solvers import colored_gs, fas, gmg
from hyteg_tpu_torch.solvers.krylov import cg_solve_fixed
from hyteg_tpu_torch.solvers.smoothers import jacobi_smooth
from hyteg_tpu_torch.solvers.templates import make_p1_gmg

from tests.test_solvers import F as JF, U as JU, _poisson_setup
from tests.test_torch_const_stencil import _assert_close, _spaces

torch.set_num_threads(1)


def poisson(level):
    """The JAX test's problem in the port: x with the Dirichlet data of
    u = sin sin sin, b = M f on the inner rows."""
    import math

    storage = CellStorage(mi.mesh_unit_cube(1))
    sp = P1Space(storage, level, device="cpu")
    bc = BoundaryCondition.all_dirichlet()
    U = lambda p: (torch.sin(math.pi * p[..., 0]) * torch.sin(math.pi * p[..., 1])
                   * torch.sin(math.pi * p[..., 2]))
    lap = P1ElementwiseOperator(sp, forms.laplace_form)
    mass = P1ElementwiseOperator(sp, forms.mass_form)
    x = sp.interpolate(U, sp.zeros(), DoFType.DIRICHLET, bc)
    f = sp.interpolate(lambda p: 3 * math.pi ** 2 * U(p), sp.zeros(),
                       DoFType.ALL, bc)
    b = sp.restore_rows(mass.apply_raw(f), sp.zeros(), FLAG_INNER, bc)
    return storage, sp, bc, lap, x, b


def test_parity_masks_match():
    for level, dim, pitch in ((2, 3, None), (3, 3, 17), (3, 2, None)):
        for a, b in zip(colored_gs.parity_masks(level, dim, pitch),
                        jcgs.parity_masks(level, dim, pitch)):
            np.testing.assert_array_equal(a, b)
    from hyteg_tpu_torch.indexing import micro

    total = sum(m.sum() for m in colored_gs.parity_masks(2, 3))
    assert total == micro.vertex_mask(2, 3).sum()


@pytest.mark.parametrize("backward,omega", [(False, 1.0), (True, 1.2)])
def test_colored_gs_sweep_matches(backward, omega):
    jsp, tsp = _spaces("cube1", 2, None)
    bc = JBC.all_dirichlet()
    _, _, jlap, _, jx, jb = _poisson_setup(jsp.storage, 2, JU, JF)
    jx = jx.cells
    elm = interop.elmats_from_reference(np.asarray(jlap.elmats), device="cpu")
    tlap = P1ElementwiseOperator(tsp, forms.laplace_form, elmats=elm)
    tbc = BoundaryCondition.all_dirichlet()
    jinv, tinv = jlap.inverse_diagonal(), tlap.inverse_diagonal()
    ref = np.asarray(jcgs.colored_gs_smooth(
        lambda v: jlap.apply_inner(v, bc), jinv, jb, jx, 2, 3, omega=omega,
        backward=backward, num_sweeps=2))
    got = colored_gs.colored_gs_smooth(
        lambda v: tlap.apply_inner(v, tbc), tinv,
        interop.block_from_reference(np.asarray(jb), device="cpu"),
        interop.block_from_reference(np.asarray(jx), device="cpu"), 2, 3,
        omega=omega, backward=backward, num_sweeps=2)
    _assert_close(got, ref, np.abs(ref).max(), 1e-5)


def test_colored_gs_smoother_converges():
    """The JAX test's gates: 30 sweeps cut the residual below 0.15 r0 and
    leave the Dirichlet rows untouched; the symmetric sweep too."""
    _, sp, bc, lap, x0, b = poisson(2)
    apply_fn = lambda v: lap.apply_inner(v, bc)
    rnorm = lambda v: float(torch.sqrt(sp.dot(b - apply_fn(v),
                                              b - apply_fn(v), FLAG_INNER, bc)))
    invd = lap.inverse_diagonal()
    xs = colored_gs.colored_gs_smooth(apply_fn, invd, b, x0, 2, 3,
                                      num_sweeps=30)
    assert rnorm(xs) < 0.15 * rnorm(x0)
    sym = colored_gs.symmetric_colored_gs_smooth(apply_fn, invd, b, x0, 2, 3,
                                                 num_sweeps=15)
    assert rnorm(sym) < 0.15 * rnorm(x0)
    sd = sp.shard_data(0, bc)
    dirichlet = sd._flag_slots(FLAG_INNER)[1]
    assert (xs - x0).reshape(-1)[dirichlet].abs().max() == 0.0


def _numpy_levels(pkg, rng_seed=0, n=(3, 5, 9)):
    """A 3-level hierarchy of dense SPD numpy systems wired as GMGLevel /
    FASLevel callables (the same arrays for both packages)."""
    rng = np.random.default_rng(rng_seed)
    mats, Ps = {}, {}
    for l, k in enumerate(n):
        Q = rng.standard_normal((k, k))
        mats[l] = Q @ Q.T + k * np.eye(k)
        if l:
            Ps[l] = rng.standard_normal((k, n[l - 1]))
    jac = lambda l: (lambda x, b: x + 0.5 * (b - mats[l] @ x)
                     / np.diag(mats[l]))
    coarse = lambda b, x0: np.linalg.solve(mats[0], b)
    return mats, Ps, jac, coarse


def test_flexible_multigrid_matches_jax_control_flow():
    mats, Ps, jac, coarse = _numpy_levels(None)

    def levels(mod):
        return {l: mod.GMGLevel(
            apply=lambda x, l=l: mats[l] @ x, smooth=jac(l),
            dot=lambda u, v: float(u @ v), zeros=lambda l=l: np.zeros(len(mats[l])),
            restrict=(lambda r, l=l: Ps[l].T @ r) if l else None,
            prolongate_add=(lambda xc, xf, l=l: xf + Ps[l] @ xc) if l else None)
            for l in mats}

    pre = {2: [jac(2), jac(2)], 1: [jac(1)]}
    post = {2: [jac(2)]}
    b = np.arange(9, dtype=np.float64)
    outs = [mod.FlexibleMultigridSolver(
        levels(mod), coarse, 0, 2, pre_lists=pre, post_lists=post).solve(
            np.zeros(9), b, 3) for mod in (jgmg, gmg)]
    np.testing.assert_array_equal(outs[0], outs[1])
    # no lists: three sweeps of each level's smoother, the plain cycle (the
    # JAX plain cycle scans its sweeps in jax arrays, so the port alone)
    plain = gmg.GeometricMultigridSolver(levels(gmg), coarse, 0, 2, 3, 3)
    flex = gmg.FlexibleMultigridSolver(levels(gmg), coarse, 0, 2)
    np.testing.assert_array_equal(flex.cycle(np.zeros(9), b),
                                  plain.cycle(np.zeros(9), b))


def test_fas_matches_jax_control_flow():
    mats, Ps, jac, coarse = _numpy_levels(None, rng_seed=1)

    def levels(mod):
        return {l: mod.FASLevel(
            apply=lambda x, l=l: mats[l] @ x + 0.1 * x ** 3, smooth=jac(l),
            restrict=(lambda r, l=l: Ps[l].T @ r) if l else None,
            restrict_inj=(lambda x, l=l: np.linalg.lstsq(
                Ps[l], x, rcond=None)[0]) if l else None,
            prolongate=(lambda xc, l=l: Ps[l] @ xc) if l else None,
            zeros=lambda l=l: np.zeros(len(mats[l])))
            for l in mats}

    b = np.linspace(-1, 1, 9)
    x = [mod.FASSolver(levels(mod), coarse, 0, 2, 2, 2).solve(
        np.zeros(9), b, 2) for mod in (jfas, fas)]
    np.testing.assert_array_equal(x[0], x[1])


def _fas_and_linear(max_l=2, min_l=0, cycles=5):
    """tests/test_solvers_extra.py's FAS hierarchy (Jacobi smoothing, 40
    fixed CG steps on level 0) in the port, and the linear V-cycle with
    the same parts. Returns both residual histories."""
    storage = CellStorage(mi.mesh_unit_cube(1))
    bc = BoundaryCondition.all_dirichlet()
    spaces = {l: P1Space(storage, l, device="cpu")
              for l in range(min_l, max_l + 1)}
    ops = {l: P1ElementwiseOperator(spaces[l], forms.laplace_form)
           for l in spaces}
    trs = {l: P1Transfer(spaces[l - 1], spaces[l])
           for l in range(min_l + 1, max_l + 1)}
    invd = {l: ops[l].inverse_diagonal() for l in spaces}
    sds = {l: spaces[l].shard_data(0, bc) for l in spaces}
    applies = {l: (lambda v, l=l: ops[l].apply_inner(v, bc)) for l in spaces}
    dots = {l: (lambda u, v, l=l: spaces[l].dot(u, v, FLAG_INNER, bc))
            for l in spaces}
    smooth = {l: (lambda x, b, l=l: spaces[l].restore_rows(
        jacobi_smooth(applies[l], invd[l], b, x), x, FLAG_INNER, sds[l]))
        for l in spaces}
    prol = {l: (lambda xc, l=l: spaces[l].restore_rows(
        trs[l].prolongate(xc), spaces[l].zeros(), FLAG_INNER, sds[l]))
        for l in trs}
    levels = {l: fas.FASLevel(
        apply=applies[l], smooth=smooth[l],
        restrict=(lambda r, l=l: trs[l].restrict(r)) if l in trs else None,
        restrict_inj=(lambda x, l=l: trs[l].restrict_injection(x))
        if l in trs else None,
        prolongate=prol.get(l), zeros=lambda l=l: spaces[l].zeros())
        for l in spaces}
    coarse = lambda b, x0: cg_solve_fixed(applies[min_l], dots[min_l], b,
                                          x0, 40)
    glevels = {l: gmg.GMGLevel(
        apply=applies[l], smooth=smooth[l], dot=dots[l],
        zeros=lambda l=l: spaces[l].zeros(),
        restrict=(lambda r, l=l: spaces[l - 1].restore_rows(
            trs[l].restrict(r), spaces[l - 1].zeros(), FLAG_INNER,
            sds[l - 1])) if l in trs else None,
        prolongate_add=(lambda xc, xf, l=l: xf + prol[l](xc))
        if l in trs else None) for l in spaces}
    solvers = (fas.FASSolver(levels, coarse, min_l, max_l),
               gmg.GeometricMultigridSolver(glevels, coarse, min_l, max_l))
    _, _, _, _, x0, b = poisson(max_l)
    rn = lambda v: float(torch.sqrt(dots[max_l](b - applies[max_l](v),
                                                b - applies[max_l](v))))
    hist = []
    for s in solvers:
        x, h = x0, [rn(x0)]
        for _ in range(cycles):
            x = s.cycle(x, b)
            h.append(rn(x))
        hist.append(h)
    return hist


def test_fas_converges_like_linear_vcycle():
    """The JAX test's gate (5 FAS cycles below 1e-2 r0), and FAS within 5%
    of the linear V-cycle's residual after every cycle."""
    h_fas, h_lin = _fas_and_linear()
    assert h_fas[-1] < 1e-2 * h_fas[0], h_fas
    for a, b in zip(h_fas[1:], h_lin[1:]):
        assert abs(a - b) <= 0.05 * b, (h_fas, h_lin)


def test_flexible_gmg_with_colored_gs_on_the_finest_level():
    """make_p1_gmg's levels under FlexibleMultigridSolver: two colored-GS
    sweeps before and after on the finest level, the stack's Chebyshev
    below; each cycle's rate <= 0.2 (the P1 cycle's bound)."""
    storage = CellStorage(mi.mesh_unit_cube(1))
    stack = make_p1_gmg(storage, 0, 3, coarse_iters=40, device="cpu")
    sp, sd, L = stack.space(), stack.sd(), 3
    op, inv = stack.operators[L], stack.inv_diags[L]
    apply_fn = lambda v: op.apply_inner(v, sd, FLAG_INNER)

    def gs(x, b):
        xn = colored_gs.symmetric_colored_gs_smooth(apply_fn, inv, b, x, L, 3,
                                                    pitch=sp.pitch)
        return sp.restore_rows(xn, x, FLAG_INNER, sd)

    g = stack.gmg
    flex = gmg.FlexibleMultigridSolver(g.levels, g.coarse_solve, 0, L,
                                       pre_lists={L: [gs]},
                                       post_lists={L: [gs]})
    gen = torch.Generator().manual_seed(5)
    x = sp.exchange_rep(torch.randn(sp.block_shape, generator=gen)
                        * sp.vertex_mask_t)
    x = sp.restore_rows(x, sp.zeros(), FLAG_INNER, sd)
    b = sp.zeros()
    res = [float(stack.residual_norm(x, b))]
    for _ in range(4):
        x = flex.cycle(x, b)
        res.append(float(stack.residual_norm(x, b)))
    rates = [res[i + 1] / res[i] for i in range(4)]
    assert max(rates) <= 0.2, rates
