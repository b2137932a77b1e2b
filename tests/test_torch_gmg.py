"""Grid transfers, smoothers, CG and the GMG slice of the PyTorch port
against the JAX package on identical inputs.

The slice: make_p1_gmg(mesh_unit_cube(1), 0, 3) in both packages, with
the JAX stack's element matrices and eigenvalue bounds carried over
through hyteg_tpu_torch.interop, x0 and b built as
__graft_entry__.entry() builds them (Dirichlet-interpolated u; b = M f on
the inner rows), one jitted JAX V-cycle against the port's eager one.

Tolerances, all f32: transfers, smoother steps and R = P^T 1e-6 of the
largest entry; CG 1e-5; one V-cycle 1e-5 * max|x|; the residual after
cycle 1 1e-3 relative; after cycles 2-3 5e-2 relative or 1e-6 * ||r0||,
because there the residual nears f32 round-off, where the two packages'
different summation orders dominate.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.core import types as jt
from hyteg_tpu.functions.p1 import P1Space as JSpace
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import forms as jforms
from hyteg_tpu.operators.p1_elementwise import P1ElementwiseOperator as JOp
from hyteg_tpu.operators.transfer import P1Transfer as JTransfer
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu.solvers import krylov as jkr
from hyteg_tpu.solvers import smoothers as jsm
from hyteg_tpu.solvers.templates import make_p1_gmg as j_make_p1_gmg
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core import types as tt
from hyteg_tpu_torch.core.types import CycleType
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.operators import forms as tforms
from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
from hyteg_tpu_torch.operators.transfer import P1Transfer
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.solvers import krylov as tkr
from hyteg_tpu_torch.solvers import smoothers as tsm
from hyteg_tpu_torch.solvers.gmg import (FullMultigridSolver,
                                         GeometricMultigridSolver)
from hyteg_tpu_torch.solvers.templates import make_p1_gmg

torch.set_num_threads(1)

T = interop.block_from_reference
N_ = interop.block_to_numpy


def _mesh(mod, name):
    return mod.mesh_single_tet() if name == "tet" else mod.mesh_unit_cube(
        int(name[-1]))


def _close(got, ref, rtol, scale=None):
    got = N_(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max() if scale is None else scale
    assert np.abs(got - ref).max() <= rtol * scale


def _rand(shape, mask, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * mask[None]).astype(np.float32)


# ---------------------------------------------------------------------------
# transfers
# ---------------------------------------------------------------------------

TRANSFER_CASES = [("tet", 1), ("tet", 2), ("cube1", 1), ("cube1", 2),
                  ("cube2", 1)]


def _transfer_pair(name, clevel):
    pitch = (1 << (clevel + 1)) + 1
    js, ts = JStorage(_mesh(jmi, name)), CellStorage(_mesh(tmi, name))
    jc, jf = JSpace(js, clevel, pitch=pitch), JSpace(js, clevel + 1, pitch=pitch)
    tc, tf = (P1Space(ts, clevel, pitch=pitch),
              P1Space(ts, clevel + 1, pitch=pitch))
    return JTransfer(jc, jf), P1Transfer(tc, tf)


@pytest.mark.parametrize("name,clevel", TRANSFER_CASES)
def test_prolongate_matches_jax(name, clevel):
    jtr, ttr = _transfer_pair(name, clevel)
    uc = _rand(jtr.coarse.block_shape, jtr.coarse.vertex_mask, clevel)
    uf = _rand(jtr.fine.block_shape, jtr.fine.vertex_mask, clevel + 7)
    ref = jax.jit(jtr.prolongate_and_add)(jnp.asarray(uc), jnp.asarray(uf))
    _close(ttr.prolongate_and_add(T(uc), T(uf)), ref, 1e-6)
    _close(ttr.prolongate(T(uc)), np.asarray(ref) - uf, 1e-6)


@pytest.mark.parametrize("name,clevel", TRANSFER_CASES)
def test_restrict_matches_jax(name, clevel):
    jtr, ttr = _transfer_pair(name, clevel)
    rf = _rand(jtr.fine.block_shape, jtr.fine.vertex_mask, clevel + 1)
    _close(ttr.restrict(T(rf)), jax.jit(jtr.restrict)(jnp.asarray(rf)), 1e-6)
    _close(ttr.restrict_injection(T(rf)),
           jax.jit(jtr.restrict_injection)(jnp.asarray(rf)), 1e-6)


def test_transfer_with_mismatched_pitch_matches_jax():
    js, ts = JStorage(jmi.mesh_unit_cube(1)), CellStorage(tmi.mesh_unit_cube(1))
    jtr = JTransfer(JSpace(js, 1), JSpace(js, 2))
    ttr = P1Transfer(P1Space(ts, 1), P1Space(ts, 2))
    uc = _rand(jtr.coarse.block_shape, jtr.coarse.vertex_mask, 5)
    _close(ttr.prolongate(T(uc)), jax.jit(jtr.prolongate)(jnp.asarray(uc)),
           1e-6)
    rf = _rand(jtr.fine.block_shape, jtr.fine.vertex_mask, 6)
    _close(ttr.restrict(T(rf)), jax.jit(jtr.restrict)(jnp.asarray(rf)), 1e-6)


@pytest.mark.parametrize("name", ["tet", "cube1"])
def test_restriction_is_transpose(name):
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

    eye_c, eye_f = np.eye(nc), np.eye(nf)
    P = np.stack([from_blocks(gf, ttr.prolongate(to_blocks(gc, e)), nf)
                  for e in eye_c], axis=1)
    R = np.stack([from_blocks(gc, ttr.restrict(to_blocks(gf, e)), nc)
                  for e in eye_f], axis=1)
    assert np.abs(R - P.T).max() <= 1e-6 * np.abs(P).max()


# ---------------------------------------------------------------------------
# smoothers and CG
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OpPair:
    jsp: JSpace
    tsp: P1Space
    jop: JOp
    top: P1ElementwiseOperator
    b: np.ndarray
    x: np.ndarray

    def applies(self):
        return (lambda v: self.jop.apply_inner(v, None, jt.FLAG_INNER),
                lambda v: self.top.apply_inner(v, None, tt.FLAG_INNER))

    def dots(self):
        return (lambda u, v: self.jsp.dot(u, v, jt.FLAG_INNER),
                lambda u, v: self.tsp.dot(u, v, tt.FLAG_INNER))


@pytest.fixture(scope="module")
def ops():
    jsp = JSpace(JStorage(jmi.mesh_unit_cube(1)), 2)
    tsp = P1Space(CellStorage(tmi.mesh_unit_cube(1)), 2)
    jop = JOp(jsp, jforms.laplace_form)
    top = P1ElementwiseOperator(tsp, tforms.laplace_form,
                                elmats=interop.elmats_from_reference(
                                    np.asarray(jop.elmats)))
    # consistent replicas (exchange_rep), b zero on the Dirichlet rows
    b = jsp.exchange_rep(jnp.asarray(_rand(jsp.block_shape, jsp.vertex_mask, 1)))
    b = np.asarray(jsp.restore_rows(b, jnp.zeros_like(b), jt.FLAG_INNER))
    x = np.asarray(jsp.exchange_rep(
        jnp.asarray(_rand(jsp.block_shape, jsp.vertex_mask, 2))))
    return OpPair(jsp, tsp, jop, top, b, x)


def test_jacobi_step_matches_jax(ops):
    ja, ta = ops.applies()
    ref = jsm.jacobi_smooth(ja, ops.jop.inverse_diagonal(), jnp.asarray(ops.b),
                            jnp.asarray(ops.x), 2.0 / 3.0)
    got = tsm.jacobi_smooth(ta, ops.top.inverse_diagonal(), T(ops.b),
                            T(ops.x), 2.0 / 3.0)
    _close(got, ref, 1e-6)


def test_chebyshev_step_matches_jax(ops):
    ja, ta = ops.applies()
    eig = jsm.p1_stencil_eig_fourier(np.asarray(ops.jop.stencil), 3)
    ref = jsm.chebyshev_smooth(ja, ops.jop.inverse_diagonal(),
                               jnp.asarray(ops.b), jnp.asarray(ops.x), eig,
                               order=4)
    got = tsm.chebyshev_smooth(ta, ops.top.inverse_diagonal(), T(ops.b),
                               T(ops.x), eig, order=4)
    _close(got, ref, 1e-6)


def test_eig_fourier_matches_jax(ops):
    ref = jsm.p1_stencil_eig_fourier(np.asarray(ops.jop.stencil), 3)
    got = tsm.p1_stencil_eig_fourier(ops.top.stencil, 3)
    assert abs(got - ref) <= 1e-6 * abs(ref)


def test_power_iteration_is_seeded_and_bounded(ops):
    _, ta = ops.applies()
    _, td = ops.dots()
    inv = ops.top.inverse_diagonal()
    bound = tsm.p1_stencil_eig_fourier(ops.top.stencil, 3)
    lams = [float(tsm.estimate_spectral_radius(
        ta, inv, td, ops.tsp.block_shape, num_iter=25,
        generator=torch.Generator().manual_seed(42))) for _ in range(2)]
    assert lams[0] == lams[1]
    assert 0.5 * bound < lams[0] <= bound * (1 + 1e-5)


def test_cg_fixed_matches_jax(ops):
    ja, ta = ops.applies()
    jd, td = ops.dots()
    x0 = ops.x * 0
    ref = jkr.cg_solve_fixed(ja, jd, jnp.asarray(ops.b), jnp.asarray(x0), 12)
    got = tkr.cg_solve_fixed(ta, td, T(ops.b), T(x0), 12)
    _close(got, ref, 1e-5)


def test_cg_matches_jax(ops):
    ja, ta = ops.applies()
    jd, td = ops.dots()
    x0 = ops.x * 0
    ref = jkr.cg_solve(ja, jd, jnp.asarray(ops.b), jnp.asarray(x0), 200,
                       rtol=1e-6)
    got = tkr.cg_solve(ta, td, T(ops.b), T(x0), 200, rtol=1e-6)
    _close(got.x, ref.x, 1e-5)
    assert abs(got.iterations - int(ref.iterations)) <= 2
    assert float(got.residual_norm2) <= 1e-12 * float(td(T(ops.b), T(ops.b)))


# ---------------------------------------------------------------------------
# the slice: make_p1_gmg on mesh_unit_cube(1), levels 0..3
# ---------------------------------------------------------------------------


def _u_jax(p):
    return jnp.sin(jnp.pi * p[..., 0]) * jnp.sin(jnp.pi * p[..., 1]) * jnp.sin(
        jnp.pi * p[..., 2])


@dataclasses.dataclass
class Slice:
    tstack: object
    x1_ref: np.ndarray
    x1: torch.Tensor
    res_ref: list
    res: list


@pytest.fixture(scope="module")
def gmg_slice():
    jstack = j_make_p1_gmg(JStorage(jmi.mesh_unit_cube(1)), 0, 3)
    eigs = {l: jsm.p1_stencil_eig_fourier(np.asarray(op.stencil), 3)
            for l, op in jstack.operators.items()}
    tstack = make_p1_gmg(
        CellStorage(tmi.mesh_unit_cube(1)), 0, 3, eigs=eigs,
        elmats={l: interop.elmats_from_reference(np.asarray(op.elmats))
                for l, op in jstack.operators.items()})
    # x0 and b as __graft_entry__.entry() builds them
    sp, bc = jstack.space(), jt.BoundaryCondition.all_dirichlet()
    mass = JOp(sp, jforms.mass_form)
    x = sp.interpolate(_u_jax, sp.zeros(), jt.DoFType.DIRICHLET, bc)
    f = sp.interpolate(lambda p: 3 * jnp.pi ** 2 * _u_jax(p), sp.zeros(),
                       jt.DoFType.ALL, bc)
    b = sp.restore_rows(mass.apply_raw(f), sp.zeros(), jt.FLAG_INNER, bc)
    xt, bt = T(np.asarray(x)), T(np.asarray(b))
    cycle = jax.jit(jstack.gmg.cycle)
    res_ref = [float(jstack.residual_norm(x, b))]
    res = [float(tstack.residual_norm(xt, bt))]
    for k in range(3):
        x = cycle(x, b)
        xt = tstack.gmg.cycle(xt, bt)
        if k == 0:
            x1_ref, x1 = np.asarray(x), xt.clone()
        res_ref.append(float(jstack.residual_norm(x, b)))
        res.append(float(tstack.residual_norm(xt, bt)))
    return Slice(tstack, x1_ref, x1, res_ref, res)


def test_slice_one_vcycle_matches_jax(gmg_slice):
    _close(gmg_slice.x1, gmg_slice.x1_ref, 1e-5)


def test_slice_residual_history_matches_jax(gmg_slice):
    ref, got = gmg_slice.res_ref, gmg_slice.res
    assert abs(got[0] - ref[0]) <= 1e-6 * ref[0]
    assert abs(got[1] - ref[1]) <= 1e-3 * ref[1]
    for k in (2, 3):
        assert abs(got[k] - ref[k]) <= max(5e-2 * ref[k], 1e-6 * ref[0])
    assert got[3] < 1e-3 * got[0]


def test_slice_w_cycle_and_fmg_converge(gmg_slice):
    stack = gmg_slice.tstack
    sp, bc = stack.space(), tt.BoundaryCondition.all_dirichlet()
    u = lambda p: (torch.sin(math.pi * p[..., 0]) * torch.sin(math.pi * p[..., 1])
                   * torch.sin(math.pi * p[..., 2]))
    mass = P1ElementwiseOperator(sp, tforms.mass_form)
    x0 = sp.interpolate(u, sp.zeros(), tt.DoFType.DIRICHLET, bc)
    f = sp.interpolate(lambda p: 3 * math.pi ** 2 * u(p), sp.zeros(),
                       tt.DoFType.ALL, bc)
    b = sp.restore_rows(mass.apply_raw(f), sp.zeros(), tt.FLAG_INNER, bc)
    g = stack.gmg
    w = GeometricMultigridSolver(g.levels, g.coarse_solve, g.min_level,
                                 g.max_level, g.pre, g.post, CycleType.W)
    r0 = float(stack.residual_norm(x0, b))
    assert float(stack.residual_norm(w.solve(x0, b, 2), b)) < 1e-2 * r0
    # FMG from the coarsest level: rhs by restriction, full prolongation
    rhs = {g.max_level: b}
    for l in range(g.max_level, g.min_level, -1):
        rhs[l - 1] = g.levels[l].restrict(rhs[l])
    prol = {l: (lambda xc, l=l: g.levels[l + 1].prolongate_add(
                xc, x0 if l + 1 == g.max_level else stack.spaces[l + 1].zeros()))
            for l in range(g.min_level, g.max_level)}
    x = FullMultigridSolver(g, prol).solve(rhs, stack.spaces[0].zeros())
    assert float(stack.residual_norm(x, b)) < 0.2 * r0
