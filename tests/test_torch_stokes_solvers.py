"""(F)GMRES, GKB, the global DoF numbering, the sparse assembly and the
direct solve of the PyTorch port against the JAX package's
(hyteg_tpu/solvers/gmres.py, functions/p1.py global_ids, io/sparse.py).

GMRES runs on tests/test_solvers.py's Poisson set-up (P1 Laplace on
mesh_unit_cube(1) at level 2, b = M f, Dirichlet data in x0), without and
with a Jacobi preconditioner; GKB on the 2D Taylor-Hood composite
(mesh_rectangle 2 x 2, P2 level 2) with 60 fixed CG steps on K as the
inner solve in both packages. The JAX side runs as its own CPU tests run
it; its b and x0 are carried over as numpy.

Tolerances: GMRES the same count of restarts and x within 1e-4 *
max|x| (float32, 40 Arnoldi steps per restart); GKB u and p within 1e-3 *
max and its last |z| within 1e-2 relative (float32, inexact inner
solves); global ids and CSR sparsity exact;
CSR values within 1e-6 of the largest entry; direct solves within 1e-5 *
max|x| (the same float64 LU on the same matrix, blocks in float32).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.core.types import FLAG_INNER as JFLAG_INNER
from hyteg_tpu.functions.p1 import P1Space as JP1Space
from hyteg_tpu.functions.p2 import P2Space as JP2Space
from hyteg_tpu.io import sparse as jsparse
from hyteg_tpu.operators import forms as jforms
from hyteg_tpu.operators.p1_elementwise import P1ElementwiseOperator as JP1Op
from hyteg_tpu.operators.p2_elementwise import P2ElementwiseOperator as JP2Op
from hyteg_tpu.solvers import gmres as jgmres
from hyteg_tpu.solvers.krylov import cg_solve_fixed as jcg_fixed
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.types import BoundaryCondition, DoFType, FLAG_INNER
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.functions.p2 import P2Space
from hyteg_tpu_torch.io import sparse
from hyteg_tpu_torch.operators import forms
from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
from hyteg_tpu_torch.operators.p2_elementwise import P2ElementwiseOperator
from hyteg_tpu_torch.solvers.gmres import fgmres_solve, gkb_solve
from hyteg_tpu_torch.solvers.krylov import cg_solve_fixed

from tests.test_solvers import F, U, _poisson_setup
from tests.test_torch_stokes import (assert_close, composites, rand_vec,
                                     storages)

torch.set_num_threads(1)


# -- (F)GMRES on the Poisson set-up -------------------------------------------


@functools.lru_cache(maxsize=None)
def poisson():
    """(JAX set-up, the port's space / bc / Laplace, b, x0 as tensors)."""
    js, ts = storages("cube")
    jset = _poisson_setup(js, 2, U, F)
    jsp, _, _, _, jx, jb = jset
    sp = P1Space(ts, 2, device="cpu")
    bc = BoundaryCondition.all_dirichlet()
    lap = P1ElementwiseOperator(sp, forms.laplace_form)
    b = interop.block_from_reference(np.asarray(jb), device="cpu")
    x0 = interop.block_from_reference(np.asarray(jx.cells), device="cpu")
    return jset, (sp, bc, lap, b, x0)


@pytest.mark.parametrize("precondition", [False, True],
                         ids=["plain", "jacobi"])
def test_fgmres_poisson(precondition):
    (jsp, jbc, jlap, _, jx, jb), (sp, bc, lap, b, x0) = poisson()
    apply_fn = lambda v: lap.apply_inner(v, bc)
    dot_fn = lambda u, v: sp.dot(u, v, FLAG_INNER, bc)
    invd = lap.inverse_diagonal()
    x, res, k = fgmres_solve(apply_fn, dot_fn, b, x0, restart=40,
                             max_restarts=5, rtol=1e-6,
                             prec_fn=(lambda r: invd * r) if precondition
                             else None)
    jinvd = jlap.inverse_diagonal()
    jxs, jres, jk = jgmres.fgmres_solve(
        lambda v: jlap.apply_inner(v, jbc),
        lambda u, v: jsp.dot(u, v, JFLAG_INNER, jbc), jb, jx.cells,
        restart=40, max_restarts=5, rtol=1e-6,
        prec_fn=(lambda r: jinvd * r) if precondition else None)
    assert k == int(jk) and k < 5, (k, int(jk))
    assert_close(x, jxs, 1e-4, "fgmres x")
    r = b - apply_fn(x)
    assert float(torch.sqrt(dot_fn(r, r))) < 1e-5 * float(
        torch.sqrt(dot_fn(b, b)))
    assert float(res) <= 1e-6 * float(torch.sqrt(dot_fn(b, b)))


# -- GKB on the Stokes composite ----------------------------------------------


def _gkb_ops(st, jax_side: bool):
    """The callables of gkb_solve for one composite: K, B (div, exchanged),
    B^T (gradient, exchanged, Dirichlet rows 0), a 60-step CG on K."""
    if jax_side:  # velocity as one stacked (dim, ...) array
        vsp, psp = st.vel_space, st.pre_space

        def rows(ys):
            return jnp.stack([vsp.restore_rows(y, jnp.zeros_like(y),
                                               JFLAG_INNER, st._vel_sd)
                              for y in ys])

        def apply_K(u):
            return rows(st.apply_K(tuple(u)))

        def apply_B(u):
            return psp.exchange_add(st.B.apply_div_local(tuple(u)),
                                    st._pre_sd)

        def apply_Bt(p):
            return rows(vsp.exchange_add(
                st.B.apply_gradient_component_local(p, d), st._vel_sd)
                for d in range(st.dim))

        def dot_u(u, v):
            return sum(vsp.dot(u[d], v[d], JFLAG_INNER, st._vel_sd)
                       for d in range(st.dim))

        def inner(rhs):
            return jcg_fixed(apply_K, dot_u, rhs, jnp.zeros_like(rhs), 60)

        def dot_p(p, q):
            return psp.dot(p, q, JFLAG_INNER, st._pre_sd)
    else:
        def apply_K(u):
            return st._restore_vel_(st.apply_K(u), None, FLAG_INNER)

        def apply_B(u):
            return st.pre_space._exchange_add_(st.B.apply_div_local(
                u.unbind(0)), st._pre_sd)

        def apply_Bt(p):
            return st._restore_vel_(st._exchange_vel_(
                st.B.apply_gradient_local(p)), None, FLAG_INNER)

        def dot_u(u, v):
            return sum(st.vel_space.dot(u[d], v[d], FLAG_INNER, st._vel_sd)
                       for d in range(st.dim))

        def inner(rhs):
            return cg_solve_fixed(apply_K, dot_u, rhs, torch.zeros_like(rhs),
                                  60)

        def dot_p(p, q):
            return st.pre_space.dot(p, q, FLAG_INNER, st._pre_sd)
    return apply_K, apply_B, apply_Bt, inner, dot_u, dot_p


def test_gkb_stokes():
    js, ts = composites("rect", 2)
    f = rand_vec(ts, 30).vel
    g = torch.zeros(ts.pre_space.block_shape)
    u, p, k, res = gkb_solve(*_gkb_ops(ts, False), f, g, None, None,
                             max_iter=8, tol=0.0)
    jf = jnp.asarray(f.numpy())
    ju, jp, jk, jres = jax.jit(lambda f, g: jgmres.gkb_solve(
        *_gkb_ops(js, True), f, g, None, None, max_iter=8, tol=0.0))(
            jf, jnp.asarray(g.numpy()))
    assert k == int(jk) == 8
    for d in range(ts.dim):
        assert_close(u[d], ju[d], 1e-3, f"gkb u[{d}]")
    assert_close(p, jp, 1e-3, "gkb p")
    assert abs(float(res) - float(jres)) <= 1e-2 * float(jres)


# -- global ids and sparse assembly ---------------------------------------------


ID_CASES = [("rect", 1, None), ("rect", 2, None), ("cube", 1, None),
            ("cube", 2, None), ("cube", 1, 9)]
ID_IDS = [f"{m}-{lv}-pitch{p}" for m, lv, p in ID_CASES]


@pytest.mark.parametrize("name,level,pitch", ID_CASES, ids=ID_IDS)
def test_global_ids(name, level, pitch):
    js, ts = storages(name)
    for jsp, sp in ((JP1Space(js, level, pitch=pitch),
                     P1Space(ts, level, device="cpu", pitch=pitch)),
                    (JP2Space(js, level, pitch=pitch),
                     P2Space(ts, level, device="cpu", pitch=pitch))):
        ids = sp.global_ids(0)
        assert np.array_equal(ids, np.asarray(jsp.global_ids(0)))
        assert np.array_equal(sp.global_ids_grid(0),
                              np.asarray(jsp.global_ids_grid(0)))
        # every global DoF appears, and only on valid positions
        assert set(np.unique(ids[ids >= 0])) == set(
            range(sp.num_global_dofs()))
        assert not (ids[:, ~sp.vertex_mask] >= 0).any()


def _csr_equal(A, jA):
    A, jA = A.copy(), jA.copy()
    for M in (A, jA):
        M.sum_duplicates()
        M.sort_indices()
    assert A.shape == jA.shape
    assert np.array_equal(A.indptr, jA.indptr)
    assert np.array_equal(A.indices, jA.indices)
    assert_close(A.data, jA.data, 1e-6, "csr values")


ASM_CASES = [(m, lv, k) for m in ("rect", "cube") for lv in (1, 2)
             for k in ("laplace", "mass")]
ASM_IDS = [f"{m}-{lv}-{k}" for m, lv, k in ASM_CASES]


@pytest.mark.parametrize("name,level,kind", ASM_CASES, ids=ASM_IDS)
def test_assemble_p1_csr(name, level, kind):
    js, ts = storages(name)
    form = forms.laplace_form if kind == "laplace" else forms.mass_form
    jform = jforms.laplace_form if kind == "laplace" else jforms.mass_form
    op = P1ElementwiseOperator(P1Space(ts, level, device="cpu"), form)
    jop = JP1Op(JP1Space(js, level), jform)
    A = sparse.assemble_p1_csr(op)
    _csr_equal(A, jsparse.assemble_p1_csr(jop))
    # the matrix applies as the operator does
    rng = np.random.default_rng(31)
    v = rng.standard_normal(A.shape[0])
    ids = op.space.global_ids(0)
    blk = np.zeros(ids.shape)
    blk[ids >= 0] = v[ids[ids >= 0]]
    y = op.apply_raw(torch.tensor(blk, dtype=torch.float32)).numpy()
    assert_close(y[ids >= 0], (A @ v)[ids[ids >= 0]], 1e-5, "A v")


@pytest.mark.parametrize("name,level,kind", ASM_CASES, ids=ASM_IDS)
def test_assemble_p2_csr(name, level, kind):
    js, ts = storages(name)
    op = P2ElementwiseOperator(P2Space(ts, level, device="cpu"), kind)
    jop = JP2Op(JP2Space(js, level), kind)
    A = sparse.assemble_p2_csr(op)
    _csr_equal(A, jsparse.assemble_p2_csr(jop))
    Ad = A.toarray()
    assert np.allclose(Ad, Ad.T, atol=1e-6 * np.abs(Ad).max())


@pytest.mark.parametrize("kind", ["p1", "p2"])
def test_direct_coarse_solver(kind):
    js, ts = storages("cube")
    bc = BoundaryCondition.all_dirichlet()
    if kind == "p1":
        sp, jsp = P1Space(ts, 2, device="cpu"), JP1Space(js, 2)
        op = P1ElementwiseOperator(sp, forms.laplace_form)
        jop = JP1Op(jsp, jforms.laplace_form)
    else:
        sp, jsp = P2Space(ts, 1, device="cpu"), JP2Space(js, 1)
        op, jop = P2ElementwiseOperator(sp, "laplace"), JP2Op(jsp, "laplace")
    solver = sparse.DirectCoarseSolver(op, bc, kind=kind)
    jsolver = jsparse.DirectCoarseSolver(jop, None, kind=kind)
    rng = np.random.default_rng(32)
    b = sp.exchange_rep(torch.tensor(rng.standard_normal(sp.block_shape),
                                     dtype=torch.float32) * sp.vertex_mask_t)
    b = sp.restore_rows(b, torch.zeros_like(b), FLAG_INNER)
    x = solver(b)
    assert_close(x, jsolver(jnp.asarray(b.numpy())), 1e-5, "direct x")
    r = b - op.apply_inner(x, bc)
    assert float(torch.sqrt(sp.dot(r, r, FLAG_INNER))) < 1e-5 * float(
        torch.sqrt(sp.dot(b, b, FLAG_INNER)))
    # x0's Dirichlet rows are kept
    x0 = sp.interpolate(lambda p: 1.0 + p[..., 0], sp.zeros(), DoFType.ALL)
    x1 = solver(b, x0)
    dirichlet = sp.restore_rows(torch.zeros_like(x0), x0, FLAG_INNER)
    assert torch.equal(sp.restore_rows(torch.zeros_like(x1), x1, FLAG_INNER),
                       dirichlet)


def test_dirichlet_reduced():
    js, ts = storages("rect")
    op = P1ElementwiseOperator(P1Space(ts, 2, device="cpu"),
                               forms.laplace_form)
    A = sparse.assemble_p1_csr(op)
    inner = np.arange(A.shape[0]) % 3 != 0
    Ar, idx = sparse.dirichlet_reduced(A, inner)
    jAr, jidx = jsparse.dirichlet_reduced(A, inner)
    assert np.array_equal(idx, jidx)
    assert np.array_equal(Ar.toarray(), jAr.toarray())
    assert np.array_equal(Ar.toarray(), A.toarray()[np.ix_(idx, idx)])
