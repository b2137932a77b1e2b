"""The N1E1 (Nedelec) and edge-DoF spaces, the curl-curl / mass operator
and the Hiptmair smoother of the PyTorch port (functions/{n1e1,edgedof}.py,
operators/n1e1_ops.py, solvers/hiptmair.py) against the JAX package on
identical inputs; mirrors tests/test_n1e1.py.

Tolerances: tables and signs exactly; the gradient and its transpose
exactly (differences of +-1-weighted reads); interpolation, element
matrices, applies and diagonals to 1e-5 of max|y| (f32, the 6-term
element products as a batched matmul where the JAX package sums term by
term); the Hiptmair damping factors to 1e-4 relative (15 f32 power
iterations from the same seed field, whose sin the two libraries round
alike to an ulp); one Hiptmair sweep to 1e-4 of max|x|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.core.types import BoundaryCondition as JBC
from hyteg_tpu.functions import n1e1 as jn1
from hyteg_tpu.functions.edgedof import EdgeDoFSpace as JEdgeDoFSpace
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import n1e1_ops as jops
from hyteg_tpu.primitives.storage import CellStorage as JCellStorage
from hyteg_tpu.solvers import hiptmair as jhip
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.types import BoundaryCondition, DoFType, FLAG_INNER
from hyteg_tpu_torch.functions import n1e1 as tn1
from hyteg_tpu_torch.functions.edgedof import EdgeDoFFunction, EdgeDoFSpace
from hyteg_tpu_torch.functions.n1e1 import N1E1Function, N1E1Space
from hyteg_tpu_torch.mesh import meshinfo as mi
from hyteg_tpu_torch.operators import n1e1_ops
from hyteg_tpu_torch.operators.n1e1_ops import N1E1ElementwiseOperator
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.solvers import hiptmair
from hyteg_tpu_torch.solvers.krylov import cg_solve

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def storages():
    return (JCellStorage(jmi.mesh_unit_cube(1), num_shards=1),
            CellStorage(mi.mesh_unit_cube(1)))


def spaces(storages, level):
    js, ts = storages
    return jn1.N1E1Space(js, level), N1E1Space(ts, level, device="cpu")


def t(a):
    return interop.block_from_reference(np.asarray(a), device="cpu")


def close(got, want, rtol, atol=0.0):
    want = np.asarray(want)
    d = np.abs(interop.block_to_numpy(got) - want).max()
    assert d <= rtol * max(np.abs(want).max(), 1e-30) + atol, d


def edge_block(jsp, seed, mask):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(jsp.block_shape) * mask[None]).astype(np.float32)
    return np.asarray(jsp.node_space.exchange_rep(jnp.asarray(x)))


def test_tables_and_signs_match(storages):
    for a, b in zip(tn1.edge_tables(3), jn1.edge_tables(3)):
        np.testing.assert_array_equal(a, b)
    jsp, tsp = spaces(storages, 1)
    np.testing.assert_array_equal(tsp.parity_signs(0), jsp.parity_signs(0))
    np.testing.assert_array_equal(tsp.edge_signs(0), jsp.edge_signs(0))
    np.testing.assert_array_equal(tsp.parity_masks, jsp.parity_masks)
    np.testing.assert_array_equal(tsp.vertexnode_mask, jsp.vertexnode_mask)
    assert tsp.num_global_dofs() == jsp.num_global_dofs()


@pytest.mark.parametrize("level", [1, 2])
def test_gradient_and_transpose_match(storages, level):
    jsp, tsp = spaces(storages, level)
    p = edge_block(jsp, level, jsp.vertexnode_mask)
    close(tsp.gradient_apply(t(p)), jsp.gradient_apply(jnp.asarray(p)), 0)
    r = edge_block(jsp, 10 + level, jsp.edge_mask)
    close(tsp.gradient_transpose_apply(t(r)),
          jsp.gradient_transpose_apply(jnp.asarray(r)), 1e-7)


@pytest.mark.parametrize("n_gauss", [1, 2])
def test_interpolate_matches(storages, n_gauss):
    jsp, tsp = spaces(storages, 2)
    a, b = np.array([0.2, 0.1, -0.4]), np.array([-0.3, 0.9, 0.5])
    jw = jsp.interpolate(lambda p: jnp.asarray(a) + jnp.cross(
        jnp.broadcast_to(jnp.asarray(b), p.shape), p), n_gauss=n_gauss)
    tw = tsp.interpolate(lambda p: torch.as_tensor(a, dtype=p.dtype)
                         + torch.linalg.cross(torch.as_tensor(
                             b, dtype=p.dtype).expand(p.shape), p, dim=-1),
                         n_gauss=n_gauss)
    close(tw, jw, 1e-5)


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (0.0, 1.0), (1.0, 0.1)])
@pytest.mark.parametrize("level", [1, 2])
def test_operator_matches(storages, level, alpha, beta):
    jsp, tsp = spaces(storages, level)
    jop = jops.N1E1ElementwiseOperator(jsp, alpha, beta)
    top = N1E1ElementwiseOperator(tsp, alpha, beta)
    close(top.elmats, jop.elmats, 1e-5)
    close(top.elmats_unsigned, jop._elmats_unsigned, 1e-5)
    x = edge_block(jsp, 20 + level, jsp.edge_mask)
    close(top.apply_raw(t(x)), jop.apply_raw(jnp.asarray(x)), 1e-5)
    close(top.diagonal_raw(), jop.diagonal_raw(), 1e-5)
    close(top.inverse_diagonal(), jop.inverse_diagonal(), 1e-5)
    if alpha:
        close(top.potential_inverse_diagonal(),
              jop.potential_inverse_diagonal(), 1e-5)
    y = top.apply(N1E1Function(t(x), tsp, BoundaryCondition.all_dirichlet()),
                  tsp.function())
    jy = jsp.restore_rows(jop.apply_raw(jnp.asarray(x)), jsp.zeros(),
                          FLAG_INNER, jsp.resolve_sd(JBC.all_dirichlet()))
    close(y.cells, jy, 1e-5)


def test_curlcurl_kills_gradients(storages):
    jsp, tsp = spaces(storages, 1)
    op = N1E1ElementwiseOperator(tsp, alpha=1.0, beta=0.0)
    p = t(edge_block(jsp, 3, jsp.node_space.vertex_mask))
    gp = tsp.gradient_apply(p)
    y = op.apply_raw(gp)
    assert float(y.abs().max()) < 1e-4 * (float(gp.abs().max()) + 1.0)


def test_mass_energy_of_constant_field(storages):
    _, tsp = spaces(storages, 2)
    mass = N1E1ElementwiseOperator(tsp, alpha=0.0, beta=1.0)
    c = torch.tensor([0.4, -0.2, 0.9])
    e = tsp.interpolate(lambda x: c.expand(x.shape))
    energy = float(tsp.dot(e, mass.apply_raw(e)))
    assert np.isclose(energy, float((c * c).sum()), rtol=2e-2)


def test_varying_seed_matches():
    shape = (6, 5, 25)
    np.testing.assert_allclose(
        hiptmair._varying_seed(shape, "cpu").numpy(),
        np.asarray(jhip._varying_seed(shape)), rtol=0, atol=2e-7)


@pytest.mark.parametrize("level", [1, 2])
def test_hiptmair_matches(storages, level):
    """Both damping factors from the power iterations, then one
    multiplicative sweep and the additive preconditioner on the same
    inputs."""
    jsp, tsp = spaces(storages, level)
    jop = jops.N1E1ElementwiseOperator(jsp, 1.0, 0.1)
    top = N1E1ElementwiseOperator(tsp, 1.0, 0.1)
    jh, th = jhip.HiptmairSmoother(jop), hiptmair.HiptmairSmoother(top)
    assert th.omega_e == pytest.approx(jh.omega_e, rel=1e-4)
    assert th.omega_v == pytest.approx(jh.omega_v, rel=1e-4)
    sd = jsp.resolve_sd(None)
    b = edge_block(jsp, 30 + level, jsp.edge_mask)
    b = np.asarray(jsp.restore_rows(jnp.asarray(b), jsp.zeros(), FLAG_INNER,
                                    sd))
    ref = np.asarray(jh.smooth(jsp.zeros(), jnp.asarray(b), num_sweeps=2))
    close(th.smooth(tsp.zeros(), t(b), num_sweeps=2), ref, 1e-4)
    ref = np.asarray(jh.as_preconditioner()(jnp.asarray(b)))
    close(th.as_preconditioner()(t(b)), ref, 1e-5)


def test_hiptmair_beats_jacobi(storages):
    """CG on curlcurl + mass preconditioned by Hiptmair against Jacobi
    (the JAX test's gates: < 2e-4 of |b| and < 0.02 x Jacobi's at 50
    steps)."""
    jsp, sp = spaces(storages, 2)
    sd = sp.resolve_sd(BoundaryCondition.all_dirichlet())
    op = N1E1ElementwiseOperator(sp, alpha=1.0, beta=1.0)
    hipt = hiptmair.HiptmairSmoother(op, sd)
    b = t(edge_block(jsp, 11, jsp.edge_mask))
    zeros = torch.zeros_like(b)
    b = sp.restore_rows(b, zeros, FLAG_INNER, sd)

    def apply_inner(x):
        return sp.restore_rows(op.apply_raw(x, sd), zeros, FLAG_INNER, sd)

    dot = lambda u, v: sp.dot(u, v, DoFType.ALL, sd)
    inv_d = sp.restore_rows(op.inverse_diagonal(sd), zeros, FLAG_INNER, sd)
    x_j = cg_solve(apply_inner, dot, b, zeros, 50, rtol=1e-12,
                   prec_fn=lambda r: inv_d * r).x
    x_h = cg_solve(apply_inner, dot, b, zeros, 50, rtol=1e-12,
                   prec_fn=hipt.as_preconditioner()).x
    res = lambda x: float(torch.sqrt(dot(b - apply_inner(x),
                                         b - apply_inner(x))))
    r_j, r_h, b0 = res(x_j), res(x_h), float(torch.sqrt(dot(b, b)))
    assert r_h < 2e-4 * b0
    assert r_h < 0.02 * max(r_j, 1e-30)


def test_edgedof_space_matches(storages):
    js, ts = storages
    jed, ted = JEdgeDoFSpace(js, 1), EdgeDoFSpace(ts, 1, device="cpu")
    assert ted.num_global_dofs() == jed.num_global_dofs()
    assert ted.num_global_dofs() == N1E1Space(ts, 1, device="cpu").num_global_dofs()
    np.testing.assert_array_equal(ted.orientation_masks, jed.orientation_masks)
    assert np.array_equal(ted.orientation_masks.any(0), ted.edge_mask)
    u = ted.interpolate(1.0)
    assert np.isclose(float(ted.dof_sum(u)), ted.num_global_dofs(), rtol=1e-5)
    f = lambda p: p[..., 0] * 2.0 - p[..., 2]
    close(ted.interpolate(f), jed.interpolate(f), 1e-6)
    x = edge_block(jn1.N1E1Space(js, 1), 4, jed.edge_mask)
    assert float(ted.dot(t(x), t(x))) == pytest.approx(
        float(jed.dot(jnp.asarray(x), jnp.asarray(x))), rel=1e-5)
    fn = EdgeDoFFunction(t(x), ted, BoundaryCondition.all_dirichlet())
    assert float(fn.sum_global()) == pytest.approx(
        float(jed.dof_sum(jnp.asarray(x))), rel=1e-4, abs=1e-4)
