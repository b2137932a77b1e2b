"""The P2 GMG stack of the PyTorch port (make_p2_gmg) against the JAX
package's on the same right-hand side, and the port's own P2 solves.

Both stacks run in float64 (the JAX package inside ``jax.enable_x64``)
with the same Chebyshev eigenvalue bounds, so that their residual
histories can be compared where float32 would already sit at its
rounding floor (the P2 V-cycle reaches it within three cycles here).
The right-hand side is a random block made consistent across interface
replicas (``exchange_rep``): a block with independent replicas holds a
part no V-cycle removes (ROADMAP C-ref7).

Tolerance: each of the first 4 residual norms within 1e-4 relative.
"""

import math

import jax
import jax.numpy as jnp
import pytest
import torch

from hyteg_tpu.solvers.templates import make_p2_gmg as jmake_p2_gmg
from hyteg_tpu_torch.core.types import BoundaryCondition, DoFType, FLAG_INNER
from hyteg_tpu_torch.operators.p2_elementwise import P2ElementwiseOperator
from hyteg_tpu_torch.solvers.templates import make_p1_gmg, make_p2_gmg

from tests.test_torch_p2 import _storages

torch.set_num_threads(1)


def _rhs(stack, seed, dtype=torch.float64):
    """A seeded random block on the tet, replicas made consistent, then
    restricted to the solved rows as bench_vcycle.py does."""
    sp = stack.space()
    g = torch.Generator().manual_seed(seed)
    b = torch.randn(sp.block_shape, generator=g, dtype=dtype)
    b = sp.exchange_rep(b * sp.vertex_mask_t.to(dtype))
    return stack.residual(torch.zeros_like(b), b)


@pytest.fixture(scope="module")
def stacks():
    """The port's float64 stack, the JAX package's with the port's eigs,
    and the JAX cycle, jitted once for both tests that use it."""
    js, ts = _storages("cube1")
    stack = make_p2_gmg(ts, 0, 2, coarse_iters=60, dtype=torch.float64,
                        device="cpu")
    with jax.enable_x64(True):
        jstack = jmake_p2_gmg(js, 0, 2, coarse_iters=60,
                              eigs=dict(stack.eigs), dtype=jnp.float64)
    return stack, jstack, jax.jit(jstack.gmg.cycle)


def _jax_norms(jstack, jcycle, b, cycles):
    """Residual norms of the JAX stack from 0 over ``cycles`` cycles."""
    with jax.enable_x64(True):
        jb = jnp.asarray(b.numpy())
        jx = jnp.zeros_like(jb)
        norms = [float(jstack.residual_norm(jx, jb))]
        for _ in range(cycles):
            jx = jcycle(jx, jb)
            norms.append(float(jstack.residual_norm(jx, jb)))
    return norms


def test_p2_gmg_matches_jax(stacks):
    stack, jstack, jcycle = stacks
    b = _rhs(stack, 0)
    x = torch.zeros_like(b)
    norms = [float(stack.residual_norm(x, b))]
    for _ in range(4):
        x = stack.gmg.cycle(x, b)
        norms.append(float(stack.residual_norm(x, b)))
    jnorms = _jax_norms(jstack, jcycle, b, 4)
    for r, jr in zip(norms[1:], jnorms[1:]):
        assert abs(r - jr) <= 1e-4 * jr, (norms, jnorms)


def test_rhs_with_disagreeing_replicas_stalls(stacks):
    """ROADMAP C-ref7: a random block whose interface replicas disagree
    (bench_vcycle.py's bench_p2 rhs) holds a part no V-cycle removes, in
    the port's stack and in the JAX package's alike; the same block made
    consistent first converges."""
    stack, jstack, jcycle = stacks
    sp = stack.space()
    g = torch.Generator().manual_seed(1)
    b0 = torch.randn(sp.block_shape, generator=g, dtype=torch.float64)
    b0 = b0 * sp.vertex_mask_t.to(torch.float64)
    for consistent in (False, True):
        b = stack.residual(torch.zeros_like(b0),
                           sp.exchange_rep(b0) if consistent else b0)
        x = torch.zeros_like(b)
        norms = [float(stack.residual_norm(x, b))]
        for _ in range(3):
            x = stack.gmg.cycle(x, b)
            norms.append(float(stack.residual_norm(x, b)))
        if consistent:
            assert norms[-1] < 1e-4 * norms[0], norms
        else:
            assert norms[-1] > 0.9 * norms[1] > 0.1 * norms[0], norms
            jnorms = _jax_norms(jstack, jcycle, b, 3)
            assert jnorms[-1] > 0.9 * jnorms[1] > 0.1 * jnorms[0], jnorms


def test_p2_gmg_converges_on_float32():
    """The stack as a user builds it (float32, power-iteration eigenvalue
    bounds): the manufactured Poisson problem of the JAX package's
    tests/test_p2_transfer.py, O(h^3) error."""
    _, ts = _storages("cube1")
    stack = make_p2_gmg(ts, 0, 2, smoother="chebyshev", coarse_iters=60,
                        device="cpu")
    sp, bc = stack.space(), BoundaryCondition.all_dirichlet()
    U = lambda p: (torch.sin(math.pi * p[..., 0]) * torch.sin(math.pi * p[..., 1])
                   * torch.sin(math.pi * p[..., 2]))
    mass = P2ElementwiseOperator(sp, "mass")
    x = sp.interpolate(U, sp.zeros(), DoFType.DIRICHLET, bc)
    f = sp.interpolate(lambda p: 3 * math.pi ** 2 * U(p), sp.zeros(),
                       DoFType.ALL, bc)
    b = sp.restore_rows(mass.apply_raw(f), sp.zeros(), FLAG_INNER, bc)
    norms = [float(stack.residual_norm(x, b))]
    for _ in range(5):
        x = stack.gmg.cycle(x, b)
        norms.append(float(stack.residual_norm(x, b)))
    assert norms[-1] < 1e-3 * norms[0], norms
    err = x - sp.interpolate(U, sp.zeros(), DoFType.ALL, bc)
    l2 = float(torch.sqrt(sp.dot(err, mass.apply_raw(err), DoFType.ALL, bc)))
    assert l2 < 5e-3, l2


def test_p2_stack_layout():
    _, ts = _storages("cube1")
    stack = make_p2_gmg(ts, 0, 2, smoother="jacobi", coarse_iters=5,
                        device="cpu")
    assert {l: stack.spaces[l].pitch for l in stack.spaces} == {
        0: 9, 1: 9, 2: 9}
    assert all(stack.gmg.levels[l].residual is None for l in stack.spaces)
    assert stack.eigs is None
    with pytest.raises(ValueError, match="space_kind"):
        make_p1_gmg(ts, 0, 1, device="cpu", space_kind="p3")
