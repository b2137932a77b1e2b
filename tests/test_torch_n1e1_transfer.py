"""The N1E1 Whitney transfers of the PyTorch port
(operators/n1e1_transfer.py) against the JAX package on identical blocks,
and the Hiptmair-smoothed curl-curl V-cycle; mirrors
tests/test_n1e1_transfer.py.

Tolerances: the table exactly; prolongation and restriction to 1e-6 of
max|y| (f32 sums of up to ~40 weighted shifts in the same order); the
adjoint identity to 1e-4 relative and field reproduction to 1e-5 (the
JAX test's bounds); the V-cycle with the JAX test's rate gates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.functions.n1e1 import N1E1Space as JN1E1Space
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import n1e1_transfer as jtr
from hyteg_tpu.primitives.storage import CellStorage as JCellStorage
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.types import FLAG_INNER
from hyteg_tpu_torch.functions.n1e1 import N1E1Space
from hyteg_tpu_torch.mesh import meshinfo as mi
from hyteg_tpu_torch.operators import n1e1_transfer as ttr
from hyteg_tpu_torch.operators.n1e1_ops import N1E1ElementwiseOperator
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.solvers.hiptmair import HiptmairSmoother

from tests.test_torch_n1e1 import close, edge_block, t

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def storages():
    return (JCellStorage(jmi.mesh_unit_cube(1), num_shards=1),
            CellStorage(mi.mesh_unit_cube(1)))


def pair(storages, lc):
    js, ts = storages
    jc, jf = JN1E1Space(js, lc), JN1E1Space(js, lc + 1)
    tc, tf = (N1E1Space(ts, lc, device="cpu"),
              N1E1Space(ts, lc + 1, device="cpu"))
    return (jc, jf, jtr.N1E1Transfer(jc, jf)), (tc, tf, ttr.N1E1Transfer(tc, tf))


def test_table_matches():
    tab, jtab = ttr.whitney_stencil_table(), jtr.whitney_stencil_table()
    assert tab == jtab
    assert len(tab) == 4 ** 3 - 2 ** 3
    assert ttr._grouped_terms() == jtr._grouped_terms()


@pytest.mark.parametrize("lc", [0, 1])
def test_transfers_match(storages, lc):
    (jc, jf, jt), (tc, tf, tt) = pair(storages, lc)
    uc = edge_block(jc, 40 + lc, jc.edge_mask)
    close(tt.prolongate(t(uc)), jt.prolongate_local(jnp.asarray(uc)), 1e-6)
    close(tt.prolongate_and_add(t(uc), torch.ones(tf.block_shape)),
          jt.prolongate_and_add(jnp.asarray(uc), jnp.ones(jf.block_shape)),
          1e-6)
    rf = edge_block(jf, 50 + lc, jf.edge_mask)
    close(tt.restrict(t(rf)), jt.restrict(jnp.asarray(rf)), 1e-6)


def test_prolongation_preserves_fields(storages):
    """Constant fields and fields with constant curl (a + b x x) are
    reproduced: coarse-interpolate-then-prolongate = fine-interpolate."""
    _, (tc, tf, tt) = pair(storages, 1)
    a, b = torch.tensor([0.2, 0.1, -0.4]), torch.tensor([-0.3, 0.9, 0.5])
    for expr, ng in ((lambda p: torch.tensor([0.3, -0.7, 0.51]).expand(
            p.shape), 2), (lambda p: a + torch.linalg.cross(
            b.expand(p.shape), p, dim=-1), 4)):
        uf = tt.prolongate(tc.interpolate(expr, n_gauss=ng))
        want = tf.interpolate(expr, n_gauss=ng)
        assert float(((uf - want) * tf.edge_mask_t).abs().max()) < 1e-5


def test_restriction_is_transpose(storages):
    (jc, jf, _), (tc, tf, tt) = pair(storages, 1)
    uc = t(edge_block(jc, 3, jc.edge_mask))
    rf = t(edge_block(jf, 4, jf.edge_mask))
    lhs = float(tf.node_space.dot(tt.prolongate(uc), rf))
    rhs = float(tc.node_space.dot(uc, tt.restrict(rf)))
    assert abs(lhs - rhs) < 1e-4 * max(1.0, abs(lhs))


def hiptmair_rate(storage, max_level, alpha=1.0, beta=0.1, cycles=4,
                  seed=0):
    """tests/test_n1e1_transfer.py's V(2,2) cycle (30 Hiptmair sweeps on
    level 0) in the port: the mean residual rate over ``cycles`` cycles
    from x = 0 on a random consistent rhs."""
    spaces = {l: N1E1Space(storage, l, device="cpu")
              for l in range(max_level + 1)}
    ops = {l: N1E1ElementwiseOperator(spaces[l], alpha, beta) for l in spaces}
    sm = {l: HiptmairSmoother(ops[l]) for l in spaces}
    trs = {l: ttr.N1E1Transfer(spaces[l - 1], spaces[l])
           for l in range(1, max_level + 1)}

    def inner(l, y):
        return spaces[l].restore_rows(y, torch.zeros_like(y), FLAG_INNER)

    def cycle(x, b, l):
        if l == 0:
            return sm[0].smooth(x, b, num_sweeps=30)
        x = sm[l].smooth(x, b, num_sweeps=2)
        rc = inner(l - 1, trs[l].restrict(b - inner(l, ops[l].apply_raw(x))))
        ec = cycle(torch.zeros_like(rc), rc, l - 1)
        x = x + inner(l, trs[l].prolongate(ec))
        return sm[l].smooth(x, b, num_sweeps=2)

    sp = spaces[max_level]
    g = torch.Generator().manual_seed(seed)
    b = sp.exchange_rep(torch.randn(sp.block_shape, generator=g)
                        * sp.edge_mask_t)
    b = inner(max_level, b)

    def rn(x):
        r = b - inner(max_level, ops[max_level].apply_raw(x))
        return float(torch.sqrt(sp.dot(r, r)))

    x = torch.zeros_like(b)
    r0 = rn(x)
    for _ in range(cycles):
        x = cycle(x, b, max_level)
    return (rn(x) / r0) ** (1.0 / cycles)


def test_curlcurl_gmg_converges_mesh_independently(storages):
    """The JAX test's gates: rate(2) < 0.5 and rate(2) < max(2.5 rate(1),
    0.5)."""
    rates = [hiptmair_rate(storages[1], lv) for lv in (1, 2)]
    assert rates[-1] < 0.5, rates
    assert rates[1] < max(2.5 * rates[0], 0.5), rates
