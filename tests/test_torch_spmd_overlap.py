"""The overlapped (interface cells first, interior cells while the
exchange is in flight) sharded apply of the port, against its plain
sharded apply, against the JAX package's overlapped apply, and its overlap
tables against the JAX package's: 4 SFC shards of mesh_unit_cube(3), where
three shards hold interior cells (on mesh_unit_cube(2) every cell of a
shard touches the interface, and the apply does not split).

The interface sub-block goes through the same kernel wrappers (B2 without
a coefficient, B4 with one) as a whole block, with those cells' tables.
Tolerances: the overlapped apply equals the port's plain neighbour-
exchange apply exactly (the same sums in the same order), and the
all-reduce fallback and the JAX package's apply to 2e-5 (f32 sums taken in
another order); the tables equal the JAX package's entry for entry.
"""

import jax
import numpy as np
import pytest
import torch

from hyteg_tpu.core import types as jt
from hyteg_tpu.functions.p1 import P1Space as JSpace
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import forms as jforms
from hyteg_tpu.operators.p1_elementwise import P1ElementwiseOperator as JOp
from hyteg_tpu.parallel import spmd as jspmd
from hyteg_tpu.primitives import loadbalancing as jlb
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.types import BoundaryCondition
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.operators import forms
from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
from hyteg_tpu_torch.parallel.comm import LocalGroup
from hyteg_tpu_torch.primitives.storage import CellStorage

torch.set_num_threads(1)

BC = BoundaryCondition.all_dirichlet()
D = 4


@pytest.fixture(scope="module")
def sp():
    return P1Space(CellStorage(tmi.mesh_unit_cube(3), num_shards=D,
                               partitioner="sfc"), 2, device="cpu")


def _jspace():
    return JSpace(jlb.make_storage(jmi.mesh_unit_cube(3), D, "sfc"), 2)


def _x(sp, seed=11):
    return np.random.default_rng(seed).standard_normal(
        (D * sp.C_loc, sp.N, sp.lanes)).astype(np.float32)


def test_overlap_tables_cover_cells(sp):
    jsp = _jspace()
    mine, ref = sp._ovl_tables, jsp._ovl_tables
    for a, b in zip(mine[:3], ref[:3]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert mine[3] == ref[3]
    ovl_cells, ovl_flat, ovl_lid, K = mine
    assert 0 < K <= sp.C_loc
    slot_lid, L_max, pack, recv, perms = sp._nbr_tables
    cell_sz = sp.block_size // sp.C_loc
    for d in range(D):
        assert sorted(ovl_cells[d]) == list(range(sp.C_loc))
        nb, ov = sp._rank_tables(d)
        assert sorted(ov.cells.tolist()) == list(range(sp.C_loc))
        # every packed local id is fed by a slot of the first K cells
        packed = set(pack[d].reshape(-1).tolist()) - {L_max}
        assert packed <= set(ov.slot_lid.tolist())
        assert int(ov.slot_flat.max()) < ov.K * cell_sz
    assert sum(sp._rank_tables(d)[1].K < sp.C_loc for d in range(D)) >= 2


def _apply(sp, x, neighbor, coeff=None):
    grp = LocalGroup(D)
    parts = interop.shards_from_reference(x, D, device="cpu")
    cparts = [None] * D if coeff is None else interop.shards_from_reference(
        coeff, D, device="cpu")

    def body(g, u, k):
        sd = sp.group_shard_data(g, BC, neighbor)
        op = P1ElementwiseOperator(sp, forms.laplace_form, shard=g.rank)
        return op.apply_raw(u, coeff=k, sd=sd)

    return interop.shards_to_reference(grp.run(body, parts, cparts))


def test_overlapped_apply_matches_plain(sp, monkeypatch):
    x = _x(sp)
    over = _apply(sp, x, True)
    fallback = _apply(sp, x, False)
    np.testing.assert_allclose(over, fallback, rtol=2e-5, atol=2e-5)
    # the same sums without the split: drop the overlap tables
    real = sp._rank_tables
    monkeypatch.setattr(sp, "_rank_tables",
                        lambda d: (real(d)[0], None))
    sp._sd_cache.clear()
    try:
        plain = _apply(sp, x, True)
    finally:
        monkeypatch.undo()
        sp._sd_cache.clear()
    np.testing.assert_array_equal(over, plain)


def test_overlapped_apply_with_coefficient(sp):
    """B4's path: the sub-blocks carry their cells' element matrices and
    coefficient."""
    x = _x(sp)
    k = 1.0 + np.abs(_x(sp, seed=5))
    np.testing.assert_allclose(_apply(sp, x, True, k),
                               _apply(sp, x, False, k),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.skipif(jax.device_count() < D, reason="needs 4 virtual devices")
def test_overlapped_apply_matches_jax(sp):
    jsp = _jspace()
    sd = jsp.stacked_shard_data(jt.BoundaryCondition.all_dirichlet(),
                                neighbor=True)
    dmesh = jspmd.device_mesh(jax.devices()[:D])

    def body(u, s):
        s = jspmd._squeeze_sd(s)
        op = JOp.from_shard_data(jsp, jforms.laplace_form, s)
        return op.apply_raw(u, sd=s, axis_name=jspmd.AXIS)

    x = _x(sp)
    want = np.asarray(jax.jit(lambda u: jspmd.shard_map(
        body, mesh=dmesh, in_specs=(jspmd.P(jspmd.AXIS), jspmd._sd_specs(sd)),
        out_specs=jspmd.P(jspmd.AXIS), check_vma=False)(u, sd))(x))
    np.testing.assert_allclose(_apply(sp, x, True), want, rtol=2e-5,
                               atol=2e-5)
