"""The port's neighbour-wise interface exchange (one paired send per
edge-colouring round) against its all-reduce fallback and against the JAX
package's psum exchange, on 8 shards of mesh_unit_cube(2); and its round
tables against the JAX package's.

Tolerances: exchange_add 1e-5 (f32 sums of 2-8 replicas taken in another
order), exchange_rep exact (a copy of the representative's value); the
tables equal the JAX package's entry for entry.
"""

import jax
import numpy as np
import pytest
import torch

from hyteg_tpu.core import types as jt
from hyteg_tpu.functions.p1 import P1Space as JSpace
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.parallel import spmd as jspmd
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.types import BoundaryCondition
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.parallel.comm import LocalGroup
from hyteg_tpu_torch.primitives.storage import CellStorage

torch.set_num_threads(1)

BC = BoundaryCondition.all_dirichlet()
D = 8


@pytest.fixture(scope="module")
def spaces():
    st = CellStorage(tmi.mesh_unit_cube(2), num_shards=D)
    return {lv: P1Space(st, lv, device="cpu") for lv in (2, 3)}


@pytest.fixture(scope="module")
def jspaces():
    st = JStorage(jmi.mesh_unit_cube(2), num_shards=D)
    return {lv: JSpace(st, lv) for lv in (2, 3)}


def _x(sp):
    rng = np.random.default_rng(3)
    return rng.standard_normal((D * sp.C_loc, sp.N, sp.lanes)).astype(
        np.float32)


def _exchange(sp, x, kind, neighbor):
    grp = LocalGroup(D)
    parts = interop.shards_from_reference(x, D, device="cpu")

    def body(g, u):
        sd = sp.group_shard_data(g, BC, neighbor)
        fn = sp.exchange_add if kind == "add" else sp.exchange_rep
        return fn(u, sd)

    return interop.shards_to_reference(grp.run(body, parts))


@pytest.mark.parametrize("kind", ["add", "rep"])
def test_neighbor_exchange_matches_fallback(spaces, kind):
    sp = spaces[2]
    x = _x(sp)
    out_n = _exchange(sp, x, kind, True)
    out_p = _exchange(sp, x, kind, False)
    if kind == "add":
        np.testing.assert_allclose(out_n, out_p, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(out_n, out_p)


@pytest.mark.skipif(jax.device_count() < D, reason="needs 8 virtual devices")
@pytest.mark.parametrize("kind", ["add", "rep"])
def test_neighbor_exchange_matches_jax_psum(spaces, jspaces, kind):
    sp, jsp = spaces[2], jspaces[2]
    x = _x(sp)
    sd = jsp.stacked_shard_data(jt.BoundaryCondition.all_dirichlet(),
                                neighbor=False)
    dmesh = jspmd.device_mesh(jax.devices()[:D])

    def body(u, s):
        s = jspmd._squeeze_sd(s)
        fn = jsp.exchange_add if kind == "add" else jsp.exchange_rep
        return fn(u, s, axis_name=jspmd.AXIS)

    want = np.asarray(jax.jit(lambda u: jspmd.shard_map(
        body, mesh=dmesh, in_specs=(jspmd.P(jspmd.AXIS), jspmd._sd_specs(sd)),
        out_specs=jspmd.P(jspmd.AXIS), check_vma=False)(u, sd))(x))
    got = _exchange(sp, x, kind, True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("level", [2, 3])
def test_round_tables_equal_jax(spaces, jspaces, level):
    mine, ref = spaces[level]._nbr_tables, jspaces[level]._nbr_tables
    for a, b in zip(mine[:4], ref[:4]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert mine[4] == ref[4]


def test_neighbor_comm_volume_is_local(spaces):
    """Per apply a shard moves at most R * M values, below the global
    interface; every round is a partial matching (each shard at most once
    as source and destination), and each shard's rounds name a peer that
    names it back."""
    sp = spaces[3]
    slot_lid, L_max, pack, recv, perms = sp._nbr_tables
    R, M = pack.shape[1], pack.shape[2]
    assert R * M < sp.maps.num_ifc, (R, M, sp.maps.num_ifc)
    for perm in perms:
        srcs = [a for a, _ in perm]
        dsts = [b for _, b in perm]
        assert len(srcs) == len(set(srcs))
        assert len(dsts) == len(set(dsts))
    tables = [sp._rank_tables(d)[0] for d in range(D)]
    for d, nb in enumerate(tables):
        for r, rnd in enumerate(nb.rounds):
            if rnd is None:
                continue
            peer, pk, rv = rnd
            back = tables[peer].rounds[r]
            assert back is not None and back[0] == d
            assert pk.numel() == back[1].numel() <= M


def _replica_spread(sp, blocks):
    """max over global DoFs of (max - min) over every shard's replicas."""
    ids = np.concatenate([sp.global_ids(d).reshape(-1) for d in range(D)])
    vals = np.concatenate([b.numpy().reshape(-1) for b in blocks])
    sel = ids >= 0
    ids, vals = ids[sel], vals[sel]
    hi = np.full(sp.num_global_dofs(), -np.inf, dtype=np.float32)
    lo = np.full(sp.num_global_dofs(), np.inf, dtype=np.float32)
    np.maximum.at(hi, ids, vals)
    np.minimum.at(lo, ids, vals)
    return float((hi - lo).max())


@pytest.mark.parametrize("how", ["exchange_add", "overlapped_apply"])
def test_replicas_get_the_same_bits(how):
    """Every shard adds a shared DoF's partial sums in rank order, so its
    replicas on all shards hold the same bits after an additive exchange
    and after the overlapped apply (exact: no tolerance)."""
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator

    st = CellStorage(tmi.mesh_unit_cube(4), num_shards=D, partitioner="sfc")
    sp = P1Space(st, 2, device="cpu")
    rng = np.random.default_rng(5)
    parts = interop.shards_from_reference(
        rng.standard_normal((D * sp.C_loc, sp.N, sp.lanes)).astype(
            np.float32), D, device="cpu")
    parts = [p * sp.vertex_mask_t for p in parts]

    def body(g, u):
        sd = sp.group_shard_data(g, BC, True)
        if how == "exchange_add":
            return sp.exchange_add(u, sd)
        assert 0 < sd.ovl.K < u.shape[0]  # the apply splits
        op = P1ElementwiseOperator(sp, forms.laplace_form, shard=g.rank)
        return op.apply_raw(sp.exchange_rep(u, sd), sd=sd)

    out = LocalGroup(D).run(body, parts)
    assert _replica_spread(sp, out) == 0.0
