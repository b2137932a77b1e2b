"""The port's load balancers and cell migration against the JAX
package's: partitions equal cell for cell, the SFC partition cuts fewer
interface DoFs than round robin, and migration round-trips (exactly: a
migration only moves blocks)."""

import numpy as np
import pytest
import torch

from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.primitives import loadbalancing as jlb
from hyteg_tpu_torch.core.types import BoundaryCondition, DoFType
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.primitives import loadbalancing as lb
from hyteg_tpu_torch.primitives.storage import CellStorage

torch.set_num_threads(1)

MESHES = {"cube2": (tmi.mesh_unit_cube, jmi.mesh_unit_cube, (2,)),
          "shell": (tmi.mesh_spherical_shell, jmi.mesh_spherical_shell,
                    (2, 2, 0.55, 1.0)),
          "annulus": (tmi.mesh_annulus, jmi.mesh_annulus, (0.55, 1.0, 8, 2))}


def _meshes(name):
    t, j, args = MESHES[name]
    return t(*args), j(*args)


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("shards", [2, 4, 6])
def test_partitions_equal_jax(name, shards):
    tm, jm = _meshes(name)
    np.testing.assert_array_equal(lb.morton_codes(lb.cell_centroids(tm)),
                                  jlb.morton_codes(
                                      jm.points[jm.elements].mean(axis=1)))
    for method in ("sfc", "greedy_volume", "round_robin", "contiguous"):
        mine = lb.make_storage(tm, shards, method)
        ref = jlb.make_storage(jm, shards, method)
        np.testing.assert_array_equal(mine.cell_global_index,
                                      ref.cell_global_index)
        np.testing.assert_array_equal(mine.cell_valid, ref.cell_valid)
        assert mine.cells_per_shard == ref.cells_per_shard
    np.testing.assert_array_equal(
        lb.partition_sfc(lb.cell_centroids(tm), shards),
        jlb.partition_sfc(jm.points[jm.elements].mean(axis=1), shards))
    np.testing.assert_array_equal(
        lb.partition_greedy(shards, lb.cell_volumes(tm)),
        jlb.partition_greedy(shards, jlb.cell_volumes(jm)))


def test_sfc_beats_round_robin_on_cut():
    mesh, jmesh = _meshes("cube2")
    rr = CellStorage(mesh, num_shards=4, partitioner="round_robin")
    sfc = CellStorage(mesh, num_shards=4, partitioner="sfc")
    assert lb.interface_cut(sfc, 2) < lb.interface_cut(rr, 2)
    assert lb.interface_cut(sfc, 2) == jlb.interface_cut(
        jlb.make_storage(jmesh, 4, "sfc"), 2)


def test_partitions_balanced():
    mesh, _ = _meshes("cube2")
    for nshards in (2, 4, 6):
        a = lb.partition_sfc(lb.cell_centroids(mesh), nshards)
        counts = np.bincount(a, minlength=nshards)
        assert counts.min() >= 1
        assert counts.max() - counts.min() <= max(2, len(a) // nshards // 2)
        w = lb.cell_volumes(mesh)
        g = lb.partition_greedy(nshards, w)
        loads = np.bincount(g, weights=w, minlength=nshards)
        assert loads.max() < 1.5 * loads.min() + 1e-12


def test_migration_round_trips():
    """round robin -> SFC -> round robin gives the blocks back bit for
    bit, and the migrated field equals the one interpolated on the new
    layout."""
    mesh, _ = _meshes("cube2")
    old = CellStorage(mesh, num_shards=3, partitioner="round_robin")
    new = lb.make_storage(mesh, 3, "sfc")
    there, back = lb.migrate(old, new), lb.migrate(new, old)
    expr = lambda p: 1.0 + p[..., 0] * 2 + p[..., 1] - 0.3 * p[..., 2]
    bc = BoundaryCondition.all_dirichlet()

    def whole(st):
        sp = P1Space(st, 2, device="cpu")
        return sp.interpolate(expr, torch.zeros((st.num_cells, sp.N,
                                                 sp.lanes)),
                              DoFType.ALL, sp.global_shard_data(bc))

    u_old, u_new = whole(old), whole(new)
    u_there = there.migrate_cellwise(u_old)
    torch.testing.assert_close(u_there, u_new, atol=1e-5, rtol=0)
    valid = torch.as_tensor(old.cell_valid)
    torch.testing.assert_close(back.migrate_cellwise(u_there)[valid],
                               u_old[valid], atol=0, rtol=0)
    assert (there.src_slot >= 0).sum() == old.topo.num_cells


def test_rebalance_and_refusals():
    mesh, _ = _meshes("cube2")
    st = CellStorage(mesh, num_shards=3, partitioner="round_robin")
    info = lb.rebalance(st, "greedy_volume")
    assert (info.src_slot >= 0).sum() == st.topo.num_cells
    assert info.new_storage.num_shards == 3
    with pytest.raises(ValueError, match="balancer|partitioner"):
        lb.make_storage(mesh, 2, "metis")
    with pytest.raises(ValueError, match="shards"):
        lb.make_storage(mesh, 49, "sfc")
    with pytest.raises(ValueError, match="one mesh"):
        lb.migrate(st, CellStorage(tmi.mesh_unit_cube(1)))
