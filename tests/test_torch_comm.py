"""The shard groups of parallel/comm.py: the same per-shard code under a
DistGroup (torch.distributed over gloo, one process per shard, started
with torch.multiprocessing) and under a LocalGroup (every shard in this
process) gives the same bits: the exchanges, a dot, an all_to_all, the
box halo apply and a sharded P1 V-cycle with the agglomerated coarse
solve. Sums over shards are taken in rank order by both groups, and each
shard's own work is the same code on the same inputs, so the results are
compared with no tolerance.

The processes meet through a file in a temporary directory (no port to
clash on under pytest-xdist) and are given PROCESS_TIMEOUT seconds; a hung
group fails the test instead of hanging it.
"""

import multiprocessing as mp
import os
import pathlib

import numpy as np
import pytest
import torch

from hyteg_tpu_torch.core.types import BoundaryCondition
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.parallel import spmd
from hyteg_tpu_torch.parallel.comm import DistGroup, LocalGroup
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.structured import BoxDomain, BoxStencilOperator
from hyteg_tpu_torch.structured import spmd as box_spmd

torch.set_num_threads(1)

PROCESS_TIMEOUT = 240.0
BC = BoundaryCondition.all_dirichlet()
F = lambda p: p[..., 0] * p[..., 1] + p[..., 2]


def _shard_work(g, storage):
    """What a shard computes with its group, as numpy arrays by name."""
    sp = P1Space(storage, 2, device="cpu")
    D, r = g.size, g.rank
    x = np.random.default_rng(7).standard_normal(
        (D * sp.C_loc, sp.N, sp.lanes)).astype(np.float32)
    u = torch.as_tensor(x[r * sp.C_loc:(r + 1) * sp.C_loc])
    out = {}
    for neighbor in (True, False):
        sd = sp.group_shard_data(g, BC, neighbor)
        out[f"add_{neighbor}"] = sp.exchange_add(u, sd)
        out[f"rep_{neighbor}"] = sp.exchange_rep(u, sd)
        out[f"dot_{neighbor}"] = sp.dot(u, u, sd=sd)
        out[f"max_{neighbor}"] = sp.dof_max(u, sd=sd)
    chunks = [torch.full((3,), 10.0 * r + j) for j in range(D)]
    out["all_to_all"] = torch.cat(g.all_to_all(chunks))
    out["all_gather"] = g.all_gather(u[:1])

    dom = BoxDomain((2, 1, 1), level=3, device="cpu")
    rows = box_spmd.slab_rows(dom.X, D)
    ub = torch.as_tensor(np.random.default_rng(8).standard_normal(
        dom.block_shape).astype(np.float32))
    s, e = rows[r]
    out["box"] = box_spmd.SpmdBoxOperator(BoxStencilOperator(dom),
                                          rows).apply_raw(g, ub[s:e].clone())

    return {k: v.numpy() for k, v in out.items()}


def _vcycle(group, storage) -> list:
    """A sharded V-cycle driven through the group (spmd.py): the local
    shards' blocks."""
    ctx = spmd.SpmdContext(storage, group, BC, device="cpu")
    vc = spmd.build_spmd_poisson_vcycle(ctx, 0, 2, coarse_iters=20,
                                        agglomerate_coarse=True)
    xs = vc.ctx.interpolate(2, F)
    return [v.numpy() for v in vc(xs, [torch.zeros_like(v) for v in xs])]


def _storage(world):
    mesh = tmi.mesh_unit_cube(1) if world == 4 else tmi.mesh_unit_cube(2)
    return CellStorage(mesh, num_shards=world,
                       partitioner="round_robin" if world == 4 else "sfc")


def _worker(rank, world, tmp):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    g = DistGroup(init_method=f"file://{tmp}/rendezvous", rank=rank,
                  world_size=world, backend="gloo", timeout=PROCESS_TIMEOUT)
    try:
        storage = _storage(world)
        res = _shard_work(g, storage)
        res["vcycle"] = _vcycle(g, storage)[0]
        np.savez(pathlib.Path(tmp) / f"rank{rank}.npz", **res)
    finally:
        g.close()


@pytest.mark.parametrize("world", [2, 4])
def test_dist_group_matches_local_group(tmp_path, world):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, world, str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(PROCESS_TIMEOUT)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} gloo processes hung"
    assert [p.exitcode for p in procs] == [0] * world

    storage = _storage(world)
    group = LocalGroup(world)
    local = group.run(lambda g: _shard_work(g, storage))
    for r, v in enumerate(_vcycle(group, storage)):
        local[r]["vcycle"] = v
    for r in range(world):
        dist = np.load(tmp_path / f"rank{r}.npz")
        assert sorted(dist.files) == sorted(local[r])
        for k in dist.files:
            np.testing.assert_array_equal(dist[k], local[r][k], err_msg=k)
    # the exchanges agree across the two exchange paths, and the group's
    # reductions are the same on every shard
    for r in range(world):
        np.testing.assert_allclose(local[r]["add_True"], local[r]["add_False"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(local[r]["rep_True"],
                                      local[r]["rep_False"])
        assert local[r]["dot_True"] == local[0]["dot_True"]
        np.testing.assert_array_equal(
            local[r]["all_to_all"],
            np.repeat(10.0 * np.arange(world) + r, 3).astype(np.float32))


def test_dist_group_needs_an_address():
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a process group already exists here")
    with pytest.raises(ValueError, match="init_method"):
        DistGroup(backend="gloo")
