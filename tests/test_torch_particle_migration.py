"""Cross-shard particle migration of the port (one all_to_all of fixed
(D, M) slot matrices) against the JAX package's, on 8 shards of
mesh_unit_cube(2): the same particles end in the same slots of the same
shards, counts are conserved, and a too-small slot count reports its
overflow instead of losing particles silently."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.parallel import spmd as jspmd
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu.transport.migration import migrate as jmigrate
from hyteg_tpu.transport.particles import (ParticleDomain as JDomain,
                                           create_particles as jcreate)
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.parallel.comm import LocalGroup
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.transport.migration import migrate
from hyteg_tpu_torch.transport.particles import (ParticleDomain,
                                                 create_particles)

torch.set_num_threads(1)

D, P = 8, 64


@pytest.fixture(scope="module")
def setup():
    storage = CellStorage(tmi.mesh_unit_cube(2), num_shards=D)
    dom = ParticleDomain(storage, level=2, device="cpu")
    rng = np.random.default_rng(0)
    pts = rng.uniform(0.05, 0.95, size=(D, P, 3))
    payload = rng.standard_normal((D, P)).astype(np.float32)
    return storage, dom, pts, payload


def _run(setup, M):
    storage, dom, pts, payload = setup
    cps = storage.cells_per_shard
    sets = []
    for d in range(D):
        ps = create_particles(pts[d], capacity=2 * P, device="cpu")
        ps.temperature[:P] = torch.as_tensor(payload[d])
        sets.append(ps)

    def body(g, ps):
        owner = dom.owners(ps) // cps
        return migrate(ps, owner, g, M=M)

    return LocalGroup(D).run(body, sets)


def test_migrate_moves_particles_to_owner_shard(setup):
    storage, dom, pts, payload = setup
    out = _run(setup, P)
    assert sum(int(o[1]) for o in out) == 0
    assert sum(int(o[0].active.sum()) for o in out) == D * P
    src = set(np.round(payload.reshape(-1), 5).tolist())
    cps = storage.cells_per_shard
    for d, (ps, _) in enumerate(out):
        act = ps.active
        if not bool(act.any()):
            continue
        oc = dom.owners(dataclasses.replace(ps))[act]
        assert bool((oc // cps == d).all())
        for v in np.round(ps.temperature[act].numpy(), 5).tolist():
            assert v in src


@pytest.mark.skipif(jax.device_count() < D, reason="needs 8 virtual devices")
def test_migration_matches_jax(setup):
    _, _, pts, payload = setup
    jst = JStorage(jmi.mesh_unit_cube(2), num_shards=D)
    jdom = JDomain(jst, level=2)
    sets = []
    for d in range(D):
        ps = jcreate(pts[d], capacity=2 * P)
        sets.append(dataclasses.replace(
            ps, temperature=jnp.asarray(np.pad(payload[d], (0, P)))))
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *sets)
    cps = jst.cells_per_shard

    def body(ps):
        ps = jax.tree.map(lambda a: a[0], ps)
        owner_cell, _ = jdom.ev.locate_cells(ps.position)
        out, dropped = jmigrate(ps, owner_cell // cps, jspmd.AXIS, D, M=P)
        return jax.tree.map(lambda a: a[None], out), dropped[None]

    spec = jax.tree.map(lambda _: jspmd.P(jspmd.AXIS), stacked)
    jout, _ = jax.jit(jspmd.shard_map(
        body, mesh=jspmd.device_mesh(jax.devices()[:D]), in_specs=(spec,),
        out_specs=(spec, jspmd.P(jspmd.AXIS)), check_vma=False))(stacked)
    mine = _run(setup, P)
    for d, (ps, _) in enumerate(mine):
        act = np.asarray(jout.active[d])
        np.testing.assert_array_equal(ps.active.numpy(), act)
        np.testing.assert_array_equal(ps.position.numpy()[act],
                                      np.asarray(jout.position[d])[act])
        np.testing.assert_array_equal(ps.temperature.numpy()[act],
                                      np.asarray(jout.temperature[d])[act])


def test_overflow_is_counted(setup):
    """M = 2 slots per destination cannot carry the emigrants: the drops
    are counted, and kept plus dropped is every particle."""
    out = _run(setup, 2)
    dropped = sum(int(o[1]) for o in out)
    kept = sum(int(o[0].active.sum()) for o in out)
    assert dropped > 0
    assert kept + dropped == D * P
