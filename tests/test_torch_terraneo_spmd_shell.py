"""The port's sharded convection step on the 3D shell
(mesh_spherical_shell(1, 2), T at P2 level 1): 4 shards of an SFC
partition against one shard at 2e-5 (|T|, |u_i|, and T and u_i at every
shard's copy of every node, of the field's max), T finite and within
[-0.05, 1.05]
(the JAX package's 3D shell case, tests/test_terraneo_spmd.py, which runs
only under -m slow there). A file of its own: its coarse MINRES runs ~90
steps per V-cycle on every shard (about 40 s on one CPU worker)."""

import numpy as np
import torch

from hyteg_tpu_torch.terraneo.params import ConvectionParameters
from hyteg_tpu_torch.terraneo.spmd_sim import ShardedConvectionSimulation

torch.set_num_threads(1)


def _nodes(sim, blocks):
    """(global id, value) of every shard's copy of every node."""
    ids = np.concatenate([sim.T_sp.global_ids(d).reshape(-1)
                          for d in range(len(blocks))])
    vals = np.concatenate([b.numpy().reshape(-1) for b in blocks])
    return ids[ids >= 0], vals[ids >= 0]


def test_sharded_shell_step_matches_single_shard():
    p = ConvectionParameters(dim=3, level=1, ntan=1, nrad=2, rayleigh=1e3,
                             max_dt=1e-4, energy_cg_iters=10)
    obs, nodes = {}, {}
    for S in (1, 4):
        sim = ShardedConvectionSimulation(p, num_shards=S, device="cpu",
                                          stokes_cycles=1, partitioner="sfc")
        T, x = sim.step(*sim.initial_state())
        obs[S] = np.asarray(sim.observables(T, x))
        nodes[S] = [_nodes(sim, T)] + [_nodes(sim, [xx.vel[c] for xx in x])
                                       for c in range(3)]
        assert all(bool(torch.isfinite(t).all()) for t in T)
        assert min(float(t.min()) for t in T) >= -0.05
        assert max(float(t.max()) for t in T) <= 1.05
    assert obs[1][1] > 0.0
    np.testing.assert_allclose(obs[4], obs[1], rtol=2e-5)
    for (ids1, v1), (ids4, v4) in zip(nodes[1], nodes[4]):
        want = np.zeros(ids1.max() + 1, dtype=v1.dtype)
        want[ids1] = v1
        assert np.abs(v4 - want[ids4]).max() <= 2e-5 * np.abs(v1).max()
