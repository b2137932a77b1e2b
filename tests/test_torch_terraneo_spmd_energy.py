"""The energy step of the port's sharded convection simulation (implicit
diffusion, explicit SUPG advection, fixed-count CG over the group) against
the JAX package's one-shard ShardedConvectionSimulation on identical T and
velocity; then the same step on 4 shards against 1. A file of its own: the
JAX step's shard_map CG takes about a minute to compile on the CPU.

Tolerances: 1e-5 of max|T| against the JAX package (float32 CG sums taken
in another order), 2e-5 between shard counts (tests/test_terraneo_spmd.py).
"""

import jax.numpy as jnp
import numpy as np
import torch

from hyteg_tpu.terraneo import spmd_sim as jss
from hyteg_tpu.terraneo.params import ConvectionParameters as JParams
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.parallel.spmd import _by_gid
from hyteg_tpu_torch.terraneo.params import ConvectionParameters
from hyteg_tpu_torch.terraneo.spmd_sim import ShardedConvectionSimulation

torch.set_num_threads(1)

PARAMS = dict(dim=2, level=1, ntan=8, nrad=1, rayleigh=1e4, max_dt=1e-4,
              energy_cg_iters=10)


def _velocity(sp_coords):
    """A smooth rotating flow u = (-y, x) sampled at the nodes."""
    return torch.stack([-sp_coords[..., 1], sp_coords[..., 0]])


def test_energy_step_matches_jax_and_shard_counts():
    sims = {S: ShardedConvectionSimulation(ConvectionParameters(**PARAMS),
                                           num_shards=S, device="cpu",
                                           stokes_cycles=1)
            for S in (1, 4)}
    out = {}
    for S, sim in sims.items():
        T, _ = sim.initial_state()

        def body(g, e, t):
            vel = _velocity(sim.T_sp.coords_from(e.sd.cell_vertices))
            vel = vel * sim.T_sp.vertex_mask_t
            return sim._energy_step(e, t, vel), vel

        out[S] = sim.ctx.run(body, sim._energy, T)

    # 4 shards against 1, per global node
    want = _by_gid(sims[1].T_sp, [out[1][0][0]])
    got = _by_gid(sims[4].T_sp, [o[0] for o in out[4]])
    scale = max(abs(v) for v in want.values())
    assert max(abs(got[g] - want[g]) for g in want) <= 2e-5 * scale

    # one shard against the JAX package's simulation on the same T and u
    jsim = jss.ShardedConvectionSimulation(JParams(**PARAMS), num_shards=1,
                                           stokes_cycles=1)
    jT, _ = jsim.initial_state()
    vel = interop.block_to_numpy(out[1][0][1])
    jnew = np.asarray(jsim._energy(jT, *(jnp.asarray(v) for v in vel)))
    mine = interop.block_to_numpy(out[1][0][0])
    assert np.abs(mine - jnew).max() <= 1e-5 * np.abs(jnew).max()
    assert np.abs(mine - np.asarray(jT)).max() > 0  # the step moved T
