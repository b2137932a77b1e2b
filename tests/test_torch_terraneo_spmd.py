"""The port's sharded TerraNeo convection step (terraneo/spmd_sim.py):
S shards against one shard of the same code at the JAX package's 2e-5
(tests/test_terraneo_spmd.py), and its one-shard pieces against the JAX
package's one-shard ShardedConvectionSimulation on identical inputs.

The port's simulation runs its Stokes coarse MINRES to rtol 1e-6 (at most 400
steps); the JAX package's runs 80 steps to 1e-8, which float32 does not
reach: past ~40 steps its true residual grows and the step depends on the
shard count at the 1e-2 level (ROADMAP C-ref1). Against the JAX package
both run 40 steps to 1e-8 (the JAX simulation given 40 through its module's
``build_spmd_stokes_vcycle``), short of that drift.
Tolerances: the initial T 1e-6 of max|T|; the buoyancy rhs 1e-5 of its
max; one Stokes V-cycle 1e-4 of max|u| (float32 Uzawa smoothing and
MINRES sums taken in another order).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.terraneo import spmd_sim as jss
from hyteg_tpu.terraneo.params import ConvectionParameters as JParams
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.terraneo.params import ConvectionParameters
from hyteg_tpu_torch.terraneo.simulation import make_convection_simulation
from hyteg_tpu_torch.terraneo.spmd_sim import ShardedConvectionSimulation

torch.set_num_threads(1)

PARAMS = dict(dim=2, level=1, ntan=8, nrad=1, rayleigh=1e4, max_dt=1e-4,
              energy_cg_iters=10)
COARSE = 40


def _run(S, steps=1, **kw):
    sim = ShardedConvectionSimulation(ConvectionParameters(**PARAMS),
                                      num_shards=S, device="cpu",
                                      stokes_cycles=1, **kw)
    T, x = sim.initial_state()
    for _ in range(steps):
        T, x = sim.step(T, x)
    return sim, T, x


def _field(sim, blocks):
    """{global T/velocity node id: value} over every shard."""
    from hyteg_tpu_torch.parallel.spmd import _by_gid

    return _by_gid(sim.T_sp, blocks)


def test_jax_coarse_settings_drift_with_the_shard_count():
    """C-ref1: with the JAX package's coarse MINRES (80 steps to rtol
    1e-8) four shards and one part by far more than 2e-5."""
    obs = [_run(S, coarse_iters=80, coarse_rtol=1e-8) for S in (1, 4)]
    rel = np.abs(np.subtract(obs[1][0].observables(obs[1][1], obs[1][2]),
                             obs[0][0].observables(obs[0][1], obs[0][2])))
    assert rel.max() > 1e-3 * 96.0


@pytest.mark.parametrize("S,partitioner", [(4, "round_robin"), (3, "sfc")])
def test_sharded_step_matches_single_shard(S, partitioner):
    sim1, T1, x1 = _run(1)
    simS, TS, xS = _run(S, partitioner=partitioner)
    np.testing.assert_allclose(simS.observables(TS, xS),
                               sim1.observables(T1, x1), rtol=2e-5)
    for get in (lambda T, x: T, lambda T, x: x.vel[0],
                lambda T, x: x.vel[1]):
        want = _field(sim1, [get(T1[0], x1[0])])
        got = _field(simS, [get(t, x) for t, x in zip(TS, xS)])
        scale = max(abs(v) for v in want.values())
        assert max(abs(got[g] - want[g]) for g in want) <= 2e-5 * scale


def test_sharded_step_transports_heat():
    sim, T, x = _run(4, steps=2)
    obs = sim.observables(T, x)
    assert np.all(np.isfinite(obs))
    assert obs[1] > 0.0  # buoyancy drives flow
    lo = min(float(t.min()) for t in T)
    hi = max(float(t.max()) for t in T)
    assert -0.05 <= lo and hi <= 1.05


def test_factory_returns_the_sharded_simulation():
    sim = make_convection_simulation(ConvectionParameters(**PARAMS),
                                     num_shards=2, device="cpu",
                                     stokes_cycles=1)
    assert isinstance(sim, ShardedConvectionSimulation)
    assert sim.group.size == 2


@pytest.fixture(scope="module")
def jsim(monkeypatch_module):
    monkeypatch_module.setattr(jss, "build_spmd_stokes_vcycle",
                               functools.partial(jss.build_spmd_stokes_vcycle,
                                                 coarse_iters=COARSE))
    return jss.ShardedConvectionSimulation(JParams(**PARAMS), num_shards=1,
                                           stokes_cycles=1)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_one_shard_pieces_match_jax(jsim):
    sim = ShardedConvectionSimulation(ConvectionParameters(**PARAMS),
                                      num_shards=1, device="cpu",
                                      stokes_cycles=1, coarse_iters=COARSE,
                                      coarse_rtol=1e-8)
    T, x = sim.initial_state()
    jT, jx = jsim.initial_state()
    jT = np.asarray(jT)
    scale = np.abs(jT).max()
    assert np.abs(interop.block_to_numpy(T[0]) - jT).max() <= 1e-6 * scale

    # buoyancy from the same T
    jb = [np.asarray(v) for v in jsim._buoyancy(jnp.asarray(jT))]
    Tt = interop.block_from_reference(jT, device="cpu")
    b = sim.ctx.run(lambda g, ee, t: sim._buoyancy(ee, t), sim._energy, [Tt])
    for d in range(2):
        np.testing.assert_allclose(interop.block_to_numpy(b[0][d]), jb[d],
                                   rtol=0, atol=1e-5 * np.abs(jb[d]).max())

    # one Stokes V-cycle from zero on the JAX rhs
    jout = jsim.stokes_step(jx, jss.TaylorHoodVec(
        tuple(jnp.asarray(v) for v in jb), jnp.zeros_like(jx.pre)))
    bt = interop.taylor_hood_from_reference(jb, np.zeros_like(
        np.asarray(jx.pre)), device="cpu")
    out = sim.stokes_step(x, [bt])[0]
    for d in range(2):
        want = np.asarray(jout.vel[d])
        np.testing.assert_allclose(interop.block_to_numpy(out.vel[d]), want,
                                   rtol=0, atol=1e-4 * np.abs(want).max())
