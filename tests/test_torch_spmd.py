"""The sharded P1 and Stokes path of the PyTorch port against the JAX
package's 4-device shard_map path and against the port's one-shard run.

Both packages shard the same storage the same way, so the JAX package's
shard-major arrays and the port's per-shard blocks (LocalGroup, 4 shards
in one process) compare slot for slot through interop.shards_*.

Tolerances, all f32: the sharded apply rtol 2e-4 / atol 2e-5 (as
tests/test_spmd.py); one V-cycle 1e-5 of max|x| against the JAX package
(same eigenvalue bounds passed to both), 1e-6 against the port's one-shard
cycle; the agglomerated coarse solve within 2e-3 of the per-shard coarse
CG (tests/test_spmd.py's bound); the Stokes V-cycle 1e-4 of max|u| against
the one-shard cycle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from hyteg_tpu.core import types as jt
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.parallel import spmd as jspmd
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.types import BoundaryCondition, DoFType
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.operators import forms
from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
from hyteg_tpu_torch.parallel import spmd
from hyteg_tpu_torch.parallel.comm import LocalGroup
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.solvers.templates import make_p1_gmg

torch.set_num_threads(1)

BC = BoundaryCondition.all_dirichlet()
JBC = jt.BoundaryCondition.all_dirichlet()
FJ = lambda p: p[..., 0] * p[..., 1] + 2.0 * p[..., 2]
needs4 = pytest.mark.skipif(jax.device_count() < 4,
                            reason="needs 4 virtual devices")


def _by_gid(space, blocks):
    out = {}
    for d, blk in enumerate(blocks):
        ids = space.global_ids(d)
        v = np.asarray(interop.block_to_numpy(blk)
                       if isinstance(blk, torch.Tensor) else blk)
        sel = ids >= 0
        out.update(zip(ids[sel].tolist(), v[sel].tolist()))
    return out


def _jax_sharded(dmesh, arr):
    return jax.device_put(jnp.asarray(arr), NamedSharding(dmesh, P(jspmd.AXIS)))


def _jax_interp(jsp, fn, D):
    return np.concatenate([np.asarray(jsp.interpolate(
        fn, jsp.zeros(), jt.DoFType.ALL, jsp.shard_data(d, JBC)))
        for d in range(D)])


@needs4
@pytest.mark.parametrize("neighbor", [True, False])
def test_sharded_apply_matches_single_device(neighbor):
    """4 shards (with padding cells: 6 cells round robin) against the
    one-shard apply per global DoF, and slot for slot against the JAX
    package's sharded apply."""
    level = 2
    mesh = tmi.mesh_unit_cube(1)
    sp1 = P1Space(CellStorage(mesh), level, device="cpu")
    x1 = sp1.interpolate(FJ, sp1.zeros(), DoFType.ALL, BC)
    y1 = P1ElementwiseOperator(sp1, forms.laplace_form).apply_raw(x1, sd=BC)

    st4 = CellStorage(mesh, num_shards=4)
    sp4 = P1Space(st4, level, device="cpu")
    grp = LocalGroup(4)

    def body(g):
        sd = sp4.group_shard_data(g, BC, neighbor)
        x = sp4.interpolate(FJ, sp4.zeros(), DoFType.ALL, sd)
        op = P1ElementwiseOperator(sp4, forms.laplace_form, shard=g.rank)
        return op.apply_raw(x, sd=sd)

    y4 = grp.run(body)
    want = _by_gid(sp1, [y1])
    for gid, val in _by_gid(sp4, y4).items():
        np.testing.assert_allclose(val, want[gid], rtol=2e-4, atol=2e-5)

    dmesh = jspmd.device_mesh(jax.devices()[:4])
    jctx = jspmd.SpmdContext(JStorage(jmi.mesh_unit_cube(1), num_shards=4),
                             dmesh, JBC)
    jsp = jctx.space(level)
    xj = _jax_sharded(dmesh, _jax_interp(jsp, FJ, 4))
    yj = np.asarray(jspmd.build_spmd_apply(jctx, level)(xj))
    np.testing.assert_allclose(interop.shards_to_reference(y4), yj,
                               rtol=2e-4, atol=2e-5)


@needs4
@pytest.mark.parametrize("agglomerate", [False, True])
def test_vcycle_matches_jax_4_devices(agglomerate):
    """One sharded V-cycle from a smooth start with b = 0: the port's
    LocalGroup against the JAX package's 4-device cycle (both on the same
    eigenvalue bounds) and against the port's one-shard cycle."""
    mesh = tmi.mesh_unit_cube(1)
    st4 = CellStorage(mesh, num_shards=4)
    stack1 = make_p1_gmg(CellStorage(mesh), 0, 2, coarse_iters=40,
                         device="cpu")
    eigs = stack1.eigs
    ctx = spmd.SpmdContext(st4, LocalGroup(4), BC, device="cpu")
    vc = spmd.build_spmd_poisson_vcycle(ctx, 0, 2, coarse_iters=40,
                                        eigs=eigs,
                                        agglomerate_coarse=agglomerate)
    xs = vc.ctx.interpolate(2, FJ)
    out = vc(xs, [torch.zeros_like(x) for x in xs])

    dmesh = jspmd.device_mesh(jax.devices()[:4])
    jctx = jspmd.SpmdContext(JStorage(jmi.mesh_unit_cube(1), num_shards=4),
                             dmesh, JBC, pitch=(1 << 2) + 1)
    jv = jspmd.build_spmd_poisson_vcycle(jctx, 0, 2, coarse_iters=40,
                                         eigs=eigs,
                                         agglomerate_coarse=agglomerate)
    jsp = jctx.space(2)
    x0 = _jax_interp(jsp, FJ, 4)
    np.testing.assert_allclose(interop.shards_to_reference(xs), x0,
                               rtol=1e-6, atol=1e-7)
    xj = np.asarray(jv(_jax_sharded(dmesh, x0),
                       _jax_sharded(dmesh, np.zeros_like(x0))))
    got = interop.shards_to_reference(out)
    # padding cells hold no DoF: the JAX cycle smooths them as a floating
    # cell, the port keeps them as they came in
    real = st4.cell_valid
    scale = np.abs(xj[real]).max()
    assert np.abs(got[real] - xj[real]).max() <= 1e-5 * scale
    np.testing.assert_array_equal(got[~real], x0[~real])

    sp1 = stack1.space()
    x1 = stack1.gmg.cycle(sp1.interpolate(FJ, sp1.zeros(), DoFType.ALL, BC),
                          sp1.zeros())
    want = _by_gid(sp1, [x1])
    err = max(abs(v - want[g]) for g, v in _by_gid(vc.ctx.space(2),
                                                  out).items())
    assert err <= 1e-6 * max(abs(v) for v in want.values())


def test_agglomerated_coarse_solve_matches():
    """The V-cycle with the redundant gathered coarse solve (the
    AgglomerationWrapper analog) agrees with the per-shard coarse CG."""
    st = CellStorage(tmi.mesh_unit_cube(1), num_shards=4)
    ctx = spmd.SpmdContext(st, LocalGroup(4), BC, device="cpu")
    outs = []
    for aggl in (False, True):
        vc = spmd.build_spmd_poisson_vcycle(ctx, 0, 2, coarse_iters=40,
                                            agglomerate_coarse=aggl)
        xs = vc.ctx.interpolate(2, lambda p: p[..., 0] * p[..., 1] + p[..., 2])
        outs.append(interop.shards_to_reference(
            vc(xs, [torch.zeros_like(x) for x in xs])))
    xa, xb = outs
    assert np.isfinite(xa).all() and np.isfinite(xb).all()
    assert np.abs(xa - xb).max() / (np.abs(xa).max() + 1e-12) < 2e-3


def test_residual_norms_are_global():
    """Every shard reads the same residual norm, the one-shard one."""
    mesh = tmi.mesh_unit_cube(1)
    st1 = make_p1_gmg(CellStorage(mesh), 0, 2, coarse_iters=20, device="cpu")
    sp1 = st1.space()
    x1 = sp1.interpolate(FJ, sp1.zeros(), DoFType.ALL, BC)
    r1 = float(st1.residual_norm(x1, sp1.zeros()))
    ctx = spmd.SpmdContext(CellStorage(mesh, num_shards=3,
                                       partitioner="sfc"),
                           LocalGroup(3), BC, device="cpu")
    vc = spmd.build_spmd_poisson_vcycle(ctx, 0, 2, coarse_iters=20)
    xs = vc.ctx.interpolate(2, FJ)
    rs = vc.ctx.run(lambda g, st, x: float(st.residual_norm(
        x, torch.zeros_like(x))), vc.stacks, xs)
    assert len(set(rs)) == 1
    assert abs(rs[0] - r1) <= 1e-5 * r1


def test_context_shard_wrapper():
    """SpmdContext.shard hands each shard its blocks and shard data per
    level, as the JAX package's ``shard`` does."""
    ctx = spmd.SpmdContext(CellStorage(tmi.mesh_unit_cube(1), num_shards=3),
                           LocalGroup(3), BC, device="cpu")
    sp = ctx.space(2)
    xs = ctx.interpolate(2, FJ)
    add = ctx.shard(lambda x, sd: sp.exchange_add(x, sd), [2])
    direct = ctx.run(lambda g, x: sp.exchange_add(x, ctx.sd(g, 2)), xs)
    for a, b in zip(add(xs), direct):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    y = add(xs)
    assert not torch.equal(y[0], xs[0])


def test_spmd_stokes_vcycle_matches_single_device():
    """One Uzawa V-cycle on the P2-P1 Stokes system: 4 shards against the
    one-shard make_stokes_gmg, per global DoF id, every component."""
    from hyteg_tpu_torch.solvers.uzawa import make_stokes_gmg

    mesh = tmi.mesh_rectangle((0, 0), (1, 1), 2, 2)
    min_l, max_l = 0, 1
    eigs = {l: 2.0 for l in range(min_l, max_l + 1)}
    uf = lambda p: p[..., 0] * (1 - p[..., 0]) * p[..., 1]
    s1 = make_stokes_gmg(CellStorage(mesh), min_l, max_l, bc=BC,
                         coarse_iters=25, eigs=eigs, device="cpu")
    st1 = s1.stokes[max_l]
    x1 = s1.gmg.cycle(st1.zeros(), st1.interpolate_velocity(
        [uf] * st1.dim, st1.zeros()))
    ctx = spmd.SpmdContext(CellStorage(mesh, num_shards=4), LocalGroup(4),
                           BC, device="cpu")
    vc = spmd.build_spmd_stokes_vcycle(ctx, min_l, max_l, coarse_iters=25,
                                       eigs=eigs)

    def cycle(g, stack):
        st = stack.stokes[max_l]
        return stack.gmg.cycle(st.zeros(), st.interpolate_velocity(
            [uf] * st.dim, st.zeros()))

    x4 = ctx.run(cycle, vc.stacks)
    vsp = vc.stacks[0].stokes[max_l].vel_space
    for comp in range(st1.dim):
        want = _by_gid(st1.vel_space, [x1.vel[comp]])
        got = _by_gid(vsp, [x.vel[comp] for x in x4])
        scale = max(abs(v) for v in want.values())
        assert max(abs(got[g] - want[g]) for g in want) <= 1e-4 * scale
    want = _by_gid(st1.pre_space, [x1.pre])
    got = _by_gid(vc.stacks[0].stokes[max_l].pre_space, [x.pre for x in x4])
    scale = max(abs(v) for v in want.values())
    assert max(abs(got[g] - want[g]) for g in want) <= 1e-4 * scale


def test_interop_shards_round_trip():
    a = np.random.default_rng(0).standard_normal((8, 5, 25)).astype(np.float32)
    parts = interop.shards_from_reference(a, 4, device="cpu")
    assert [tuple(p.shape) for p in parts] == [(2, 5, 25)] * 4
    np.testing.assert_array_equal(interop.shards_to_reference(parts), a)
    with pytest.raises(ValueError):
        interop.shards_from_reference(a, 3, device="cpu")


def test_group_errors_do_not_hang():
    """A shard that raises breaks the group's barrier: the others stop and
    the first real error comes out."""
    grp = LocalGroup(3)

    def body(g):
        if g.rank == 1:
            raise KeyError("boom")
        return g.all_reduce(torch.ones(()))

    with pytest.raises(KeyError, match="boom"):
        grp.run(body)
    # the group is usable again afterwards
    assert [float(v) for v in grp.run(
        lambda g: g.all_reduce(torch.ones(())))] == [3.0] * 3


def test_entry_points_reject_bad_shard_counts():
    mesh = tmi.mesh_unit_cube(1)  # 6 cells
    with pytest.raises(ValueError, match="shards"):
        CellStorage(mesh, num_shards=7)
    with pytest.raises(ValueError, match="group of 2"):
        spmd.SpmdContext(CellStorage(mesh, num_shards=3), LocalGroup(2),
                         device="cpu")
    with pytest.raises(ValueError):
        LocalGroup(0)


def test_dryrun_multichip_two_shards():
    res = spmd.dryrun_multichip(2, device="cpu")
    assert res["p1_vcycle_rel"] <= 1e-4
    assert res["convection_rel"] <= 2e-5
