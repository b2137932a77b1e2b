"""The port's row-slab-sharded box path against the JAX package's single-
device and sharded box path (tests/test_spmd_box.py's and
tests/test_box_spmd.py's cases) and against its own single-device path.

The port's slabs are aligned across the hierarchy (structured/spmd.py);
the JAX package's are padded to equal sizes: interop.box_slabs_* convert.
Tolerances, all f32: the apply rtol 2e-5 / atol 2e-5 against the JAX
package (exactly equal to the port's single-device apply: the same kernel
sums); the V-cycle rtol 2e-4 / atol 2e-5; three Jacobi sweeps rtol 2e-4 /
atol 1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.structured import BoxDomain as JBox
from hyteg_tpu.structured import BoxStencilOperator as JBoxOp
from hyteg_tpu.structured import gmg as jgmg
from hyteg_tpu.structured import spmd as jbspmd
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.parallel.comm import LocalGroup
from hyteg_tpu_torch.structured import BoxDomain, BoxStencilOperator, gmg
from hyteg_tpu_torch.structured import spmd

torch.set_num_threads(1)


@pytest.mark.parametrize("shards", [2, 8])
def test_spmd_apply_matches_single(shards):
    dom = BoxDomain((2, 1, 1), level=3, device="cpu")
    op = BoxStencilOperator(dom)
    rows = spmd.slab_rows(dom.X, shards)
    sop = spmd.SpmdBoxOperator(op, rows)
    u = np.random.default_rng(0).standard_normal(dom.block_shape).astype(
        np.float32)
    ut = torch.as_tensor(u)
    got = spmd.unshard_field(LocalGroup(shards).run(
        lambda g, x: sop.apply_raw(g, x), spmd.shard_field(ut, rows)))
    torch.testing.assert_close(got, op.apply_raw(ut), rtol=0, atol=0)
    want = np.asarray(JBoxOp(JBox((2, 1, 1), level=3)).apply_raw(
        jnp.asarray(u)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_interop_box_slabs_round_trip():
    dom = BoxDomain((2, 1, 1), level=3, device="cpu")
    rows = spmd.slab_rows(dom.X, 4)
    jpad = np.pad(np.arange(dom.X * dom.L, dtype=np.float32).reshape(
        dom.block_shape), ((0, 3), (0, 0)))
    parts = interop.box_slabs_from_reference(jpad, rows, device="cpu")
    assert [p.shape[0] for p in parts] == [e - s for s, e in rows]
    np.testing.assert_array_equal(interop.box_slabs_to_reference(parts, 4),
                                  jpad)


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")
def test_spmd_apply_matches_jax_sharded():
    jdom = JBox((2, 1, 1), level=3)
    jmesh = jbspmd.device_mesh(jax.devices()[:8])
    jsop = jbspmd.SpmdBoxOperator(JBoxOp(jdom), jmesh)
    u = np.random.default_rng(1).standard_normal(jdom.block_shape).astype(
        np.float32)
    jout = np.asarray(jsop.apply_raw(jbspmd.shard_field(jnp.asarray(u), jdom,
                                                        jmesh)))
    dom = BoxDomain((2, 1, 1), level=3, device="cpu")
    rows = spmd.slab_rows(dom.X, 8)
    sop = spmd.SpmdBoxOperator(BoxStencilOperator(dom), rows)
    parts = interop.box_slabs_from_reference(
        np.pad(u, ((0, jout.shape[0] - dom.X), (0, 0))), rows, device="cpu")
    got = LocalGroup(8).run(lambda g, x: sop.apply_raw(g, x), parts)
    np.testing.assert_allclose(interop.box_slabs_to_reference(got, 8), jout,
                               rtol=2e-5, atol=2e-5)


def test_spmd_vcycle_matches_single():
    """The sharded V-cycle gives the single-device V-cycle (same
    operators, transfers and Chebyshev intervals), the port's and the JAX
    package's."""
    dom = BoxDomain((2, 1, 1), level=4, device="cpu")
    levels1 = gmg.build_hierarchy(dom, min_level=2)
    levelsN = spmd.build_spmd_hierarchy(dom, 4, min_level=2)
    assert [l.eig_max for l in levelsN] == [l.eig_max for l in levels1]
    f = dom.interpolate(lambda x, y, z: torch.sin(math.pi * x) * y * (1 - z))
    b = dom.mask_interior(f)
    x1 = gmg.vcycle(levels1, torch.zeros_like(b), b)
    xN = spmd.unshard_field(LocalGroup(4).run(
        lambda g, bb: spmd.spmd_vcycle(g, levelsN, torch.zeros_like(bb), bb),
        spmd.shard_field(b, levelsN[0].rows)))
    torch.testing.assert_close(xN, x1, rtol=2e-4, atol=2e-5)

    jdom = JBox((2, 1, 1), level=4)
    jlevels = jgmg.build_hierarchy(jdom, min_level=2)
    for jl, l in zip(jlevels, levels1):
        jl.eig_max = l.eig_max
    jb = jnp.asarray(b.numpy())
    xj = np.asarray(jgmg.vcycle(jlevels, jnp.zeros_like(jb), jb))
    np.testing.assert_allclose(xN.numpy(), xj, rtol=2e-4, atol=2e-5)


def test_spmd_solve_converges():
    dom = BoxDomain((2, 1, 1), level=4, device="cpu")
    levels = spmd.build_spmd_hierarchy(dom, 4, min_level=2)
    f = dom.interpolate(lambda x, y, z: torch.sin(math.pi * x)
                        * torch.sin(math.pi * y) * torch.sin(math.pi * z))
    out = LocalGroup(4).run(
        lambda g, ff: spmd.spmd_solve_poisson(g, levels, ff, cycles=4),
        spmd.shard_field(f, levels[0].rows))
    rns = out[0][1].numpy()
    assert all(np.array_equal(o[1].numpy(), rns) for o in out)
    assert (rns[1:] < rns[:-1]).all(), rns
    assert rns[-1] < 0.05 * rns[0], rns


def test_sharded_jacobi_matches_single_device():
    dom = BoxDomain((1, 1, 1), level=3, device="cpu")
    op = BoxStencilOperator(dom)
    rows = spmd.slab_rows(dom.X, 8)
    sop = spmd.SpmdBoxOperator(op, rows)
    rng = np.random.default_rng(1)
    b = dom.mask_interior(torch.as_tensor(
        rng.standard_normal(dom.block_shape), dtype=torch.float32))
    want = torch.zeros_like(b)
    dinv = dom.interior_rowclass * op.inverse_diagonal
    from hyteg_tpu_torch.structured.box import rowclass_mul_
    for _ in range(3):
        want = want + 0.8 * rowclass_mul_(torch.sub(b, op.apply_raw(want)),
                                          dinv)

    def body(g, bb):
        x = torch.zeros_like(bb)
        for _ in range(3):
            x = sop.jacobi_step(g, x, bb)
        return x

    got = spmd.unshard_field(LocalGroup(8).run(body,
                                               spmd.shard_field(b, rows)))
    torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5)


def test_slab_rows_refuse_too_many_shards():
    with pytest.raises(ValueError, match="coarsest"):
        spmd.slab_rows(9, 16)
    assert spmd.slab_rows(33, 4, 9) == [(0, 8), (8, 16), (16, 24), (24, 33)]
