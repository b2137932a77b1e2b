"""Free-slip normal projection of the PyTorch port
(hyteg_tpu_torch/operators/freeslip.py): the three cases of
tests/test_freeslip.py on the port, and the port's normals, mask,
projection and wrapped operator against the JAX package's on identical
inputs.

Mesh: mesh_annulus(0.5, 1, 6, 1) at P2 level 2, flag 1 (inner rim)
Dirichlet, flag 2 (outer rim) free-slip, the radial normal, as
tests/test_freeslip.py.

Tolerances (float32): the mask exact; normals, projections and the
wrapped operator 1e-6 * max|y| against the JAX package; the reference
test's own tolerances for its three cases.
"""

import functools

import jax.numpy as jnp
import numpy as np
import torch

from hyteg_tpu.core import types as jt
from hyteg_tpu.functions.p2 import P2Space as JP2
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import freeslip as jfs
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu_torch.core.types import BoundaryCondition, DoFType
from hyteg_tpu_torch.functions.p2 import P2Space
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.operators.freeslip import (NormalProjection,
                                                StrongFreeSlipWrapper)
from hyteg_tpu_torch.primitives.storage import CellStorage

from tests.test_torch_blending import assert_close

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def setup():
    """(JAX space, JAX bc, port space, port bc)."""
    jsp = JP2(JStorage(jmi.mesh_annulus(0.5, 1.0, 6, 1), num_shards=1), 2)
    tsp = P2Space(CellStorage(tmi.mesh_annulus(0.5, 1.0, 6, 1)), 2,
                  device="cpu")
    jbc = jt.BoundaryCondition.all_dirichlet().with_flag(2, jt.DoFType.FREESLIP)
    tbc = BoundaryCondition.all_dirichlet().with_flag(2, DoFType.FREESLIP)
    return jsp, jbc, tsp, tbc


def radial(x):
    return x[..., :2]


def field(sp, bc, fn):
    return sp.interpolate(fn, sp.zeros(), DoFType.ALL, bc)


def test_projection_zeroes_normal_component():
    _, _, sp, bc = setup()
    proj = NormalProjection(sp, bc, radial)
    vx = field(sp, bc, lambda x: 1.0 + 0 * x[..., 0])
    vy = field(sp, bc, lambda x: 0.5 + 0 * x[..., 0])
    px, py = proj.project((vx, vy))
    n, mask = proj.normals.numpy(), proj.mask.numpy() > 0
    assert mask.any()
    un = px.numpy() * n[..., 0] + py.numpy() * n[..., 1]
    assert np.abs(un[mask]).max() < 1e-5
    np.testing.assert_array_equal(px.numpy()[~mask], vx.numpy()[~mask])
    qx, qy = proj.project((px, py))
    np.testing.assert_allclose(qx.numpy(), px.numpy(), atol=1e-6)


def test_tangential_field_unchanged():
    _, _, sp, bc = setup()
    proj = NormalProjection(sp, bc, radial)
    vx = field(sp, bc, lambda x: -x[..., 1])
    vy = field(sp, bc, lambda x: x[..., 0])
    px, py = proj.project(torch.stack([vx, vy]))
    np.testing.assert_allclose(px.numpy(), vx.numpy(), atol=1e-5)
    np.testing.assert_allclose(py.numpy(), vy.numpy(), atol=1e-5)


def test_wrapped_operator_identity_on_normal_space():
    _, _, sp, bc = setup()
    proj = NormalProjection(sp, bc, radial)
    wrapped = StrongFreeSlipWrapper(lambda v: 2.0 * torch.stack(list(v)),
                                    proj)
    vel = torch.stack([field(sp, bc, lambda x: x[..., 0]),
                       field(sp, bc, lambda x: x[..., 1])])
    out = wrapped(vel)
    want = 2.0 * proj.project(vel) + proj.normal_part(vel)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5)
    np.testing.assert_allclose(wrapped.project_rhs(vel).numpy(),
                               proj.project(vel).numpy(), atol=0)


def test_against_reference():
    """Normals, mask, projection, normal part and the wrapped operator
    against the JAX package on the same seeded velocity."""
    jsp, jbc, tsp, tbc = setup()
    jproj = jfs.NormalProjection(jsp, jbc, radial)
    tproj = NormalProjection(tsp, tbc, radial)
    np.testing.assert_array_equal(tproj.mask.numpy(), np.asarray(jproj.mask))
    assert_close(tproj.normals, jproj.normals, 1e-6, "normals")
    rng = np.random.default_rng(0)
    vel = rng.standard_normal((2,) + tuple(tsp.block_shape)).astype(np.float32)
    vel *= tsp.vertex_mask[None]
    jvel = tuple(jnp.asarray(v) for v in vel)
    tvel = torch.tensor(vel)
    for got, want in ((tproj.project(tvel), jproj.project(jvel)),
                      (tproj.normal_part(tvel), jproj.normal_part(jvel))):
        for d in range(2):
            assert_close(got[d], want[d], 1e-6)
    twrap = StrongFreeSlipWrapper(lambda v: 3.0 * v + 1.0, tproj)
    jwrap = jfs.StrongFreeSlipWrapper(
        lambda v: tuple(3.0 * a + 1.0 for a in v), jproj)
    got, want = twrap(tvel), jwrap(jvel)
    for d in range(2):
        assert_close(got[d], want[d], 1e-6, "wrapped")
