"""The VolumeDoF / P0 space of the PyTorch port (functions/volume.py)
against the JAX package: counts, element volumes and centroids, P0
interpolation, integrals, the diagonal mass operator and the P1 <-> P0
conversions, on identical inputs; mirrors tests/test_volume.py.

Tolerances: 1e-6 relative for geometry and element means (f32, a few
terms in the same order); 1e-5 of the maximum for p0_to_p1 (sums over up
to 24 elements, then the additive exchange).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.core.types import BoundaryCondition as JBC, DoFType as JDoF
from hyteg_tpu.functions.p1 import P1Space as JP1Space
from hyteg_tpu.functions.volume import (VolumeDoFSpace as JVolumeDoFSpace,
                                        p0_to_p1 as j_p0_to_p1,
                                        p1_to_p0 as j_p1_to_p0)
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.primitives.storage import CellStorage as JCellStorage
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.types import BoundaryCondition, DoFType
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.functions.volume import (P0Function, VolumeDoFSpace,
                                              p0_to_p1, p1_to_p0)
from hyteg_tpu_torch.mesh import meshinfo as mi
from hyteg_tpu_torch.primitives.storage import CellStorage

torch.set_num_threads(1)

MESHES = {
    "rect": lambda m: m.mesh_rectangle(nx=2, ny=1),
    "square": lambda m: m.mesh_rectangle(nx=1, ny=1),
    "cube1": lambda m: m.mesh_unit_cube(1),
    "tet": lambda m: m.mesh_single_tet(),
}


def storages(name):
    return (JCellStorage(MESHES[name](jmi), num_shards=1),
            CellStorage(MESHES[name](mi)))


def _close(got, want, rtol, atol=0.0):
    got = interop.block_to_numpy(got) if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name,level", [("rect", 3), ("cube1", 2),
                                        ("tet", 3)])
def test_counts_volumes_centroids(name, level):
    js, ts = storages(name)
    jv, tv = JVolumeDoFSpace(js, level), VolumeDoFSpace(ts, level,
                                                         device="cpu")
    assert tv.block_shape == jv.block_shape
    assert tv.num_global_dofs() == jv.num_global_dofs()
    np.testing.assert_array_equal(tv.base_mask, jv.base_mask)
    _close(tv.elem_volumes, jv.elem_volumes, 1e-6)
    _close(tv.elem_vertices(), jv.elem_vertices(), 1e-6, 1e-7)
    _close(tv.elem_centroids(), jv.elem_centroids(), 1e-6, 1e-7)
    # the measures sum to the domain's (unit square / cube)
    if name != "tet":
        assert abs(float(tv.elem_volumes.sum()) - 1.0) < 1e-5


@pytest.mark.parametrize("ndofs", [1, 3])
def test_interpolate_dot_mass(ndofs):
    js, ts = storages("square")
    jv = JVolumeDoFSpace(js, 4, ndofs=ndofs)
    tv = VolumeDoFSpace(ts, 4, ndofs=ndofs, device="cpu")
    f = lambda c: c[..., 0] + 2.0 * c[..., 1] ** 2
    ju, tu = jv.interpolate(f), tv.interpolate(f)
    _close(tu, ju, 1e-6, 1e-7)
    _close(tv.interpolate(1.5), jv.interpolate(1.5), 0)
    assert abs(float(tv.dot(tu, tu)) - float(jv.dot(ju, ju))) <= \
        1e-5 * float(jv.dot(ju, ju))
    assert float(tv.dof_max(tu)) == pytest.approx(float(jv.dof_max(ju)),
                                                   rel=1e-6)
    if ndofs == 1:
        _close(tv.mass_apply(tu), jv.mass_apply(ju), 1e-6, 1e-9)
        _close(tv.inverse_mass_apply(tv.mass_apply(tu)), ju, 1e-5, 1e-7)
        p0 = P0Function(tv).interpolate(lambda c: c[..., 0])
        # midpoint quadrature of x over the unit square = 1/2
        assert abs(float(p0.integral()) - 0.5) < 1e-5


@pytest.mark.parametrize("name,level", [("square", 3), ("cube1", 2),
                                        ("cube1", 3)])
def test_p1_p0_conversions_match(name, level):
    js, ts = storages(name)
    jp, tp = JP1Space(js, level), P1Space(ts, level, device="cpu")
    jv, tv = JVolumeDoFSpace(js, level), VolumeDoFSpace(ts, level,
                                                         device="cpu")
    f = lambda p: 1.0 + p[..., 0] - 0.5 * p[..., 1] + p[..., 0] * p[..., 1]
    ju = jp.interpolate(f, jp.zeros(), JDoF.ALL, JBC.all_dirichlet())
    tu = interop.block_from_reference(np.asarray(ju), device="cpu")
    ref = j_p1_to_p0(jp, ju, jv)
    _close(p1_to_p0(tp, tu, tv), ref, 1e-6, 1e-7)
    rng = np.random.default_rng(level)
    q = (rng.standard_normal(jv.block_shape) * jv._valid_weight).astype(
        np.float32)
    ref = np.asarray(j_p0_to_p1(jv, jnp.asarray(q), jp))
    got = p0_to_p1(tv, interop.volume_block_from_reference(q, device="cpu"),
                   tp)
    _close(got, ref, 0, 1e-5 * np.abs(ref).max())


def test_p1_p0_roundtrip_constant():
    _, ts = storages("cube1")
    tp, tv = P1Space(ts, 2, device="cpu"), VolumeDoFSpace(ts, 2, device="cpu")
    u = tp.interpolate(3.0, tp.zeros(), DoFType.ALL,
                       BoundaryCondition.all_dirichlet())
    p0 = p1_to_p0(tp, u, tv)
    assert torch.allclose(p0[tv.valid_weight_t > 0], torch.tensor(3.0))
    back = p0_to_p1(tv, p0, tp)
    assert torch.allclose(back[:, tp.vertex_mask_t.bool()],
                          torch.tensor(3.0), rtol=1e-5)
