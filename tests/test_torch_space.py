"""P1 space of the PyTorch port (hyteg_tpu_torch.functions.p1) against
the JAX package: level maps, halo exchanges, reductions, row restores and
interpolation on identical inputs (made with numpy from a seed).

The JAX side runs as on any CPU: its single-shard exchanges take the dense
structured path (functions/ifc_dense.py), an implementation independent of
the port's slot-map ``index_add_``. Tolerance: 1e-6 relative, for f32
sums taken in another order."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.core import types as jt
from hyteg_tpu.functions.p1 import P1Space as JSpace
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core import types as tt
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.primitives.storage import CellStorage

torch.set_num_threads(1)

RTOL = 1e-6
MESHES = ("mesh_single_tet", "unit_cube_1", "unit_cube_2")
CASES = [(m, level) for m in MESHES for level in (1, 2, 3, 4)]
FLAGS = ("ALL", "INNER", "FLAG_INNER", "DIRICHLET")


def _mesh(mod, name):
    if name == "mesh_single_tet":
        return mod.mesh_single_tet()
    return mod.mesh_unit_cube(int(name[-1]))


def _flag(mod, name):
    return mod.FLAG_INNER if name == "FLAG_INNER" else getattr(mod.DoFType, name)


@dataclasses.dataclass
class Pair:
    jsp: JSpace
    tsp: P1Space
    x: np.ndarray
    y: np.ndarray


@pytest.fixture(scope="module", params=CASES, ids=[f"{m}-l{l}" for m, l in CASES])
def pair(request):
    name, level = request.param
    jsp = JSpace(JStorage(_mesh(jmi, name)), level)
    tsp = P1Space(CellStorage(_mesh(tmi, name)), level)
    rng = np.random.default_rng(level)
    mask = jsp.vertex_mask[None]
    x = (rng.standard_normal(jsp.block_shape) * mask).astype(np.float32)
    y = (rng.standard_normal(jsp.block_shape) * mask).astype(np.float32)
    return Pair(jsp, tsp, x, y)


def _close(got: torch.Tensor, ref, rtol=RTOL):
    got, ref = interop.block_to_numpy(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= rtol * scale


def _t(a):
    return interop.block_from_reference(a)


def test_level_maps_equal(pair):
    jm, tm = pair.jsp.maps, pair.tsp.maps
    for f in dataclasses.fields(jm):
        a, b = getattr(jm, f.name), getattr(tm, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def test_exchange_add(pair):
    _close(pair.tsp.exchange_add(_t(pair.x)),
           pair.jsp.exchange_add(jnp.asarray(pair.x)))


def test_exchange_rep(pair):
    _close(pair.tsp.exchange_rep(_t(pair.x)),
           pair.jsp.exchange_rep(jnp.asarray(pair.x)))


@pytest.mark.parametrize("flag", FLAGS)
def test_dot(pair, flag):
    x, y = pair.x, pair.y
    ref = float(pair.jsp.dot(jnp.asarray(x), jnp.asarray(y), _flag(jt, flag)))
    got = float(pair.tsp.dot(_t(x), _t(y), _flag(tt, flag)))
    # Cauchy-Schwarz scale: the dot itself may cancel to ~0
    scale = math.sqrt(float((x * x).sum()) * float((y * y).sum()))
    assert abs(got - ref) <= RTOL * scale


@pytest.mark.parametrize("flag", ("FLAG_INNER", "DIRICHLET"))
def test_restore_rows(pair, flag):
    x, y = pair.x, pair.y
    ref = pair.jsp.restore_rows(jnp.asarray(x), jnp.asarray(y), _flag(jt, flag))
    got = pair.tsp.restore_rows(_t(x), _t(y), _flag(tt, flag))
    _close(got, ref)


def _u_jax(p):
    return jnp.sin(jnp.pi * p[..., 0]) * jnp.cos(p[..., 1]) + p[..., 2] ** 2


def _u_torch(p):
    return torch.sin(math.pi * p[..., 0]) * torch.cos(p[..., 1]) + p[..., 2] ** 2


@pytest.mark.parametrize("flag", ("ALL", "DIRICHLET", "FLAG_INNER"))
def test_interpolate(pair, flag):
    old = pair.x
    ref = pair.jsp.interpolate(_u_jax, jnp.asarray(old), _flag(jt, flag))
    got = pair.tsp.interpolate(_u_torch, _t(old), _flag(tt, flag))
    _close(got, ref)
    ref = pair.jsp.interpolate(1.5, jnp.asarray(old), _flag(jt, flag))
    got = pair.tsp.interpolate(1.5, _t(old), _flag(tt, flag))
    _close(got, ref)
