"""Blended-geometry P2 operators of the PyTorch port
(hyteg_tpu_torch/operators/p2_blended_stokes.py) against the JAX package
(hyteg_tpu/operators/p2_blended_stokes.py) on identical numpy-seeded
inputs: the epsilon apply and diagonal, with and without ``full`` and a
nodal viscosity, the divergence and the gradient, on the blended shell
mesh_spherical_shell(1, 2, 0.55, 1) (480 tets, P2 level 1) and the blended
annulus mesh_annulus(0.5, 1, 8, 1) (P2 level 2); on the identity map
against the port's affine operators (mesh_unit_cube(1), P2 level 2, as
tests/test_p2_blended.py); the adjoint identity of div and grad, and the
epsilon operator's symmetry and positivity on the shell
(tests/test_p2_blended.py::test_blended_epsilon_symmetric_on_shell).

The JAX side runs as its own CPU tests run it (plain XLA: no Pallas kernel
is reached). Velocities are replica-consistent; the viscosity is 0.5 + a
seeded uniform field, made consistent.

Tolerances (float32; sums in another order): applies, diagonals, div and
grad 1e-5 * max|y| against the JAX package and against the affine
operators; the adjoint identity 1e-5 relative; symmetry 1e-3 relative (the
JAX test's), positivity.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.functions.p1 import P1Space as JP1
from hyteg_tpu.functions.p2 import P2Space as JP2
from hyteg_tpu.geometry import maps as jmaps
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import p2_blended_stokes as jbs
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.types import DoFType
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.functions.p2 import P2Space
from hyteg_tpu_torch.geometry import maps as tmaps
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.operators import p2_blended_stokes as tbs
from hyteg_tpu_torch.operators.mixed import P2ToP1DivOperator
from hyteg_tpu_torch.operators.p2_epsilon import P2VectorEpsilonOperator
from hyteg_tpu_torch.primitives.storage import CellStorage

from tests.test_torch_blending import assert_close

torch.set_num_threads(1)

MESHES = {"shell12": lambda m: m.mesh_spherical_shell(1, 2, 0.55, 1.0),
          "annulus8": lambda m: m.mesh_annulus(0.5, 1.0, 8, 1),
          "cube": lambda m: m.mesh_unit_cube(1)}
LEVELS = {"shell12": 1, "annulus8": 2, "cube": 2}


@functools.lru_cache(maxsize=None)
def storages(name):
    return (JStorage(MESHES[name](jmi), num_shards=1),
            CellStorage(MESHES[name](tmi)))


@functools.lru_cache(maxsize=None)
def spaces(name):
    """(JAX P2, JAX P1, port P2, port P1) on one shared lane pitch."""
    js, ts = storages(name)
    L = LEVELS[name]
    P = (1 << (L + 1)) + 1
    return (JP2(js, L, pitch=P), JP1(js, L, pitch=P),
            P2Space(ts, L, device="cpu", pitch=P),
            P1Space(ts, L, device="cpu", pitch=P))


def rand_vel(p2: P2Space, seed: int) -> torch.Tensor:
    """A seeded replica-consistent (dim, C, M, lanes) velocity."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((p2.dim,) + tuple(p2.block_shape))
    x = torch.tensor(x * p2.vertex_mask[None], dtype=torch.float32)
    return torch.stack([p2.exchange_rep(v) for v in x])


def rand_pressure(p1: P1Space, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(p1.block_shape) * p1.vertex_mask[None]
    return p1.exchange_rep(interop.block_from_reference(x, device="cpu"))


def viscosity(p2: P2Space, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    mu = (0.5 + rng.uniform(size=p2.block_shape)) * p2.vertex_mask[None]
    return p2.exchange_rep(interop.block_from_reference(mu, device="cpu"))


def jx(t: torch.Tensor):
    return jnp.asarray(t.numpy())


BLENDED = ["shell12", "annulus8"]
VARIANTS = [(False, False), (True, False), (False, True)]
VARIANT_IDS = ["plain", "full", "viscosity"]


@functools.lru_cache(maxsize=None)
def eps_pair(name, full):
    jp2, _, tp2, _ = spaces(name)
    return (jbs.P2BlendedEpsilonOperator(jp2, jmaps.RadialMap(), full=full),
            tbs.P2BlendedEpsilonOperator(tp2, tmaps.RadialMap(), full=full))


def test_node_coords_blended():
    jp2, _, tp2, _ = spaces("shell12")
    want = jbs.node_coords_blended(jp2, jmaps.RadialMap())
    assert_close(tbs.node_coords_blended(tp2, tmaps.RadialMap()), want, 1e-6)


@pytest.mark.parametrize("full,with_mu", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("name", BLENDED)
def test_epsilon_apply(name, full, with_mu):
    jop, top = eps_pair(name, full)
    xs = rand_vel(top.space, 1)
    mu = viscosity(top.space, 2) if with_mu else None
    got = top.apply_raw(xs, coeff=mu)
    want = jop.apply_raw(tuple(jx(v) for v in xs),
                         coeff=None if mu is None else jx(mu))
    assert torch.isfinite(got).all()
    for d in range(top.space.dim):
        assert_close(got[d], want[d], 1e-5, f"eps[{d}]")


@pytest.mark.parametrize("full,with_mu", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("name", BLENDED)
def test_epsilon_diagonal(name, full, with_mu):
    jop, top = eps_pair(name, full)
    mu = viscosity(top.space, 3) if with_mu else None
    got = top.inverse_diagonal(coeff=mu)
    want = jop.inverse_diagonal(coeff=None if mu is None else jx(mu))
    for d in range(top.space.dim):
        assert_close(got[d], want[d], 1e-5, f"inverse diagonal[{d}]")


@pytest.mark.parametrize("name", BLENDED)
def test_div_and_gradient(name):
    jp2, jp1, tp2, tp1 = spaces(name)
    jop = jbs.P2P1BlendedDivOperator(jp2, jp1, jmaps.RadialMap())
    top = tbs.P2P1BlendedDivOperator(tp2, tp1, tmaps.RadialMap())
    xs = rand_vel(tp2, 4)
    assert_close(top.apply_div_local(xs.unbind(0)),
                 jop.apply_div_local(tuple(jx(v) for v in xs)), 1e-5, "div")
    p = rand_pressure(tp1, 5)
    grad = top.apply_gradient_local(p)
    for d in range(tp2.dim):
        want = jop.apply_gradient_component_local(jx(p), d)
        assert_close(grad[d], want, 1e-5, f"grad[{d}]")
        assert_close(top.apply_gradient_component_local(p, d), want, 1e-5)


@pytest.mark.parametrize("name", BLENDED)
def test_div_grad_adjoint(name):
    """<B u, p> = <u, B^T p> over the global DoFs (both exchanged)."""
    _, _, tp2, tp1 = spaces(name)
    op = tbs.P2P1BlendedDivOperator(tp2, tp1, tmaps.RadialMap())
    u, p = rand_vel(tp2, 6), rand_pressure(tp1, 7)
    lhs = float(tp1.dot(tp1.exchange_add(op.apply_div_local(u.unbind(0))), p))
    g = op.apply_gradient_local(p)
    rhs = sum(float(tp2.dot(tp2.exchange_add(g[d]), u[d]))
              for d in range(tp2.dim))
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs), (lhs, rhs)


@pytest.mark.parametrize("full,with_mu", VARIANTS + [(True, True)],
                         ids=VARIANT_IDS + ["full-viscosity"])
def test_epsilon_identity_is_affine(full, with_mu):
    """tests/test_p2_blended.py::test_blended_epsilon_matches_affine_on_
    identity and its diagonal test, against the port's affine operator."""
    _, _, tp2, _ = spaces("cube")
    aff = P2VectorEpsilonOperator(tp2, full=full)
    ble = tbs.P2BlendedEpsilonOperator(tp2, tmaps.GeometryMap(), full=full)
    xs = rand_vel(tp2, 8)
    mu = viscosity(tp2, 9) if with_mu else None
    assert_close(ble.apply_raw(xs, mu), aff.apply_raw(xs, mu), 1e-5, "apply")
    assert_close(ble.apply_inner(xs, coeff=mu), aff.apply_inner(xs, coeff=mu),
                 1e-5, "apply_inner")
    assert_close(ble.diagonal_raw(mu), aff.diagonal_raw(mu), 1e-5, "diag")


def test_div_grad_identity_is_affine():
    """tests/test_p2_blended.py::test_blended_div_grad_match_affine_on_
    identity, against the port's affine operator."""
    _, _, tp2, tp1 = spaces("cube")
    aff = P2ToP1DivOperator(tp2, tp1)
    ble = tbs.P2P1BlendedDivOperator(tp2, tp1, tmaps.GeometryMap())
    xs = rand_vel(tp2, 10)
    assert_close(ble.apply_div_local(xs.unbind(0)),
                 aff.apply_div_local(xs.unbind(0)), 1e-5, "div")
    p = rand_pressure(tp1, 11)
    assert_close(ble.apply_gradient_local(p), aff.apply_gradient_local(p),
                 1e-5, "grad")


def test_epsilon_symmetric_on_shell():
    """<K u, v> == <u, K v> and <K u, u> > 0 on the blended shell."""
    _, top = eps_pair("shell12", False)
    sp = top.space
    us, vs = rand_vel(sp, 3), rand_vel(sp, 4)
    Ku, Kv = top.apply_raw(us), top.apply_raw(vs)
    dot = lambda a, b: sum(float(sp.dot(a[d], b[d], DoFType.ALL))
                           for d in range(sp.dim))
    lhs, rhs = dot(Ku, vs), dot(us, Kv)
    assert abs(lhs - rhs) < 1e-3 * max(abs(lhs), 1.0), (lhs, rhs)
    assert dot(Ku, us) > 0.0
