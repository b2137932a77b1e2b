"""TransportOperatorStd and its pieces (terraneo/transport_std.py) of the
PyTorch port against the JAX package on identical inputs: the element
gradients and volumes, the SUPG advection apply (Galerkin only, SUPG,
Peclet-limited SUPG), shear heating, and the implicit step with every
term (diffusion, Eulerian SUPG advection, adiabatic, shear and internal
heating) in 2D and on a small shell, plus the JAX tests' gates.

Meshes: mesh_rectangle 2 x 2 (8 faces) at P1 level 3, mesh_unit_cube(1)
at level 3, mesh_spherical_shell(1, 1, 0.55, 1) at level 2. Fields are
interpolated with the JAX package and carried over with interop.

Tolerances (float32; the port's gradients and volumes are computed in
float64, the JAX package's in float32): gradients and volumes 1e-5
relative; applies and the shear source 1e-5 of max|y|; the implicit step
(CG to rtol 1e-7) 1e-5 of max|T|.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.core.types import DoFType as JDoF
from hyteg_tpu.functions.p1 import P1Space as JP1
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu.terraneo import transport_std as jts
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.types import DoFType
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.operators import forms
from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.terraneo import transport_std as tts

torch.set_num_threads(1)

MESHES = {
    "rect": (3, lambda m: m.mesh_rectangle(nx=2, ny=2)),
    "cube": (3, lambda m: m.mesh_unit_cube(1)),
    "shell": (2, lambda m: m.mesh_spherical_shell(1, 1, 0.55, 1.0)),
}
RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def spaces(name):
    level, mk = MESHES[name]
    js, ts = JStorage(mk(jmi), num_shards=1), CellStorage(mk(tmi))
    return JP1(js, level), P1Space(ts, level, device="cpu")


@functools.lru_cache(maxsize=None)
def inputs(name):
    """(T, vel components, eta, adiabatic coefficient) as numpy."""
    jsp, _ = spaces(name)
    dim = jsp.dim
    interp = lambda f: np.asarray(jsp.interpolate(f, jsp.zeros(), JDoF.ALL))
    T = interp(lambda x: jnp.sin(jnp.pi * x[..., 0]) * x[..., 1] + 0.3)
    vel = np.stack([interp(lambda x, i=i: 0.4 * x[..., (i + 1) % dim]
                           - 0.2 * x[..., i] + 0.1 * x[..., 0] ** 2)
                    for i in range(dim)])
    eta = interp(lambda x: 1.0 + 0.5 * x[..., 0] * x[..., 1])
    adia = interp(lambda x: 0.1 + 0.05 * x[..., 1])
    return T, vel, eta, adia


def t(a):
    return interop.block_from_reference(a, device="cpu")


def assert_close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, (what, err, scale)


@pytest.mark.parametrize("name", list(MESHES))
def test_element_gradients_and_volumes(name):
    jsp, tsp = spaces(name)
    cv = tsp.resolve_sd().cell_vertices
    jcv = jnp.asarray(jsp.cell_vertices(0))
    assert_close(tts.element_basis_gradients(tsp, cv),
                 jts.element_basis_gradients(jsp, jcv), RTOL, "grads")
    assert_close(tts.element_volumes(tsp, cv),
                 jts.element_volumes(jsp, jcv), RTOL, "volumes")


@pytest.mark.parametrize("name", list(MESHES))
def test_element_tables_built_once(name):
    """element_tables computes a space's gradients and volumes on its first
    call and hands the same tensors to every later caller (shear heating
    on each energy step, each SUPG operator)."""
    _, tsp = spaces(name)
    cv = tsp.resolve_sd().cell_vertices
    grads, vols = tts.element_tables(tsp)
    assert torch.equal(grads, tts.element_basis_gradients(tsp, cv))
    assert torch.equal(vols, tts.element_volumes(tsp, cv))
    again = tts.element_tables(tsp)
    assert again[0] is grads and again[1] is vols
    assert tts.SUPGAdvectionOperator(tsp).grads is grads


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("supg,kappa", [(False, 0.0), (True, 0.0),
                                        (True, 0.05)])
def test_supg_apply_matches_reference(name, supg, kappa):
    jsp, tsp = spaces(name)
    T, vel, _, _ = inputs(name)
    jop = jts.SUPGAdvectionOperator(jsp, supg=supg, kappa=kappa)
    top = tts.SUPGAdvectionOperator(tsp, supg=supg, kappa=kappa)
    want = jop.apply_raw(jnp.asarray(T), tuple(jnp.asarray(v) for v in vel))
    got = top.apply_raw(t(T), t(vel))
    assert_close(got, want, RTOL, f"{name} supg={supg} kappa={kappa}")


def test_advection_kills_constants():
    """tests/test_transport_std.py's gate: the advection of a constant
    vanishes on every valid row."""
    _, tsp = spaces("cube")
    _, vel, _, _ = inputs("cube")
    T = tsp.vertex_mask_t.expand(tsp.block_shape)
    y = tts.SUPGAdvectionOperator(tsp, supg=True).apply_raw(T, t(vel))
    mask = tsp.vertex_mask_t.bool().expand(tsp.block_shape)
    assert y[mask].abs().max() < 1e-5


@pytest.mark.parametrize("name", list(MESHES))
def test_shear_heating_matches_reference(name):
    jsp, tsp = spaces(name)
    _, vel, eta, _ = inputs(name)
    want = jts.shear_heating_source(jsp, tuple(jnp.asarray(v) for v in vel),
                                    jnp.asarray(eta))
    got = tts.shear_heating_source(tsp, t(vel), t(eta))
    assert_close(got, want, RTOL, name)


def test_shear_heating_uniform_shear():
    """u = (g y, 0, 0), eta constant: Q = eta g^2 everywhere (the JAX
    test's gate)."""
    _, tsp = spaces("cube")
    g, eta_v = 1.5, 0.8
    u0 = tsp.interpolate(lambda x: g * x[..., 1], tsp.zeros(), DoFType.ALL)
    vel = torch.stack([u0, tsp.zeros(), tsp.zeros()])
    eta = torch.full(tsp.block_shape, eta_v)
    Q = tts.shear_heating_source(tsp, vel, eta)
    mask = tsp.vertex_mask_t.bool().expand(tsp.block_shape)
    np.testing.assert_allclose(Q[mask].numpy(), eta_v * g * g, rtol=1e-4)


TERMS = {"ADVECTION_EULERIAN": True, "SHEAR_HEATING": True,
         "ADIABATIC_HEATING": True, "INTERNAL_HEATING": True}


@pytest.mark.parametrize("name", list(MESHES))
def test_transport_step_matches_reference(name):
    """The implicit step with every term: both packages from the same T,
    velocity, viscosity and adiabatic coefficient."""
    jsp, tsp = spaces(name)
    T, vel, eta, adia = inputs(name)
    jop = jts.TransportOperatorStd(jsp, kappa=1e-2, terms=TERMS)
    top = tts.TransportOperatorStd(tsp, kappa=1e-2, terms=TERMS)
    jop.adiabatic_coeff, top.adiabatic_coeff = jnp.asarray(adia), t(adia)
    jop.internal_heating = top.internal_heating = 0.05
    want = jop.step(jnp.asarray(T), 1e-2,
                    vel=tuple(jnp.asarray(v) for v in vel),
                    eta=jnp.asarray(eta))
    got = top.step(t(T), 1e-2, vel=t(vel), eta=t(eta))
    assert_close(got, want, RTOL, name)
    assert top.last_iterations > 0
    # Dirichlet rows untouched, T finite
    bnd = (top._inner_mask(torch.float32) == 0) & \
        tsp.vertex_mask_t.bool().expand(tsp.block_shape)
    assert torch.isfinite(got).all()
    assert torch.equal(got[bnd], t(T)[bnd])


def test_transport_operators_are_the_kernel_paths():
    """The step's Laplace and mass are P1ElementwiseOperators (kernel B2 on
    a CUDA tensor); the adiabatic term is the mass with a coefficient
    (kernel B4): on the CPU both run their plain versions, which must give
    what an explicit P1 operator gives."""
    _, tsp = spaces("cube")
    T, _, _, adia = inputs("cube")
    top = tts.TransportOperatorStd(tsp, terms={"ADIABATIC_HEATING": True})
    top.adiabatic_coeff = t(adia)
    M = P1ElementwiseOperator(tsp, forms.mass_form)
    y = top._lhs(t(T), 0.5, None)
    want = (M.apply_raw(t(T)) + 0.5 * top.A.apply_raw(t(T))
            + 0.5 * M.apply_raw(t(T), coeff=t(adia)))
    assert_close(y, want, 1e-6, "lhs")
