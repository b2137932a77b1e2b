"""Transport of the PyTorch port against the JAX package on identical
inputs: one MMOC step (RK2 and RK4, two substeps) in 2D and 3D, the mass
fix, UnsteadyDiffusion (theta 1 and 0.5) and the BDF / CFL helpers, the
particle integrators on one shard, and the circular-flow case of
tests/test_transport.py with its gates.

Meshes: the square mesh_rectangle((-1, -1), (1, 1), 2, 2) (8 faces), the
unit square mesh_rectangle(1, 1) for the heat equation, and
mesh_spherical_shell(1, 1, 0.55, 1) for a 3D MMOC step. The velocity is
the rigid rotation v = (-y, x) (about z in 3D); fields are interpolated
with the JAX package and carried over with interop.

Tolerances (float32; sums in another order, departure points to ~1e-7):
an MMOC step, the particle positions and the circular flow's eight steps
1e-4 of max|c|; a diffusion step 1e-5 of max|u|; the mass fix's masses
1e-5 relative.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.core.types import BoundaryCondition as JBC
from hyteg_tpu.core.types import DoFType as JDoF
from hyteg_tpu.functions.p1 import P1Space as JP1
from hyteg_tpu.functions.p2 import P2Space as JP2
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.numerictools import BDF2 as JBDF2
from hyteg_tpu.numerictools import UnsteadyDiffusion as JUD
from hyteg_tpu.numerictools import cfl_max_dt as jcfl
from hyteg_tpu.operators import forms as jforms
from hyteg_tpu.operators.p1_elementwise import P1ElementwiseOperator as JP1Op
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu.transport import MMOCTransport as JMMOC
from hyteg_tpu.transport.particles import ParticleDomain as JDomain
from hyteg_tpu.transport.particles import create_particles as jcreate
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.types import BoundaryCondition, DoFType
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.numerictools import (BDF1, BDF2, CrankNicolson,
                                          UnsteadyDiffusion, cfl_max_dt)
from hyteg_tpu_torch.operators import forms
from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.transport import (MMOCTransport, ParticleDomain,
                                       create_particles)

torch.set_num_threads(1)

MESHES = {
    "square": lambda m: m.mesh_rectangle(lower=(-1.0, -1.0),
                                         upper=(1.0, 1.0), nx=2, ny=2),
    "unit": lambda m: m.mesh_rectangle(nx=1, ny=1),
    "shell": lambda m: m.mesh_spherical_shell(1, 1, 0.55, 1.0),
}
STEP_RTOL = 1e-4
DIFF_RTOL = 1e-5
BC = JBC.all_dirichlet()


@functools.lru_cache(maxsize=None)
def storages(name):
    return (JStorage(MESHES[name](jmi), num_shards=1),
            CellStorage(MESHES[name](tmi)))


def blob(cx, cy, s=0.08):
    return lambda x: jnp.exp(-((x[..., 0] - cx) ** 2 + (x[..., 1] - cy) ** 2)
                             / (2 * s * s))


@functools.lru_cache(maxsize=None)
def fields(name, level, degree):
    """(c, vel) of the JAX package as numpy: a blob and the rotation."""
    js, _ = storages(name)
    sp = (JP1 if degree == 1 else JP2)(js, level)
    c = sp.interpolate(blob(0.5, 0.0, 0.15 if degree == 1 else 0.08),
                       sp.zeros(), JDoF.ALL, BC)
    vel = [sp.interpolate(lambda x: -x[..., 1], sp.zeros(), JDoF.ALL, BC),
           sp.interpolate(lambda x: x[..., 0], sp.zeros(), JDoF.ALL, BC)]
    if js.dim == 3:
        vel.append(sp.zeros())
    return np.asarray(c), np.stack([np.asarray(v) for v in vel])


@functools.lru_cache(maxsize=None)
def transports(name, level, degree):
    js, ts = storages(name)
    return (JMMOC(js, level, degree=degree, vel_degree=degree),
            MMOCTransport(ts, level, degree=degree, vel_degree=degree,
                          device="cpu"))


def t(a):
    return interop.block_from_reference(a, device="cpu")


def assert_close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, (what, err, scale)


MMOC_CASES = [("square", 3, 2, 4), ("square", 3, 2, 2), ("square", 3, 1, 4),
              ("shell", 1, 2, 4), ("shell", 2, 1, 2)]


@pytest.mark.parametrize("name,level,degree,rk", MMOC_CASES,
                         ids=[f"{m}-P{d}-L{lv}-rk{rk}"
                              for m, lv, d, rk in MMOC_CASES])
def test_mmoc_step_matches_reference(name, level, degree, rk):
    """One MMOC step with two substeps: the port evaluates only the kept
    slots, the JAX package every slot (then masks); equal on each."""
    jm, tm = transports(name, level, degree)
    c, vel = fields(name, level, degree)
    dt = 0.1
    want = np.asarray(jm.step(jnp.asarray(c), tuple(jnp.asarray(v)
                                                    for v in vel),
                              dt, rk=rk, substeps=2))
    got = tm.step(t(c), t(vel), dt, rk=rk, substeps=2)
    assert_close(got, want, STEP_RTOL, f"{name} P{degree} rk{rk}")
    # the padding outside each simplex stays 0
    assert not got[:, ~tm._node_space.vertex_mask_t.bool()].any()
    # a sequence of components gives the same as the stacked block
    again = tm.step(t(c), list(t(vel)), dt, rk=rk, substeps=2)
    assert torch.equal(again, got)


def test_departure_points_match_reference():
    jm, tm = transports("square", 3, 2)
    _, vel = fields("square", 3, 2)
    want = np.asarray(jm.departure_points(jnp.asarray(vel), 0.3, rk=4,
                                          substeps=2))
    got = tm.departure_points(t(vel), 0.3, rk=4, substeps=2)
    kept = tm._kept.numpy()
    np.testing.assert_allclose(got.numpy(), want[kept], rtol=0, atol=1e-6)


def test_mass_fix_matches_reference():
    js, ts = storages("square")
    jm, tm = transports("square", 4, 1)
    c, vel = fields("square", 4, 1)
    jsp, tsp = JP1(js, 4), P1Space(ts, 4, device="cpu")
    jM = JP1Op(jsp, jforms.mass_form)
    tM = P1ElementwiseOperator(tsp, forms.mass_form)
    jdot = lambda a, b: jsp.dot(jM.apply_raw(a), b, JDoF.ALL)
    tdot = lambda a, b: tsp.dot(tM.apply_raw(a), b, DoFType.ALL)
    jc1 = jm.step(jnp.asarray(c), tuple(jnp.asarray(v) for v in vel), 0.1,
                  rk=2)
    tc1 = tm.step(t(c), t(vel), 0.1, rk=2)
    want = np.asarray(jm.mass_fix(jc1, jnp.asarray(c), jdot))
    got = tm.mass_fix(tc1, t(c), tdot)
    assert_close(got, want, STEP_RTOL, "mass fix")
    m0 = float(tdot(t(c), torch.ones_like(got)))
    m1 = float(tdot(got, torch.ones_like(got)))
    np.testing.assert_allclose(m1, m0, rtol=1e-5)


def test_mmoc_circular_flow_gate():
    """tests/test_transport.py's case: a blob an eighth-turn around the
    origin, P2 level 4, eight RK4 steps; its gates (relative L2 error <
    0.15, max < 1.15, min > -0.2), and the port's result against the JAX
    package's eight steps."""
    js, ts = storages("square")
    level, steps, theta = 4, 8, np.pi / 4.0
    dt = theta / steps
    jm, tm = transports("square", level, 2)
    c, vel = fields("square", level, 2)
    jstep = jax.jit(lambda c: jm.step(c, tuple(jnp.asarray(v) for v in vel),
                                      dt, rk=4))
    jc, tc = jnp.asarray(c), t(c)
    for _ in range(steps):
        jc, tc = jstep(jc), tm.step(tc, t(vel), dt, rk=4)
    assert_close(tc, np.asarray(jc), STEP_RTOL, "eight steps")
    sp = tm.space
    jsp = JP2(js, level)
    want = t(np.asarray(jsp.interpolate(
        blob(0.5 * np.cos(theta), 0.5 * np.sin(theta)), jsp.zeros(),
        JDoF.ALL, BC)))
    num = float(sp.dot(tc - want, tc - want, DoFType.ALL))
    den = float(sp.dot(want, want, DoFType.ALL))
    assert math.sqrt(num / den) < 0.15
    assert float(sp.dof_max(tc, DoFType.ALL)) < 1.15
    assert float(sp.dof_max(-tc, DoFType.ALL)) < 0.2


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_unsteady_diffusion_matches_reference(theta):
    """Two theta-scheme heat-equation steps on sin(pi x) sin(pi y), P1
    level 4, with a source, in both packages."""
    js, ts = storages("unit")
    jsp, tsp = JP1(js, 4), P1Space(ts, 4, device="cpu")
    jud = JUD(jsp, JP1Op(jsp, jforms.laplace_form),
              JP1Op(jsp, jforms.mass_form), BC, theta=theta, cg_iters=400,
              cg_rtol=1e-9)
    tud = UnsteadyDiffusion(
        tsp, P1ElementwiseOperator(tsp, forms.laplace_form),
        P1ElementwiseOperator(tsp, forms.mass_form),
        BoundaryCondition.all_dirichlet(), theta=theta, cg_iters=400,
        cg_rtol=1e-9)
    u0 = np.asarray(jsp.interpolate(
        lambda x: jnp.sin(jnp.pi * x[..., 0]) * jnp.sin(jnp.pi * x[..., 1])
        + x[..., 0], jsp.zeros(), JDoF.ALL, BC))
    f = np.asarray(jsp.interpolate(lambda x: 1.0 + 0 * x[..., 0],
                                   jsp.zeros(), JDoF.ALL, BC))
    ju, tu = jnp.asarray(u0), t(u0)
    for _ in range(2):
        ju = jud.step(ju, 2e-3, f_new=jnp.asarray(f), f_old=jnp.asarray(f))
        tu = tud.step(tu, 2e-3, f_new=t(f), f_old=t(f))
    assert_close(tu, np.asarray(ju), DIFF_RTOL, f"theta {theta}")
    assert tud.last_iterations > 0
    # Dirichlet rows keep u0 (the boundary value x)
    bnd = np.asarray(jsp.restore_rows(jnp.zeros_like(ju), jnp.ones_like(ju),
                                      JDoF.INNER, jsp.resolve_sd(BC))) > 0
    np.testing.assert_array_equal(tu.numpy()[bnd], u0[bnd])


def test_bdf_and_cfl_match_reference():
    jb, tb = JBDF2(), BDF2()
    for dt in (0.1, 0.03):
        np.testing.assert_allclose(tb.lhs_coeff(dt), jb.lhs_coeff(dt))
        np.testing.assert_allclose(tb.rhs_coeffs(dt), jb.rhs_coeffs(dt))
    assert BDF1().rhs_coeffs(0.5) == (2.0,) and tb.steps == 2
    assert CrankNicolson().theta == 0.5
    np.testing.assert_allclose(cfl_max_dt(0.01, 2.0, cfl=0.5),
                               float(jcfl(0.01, 2.0, cfl=0.5)), rtol=1e-6)
    np.testing.assert_allclose(cfl_max_dt(0.01, torch.tensor(2.0), cfl=0.5),
                               0.0025, rtol=1e-6)


@functools.lru_cache(maxsize=None)
def domains(level):
    js, ts = storages("square")
    return JDomain(js, level, degree=1), ParticleDomain(ts, level, degree=1,
                                                        device="cpu")


@pytest.mark.parametrize("method", ["euler", "rk2", "rk4"])
def test_particle_integration_matches_reference(method):
    """Particles on one shard through the rotation, 8 sub-steps of a
    quarter turn, seeds padded to a capacity with inactive slots."""
    jd, td = domains(3)
    _, vel = fields("square", 3, 1)
    seeds = np.random.default_rng(7).uniform(-0.6, 0.6, size=(32, 2))
    jps = jcreate(seeds, capacity=40)
    tps = create_particles(seeds, capacity=40, device="cpu")
    assert tps.capacity == 40 and int(tps.num_active()) == 32
    jout = jd.integrate(jps, tuple(jnp.asarray(v) for v in vel),
                        np.pi / 2, steps=8, method=method)
    tout = td.integrate(tps, t(vel), np.pi / 2, steps=8, method=method)
    assert_close(tout.position, np.asarray(jout.position), STEP_RTOL, method)
    assert_close(tout.velocity, np.asarray(jout.velocity), STEP_RTOL, method)
    assert not tout.position[32:].any()
    if method == "rk4":
        R = np.array([[0.0, -1.0], [1.0, 0.0]])
        err = np.linalg.norm(tout.position[:32].numpy() - seeds @ R.T, axis=1)
        assert err.max() < 5e-3


def test_particle_velocity_sampled_in_one_pass():
    """sample_velocity takes the components as a sequence or stacked, and
    gives each component's own evaluation at the particles."""
    _, td = domains(3)
    _, vel = fields("square", 3, 1)
    seeds = np.random.default_rng(8).uniform(-0.9, 0.9, size=(24, 2))
    ps = create_particles(seeds, device="cpu")
    got = td.sample_velocity(t(vel), ps)
    assert got.shape == (24, 2)
    assert torch.equal(got, td.sample_velocity(list(t(vel)), ps))
    for d in range(2):
        assert torch.equal(got[:, d], td.sample(t(vel)[d], ps))


def test_particle_owners_and_temperature():
    jd, td = domains(3)
    js, _ = storages("square")
    tf = np.asarray(JP1(js, 3).interpolate(lambda x: x[..., 0] + 2.0,
                                           JP1(js, 3).zeros(), JDoF.ALL, BC))
    seeds = np.array([[0.25, 0.25], [-0.5, 0.1], [0.0, -0.75], [1.3, 0.2]])
    jps, tps = jcreate(seeds), create_particles(seeds, device="cpu")
    np.testing.assert_array_equal(td.owners(tps).numpy(),
                                  np.asarray(jd.owners(jps)))
    jout = jd.integrate_temperature(jps, jnp.asarray(tf), dt=0.5, rate=1.0)
    tout = td.integrate_temperature(tps, t(tf), dt=0.5, rate=1.0)
    assert_close(tout.temperature, np.asarray(jout.temperature), 1e-6,
                 "temperature")
    assert_close(td.sample(t(tf), tps), np.asarray(jd.sample(
        jnp.asarray(tf), jps)), 1e-6, "sample")
    with pytest.raises(ValueError):
        create_particles(seeds, capacity=2, device="cpu")
