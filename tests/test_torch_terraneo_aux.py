"""The TerraNeo helpers of the PyTorch port against the JAX package on
identical inputs: spherical harmonics (basis, synthesis, analysis, the
initial-temperature perturbation), plate velocities, radial profiles and
``P1Space.unique_weight``, the viscosity law, the manufactured solutions,
the power iteration, the run configuration, the timing tree, and a
checkpoint restored into a finer level with the port's P1 prolongation.

Tolerances (float32 unless noted): harmonics and plate velocities 1e-5
of their max (float64 inputs: 1e-12); profiles and weights 1e-6
absolute; manufactured fields 1e-5 of their max; the spectral radius
1e-5 relative; the prolongated checkpoint 1e-6 of max|u|.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.core.types import BoundaryCondition as JBC
from hyteg_tpu.core.types import DoFType as JDoF
from hyteg_tpu.functions.p1 import P1Space as JP1
from hyteg_tpu.functions.p2 import P2Space as JP2
from hyteg_tpu.io.checkpoint import CheckpointExporter as JExporter
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.numerictools import manufactured as jman
from hyteg_tpu.numerictools import estimate_spectral_radius_op as jradius
from hyteg_tpu.operators import forms as jforms
from hyteg_tpu.operators.p1_elementwise import P1ElementwiseOperator as JP1Op
from hyteg_tpu.operators.transfer import P1Transfer as JTransfer
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu.terraneo import plates as jplates
from hyteg_tpu.terraneo import profiles as jprofiles
from hyteg_tpu.terraneo import sphericalharmonics as jsh
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.config import from_dict, load_config
from hyteg_tpu_torch.core.timing import TimingTree
from hyteg_tpu_torch.core.types import DoFType
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.functions.p2 import P2Space
from hyteg_tpu_torch.io.checkpoint import CheckpointImporter
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.numerictools import manufactured as tman
from hyteg_tpu_torch.numerictools import estimate_spectral_radius_op
from hyteg_tpu_torch.operators import forms
from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
from hyteg_tpu_torch.operators.transfer import P1Transfer
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.terraneo import plates, profiles
from hyteg_tpu_torch.terraneo import sphericalharmonics as sh

torch.set_num_threads(1)


def assert_close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, (what, err, scale)


def sphere_points(q, seed, radius=1.0):
    x = np.random.default_rng(seed).normal(size=(q, 3))
    return radius * x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("lmax", [0, 2, 5])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sh_basis_matches_reference(lmax, dtype):
    x = (sphere_points(300, lmax) * 1.7).astype(dtype)
    x[0] = 0.0        # the origin: r == 0 is guarded
    x[1] = (0, 0, 2)  # a pole: phi = atan2(0, 0)
    want = np.asarray(jsh.sh_basis(lmax, jnp.asarray(x)))
    got = sh.sh_basis(lmax, torch.as_tensor(x))
    assert got.shape == (300, sh.num_coeffs(lmax))
    assert_close(got, want, 1e-5, f"lmax {lmax}")
    assert sh.sh_index(2, -1) == jsh.sh_index(2, -1)


def test_sh_synthesis_analysis_and_perturbation():
    lmax = 3
    c = np.random.default_rng(1).normal(size=sh.num_coeffs(lmax))
    x = sphere_points(200, 2)
    w = np.full(200, 4 * np.pi / 200)
    f = sh.sh_synthesis(c, lmax, torch.as_tensor(x))
    assert_close(f, jsh.sh_synthesis(jnp.asarray(c), lmax, jnp.asarray(x)),
                 1e-5, "synthesis")
    a = sh.sh_analysis_weighted(f, torch.as_tensor(w), lmax,
                                torch.as_tensor(x))
    ja = jsh.sh_analysis_weighted(jnp.asarray(f.numpy()), jnp.asarray(w),
                                  lmax, jnp.asarray(x))
    assert_close(a, ja, 1e-5, "analysis")
    cc = np.zeros(sh.num_coeffs(2))
    cc[sh.sh_index(2, 1)] = 1.0
    ic, jic = (sh.temperature_perturbation(2, cc, 0.5, 1.0),
               jsh.temperature_perturbation(2, cc, 0.5, 1.0))
    pts = sphere_points(100, 3) * np.random.default_rng(4).uniform(
        0.4, 1.1, size=(100, 1))
    assert_close(ic(torch.as_tensor(pts)), jic(jnp.asarray(pts)), 1e-5, "ic")
    for r, exp in ((0.5, 1.0), (1.0, 0.0)):  # damped at the rims
        np.testing.assert_allclose(
            ic(torch.as_tensor(r * sphere_points(50, 5))).numpy(), exp,
            atol=1e-5)


@pytest.mark.parametrize("smoothing", [0.0, 0.02, 0.1])
def test_plate_velocity_matches_reference(smoothing):
    stages = [jplates.synthetic_stage(5, seed=3, max_rate=2.0),
              jplates.synthetic_stage(5, seed=6, age=10.0)]
    tst = [plates.synthetic_stage(5, seed=3, max_rate=2.0),
           plates.synthetic_stage(5, seed=6, age=10.0)]
    for a, b in zip(stages, tst):
        np.testing.assert_array_equal(a.seeds, b.seeds)
        np.testing.assert_array_equal(a.omegas, b.omegas)
    jp = jplates.PlateVelocityProvider(stages, smoothing=smoothing)
    tp = plates.PlateVelocityProvider(tst, smoothing=smoothing)
    x = sphere_points(300, 4, 1.2).astype(np.float32)
    for age in (0.0, 15.0):
        v = tp.velocity(torch.as_tensor(x), age)
        assert_close(v, jp.velocity(jnp.asarray(x), age), 1e-5, age)
        # tangential: v . x = 0
        assert (v * torch.as_tensor(x)).sum(-1).abs().max() < 1e-5 * (
            v.norm(dim=-1).max() + 1)
        np.testing.assert_allclose(
            float(tp.rms_velocity(torch.as_tensor(x), age)),
            float(jp.rms_velocity(jnp.asarray(x), age)), rtol=1e-5)
    with pytest.raises(ValueError):
        plates.PlateVelocityProvider([])


@functools.lru_cache(maxsize=None)
def storages(name):
    mk = {"annulus": lambda m: m.mesh_annulus(0.55, 1.0, 6, 1),
          "shell": lambda m: m.mesh_spherical_shell(1, 1, 0.55, 1.0),
          "cube": lambda m: m.mesh_unit_cube(1)}[name]
    return JStorage(mk(jmi), num_shards=1), CellStorage(mk(tmi))


@pytest.mark.parametrize("name", ["annulus", "shell"])
@pytest.mark.parametrize("degree", [1, 2])
def test_unique_weight_and_radial_profile(name, degree):
    js, ts = storages(name)
    jsp = (JP1 if degree == 1 else JP2)(js, 2)
    tsp = (P1Space if degree == 1 else P2Space)(ts, 2, device="cpu")
    node = getattr(tsp, "node_space", tsp)
    jnode = getattr(jsp, "node_space", jsp)
    w = node.unique_weight()
    np.testing.assert_allclose(w.numpy(), np.asarray(jnode.unique_weight()),
                               rtol=0, atol=1e-6)
    # every global DoF counted once
    np.testing.assert_allclose(float(w.sum()), node.num_global_dofs(),
                               rtol=1e-6)
    u = np.asarray(jsp.interpolate(
        lambda x: jnp.sqrt(jnp.sum(x * x, axis=-1)) + 0.1 * x[..., 0],
        jsp.zeros(), JDoF.ALL, JBC.all_dirichlet()))
    want = jprofiles.radial_profile(jsp, jnp.asarray(u), 0.55, 1.0, 5)
    got = profiles.radial_profile(tsp, interop.block_from_reference(
        u, device="cpu"), 0.55, 1.0, 5)
    np.testing.assert_allclose(got.radii, want.radii)
    for k in ("mean", "vmin", "vmax"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=0, atol=1e-6)


def test_viscosity_law():
    eta, jeta = (profiles.viscosity_profile_arrhenius(2.0),
                 jprofiles.viscosity_profile_arrhenius(2.0))
    T = np.linspace(-0.1, 1.1, 13, dtype=np.float32)
    assert_close(eta(torch.as_tensor(T)), jeta(jnp.asarray(T)), 1e-6)
    assert float(eta(torch.tensor(0.5))) == pytest.approx(1.0)


@pytest.mark.parametrize("name", sorted(tman.ALL))
def test_manufactured_matches_reference(name):
    t, j = tman.ALL[name], jman.ALL[name]
    assert (t.dim, t.description) == (j.dim, j.description)
    x = np.random.default_rng(6).uniform(0, 1, size=(40, t.dim)).astype(
        np.float32)
    for fn in ("u", "f"):
        got, want = getattr(t, fn)(torch.as_tensor(x)), getattr(j, fn)(
            jnp.asarray(x))
        for g, w in zip(*((got, want) if isinstance(got, tuple)
                          else ((got,), (want,)))):
            assert_close(g, w, 1e-5, f"{name} {fn}")


def test_spectral_radius_matches_reference():
    js, ts = storages("cube")
    jsp, tsp = JP1(js, 3), P1Space(ts, 3, device="cpu")
    jA, tA = JP1Op(jsp, jforms.laplace_form), P1ElementwiseOperator(
        tsp, forms.laplace_form)
    x0 = np.asarray(jsp.exchange_rep(jnp.asarray(
        np.random.default_rng(8).normal(size=jsp.block_shape).astype(
            np.float32)) * jnp.asarray(jsp.vertex_mask[None],
                                       jnp.float32)))
    want = float(jradius(jA.apply_raw, lambda a, b: jsp.dot(a, b,
                                                            JDoF.ALL),
                         jnp.asarray(x0), iters=15))
    got = estimate_spectral_radius_op(
        tA.apply_raw, lambda a, b: tsp.dot(a, b, DoFType.ALL),
        torch.as_tensor(x0), iters=15)
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_config_and_timing(tmp_path):
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"solver": {"max_level": 4}, "ra": 1e4}))
    p = load_config(str(cfg))
    assert p.solver.max_level == 4 and p.ra == 1e4
    q = p.with_overrides({"solver.max_level": 6, "new.key": 1})
    assert q.solver.max_level == 6 and q.new.key == 1
    assert p.solver.max_level == 4 and from_dict({"a": 1}).a == 1
    with pytest.raises(ValueError):
        load_config(str(tmp_path / "c.yaml"))
    tt = TimingTree()
    for _ in range(2):
        with tt.scope("solve", sync="cpu"):
            with tt.scope("smooth", sync=torch.zeros(1)):
                pass
    d = json.loads(tt.json())
    solve, = d["children"]
    assert solve["count"] == 2 and solve["children"][0]["count"] == 2
    assert "smooth" in tt.pretty()
    tt.save(str(tmp_path / "t.json"))


def test_checkpoint_restore_prolongated(tmp_path):
    """A P1 field stored by the JAX package at level 2, restored into level
    3 through the port's P1Transfer, against the JAX package's restore."""
    js, ts = storages("cube")
    lin = lambda p: 1 + 2 * p[..., 0] - p[..., 2]
    u2 = np.asarray(JP1(js, 2).function().interpolate(lin).cells)
    exp = JExporter()
    exp.register("u", 2, u2)
    path = exp.store(str(tmp_path), "ckpt", timestep=1)
    imp = CheckpointImporter(path)
    assert imp.levels_of("u") == [2]
    got = imp.restore_prolongated(
        "u", 2, 3, lambda l: P1Transfer(P1Space(ts, l, device="cpu"),
                                        P1Space(ts, l + 1, device="cpu")),
        device="cpu")
    from hyteg_tpu.io.checkpoint import CheckpointImporter as JImporter

    want = JImporter(path).restore_prolongated(
        "u", 2, 3, lambda l: JTransfer(JP1(js, l), JP1(js, l + 1)))
    assert_close(got, np.asarray(want), 1e-6, "prolongated")
