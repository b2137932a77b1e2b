"""The coupled convection simulation (terraneo/simulation.py) of the PyTorch
port against the JAX package, with the parameters of
tests/test_terraneo.py:15-19 (the annulus mesh_annulus(0.55, 1, 6, 1) at
P2 level 2, Ra 1e4): the initial temperature and the buoyancy rhs, one
Stokes solve (MINRES, 80 steps at most), two coupled steps from the same
state, the eta(T) and heating variants, checkpoints across the packages
in both directions, and the port's app for one step on the CPU.

The JAX simulation jits its Stokes solve and energy step; the port runs them
eagerly. Both start from the same state (interop carries it across), so
their outputs are compared directly.

Tolerances (float32; MINRES and CG run in another summation order, and
an 80-step MINRES that has not converged amplifies that): T, the rhs and
the viscosity 1e-5 of their max; the MINRES iteration count within 2 of
the JAX package's; velocity and pressure after a solve 1e-3 of their
max; T after a coupled step 1e-4 of max|T|; dt 1e-4 relative. The
epsilon system (eta(T)) after 40 MINRES steps: 2e-2 of max|u|, since its
float32 Lanczos recurrence amplifies rounding there: the JAX package's
own solve moves by 2.2e-3 / 2.9e-3 of max|u| when b is scaled by
1 + 1e-7, and the two packages agree to 1e-5 after 20 steps.
Checkpoints cross bit for bit.
"""

import glob
import json
import math

import numpy as np
import pytest
import torch

from hyteg_tpu.io.checkpoint import CheckpointImporter as JImporter
from hyteg_tpu.terraneo import ConvectionParameters as JParams
from hyteg_tpu.terraneo import ConvectionSimulation as JSim
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.types import DoFType
from hyteg_tpu_torch.io.checkpoint import CheckpointImporter
from hyteg_tpu_torch.terraneo import ConvectionParameters, ConvectionSimulation
from hyteg_tpu_torch.terraneo.simulation import make_convection_simulation

torch.set_num_threads(1)

PARAMS = dict(dim=2, ntan=6, nrad=1, level=2, rayleigh=1e4, stokes_iters=80,
              stokes_rtol=1e-6, energy_cg_iters=120, max_dt=5e-4,
              profile_bins=6)
FIELD_RTOL = 1e-5
SOLVE_RTOL = 1e-3
STEP_RTOL = 1e-4
EPS_SOLVE_RTOL = 2e-2


def assert_close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, (what, err, scale)


def assert_vel_close(tsim, jsim, rtol, what):
    for d in range(tsim.dim):
        assert_close(tsim.x.vel[d], jsim.x.vel[d], rtol, f"{what} u{d}")
    assert_close(tsim.x.pre, jsim.x.pre, rtol, f"{what} p")


def same_state(tsim, jsim):
    """Set the port's state to the JAX simulation's."""
    tsim.state = interop.convection_state_from_reference(
        np.asarray(jsim.T), [np.asarray(v) for v in jsim.x.vel],
        np.asarray(jsim.x.pre), jsim.time, jsim.step_count, device="cpu")


@pytest.fixture(scope="module")
def sims():
    return (JSim(JParams(**PARAMS)),
            ConvectionSimulation(ConvectionParameters(**PARAMS),
                                 device="cpu"))


def test_initial_state_and_rhs(sims):
    jsim, tsim = sims
    assert_close(tsim.T, jsim.T, FIELD_RTOL, "T0")
    T = tsim.T.numpy()
    assert np.isfinite(T).all() and T.min() >= -1e-5 and T.max() <= 1 + 1e-5
    jb, tb = jsim.buoyancy_rhs(jsim.T), tsim.buoyancy_rhs(tsim.T)
    for d in range(2):
        assert_close(tb.vel[d], jb.vel[d], FIELD_RTOL, f"rhs {d}")
    assert not tb.pre.any()
    jp, tp = jsim.temperature_profile(), tsim.temperature_profile()
    np.testing.assert_allclose(tp.radii, jp.radii)
    for k in ("mean", "vmin", "vmax"):
        np.testing.assert_allclose(getattr(tp, k), getattr(jp, k),
                                   rtol=0, atol=1e-5)
    assert tp.mean[0] > 0.7 and tp.mean[-1] < 0.3


def test_stokes_solve_matches_reference(sims):
    jsim, tsim = sims
    ji = jsim.solve_stokes()
    ti = tsim.solve_stokes()
    assert abs(ti - ji) <= 2, (ti, ji)
    assert math.isfinite(tsim.stokes_residual)
    assert_vel_close(tsim, jsim, SOLVE_RTOL, "solve")
    # tests/test_terraneo.py's gates: visible flow, small divergence
    vmax = max(float(tsim.T_space.dof_max(v.abs(), DoFType.ALL))
               for v in tsim.x.vel)
    assert math.isfinite(vmax) and vmax > 1.0
    st = tsim.stokes
    div = st.pre_space.exchange_add(st.B.apply_div_local(
        tsim.x.vel.unbind(0)), st._pre_sd)
    assert math.sqrt(float(st.pre_space.dot(div, div, DoFType.ALL,
                                            st._pre_sd))) < 0.05 * vmax


def test_two_coupled_steps_match_reference(sims):
    jsim, tsim = sims
    same_state(tsim, jsim)
    for _ in range(2):
        jdt, tdt = jsim.step(), tsim.step()
        np.testing.assert_allclose(tdt, jdt, rtol=1e-4)
        assert_close(tsim.T, jsim.T, STEP_RTOL, "T")
    assert tsim.step_count == jsim.step_count == 2
    np.testing.assert_allclose(tsim.time, jsim.time, rtol=1e-4)
    T = tsim.T.numpy()
    assert np.isfinite(T).all() and T.min() >= -0.05 and T.max() <= 1.05
    np.testing.assert_allclose(tsim.nusselt_like(), jsim.nusselt_like(),
                               rtol=1e-4)
    # the timing tree: the Stokes solve, and MMOC and the energy step under
    # the energy solve, each counted per step
    root = tsim.timing.root.children
    assert root["solveStokes"].count == 3
    energy = root["solveEnergy"]
    assert energy.count == 2
    assert {c: energy.children[c].count for c in energy.children} == {
        "MMOC": 2, "energyStep": 2}
    assert json.loads(tsim.timing.json())["name"] == "root"


def test_checkpoints_cross_bit_for_bit(sims, tmp_path):
    """A checkpoint written by either package restores in the other,
    value for value."""
    jsim, tsim = sims
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jsim.p.checkpoint_dir, tsim.p.checkpoint_dir = str(jdir), str(tdir)
    jsim.store_checkpoint()
    tsim.store_checkpoint()
    jpath, = glob.glob(str(jdir / "*.npz"))
    tpath, = glob.glob(str(tdir / "*.npz"))
    # JAX -> port
    probe = ConvectionSimulation(ConvectionParameters(**PARAMS), device="cpu")
    probe.restore_checkpoint(jpath)
    np.testing.assert_array_equal(probe.T.numpy(), np.asarray(jsim.T))
    for d in range(2):
        np.testing.assert_array_equal(probe.x.vel[d].numpy(),
                                      np.asarray(jsim.x.vel[d]))
    np.testing.assert_array_equal(probe.x.pre.numpy(), np.asarray(jsim.x.pre))
    assert (probe.time, probe.step_count) == (jsim.time, jsim.step_count)
    # port -> JAX (the reference's importer and simulation)
    jimp = JImporter(tpath)
    assert jimp.attrs == {"time": tsim.time, "step": tsim.step_count}
    jprobe = JSim(JParams(**PARAMS))
    jprobe.restore_checkpoint(tpath)
    np.testing.assert_array_equal(np.asarray(jprobe.T), tsim.T.numpy())
    np.testing.assert_array_equal(np.asarray(jprobe.x.pre), tsim.x.pre.numpy())
    for d in range(2):
        np.testing.assert_array_equal(np.asarray(jprobe.x.vel[d]),
                                      tsim.x.vel[d].numpy())
    # the headers list the same entries
    th, jh = CheckpointImporter(tpath).header, jimp.header
    assert th["entries"] == JImporter(jpath).header["entries"] == jh["entries"]


def test_eta_T_variant_matches_reference():
    """visc_activation > 0: K is the epsilon operator with eta(T) =
    exp(E(0.5 - T)) (tests/test_terraneo.py:80-98's parameters)."""
    kw = dict(dim=2, ntan=6, nrad=1, level=2, visc_activation=2.0,
              stokes_iters=40, max_dt=1e-3)
    jsim = JSim(JParams(**kw))
    tsim = ConvectionSimulation(ConvectionParameters(**kw), device="cpu")
    assert tsim.stokes.use_epsilon
    mu = tsim.viscosity_field()
    assert_close(mu, jsim.viscosity_field(), FIELD_RTOL, "eta")
    mask = tsim.T_space.vertex_mask_t.bool().expand(mu.shape)
    assert float(mu[mask].max() / mu[mask].min()) > 2.0
    jdt, tdt = jsim.step(), tsim.step()
    assert abs(tsim.stokes_iterations - 40) <= 2
    assert_vel_close(tsim, jsim, EPS_SOLVE_RTOL, "eta(T)")
    np.testing.assert_allclose(tdt, jdt, rtol=1e-3)
    assert_close(tsim.T, jsim.T, SOLVE_RTOL, "T")


def test_heating_variant_matches_reference():
    """Shear and adiabatic heating in the energy step
    (tests/test_terraneo.py:101-118's parameters)."""
    kw = dict(dim=2, level=2, ntan=6, nrad=1, rayleigh=1e3,
              shear_heating=True, adiabatic_heating=0.1, visc_activation=1.0,
              stokes_iters=15)
    jsim = JSim(JParams(**kw))
    tsim = ConvectionSimulation(ConvectionParameters(**kw), device="cpu")
    jsim.solve_stokes()
    tsim.solve_stokes()
    assert_vel_close(tsim, jsim, SOLVE_RTOL, "heating solve")
    same_state(tsim, jsim)
    T_before = tsim.T.clone()
    jsim.solve_energy(1e-3)
    tsim.solve_energy(1e-3)
    assert_close(tsim.T, jsim.T, STEP_RTOL, "heated T")
    assert torch.isfinite(tsim.T).all()
    assert float((tsim.T - T_before).abs().max()) > 0


def test_more_shards_name_a8():
    # A8 is ported: more than one shard gives the sharded simulation
    from hyteg_tpu_torch.terraneo.spmd_sim import ShardedConvectionSimulation

    assert isinstance(make_convection_simulation(
        ConvectionParameters(**PARAMS), num_shards=2, device="cpu"),
        ShardedConvectionSimulation)
    sim = make_convection_simulation(ConvectionParameters(**PARAMS),
                                     device="cpu")
    assert isinstance(sim, ConvectionSimulation)


def test_app_one_step_on_cpu(tmp_path):
    from hyteg_tpu_torch.apps import terraneo_convection as app

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({**PARAMS, "stokes_iters": 20,
                               "unknown_key": 1}))
    out = tmp_path / "out"
    assert app.main([str(cfg), "--steps", "1", "--device", "cpu",
                     "--out", str(out), "--vtk-every", "1"]) == 0
    rows = json.loads((out / "metrics.json").read_text())
    assert len(rows) == 1 and rows[0]["step"] == 1
    assert rows[0]["dt"] > 0 and rows[0]["vrms"] > 0
    timing = json.loads((out / "timing.json").read_text())
    assert {c["name"] for c in timing["children"]} == {"solveStokes",
                                                      "solveEnergy"}
    prof = np.loadtxt(out / "radial_profile.txt")
    assert prof.shape == (PARAMS["profile_bins"], 4)
    # --vtk-every writes T on its P2 node grid (tests/test_torch_io.py
    # reads the file back)
    assert "UnstructuredGrid" in (out / "convection_ts1.vtu").read_text()


def gate_values(sim, dof_max, div_local, dot, pre_sp, pre_sd, mask, T):
    """(max|u|, ||div u|| / max|u|, T min, T max) of a simulation's state."""
    vmax = max(float(dof_max(v)) for v in sim.x.vel)
    div = pre_sp.exchange_add(div_local(sim.x.vel), pre_sd)
    div_rel = math.sqrt(float(dot(div))) / vmax
    Tk = np.asarray(T)[np.broadcast_to(mask, np.shape(T))]
    return vmax, div_rel, float(Tk.min()), float(Tk.max())


def last_solve_residual(sim, T, flag) -> float:
    """||b - A x||_P / ||b||_P of ``sim``'s last Stokes solve, made on
    temperature T (P the block-diagonal preconditioner: the norm of
    MINRES's residual estimate); either package's simulation."""
    st, mu = sim.stokes, sim.viscosity_field(T)
    prec = st.block_diag_preconditioner(mu=mu)
    b = sim.buoyancy_rhs(T)
    r = b - st.apply_inner(sim.x, flag, mu=mu)
    return math.sqrt(float(st.dot(r, prec(r), flag))
                     / float(st.dot(b, prec(b), flag)))


CASES = {
    # chip_smoke.TERRANEO_ANNULUS at coarser levels
    "annulus": dict(dim=2, ntan=12, nrad=2, visc_activation=2.0,
                    shear_heating=True, adiabatic_heating=0.1),
    # chip_smoke.TERRANEO_SHELL at coarser levels
    "shell": dict(dim=3, ntan=2, nrad=2),
}


def main(case, levels):
    """Both simulations on the CPU at one of the card's cases (defaults
    otherwise: 120 MINRES steps) at coarser levels: two steps each, then
    tests/test_terraneo.py's gate values and the last Stokes solve's true
    residual against |b|. Usage:
    python -m tests.test_torch_terraneo [annulus|shell] 2 3 4"""
    import jax.numpy as jnp
    from hyteg_tpu.core.types import FLAG_INNER as JFLAG_INNER
    from hyteg_tpu.core.types import DoFType as JDoF
    from hyteg_tpu_torch.core.types import FLAG_INNER

    kw = CASES[case]
    for level in levels:
        jsim = JSim(JParams(**kw, level=level))
        tsim = ConvectionSimulation(ConvectionParameters(**kw, level=level),
                                    device="cpu")
        for _ in range(2):
            jT, tT = jsim.T, tsim.T.clone()
            jsim.step()
            tsim.step()
        js, ts = jsim.stokes, tsim.stokes
        jv = gate_values(
            jsim, lambda v: jsim.T_space.dof_max(jnp.abs(v), JDoF.ALL),
            js.B.apply_div_local,
            lambda d: js.pre_space.dot(d, d, JDoF.ALL, js._pre_sd),
            js.pre_space, js._pre_sd, np.asarray(jsim.T_space.vertex_mask),
            jsim.T)
        tv = gate_values(
            tsim, lambda v: tsim.T_space.dof_max(v.abs(), DoFType.ALL),
            lambda vel: ts.B.apply_div_local(vel.unbind(0)),
            lambda d: ts.pre_space.dot(d, d, DoFType.ALL, ts._pre_sd),
            ts.pre_space, ts._pre_sd,
            tsim.T_space.vertex_mask_t.bool().numpy(), tsim.T.numpy())
        res = (last_solve_residual(jsim, jT, JFLAG_INNER),
               last_solve_residual(tsim, tT, FLAG_INNER))
        for name, v, r in (("jax", jv, res[0]), ("port", tv, res[1])):
            print(f"{case} level {level} {name}: max|u| {v[0]:.4g}  "
                  f"div/max|u| {v[1]:.4g}  T in [{v[2]:.4g}, {v[3]:.4g}]  "
                  f"|b - Ax|_P/|b|_P {r:.4g}", flush=True)


if __name__ == "__main__":
    import sys

    args = sys.argv[1:]
    case = args.pop(0) if args and args[0] in CASES else "annulus"
    main(case, [int(a) for a in args] or [2, 3, 4])
