"""TerraNeo-style mantle convection: buoyancy-coupled Stokes flow +
energy transport on an annulus (2D) or icosahedral spherical shell (3D);
torch counterpart of hyteg_tpu/terraneo/simulation.py, on one device.

Reference: apps/TerraNeo/Origin/Simulation.hpp (ConvectionSimulation with
init / step / solveStokes / solveEnergy, Convection.cpp:27-60 time loop),
src/terraneo/. Differences by design, as in the JAX package: the energy
advection is the semi-Lagrangian MMOC analog (transport/mmoc.py) instead
of migrating particles, and the Stokes solve is preconditioned MINRES on
the P2-P1 Taylor-Hood block system. Where the JAX package jits the Stokes
solve and the energy step once, these are plain methods run eagerly; the
viscosity field eta(T) is evaluated again on every solve, as there.

Kernels on this path (CUDA tensors): B5 for the energy Laplace and mass
and for the constant-viscosity K once per velocity component, B3 for the
lumped pressure mass of the MINRES preconditioner (their 2D forms on the
annulus); a variable viscosity switches K to the plain epsilon operator.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..composites.stokes import P2P1TaylorHoodStokes, TaylorHoodVec
from ..core.timing import TimingTree
from ..core.types import BoundaryCondition, DoFType, FLAG_INNER
from ..functions.p2 import P2Space
from ..io.checkpoint import CheckpointExporter, CheckpointImporter
from ..mesh import meshinfo as mi
from ..numerictools import UnsteadyDiffusion, cfl_max_dt
from ..operators.p2_elementwise import P2ElementwiseOperator
from ..primitives.storage import CellStorage
from ..solvers.krylov import minres_solve
from ..transport import MMOCTransport
from .params import ConvectionParameters
from .profiles import RadialProfile, radial_profile, \
    viscosity_profile_arrhenius
from .transport_std import shear_heating_source


def make_convection_simulation(params: ConvectionParameters | None = None,
                               num_shards: int = 1, *, device, **kwargs):
    """Factory for the convection simulation at any shard count
    (reference: apps/TerraNeo/Origin/Convection.cpp). num_shards == 1
    returns the single-device ConvectionSimulation (MMOC transport,
    MINRES Stokes); num_shards > 1 the ShardedConvectionSimulation
    (sharded Uzawa-GMG Stokes and sharded SUPG energy over a shard group;
    ``kwargs`` go to it, e.g. ``group``, ``stokes_cycles``)."""
    if num_shards == 1:
        return ConvectionSimulation(params, device=device)
    from .spmd_sim import ShardedConvectionSimulation

    return ShardedConvectionSimulation(params, num_shards=num_shards,
                                       device=device, **kwargs)


@dataclasses.dataclass
class ConvectionState:
    """What a time step carries: temperature, the Taylor-Hood solution
    (the next solve's start), model time and step count."""

    T: torch.Tensor
    x: TaylorHoodVec
    time: float
    step_count: int


class ConvectionSimulation:
    """Couples the Stokes momentum balance and the energy equation:

        -div(2 eta eps(u)) + grad p = Ra T e_r,   div u = 0
        dT/dt + u . grad T = kappa Lap T + H

    with T = 1 on the inner rim, T = 0 on the outer rim, no-slip velocity.
    ``device`` has no default. The last Stokes solve's MINRES steps and
    residual estimate are ``stokes_iterations`` / ``stokes_residual``, the
    last energy step's CG steps ``self.energy.last_iterations``.
    """

    def __init__(self, params: ConvectionParameters | None = None, *,
                 device):
        self.p = p = params or ConvectionParameters()
        self.device = torch.device(device)
        if p.dim == 2:
            mesh = mi.mesh_annulus(p.rmin, p.rmax, p.ntan, p.nrad)
        else:
            mesh = mi.mesh_spherical_shell(p.ntan, p.nrad, p.rmin, p.rmax)
        self.storage = CellStorage(mesh, num_shards=1)
        self.dim = self.storage.dim
        self.level = p.level
        self.timing = TimingTree()

        # temperature space & operators
        self.T_space = P2Space(self.storage, p.level, device=device)
        self.T_bc = BoundaryCondition.all_dirichlet()
        self.A_T = P2ElementwiseOperator(self.T_space, "laplace")
        self.M_T = P2ElementwiseOperator(self.T_space, "mass")
        self.energy = UnsteadyDiffusion(
            self.T_space, self.A_T, self.M_T, self.T_bc, theta=p.theta,
            cg_iters=p.energy_cg_iters, cg_rtol=p.energy_cg_rtol,
        )
        self.energy.A = _Scaled(self.A_T, p.diffusivity)

        # Stokes block system (velocity shares the P2 node grid with T).
        # visc_activation > 0 switches the viscous block to the
        # variable-viscosity epsilon operator with eta(T) = exp(E(0.5 - T))
        # re-evaluated every Stokes solve (reference: src/terraneo/
        # operators/P2P1StokesOperatorWithWrapper + Viscosity.hpp).
        self.vel_bc = BoundaryCondition.all_dirichlet()
        self._eta_fn = (viscosity_profile_arrhenius(p.visc_activation)
                        if p.visc_activation > 0.0 else None)
        self.stokes = P2P1TaylorHoodStokes(
            self.storage, p.level, self.vel_bc, viscosity=p.viscosity,
            epsilon=self._eta_fn is not None, device=device)
        self.transport = MMOCTransport(self.storage, p.level, degree=2,
                                       vel_degree=2, device=device)

        # radial unit vector at T/velocity nodes
        xyz = self.T_space.coords()
        r = torch.sqrt(torch.sum(xyz[..., : self.dim] ** 2, dim=-1,
                                 keepdim=True))
        self._e_r = xyz[..., : self.dim] / torch.clamp(r, min=1e-30)
        del xyz, r
        self._h_min = self._min_edge() / (1 << p.level)
        self.time = 0.0
        self.step_count = 0
        self.stokes_iterations = 0
        self.stokes_residual = math.nan

        self.T = self.initial_temperature()
        self.x = self.stokes.zeros()

    # -- setup ----------------------------------------------------------------

    def _min_edge(self) -> float:
        v = np.asarray(self.storage.cell_vertices)[
            np.asarray(self.storage.cell_valid)
        ][..., : self.dim]
        nv = v.shape[1]
        e = min(
            float(np.linalg.norm(v[:, i] - v[:, j], axis=-1).min())
            for i in range(nv) for j in range(i + 1, nv)
        )
        return e

    def conductive_profile(self, x):
        p = self.p
        r = torch.sqrt(torch.sum(x[..., : self.dim] ** 2, dim=-1))
        # straight-edged macro rims have chord nodes with r slightly outside
        # [rmin, rmax] -> clip so T stays in [0, 1]
        return torch.clamp((p.rmax - r) / (p.rmax - p.rmin), 0.0, 1.0)

    def initial_temperature(self, perturbation: float = 0.1):
        """Conductive profile + single-harmonic lateral perturbation
        (reference: terraneo initial condition helpers)."""
        p = self.p

        def T0(x):
            base = self.conductive_profile(x)
            theta = torch.atan2(x[..., 1], x[..., 0])
            r = torch.sqrt(torch.sum(x[..., : self.dim] ** 2, dim=-1))
            s = torch.sin(math.pi * (r - p.rmin) / (p.rmax - p.rmin))
            return torch.clamp(base + perturbation * s * torch.cos(4 * theta),
                               0, 1)

        sp = self.T_space
        T = sp.interpolate(T0, sp.zeros(), DoFType.ALL, self.T_bc)
        # exact boundary values on the rims
        return sp.interpolate(self.conductive_profile, T, DoFType.DIRICHLET,
                              self.T_bc)

    # -- state ----------------------------------------------------------------

    @property
    def state(self) -> ConvectionState:
        return ConvectionState(self.T, self.x, self.time, self.step_count)

    @state.setter
    def state(self, s: ConvectionState) -> None:
        self.T, self.x = s.T, s.x
        self.time, self.step_count = float(s.time), int(s.step_count)

    # -- physics --------------------------------------------------------------

    def buoyancy_rhs(self, T) -> TaylorHoodVec:
        """f = Ra * M (T e_r), Dirichlet velocity rows zeroed."""
        st = self.stokes
        vel = torch.stack([
            self.T_space._restore_rows_(
                self.p.rayleigh * self.M_T.apply_raw(T * self._e_r[..., d],
                                                     sd=st._vel_sd),
                None, FLAG_INNER, st._vel_sd)
            for d in range(self.dim)])
        return TaylorHoodVec(vel, torch.zeros_like(self.x.pre))

    def _stokes_solve(self, b, x0, mu):
        st, p = self.stokes, self.p
        prec = st.block_diag_preconditioner(mu=mu)
        x, iters, phibar = minres_solve(
            lambda v: st.apply_inner(v, FLAG_INNER, mu=mu),
            lambda u, v: st.dot(u, v, FLAG_INNER),
            b, x0, p.stokes_iters, rtol=p.stokes_rtol, prec_fn=prec,
        )
        return TaylorHoodVec(x.vel, st.project_mean(x.pre)), iters, phibar

    def viscosity_field(self, T=None):
        """Nodal eta(T) on the velocity node grid, or None (constant)."""
        if self._eta_fn is None:
            return None
        return self._eta_fn(self.T if T is None else T)

    def solve_stokes(self, T=None) -> int:
        T = self.T if T is None else T
        with self.timing.scope("solveStokes", sync=self.device):
            b = self.buoyancy_rhs(T)
            self.x, iters, phibar = self._stokes_solve(
                b, self.x, self.viscosity_field(T))
            self.stokes_residual = float(phibar)
        self.stokes_iterations = int(iters)
        return self.stokes_iterations

    def _energy_step(self, T, vel, dt):
        p = self.p
        with self.timing.scope("MMOC", sync=self.device):
            Tadv = self.transport.step(T, vel, dt, rk=p.mmoc_rk,
                                       substeps=p.mmoc_substeps)
        with self.timing.scope("energyStep", sync=self.device):
            f = None
            if p.internal_heating != 0.0:
                f = torch.full_like(Tadv, p.internal_heating)
            if p.shear_heating:
                # viscous dissipation of the P1 interpolant of the P2
                # velocity on the node grid (reference:
                # src/terraneo/operators/TransportOperatorStd.hpp:264)
                eta = self.viscosity_field(T)
                if eta is None:
                    eta = torch.full_like(Tadv, p.viscosity)
                Q = shear_heating_source(self.T_space.node_space, vel, eta)
                f = Q if f is None else f + Q
            if p.adiabatic_heating != 0.0:
                # dT/dt += -C_a T (compressible adiabatic cooling analog,
                # explicit in T^n: TransportOperatorStd.hpp:187)
                g = -p.adiabatic_heating * Tadv
                f = g if f is None else f + g
            return self.energy.step(Tadv, dt, f_new=f)

    def solve_energy(self, dt):
        """The MMOC transport, then the implicit energy step; each has its
        scope (``MMOC``, ``energyStep``) under ``solveEnergy``."""
        with self.timing.scope("solveEnergy", sync=self.device):
            self.T = self._energy_step(self.T, self.x.vel, dt)

    def pick_dt(self) -> float:
        vmax = 0.0
        for v in self.x.vel:
            vmax = max(vmax, float(self.T_space.dof_max(v.abs(),
                                                        DoFType.ALL)))
        if vmax == 0.0:
            return self.p.max_dt
        return float(min(self.p.max_dt,
                         cfl_max_dt(self._h_min, vmax, self.p.cfl)))

    # -- time stepping ----------------------------------------------------------------

    def step(self):
        """One coupled time step (reference: ConvectionSimulation::step)."""
        p = self.p
        if self.step_count % p.stokes_every == 0:
            self.solve_stokes()
        dt = self.pick_dt()
        self.solve_energy(dt)
        self.time += dt
        self.step_count += 1
        if (p.checkpoint_dir and p.checkpoint_every
                and self.step_count % p.checkpoint_every == 0):
            self.store_checkpoint()
        return dt

    def run(self, n_steps: int):
        for _ in range(n_steps):
            self.step()

    # -- observability ----------------------------------------------------------

    def temperature_profile(self, nbins: int | None = None) -> RadialProfile:
        return radial_profile(self.T_space, self.T, self.p.rmin, self.p.rmax,
                              nbins or self.p.profile_bins)

    def nusselt_like(self) -> float:
        """Mean conductive heat flux proxy at the outer bin (observability
        metric, not the exact boundary Nusselt integral)."""
        prof = self.temperature_profile()
        dr = (self.p.rmax - self.p.rmin) / len(prof.radii)
        return float((prof.mean[-2] - prof.mean[-1]) / dr)

    def store_checkpoint(self):
        """The JAX package's file: T, u0..u{dim-1}, p at this level, with
        the model time and step as attributes."""
        exp = CheckpointExporter()
        exp.register("T", self.level, self.T)
        for d in range(self.dim):
            exp.register(f"u{d}", self.level, self.x.vel[d])
        exp.register("p", self.level, self.x.pre)
        exp.add_attribute("time", self.time)
        exp.add_attribute("step", self.step_count)
        exp.store(self.p.checkpoint_dir, "convection",
                  timestep=self.step_count)

    def restore_checkpoint(self, path: str):
        imp = CheckpointImporter(path)
        dev = self.device
        self.T = torch.as_tensor(imp.restore("T", self.level), device=dev)
        vel = torch.stack([torch.as_tensor(imp.restore(f"u{d}", self.level),
                                           device=dev)
                           for d in range(self.dim)])
        self.x = TaylorHoodVec(vel, torch.as_tensor(
            imp.restore("p", self.level), device=dev))
        self.time = float(imp.attrs.get("time", 0.0))
        self.step_count = int(imp.attrs.get("step", 0))


class _Scaled:
    """kappa * A wrapper matching the elementwise-operator apply interface."""

    def __init__(self, op, scale: float):
        self.op = op
        self.scale = scale

    def apply_raw(self, x, coeff=None, sd=None):
        return self.scale * self.op.apply_raw(x, coeff=coeff, sd=sd)
