"""Sharded TerraNeo convection step (torch counterpart of
hyteg_tpu/terraneo/spmd_sim.py).

One coupled mantle-convection time step over a shard group (reference:
apps/TerraNeo/Origin/Convection.cpp:27-60,
apps/2020-scaling-workshop/Helpers.cpp:103-173):

  * momentum: Taylor-Hood Stokes with the buoyancy rhs Ra T e_r, solved by
    ``stokes_cycles`` sharded Uzawa GMG V-cycles
    (parallel/spmd.py:build_spmd_stokes_vcycle; kernel B5 per velocity
    component, B3 for the lumped pressure mass),
  * energy: temperature as P1 on the velocity node grid (level + 1), one
    implicit-diffusion / explicit-SUPG-advection theta step whose CG runs
    inside the group with global dots (kernel B2 for the Laplace and mass
    applies).

The step is the same at any shard count up to rounding, which the tests
and the card's smoke run hold S shards against 1 to (the reference's
multi-rank-vs-serial pattern). State is per-shard lists: T blocks and
TaylorHoodVec solutions, aligned with ``group.local_ranks``.
"""

from __future__ import annotations

import math

import torch

from ..composites.stokes import TaylorHoodVec, stokes_spaces
from ..core.types import DoFType, FLAG_INNER
from ..mesh import meshinfo as mi
from ..operators import forms
from ..operators.p1_elementwise import P1ElementwiseOperator
from ..parallel.comm import LocalGroup
from ..parallel.spmd import SpmdContext, build_spmd_stokes_vcycle, warm_tables
from ..primitives.storage import CellStorage
from .params import ConvectionParameters
from .transport_std import SUPGAdvectionOperator


class _ShardEnergy:
    """One shard's energy-step operators and its radial unit vector."""

    def __init__(self, sim: "ShardedConvectionSimulation", group):
        sp, r = sim.T_sp, group.rank
        self.sd = sp.group_shard_data(group, sim.ctx.bc)
        self.A = P1ElementwiseOperator(sp, forms.laplace_form, shard=r)
        self.M = P1ElementwiseOperator(sp, forms.mass_form, shard=r)
        self.adv = SUPGAdvectionOperator(sp, supg=True, shard=r,
                                         kappa=sim.p.diffusivity)
        xyz = sp.coords_from(self.sd.cell_vertices)[..., :sim.dim]
        rad = torch.sqrt(torch.sum(xyz ** 2, dim=-1, keepdim=True))
        self.e_r = (xyz / torch.clamp(rad, min=1e-30)).movedim(-1, 0)


class ShardedConvectionSimulation:
    """The sharded convection model: ``initial_state()`` then ``step(T,
    x)`` on per-shard lists. ``group`` defaults to a LocalGroup of
    ``num_shards`` shards on ``device``; a DistGroup runs one shard per
    process.

    The Stokes coarse MINRES runs to ``coarse_rtol`` in at most
    ``coarse_iters`` steps. The JAX package's simulation runs 80 steps to rtol
    1e-8, which float32 does not reach. On the annulus of its test (level
    1, ntan 8) MINRES converges in ~15 steps, and from ~40 on its true
    residual grows while its estimate keeps falling (30.4 of 369 at 80):
    the step then depends on the shard count at the 1e-2 level (ROADMAP
    C-ref1). On the shell, 80 steps stop short of convergence (1e-4 of the
    start on mesh_spherical_shell(1, 2) at level 1), and the partial
    solution differs between shard counts by 3e-5. 1e-6 in at most 400
    steps converges both (15 and ~100 steps) and stops before the drift.
    Pass coarse_iters=80, coarse_rtol=1e-8 for the JAX package's step."""

    def __init__(self, params: ConvectionParameters | None = None,
                 num_shards: int = 1, *, device, group=None,
                 stokes_cycles: int = 2, partitioner: str = "round_robin", coarse_iters: int = 400,
                 coarse_rtol: float = 1e-6):
        self.p = p = params or ConvectionParameters()
        if p.dim == 2:
            mesh = mi.mesh_annulus(p.rmin, p.rmax, p.ntan, p.nrad)
        else:
            mesh = mi.mesh_spherical_shell(p.ntan, p.nrad, p.rmin, p.rmax)
        self.storage = CellStorage(mesh, num_shards=num_shards,
                                   partitioner=partitioner)
        self.group = group if group is not None else LocalGroup(num_shards)
        self.ctx = SpmdContext(self.storage, self.group, device=device)
        self.dim = self.storage.dim
        self.level = p.level
        self.stokes_cycles = stokes_cycles

        # temperature lives on the velocity node grid: P1 at level + 1,
        # the finest velocity space's own node space
        self.Tlvl = p.level + 1
        pitch = (1 << self.Tlvl) + 1
        lrange = range(p.min_level, p.level + 1)
        spaces = {l: stokes_spaces(self.storage, l, pitch, device=device)
                  for l in lrange}
        self.T_sp = spaces[p.level][0].node_space
        warm_tables(self.T_sp)
        self.stokes_step = build_spmd_stokes_vcycle(
            self.ctx, p.min_level, p.level, viscosity=p.viscosity,
            eigs={l: 3.0 for l in lrange}, spaces_per_level=spaces,
            coarse_iters=coarse_iters, coarse_rtol=coarse_rtol)
        self._energy = self.ctx.run(lambda g: _ShardEnergy(self, g))

    def _stokes(self, g):
        return self.stokes_step.stacks[self.ctx.local_ranks.index(g.rank)] \
            .stokes[self.level]

    def initial_state(self):
        """(T, x): the conductive profile with a sin(4 theta) perturbation,
        and zero Stokes solutions."""
        p, dim = self.p, self.dim

        def T0(pt):
            r = torch.sqrt(torch.sum(pt[..., :dim] ** 2, dim=-1))
            base = torch.clamp((p.rmax - r) / (p.rmax - p.rmin), 0.0, 1.0)
            theta = torch.atan2(pt[..., 1], pt[..., 0])
            return base + 0.1 * torch.sin(4 * theta) * base * (1 - base)

        sp = self.T_sp
        T = self.ctx.run(lambda g, e: sp.interpolate(
            T0, sp.zeros(), DoFType.ALL, e.sd), self._energy)
        x = self.ctx.run(lambda g: self._stokes(g).zeros())
        return T, x

    def _buoyancy(self, e: _ShardEnergy, T: torch.Tensor) -> torch.Tensor:
        """Ra M (T e_r), (dim, C, N, lanes), Dirichlet rows zeroed."""
        sp, sd = self.T_sp, e.sd
        out = torch.stack([self.p.rayleigh * e.M.apply_raw(T * e.e_r[d], sd=sd)
                           for d in range(self.dim)])
        for d in range(self.dim):
            sp._restore_rows_(out[d], None, FLAG_INNER, sd)
        return out

    def _energy_step(self, e: _ShardEnergy, T, vel) -> torch.Tensor:
        """Implicit diffusion, explicit SUPG advection; fixed-count CG on
        the inner rows with Dirichlet rows carried through."""
        p, sp, sd = self.p, self.T_sp, e.sd
        dt = p.max_dt

        def lhs(x):
            y = e.M.apply_raw(x, sd=sd) + (dt * p.diffusivity) * \
                e.A.apply_raw(x, sd=sd)
            return sp._restore_rows_(y, None, FLAG_INNER, sd)

        rhs = e.M.apply_raw(T, sd=sd) - dt * e.adv.apply_raw(T, vel, sd=sd)
        if p.internal_heating != 0.0:
            rhs = rhs + dt * e.M.apply_raw(
                torch.full_like(T, p.internal_heating), sd=sd)
        rhs = sp._restore_rows_(rhs, T, FLAG_INNER, sd)

        def dot(u, v):
            return sp.dot(u, v, FLAG_INNER, sd)

        x = T
        r = sp._restore_rows_(rhs - lhs(x), None, FLAG_INNER, sd)
        q, rs = r, dot(r, r)
        for _ in range(p.energy_cg_iters):
            Aq = lhs(q)
            alpha = rs / torch.clamp(dot(q, Aq), min=1e-30)
            x = x + alpha * q
            r = r - alpha * Aq
            rs_new = dot(r, r)
            q = r + (rs_new / torch.clamp(rs, min=1e-30)) * q
            rs = rs_new
        return x

    def step(self, T: list, x: list):
        """One coupled step: Stokes V-cycles, then the energy step."""
        b = self.ctx.run(lambda g, e, t, xx: TaylorHoodVec(
            self._buoyancy(e, t), torch.zeros_like(xx.pre)),
            self._energy, T, x)
        for _ in range(self.stokes_cycles):
            x = self.stokes_step(x, b)
        T = self.ctx.run(lambda g, e, t, xx: self._energy_step(e, t, xx.vel),
                         self._energy, T, x)
        return T, x

    def observables(self, T: list, x: list) -> list:
        """[|T|, |u_0|, ..., |u_dim-1|] over the raw per-shard blocks, as
        the JAX package's test reads them (interface replicas counted
        once per cell, padding cells excluded)."""
        def body(g, t, xx):
            pad = self.T_sp.group_shard_data(g, self.ctx.bc).pad_cells

            def sq(a):
                a = a * a
                return (a if pad is None else a.index_fill_(0, pad, 0.0)).sum()

            parts = [sq(t)] + [sq(v) for v in xx.vel]
            return [float(g.all_reduce(s.double())) for s in parts]

        return [math.sqrt(v) for v in self.ctx.run(body, T, x)[0]]
