"""Inexact Uzawa smoother + Stokes GMG assembly; torch counterpart of
hyteg_tpu/solvers/uzawa.py (one shard of a storage; sharded through the
composites' group shard data).

Reference: src/hyteg/solvers/UzawaSmoother.hpp:99-481 and the
stokesSphere/scaling-workshop solver stack (apps/2020-scaling-workshop/
Helpers.cpp:103-173): GMG V-cycles on the P2-P1 block system with an
inexact Uzawa smoother (velocity sub-smoother on the viscous block, lumped
pressure-mass update) and a MINRES coarse solve. The sequential
Gauss-Seidel velocity sweeps of the reference become Chebyshev sweeps, as
in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..composites.stokes import P2P1TaylorHoodStokes, TaylorHoodVec
from ..core.types import BoundaryCondition, DoFType, FLAG_INNER
from ..operators.p2_transfer import P2Transfer
from ..operators.transfer import P1Transfer
from .gmg import GeometricMultigridSolver, GMGLevel
from .krylov import minres_solve
from .smoothers import chebyshev_smooth, estimate_spectral_radius


class UzawaSmoother:
    """One inexact-Uzawa sweep on the Stokes system.

    The velocity half-step smooths the full (possibly component-coupled
    epsilon) viscous block with Chebyshev over the (dim, ...) velocity
    block; the pressure takes a damped step with the inverse lumped P1
    mass (kernel B3 at set-up). ``eig_max`` (lambda_max of D^-1 K) is
    estimated by 20 power iterations from a random start drawn from
    ``generator`` when not given (reference: ChebyshevSmoother.hpp:558-717).
    """

    def __init__(self, stokes: P2P1TaylorHoodStokes, flag: DoFType = FLAG_INNER,
                 vel_smooth_order: int = 3, omega_p: float = 0.3,
                 eig_max=None, generator: torch.Generator | None = None):
        self.st = st = stokes
        self.flag = flag
        self.order = vel_smooth_order
        self.omega_p = omega_p
        self.k_invdiag = st.K_inverse_diagonal()
        self.pmass_inv = st.pressure_mass_inverse()
        if eig_max is None:
            eig_max = estimate_spectral_radius(
                self._apply_k_stacked, self.k_invdiag, self._dot_v,
                (st.dim,) + tuple(st.vel_space.block_shape), num_iter=20,
                generator=generator, dtype=st.vel_space.dtype)
        self.eig_max = float(eig_max)

    def _dot_v(self, u, v):
        st = self.st
        return sum(st.vel_space.dot(u[d], v[d], self.flag, st._vel_sd)
                   for d in range(st.dim))

    def _apply_k_stacked(self, v: torch.Tensor) -> torch.Tensor:
        """K on the (dim, ...) velocity, rows restricted to flag."""
        return self.st._restore_vel_(self.st.apply_K(v), None, self.flag)

    def __call__(self, x: TaylorHoodVec, b: TaylorHoodVec) -> TaylorHoodVec:
        st, flag = self.st, self.flag

        # velocity half-step: smooth K u = f - Bt p (coupled components)
        btp = st._restore_vel_(
            st._exchange_vel_(st.B.apply_gradient_local(x.pre)), None, flag)
        rhs = torch.sub(b.vel, btp, out=btp)
        u = chebyshev_smooth(self._apply_k_stacked, self.k_invdiag, rhs,
                             x.vel, self.eig_max, order=self.order)
        new_vel = st._restore_vel_(u, x.vel, flag)  # u is fresh

        # pressure update: p <- p + omega * Minv (B u - g)
        div = st.pre_space._exchange_add_(
            st.B.apply_div_local(new_vel.unbind(0)), st._pre_sd)
        upd = st._mask_pressure_(self.pmass_inv * div.sub_(b.pre))
        return TaylorHoodVec(new_vel, x.pre + self.omega_p * upd)


class StokesGMGStack(NamedTuple):
    """What make_stokes_gmg builds: the composite and the Uzawa smoother of
    every level, the GMG solver, and each level's eig_max."""

    stokes: dict
    gmg: GeometricMultigridSolver
    eigs: dict
    smoothers: dict


def make_stokes_gmg(
    storage,
    min_level: int,
    max_level: int,
    bc: BoundaryCondition | None = None,
    viscosity: float = 1.0,
    pre_smooth: int = 2,
    post_smooth: int = 2,
    omega_p: float = 0.3,
    coarse_iters: int = 80,
    flag: DoFType = FLAG_INNER,
    mu=None,
    epsilon: bool = False,
    full_viscous: bool = False,
    eigs: dict | None = None,
    elmats: dict | None = None,
    dtype=torch.float32,
    gmap=None,
    *,
    device,
    shard: int = 0,
    sd_per_level: dict | None = None,
    spaces_per_level: dict | None = None,
    coarse_rtol: float = 1e-8,
) -> StokesGMGStack:
    """GMG solver over the Stokes composite with Uzawa smoothing, on
    ``device``, which has no default.

    ``mu``: callable of coords (or None): variable-viscosity epsilon
    operator on every level. ``eigs``: optional per-level eig_max (skips
    the power iteration, e.g. values carried over from the JAX package);
    otherwise each level's is estimated from a torch.Generator seeded with
    the level. ``elmats``: optional {level: composite elmats dict} (see
    P2P1TaylorHoodStokes). ``gmap``: a geometry (blending) map, passed to
    every level's composite (blended epsilon and div / grad operators).
    The coarse solve is MINRES with the
    block-diagonal preconditioner, ``coarse_iters`` steps at most, to
    ``coarse_rtol`` (1e-8, as in the JAX package, which float32 does not
    reach: see ShardedConvectionSimulation). Sharded: ``shard`` and ``sd_per_level`` ({level: (velocity
    shard data, pressure shard data)}, e.g. with a group) go to every
    level's composite, ``spaces_per_level`` ({level: stokes_spaces(...)})
    lets shards share their spaces; the smoothers, transfers, dots and
    the coarse MINRES then run over the group."""
    lrange = range(min_level, max_level + 1)
    pitch = (1 << (max_level + 1)) + 1  # one lane pitch across all levels
    stokes = {l: P2P1TaylorHoodStokes(
        storage, l, bc, viscosity, device=device, dtype=dtype, pitch=pitch,
        mu_field=mu, epsilon=epsilon, full_viscous=full_viscous,
        elmats=(elmats or {}).get(l), gmap=gmap, shard=shard,
        vel_sd=(sd_per_level or {}).get(l, (None, None))[0],
        pre_sd=(sd_per_level or {}).get(l, (None, None))[1],
        spaces=(spaces_per_level or {}).get(l)) for l in lrange}
    gen = torch.Generator(device=stokes[min_level].device)
    smoothers = {}
    for l in lrange:
        gen.manual_seed(l)
        smoothers[l] = UzawaSmoother(stokes[l], flag, omega_p=omega_p,
                                     eig_max=(eigs or {}).get(l),
                                     generator=gen)
    vel_tr = {l: P2Transfer(stokes[l - 1].vel_space, stokes[l].vel_space)
              for l in range(min_level + 1, max_level + 1)}
    pre_tr = {l: P1Transfer(stokes[l - 1].pre_space, stokes[l].pre_space)
              for l in range(min_level + 1, max_level + 1)}

    def make_restrict(l):
        st_f, st_c = stokes[l], stokes[l - 1]

        def restrict(r: TaylorHoodVec) -> TaylorHoodVec:
            vel = torch.stack([
                vel_tr[l].restrict(rv, st_f._vel_sd, st_c._vel_sd)
                for rv in r.vel.unbind(0)])
            pre = pre_tr[l].restrict(r.pre, st_f._pre_sd, st_c._pre_sd)
            return TaylorHoodVec(st_c._restore_vel_(vel, None, flag),
                                 st_c._mask_pressure_(pre))

        return restrict

    def make_prolongate_add(l):
        st_f = stokes[l]

        def padd(xc: TaylorHoodVec, xf: TaylorHoodVec) -> TaylorHoodVec:
            vel = torch.stack([
                vel_tr[l].prolongate_and_add(xc.vel[d], xf.vel[d])
                for d in range(st_f.dim)])
            p = xf.pre + pre_tr[l].prolongate(xc.pre)
            return TaylorHoodVec(st_f._restore_vel_(vel, xf.vel, flag),
                                 st_f._mask_pressure_(p))

        return padd

    levels = {}
    for l in lrange:
        levels[l] = GMGLevel(
            apply=(lambda x, l=l: stokes[l].apply_inner(x, flag)),
            smooth=smoothers[l],
            dot=(lambda u, v, l=l: stokes[l].dot(u, v, flag)),
            zeros=stokes[l].zeros,
            restrict=make_restrict(l) if l > min_level else None,
            prolongate_add=make_prolongate_add(l) if l > min_level else None,
        )

    st_c = stokes[min_level]
    prec = st_c.block_diag_preconditioner()

    def coarse_solve(b_c: TaylorHoodVec, x0: TaylorHoodVec) -> TaylorHoodVec:
        x, _, _ = minres_solve(
            lambda v: st_c.apply_inner(v, flag),
            lambda u, v: st_c.dot(u, v, flag),
            b_c, x0, coarse_iters, rtol=coarse_rtol, prec_fn=prec)
        return x

    gmg = GeometricMultigridSolver(levels, coarse_solve, min_level, max_level,
                                   pre_smooth, post_smooth)
    return StokesGMGStack(stokes, gmg,
                          {l: smoothers[l].eig_max for l in lrange}, smoothers)
