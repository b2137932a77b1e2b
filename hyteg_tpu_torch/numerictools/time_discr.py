"""Time discretization: theta-schemes, BDF coefficients, CFL helpers, and
the implicit UnsteadyDiffusion wrapper (torch counterpart of
hyteg_tpu/numerictools/time_discr.py).

Reference: src/hyteg/numerictools/{BDFScheme,CrankNicolsonScheme,CFDHelpers}.hpp
and src/hyteg/composites/UnsteadyDiffusion.hpp (implicit time-stepping
wrapper around a diffusion operator). The solve is the port's CG, which
reads its residual on the host once per step.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.types import BoundaryCondition, DoFType, FLAG_INNER
from ..solvers.krylov import cg_solve


@dataclasses.dataclass(frozen=True)
class BDF1:
    """u' ~ (u^{n+1} - u^n)/dt (backward Euler). weights: [1, -1]/dt."""

    steps: int = 1

    def lhs_coeff(self, dt):      # multiplies u^{n+1} in M-term
        return 1.0 / dt

    def rhs_coeffs(self, dt):     # multiply [u^n, ...] in M-term
        return (1.0 / dt,)


@dataclasses.dataclass(frozen=True)
class BDF2:
    """u' ~ (3 u^{n+1} - 4 u^n + u^{n-1}) / (2 dt)."""

    steps: int = 2

    def lhs_coeff(self, dt):
        return 1.5 / dt

    def rhs_coeffs(self, dt):
        return (2.0 / dt, -0.5 / dt)


@dataclasses.dataclass(frozen=True)
class CrankNicolson:
    """theta = 1/2 scheme (used through UnsteadyDiffusion theta)."""

    theta: float = 0.5


def cfl_max_dt(h_min: float, v_max, cfl: float = 1.0) -> float:
    """Largest stable dt for advection (reference: CFDHelpers CFL);
    ``v_max`` a number or a 0-dim tensor (read on the host)."""
    return cfl * h_min / max(float(v_max), 1e-300)


class UnsteadyDiffusion:
    """Implicit theta-scheme for du/dt - div(kappa grad u) = f.

      (M + theta dt A) u^{n+1} = (M - (1-theta) dt A) u^n
                                 + dt M (theta f^{n+1} + (1-theta) f^n)

    ``A``/``M`` are elementwise operators exposing apply_raw; Dirichlet rows
    of u^{n+1} keep their (already interpolated) boundary values. The last
    step's CG iteration count is ``last_iterations``.
    Reference: src/hyteg/composites/UnsteadyDiffusion.hpp.
    """

    def __init__(self, space, A, M, bc: BoundaryCondition | None = None,
                 theta: float = 1.0, cg_iters: int = 200, cg_rtol: float = 1e-7):
        self.space = space
        self.A = A
        self.M = M
        self.bc = bc or BoundaryCondition.all_dirichlet()
        self.theta = theta
        self.cg_iters = cg_iters
        self.cg_rtol = cg_rtol
        self._sd = space.resolve_sd(self.bc)
        self.last_iterations = 0

    def _lhs_raw(self, x, dt):
        return self.M.apply_raw(x, sd=self._sd) + (self.theta * dt) * \
            self.A.apply_raw(x, sd=self._sd)

    def step(self, u, dt, f_new=None, f_old=None):
        sp, sd, th = self.space, self._sd, self.theta
        rhs = self.M.apply_raw(u, sd=sd) - ((1.0 - th) * dt) * \
            self.A.apply_raw(u, sd=sd)
        if f_new is not None:
            src = th * f_new + (0.0 if f_old is None else (1.0 - th) * f_old)
            rhs = rhs + dt * self.M.apply_raw(src, sd=sd)
        # move Dirichlet values to the RHS: solve for the update on inner rows
        lhs_of_bc = self._lhs_raw(sp.restore_rows(u, torch.zeros_like(u),
                                                  DoFType.DIRICHLET, sd), dt)
        b = sp.restore_rows(rhs - lhs_of_bc, None, FLAG_INNER, sd)

        def apply_fn(x):
            return sp._restore_rows_(self._lhs_raw(x, dt), None, FLAG_INNER,
                                     sd)

        def dot_fn(a, bb):
            return sp.dot(a, bb, FLAG_INNER, sd)

        x0 = sp.restore_rows(u, None, FLAG_INNER, sd)
        res = cg_solve(apply_fn, dot_fn, b, x0, self.cg_iters, self.cg_rtol)
        self.last_iterations = res.iterations
        # keep Dirichlet rows of u
        return sp.restore_rows(res.x, u, FLAG_INNER, sd)
