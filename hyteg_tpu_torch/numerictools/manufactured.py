"""Manufactured solutions for convergence studies (torch counterpart of
hyteg_tpu/numerictools/manufactured.py).

The reference scatters these across its test programs (e.g.
tests/hyteg/P1/P1PetscSolveTest.cpp, apps/MultigridStudies — sin/cos
product eigenfunctions, polynomial solutions, Stokes stream functions);
this module collects them behind one API so tests and apps share them.

Each entry is a ManufacturedSolution with callables taking a torch tensor
of points ``x`` of shape (..., dim):

    u(x)      exact scalar (or tuple for vector) solution
    f(x)      matching right-hand side of the PDE
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

PI = math.pi


@dataclass(frozen=True)
class ManufacturedSolution:
    name: str
    dim: int
    u: Callable
    f: Callable
    description: str = ""


def _sin3(x):
    return (torch.sin(PI * x[..., 0]) * torch.sin(PI * x[..., 1])
            * torch.sin(PI * x[..., 2]))


def _sin2(x):
    return torch.sin(PI * x[..., 0]) * torch.sin(PI * x[..., 1])


#: -Delta u = f on the unit cube, u = 0 on the boundary
poisson_sin_3d = ManufacturedSolution(
    "poisson_sin_3d", 3, _sin3, lambda x: 3 * PI**2 * _sin3(x),
    "Laplace eigenfunction on the unit cube")

poisson_sin_2d = ManufacturedSolution(
    "poisson_sin_2d", 2, _sin2, lambda x: 2 * PI**2 * _sin2(x),
    "Laplace eigenfunction on the unit square")

#: polynomial solution exactly representable at machine precision by P2
poisson_quadratic_3d = ManufacturedSolution(
    "poisson_quadratic_3d", 3,
    lambda x: x[..., 0] * x[..., 1] + x[..., 2] ** 2,
    lambda x: -2.0 * torch.ones_like(x[..., 0]),
    "quadratic: P2-exact, Dirichlet data inhomogeneous")


def _stokes_vel_2d(x):
    """Divergence-free velocity from the stream function
    psi = sin(pi x)^2 sin(pi y)^2 (zero on the boundary)."""
    sx, sy = torch.sin(PI * x[..., 0]), torch.sin(PI * x[..., 1])
    cx, cy = torch.cos(PI * x[..., 0]), torch.cos(PI * x[..., 1])
    u = 2 * PI * sx**2 * sy * cy
    v = -2 * PI * sx * cx * sy**2
    return u, v


def _stokes_pressure_2d(x):
    return torch.sin(PI * x[..., 0]) * torch.cos(PI * x[..., 1])


def _stokes_rhs_2d(x):
    """f = -Delta u + grad p in closed form (the JAX package derives the
    same fields by autodiff): with u = pi sin^2(pi x) sin(2 pi y) and
    v = -pi sin(2 pi x) sin^2(pi y),
    Delta u = 2 pi^3 sin(2 pi y) (cos(2 pi x) - 2 sin^2(pi x)) and
    Delta v = -2 pi^3 sin(2 pi x) (cos(2 pi y) - 2 sin^2(pi y))."""
    X, Y = x[..., 0], x[..., 1]
    sx, sy = torch.sin(PI * X), torch.sin(PI * Y)
    lap_u = 2 * PI**3 * torch.sin(2 * PI * Y) * (torch.cos(2 * PI * X)
                                                 - 2 * sx**2)
    lap_v = -2 * PI**3 * torch.sin(2 * PI * X) * (torch.cos(2 * PI * Y)
                                                  - 2 * sy**2)
    dpx = PI * torch.cos(PI * X) * torch.cos(PI * Y)
    dpy = -PI * sx * sy
    return -lap_u + dpx, -lap_v + dpy


stokes_stream_2d = ManufacturedSolution(
    "stokes_stream_2d", 2, _stokes_vel_2d, _stokes_rhs_2d,
    "div-free stream-function Stokes solution, p = sin(pi x) cos(pi y)")

ALL = {s.name: s for s in (poisson_sin_3d, poisson_sin_2d,
                           poisson_quadratic_3d, stokes_stream_2d)}
