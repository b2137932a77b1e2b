"""Real spherical harmonics for shell initial conditions and analysis
(torch counterpart of hyteg_tpu/terraneo/sphericalharmonics.py).

Reference: src/terraneo/sphericalharmonics/ — used to seed the initial
temperature perturbation and to analyse radial shells. Fully
orthonormalized real harmonics

    Y_{l,0}   = N_{l,0} P_l^0(cos th)
    Y_{l,m}^c = sqrt(2) N_{l,m} P_l^m(cos th) cos(m ph)   m > 0
    Y_{l,m}^s = sqrt(2) N_{l,m} P_l^m(cos th) sin(m ph)   m > 0

evaluated with the stable three-term Legendre recurrence; the norms are
host math, the evaluation elementwise torch over any coordinate tensor."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def num_coeffs(lmax: int) -> int:
    return (lmax + 1) ** 2


def sh_index(l: int, m: int) -> int:
    """Flat index of (l, m): m in [-l, l]; negative m = sine harmonics."""
    return l * l + l + m


@functools.lru_cache(maxsize=None)
def _norms(lmax: int) -> np.ndarray:
    """N_{l,m} = sqrt((2l+1)/(4 pi) (l-m)!/(l+m)!) via log-gamma."""
    out = np.zeros((lmax + 1, lmax + 1))
    for l in range(lmax + 1):
        for m in range(l + 1):
            logn = 0.5 * (math.log(2 * l + 1) - math.log(4 * math.pi)
                          + math.lgamma(l - m + 1) - math.lgamma(l + m + 1))
            out[l, m] = math.exp(logn)
    return out


def sh_basis(lmax: int, xyz: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit-sphere directions -> (..., (lmax+1)^2) real harmonics.

    Input need not be normalized (it is projected to the unit sphere)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = torch.sqrt(x * x + y * y + z * z)
    r = torch.where(r == 0, 1.0, r)
    c = z / r                       # cos(theta)
    rho = torch.sqrt(torch.clamp(x * x + y * y, min=0.0)) / r  # sin(theta)
    phi = torch.atan2(y, x)
    N = _norms(lmax)
    out = [None] * num_coeffs(lmax)
    Pmm = torch.ones_like(c)
    for m in range(lmax + 1):
        if m > 0:
            Pmm = Pmm * (-(2 * m - 1)) * rho
        Plm_prev, Plm = None, Pmm
        cmphi = torch.cos(m * phi)
        smphi = torch.sin(m * phi)
        for l in range(m, lmax + 1):
            if l > m:
                if l == m + 1:
                    Pnew = (2 * m + 1) * c * Pmm
                else:
                    Pnew = ((2 * l - 1) * c * Plm
                            - (l + m - 1) * Plm_prev) / (l - m)
                Plm_prev, Plm = Plm, Pnew
            base = float(N[l, m]) * Plm
            if m == 0:
                out[sh_index(l, 0)] = base
            else:
                s2 = math.sqrt(2.0)
                out[sh_index(l, m)] = s2 * base * cmphi
                out[sh_index(l, -m)] = s2 * base * smphi
    return torch.stack(out, dim=-1)


def sh_synthesis(coeffs, lmax: int, xyz: torch.Tensor) -> torch.Tensor:
    """f(x) = sum_i coeffs_i Y_i(x)."""
    Y = sh_basis(lmax, xyz)
    return torch.sum(Y * torch.as_tensor(coeffs, dtype=Y.dtype,
                                         device=Y.device), dim=-1)


def sh_analysis_weighted(f: torch.Tensor, weights: torch.Tensor, lmax: int,
                         xyz: torch.Tensor) -> torch.Tensor:
    """Discrete forward transform: c_i ~ sum_k w_k f_k Y_i(x_k), with w a
    surface quadrature weight (sums to 4 pi on a full sphere). Used for the
    reference-style radial-shell analysis of a DoF field."""
    Y = sh_basis(lmax, xyz)
    return torch.sum(weights[..., None] * f[..., None] * Y,
                     dim=tuple(range(f.ndim)))


def temperature_perturbation(lmax: int, coeffs, rmin: float, rmax: float,
                             amplitude: float = 0.1):
    """Reference-style initial condition: background conductive profile plus
    SH perturbation damped to zero at both shell boundaries
    (reference: TerraNeo initial temperature setup)."""

    def ic(x):
        r = torch.sqrt(torch.sum(x * x, dim=-1))
        r = torch.clamp(r, rmin, rmax)
        s = (r - rmin) / (rmax - rmin)
        background = 1.0 - s
        damp = torch.sin(math.pi * s)
        pert = sh_synthesis(coeffs, lmax, x)
        return background + amplitude * damp * pert

    return ic
