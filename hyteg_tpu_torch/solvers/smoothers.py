"""Point smoothers: weighted Jacobi and Chebyshev (+ spectral estimation);
torch counterpart of hyteg_tpu/solvers/smoothers.py.

Reference: src/hyteg/solvers/WeightedJacobiSmoother.hpp,
ChebyshevSmoother.hpp:558-717 and
src/hyteg/solvers/numerictools/SpectrumEstimation.hpp:56.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..indexing import micro


def jacobi_smooth(
    apply_fn: Callable,
    inv_diag: torch.Tensor,
    b: torch.Tensor,
    x: torch.Tensor,
    omega: float = 2.0 / 3.0,
    num_sweeps: int = 1,
) -> torch.Tensor:
    """x <- x + omega D^{-1} (b - A x), on the rows apply_fn acts on."""
    for _ in range(num_sweeps):
        x = x + omega * inv_diag * (b - apply_fn(x))
    return x


def estimate_spectral_radius(
    apply_fn: Callable,
    inv_diag: torch.Tensor,
    dot_fn: Callable,
    shape,
    num_iter: int = 20,
    generator: torch.Generator | None = None,
    dtype=torch.float32,
) -> torch.Tensor:
    """Largest eigenvalue of D^{-1} A by power iteration on a random start
    uniform in [-1, 1) drawn from ``generator`` (on inv_diag's device)
    (reference: estimateSpectralRadiusWithPowerIteration)."""
    x = torch.rand(shape, generator=generator, dtype=dtype,
                   device=inv_diag.device) * 2.0 - 1.0
    x = inv_diag * apply_fn(x)  # restrict to the operator's row space
    lam = torch.zeros((), dtype=dtype, device=inv_diag.device)
    for _ in range(num_iter):
        nrm = torch.sqrt(dot_fn(x, x))
        x = x / torch.where(nrm == 0, 1.0, nrm)
        y = inv_diag * apply_fn(x)
        lam = dot_fn(x, y)
        x = y
    return lam


def p1_stencil_eig_fourier(stencil, dim: int, samples: int = 64) -> float:
    """Host-side upper bound for lambda_max(D^-1 A) of a per-cell-constant
    P1 stencil operator: the max over cells of the interior stencil's
    periodic symbol  sum_d W_d cos(d.theta) / W_0  (eigenvector
    interlacing majorizes the Dirichlet spectrum per cell; interfaces
    average adjacent cells' symbols and stay below the max). Computed in
    float64 on the host from the stencil's own values (bf16 ones for a
    bf16 operator), as the JAX package does."""
    if isinstance(stencil, torch.Tensor):
        stencil = stencil.detach().cpu().to(torch.float64).numpy()
    W = np.asarray(stencil, dtype=np.float64).sum(-1)  # (C, n_s)
    dirs = np.asarray(micro.stencil_directions(dim), dtype=np.float64)
    center = int(np.where(~dirs.any(axis=1))[0][0])
    th = np.linspace(0.0, np.pi, samples)
    grids = np.meshgrid(*([th] * dim), indexing="ij")
    tg = np.stack(grids, axis=-1).reshape(-1, dim)  # (S, dim)
    cos = np.cos(tg @ dirs.T)  # (S, n_s)
    lam = cos @ W.T  # (S, C)
    w0 = W[:, center]
    good = w0 > 0
    return float((lam[:, good].max(axis=0) / w0[good]).max())


def chebyshev_smooth(
    apply_fn: Callable,
    inv_diag: torch.Tensor,
    b: torch.Tensor,
    x: torch.Tensor,
    eig_max,
    order: int = 3,
    lower_factor: float = 0.3,
    upper_factor: float = 1.1,
) -> torch.Tensor:
    """Chebyshev polynomial smoother of given order on the D^{-1}A-spectrum
    interval [lower_factor, upper_factor] * eig_max."""
    lmin = lower_factor * eig_max
    lmax = upper_factor * eig_max
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    r = inv_diag * (b - apply_fn(x))
    d = r / theta
    x = x + d
    rho = 1.0 / sigma
    for _ in range(order - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        r = inv_diag * (b - apply_fn(x))
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        x = x + d
        rho = rho_new
    return x
