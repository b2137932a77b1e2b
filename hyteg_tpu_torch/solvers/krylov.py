"""Krylov solvers on raw DoF blocks; torch counterpart of
hyteg_tpu/solvers/krylov.py.

Reference: src/hyteg/solvers/CGSolver.hpp:94 (preconditioned CG),
MinresSolver.hpp (preconditioned MINRES).
``apply_fn`` must return A x restricted to the solved rows (zero on
Dirichlet rows) and ``dot_fn`` must count every global DoF exactly once
(the reference's dotGlobal) and return a 0-dim tensor.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm2: torch.Tensor


def cg_solve(
    apply_fn: Callable,
    dot_fn: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    max_iter: int,
    rtol: float = 1e-8,
    atol: float = 0.0,
    prec_fn: Callable | None = None,
) -> CGResult:
    """(Preconditioned) conjugate gradients until ||r||^2 <= max(rtol^2
    ||r0||^2, atol^2) or ``max_iter`` steps. The stopping test reads the
    residual on the host once per step; cg_solve_fixed avoids that."""
    prec = prec_fn if prec_fn is not None else (lambda r: r)

    x = x0
    r = b - apply_fn(x0)
    p = prec(r)
    rz = dot_fn(r, p)
    rr = dot_fn(r, r)
    tol2 = max(rtol * rtol * float(rr), atol * atol)
    k = 0
    while k < max_iter and float(rr) > tol2:
        ap = apply_fn(p)
        pap = dot_fn(p, ap)
        alpha = rz / torch.where(pap == 0, 1.0, pap)
        x = x + alpha * p
        r = r - alpha * ap
        z = prec(r)
        rz_new = dot_fn(r, z)
        beta = rz_new / torch.where(rz == 0, 1.0, rz)
        p = z + beta * p
        rz = rz_new
        rr = dot_fn(r, r)
        k += 1
    return CGResult(x, k, rr)


def _zeros_like(v):
    return torch.zeros_like(v) if isinstance(v, torch.Tensor) else v.zeros_like()


def _nonzero(s: torch.Tensor) -> torch.Tensor:
    return torch.where(s == 0, 1.0, s)


def minres_solve(
    apply_fn: Callable,
    dot_fn: Callable,
    b,
    x0,
    max_iter: int,
    rtol: float = 1e-8,
    prec_fn: Callable | None = None,
):
    """Preconditioned MINRES (reference: src/hyteg/solvers/MinresSolver.hpp),
    the Stokes/saddle-point workhorse. Operands are tensors or any vector
    with +, -, multiplication by a 0-dim tensor and ``zeros_like()`` (a
    TaylorHoodVec). Runs until the residual estimate phibar <= rtol *
    beta1 or ``max_iter`` steps, reading phibar on the host once per step.
    Returns (x, iterations, phibar)."""
    prec = prec_fn if prec_fn is not None else (lambda r: r)

    r1 = b - apply_fn(x0)
    y = prec(r1)
    beta1 = torch.sqrt(torch.clamp(dot_fn(r1, y), min=0.0))
    tol = rtol * float(beta1)
    zero = torch.zeros_like(beta1)
    x, r2 = x0, r1
    oldb, beta, dbar, epsln, phibar = zero, beta1, zero, zero, beta1
    cs, sn = zero - 1.0, zero
    w, w2 = _zeros_like(x0), _zeros_like(x0)
    k = 0
    while k < max_iter and float(phibar) > tol:
        v = (1.0 / _nonzero(beta)) * y
        y = apply_fn(v)
        if k >= 1:
            y = y - (beta / _nonzero(oldb)) * r1
        alfa = dot_fn(v, y)
        y = y - (alfa / _nonzero(beta)) * r2
        r1, r2 = r2, y
        y = prec(r2)
        oldb = beta
        beta = torch.sqrt(torch.clamp(dot_fn(r2, y), min=0.0))
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = torch.clamp(torch.sqrt(gbar ** 2 + beta ** 2), min=1e-30)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar
        w1, w2 = w2, w
        w = (1.0 / gamma) * (v - oldeps * w1 - delta * w2)
        x = x + phi * w
        k += 1
    return x, k, phibar


def cg_solve_fixed(
    apply_fn: Callable,
    dot_fn: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    num_iter: int,
) -> torch.Tensor:
    """Fixed-iteration CG (the GMG coarse solver), free of host syncs.

    Updates freeze once the residual has dropped ~to round-off relative to
    the initial residual: continuing fixed iterations past (float32)
    convergence would otherwise amplify rounding noise through the search
    direction (beta ~ ratio of noise) and destroy the coarse correction.
    The freeze is a masked select on 0-dim tensors, so nothing reads a
    value back to the host inside the loop."""
    r = b - apply_fn(x0)
    rr = dot_fn(r, r)
    # attainable float accuracy: |r|/|r0| ~ O(eps); below that only noise
    tol2 = (64.0 * torch.finfo(rr.dtype).eps) ** 2 * rr
    x, p = x0, r
    for _ in range(num_iter):
        active = rr > tol2
        ap = apply_fn(p)
        pap = dot_fn(p, ap)
        ok = active & (pap > 0)
        alpha = torch.where(ok, rr / torch.where(pap <= 0, 1.0, pap), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        rr_new = torch.where(ok, dot_fn(r, r), rr)
        beta = torch.where(ok, rr_new / torch.where(rr == 0, 1.0, rr), 0.0)
        p = torch.where(ok, r + beta * p, p)
        rr = rr_new
    return x
