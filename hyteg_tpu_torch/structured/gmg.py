"""Geometric multigrid on the structured box path (torch counterpart of
hyteg_tpu/structured/gmg.py).

Pre-smooth, restrict, recurse, prolongate-add, post-smooth, with
Chebyshev smoothing and a fixed-iteration CG coarse solve that never reads
a value back to the host.

Dirichlet boundary: the eliminated form — boundary rows act as identity
(operator.apply_dirichlet), corrections are masked to the interior on
every level, so the homogeneous boundary of the error equation is exact.

Memory: masks and the inverse diagonal are (3, L) row-class vectors, and
block-sized temporaries are updated in place where the math allows. A
solve_poisson cycle peaks at seven finest-level blocks, in the
post-smoother: the caller's f, the masked rhs b, the solve loop's x, the
pre-smoothed x, the smoother's new x, its d and its residual.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..operators import forms
from . import kuhn, transfer
from .box import BoxDomain, rowclass_mul, rowclass_mul_
from .operator import BoxStencilOperator


def _dot(a, b):
    """f32-exact dot (TF32 is off package-wide; this never becomes a
    matmul anyway)."""
    return torch.sum(a * b)


def _norm(a):
    return torch.sqrt(_dot(a, a))


def eig_max_fourier(op: BoxStencilOperator, samples: int = 96) -> float:
    """Upper bound for lambda_max(D^-1 A) from the interior stencil symbol.

    The interior operator is a constant 15-point stencil; its periodic
    symbol  lam(theta) = sum_d w_d cos(d . theta) / w_0  majorizes the
    Dirichlet spectrum (eigenvector interlacing on the rectangular grid).
    Evaluated on the host on a theta grid.
    """
    dirs = kuhn.stencil_dirs()
    # interior lane weight: any interior lane of the interior row class
    Y, Z = op.domain.dims[1], op.domain.dims[2]
    lane = (Y // 2) * Z + Z // 2
    w = op.w_vecs[0, :, lane].cpu().numpy().astype(np.float64)  # (n_s,)
    center = [i for i, d in enumerate(dirs) if not d.any()]
    w0 = w[center[0]]
    th = np.linspace(0.0, np.pi, samples)
    tg = np.stack(np.meshgrid(th, th, th, indexing="ij"), axis=-1)
    lam = np.zeros(tg.shape[:-1])
    for i, d in enumerate(dirs):
        lam += w[i] * np.cos(tg @ d.astype(np.float64))
    return float(lam.max() / w0)


def estimate_eig_max(op: BoxStencilOperator, iters: int = 50) -> float:
    """Power iteration for lambda_max(D^-1 A) on the interior; one host
    read at the end."""
    dom = op.domain
    scale = dom.interior_rowclass * op.inverse_diagonal

    def step(x):
        return rowclass_mul_(op.apply_raw(dom.mask_interior(x)), scale)

    x = torch.ones(dom.block_shape, dtype=dom.dtype, device=dom.device)
    x = x / _norm(x)
    for _ in range(iters):
        y = step(x)
        x = y / _norm(y)
    return float(_dot(x, step(x)))


@dataclass
class BoxLevel:
    domain: BoxDomain
    op: BoxStencilOperator
    eig_max: float
    #: (3, L) interior mask times the inverse diagonal (derived, not passed)
    dinv_inner: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        self.dinv_inner = (self.domain.interior_rowclass
                           * self.op.inverse_diagonal)

    @property
    def inner(self) -> torch.Tensor:
        """(3, L) row-class interior mask."""
        return self.domain.interior_rowclass


def build_hierarchy(domain: BoxDomain, form=forms.laplace_form,
                    min_level: int = 1) -> list[BoxLevel]:
    """Fine-to-coarse list of levels with operators + spectral bounds."""
    levels = []
    d = domain
    while True:
        op = BoxStencilOperator(d, form)
        levels.append(BoxLevel(d, op, eig_max_fourier(op)))
        if d.level <= min_level:
            break
        d = d.coarse()
    return levels


def _smoother_residual(lvl: BoxLevel, x, b):
    """inner * D^-1 (b - A x), in place on the fresh apply result."""
    return rowclass_mul_(lvl.op.residual(x, b), lvl.dinv_inner)


def _cheby(lvl: BoxLevel, x, b, degree: int):
    """Standard three-term Chebyshev recurrence (textbook form); returns a
    fresh x and leaves the caller's untouched."""
    # 1.1 margin above the bound; the smoothing interval bottom at
    # 0.15*lmax leaves modes below it to the coarse-grid correction
    # (reference: ChebyshevSmoother.hpp:558-717).
    lmax = lvl.eig_max * 1.1
    lmin = lvl.eig_max * 0.15
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)

    d = _smoother_residual(lvl, x, b).div_(theta)
    x = x + d
    sigma = theta / delta
    rho = 1.0 / sigma
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        d.mul_(rho_new * rho).add_(_smoother_residual(lvl, x, b),
                                   alpha=2.0 * rho_new / delta)
        x.add_(d)
        rho = rho_new
    return x


def coarse_cg(lvl: BoxLevel, b, iters: int = 40):
    """Fixed-iteration CG on the interior; the step-size guards are tensor
    ops, so nothing reads a value back to the host."""
    dom = lvl.domain

    def A(v):
        return dom.mask_interior(lvl.op.apply_raw(dom.mask_interior(v)))

    x = torch.zeros_like(b)
    r = dom.mask_interior(b)
    p = r
    rs = _dot(r, r)
    for _ in range(iters):
        Ap = A(p)
        denom = _dot(p, Ap)
        alpha = torch.where(denom > 0, rs / torch.clamp_min(denom, 1e-30), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = _dot(r, r)
        beta = torch.where(rs > 0, rs_new / torch.clamp_min(rs, 1e-30), 0.0)
        p = r + beta * p
        rs = rs_new
    return x


def vcycle(levels: list[BoxLevel], x, b, pre: int = 2, post: int = 2,
           coarse_iters: int = 40, _k: int = 0):
    """One V-cycle on levels[_k:]; returns a fresh x."""
    lvl = levels[_k]
    if _k == len(levels) - 1:
        return coarse_cg(lvl, b, coarse_iters)
    nxt = levels[_k + 1]
    x = _cheby(lvl, x, b, pre)
    r = rowclass_mul_(lvl.op.residual(x, b), lvl.inner)
    r_c = rowclass_mul_(transfer.restrict(r, lvl.domain, nxt.domain),
                        nxt.inner)
    del r
    e_c = vcycle(levels, torch.zeros_like(r_c), r_c, pre, post,
                 coarse_iters, _k + 1)
    del r_c
    e = transfer.prolongate(rowclass_mul(e_c, nxt.inner), nxt.domain,
                            lvl.domain)
    del e_c
    x.add_(rowclass_mul_(e, lvl.inner))
    del e
    return _cheby(lvl, x, b, post)


def solve_poisson(levels: list[BoxLevel], f, g=None, cycles: int = 8,
                  pre: int = 2, post: int = 2):
    """Dirichlet Poisson solve: A u = f interior, u = g on the boundary.

    Returns (u, per-cycle residual norms as a (cycles,) tensor)."""
    lvl = levels[0]
    dom = lvl.domain
    if g is None:
        # A (bnd * 0) = 0: the rhs is f on the interior
        b = dom.mask_interior(f)
    else:
        bg = dom.mask_boundary(g)
        b = rowclass_mul_(lvl.op.residual(bg, f), lvl.inner)
        del bg
    # inner * (bnd * g) = 0: the interior iterate starts at zero
    x = torch.zeros_like(f)
    rns = []
    for _ in range(cycles):
        x = vcycle(levels, x, b, pre, post)
        rns.append(_norm(rowclass_mul_(lvl.op.residual(x, b), lvl.inner)))
    if g is not None:
        x.add_(dom.mask_boundary(g))
    return x, torch.stack(rns)
