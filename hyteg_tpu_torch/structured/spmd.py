"""Sharded box path: row slabs over a shard group (torch counterpart of
hyteg_tpu/structured/spmd.py).

Domain decomposition by x-row slabs. The halo exchange is neighbour-wise:
each shard swaps one grid row with each adjacent shard per apply, the
analog of the reference's nearest-neighbour PackInfo exchange
(reference: src/hyteg/communication/PackInfo.hpp:43-183,
BufferedCommunication.hpp:92-119).

Slabs are aligned across a hierarchy: shard r holds rows
``[s_r 2^k, s_{r+1} 2^k)`` of the level k levels above the base level,
where the base rows ``s_r`` split the base level's rows evenly, so a
coarse slab is the decimation of its fine slab and each grid transfer
needs one halo row (restriction one below, prolongation one above). The
JAX package pads every level to equal slabs and lets GSPMD place the
transfers; this computes the same values per row.

The apply runs kernel B1 (kernels/box_stencil.py) on the slab itself,
then again on a strip of at most three rows for each slab edge row that
has a neighbour's halo row, after the halos arrive: the kernel's three
weight sets (row 0, row X-1, every other row) are the JAX sweep's (bulk,
first row, last row), and a strip's rows fall into the same classes as the
global rows they hold, so every row gets the weights the global apply
gives it. Chebyshev smoothing, the coarse CG (with global dots) and the
V-cycle are per-shard code on the slabs.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels import box_stencil
from ..operators import forms
from . import gmg, transfer
from .box import BoxDomain
from .operator import BoxStencilOperator


def slab_rows(X: int, D: int, X_base: int | None = None) -> list:
    """Row ranges [(start, end)] of D shards on a level of X rows whose
    hierarchy bottoms out at X_base rows (default X itself): the base
    level's X_base - 1 row gaps split evenly, scaled up."""
    X_base = X if X_base is None else X_base
    if X_base - 1 < D:
        raise ValueError(f"{X_base} rows at the coarsest level cannot give "
                         f"each of {D} shards a row")
    f = (X - 1) // (X_base - 1)
    if f * (X_base - 1) != X - 1:
        raise ValueError(f"{X} rows are no refinement of {X_base}")
    starts = [f * ((r * (X_base - 1)) // D) for r in range(D)]
    return [(s, starts[r + 1] if r + 1 < D else X)
            for r, s in enumerate(starts)]


def shard_field(u: torch.Tensor, rows: list) -> list:
    """A whole (X, L) block -> each shard's slab."""
    return [u[s:e].contiguous() for s, e in rows]


def unshard_field(parts: list) -> torch.Tensor:
    return torch.cat(parts, dim=0)


def _rowclass_mul_(v: torch.Tensor, w3: torch.Tensor, rows, X: int):
    """In place: slab rows times their row class's lane vector (w3 (3, L):
    class 1 on global row 0, 2 on global row X-1, 0 elsewhere)."""
    s, e = rows
    special = [(0, 1)] if s == 0 else []
    if e == X:
        special.append((e - s - 1, 2))
    saved = [v[i].clone() for i, _ in special]
    v.mul_(w3[0])
    for (i, c), row in zip(special, saved):
        torch.mul(row, w3[c], out=v[i])
    return v


def _halo_start(group, u: torch.Tensor):
    """Send the slab's first row down (to rank - 1) and its last row up
    (to rank + 1); pair (a, a + 1) swaps in round a % 2."""
    r, D = group.rank, group.size
    sends = [None, None]
    if r > 0:
        sends[(r - 1) % 2] = (r - 1, u[0].contiguous())
    if r + 1 < D:
        sends[r % 2] = (r + 1, u[-1].contiguous())
    return group.exchange_start(sends)


def _halo_finish(group, pending):
    """(row from rank - 1, row from rank + 1), None at the ends."""
    r, D = group.rank, group.size
    got = group.exchange_finish(pending)
    return (got[(r - 1) % 2] if r > 0 else None,
            got[r % 2] if r + 1 < D else None)


def _halos(group, u: torch.Tensor):
    return _halo_finish(group, _halo_start(group, u))


class SpmdBoxOperator:
    """Row-slab-sharded stencil apply (per-shard code): ``apply_raw(group,
    u)`` takes the shard's slab (rows ``rows[group.rank]``)."""

    def __init__(self, op: BoxStencilOperator, rows: list):
        self.op = op
        self.domain = op.domain
        self.rows = rows

    def apply_raw(self, group, u: torch.Tensor) -> torch.Tensor:
        """A u on the slab's rows: halos sent first, the slab's own rows
        computed while they travel, the edge rows fixed after."""
        X, Y, Z = self.domain.dims
        s, e = self.rows[group.rank]
        n = e - s
        w = self.op.w_vecs
        pending = _halo_start(group, u)
        y = box_stencil.box_apply(u, w, (n, Y, Z))
        lo, hi = _halo_finish(group, pending)
        fix = []
        if lo is not None:
            fix.append(0)
        if hi is not None and (n - 1) not in fix:
            fix.append(n - 1)
        for i in fix:
            prev = lo if i == 0 else u[i - 1]
            nxt = hi if i == n - 1 else u[i + 1]
            strip = [t for t in (prev, u[i], nxt) if t is not None]
            out = box_stencil.box_apply(torch.stack(strip), w,
                                        (len(strip), Y, Z))
            y[i] = out[0 if prev is None else 1]
        return y

    def jacobi_step(self, group, u, b, omega: float = 0.8):
        """One damped-Jacobi sweep on the interior rows of the slab."""
        X = self.domain.X
        dinv = self.domain.interior_rowclass * self.op.inverse_diagonal
        r = torch.sub(b, self.apply_raw(group, u))
        return u + omega * _rowclass_mul_(r, dinv, self.rows[group.rank], X)


@dataclasses.dataclass
class SpmdBoxLevel:
    """One level of the sharded hierarchy, shared by every shard."""

    domain: BoxDomain
    op: SpmdBoxOperator
    eig_max: float

    @property
    def rows(self) -> list:
        return self.op.rows

    def inner_(self, group, v):
        return _rowclass_mul_(v, self.domain.interior_rowclass,
                              self.rows[group.rank], self.domain.X)

    def dinv_inner_(self, group, v):
        w = self.domain.interior_rowclass * self.op.op.inverse_diagonal
        return _rowclass_mul_(v, w, self.rows[group.rank], self.domain.X)


def build_spmd_hierarchy(domain: BoxDomain, num_shards: int,
                         form=forms.laplace_form, min_level: int = 2,
                         eig_max: float | None = None) -> list:
    """Fine-to-coarse sharded levels with slabs aligned across levels and
    the single-device path's spectral bounds (eig_max_fourier), or
    ``eig_max`` on every level."""
    doms = [domain]
    while doms[-1].level > min_level:
        doms.append(doms[-1].coarse())
    X_base = doms[-1].X
    levels = []
    for d in doms:
        op = BoxStencilOperator(d, form)
        levels.append(SpmdBoxLevel(
            d, SpmdBoxOperator(op, slab_rows(d.X, num_shards, X_base)),
            gmg.eig_max_fourier(op) if eig_max is None else eig_max))
    return levels


def _dot(group, a, b):
    return group.all_reduce(torch.sum(a * b))


def _restrict(group, fine: SpmdBoxLevel, coarse: SpmdBoxLevel, r):
    """Coarse slab of P^T r: one fine halo row from below."""
    _, Yf, Zf = fine.domain.dims
    s_c, e_c = coarse.rows[group.rank]
    lo, _ = _halos(group, r)
    ext = r if lo is None else torch.cat([lo[None], r])
    sten = transfer._stencil15(ext.reshape(ext.shape[0], Yf, Zf))
    off = 0 if lo is None else 1
    rc = sten[off::2, ::2, ::2][:e_c - s_c]
    return rc.reshape(e_c - s_c, -1).contiguous()


def _prolongate(group, coarse: SpmdBoxLevel, fine: SpmdBoxLevel, uc):
    """Fine slab of P u_c: one coarse halo row from above."""
    _, Yf, Zf = fine.domain.dims
    _, Yc, Zc = coarse.domain.dims
    s_f, e_f = fine.rows[group.rank]
    _, hi = _halos(group, uc)
    ext = uc if hi is None else torch.cat([uc, hi[None]])
    e = uc.new_zeros((2 * ext.shape[0] - 1, Yf, Zf))
    e[::2, ::2, ::2] = ext.reshape(ext.shape[0], Yc, Zc)
    return transfer._stencil15(e)[:e_f - s_f].reshape(e_f - s_f, -1)


def _cheby(group, lvl: SpmdBoxLevel, x, b, degree: int):
    """The single-device path's Chebyshev recurrence on slabs."""
    lmax, lmin = lvl.eig_max * 1.1, lvl.eig_max * 0.15
    theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)

    def resid(x):
        return lvl.dinv_inner_(group, torch.sub(b, lvl.op.apply_raw(group, x)))

    d = resid(x).div_(theta)
    x = x + d
    sigma = theta / delta
    rho = 1.0 / sigma
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        d.mul_(rho_new * rho).add_(resid(x), alpha=2.0 * rho_new / delta)
        x.add_(d)
        rho = rho_new
    return x


def coarse_cg_spmd(group, lvl: SpmdBoxLevel, b, iters: int = 40):
    """Fixed-iteration CG on the interior with global dots, free of host
    reads."""
    def A(v):
        return lvl.inner_(group, lvl.op.apply_raw(group,
                                                  lvl.inner_(group, v.clone())))

    x = torch.zeros_like(b)
    r = lvl.inner_(group, b.clone())
    p = r
    rs = _dot(group, r, r)
    for _ in range(iters):
        Ap = A(p)
        denom = _dot(group, p, Ap)
        alpha = torch.where(denom > 0, rs / torch.clamp_min(denom, 1e-30), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = _dot(group, r, r)
        beta = torch.where(rs > 0, rs_new / torch.clamp_min(rs, 1e-30), 0.0)
        p = r + beta * p
        rs = rs_new
    return x


def spmd_vcycle(group, levels: list, x, b, pre: int = 2, post: int = 2,
                coarse_iters: int = 40, _k: int = 0):
    """One sharded V-cycle on levels[_k:] (per-shard code on slabs)."""
    lvl = levels[_k]
    if _k == len(levels) - 1:
        return coarse_cg_spmd(group, lvl, b, coarse_iters)
    nxt = levels[_k + 1]
    x = _cheby(group, lvl, x, b, pre)
    r = lvl.inner_(group, torch.sub(b, lvl.op.apply_raw(group, x)))
    r_c = nxt.inner_(group, _restrict(group, lvl, nxt, r))
    del r
    e_c = spmd_vcycle(group, levels, torch.zeros_like(r_c), r_c, pre, post,
                      coarse_iters, _k + 1)
    del r_c
    e = _prolongate(group, nxt, lvl, nxt.inner_(group, e_c))
    del e_c
    x.add_(lvl.inner_(group, e))
    del e
    return _cheby(group, lvl, x, b, post)


def spmd_residual_norm(group, lvl: SpmdBoxLevel, x, b) -> torch.Tensor:
    r = lvl.inner_(group, torch.sub(b, lvl.op.apply_raw(group, x)))
    return torch.sqrt(_dot(group, r, r))


def spmd_solve_poisson(group, levels: list, f, cycles: int = 5,
                       pre: int = 2, post: int = 2, coarse_iters: int = 40):
    """Dirichlet Poisson solve with a homogeneous boundary on the shard's
    slab of f; returns (its slab of u, per-cycle global residual norms)."""
    lvl = levels[0]
    b = lvl.inner_(group, f.clone())
    x = torch.zeros_like(b)
    rns = []
    for _ in range(cycles):
        x = spmd_vcycle(group, levels, x, b, pre, post, coarse_iters)
        rns.append(spmd_residual_norm(group, lvl, x, b))
    return x, torch.stack(rns)
