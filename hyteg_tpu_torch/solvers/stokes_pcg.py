"""Preconditioned CG on the full Stokes saddle system; torch counterpart
of hyteg_tpu/solvers/stokes_pcg.py.

Reference: src/hyteg/solvers/StokesPCGSolver.hpp: CG over the composite
Taylor-Hood vector with a block preconditioner. CG on an indefinite
saddle-point matrix is only guaranteed in exact arithmetic with the right
preconditioner; like the reference, this is offered as a cheap-per-iter
alternative to MinRes for well-conditioned regimes (the block-diagonal
preconditioner keeps the preconditioned spectrum close to +-1).
"""

from __future__ import annotations

from ..composites.stokes import P2P1TaylorHoodStokes, TaylorHoodVec
from ..core.types import DoFType, FLAG_INNER
from .krylov import CGResult, cg_solve


def stokes_pcg_solve(st: P2P1TaylorHoodStokes, b: TaylorHoodVec,
                     x0: TaylorHoodVec | None = None, max_iter: int = 100,
                     rtol: float = 1e-6, flag: DoFType = FLAG_INNER,
                     use_prec: bool = True) -> CGResult:
    """Returns a CGResult whose ``x`` is a TaylorHoodVec (pressure
    mean-projected)."""
    x0 = st.zeros() if x0 is None else x0

    def apply_fn(x):
        y = st.apply_inner(x, flag)
        return TaylorHoodVec(y.vel, st.project_mean(y.pre))

    prec = st.block_diag_preconditioner() if use_prec else None
    bb = TaylorHoodVec(b.vel, st.project_mean(b.pre))
    res = cg_solve(apply_fn, lambda u, v: st.dot(u, v, flag), bb, x0,
                   max_iter, rtol, prec_fn=prec)
    x = res.x
    return res._replace(x=TaylorHoodVec(x.vel, st.project_mean(x.pre)))
