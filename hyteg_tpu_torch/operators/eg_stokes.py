"""EG-P0 Stokes: enriched-Galerkin velocity + P0 pressure; torch
counterpart of hyteg_tpu/operators/eg_stokes.py.

Reference: the EG Stokes discretization of
src/hyteg/egfunctionspace/ — EGOperators (EGP0StokesOperator /
EGP0EpsilonStokesOperator), with the velocity-pressure coupling of
EGDivFormNitscheBC.hpp / EGDivtFormNitscheBC.hpp and the epsilon
viscous block of EGEpsilonFormNitscheBC.hpp.  The ~180k LoC of
generated facet forms collapse into the translation-invariant facet
tables already built by EGLaplaceOperator.

Discretization (velocity u = u_CG + c psi in [P1]^d + P0-enrichment,
pressure q in P0):

    a(u, v)  = viscous block (laplace or epsilon form, eg_ops.py)
    b(u, q)  = - sum_T int_T q div u
               + sum_{interior f} int_f {q} [u . n]
               + sum_{boundary f} int_f q (u . n)        (Nitsche)

The CG part is continuous, so only the enrichment contributes to the
facet jumps; CG boundary facet terms vanish on the interior system
because every P1 basis function supported on a boundary facet belongs
to a Dirichlet-eliminated node.  The saddle system

    [ A   B^T ] [u]   [f]
    [ B   0   ] [p] = [g]

is symmetric indefinite (B^T assembled as the exact transpose) and is
solved with MINRES + pressure mean projection (enclosed flow).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..core.types import DoFType, FLAG_INNER
from ..functions.eg import EGFunction, EGSpace
from ..indexing import micro
from .dg_ops import _nbr_mask_tensors, _shift_elem
from .eg_ops import EGLaplaceOperator, _p1_grids, _read_p1, _scatter_p1


@dataclasses.dataclass
class EGP0StokesFunction:
    """u: EG velocity; p: (C, T, n, ..) P0 pressure block."""

    u: EGFunction
    p: torch.Tensor

    def __add__(self, o):
        return EGP0StokesFunction(self.u + o.u, self.p + o.p)

    def __sub__(self, o):
        return EGP0StokesFunction(self.u - o.u, self.p - o.p)

    def __mul__(self, s):
        return EGP0StokesFunction(s * self.u, s * self.p)

    __rmul__ = __mul__

    def zeros_like(self) -> "EGP0StokesFunction":
        return EGP0StokesFunction(self.u.zeros_like(), torch.zeros_like(self.p))


class EGP0StokesOperator(nn.Module):
    """Coupled EG Stokes operator (single-macro slice, as the viscous
    block).  ``form`` selects the viscous bilinear form."""

    def __init__(self, space: EGSpace, sigma: float | None = None,
                 form: str = "epsilon"):
        super().__init__()
        self.space = space
        self.visc = EGLaplaceOperator(space, sigma=sigma, form=form)
        self._masks = _nbr_mask_tensors(space.level, space.dim, space.dtype,
                                        space.device)

    def forward(self, x: EGP0StokesFunction) -> EGP0StokesFunction:
        return self.apply(x)

    # -- div / grad blocks ---------------------------------------------------

    def apply_div(self, u: EGFunction) -> torch.Tensor:
        """B u: P0 pressure-row block."""
        sp = self.space
        dim, n = sp.dim, sp.p0.n
        p1, T, nv = sp.p1, sp.p0.T, sp.dim + 1
        offs = micro.offsets(dim)
        op = self.visc
        nbr_class, nbr_shift = op._nbr
        F = dim + 1
        sh = (slice(None),) + (None,) * dim

        grids = _p1_grids(p1, u.vel)
        out = torch.zeros_like(u.enr)
        for t in range(T):
            base_mask = op.base_masks[t][None]
            vol = op.vol[:, t][sh]
            g = op.g[:, t]
            ue = u.enr[:, t]
            # -int_T q (div u_CG + dim c)
            acc = -dim * vol * ue
            for a in range(nv):
                for d in range(dim):
                    rcad = _read_p1(grids[d], offs[t, a], n, dim)
                    acc = acc - vol * g[:, a, d][sh] * rcad
            # facet jumps of the enrichment
            for f in range(F):
                mi, mb = self._masks[(t, f)]
                mi, mb = mi[None], mb[None]
                t2, s = int(nbr_class[t, f]), nbr_shift[t, f]
                ue_n = _shift_elem(u.enr[:, t2], s, dim)
                a_s = op.a_s[:, t, f][sh]
                a_n = op.a_n[:, t, f][sh]
                acc = acc + mi * 0.5 * (ue * a_s - ue_n * a_n) \
                          + mb * ue * a_s
            out[:, t] = acc * base_mask
        return out * sp.p0._weight(out.dtype)

    def apply_divT(self, p: torch.Tensor) -> EGFunction:
        """B^T p: velocity-row block (exact transpose of apply_div)."""
        sp = self.space
        dim, n = sp.dim, sp.p0.n
        p1, T, nv = sp.p1, sp.p0.T, sp.dim + 1
        offs = micro.offsets(dim)
        op = self.visc
        nbr_class, nbr_shift = op._nbr
        F = dim + 1
        sh = (slice(None),) + (None,) * dim

        out_v = [torch.zeros(p1.block_shape, dtype=p.dtype, device=p.device)
                 for _ in range(dim)]
        out_g = _p1_grids(p1, out_v)
        out_e = torch.zeros_like(p)

        for t in range(T):
            base_mask = op.base_masks[t][None]
            vol = op.vol[:, t][sh]
            g = op.g[:, t]
            pt = p[:, t] * base_mask
            # CG rows: -p vol g[a, d]
            for a in range(nv):
                for d in range(dim):
                    _scatter_p1(out_g[d], -vol * g[:, a, d][sh] * pt,
                                offs[t, a], n, dim)
            # enrichment rows: -p dim vol + facet transpose
            acc_e = -dim * vol * pt
            for f in range(F):
                mi, mb = self._masks[(t, f)]
                mi, mb = mi[None], mb[None]
                t2, s = int(nbr_class[t, f]), nbr_shift[t, f]
                bm_n = op.base_masks[t2][None]
                p_n = _shift_elem((p[:, t2] * bm_n), s, dim)
                a_s = op.a_s[:, t, f][sh]
                acc_e = acc_e + (mi * 0.5 * (pt + p_n) + mb * pt) * a_s
            out_e[:, t] = acc_e * base_mask

        sd = p1.resolve_sd(None)
        vel = tuple(p1._exchange_add_(v, sd) for v in out_v)
        return EGFunction(vel, out_e * sp.p0._weight(out_e.dtype), sp)

    # -- coupled apply -------------------------------------------------------

    def apply(self, x: EGP0StokesFunction,
              flag: DoFType = FLAG_INNER) -> EGP0StokesFunction:
        sp = self.space
        au = self.visc.apply(x.u) + self.apply_divT(x.p)
        sd = sp.p1.resolve_sd(None)
        vel = tuple(sp.p1.restore_rows(v, torch.zeros_like(v), flag, sd)
                    for v in au.vel)
        return EGP0StokesFunction(EGFunction(vel, au.enr, sp),
                                  self.apply_div(x.u))

    def project_pressure_mean(self, p: torch.Tensor) -> torch.Tensor:
        """Remove the volume-weighted pressure mean (enclosed flow)."""
        sp = self.space
        w = sp.p0.elem_volumes.to(p.dtype)  # (C,T,n..), masked
        mean = torch.sum(p * w) / torch.sum(w)
        return (p - mean) * sp.p0._weight(p.dtype)

    def dot(self, a: EGP0StokesFunction, b: EGP0StokesFunction):
        return self.space.dot(a.u, b.u) + torch.sum(a.p * b.p)
