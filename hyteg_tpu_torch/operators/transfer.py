"""Inter-level grid transfer operators (P1 linear P/R + injection); torch
counterpart of hyteg_tpu/operators/transfer.py.

Every odd-parity fine micro-vertex is the midpoint of exactly one coarse
micro-edge of the structured simplex grid, so both directions are ONE
symmetric stencil S (center 1, the 14 tet stencil directions 1/2; in 2D
the 6 triangle directions):

    P:        u_f = S expand(u_c)        (zero-interleave then S)
    R = P^T:  r_c = decimate(S r_f)      (sample even positions)

The stencil runs on the exact 3D view (C, N, N, pitch) with per-axis
zero-filled shifts (no lane aliasing). All levels share one pitch, so the
coarse z axis keeps ``pitch`` lanes: decimation writes
``fine[:, ::2, ::2, ::2]`` into the first ceil(pitch/2) z-lanes of a zero
coarse view (the rest stay zero) and expansion is its transpose — plain
strided views, where the JAX package contracts one-hot band matrices. A
2D block (C, N, N) has no pitch: decimation is ``fine[:, ::2, ::2]``.

Restriction pre-scales fine interface replicas by 1/multiplicity so each
fine DoF contributes exactly once globally, then exchanges the coarse
result additively.
"""

from __future__ import annotations

import torch
from torch import nn

from ..functions.p1 import P1Space
from ..indexing import flat, micro


def _stencil_dirs(dim: int):
    dirs = micro.stencil_directions(dim)
    return [tuple(int(v) for v in d) for d in dirs
            if any(int(v) != 0 for v in d)]


def _stencil15(u: torch.Tensor, dim: int) -> torch.Tensor:
    """S u: center 1 + 1/2 on the tet stencil directions, zero-filled per
    axis on the trailing ``dim`` axes: acc[p] += u[p + d] / 2."""
    acc = u.clone()
    nd = u.ndim
    for d in _stencil_dirs(dim):
        dst, src = [slice(None)] * nd, [slice(None)] * nd
        for i, dv in enumerate(d):
            ax = nd - dim + i
            if dv > 0:
                dst[ax], src[ax] = slice(0, -dv), slice(dv, None)
            elif dv < 0:
                dst[ax], src[ax] = slice(-dv, None), slice(0, dv)
        acc[tuple(dst)].add_(u[tuple(src)], alpha=0.5)
    return acc


class P1Transfer(nn.Module):
    """Prolongation/restriction between two levels on the same storage.

    Both levels should share one lane pitch (GMG stacks do); otherwise the
    coarse array is repitched at the boundary (a materialized relayout)."""

    def __init__(self, coarse: P1Space, fine: P1Space):
        super().__init__()
        assert fine.level == coarse.level + 1
        assert fine.storage is coarse.storage
        self.coarse = coarse
        self.fine = fine
        self.dim = coarse.dim
        self._repitch = self.dim == 3 and coarse.pitch != fine.pitch
        kw = dict(dtype=fine.dtype, device=fine.device)
        self.register_buffer("fine_mask", fine.vertex_mask_t)
        # coarse vertex mask laid out with the fine pitch (2D: no pitch)
        self.register_buffer("coarse_mask", torch.as_tensor(
            micro.vertex_mask_flat(coarse.level, self.dim, fine.pitch), **kw))

    def _c_in(self, uc):
        if not self._repitch:
            return uc
        return flat.repitch(uc, self.coarse.N, self.coarse.pitch,
                            self.fine.pitch)

    def _c_out(self, rc):
        if not self._repitch:
            return rc
        return flat.repitch(rc, self.coarse.N, self.fine.pitch,
                            self.coarse.pitch)

    def _expand(self, uc: torch.Tensor) -> torch.Tensor:
        """Coarse (C, Nc, Lc) -> fine (C, Nf, Nf, P) view (2D: (C, Nf, Nf))
        with the coarse values at even positions."""
        Nc, Nf, P = self.coarse.N, self.fine.N, self.fine.pitch
        if self.dim == 2:
            gf = uc.new_zeros((uc.shape[0], Nf, Nf))
            gf[:, ::2, ::2] = uc
            return gf
        gc = uc.reshape(uc.shape[0], Nc, Nc, P)
        gf = uc.new_zeros((uc.shape[0], Nf, Nf, P))
        gf[:, ::2, ::2, ::2] = gc[..., : (P + 1) // 2]
        return gf

    def _decimate(self, gf: torch.Tensor) -> torch.Tensor:
        """Fine (C, Nf, Nf, P) view (2D: (C, Nf, Nf)) -> coarse (C, Nc, Lc)
        by even-position sampling; z-lanes past ceil(P/2) stay zero."""
        Nc, P = self.coarse.N, self.fine.pitch
        if self.dim == 2:
            return gf[:, ::2, ::2].contiguous()
        gc = gf.new_zeros((gf.shape[0], Nc, Nc, P))
        gc[..., : (P + 1) // 2] = gf[:, ::2, ::2, ::2]
        return gc.reshape(gf.shape[0], Nc, Nc * P)

    # -- prolongation ---------------------------------------------------------

    def prolongate(self, uc: torch.Tensor) -> torch.Tensor:
        """(C, Nc, Lc) -> (C, Nf, Lf) linear interpolation, per-cell."""
        e = self._expand(self._c_in(uc) * self.coarse_mask)
        out = _stencil15(e, self.dim).reshape(self.fine.block_shape)
        return out * self.fine_mask

    def prolongate_and_add(self, uc, uf):
        return uf + self.prolongate(uc)

    # -- restriction ----------------------------------------------------------

    def restrict(self, rf: torch.Tensor, sd_fine=None,
                 sd_coarse=None) -> torch.Tensor:
        """(C, Nf, Lf) -> (C, Nc, Lc), exact transpose of prolongate.

        Fine interface replicas are pre-scaled by 1/mult so each fine DoF
        contributes once globally; the coarse result is exchanged
        additively.
        """
        csp, fsp = self.coarse, self.fine
        sd_f = fsp.resolve_sd(sd_fine)
        sd_c = csp.resolve_sd(sd_coarse)
        rfs = rf * self.fine_mask
        # in place on the fresh masked copy
        f = rfs.view(-1)
        f[sd_f.slot_flat] = f[sd_f.slot_flat] * sd_f.slot_inv_mult
        s = _stencil15(fsp.to_grid(rfs), self.dim)
        rc = self._c_out(self._decimate(s)) * csp.vertex_mask_t
        return csp._exchange_add_(rc, sd_c)  # rc is fresh

    def restrict_injection(self, rf: torch.Tensor):
        """Injection restriction (reference: P1toP1InjectionRestriction)."""
        rc = self._c_out(self._decimate(self.fine.to_grid(rf)))
        return rc * self.coarse.vertex_mask_t
