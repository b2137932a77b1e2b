"""Matrix-free P1 elementwise operators on structured micro-grids (torch
counterpart of hyteg_tpu/operators/p1_elementwise.py).

For each micro-element congruence class t the local element matrix is
constant over an affine macro-cell, so with coeff=None the apply
collapses into the 15-point constant stencil (kernel B2,
kernels/p1_const_stencil.py) and the diagonal into kernel B3
(kernels/p1_stencil.py). The general elementwise apply with a nodal
coefficient is kernel B4, which is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.types import DoFType, FLAG_INNER, UpdateType
from ..functions.p1 import P1Function, P1Space
from ..indexing import micro
from ..kernels.p1_const_stencil import (face_weights_full, p1_const_apply,
                                        stencil_weights)
from ..kernels.p1_stencil import p1_diagonal_local


def compute_elmats(space: P1Space, form, cell_vertices: torch.Tensor) -> torch.Tensor:
    """(C, T, nv, nv) element matrices — one micro-element per congruence
    class (base-independent for affine cells)."""
    v0 = cell_vertices[:, :1, :]
    J = cell_vertices[:, 1:, :] - v0  # (C, dim, dim) rows are edge vectors
    offs = torch.as_tensor(micro.offsets(space.dim), dtype=cell_vertices.dtype,
                           device=cell_vertices.device) / space.n
    micro_verts = v0[:, None] + torch.einsum("tvd,cde->ctve", offs, J)
    return form(micro_verts).to(space.dtype)


class P1ElementwiseOperator(nn.Module):
    """A: src -> dst with constant-per-cell element matrices.

    ``form``: callable (..., nv, dim) physical vertex coords -> (..., nv, nv).
    ``elmats`` (optional): precomputed (C, 6, 4, 4) element matrices, e.g.
    carried over from the JAX package with interop.elmats_from_reference.
    The per-cell tables are registered buffers.
    """

    def __init__(self, space: P1Space, form, shard: int = 0, elmats=None,
                 coeff_avg: str = "arithmetic"):
        super().__init__()
        self.space = space
        self.form = form
        self.shard = shard
        #: averaging of nodal coefficient fields over element vertices
        #: (reference: src/hyteg/forms/CoefficientAveraging.hpp)
        self.coeff_avg = coeff_avg
        if elmats is None:
            elmats = compute_elmats(
                space, form, space.resolve_sd(None, shard).cell_vertices)
        elmats = torch.as_tensor(elmats, dtype=space.dtype,
                                 device=space.device).contiguous()
        self.register_buffer("elmats", elmats)
        self.register_buffer("stencil",
                             stencil_weights(elmats, space.dim).contiguous())
        self.register_buffer("stencil_face",
                             face_weights_full(elmats, space.dim).contiguous())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply_raw(x)

    # -- raw array API (used by the solvers) ---------------------------------

    def _apply_local(self, x, coeff=None):
        """Per-cell partial apply (no exchange)."""
        if coeff is not None:
            raise NotImplementedError(
                "variable-coefficient apply is the general elementwise "
                "kernel, not ported yet (ROADMAP B4)")
        sp = self.space
        return p1_const_apply(x, self.stencil, self.stencil_face, sp.level,
                              sp.dim, sp.pitch)

    def apply_raw(self, x, coeff=None, sd=None) -> torch.Tensor:
        """Full A x on every row (interface rows exchanged additively)."""
        sd = self.space.resolve_sd(sd, self.shard)
        # the exchange writes in place into the fresh apply result
        return self.space._exchange_add_(self._apply_local(x, coeff), sd)

    def gemv(self, x, y, alpha=1.0, beta=1.0, coeff=None, sd=None) -> torch.Tensor:
        """alpha * A x + beta * y
        (reference: P1ElementwiseOperator gemv, P1ElementwiseOperator.cpp:67)."""
        z = self.apply_raw(x, coeff, sd)
        return alpha * z + beta * y

    def residual(self, x, b, coeff=None, sd=None):
        """b - A x."""
        return torch.sub(b, self.apply_raw(x, coeff, sd))

    def apply_inner(self, x, sd_or_bc=None, flag: DoFType = FLAG_INNER,
                    coeff=None) -> torch.Tensor:
        """A x with rows outside ``flag`` zeroed (Dirichlet rows untouched)."""
        sd = self.space.resolve_sd(sd_or_bc, self.shard)
        y = self.apply_raw(x, coeff, sd)
        if flag == DoFType.ALL:
            return y
        if flag & DoFType.INNER:
            return self.space._restore_rows_(y, None, flag, sd)  # y is fresh
        return self.space.restore_rows(y, torch.zeros_like(y), flag, sd)

    def diagonal_raw(self, coeff=None, sd=None) -> torch.Tensor:
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        d = p1_diagonal_local(self.elmats, sp.level, sp.dim, sp.pitch, False,
                              coeff, self.coeff_avg)
        return sp._exchange_add_(d, sd)  # d is fresh

    def _inverse(self, d) -> torch.Tensor:
        mask = self.space.vertex_mask_t.bool()
        ok = mask & (d != 0)
        return torch.where(ok, 1.0 / torch.where(d == 0, 1.0, d), 0.0)

    def inverse_diagonal(self, coeff=None, sd=None) -> torch.Tensor:
        """1/diag on valid rows, 0 elsewhere
        (reference: computeInverseDiagonalOperatorValues)."""
        return self._inverse(self.diagonal_raw(coeff, sd))

    def lumped_inverse_diagonal(self, coeff=None, sd=None):
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        d = p1_diagonal_local(self.elmats, sp.level, sp.dim, sp.pitch, True,
                              coeff, self.coeff_avg)
        return self._inverse(sp._exchange_add_(d, sd))

    # -- HyTeG-style function API -------------------------------------------

    def apply(
        self,
        src: P1Function,
        dst: P1Function,
        flag: DoFType = FLAG_INNER,
        update: UpdateType = UpdateType.REPLACE,
    ) -> P1Function:
        sd = self.space.shard_data(self.shard, dst.bc)
        y = self.apply_raw(src.cells, sd=sd)
        if update == UpdateType.ADD:
            y = y + dst.cells
        out = self.space.restore_rows(y, dst.cells, flag, sd)
        return P1Function(out, dst.space, dst.bc)
