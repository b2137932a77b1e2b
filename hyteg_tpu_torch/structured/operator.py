"""Matrix-free stencil operators on BoxDomain grids (torch counterpart of
hyteg_tpu/structured/operator.py).

A single translation-invariant 15-point stencil with pointwise-exact
per-lane weight vectors (kuhn.lane_weights): boundary faces need no
separate loops. The apply is kernel B1 (kernels/box_stencil.py). The
diagonal is held as (3, L) row-class lane vectors, since only rows 0 and
X-1 differ from the interior rows.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import box_stencil
from ..operators import forms
from . import kuhn
from .box import BoxDomain


class BoxStencilOperator(nn.Module):
    """A: u -> A u for a constant-coefficient form on a BoxDomain.

    ``form``: callable (..., 4, 3) physical tet vertices -> (..., 4, 4)
    element matrices, evaluated in f32 on the domain's device.
    ``elmats`` (optional): precomputed (6, 4, 4) Kuhn element matrices.
    Element matrices and weights stay f32 whatever the domain dtype; the
    apply accumulates in f32 and returns the block's dtype.
    """

    def __init__(self, domain: BoxDomain, form=forms.laplace_form,
                 elmats=None):
        super().__init__()
        self.domain = domain
        self.form = form
        kw = dict(dtype=torch.float32, device=domain.device)
        if elmats is None:
            elmats = form(torch.as_tensor(kuhn.micro_vertices(domain.h), **kw))
        self.register_buffer("elmats",
                             torch.as_tensor(elmats, **kw).contiguous())
        X, Y, Z = domain.dims
        self.register_buffer("w_vecs", kuhn.lane_weights(self.elmats, X, Y, Z))
        s0 = int((kuhn.stencil_dirs() == 0).all(axis=1).nonzero()[0][0])
        d = self.w_vecs[:, s0].contiguous()  # (3, L) row-class diagonal
        self.register_buffer("diagonal", d)
        self.register_buffer("inverse_diagonal", torch.where(
            d != 0, 1.0 / torch.where(d == 0, 1.0, d), 0.0))

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        return self.apply_raw(u)

    # -- apply ----------------------------------------------------------------

    def apply_raw(self, u: torch.Tensor) -> torch.Tensor:
        """Exact A u on every node (including boundary rows)."""
        return box_stencil.box_apply(u, self.w_vecs, self.domain.dims)

    def _apply_torch(self, u: torch.Tensor) -> torch.Tensor:
        """The plain formulation on any device (counterpart of _apply_xla,
        with f32 accumulation)."""
        return box_stencil.box_apply_torch(u, self.w_vecs, self.domain.dims)

    def gemv(self, u, y, alpha=1.0, beta=1.0) -> torch.Tensor:
        """alpha * A u + beta * y (in place on the fresh apply result)."""
        z = self.apply_raw(u)
        if alpha != 1.0:
            z.mul_(alpha)
        return z.add_(y, alpha=beta)

    def residual(self, u, b) -> torch.Tensor:
        """b - A u (in place on the fresh apply result)."""
        z = self.apply_raw(u)
        return torch.sub(b, z, out=z)

    # -- Dirichlet form: boundary rows act as identity ------------------------

    def apply_dirichlet(self, u: torch.Tensor) -> torch.Tensor:
        """Inner rows of A u; boundary rows pass u through (identity),
        the standard eliminated-Dirichlet operator."""
        d = self.domain
        return d.mask_interior(self.apply_raw(u)).add_(d.mask_boundary(u))
