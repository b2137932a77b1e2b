"""Matrix-free P2 elementwise operators on the dense node grid (torch
counterpart of hyteg_tpu/operators/p2_elementwise.py, 2D and 3D).

On the level-(L+1) node grid, micro-element class t with base b (on the
level-L element grid) owns the 10 nodes (6 in 2D) at ``2 b + O_t(g)``,
O_t(g) in {0,1,2}^dim, and the apply is

    dst[2b + O_t(g_A)] += elMat[c, t, A, B] * src[2b + O_t(g_B)]

over the valid bases of each class. The JAX package slices the flat lanes
with stride 2; here a 3D block is viewed as (C, M, M, pitch) (a 2D block
(C, M, M) is its own grid) and every class is read and written as a
stride-2 view over the (n,)*dim base cube, which keeps no padding or
aliased lanes in the arithmetic.

With ``coeff=None`` the operator applies through the parity-resolved
stencil, kernel B5 (kernels/p2_const_stencil.py). The apply with a nodal
coefficient is ``p2_apply_local``, plain torch on every device: the JAX
package has no Pallas kernel for it either.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..core.types import DoFType, FLAG_INNER, UpdateType
from ..functions.p2 import P2Function, P2Space
from ..indexing import micro
from ..kernels.p2_const_stencil import (p2_const_apply, p2_face_weights,
                                        p2_folded_weights, p2_stencil_weights)
from . import quadrature as q


@functools.lru_cache(maxsize=None)
def p2_node_offsets(dim: int) -> np.ndarray:
    """(T, n_nodes, dim) node-grid offsets of each class's P2 nodes, in the
    canonical p2_offsets order: O_t(g) = (2 - sum g) off_0 + sum_i g_i off_i+1."""
    offs = micro.offsets(dim)
    gs = q.p2_offsets(dim)
    out = np.zeros((offs.shape[0], gs.shape[0], dim), dtype=np.int64)
    for t in range(offs.shape[0]):
        for A, g in enumerate(gs):
            out[t, A] = (2 - int(g.sum())) * offs[t, 0] + sum(
                int(g[i]) * offs[t, 1 + i] for i in range(dim))
    assert out.min() >= 0 and out.max() <= 2
    return out


@functools.lru_cache(maxsize=8)
def _base_masks(level: int, dim: int, dtype, device) -> torch.Tensor:
    """(T, n, ..., n) class base masks on the level-L element grid."""
    n = 1 << level
    m = np.stack([micro.elem_base_mask(level, t, dim)[(slice(0, n),) * dim]
                  for t in range(micro.num_classes(dim))])
    return torch.as_tensor(m, dtype=dtype, device=device)


def _grid(u: torch.Tensor, pitch: int, dim: int) -> torch.Tensor:
    """(C, M, M*pitch) block -> (C, M, M, pitch) view; a 2D block
    (C, M, M) is its own grid."""
    if dim == 2:
        return u
    return u.view(u.shape[0], u.shape[1], u.shape[1], pitch)


def _read_strided(u3: torch.Tensor, off, n: int, step: int = 2) -> torch.Tensor:
    """R[b] = u[step * b + off] over the (n,)*dim base cube: a view."""
    return u3[(slice(None),) + tuple(slice(int(o), int(o) + step * n, step)
                                     for o in off)]


def _scatter_strided_add(d3: torch.Tensor, v: torch.Tensor, off, n: int,
                         step: int = 2) -> None:
    """d[step * b + off] += v[b], in place (v masked by the caller)."""
    _read_strided(d3, off, n, step).add_(v)


def _coeff_mean(c3: torch.Tensor, t: int, n: int, dim: int) -> torch.Tensor:
    """(C, n, ..., n) arithmetic mean of a nodal coefficient over the
    dim + 1 vertices (node offsets 2 * off_t) of each class-t element."""
    voffs = micro.offsets(dim)
    sc = _read_strided(c3, 2 * voffs[t, 0], n)
    for v in range(1, voffs.shape[1]):
        sc = sc + _read_strided(c3, 2 * voffs[t, v], n)
    return sc / voffs.shape[1]


def compute_p2_elmats(space: P2Space, kind: str = "laplace",
                      cell_vertices=None, degree: int | None = None,
                      form=None, dtype=None) -> torch.Tensor:
    """(C, T, 10, 10) P2 element matrices per micro-element class
    ((C, 2, 6, 6) in 2D), on the space's device in ``dtype`` (default the
    space's), assembled in float64.

    kind: 'laplace' | 'mass', or pass ``form(verts) -> (..., nn, nn)``."""
    cv = space.cell_vertices(0) if cell_vertices is None else cell_vertices
    verts = torch.as_tensor(np.asarray(cv), dtype=torch.float64)
    verts = verts[..., :space.dim]  # a 2D mesh keeps its vertices as (x, y, 0)
    v0 = verts[:, :1, :]
    J = verts[:, 1:, :] - v0
    offs = torch.as_tensor(micro.offsets(space.dim), dtype=torch.float64) / space.n
    micro_verts = v0[:, None] + torch.einsum("tvd,cde->ctve", offs, J)
    if form is not None:
        elm = form(micro_verts)
    elif kind == "laplace":
        pts, w = q.simplex_rule(space.dim, 2 if degree is None else degree)
        elm = q.stiffness_elmat(micro_verts, q.p2_grads_at(space.dim, pts), w)
    elif kind == "mass":
        pts, w = q.simplex_rule(space.dim, 4 if degree is None else degree)
        elm = q.mass_elmat(micro_verts, q.p2_basis_at(space.dim, pts), w)
    else:
        raise ValueError(f"unknown kind {kind}")
    return elm.to(dtype=dtype or space.dtype,
                  device=space.device).contiguous()


def p2_apply_local(src, elmats, level: int, dim: int,
                   pitch: int | None = None, coeff=None) -> torch.Tensor:
    """Per-cell partial P2 apply on the node grid (general formulation).

    src: (C, M, M*pitch) (3D) or (C, M, M) (2D); elmats: (C, T, nn, nn);
    coeff: optional nodal field like src; each element is scaled by the
    arithmetic mean of its dim + 1 vertex values, as in the JAX package.
    Per class: one (nn, nn) x (nn, n^dim) batched product of the nn
    stride-2 reads, then nn strided adds."""
    n = 1 << level
    M = 2 * n + 1
    pitch = M if pitch is None else pitch
    C = src.shape[0]
    node_offs = p2_node_offsets(dim)
    T, nn = node_offs.shape[:2]
    masks = _base_masks(level, dim, src.dtype, src.device)
    u3 = _grid(src.contiguous(), pitch, dim)
    c3 = None if coeff is None else _grid(coeff.contiguous(), pitch, dim)
    dst = torch.zeros_like(src)
    d3 = _grid(dst, pitch, dim)
    for t in range(T):
        R = torch.stack([_read_strided(u3, node_offs[t, B], n)
                         for B in range(nn)], dim=1).reshape(C, nn, -1)
        Y = torch.bmm(elmats[:, t].to(src.dtype), R).view(
            (C, nn) + (n,) * dim)
        scale = masks[t] if c3 is None else masks[t] * _coeff_mean(c3, t, n,
                                                                    dim)
        Y = Y * scale.unsqueeze(-dim - 1)
        for A in range(nn):
            _scatter_strided_add(d3, Y[:, A], node_offs[t, A], n)
    return dst


def p2_diagonal_local(elmats, level: int, dim: int, block_shape,
                      pitch: int | None = None, coeff=None) -> torch.Tensor:
    """Per-cell partial diagonal dst[2b + O_A] += elMat[t, A, A] (times the
    element's coefficient mean). Set-up only. bf16 element matrices: the
    sums run in f32 on the widened entries and the result is rounded to
    bf16 once (the JAX package sums in bf16; ROADMAP C-ref14)."""
    if elmats.dtype == torch.bfloat16:
        co = None if coeff is None else coeff.to(torch.float32)
        return p2_diagonal_local(elmats.to(torch.float32), level, dim,
                                 block_shape, pitch, co).to(torch.bfloat16)
    n = 1 << level
    pitch = 2 * n + 1 if pitch is None else pitch
    node_offs = p2_node_offsets(dim)
    T, nn = node_offs.shape[:2]
    masks = _base_masks(level, dim, elmats.dtype, elmats.device)
    dst = torch.zeros(block_shape, dtype=elmats.dtype, device=elmats.device)
    d3 = _grid(dst, pitch, dim)
    c3 = None if coeff is None else _grid(coeff.contiguous(), pitch, dim)
    for t in range(T):
        scale = masks[t] if c3 is None else masks[t] * _coeff_mean(c3, t, n,
                                                                    dim)
        for A in range(nn):
            w = elmats[:, t, A, A].reshape((-1,) + (1,) * dim)
            _scatter_strided_add(d3, w * scale, node_offs[t, A], n)
    return dst


class P2ElementwiseOperator(nn.Module):
    """P2 -> P2 operator (reference: P2ElementwiseOperator).

    ``elmats`` (optional): precomputed (C, 6, 10, 10) element matrices
    ((C, 2, 6, 6) in 2D), e.g. carried over from the JAX package with
    interop. The element
    matrices and the folded stencil rows W (kernels/p2_const_stencil.py),
    which kernel B5 reads, are registered buffers.

    On a bf16 space the element matrices are assembled as for f32, and the
    tables A, E and W summed from the f32 matrices in f32; each buffer is
    then rounded to bf16 once, as the bf16 P1 operator's (ROADMAP C-ref12).
    The JAX package rounds the element matrices to bf16 first and sums its
    tables A and E in bf16 (ROADMAP C-ref14)."""

    def __init__(self, space: P2Space, kind: str = "laplace", shard: int = 0,
                 elmats=None, form=None):
        super().__init__()
        self.space = space
        self.shard = shard
        # the tables are built in f32 at least, then rounded once
        wide = torch.float32 if space.dtype == torch.bfloat16 else space.dtype
        if elmats is None:
            elmats = compute_p2_elmats(space, kind, form=form,
                                       cell_vertices=space.cell_vertices(shard),
                                       dtype=wide)
        elmats = torch.as_tensor(elmats, device=space.device).to(wide)
        self.register_buffer("elmats", elmats.to(space.dtype).contiguous())
        self.register_buffer("stencil_folded", p2_folded_weights(
            p2_stencil_weights(elmats, space.dim),
            p2_face_weights(elmats, space.dim)).to(space.dtype).contiguous())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply_raw(x)

    def _apply_local(self, x, coeff=None, out=None):
        """Per-cell partial apply (no exchange); the constant apply writes
        into ``out`` when given."""
        sp = self.space
        if coeff is None:
            return p2_const_apply(x, self.stencil_folded, sp.level, sp.pitch,
                                  sp.dim, out=out)
        assert out is None, "out= is for the constant apply"
        return p2_apply_local(x, self.elmats, sp.level, sp.dim, sp.pitch,
                              coeff)

    def apply_raw(self, x, coeff=None, sd=None) -> torch.Tensor:
        """Full A x on every row (interface rows exchanged additively)."""
        sd = self.space.resolve_sd(sd, self.shard)
        return self.space._exchange_add_(self._apply_local(x, coeff), sd)

    def gemv(self, x, y, alpha=1.0, beta=1.0, coeff=None, sd=None):
        """alpha * A x + beta * y (reference: P2ElementwiseOperator gemv)."""
        return alpha * self.apply_raw(x, coeff, sd) + beta * y

    def residual(self, x, b, coeff=None, sd=None):
        """b - A x."""
        return torch.sub(b, self.apply_raw(x, coeff, sd))

    def apply_inner(self, x, sd_or_bc=None, flag: DoFType = FLAG_INNER,
                    coeff=None) -> torch.Tensor:
        """A x with rows outside ``flag`` zeroed."""
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
        d = p2_diagonal_local(self.elmats, sp.level, sp.dim, sp.block_shape,
                              sp.pitch, coeff)
        return sp._exchange_add_(d, sd)  # d is fresh

    def inverse_diagonal(self, coeff=None, sd=None) -> torch.Tensor:
        """1/diag on valid rows, 0 elsewhere."""
        d = self.diagonal_raw(coeff, sd)
        ok = self.space.vertex_mask_t.bool() & (d != 0)
        return torch.where(ok, 1.0 / torch.where(d == 0, 1.0, d), 0.0)

    def apply(self, src: P2Function, dst: P2Function,
              flag: DoFType = FLAG_INNER,
              update: UpdateType = UpdateType.REPLACE) -> P2Function:
        sd = self.space.shard_data(self.shard, dst.bc)
        y = self.apply_raw(src.cells, sd=sd)
        if update == UpdateType.ADD:
            y = y + dst.cells
        return P2Function(self.space.restore_rows(y, dst.cells, flag, sd),
                          dst.space, dst.bc)
