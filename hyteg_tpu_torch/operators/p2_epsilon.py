"""P2 vector epsilon / full-viscous operators (variable viscosity); torch
counterpart of hyteg_tpu/operators/p2_epsilon.py, plain torch on every
device (the JAX package has no Pallas kernel for it either).

The viscous block of variable-viscosity Stokes:

    K[d A, e B] = int 2 mu eps(phi_B e_e) : eps(phi_A e_d)
                = int mu (d_e phi_A d_d phi_B + delta_de grad phi_A . grad phi_B)

with optionally the full-viscous compressible part - (2/3) int mu
(d_d phi_A)(d_e phi_B) (reference: full_stokes family).

The viscosity enters by element-mean averaging of a nodal field (the
reference's CoefficientQuadratureAveraging arithmetic mode): elMat per
element is the unit-viscosity matrix scaled by the mean of mu at the
element's vertices. Applies are strided multiply-adds on the dense
level-(L+1) node grid (viewed as (C, M, M, pitch), see p2_elementwise.py),
sharing the per-class reads across all dim^2 component blocks.
Vectors are (dim, C, M, lanes) blocks.
"""

from __future__ import annotations

import torch

from ..core.types import DoFType, FLAG_INNER
from ..functions.p2 import P2Space
from . import quadrature as q
from .mixed import micro_vertices, physical_p2_grads
from .p2_elementwise import (_base_masks, _coeff_mean, _grid, _read_strided,
                             _scatter_strided_add, p2_node_offsets)


def compute_p2_epsilon_elmats(space: P2Space, cell_vertices=None,
                              full: bool = False) -> torch.Tensor:
    """(C, T, dim, dim, nn, nn) unit-viscosity epsilon element matrices,
    assembled in float64, on the space's device and dtype.

    K[c,t,d,e,A,B] = int d_e phi_A d_d phi_B + delta_de grad phi_A.grad phi_B
    (+ full: - 2/3 d_d phi_A d_e phi_B), exact for affine micro-elements.
    """
    dim = space.dim
    pts, w = q.simplex_rule(dim, 2)
    g, detJ = physical_p2_grads(micro_vertices(space, cell_vertices), pts)
    wq = torch.as_tensor(w, dtype=torch.float64)
    cross = torch.einsum("q,ctaqe,ctbqd->ctdeab", wq, g, g)
    lap = torch.einsum("q,ctaqk,ctbqk->ctab", wq, g, g)
    K = cross + torch.eye(dim, dtype=torch.float64)[None, None, :, :, None,
                                                    None] * lap[:, :, None,
                                                                None]
    if full:
        K = K - (2.0 / 3.0) * torch.einsum("q,ctaqd,ctbqe->ctdeab", wq, g, g)
    K = detJ[..., None, None, None, None] * K
    return K.to(dtype=space.dtype, device=space.device).contiguous()


def _class_scale(masks, t, c3, n, dim):
    """Base mask of class t, times the element mean of the coefficient."""
    return masks[t] if c3 is None else masks[t] * _coeff_mean(c3, t, n, dim)


def p2_vector_apply_local(xs, elmats, level: int, dim: int,
                          pitch: int | None = None, coeff=None) -> torch.Tensor:
    """Per-cell partial vector apply: ys[d] = sum_e K[d,e] xs[e].

    xs: (dim, C, M, lanes) block or a sequence of dim node-grid blocks;
    elmats: (C, T, dim, dim, nn, nn); coeff: optional nodal viscosity
    (node grid), element-mean scaling. Returns a (dim, C, M, lanes) block.
    """
    n = 1 << level
    M = 2 * n + 1
    pitch = M if (pitch is None or dim == 2) else pitch
    node_offs = p2_node_offsets(dim)
    T, nn = node_offs.shape[:2]
    x0 = xs[0]
    masks = _base_masks(level, dim, x0.dtype, x0.device)
    x3 = [_grid(x.contiguous(), pitch, dim) for x in xs]
    c3 = None if coeff is None else _grid(coeff.contiguous(), pitch, dim)
    ys = torch.zeros((dim,) + tuple(x0.shape), dtype=x0.dtype,
                     device=x0.device)
    y3 = [_grid(y, pitch, dim) for y in ys.unbind(0)]
    shape = (-1,) + (1,) * dim
    for t in range(T):
        scale = _class_scale(masks, t, c3, n, dim)
        offs = [tuple(int(v) for v in node_offs[t, B]) for B in range(nn)]
        reads = {(e, o): _read_strided(x3[e], o, n)
                 for e in range(dim) for o in set(offs)}
        for d in range(dim):
            for A in range(nn):
                acc = None
                for e in range(dim):
                    for B in range(nn):
                        r = reads[(e, offs[B])]
                        w = elmats[:, t, d, e, A, B].reshape(shape)
                        acc = r * w if acc is None else acc.addcmul_(r, w)
                _scatter_strided_add(y3[d], acc.mul_(scale), offs[A], n)
    return ys


def p2_vector_diagonal_local(elmats, level: int, dim: int, block_shape,
                             pitch: int | None = None,
                             coeff=None) -> torch.Tensor:
    """Per-cell partial diagonals, a (dim, C, M, lanes) block."""
    n = 1 << level
    pitch = (2 * n + 1) if (pitch is None or dim == 2) else pitch
    node_offs = p2_node_offsets(dim)
    T, nn = node_offs.shape[:2]
    masks = _base_masks(level, dim, elmats.dtype, elmats.device)
    c3 = None if coeff is None else _grid(coeff.contiguous(), pitch, dim)
    ds = torch.zeros((dim,) + tuple(block_shape), dtype=elmats.dtype,
                     device=elmats.device)
    d3 = [_grid(x, pitch, dim) for x in ds.unbind(0)]
    shape = (-1,) + (1,) * dim
    for t in range(T):
        scale = _class_scale(masks, t, c3, n, dim)
        for d in range(dim):
            for A in range(nn):
                w = elmats[:, t, d, d, A, A].reshape(shape)
                _scatter_strided_add(d3[d], w * scale, node_offs[t, A], n)
    return ds


class P2VectorEpsilonOperator:
    """Vector P2 -> vector P2 viscous block with nodal viscosity.

    The viscosity is None (unit viscosity) or a nodal field on the node
    grid, applied by element-mean averaging at every apply, so a
    time-dependent eta(T) can be passed per call via ``coeff``."""

    def __init__(self, space: P2Space, shard: int = 0, full: bool = False,
                 elmats=None, cell_vertices=None):
        self.space = space
        self.shard = shard
        self.full = full
        if elmats is None:
            elmats = compute_p2_epsilon_elmats(space, cell_vertices, full)
        self.elmats = torch.as_tensor(elmats, dtype=space.dtype,
                                      device=space.device).contiguous()

    def _exchange_each_(self, ys, sd):
        for y in ys.unbind(0):
            self.space._exchange_add_(y, sd)
        return ys

    def apply_local(self, xs, coeff=None) -> torch.Tensor:
        """Per-cell partial apply (no exchange), a fresh (dim, C, M,
        lanes) block."""
        sp = self.space
        return p2_vector_apply_local(xs, self.elmats, sp.level, sp.dim,
                                     sp.pitch, coeff)

    def apply_raw(self, xs, coeff=None, sd=None) -> torch.Tensor:
        sd = self.space.resolve_sd(sd, self.shard)
        return self._exchange_each_(self.apply_local(xs, coeff), sd)

    def apply_inner(self, xs, sd_or_bc=None, flag: DoFType = FLAG_INNER,
                    coeff=None) -> torch.Tensor:
        sd = self.space.resolve_sd(sd_or_bc, self.shard)
        ys = self.apply_raw(xs, coeff, sd)
        for y in ys.unbind(0):
            if flag & DoFType.INNER:
                self.space._restore_rows_(y, None, flag, sd)  # ys is fresh
            else:
                y.copy_(self.space.restore_rows(y, torch.zeros_like(y), flag,
                                                sd))
        return ys

    def diagonal_raw(self, coeff=None, sd=None) -> torch.Tensor:
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        ds = p2_vector_diagonal_local(self.elmats, sp.level, sp.dim,
                                      sp.block_shape, sp.pitch, coeff)
        return self._exchange_each_(ds, sd)

    def inverse_diagonal(self, coeff=None, sd=None) -> torch.Tensor:
        ds = self.diagonal_raw(coeff, sd)
        ok = self.space.vertex_mask_t.bool() & (ds != 0)
        return torch.where(ok, 1.0 / torch.where(ds == 0, 1.0, ds), 0.0)
