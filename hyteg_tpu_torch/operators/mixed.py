"""Mixed P2 (velocity) <-> P1 (pressure) operators for Taylor-Hood Stokes;
torch counterpart of hyteg_tpu/operators/mixed.py.

Reference: src/hyteg/mixedoperators/ (P2ToP1 divergence, P1ToP2 gradient),
src/mixed_operator/P2P1TaylorHoodStokesOperator.hpp. Element matrices come
from the quadrature rules:

    B[i, A, d]  = - int  psi_i  d(phi_A)/dx_d      (divergence, P2 -> P1)
    Bt          =   transpose                       (gradient,  P1 -> P2)

applied as strided shifted multiply-adds: the P1 pressure lives on the
element-level-L vertex grid, the P2 velocity on the level-(L+1) node grid;
class t with base b couples pressure node ``b + off_i`` with velocity node
``2 b + O_t(g_A)``.

Both blocks share one lane pitch, so both are viewed as grids (C, N, N,
pitch) (2D blocks are their own grids) and every read and write is a view
over the (n,)*dim base cube: stride 2 on the node grid, stride 1 (a shift)
on the vertex grid. The JAX package shifts flat lanes instead and pads a
read that runs past the block; a grid view never leaves the block, so the
port needs no padding. The arithmetic stays the JAX package's: per class,
each read once, then weighted sums of the reads, no dense matrix product.
"""

from __future__ import annotations

import numpy as np
import torch

from ..functions.p1 import P1Space
from ..functions.p2 import P2Space
from ..indexing import micro
from . import quadrature as q
from .forms import det_small, inv_small
from .p2_elementwise import (_base_masks, _grid, _read_strided,
                             _scatter_strided_add, p2_node_offsets)


def _shift_read_p1(p3: torch.Tensor, off, n: int) -> torch.Tensor:
    """R[b] = p[b + off] over the (n,)*dim base cube of the element-level
    vertex grid: a view."""
    return _read_strided(p3, off, n, step=1)


def _shift_write_p1_add(d3: torch.Tensor, v: torch.Tensor, off, n: int) -> None:
    """d[b + off] += v[b], in place."""
    _scatter_strided_add(d3, v, off, n, step=1)


def micro_vertices(space, cell_vertices=None) -> torch.Tensor:
    """(C, T, dim + 1, dim) float64 vertices of each class's micro-element
    at base 0 (a 2D mesh keeps its vertices as (x, y, 0))."""
    dim = space.dim
    cv = space.cell_vertices(0) if cell_vertices is None else cell_vertices
    verts = torch.as_tensor(np.asarray(cv), dtype=torch.float64)[..., :dim]
    v0 = verts[:, :1, :]
    J = verts[:, 1:, :] - v0
    offs = torch.as_tensor(micro.offsets(dim), dtype=torch.float64) / space.n
    return v0[:, None] + torch.einsum("tvd,cde->ctve", offs, J)


def physical_p2_grads(mv: torch.Tensor, pts) -> tuple:
    """Physical P2 basis gradients at the rule's points, (C, T, nA, Q,
    dim), and |det J| (C, T), for micro-element vertices ``mv``."""
    dim = mv.shape[-1]
    Je = (mv[..., 1:, :] - mv[..., :1, :]).transpose(-1, -2)  # (C,T,dim,dim)
    g = torch.einsum("aqd,ctde->ctaqe",
                     torch.as_tensor(q.p2_grads_at(dim, pts),
                                     dtype=torch.float64), inv_small(Je))
    return g, det_small(Je).abs()


def compute_divergence_elmats(p2: P2Space, cell_vertices=None) -> torch.Tensor:
    """(C, T, nv_p1, n_p2, dim): B[i, A, d] = -int psi_i dphi_A/dx_d,
    assembled in float64, on the space's device and dtype."""
    pts, w = q.simplex_rule(p2.dim, 2)
    g, detJ = physical_p2_grads(micro_vertices(p2, cell_vertices), pts)
    p1_vals = torch.as_tensor(q.p1_basis_at(p2.dim, pts), dtype=torch.float64)
    B = -torch.einsum("q,iq,ctaqe->ctiae",
                      torch.as_tensor(w, dtype=torch.float64), p1_vals, g)
    B = detJ[..., None, None, None] * B
    return B.to(dtype=p2.dtype, device=p2.device).contiguous()


class P2ToP1DivOperator:
    """Divergence (P2 velocity components -> P1 pressure) and its transpose,
    the gradient (P1 pressure -> P2 component d); partial per-cell sums,
    the caller exchanges additively."""

    def __init__(self, p2: P2Space, p1: P1Space, shard: int = 0, elmats=None):
        assert p1.level == p2.level
        if p2.dim == 3 and p1.pitch != p2.pitch:
            raise ValueError(
                f"P2ToP1DivOperator needs a shared lane pitch (P1 {p1.pitch}"
                f" != P2 {p2.pitch})")
        self.p2, self.p1 = p2, p1
        self.shard = shard
        if elmats is None:
            elmats = compute_divergence_elmats(p2, p2.cell_vertices(shard))
        self.elmats = torch.as_tensor(elmats, dtype=p2.dtype,
                                      device=p2.device).contiguous()
        self._node_offs = p2_node_offsets(p2.dim)
        self._voffs = micro.offsets(p2.dim)

    def _weights(self, t: int, i: int, A: int, d: int) -> torch.Tensor:
        """Per-cell weight B[c, t, i, A, d], shaped to broadcast over the
        base cube."""
        return self.elmats[:, t, i, A, d].reshape((-1,) + (1,) * self.p2.dim)

    def _masks(self, dtype, device):
        return _base_masks(self.p2.level, self.p2.dim, dtype, device)

    def apply_component_local(self, vel_d: torch.Tensor, d: int,
                              out: torch.Tensor | None = None) -> torch.Tensor:
        """Partial (per-cell) divergence contribution of component d, added
        into ``out`` when given (else into a fresh zero block)."""
        p2, dim, n = self.p2, self.p2.dim, self.p2.n
        node_offs, voffs = self._node_offs, self._voffs
        T, nA = node_offs.shape[:2]
        masks = self._masks(vel_d.dtype, vel_d.device)
        dst = (torch.zeros(self.p1.block_shape, dtype=vel_d.dtype,
                           device=vel_d.device) if out is None else out)
        u3 = _grid(vel_d.contiguous(), p2.pitch, dim)
        d3 = _grid(dst, p2.pitch, dim)
        for t in range(T):
            reads = {}
            for A in range(nA):
                o = tuple(int(x) for x in node_offs[t, A])
                if o not in reads:
                    reads[o] = _read_strided(u3, o, n)
            for i in range(voffs.shape[1]):
                acc = None
                for A in range(nA):
                    r = reads[tuple(int(x) for x in node_offs[t, A])]
                    w = self._weights(t, i, A, d)
                    acc = r * w if acc is None else acc.addcmul_(r, w)
                _shift_write_p1_add(d3, acc.mul_(masks[t]), voffs[t, i], n)
        return dst

    def apply_div_local(self, vel_components) -> torch.Tensor:
        """Partial divergence of all components, one P1 block."""
        out = None
        for d, v in enumerate(vel_components):
            out = self.apply_component_local(v, d, out)
        return out

    def _gradient_into(self, p: torch.Tensor, comps, outs) -> None:
        """Partial gradient components ``comps`` of p added into ``outs``
        (one P2 block each), sharing each class's pressure reads."""
        p2, dim, n = self.p2, self.p2.dim, self.p2.n
        node_offs, voffs = self._node_offs, self._voffs
        T, nA = node_offs.shape[:2]
        masks = self._masks(p.dtype, p.device)
        p3 = _grid(p.contiguous(), p2.pitch, dim)
        o3 = [_grid(o, p2.pitch, dim) for o in outs]
        for t in range(T):
            reads = [_shift_read_p1(p3, voffs[t, i], n)
                     for i in range(voffs.shape[1])]
            for d, d3 in zip(comps, o3):
                for A in range(nA):
                    acc = None
                    for i, r in enumerate(reads):
                        w = self._weights(t, i, A, d)
                        acc = r * w if acc is None else acc.addcmul_(r, w)
                    _scatter_strided_add(d3, acc.mul_(masks[t]),
                                         node_offs[t, A], n)

    def apply_gradient_component_local(self, p: torch.Tensor, d: int) -> torch.Tensor:
        """Partial B^T (gradient): pressure -> P2 component d."""
        out = torch.zeros(self.p2.block_shape, dtype=p.dtype, device=p.device)
        self._gradient_into(p, (d,), (out,))
        return out

    def apply_gradient_local(self, p: torch.Tensor) -> torch.Tensor:
        """Partial B^T of every component: a (dim, C, M, lanes) block."""
        out = torch.zeros((self.p2.dim,) + tuple(self.p2.block_shape),
                          dtype=p.dtype, device=p.device)
        self._gradient_into(p, range(self.p2.dim), out.unbind(0))
        return out
