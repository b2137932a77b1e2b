"""Matrix-free N1E1 curl-curl / mass operators on the dense node grid;
torch counterpart of hyteg_tpu/operators/n1e1_ops.py.

Reference: src/hyteg/elementwiseoperators/N1E1ElementwiseOperator.hpp and
the curl-curl forms under src/hyteg/forms/form_hyteg_generated/n1e1/.
Whitney basis on an affine micro-tet with vertices (x_0..x_3), edge (a, b)
oriented a -> b:

    w_ab   = lambda_a grad(lambda_b) - lambda_b grad(lambda_a)
    curl w = 2 grad(lambda_a) x grad(lambda_b)          (constant)

so the curl-curl element matrix is exact in closed form and the mass
matrix uses the exact P1 moment integral lambda_i lambda_j = |K| (1 +
delta_ij)/20. Canonical-orientation signs (functions/n1e1.py) are folded
into the per-cell element matrices, after which the apply is the P2
elementwise operator's stride-2 pattern: per class, the 6 edge-midpoint
reads of every element as one batched (6, 6) product, then 6 strided
adds (operators/p2_elementwise.py's helpers on the (C, M, M, pitch) view).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.types import DoFType, FLAG_INNER, UpdateType
from ..functions.n1e1 import N1E1Function, N1E1Space, _local_edges, edge_tables
from ..indexing import micro
from . import forms
from .p2_elementwise import _base_masks, _grid, _read_strided, _scatter_strided_add


def _micro_grads_vols(space: N1E1Space, cell_vertices=None):
    """Per (cell, class): P1 barycentric gradients (C,T,4,3) and volumes
    (C,T). All micro-tets of a class within a macro-cell are congruent."""
    ns = space.node_space
    cv = (ns._tensor(space.storage.cell_vertices[
        : space.storage.cells_per_shard])
          if cell_vertices is None else cell_vertices)
    v0 = cv[:, :1, :]
    J = cv[:, 1:, :] - v0  # (C, 3, 3) rows are edge vectors
    offs = ns._tensor(micro.offsets(3)) / space.n
    mv = v0[:, None] + torch.einsum("tvd,cde->ctve", offs, J)
    return forms.p1_gradients(mv)


def n1e1_elmats(space: N1E1Space, alpha: float = 1.0, beta: float = 0.0,
                cell_vertices=None, signed: bool = True) -> torch.Tensor:
    """(C, T, 6, 6) element matrices alpha * curlcurl + beta * mass in the
    canonical orientation (signs folded in when ``signed``)."""
    g, vol = _micro_grads_vols(space, cell_vertices)  # (C,T,4,3), (C,T)
    edges = _local_edges(3)
    E = len(edges)
    a_idx = [e[0] for e in edges]
    b_idx = [e[1] for e in edges]
    ga, gb = g[:, :, a_idx], g[:, :, b_idx]  # (C,T,E,3)
    K = torch.zeros(g.shape[:2] + (E, E), dtype=space.dtype,
                    device=space.device)
    if alpha != 0.0:
        c = 2.0 * torch.linalg.cross(ga, gb, dim=-1)  # curl w_e
        K = K + alpha * vol[..., None, None] * torch.einsum(
            "ctei,ctfi->ctef", c, c)
    if beta != 0.0:
        G = torch.einsum("ctai,ctbi->ctab", g, g)  # (C,T,4,4)
        nv = 4
        I = space.node_space._tensor((np.ones((nv, nv)) + np.eye(nv)) / 20.0)
        II = vol[..., None, None] * I

        def pick(M, rows, cols):
            return M[:, :, rows][:, :, :, cols]

        M_e = (pick(G, b_idx, b_idx) * pick(II, a_idx, a_idx)
               - pick(G, b_idx, a_idx) * pick(II, a_idx, b_idx)
               - pick(G, a_idx, b_idx) * pick(II, b_idx, a_idx)
               + pick(G, a_idx, a_idx) * pick(II, b_idx, b_idx))
        K = K + beta * M_e
    if signed:
        s = space.node_space._tensor(space.edge_signs(0))  # (C,T,E)
        K = K * s[..., :, None] * s[..., None, :]
    return K


def n1e1_apply_local(src, elmats, level: int, pitch: int) -> torch.Tensor:
    """Per-cell partial apply: dst[2b + o_A] += elMat[c,t,A,B] src[2b + o_B]
    over the 6 edge midpoints o of every micro-tet class."""
    n = 1 << level
    node_offs, _, _ = edge_tables(3)  # (T, E, 3)
    T, E = node_offs.shape[0], node_offs.shape[1]
    C = src.shape[0]
    masks = _base_masks(level, 3, src.dtype, src.device)
    u3 = _grid(src.contiguous(), pitch, 3)
    dst = torch.zeros_like(src)
    d3 = _grid(dst, pitch, 3)
    for t in range(T):
        R = torch.stack([_read_strided(u3, node_offs[t, B], n)
                         for B in range(E)], dim=1).reshape(C, E, -1)
        Y = torch.bmm(elmats[:, t], R).view(C, E, n, n, n) * masks[t]
        for A in range(E):
            _scatter_strided_add(d3, Y[:, A], node_offs[t, A], n)
    return dst


def _diag_scatter(P, offsets, level: int, block_shape, pitch: int):
    """dst[2b + o_A] += P[c, t, A] over the valid bases of class t."""
    n = 1 << level
    masks = _base_masks(level, 3, P.dtype, P.device)
    dst = torch.zeros(block_shape, dtype=P.dtype, device=P.device)
    d3 = _grid(dst, pitch, 3)
    for t in range(P.shape[1]):
        for A in range(P.shape[2]):
            v = P[:, t, A].reshape(-1, 1, 1, 1) * masks[t]
            _scatter_strided_add(d3, v, offsets[t, A], n)
    return dst


def n1e1_diagonal_local(elmats, level: int, block_shape,
                        pitch: int) -> torch.Tensor:
    node_offs, _, _ = edge_tables(3)
    d = torch.diagonal(elmats, dim1=-2, dim2=-1)
    return _diag_scatter(d, node_offs, level, block_shape, pitch)


def potential_diagonal_local(space: N1E1Space, elmats_unsigned,
                             block_shape) -> torch.Tensor:
    """Diagonal of G^T A G on the vertex (even) nodes, assembled from the
    local 4x4 potential matrices P = Gloc^T elMat Gloc (canonical signs
    cancel). Feeds the vertex half of the Hiptmair smoother."""
    edges = _local_edges(3)
    E, nv = len(edges), 4
    Gloc = np.zeros((E, nv))
    for e, (a, b) in enumerate(edges):
        Gloc[e, b], Gloc[e, a] = 1.0, -1.0
    Gl = torch.as_tensor(Gloc, dtype=elmats_unsigned.dtype,
                         device=elmats_unsigned.device)
    P = torch.einsum("ea,ctef,fb->ctab", Gl, elmats_unsigned, Gl)
    d = torch.diagonal(P, dim1=-2, dim2=-1)
    return _diag_scatter(d, 2 * micro.offsets(3), space.level, block_shape,
                         space.node_space.pitch)


class N1E1ElementwiseOperator(nn.Module):
    """alpha * curl-curl + beta * mass on N1E1
    (reference: N1E1ElementwiseLinearCombinationOperator). The signed and
    unsigned element matrices are registered buffers."""

    def __init__(self, space: N1E1Space, alpha: float = 1.0,
                 beta: float = 0.0, shard: int = 0, cell_vertices=None):
        super().__init__()
        self.space = space
        self.shard = shard
        self.alpha, self.beta = alpha, beta
        self.register_buffer("elmats", n1e1_elmats(
            space, alpha, beta, cell_vertices).contiguous())
        self.register_buffer("elmats_unsigned", n1e1_elmats(
            space, alpha, beta, cell_vertices, signed=False).contiguous())

    def forward(self, x):
        return self.apply_raw(x)

    def apply_raw(self, x, sd=None):
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        y = n1e1_apply_local(x, self.elmats, sp.level, sp.node_space.pitch)
        return sp.node_space._exchange_add_(y, sd)  # y is fresh

    def diagonal_raw(self, sd=None):
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        d = n1e1_diagonal_local(self.elmats, sp.level, sp.block_shape,
                                sp.node_space.pitch)
        return sp.node_space._exchange_add_(d, sd)

    @staticmethod
    def _inverse(d, mask):
        ok = mask.bool()[None] & (d != 0)
        return torch.where(ok, 1.0 / torch.where(d == 0, 1.0, d), 0.0)

    def inverse_diagonal(self, sd=None):
        return self._inverse(self.diagonal_raw(sd), self.space.edge_mask_t)

    def potential_inverse_diagonal(self, sd=None):
        """Inverse diagonal of G^T A G (vertex nodes) for Hiptmair."""
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        d = potential_diagonal_local(sp, self.elmats_unsigned, sp.block_shape)
        d = sp.node_space._exchange_add_(d, sd)
        return self._inverse(d, sp.vertexnode_mask_t)

    def apply(self, src: N1E1Function, dst: N1E1Function,
              flag: DoFType = FLAG_INNER,
              update: UpdateType = UpdateType.REPLACE) -> N1E1Function:
        sd = self.space.shard_data(self.shard, dst.bc)
        y = self.apply_raw(src.cells, sd=sd)
        if update == UpdateType.ADD:
            y = y + dst.cells
        out = self.space.restore_rows(y, dst.cells, flag, sd)
        return N1E1Function(out, dst.space, dst.bc)
