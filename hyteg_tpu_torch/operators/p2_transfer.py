"""P2 -> P2 quadratic grid transfers on dense node grids (torch
counterpart of hyteg_tpu/operators/p2_transfer.py, 2D and 3D).

Reference: src/hyteg/gridtransferoperators/P2toP2QuadraticProlongation.hpp /
P2toP2QuadraticRestriction.hpp. A coarse micro-element (class t, base b on
the level-L element grid) covers the 35 fine nodes (15 in 2D) at
level-(L+2) coords ``4 b + G`` (G = sum_i m_i off_t[i], |m| = 4);
prolongation evaluates the coarse P2 basis there:

    out[4 b + G] = sum_A  phi_A(m / 4) * u[2 b + O_t(g_A)]

Per class, one gather takes the 10 coarse values of every valid element
base, one product with the (35, 10) weight table ((15, 6) in 2D)
evaluates the fine values, and one ``index_add_`` adds them into the
fine block: three
launches per class, where a strided add per (class, fine offset) took
about 240 per transfer and left the V-cycle bound by host launches.
Neighbouring elements share fine nodes where their values agree (FE
continuity), so the fine block accumulates every element's value and is
divided by the number of elements that contain each node (the JAX package
instead writes with masked ``set``s; the two agree up to rounding).
Restriction is the transpose: prescale the fine interface replicas by
1/(replica count) and every node by 1/(element count), then per class
gather the 35 fine values, one (10, 35) product, one ``index_add_`` into
the coarse block, and the additive coarse exchange. Only the valid bases
of each class are indexed, so no padding or aliased lanes enter the sums.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch
from torch import nn

from ..functions.p2 import P2Space
from ..indexing import flat, micro
from . import quadrature as q
from .p2_elementwise import p2_node_offsets


@functools.lru_cache(maxsize=None)
def _fine_offsets_and_weights(dim: int):
    """Per class t: the distinct fine-node offsets G_t = sum_i m_i off_i
    (|m| = 4, the quarter-point lattice of that class's shape) and the
    P2 basis weights phi_A(m[1:] / 4), with entries below 1e-14 set to 0.

    Returns (gs (T, nG, dim) int, W (T, nG, nA) float64)."""
    offs = micro.offsets(dim)
    T, nv = offs.shape[:2]
    multi = [m for m in itertools.product(range(5), repeat=nv) if sum(m) == 4]
    nA = q.p2_offsets(dim).shape[0]
    gs, W = [], []
    for t in range(T):
        seen, gt, wt = set(), [], []
        for m in multi:
            G = tuple(int(v) for v in sum(m[i] * offs[t, i] for i in range(nv)))
            if G in seen:
                continue
            seen.add(G)
            x = np.array(m[1:], dtype=np.float64) / 4.0
            gt.append(G)
            wt.append(q.p2_basis_at(dim, x[None, :])[:, 0])
        gs.append(gt)
        W.append(wt)
    gs, W = np.asarray(gs, dtype=np.int64), np.asarray(W, dtype=np.float64)
    assert W.shape[1:] == (len(multi), nA)
    W[np.abs(W) < 1e-14] = 0.0
    return gs, W


@functools.lru_cache(maxsize=None)
def _elem_mult(level: int, dim: int, pitch: int) -> np.ndarray:
    """(Mf, lanes) number of coarse (class, base) elements of one macro
    cell that contain each fine node (1 where none, and on padding lanes:
    a neutral divisor)."""
    n = 1 << level
    Mf = (1 << (level + 2)) + 1
    gs, _ = _fine_offsets_and_weights(dim)
    count = np.zeros((Mf,) * dim)
    for t in range(micro.num_classes(dim)):
        bases = np.argwhere(
            micro.elem_base_mask(level, t, dim)[(slice(0, n),) * dim])
        for G in gs[t]:
            pos = bases * 4 + G
            count[tuple(pos.T)] += 1.0
    count[count == 0] = 1.0
    if dim == 2:
        return count
    out = flat.flatten_field(count, pitch)
    out[flat.flatten_field(np.ones_like(count), pitch) == 0] = 1.0
    return out


@functools.lru_cache(maxsize=None)
def _class_indices(level: int, dim: int, pitch: int) -> tuple:
    """Per class t: (coarse (nA, nb_t), fine (nG, nb_t)) int64 flat
    indices into one cell's coarse (Mc, Mc*pitch) and fine (Mf, Mf*pitch)
    blocks ((Mc, Mc) and (Mf, Mf) in 2D) of the nA P2 nodes 2b + O_t(g_A)
    and the nG fine nodes 4b + G of every valid class-t element base b on
    the level-``level`` element grid."""
    n = 1 << level
    Mc, Mf = 2 * n + 1, 4 * n + 1
    node_offs = p2_node_offsets(dim)
    gs, _ = _fine_offsets_and_weights(dim)

    def flat_index(pos, M):
        if dim == 2:
            return pos[..., 0] * M + pos[..., 1]
        return (pos[..., 0] * M + pos[..., 1]) * pitch + pos[..., 2]

    out = []
    for t in range(node_offs.shape[0]):
        b = np.argwhere(
            micro.elem_base_mask(level, t, dim)[(slice(0, n),) * dim])
        out.append((flat_index(2 * b[None] + node_offs[t][:, None], Mc),
                    flat_index(4 * b[None] + gs[t][:, None], Mf)))
    return tuple(out)


class P2Transfer(nn.Module):
    """Quadratic prolongation/restriction between P2 levels L and L+1.

    Both levels should share one lane pitch (GMG stacks do); otherwise the
    coarse array is repitched at the boundary."""

    def __init__(self, coarse: P2Space, fine: P2Space):
        super().__init__()
        assert fine.level == coarse.level + 1
        assert fine.storage is coarse.storage
        self.coarse = coarse
        self.fine = fine
        self.dim = dim = coarse.dim
        self._repitch = dim == 3 and coarse.pitch != fine.pitch
        kw = dict(dtype=fine.dtype, device=fine.device)
        _, W = _fine_offsets_and_weights(dim)
        self.register_buffer("weights", torch.as_tensor(W, **kw))  # (T, nG, nA)
        self.register_buffer("inv_mult", torch.as_tensor(
            1.0 / _elem_mult(coarse.level, dim, fine.pitch), **kw))
        self.index = [tuple(torch.as_tensor(a, device=fine.device) for a in ij)
                      for ij in _class_indices(coarse.level, dim, fine.pitch)]

    def _c_in(self, uc):
        if not self._repitch:
            return uc
        return flat.repitch(uc, self.coarse.M, self.coarse.pitch,
                            self.fine.pitch)

    def _c_out(self, rc):
        if not self._repitch:
            return rc
        return flat.repitch(rc, self.coarse.M, self.fine.pitch,
                            self.coarse.pitch)

    def prolongate(self, uc: torch.Tensor) -> torch.Tensor:
        """(C, Mc, Mc*Pc) -> (C, Mf, Mf*Pf), per cell (no exchange)."""
        fsp = self.fine
        C = uc.shape[0]
        ucf = self._c_in(uc).reshape(C, -1)
        out = uc.new_zeros((C, fsp.M * fsp.lanes))
        for t, (ic, jf) in enumerate(self.index):
            V = torch.matmul(self.weights[t], ucf[:, ic])  # (C, nG, nb)
            out.index_add_(1, jf.view(-1), V.view(C, -1))
        out = out.view(C, fsp.M, fsp.lanes)
        return out.mul_(self.inv_mult).mul_(fsp.vertex_mask_t)

    def prolongate_and_add(self, uc, uf):
        return uf + self.prolongate(uc)

    def restrict(self, rf: torch.Tensor, sd_fine=None,
                 sd_coarse=None) -> torch.Tensor:
        """(C, Mf, Mf*Pf) -> (C, Mc, Mc*Pc), the transpose of prolongate;
        the coarse result is exchanged additively."""
        csp, fsp = self.coarse, self.fine
        sd_f = fsp.resolve_sd(sd_fine)
        sd_c = csp.resolve_sd(sd_coarse)
        C = rf.shape[0]
        rfs = rf * fsp.vertex_mask_t
        f = rfs.view(-1)  # in place on the fresh masked copy
        f[sd_f.slot_flat] = f[sd_f.slot_flat] * sd_f.slot_inv_mult
        rff = rfs.mul_(self.inv_mult).view(C, -1)
        Lc = csp.M * fsp.pitch if self.dim == 3 else csp.M
        rc = rf.new_zeros((C, csp.M * Lc))
        for t, (ic, jf) in enumerate(self.index):
            V = torch.matmul(self.weights[t].T, rff[:, jf])  # (C, nA, nb)
            rc.index_add_(1, ic.view(-1), V.view(C, -1))
        rc = self._c_out(rc.view(C, csp.M, Lc))
        return csp._exchange_add_(rc * csp.vertex_mask_t, sd_c)  # fresh
