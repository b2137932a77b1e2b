"""N1E1 (Nedelec edge elements of the first kind, lowest order) space;
torch counterpart of hyteg_tpu/functions/n1e1.py.

TPU-native redesign of the reference's N1E1VectorFunction
(reference: src/hyteg/n1e1functionspace/N1E1VectorFunction.hpp and the
edge-orientation tables in src/hyteg/edgedofspace/EdgeDoFOrientation.hpp:29-39).

Key observation (same as P2): every micro-edge of refinement level L has its
midpoint at an *odd-parity* node of the level-(L+1) node grid, and the parity
class of the midpoint identifies the edge's direction uniquely:

    parity (1,0,0) -> direction ( 1, 0, 0)   "X"
    parity (0,1,0) -> direction ( 0, 1, 0)   "Y"
    parity (0,0,1) -> direction ( 0, 0, 1)   "Z"
    parity (1,1,0) -> direction (-1, 1, 0)   "XY"
    parity (1,0,1) -> direction (-1, 0, 1)   "XZ"
    parity (0,1,1) -> direction ( 0,-1, 1)   "YZ"
    parity (1,1,1) -> direction ( 1,-1, 1)   "XYZ"

(the midpoint m connects the doubled-grid nodes m - d and m + d). An N1E1
function is therefore ONE (C, M, M, M) block (M = 2^(L+1)+1) holding the
*canonically oriented* edge circulations at the odd nodes, reusing the full
P1 level-(L+1) interface-exchange machinery (the node space's shard
data, exchanges and dots). Tangential continuity across
macro-cells is guaranteed by storing every DoF in a *canonical global
orientation*: the physical edge tangent with lexicographically positive
direction. Each (cell, parity class) has a constant +-1 sign relating the
local index direction to the canonical one, so signs enter all kernels as
per-cell scalars (never materialized as full fields).

The discrete gradient G : P1 -> N1E1 ((G p)_e = p(head) - p(tail)) and its
transpose are shifted-difference stencils on the doubled grid; they feed the
Hiptmair hybrid smoother (reference: src/mixed_operator/HybridSmoother.hpp).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.types import BoundaryCondition, DoFType
from ..indexing import flat, micro
from ..primitives.storage import CellStorage
from .p1 import P1Function, P1ShardData, P1Space

# parity classes of odd doubled-grid nodes and the local edge direction
# through each (3D): midpoint m has endpoints m - d and m + d.
PARITIES_3D = np.array(
    [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1),
     (1, 1, 1)], dtype=np.int64)
DIRS_3D = np.array(
    [(1, 0, 0), (0, 1, 0), (0, 0, 1), (-1, 1, 0), (-1, 0, 1), (0, -1, 1),
     (1, -1, 1)], dtype=np.int64)

PARITIES_2D = np.array([(1, 0), (0, 1), (1, 1)], dtype=np.int64)
DIRS_2D = np.array([(1, 0), (0, 1), (-1, 1)], dtype=np.int64)


def parities(dim: int) -> np.ndarray:
    return PARITIES_3D if dim == 3 else PARITIES_2D


def directions(dim: int) -> np.ndarray:
    return DIRS_3D if dim == 3 else DIRS_2D


def lex_sign(vecs: np.ndarray, tol: float = 1e-9) -> np.ndarray:
    """(..., d) -> (...) +-1: sign of the first significantly nonzero
    component (the canonical global orientation rule)."""
    mag = np.max(np.abs(vecs), axis=-1, keepdims=True)
    sig = np.abs(vecs) > tol * np.maximum(mag, 1e-300)
    first = np.argmax(sig, axis=-1)
    comp = np.take_along_axis(vecs, first[..., None], axis=-1)[..., 0]
    s = np.sign(comp)
    return np.where(s == 0, 1.0, s)


def _local_edges(dim: int) -> list[tuple[int, int]]:
    nv = dim + 1
    return [(a, b) for a in range(nv) for b in range(a + 1, nv)]


@functools.lru_cache(maxsize=None)
def edge_tables(dim: int):
    """Static per-class edge tables.

    Returns (node_offs, par_idx, s_local):
      node_offs: (T, E, dim) doubled-grid offset of each local edge midpoint
      par_idx:   (T, E) parity-class index of each local edge
      s_local:   (T, E) +-1 sign: local orientation (a -> b) vs the parity
                 class's index direction d.
    """
    offs = micro.offsets(dim)
    pars, dirs = parities(dim), directions(dim)
    edges = _local_edges(dim)
    T, E = offs.shape[0], len(edges)
    node_offs = np.zeros((T, E, dim), dtype=np.int64)
    par_idx = np.zeros((T, E), dtype=np.int64)
    s_local = np.zeros((T, E), dtype=np.float64)
    for t in range(T):
        for e, (a, b) in enumerate(edges):
            mid = offs[t, a] + offs[t, b]
            node_offs[t, e] = mid
            p = tuple(int(x) % 2 for x in mid)
            k = next(i for i in range(len(pars))
                     if tuple(pars[i]) == p)
            par_idx[t, e] = k
            step = offs[t, b] - offs[t, a]
            if np.array_equal(step, dirs[k]):
                s_local[t, e] = 1.0
            elif np.array_equal(step, -dirs[k]):
                s_local[t, e] = -1.0
            else:
                raise AssertionError("edge direction not in parity table")
    return node_offs, par_idx, s_local


def _shift(u: torch.Tensor, d, pitch: int, dim: int) -> torch.Tensor:
    """out[m] = u[m + d] (zero outside) on flat blocks (C, M, lanes[, 3])."""
    ncomp = u.ndim - 3
    return flat.shift_read(u, d, pitch, dim, ncomp)


class N1E1Space:
    """Binds (storage, element level L, device); DoFs on odd nodes of the
    L+1 grid. ``device`` has no default."""

    def __init__(self, storage: CellStorage, level: int, *, device,
                 dtype=torch.float32):
        assert storage.dim == 3, "N1E1 is a 3D (H(curl)) space"
        self.storage = storage
        self.level = level
        self.node_space = P1Space(storage, level + 1, device=device,
                                  dtype=dtype)
        self.device = self.node_space.device
        self.dtype = dtype
        self.dim = storage.dim
        self.n = 1 << level
        self.M = self.node_space.N

    # -- delegation -----------------------------------------------------------

    @property
    def block_shape(self):
        return self.node_space.block_shape

    def zeros(self):
        return self.node_space.zeros()

    def shard_data(self, shard: int, bc: BoundaryCondition) -> P1ShardData:
        return self.node_space.shard_data(shard, bc)

    def resolve_sd(self, sd_or_bc=None, shard: int = 0) -> P1ShardData:
        return self.node_space.resolve_sd(sd_or_bc, shard)

    def exchange_add(self, u, sd=None):
        return self.node_space.exchange_add(u, sd)

    def exchange_rep(self, u, sd=None):
        return self.node_space.exchange_rep(u, sd)

    def restore_rows(self, new, old, flag, sd=None):
        return self.node_space.restore_rows(new, old, flag, sd)

    def dot(self, u, v, flag=DoFType.ALL, sd=None):
        return self.node_space.dot(u, v, flag, sd)

    # -- masks ---------------------------------------------------------------

    @functools.cached_property
    def parity_masks(self) -> np.ndarray:
        """(P, M, lanes) bool — odd nodes of each parity class in the simplex."""
        pars = parities(self.dim)
        grids = np.meshgrid(*([np.arange(self.M)] * self.dim), indexing="ij")
        vm = self.node_space.vertex_mask
        out = []
        for p in pars:
            m = np.ones_like(grids[0], dtype=bool)
            for g, pi in zip(grids, p):
                m &= g % 2 == int(pi)
            if self.dim == 3:
                m = flat.flatten_field(m, self.node_space.pitch)
            out.append(m & vm)
        return np.stack(out)

    @functools.cached_property
    def edge_mask(self) -> np.ndarray:
        return self.parity_masks.any(axis=0)

    @functools.cached_property
    def vertexnode_mask(self) -> np.ndarray:
        """Even-parity (P1 potential) nodes."""
        return self.node_space.vertex_mask & ~self.edge_mask

    @functools.cached_property
    def parity_masks_t(self) -> torch.Tensor:
        return self.node_space._tensor(self.parity_masks)

    @functools.cached_property
    def edge_mask_t(self) -> torch.Tensor:
        return self.node_space._tensor(self.edge_mask)

    @functools.cached_property
    def vertexnode_mask_t(self) -> torch.Tensor:
        return self.node_space._tensor(self.vertexnode_mask)

    def num_global_dofs(self) -> int:
        """Global number of micro-edges = nodes(L+1) - nodes(L)."""
        return (self.node_space.num_global_dofs()
                - self.storage.p1_level_maps(self.level).num_global_dofs)

    # -- canonical orientation signs ------------------------------------------

    def _jacobians(self, shard: int = 0) -> np.ndarray:
        lo = shard * self.storage.cells_per_shard
        cv = np.asarray(
            self.storage.cell_vertices[lo: lo + self.storage.cells_per_shard])
        return (cv[:, 1:, :] - cv[:, :1, :]).transpose(0, 2, 1)  # (C,3,dim->col)

    def parity_signs(self, shard: int = 0) -> np.ndarray:
        """(C, P) +-1: canonical sign of each parity class's direction —
        +1 iff the physical tangent J @ d is lexicographically positive."""
        cache = self.__dict__.setdefault("_parity_signs", {})
        if shard not in cache:
            J = self._jacobians(shard)  # (C, 3, dim)
            dirs = directions(self.dim).astype(np.float64)  # (P, dim)
            cache[shard] = lex_sign(np.einsum("cij,pj->cpi", J, dirs))
        return cache[shard]

    @functools.cached_property
    def _sign_cols(self) -> torch.Tensor:
        """(P, C, 1, 1) parity signs of shard 0 as tensors."""
        ps = self.node_space._tensor(self.parity_signs(0))
        return ps.t().reshape(ps.shape[1], -1, 1, 1).contiguous()

    def edge_signs(self, shard: int = 0) -> np.ndarray:
        """(C, T, E) +-1: total sign local edge (a->b) -> canonical."""
        _, par_idx, s_local = edge_tables(self.dim)
        ps = self.parity_signs(shard)  # (C, P)
        return ps[:, par_idx] * s_local[None]

    # -- interpolation (edge circulations of a vector field) -------------------

    def interpolate(self, expr, sd=None, shard: int = 0,
                    n_gauss: int = 2) -> torch.Tensor:
        """DoF_e = integral over edge e of expr(x) . t_e dl in the canonical
        orientation (reference: N1E1VectorFunction::interpolate). ``expr``
        maps (..., 3) physical coords -> (..., 3) vectors."""
        sd = self.resolve_sd(sd, shard)
        coords = self.node_space.coords_from(sd.cell_vertices)  # (C, M..,3)
        J = self.node_space._tensor(self._jacobians(shard))
        dirs = self.node_space._tensor(directions(self.dim))
        ps = self.node_space._tensor(self.parity_signs(shard))
        # physical half-edge vector per (cell, parity): J @ d / (2n)
        half = torch.einsum("cij,pj->cpi", J, dirs) / (2.0 * self.n)
        if n_gauss == 1:
            s_pts, s_wts = [0.0], [1.0]
        else:
            g = 1.0 / (2.0 * np.sqrt(3.0))
            s_pts, s_wts = [-g, g], [0.5, 0.5]
        out = torch.zeros(self.block_shape, dtype=self.dtype,
                          device=self.device)
        for k in range(self.parity_masks.shape[0]):
            h = half[:, k].reshape(-1, 1, 1, 3)
            acc = 0.0
            for s, w in zip(s_pts, s_wts):
                x = coords + (2.0 * s) * h
                ev = torch.as_tensor(expr(x), dtype=self.dtype,
                                     device=self.device)
                acc = acc + w * torch.sum(ev * (2.0 * h), dim=-1)
            sgn = ps[:, k].reshape(-1, 1, 1)
            out = out + sgn * acc * self.parity_masks_t[k][None]
        # replicas agree up to roundoff; force the representative's value
        if self.storage.num_shards == 1:
            out = self.node_space._exchange_rep_(out, sd)
        return out

    # -- discrete gradient G and transpose ------------------------------------

    def gradient_apply(self, p: torch.Tensor) -> torch.Tensor:
        """(G p)_e = p(head) - p(tail) (canonical orientation). ``p`` lives on
        the even nodes of the doubled grid (P2-style embedding of a P1
        level-L function). Local: replicas of consistent p give consistent
        canonical edge values, so no exchange is needed."""
        dirs = directions(self.dim)
        pitch = self.node_space.pitch
        out = torch.zeros_like(p)
        for k in range(dirs.shape[0]):
            d = dirs[k]
            diff = (_shift(p, d, pitch, self.dim)
                    - _shift(p, -d, pitch, self.dim))
            out = out + self._sign_cols[k] * diff * self.parity_masks_t[k][None]
        return out

    def gradient_transpose_apply(self, r: torch.Tensor,
                                 sd=None) -> torch.Tensor:
        """(G^T r) on the even (vertex) nodes: per-cell partial sums — callers
        must exchange_add the result (assembly-style). Unlike element-based
        assembly, G^T sums over *edges*, and interface edges are replicated
        across cells — each replica is weighted by 1/multiplicity so the
        post-exchange sum counts every global edge exactly once."""
        sd = self.resolve_sd(sd)
        w = self.node_space.unique_weight(sd)
        dirs = directions(self.dim)
        pitch = self.node_space.pitch
        rw = r * w
        out = torch.zeros_like(r)
        for k in range(dirs.shape[0]):
            d = dirs[k]
            v = self._sign_cols[k] * rw * self.parity_masks_t[k][None]
            out = out + _shift(v, [-x for x in d], pitch, self.dim) - _shift(
                v, d, pitch, self.dim)
        return out * self.vertexnode_mask_t[None]

    def function(self, bc: BoundaryCondition | None = None) -> "N1E1Function":
        return N1E1Function(self.zeros(), self,
                            bc or BoundaryCondition.all_dirichlet())


@dataclasses.dataclass
class N1E1Function:
    """User-facing N1E1 handle (reference: N1E1VectorFunction)."""

    cells: torch.Tensor
    space: N1E1Space
    bc: BoundaryCondition

    def _sd(self):
        return self.space.shard_data(0, self.bc)

    def _like(self, cells) -> "N1E1Function":
        return N1E1Function(cells, self.space, self.bc)

    def interpolate(self, expr) -> "N1E1Function":
        return self._like(self.space.interpolate(expr, self._sd()))

    def assign(self, scalars, functions) -> "N1E1Function":
        return self._like(sum(s * f.cells for s, f in zip(scalars, functions)))

    def dot_global(self, other: "N1E1Function", flag=DoFType.ALL):
        return self.space.dot(self.cells, other.cells, flag, self._sd())

    def norm(self, flag=DoFType.ALL):
        return torch.sqrt(self.dot_global(self, flag))
