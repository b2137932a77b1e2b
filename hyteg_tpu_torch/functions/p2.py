"""P2 (quadratic Lagrange) function space on dense node grids (torch
counterpart of hyteg_tpu/functions/p2.py, 2D and 3D; sharded through
the node space's shard data, as the JAX package's ``axis_name`` paths).

The micro-edge midpoints of refinement level L are exactly the
micro-vertices of level L+1, so all P2 DoFs (vertex DoFs and the 7 edge
orientations, 3 in 2D) live on the dense level-(L+1) node grid:

    even-parity nodes  <-> vertex DoFs
    odd-parity nodes   <-> edge DoFs (parity class == edge orientation:
                           (1,0,0) = X ... (1,1,1) = XYZ)

A P2 function is one (C, M, M*pitch) block ((C, M, M) in 2D) with
M = 2^(L+1)+1, and every space operation (exchanges, flags, dots,
interpolation) is the level-(L+1) P1 space's.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.types import BoundaryCondition, DoFType
from ..indexing import flat, micro
from ..primitives.storage import CellStorage
from .p1 import P1ShardData, P1Space


class P2Space:
    """Binds (storage, element level L, device); DoFs live on the level-
    (L+1) node grid of ``node_space``. ``device`` has no default."""

    def __init__(self, storage: CellStorage, level: int, *, device,
                 dtype=torch.float32, pitch: int | None = None):
        self.storage = storage
        self.level = level              # element refinement level
        self.node_space = P1Space(storage, level + 1, device=device,
                                  dtype=dtype, pitch=pitch)
        self.device = self.node_space.device
        self.dtype = dtype
        self.dim = storage.dim
        self.n = 1 << level             # elements per macro-edge
        self.M = self.node_space.N      # node-grid points per macro-edge
        self.pitch = self.node_space.pitch

    # -- delegation to the node grid ----------------------------------------

    @property
    def block_shape(self):
        return self.node_space.block_shape

    @property
    def lanes(self) -> int:
        return self.node_space.lanes

    def zeros(self) -> torch.Tensor:
        return self.node_space.zeros()

    def num_global_dofs(self) -> int:
        return self.node_space.num_global_dofs()

    def shard_data(self, shard: int, bc: BoundaryCondition) -> P1ShardData:
        return self.node_space.shard_data(shard, bc)

    def group_shard_data(self, group, bc: BoundaryCondition,
                         neighbor: bool = True) -> P1ShardData:
        return self.node_space.group_shard_data(group, bc, neighbor)

    def resolve_sd(self, sd_or_bc=None, shard: int = 0) -> P1ShardData:
        return self.node_space.resolve_sd(sd_or_bc, shard)

    def exchange_add(self, u, sd=None) -> torch.Tensor:
        return self.node_space.exchange_add(u, sd)

    def exchange_rep(self, u, sd=None) -> torch.Tensor:
        return self.node_space.exchange_rep(u, sd)

    def _exchange_add_(self, u, sd) -> torch.Tensor:
        return self.node_space._exchange_add_(u, sd)

    def dot(self, u, v, flag=DoFType.ALL, sd=None) -> torch.Tensor:
        return self.node_space.dot(u, v, flag, sd)

    def dof_sum(self, u, flag=DoFType.ALL, sd=None):
        return self.node_space.dof_sum(u, flag, sd)

    def dof_max(self, u, flag=DoFType.ALL, sd=None):
        return self.node_space.dof_max(u, flag, sd)

    def restore_rows(self, new, old, flag, sd=None) -> torch.Tensor:
        return self.node_space.restore_rows(new, old, flag, sd)

    def _restore_rows_(self, new, old, flag, sd) -> torch.Tensor:
        return self.node_space._restore_rows_(new, old, flag, sd)

    def interpolate(self, expr, old, flag, sd=None) -> torch.Tensor:
        """P2 nodal interpolation: evaluate at every node (vertices and edge
        midpoints), which is P1 interpolation on the node grid."""
        return self.node_space.interpolate(expr, old, flag, sd)

    def coords(self, shard: int = 0) -> torch.Tensor:
        return self.node_space.coords(shard)

    def cell_vertices(self, shard: int = 0) -> np.ndarray:
        return self.node_space.cell_vertices(shard)

    def global_ids(self, shard: int = 0) -> np.ndarray:
        return self.node_space.global_ids(shard)

    def global_ids_grid(self, shard: int = 0) -> np.ndarray:
        return self.node_space.global_ids_grid(shard)

    @property
    def vertex_mask(self) -> np.ndarray:
        return self.node_space.vertex_mask

    @property
    def vertex_mask_t(self) -> torch.Tensor:
        return self.node_space.vertex_mask_t

    @property
    def interior_mask(self) -> np.ndarray:
        return self.node_space.interior_mask

    # -- parity views (VertexDoF / EdgeDoF decomposition) --------------------

    def _parity_grid(self, parity) -> np.ndarray:
        """(M, lanes) bool: nodes whose coordinates have this parity."""
        grids = np.meshgrid(*([np.arange(self.M)] * self.dim), indexing="ij")
        m = np.ones_like(grids[0], dtype=bool)
        for g, p in zip(grids, parity):
            m &= g % 2 == p
        if self.dim == 3:
            m = flat.flatten_field(m, self.pitch)
        return m & self.vertex_mask

    @functools.cached_property
    def vertexdof_mask(self) -> np.ndarray:
        """(M, lanes) bool: even-parity nodes (the P1 sub-function)."""
        return self._parity_grid((0,) * self.dim)

    @functools.cached_property
    def edgedof_mask(self) -> np.ndarray:
        return self.vertex_mask & ~self.vertexdof_mask

    def edgedof_orientation_mask(self, parity: tuple[int, ...]) -> np.ndarray:
        """Mask of one edge orientation (reference EdgeDoFOrientation):
        parity (1,0,0) = X edges, ..., (1,1,1) = XYZ diagonal edges."""
        return self._parity_grid(parity)

    def p1_subspace(self) -> P1Space:
        """The level-L P1 space on the same lane pitch (vertex DoFs)."""
        return P1Space(self.storage, self.level, device=self.device,
                       dtype=self.dtype, pitch=self.pitch)

    def vertexdof_view(self, u: torch.Tensor) -> torch.Tensor:
        """(C, N_L, N_L*pitch) P1 level-L block (same pitch; (C, N_L, N_L)
        in 2D): the vertex DoFs of u. Stride-2 lane slicing maps coarse
        lane yc*P + zc to fine lane 2yc*P + 2zc; lanes it aliases onto odd
        nodes are masked off with the coarse vertex mask."""
        Nc = (1 << self.level) + 1
        if self.dim == 2:
            return u[:, ::2, ::2] * torch.as_tensor(
                micro.vertex_mask_flat(self.level, 2, Nc), dtype=u.dtype,
                device=u.device)
        P = self.pitch
        Lc, Lu = Nc * P, (Nc - 1) * P + Nc
        v = u[:, : 2 * Nc - 1 : 2, : 2 * Lu - 1 : 2]
        if Lu < Lc:
            v = torch.nn.functional.pad(v, (0, Lc - Lu))
        cvm = torch.as_tensor(micro.vertex_mask_flat(self.level, 3, P),
                              dtype=v.dtype, device=v.device)
        return v * cvm

    def embed_p1(self, u_p1_levelL: torch.Tensor) -> torch.Tensor:
        """Embed a P1 level-L function into P2 (exact: linear functions are
        quadratic; edge values are endpoint averages), the reference's
        P1 -> P2 conversion (gridtransferoperators/P1toP2Conversion)."""
        from ..operators.transfer import P1Transfer

        tr = P1Transfer(self.p1_subspace(), self.node_space)
        return tr.prolongate(u_p1_levelL)

    def function(self, bc: BoundaryCondition | None = None) -> "P2Function":
        return P2Function(self.zeros(), self,
                          bc or BoundaryCondition.all_dirichlet())


@dataclasses.dataclass
class P2Function:
    """User-facing P2 handle (same surface as P1Function)."""

    cells: torch.Tensor
    space: P2Space
    bc: BoundaryCondition

    def _like(self, cells) -> "P2Function":
        return P2Function(cells, self.space, self.bc)

    def _sd(self):
        return self.space.shard_data(0, self.bc)

    def assign(self, scalars, functions, flag: DoFType = DoFType.ALL):
        new = sum(s * f.cells for s, f in zip(scalars, functions))
        if flag == DoFType.ALL:
            return self._like(new)
        return self._like(
            self.space.restore_rows(new, self.cells, flag, self._sd()))

    def interpolate(self, expr, flag: DoFType = DoFType.ALL) -> "P2Function":
        return self._like(
            self.space.interpolate(expr, self.cells, flag, self._sd()))

    def dot_global(self, other: "P2Function", flag: DoFType = DoFType.ALL):
        return self.space.dot(self.cells, other.cells, flag, self._sd())

    def sum_global(self, flag: DoFType = DoFType.ALL):
        return self.space.dof_sum(self.cells, flag, self._sd())

    def max_global(self, flag: DoFType = DoFType.ALL):
        return self.space.dof_max(self.cells, flag, self._sd())

    def norm(self, flag: DoFType = DoFType.ALL):
        return torch.sqrt(self.dot_global(self, flag))
