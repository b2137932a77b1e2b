"""Standalone EdgeDoF function space (one scalar DoF per micro-edge);
torch counterpart of hyteg_tpu/functions/edgedof.py.

TPU-native equivalent of the reference's EdgeDoFFunction
(reference: src/hyteg/edgedofspace/EdgeDoFFunction.hpp, orientations
src/hyteg/edgedofspace/EdgeDoFOrientation.hpp:29-39 — X, Y, Z, XY, XZ, YZ,
XYZ). As with P2 (see functions/p2.py) and N1E1 (functions/n1e1.py), edge
midpoints are the odd-parity nodes of the level-(L+1) node grid, so an
EdgeDoF function is one (C, M...) block masked to odd nodes, with the parity
class playing the role of the reference's orientation enum, and all
communication reusing the P1 level-(L+1) interface machinery.

Unlike N1E1 the DoFs are plain scalars (no orientation sign)."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.types import BoundaryCondition, DoFType
from ..indexing import flat
from ..primitives.storage import CellStorage
from .n1e1 import parities
from .p1 import P1ShardData, P1Space


class EdgeDoFSpace:
    """Binds (storage, element level L, device); DoFs on odd nodes of the
    L+1 grid. ``device`` has no default."""

    def __init__(self, storage: CellStorage, level: int, *, device,
                 dtype=torch.float32):
        self.storage = storage
        self.level = level
        self.node_space = P1Space(storage, level + 1, device=device,
                                  dtype=dtype)
        self.device = self.node_space.device
        self.dtype = dtype
        self.dim = storage.dim
        self.n = 1 << level
        self.M = self.node_space.N

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

    # -- orientation masks ----------------------------------------------------

    @functools.cached_property
    def orientation_masks(self) -> np.ndarray:
        """(P, M, lanes) bool — one mask per edge orientation (parity class)."""
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
        return self.orientation_masks.any(axis=0)

    def num_global_dofs(self) -> int:
        return (self.node_space.num_global_dofs()
                - self.storage.p1_level_maps(self.level).num_global_dofs)

    # -- ops (masked to edge DoFs) ---------------------------------------------

    def _edge_weight(self, dtype) -> torch.Tensor:
        return self.node_space._tensor(self.edge_mask[None], dtype)

    def interpolate(self, expr, sd=None, shard: int = 0) -> torch.Tensor:
        """Evaluate ``expr`` at every edge midpoint (reference EdgeDoF
        interpolate semantics: value at the micro-edge center)."""
        sd = self.resolve_sd(sd, shard)
        if callable(expr):
            vals = torch.as_tensor(
                expr(self.node_space.coords_from(sd.cell_vertices)),
                dtype=self.dtype, device=self.device)
        else:
            vals = torch.full(self.block_shape, expr, dtype=self.dtype,
                              device=self.device)
        return vals * self._edge_weight(self.dtype)

    def dot(self, u, v, flag=DoFType.ALL, sd=None):
        """Global dot counting every edge DoF once (zero even nodes make the
        node-grid dot exact on edge-masked inputs)."""
        w = self._edge_weight(u.dtype)
        return self.node_space.dot(u * w, v * w, flag, sd)

    def dof_sum(self, u, flag=DoFType.ALL, sd=None):
        return self.dot(u, torch.ones_like(u), flag, sd)

    def function(self, bc: BoundaryCondition | None = None) -> "EdgeDoFFunction":
        return EdgeDoFFunction(self.zeros(), self,
                               bc or BoundaryCondition.all_dirichlet())


@dataclasses.dataclass
class EdgeDoFFunction:
    """User-facing EdgeDoF handle (reference: EdgeDoFFunction)."""

    cells: torch.Tensor
    space: EdgeDoFSpace
    bc: BoundaryCondition

    def _sd(self):
        return self.space.shard_data(0, self.bc)

    def interpolate(self, expr) -> "EdgeDoFFunction":
        return EdgeDoFFunction(
            self.space.interpolate(expr, self._sd()), self.space, self.bc)

    def assign(self, scalars, functions) -> "EdgeDoFFunction":
        vals = sum(s * f.cells for s, f in zip(scalars, functions))
        return EdgeDoFFunction(vals, self.space, self.bc)

    def dot_global(self, other: "EdgeDoFFunction", flag=DoFType.ALL):
        return self.space.dot(self.cells, other.cells, flag, self._sd())

    def sum_global(self, flag=DoFType.ALL):
        return self.space.dof_sum(self.cells, flag, self._sd())
