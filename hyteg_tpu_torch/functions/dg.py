"""DG1 (discontinuous piecewise-linear) function space; torch counterpart
of hyteg_tpu/functions/dg.py.

Reference: src/hyteg/dgfunctionspace/DGFunction.hpp,
src/hyteg/dg1functionspace/DG1Function.hpp. A DG1 function stores
``nv = dim+1`` nodal values (at the element's vertices) per micro-element
in a VolumeDoF block (C, T, n..., nv): no inter-element continuity, no
interface replication; facet coupling is done by the DG operators
(operators/dg_ops.py)."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..indexing import micro
from ..primitives.storage import CellStorage
from .volume import VolumeDoFSpace, _p1_grid, _vertex_slice


class DG1Space(VolumeDoFSpace):
    """VolumeDoF space with one DoF per element vertex."""

    def __init__(self, storage: CellStorage, level: int, *, device,
                 dtype=torch.float32):
        super().__init__(storage, level, ndofs=storage.dim + 1,
                         device=device, dtype=dtype)

    def interpolate(self, expr) -> torch.Tensor:
        """Nodal interpolation: evaluate at every element vertex."""
        if not callable(expr):
            return super().interpolate(expr)
        verts = self.elem_vertices()  # (C, T, n..., nv, dim)
        vals = torch.as_tensor(expr(verts), dtype=self.dtype,
                               device=self.device)
        return vals * self.valid_weight_t[..., None]

    def integral(self, u) -> torch.Tensor:
        """Exact integral of the piecewise-linear field: |K| * mean(nodal)."""
        return torch.sum(self.elem_volumes[..., None] * u) / self.ndofs

    @functools.cached_property
    def mass_elmats(self) -> torch.Tensor:
        """(C, T, nv, nv) block-diagonal DG1 mass matrices (exact)."""
        nv = self.ndofs
        denom = 20.0 if self.dim == 3 else 12.0
        base = (np.ones((nv, nv)) + np.eye(nv)) / denom
        vols = self.elem_volumes  # (C, T, n...)
        # volumes are constant per (cell, class); take the base element
        v0 = vols[(slice(None), slice(None)) + (0,) * self.dim]
        return v0[..., None, None] * self._tensor(base)

    def _blockwise(self, m, u) -> torch.Tensor:
        shape = u.shape
        ue = u.reshape(shape[:2] + (-1, self.ndofs))
        return torch.einsum("ctab,ctkb->ctka", m, ue).reshape(shape)

    def mass_apply(self, u) -> torch.Tensor:
        return self._blockwise(self.mass_elmats, u)

    @functools.cached_property
    def _inv_mass_elmats(self) -> torch.Tensor:
        m = self.mass_elmats.detach().cpu().double().numpy()
        sel = np.abs(np.linalg.det(m)) > 1e-300
        minv = np.zeros_like(m)
        minv[sel] = np.linalg.inv(m[sel])
        return self._tensor(minv)

    def inverse_mass_apply(self, u) -> torch.Tensor:
        return self._blockwise(self._inv_mass_elmats, u)


def p1_to_dg1(p1_space, u_p1, dg: DG1Space) -> torch.Tensor:
    """Exact embedding P1 -> DG1 (reference: P1toDG conversion): element
    vertex value = P1 value at that micro-vertex."""
    assert dg.level == p1_space.level
    dim, n = dg.dim, dg.n
    g = _p1_grid(p1_space, u_p1)
    offs = micro.offsets(dim)
    parts = [torch.stack([g[_vertex_slice(offs[t, v], n, dim)]
                          for v in range(offs.shape[1])], dim=-1)
             for t in range(dg.T)]
    return torch.stack(parts, dim=1) * dg._weight(u_p1.dtype)


@dataclasses.dataclass
class DG1Function:
    """User-facing DG1 handle (reference: DG1Function)."""

    values: torch.Tensor
    space: DG1Space

    def interpolate(self, expr) -> "DG1Function":
        return DG1Function(self.space.interpolate(expr), self.space)

    def assign(self, scalars, functions) -> "DG1Function":
        return DG1Function(
            sum(s * f.values for s, f in zip(scalars, functions)), self.space)

    def dot_global(self, other: "DG1Function"):
        return self.space.dot(self.values, other.values)

    def integral(self):
        return self.space.integral(self.values)
