"""VolumeDoF / P0 / DG function spaces: per-micro-element DoFs (torch
counterpart of hyteg_tpu/functions/volume.py).

Reference: src/hyteg/volumedofspace/VolumeDoFFunction.hpp,
CellDoFIndexing.hpp:38-55 (WHITE_UP..GREEN_DOWN micro-cell types) and
src/hyteg/p0functionspace/P0Function.hpp. Data layout is SoA:

    (C, T, n, ..., n [, ndofs])   n = 2^level, T = element classes (6/2)

masked by the per-class base masks. Volume DoFs are owned by their
macro-cell: no interface replication and no halo exchange (the DG facet
operators couple neighbouring cells themselves, operators/dg_ops.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..indexing import flat, micro
from ..primitives.storage import CellStorage


class VolumeDoFSpace:
    """Per-micro-element DoF space with ``ndofs`` scalars per element, on
    ``device`` (no default)."""

    def __init__(self, storage: CellStorage, level: int, ndofs: int = 1, *,
                 device, dtype=torch.float32):
        self.storage = storage
        self.level = level
        self.dim = storage.dim
        self.n = 1 << level
        self.T = micro.num_classes(self.dim)
        self.ndofs = ndofs
        self.device = torch.device(device)
        self.dtype = dtype
        self.C_loc = storage.cells_per_shard * storage.num_shards

    # -- static masks / geometry ----------------------------------------------

    @functools.cached_property
    def base_mask(self) -> np.ndarray:
        """(T, n...) bool — valid element base positions per class."""
        crop = tuple(slice(0, self.n) for _ in range(self.dim))
        return np.stack([micro.elem_base_mask(self.level, t, self.dim)[crop]
                         for t in range(self.T)])

    @property
    def block_shape(self):
        s = (self.C_loc, self.T) + (self.n,) * self.dim
        return s + ((self.ndofs,) if self.ndofs > 1 else ())

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype,
                               device=self.device)

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.block_shape, dtype=self.dtype,
                           device=self.device)

    @functools.cached_property
    def _valid_weight(self) -> np.ndarray:
        """(C, T, n...) float64: 1 on valid elements of valid cells."""
        cv = np.asarray(self.storage.cell_valid, dtype=np.float64)
        return cv.reshape((-1, 1) + (1,) * self.dim) * self.base_mask[None]

    @functools.cached_property
    def valid_weight_t(self) -> torch.Tensor:
        """``_valid_weight`` as a tensor of the space's dtype."""
        return self._tensor(self._valid_weight)

    def _weight(self, dtype=None) -> torch.Tensor:
        w = self.valid_weight_t if dtype in (None, self.dtype) else \
            self._tensor(self._valid_weight, dtype)
        return w[..., None] if self.ndofs > 1 else w

    def num_global_dofs(self) -> int:
        return int(self._valid_weight.sum()) * self.ndofs

    def elem_vertices(self, cell_vertices=None) -> torch.Tensor:
        """(C, T, n..., nv, dim) physical vertex coords of every element."""
        cv = (self._tensor(self.storage.cell_vertices) if cell_vertices is None
              else cell_vertices)
        verts = cv[..., : self.dim]
        v0 = verts[:, :1, :]
        J = verts[:, 1:, :] - v0  # (C, dim, dim)
        offs = self._tensor(micro.offsets(self.dim))  # (T, nv, dim)
        axes = [torch.arange(self.n, dtype=self.dtype, device=self.device)] \
            * self.dim
        grids = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
        ref = (grids[None, ..., None, :] + offs.reshape(
            (self.T,) + (1,) * self.dim + offs.shape[1:])) / self.n
        return v0.reshape((-1,) + (1,) * (self.dim + 2) + (self.dim,)) + \
            torch.einsum("t...vd,cde->ct...ve", ref, J)

    def elem_centroids(self) -> torch.Tensor:
        return self.elem_vertices().mean(dim=-2)

    @functools.cached_property
    def elem_volumes(self) -> torch.Tensor:
        """(C, T, n...) element measures (areas/volumes)."""
        cv = self._tensor(self.storage.cell_vertices)
        verts = cv[..., : self.dim]
        J = verts[:, 1:, :] - verts[:, :1, :]
        det = torch.abs(torch.linalg.det(J.double())).to(self.dtype)
        fact = 2.0 if self.dim == 2 else 6.0
        vol = det / fact / (self.n ** self.dim)  # all classes equal measure
        return vol.reshape((-1, 1) + (1,) * self.dim) * self.valid_weight_t

    # -- vector-space ops -------------------------------------------------------

    def interpolate(self, expr) -> torch.Tensor:
        """Evaluate ``expr`` (constant or callable of centroid coords
        (..., dim)) per element (reference: P0 interpolate semantics)."""
        if callable(expr):
            vals = torch.as_tensor(expr(self.elem_centroids()),
                                   dtype=self.dtype, device=self.device)
        else:
            vals = torch.full((self.C_loc, self.T) + (self.n,) * self.dim,
                              expr, dtype=self.dtype, device=self.device)
        w = self._weight()
        if self.ndofs > 1:
            if vals.ndim == w.ndim - 1:
                vals = vals[..., None]
            vals = vals.expand(self.block_shape)
        return vals * w

    def dot(self, u, v) -> torch.Tensor:
        return torch.sum(u * v * self._weight(u.dtype))

    def dof_sum(self, u):
        return self.dot(u, torch.ones_like(u))

    def dof_max(self, u):
        w = self._weight(u.dtype) > 0
        return torch.where(w, u, -torch.inf).max()

    def integral(self, u) -> torch.Tensor:
        """Domain integral of the piecewise-constant field (ndofs=1)."""
        return torch.sum(u * self.elem_volumes)

    # -- P0 mass operator (diagonal) ----------------------------------------------

    def mass_apply(self, u) -> torch.Tensor:
        """P0 mass matrix is diagonal: M u = |K| u."""
        return u * self.elem_volumes

    def inverse_mass_apply(self, u) -> torch.Tensor:
        v = self.elem_volumes
        return torch.where(v > 0, u / torch.where(v > 0, v, 1.0), 0.0)


class P0Function:
    """Piecewise-constant function handle (reference: P0Function)."""

    def __init__(self, space: VolumeDoFSpace, values=None):
        assert space.ndofs == 1
        self.space = space
        self.values = space.zeros() if values is None else values

    def interpolate(self, expr) -> "P0Function":
        return P0Function(self.space, self.space.interpolate(expr))

    def assign(self, scalars, functions) -> "P0Function":
        vals = sum(s * f.values for s, f in zip(scalars, functions))
        return P0Function(self.space, vals)

    def dot_global(self, other: "P0Function"):
        return self.space.dot(self.values, other.values)

    def integral(self):
        return self.space.integral(self.values)


# -- conversions P1 <-> P0 (reference: gridtransferoperators P1toP0/P0toP1) ----


def _p1_grid(p1_space, u_p1):
    """The exact (C, N, ..., N) grid of a P1 block (a view in 3D)."""
    if p1_space.dim == 3:
        return flat.to_grid(u_p1, p1_space.N, p1_space.pitch)[..., : p1_space.N]
    return u_p1


def _vertex_slice(off, n: int, dim: int):
    return (slice(None),) + tuple(slice(int(off[d]), int(off[d]) + n)
                                  for d in range(dim))


def p1_to_p0(p1_space, u_p1, vol_space: VolumeDoFSpace) -> torch.Tensor:
    """Element value = mean of the element's vertex values."""
    assert vol_space.level == p1_space.level
    dim, n = vol_space.dim, vol_space.n
    g = _p1_grid(p1_space, u_p1)
    offs = micro.offsets(dim)
    parts = []
    for t in range(vol_space.T):
        acc = None
        for v in range(offs.shape[1]):
            r = g[_vertex_slice(offs[t, v], n, dim)]
            acc = r if acc is None else acc + r
        parts.append(acc / offs.shape[1])
    return torch.stack(parts, dim=1) * vol_space._weight(u_p1.dtype)


def p0_to_p1(vol_space: VolumeDoFSpace, u_p0, p1_space, sd=None) -> torch.Tensor:
    """Volume-weighted average of adjacent element values at each vertex."""
    dim, n = vol_space.dim, vol_space.n
    offs = micro.offsets(dim)
    vols = vol_space.elem_volumes.to(u_p0.dtype)
    N = p1_space.N
    if dim == 3:  # the flat blocks, written through their exact grid views
        P = p1_space.pitch
        num = torch.zeros((vol_space.C_loc, N, N * P), dtype=u_p0.dtype,
                          device=u_p0.device)
        den = torch.zeros_like(num)
        gnum, gden = _p1_grid(p1_space, num), _p1_grid(p1_space, den)
    else:
        num = torch.zeros((vol_space.C_loc, N, N), dtype=u_p0.dtype,
                          device=u_p0.device)
        den = torch.zeros_like(num)
        gnum, gden = num, den
    for t in range(vol_space.T):
        contrib = u_p0[:, t] * vols[:, t]
        wgt = vols[:, t]
        for v in range(offs.shape[1]):
            sl = _vertex_slice(offs[t, v], n, dim)
            gnum[sl] += contrib
            gden[sl] += wgt
    sd = p1_space.resolve_sd(sd)
    num = p1_space._exchange_add_(num, sd)
    den = p1_space._exchange_add_(den, sd)
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
