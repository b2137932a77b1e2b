"""P1 (vertex-DoF) function space on macro-cell blocks (torch counterpart
of hyteg_tpu/functions/p1.py, single shard, 2D and 3D).

DoF values live in dense masked *flat* blocks, one block per macro-cell:
``(C, N, N*pitch)`` in 3D (lane = y*pitch + z; see indexing/flat.py),
``(C, N, N)`` in 2D, where a cell is a macro-face and the lane axis is z
itself (no pitch, no padding lanes; the triangle x + z <= n fills half
the block). Interface DoFs are replicated across adjacent cells
(invariant: replicas equal; slots outside the simplex stay zero). The
halo exchange of the reference (communicate / communicateAdditively)
becomes two index-map exchanges over precomputed slot maps:

  * ``exchange_add``  — replicas <- sum of replicas (``index_add_``)
  * ``exchange_rep``  — replicas <- owner value (gather from the
    representative slot)

``index_add_`` adds with atomics on CUDA, in no fixed order, so sums over
replicas may differ from run to run in the last bits.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.types import BoundaryCondition, DoFType
from ..indexing import flat, micro
from ..primitives.storage import CellStorage, P1LevelMaps


@dataclasses.dataclass
class P1ShardData:
    """Slot maps of one shard under one BC, as device tensors.

    Only valid slots are kept: the JAX package carries padded slots with
    an out-of-bounds ``slot_flat`` and drops them in every scatter
    (``mode="drop"``); torch indexing raises on such indices, so they are
    filtered out once here."""

    slot_flat: torch.Tensor      # (S,) int64 flat index into the block
    slot_gid: torch.Tensor       # (S,) int64 global interface-DoF id
    slot_rep: torch.Tensor       # (S,) bool — representative slot of its DoF
    slot_inv_mult: torch.Tensor  # (S,) float — 1 / replica count
    slot_doftype: torch.Tensor   # (S,) int32 — DoFType under ``bc``
    cell_vertices: torch.Tensor  # (C, dim + 1, 3) float
    bc: BoundaryCondition
    _by_flag: dict = dataclasses.field(default_factory=dict, repr=False)

    def _flag_slots(self, flag: DoFType):
        """(flat idx of slots in flag, of slots not in flag, of
        representative slots in flag), built once per flag: boolean
        indexing synchronises with the device."""
        key = int(flag)
        if key not in self._by_flag:
            sel = (self.slot_doftype & key) != 0
            self._by_flag[key] = (self.slot_flat[sel], self.slot_flat[~sel],
                                  self.slot_flat[sel & self.slot_rep])
        return self._by_flag[key]

    @functools.cached_property
    def rep_slots(self):
        """(flat idx, gid) of every representative slot."""
        return self.slot_flat[self.slot_rep], self.slot_gid[self.slot_rep]


@dataclasses.dataclass
class P1Function:
    """User-facing handle: per-cell DoF blocks + space + BC."""

    cells: torch.Tensor  # (C, N, lanes)
    space: "P1Space"
    bc: BoundaryCondition

    def copy(self) -> "P1Function":
        return P1Function(self.cells.clone(), self.space, self.bc)

    def _like(self, cells) -> "P1Function":
        return P1Function(cells, self.space, self.bc)

    def _sd(self):
        return self.space.shard_data(0, self.bc)

    def assign(self, scalars, functions, flag: DoFType = DoFType.ALL) -> "P1Function":
        new = sum(s * f.cells for s, f in zip(scalars, functions))
        if flag == DoFType.ALL:
            return self._like(new)
        return self._like(
            self.space.restore_rows(new, self.cells, flag, self._sd()))

    def add_scaled(self, scalars, functions, flag: DoFType = DoFType.ALL) -> "P1Function":
        new = self.cells + sum(s * f.cells for s, f in zip(scalars, functions))
        if flag == DoFType.ALL:
            return self._like(new)
        return self._like(
            self.space.restore_rows(new, self.cells, flag, self._sd()))

    def interpolate(self, expr, flag: DoFType = DoFType.ALL) -> "P1Function":
        return self._like(
            self.space.interpolate(expr, self.cells, flag, self._sd()))

    def dot_global(self, other: "P1Function", flag: DoFType = DoFType.ALL):
        return self.space.dot(self.cells, other.cells, flag, self._sd())

    def sum_global(self, flag: DoFType = DoFType.ALL):
        return self.space.dof_sum(self.cells, flag, self._sd())

    def max_global(self, flag: DoFType = DoFType.ALL):
        return self.space.dof_max(self.cells, flag, self._sd())

    def norm(self, flag: DoFType = DoFType.ALL):
        return torch.sqrt(self.dot_global(self, flag))


class P1Space:
    """Binds (storage, level, device): static masks, slot maps, exchanges
    and reductions. 2D or 3D, one shard. ``device`` has no default: a
    caller names the card or the CPU. A 2D space ignores ``pitch`` (its
    blocks have none), as the JAX package does."""

    def __init__(self, storage: CellStorage, level: int, *, device,
                 dtype=torch.float32, pitch: int | None = None):
        if storage.num_shards != 1:
            raise NotImplementedError(
                "multi-shard storage is not ported yet (ROADMAP A8)")
        self.storage = storage
        self.level = level
        self.device = torch.device(device)
        self.dtype = dtype
        self.dim = storage.dim
        self.N = (1 << level) + 1
        self.n = self.N - 1
        # lane pitch of the flat 3D layout; GMG stacks share pitch = N_max
        # across levels so grid transfers are pure stride-2 slicing
        self.pitch = self.N if (pitch is None or self.dim == 2) else int(pitch)
        assert self.pitch >= self.N
        self.maps: P1LevelMaps = storage.p1_level_maps(level, self.pitch)
        self.C_loc = storage.cells_per_shard
        self._sd_cache: dict = {}

    # -- static helpers ------------------------------------------------------

    @property
    def lanes(self) -> int:
        """Size of the minor (lane) axis of a block."""
        return self.N * self.pitch if self.dim == 3 else self.N

    @property
    def block_shape(self):
        return (self.C_loc, self.N, self.lanes)

    @property
    def block_size(self):
        return self.C_loc * self.N * self.lanes

    @functools.cached_property
    def vertex_mask(self) -> np.ndarray:
        """Flat (N, lanes) bool mask of valid micro-vertices."""
        return micro.vertex_mask_flat(self.level, self.dim, self.pitch)

    @functools.cached_property
    def interior_mask(self) -> np.ndarray:
        return micro.interior_mask_flat(self.level, self.dim, self.pitch)

    def _tensor(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype,
                               device=self.device)

    @functools.cached_property
    def vertex_mask_t(self) -> torch.Tensor:
        """(N, lanes) vertex mask as a tensor of the space's dtype."""
        return self._tensor(self.vertex_mask)

    @functools.cached_property
    def _interior_w(self) -> torch.Tensor:
        return self._tensor(self.interior_mask)

    def to_grid(self, u):
        """(C, N, lanes) -> (C, N, N, pitch) view (3D; identity in 2D)."""
        if self.dim == 2:
            return u
        return u.reshape(u.shape[:-1] + (self.N, self.pitch))

    def from_grid(self, g):
        if self.dim == 2:
            return g
        return g.reshape(g.shape[:-2] + (self.N * self.pitch,))

    def cell_vertices(self, shard: int = 0) -> np.ndarray:
        lo = shard * self.C_loc
        return self.storage.cell_vertices[lo : lo + self.C_loc]

    def num_global_dofs(self) -> int:
        return self.maps.num_global_dofs

    # -- shard data ----------------------------------------------------------

    @functools.cached_property
    def slot_rep_mask(self) -> np.ndarray:
        """(D, S) bool — slot is the global representative of its DoF."""
        m = self.maps
        out = np.zeros(m.slot_flat.shape, dtype=bool)
        out[m.ifc_rep_dev, m.ifc_rep_slot] = True
        return out

    @functools.cached_property
    def slot_inv_mult(self) -> np.ndarray:
        """(D, S) float — 1 / replica count (0 on padded slots)."""
        m = self.maps
        inv = np.zeros(m.slot_flat.shape, dtype=np.float64)
        valid = m.slot_gid < m.num_ifc
        inv[valid] = 1.0 / m.ifc_mult[m.slot_gid[valid]]
        return inv

    def slot_doftype_np(self, bc: BoundaryCondition) -> np.ndarray:
        """(D, S) int32 DoFType per interface slot under the given BC."""
        flags = self.maps.slot_meshflag
        out = np.zeros(flags.shape, dtype=np.int32)
        for f in np.unique(flags):
            out[flags == f] = int(bc.doftype_of(int(f)))
        return out

    def resolve_sd(self, sd_or_bc=None, shard: int = 0) -> P1ShardData:
        """Accept a P1ShardData, a BoundaryCondition, or None (default
        all-Dirichlet BC)."""
        if isinstance(sd_or_bc, P1ShardData):
            return sd_or_bc
        bc = sd_or_bc or BoundaryCondition.all_dirichlet()
        return self.shard_data(shard, bc)

    def shard_data(self, shard: int, bc: BoundaryCondition) -> P1ShardData:
        key = (shard, bc)
        if key not in self._sd_cache:
            m = self.maps
            valid = m.slot_gid[shard] < m.num_ifc
            idx = lambda a, dt: self._tensor(np.asarray(a)[shard][valid], dt)
            self._sd_cache[key] = P1ShardData(
                slot_flat=idx(m.slot_flat, torch.int64),
                slot_gid=idx(m.slot_gid, torch.int64),
                slot_rep=idx(self.slot_rep_mask, torch.bool),
                slot_inv_mult=idx(self.slot_inv_mult, self.dtype),
                slot_doftype=idx(self.slot_doftype_np(bc), torch.int32),
                cell_vertices=self._tensor(self.cell_vertices(shard)),
                bc=bc,
            )
        return self._sd_cache[key]

    # -- exchanges (the halo-communication analog) ---------------------------

    def _exchange_add_(self, u: torch.Tensor, sd: P1ShardData) -> torch.Tensor:
        """exchange_add in place on ``u``."""
        f = u.view(-1)
        g = torch.zeros(self.maps.num_ifc, dtype=u.dtype, device=u.device)
        g.index_add_(0, sd.slot_gid, f[sd.slot_flat])
        f[sd.slot_flat] = g[sd.slot_gid]
        return u

    def _exchange_rep_(self, u: torch.Tensor, sd: P1ShardData) -> torch.Tensor:
        """exchange_rep in place on ``u``."""
        f = u.view(-1)
        rep_flat, rep_gid = sd.rep_slots
        g = torch.zeros(self.maps.num_ifc, dtype=u.dtype, device=u.device)
        g[rep_gid] = f[rep_flat]
        f[sd.slot_flat] = g[sd.slot_gid]
        return u

    def exchange_add(self, u, sd=None) -> torch.Tensor:
        """Replicas <- sum over replicas (additive halo exchange)."""
        return self._exchange_add_(u.clone(), self.resolve_sd(sd))

    def exchange_rep(self, u, sd=None) -> torch.Tensor:
        """Replicas <- representative's value (consistency sync)."""
        return self._exchange_rep_(u.clone(), self.resolve_sd(sd))

    # -- reductions ----------------------------------------------------------

    def dot(self, u, v, flag: DoFType = DoFType.ALL, sd=None) -> torch.Tensor:
        """Global dot product counting every DoF once
        (reference: VertexDoFFunction::dotGlobal). A 0-dim tensor: no host
        sync. One shard means no padding cells, so every cell counts."""
        sd = self.resolve_sd(sd)
        acc = torch.zeros((), dtype=self.dtype, device=self.device)
        if flag & DoFType.INNER:
            acc = acc + (u * v * self._interior_w).sum()
        _, _, rep = sd._flag_slots(flag)
        return acc + (u.reshape(-1)[rep] * v.reshape(-1)[rep]).sum()

    def dof_sum(self, u, flag: DoFType = DoFType.ALL, sd=None):
        return self.dot(u, torch.ones_like(u), flag, sd)

    def unique_weight(self, sd=None) -> torch.Tensor:
        """(C, N, lanes) weights so that sum(w * u) counts every global DoF
        once (interior: 1; interface replicas: 1/multiplicity; padding: 0).
        Used by histogram-style reductions (e.g. radial profiles)."""
        sd = self.resolve_sd(sd)
        w = self._interior_w.expand(self.block_shape).clone()
        w.view(-1)[sd.slot_flat] = sd.slot_inv_mult
        return w

    def dof_max(self, u, flag: DoFType = DoFType.ALL, sd=None):
        sd = self.resolve_sd(sd)
        acc = torch.full((), -torch.inf, dtype=u.dtype, device=u.device)
        if flag & DoFType.INNER:
            acc = torch.where(self._interior_w > 0, u, -torch.inf).max()
        _, _, rep = sd._flag_slots(flag)
        if rep.numel():
            acc = torch.maximum(acc, u.reshape(-1)[rep].max())
        return acc

    # -- row-restricted updates ---------------------------------------------

    def _restore_rows_(self, new, old, flag: DoFType, sd: P1ShardData):
        """restore_rows in place on ``new`` for a flag containing INNER;
        ``old=None`` stands for zeros. Saves the block-sized copy on the
        solver's hot path, where ``new`` is always a fresh tensor."""
        assert flag & DoFType.INNER
        _, unsel, _ = sd._flag_slots(flag)
        f = new.view(-1)
        if old is None:
            f.index_fill_(0, unsel, 0.0)
        else:
            f[unsel] = old.reshape(-1)[unsel]
        return new

    def restore_rows(self, new, old, flag: DoFType, sd=None) -> torch.Tensor:
        """Keep ``new`` on rows whose DoFType is in ``flag``; restore ``old``
        elsewhere. Interior rows are INNER; interface rows use slot maps."""
        sd = self.resolve_sd(sd)
        if flag == DoFType.ALL:
            return new
        if flag & DoFType.INNER:
            return self._restore_rows_(new.clone(), old, flag, sd)
        sel, _, _ = sd._flag_slots(flag)
        out = old.clone()
        out.view(-1)[sel] = new.reshape(-1)[sel]
        return out

    # -- interpolation -------------------------------------------------------

    @functools.cached_property
    def _ref_coords(self) -> torch.Tensor:
        """(N, lanes, dim) reference coordinates (barycentric index / n);
        zeros on 3D padding lanes (finite garbage, masked downstream)."""
        axes = [np.arange(self.N)] * self.dim
        ref = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1) / self.n
        if self.dim == 3:
            ref = flat.flatten_field(ref, self.pitch, ncomp=1)
        return self._tensor(ref)

    def coords_from(self, cell_vertices: torch.Tensor) -> torch.Tensor:
        """(C, N, lanes, 3) physical coordinates of every micro-vertex
        (cell_vertices (C, dim + 1, 3); a 2D mesh keeps z = 0)."""
        v0 = cell_vertices[:, 0]
        J = cell_vertices[:, 1:] - cell_vertices[:, :1]  # (C, dim, 3)
        return v0.reshape(-1, 1, 1, 3) + torch.einsum(
            "xld,cde->cxle", self._ref_coords, J)

    def coords(self, shard: int = 0) -> torch.Tensor:
        return self.coords_from(self._tensor(self.cell_vertices(shard)))

    def interpolate(self, expr, old, flag: DoFType, sd=None) -> torch.Tensor:
        """Evaluate ``expr`` (constant or callable of coords (..., 3)) on rows
        in ``flag``; replicas are forced consistent via the representative
        (each cell evaluates at its own affine image of a shared point, so
        replicas may differ in the last ulp)."""
        sd = self.resolve_sd(sd)
        if callable(expr):
            vals = torch.as_tensor(expr(self.coords_from(sd.cell_vertices)),
                                   dtype=self.dtype, device=self.device)
            vals = self._exchange_rep_(vals.contiguous(), sd)
        else:
            vals = torch.full(self.block_shape, expr, dtype=self.dtype,
                              device=self.device)
        vals = vals * self.vertex_mask_t
        if flag == DoFType.ALL:
            return vals
        if flag & DoFType.INNER:
            return self._restore_rows_(vals, old, flag, sd)
        return self.restore_rows(vals, old, flag, sd)

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.block_shape, dtype=self.dtype,
                           device=self.device)

    def function(self, bc: BoundaryCondition | None = None) -> P1Function:
        return P1Function(self.zeros(), self,
                          bc or BoundaryCondition.all_dirichlet())

    # -- global enumeration (reference: VertexDoFFunction::enumerate) --------

    @functools.cached_property
    def _interior_pack(self) -> np.ndarray:
        """(N, lanes) int64: lexicographic index among cell-interior
        positions, -1 elsewhere."""
        imask = self.interior_mask
        pack = np.full(imask.shape, -1, dtype=np.int64)
        pack[imask] = np.arange(int(imask.sum()))
        return pack

    def global_ids(self, shard: int = 0) -> np.ndarray:
        """(C, N, lanes) int64 global DoF id per position of the flat block
        layout; -1 outside the macro-simplex, on padding lanes and on
        padding cells. Host-side (numpy): sparse assembly and tests."""
        m = self.maps
        out = np.full(self.block_shape, -1, dtype=np.int64)
        flat_out = out.reshape(-1)
        sf, sg = m.slot_flat[shard], m.slot_gid[shard]
        ok = (sf < flat_out.shape[0]) & (sg < m.num_ifc)
        flat_out[sf[ok]] = sg[ok]
        lo = shard * self.C_loc
        sel = self._interior_pack >= 0
        for c in range(self.C_loc):
            if not self.storage.cell_valid[lo + c]:
                out[c] = -1
                continue
            gci = self.storage.cell_global_index[lo + c]
            out[c][sel] = (m.num_ifc + gci * m.num_interior_per_cell
                           + self._interior_pack[sel])
        return out

    def global_ids_grid(self, shard: int = 0) -> np.ndarray:
        """(C, N, N, N) / (C, N, N) grid view of global_ids, indexed by
        (x, y, z) (host-side)."""
        g = self.global_ids(shard)
        if self.dim == 2:
            return g
        return flat.unflatten_field(g, self.N, self.pitch)
