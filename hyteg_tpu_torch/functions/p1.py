"""P1 (vertex-DoF) function space on macro-cell blocks (torch counterpart
of hyteg_tpu/functions/p1.py, 2D and 3D, one shard or several).

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

On a sharded storage each shard holds its own cells' blocks, and a shard
data that carries a group (``P1Space.group_shard_data``) makes every
exchange and reduction global: the additive exchange sums each shard's
replicas locally, then adds its neighbours' partial sums in rank order (so
every shard's replica of a DoF gets the same bits), one paired send per
edge-colouring round (``_nbr_tables``; reference:
src/hyteg/communication/PackInfo.hpp:43-183), or, without those tables,
all-reduces the whole interface vector; dots and maxima all-reduce their
local parts. Padding cells (``cell_valid`` false) count nowhere.
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
    #: indices of the shard's padding cells (they hold no DoF; solver
    #: updates keep them at their old value, reductions skip them);
    #: None: no padding
    pad_cells: torch.Tensor | None = None
    #: the shard group (parallel/comm.py) that makes exchanges and
    #: reductions global; None: this shard alone
    group: object = None
    nbr: "NbrTables | None" = None
    ovl: "OvlTables | None" = None
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
class NbrTables:
    """One shard's neighbour-exchange tables: each valid slot's local
    interface id (``slot_lid``, into local sums of length L + 1; L is a
    dump bucket that stays 0) and, per edge-colouring round, None or
    (peer shard, local ids to send, local ids to add the received values
    to), both in the pair's shared order."""

    slot_lid: torch.Tensor   # (S,) int64
    rep_lid: torch.Tensor    # (R,) int64 local id of each representative slot
    L: int
    rounds: list


@dataclasses.dataclass
class OvlTables:
    """Interface-first cell order for the overlapped apply: ``cells`` puts
    every cell incident to a cross-shard interface DoF first (K of them);
    ``slot_flat`` / ``slot_lid`` are the cross-shard slots as flat indices
    into the K-cell sub-block and their local ids."""

    cells: torch.Tensor      # (C,) int64 permutation
    K: int
    slot_flat: torch.Tensor  # (X,) int64
    slot_lid: torch.Tensor   # (X,) int64

    @functools.cached_property
    def ifc(self) -> torch.Tensor:
        return self.cells[:self.K].contiguous()

    @functools.cached_property
    def interior(self) -> torch.Tensor:
        return self.cells[self.K:].contiguous()


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
    and reductions. 2D or 3D; on a sharded storage a block holds one
    shard's cells. ``device`` has no default: a caller names the card or
    the CPU. A 2D space ignores ``pitch`` (its blocks have none), as the
    JAX package does."""

    def __init__(self, storage: CellStorage, level: int, *, device,
                 dtype=torch.float32, pitch: int | None = None):
        if storage.num_shards > storage.topo.num_cells:
            raise ValueError(f"{storage.num_shards} shards for a mesh of "
                             f"{storage.topo.num_cells} cells")
        self.storage = storage
        self.level = level
        self.device = torch.device(device)
        self.dtype = dtype
        # coordinates (cell vertices, reference and physical coordinates)
        # are at least f32: a bf16 space evaluates a field at f32 points
        # and rounds each value once
        self.coord_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
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
        return flat.to_grid(u, self.N, self.pitch)

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

    def cell_valid(self, shard: int = 0) -> np.ndarray:
        lo = shard * self.C_loc
        return self.storage.cell_valid[lo : lo + self.C_loc]

    def _pad_cells(self, valid: np.ndarray):
        if valid.all():
            return None
        return self._tensor(np.flatnonzero(~valid), torch.int64)

    def shard_data(self, shard: int, bc: BoundaryCondition) -> P1ShardData:
        """Slot maps of one shard, with no group: on a sharded storage its
        exchanges and reductions see this shard's replicas alone."""
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
                cell_vertices=self._tensor(self.cell_vertices(shard),
                                           self.coord_dtype),
                bc=bc,
                pad_cells=self._pad_cells(self.cell_valid(shard)),
            )
        return self._sd_cache[key]

    def group_shard_data(self, group, bc: BoundaryCondition,
                         neighbor: bool = True) -> P1ShardData:
        """Shard data of ``group.rank`` whose exchanges and reductions run
        over ``group`` (parallel/comm.py). ``neighbor`` attaches the
        neighbour-exchange and overlap tables; without them the exchange
        all-reduces the whole interface vector (the JAX package's psum
        fallback)."""
        if group.size != self.storage.num_shards:
            raise ValueError(f"a group of {group.size} shards for a storage "
                             f"of {self.storage.num_shards}")
        key = ("group", id(group), group.rank, bc, neighbor)
        if key not in self._sd_cache:
            base = self.shard_data(group.rank, bc)
            nbr = ovl = None
            if neighbor and self.storage.num_shards > 1:
                nbr, ovl = self._rank_tables(group.rank)
            self._sd_cache[key] = dataclasses.replace(
                base, group=group, nbr=nbr, ovl=ovl, _by_flag={})
        return self._sd_cache[key]

    def global_shard_data(self, bc: BoundaryCondition) -> P1ShardData:
        """One-block view of the WHOLE sharded storage: slot maps re-based
        onto the all-gathered (C_total, N, lanes) block, no group. The
        agglomeration analog (reference: AgglomerationWrapper.hpp:75): the
        coarse level is gathered and solved redundantly on every shard."""
        key = ("global", bc)
        if key not in self._sd_cache:
            m = self.maps
            D = m.slot_flat.shape[0]
            valid = (m.slot_gid < m.num_ifc).reshape(-1)
            flat_g = (m.slot_flat.astype(np.int64) + np.arange(
                D, dtype=np.int64)[:, None] * self.block_size).reshape(-1)
            sel = lambda a, dt: self._tensor(np.asarray(a).reshape(-1)[valid],
                                             dt)
            self._sd_cache[key] = P1ShardData(
                slot_flat=sel(flat_g, torch.int64),
                slot_gid=sel(m.slot_gid, torch.int64),
                slot_rep=sel(self.slot_rep_mask, torch.bool),
                slot_inv_mult=sel(self.slot_inv_mult, self.dtype),
                slot_doftype=sel(self.slot_doftype_np(bc), torch.int32),
                cell_vertices=self._tensor(self.storage.cell_vertices,
                                           self.coord_dtype),
                bc=bc,
                pad_cells=self._pad_cells(self.storage.cell_valid),
            )
        return self._sd_cache[key]

    # -- neighbour-exchange tables (host precompute, per level) --------------

    @functools.cached_property
    def _local_gids(self):
        """Per shard, the sorted interface gids it holds and each valid
        slot's index among them; and every gid's sharing shards."""
        from collections import defaultdict

        m = self.maps
        D = m.slot_gid.shape[0]
        loc_gids, slot_lid = [], []
        sharers = defaultdict(list)
        for d in range(D):
            gids = np.asarray(m.slot_gid[d])
            valid = gids < m.num_ifc
            uniq, inv = np.unique(gids[valid], return_inverse=True)
            loc_gids.append(uniq)
            lid = np.full(gids.shape, -1, dtype=np.int64)
            lid[valid] = inv
            slot_lid.append(lid)
            for g in uniq:
                sharers[int(g)].append(d)
        return loc_gids, slot_lid, dict(sharers)

    @functools.cached_property
    def _nbr_tables(self):
        """Neighbour-wise exchange tables, as the JAX package builds them:
        (slot_lid (D, S), L_max, pack (D, R, M), recv (D, R, M), perms),
        perms[r] the pair list of round r (one partial matching of the
        neighbour graph per round, greedy edge colouring). Pack and recv
        entries are local ids; L_max is the dump bucket for padding."""
        from collections import defaultdict

        loc_gids, lids, sharers = self._local_gids
        D = len(loc_gids)
        L_max = max((len(u) for u in loc_gids), default=0)
        slot_lid = np.stack(lids)
        slot_lid[slot_lid < 0] = L_max
        pair_g = defaultdict(list)
        for g, devs in sharers.items():
            for i in range(len(devs)):
                for j in range(i + 1, len(devs)):
                    pair_g[(devs[i], devs[j])].append(g)
        colors, used = {}, defaultdict(set)
        for e in sorted(pair_g):
            c = 0
            while c in used[e[0]] or c in used[e[1]]:
                c += 1
            colors[e] = c
            used[e[0]].add(c)
            used[e[1]].add(c)
        R = (max(colors.values()) + 1) if colors else 0
        M = max((len(v) for v in pair_g.values()), default=1)
        pack = np.full((D, max(R, 1), M), L_max, dtype=np.int64)
        recv = np.full((D, max(R, 1), M), L_max, dtype=np.int64)
        perms: list[list] = [[] for _ in range(max(R, 1))]
        g2l = [{int(g): i for i, g in enumerate(loc_gids[d])}
               for d in range(D)]
        for (d, e), gs in pair_g.items():
            c = colors[(d, e)]
            for k, g in enumerate(sorted(gs)):
                pack[d, c, k] = g2l[d][g]
                pack[e, c, k] = g2l[e][g]
                recv[d, c, k] = g2l[d][g]
                recv[e, c, k] = g2l[e][g]
            perms[c] += [(d, e), (e, d)]
        return (slot_lid.astype(np.int32), int(L_max),
                pack.astype(np.int32), recv.astype(np.int32),
                tuple(tuple(sorted(p)) for p in perms))

    @functools.cached_property
    def _ovl_tables(self):
        """Interface/interior cell split for the overlapped apply, as the
        JAX package builds it: (ovl_cells (D, C_loc), ovl_slot_flat (D, S),
        ovl_slot_lid (D, S), K). Per shard a permutation of its cells that
        puts every cell incident to a cross-shard interface DoF first;
        every local contribution to a cross-shard DoF then comes from the
        first K cells. The cross-shard gids are those of the neighbour
        tables' sharers (reference: BufferedCommunication.hpp:92-100)."""
        m = self.maps
        D, S = m.slot_gid.shape
        slot_lid, L_max, _, _, _ = self._nbr_tables
        _, _, sharers = self._local_gids
        C_loc = self.C_loc
        cell_sz = self.block_size // C_loc
        cross = np.fromiter((g for g, devs in sharers.items()
                             if len(devs) >= 2), dtype=np.int64)
        flat_ = np.asarray(m.slot_flat)
        gid = np.asarray(m.slot_gid)
        sel_all = np.isin(gid, cross) & (gid < m.num_ifc)
        ovl_cells = np.zeros((D, C_loc), dtype=np.int32)
        inv = np.zeros((D, C_loc), dtype=np.int64)
        kd = np.zeros(D, dtype=np.int64)
        for d in range(D):
            cs = np.unique(flat_[d][sel_all[d]] // cell_sz)
            order = np.concatenate([cs, np.setdiff1d(np.arange(C_loc), cs)])
            ovl_cells[d] = order
            inv[d, order] = np.arange(C_loc)
            kd[d] = len(cs)
        K = int(max(kd.max(), 1))
        ovl_flat = np.full((D, S), K * cell_sz, dtype=np.int64)
        ovl_lid = np.full((D, S), L_max, dtype=np.int64)
        for d in range(D):
            sel = sel_all[d]
            c, o = flat_[d][sel] // cell_sz, flat_[d][sel] % cell_sz
            ovl_flat[d, sel] = inv[d, c] * cell_sz + o
            ovl_lid[d, sel] = slot_lid[d][sel]
        return (ovl_cells, ovl_flat.astype(np.int32),
                ovl_lid.astype(np.int32), K)

    def _rank_tables(self, d: int):
        """One shard's NbrTables and OvlTables as device tensors, with the
        padding of the stacked tables dropped: each round sends only its
        pair's entries, and only valid cross-shard slots feed the start of
        the overlapped exchange."""
        m = self.maps
        slot_lid, L, pack, recv, perms = self._nbr_tables
        valid = m.slot_gid[d] < m.num_ifc
        i64 = lambda a: self._tensor(np.asarray(a, dtype=np.int64),
                                     torch.int64)
        rounds = []
        for r, perm in enumerate(perms):
            peer = [b for a, b in perm if a == d]
            if not peer:
                rounds.append(None)
                continue
            n = int((pack[d, r] < L).sum())
            rounds.append((peer[0], i64(pack[d, r, :n]), i64(recv[d, r, :n])))
        rep = self.slot_rep_mask[d] & valid
        nbr = NbrTables(slot_lid=i64(slot_lid[d][valid]),
                        rep_lid=i64(slot_lid[d][rep]), L=L, rounds=rounds)
        cells, oflat, olid, _ = self._ovl_tables
        live = (olid[d] < L) & valid
        # this shard's own interface cell count: the stacked tables pad
        # every shard to the largest
        kd = (int(oflat[d][live].max()) // (self.block_size // self.C_loc)
              + 1) if live.any() else 0
        ovl = OvlTables(cells=i64(cells[d]), K=kd,
                        slot_flat=i64(oflat[d][live]),
                        slot_lid=i64(olid[d][live]))
        return nbr, ovl

    # -- exchanges (the halo-communication analog) ---------------------------

    def _nbr_sums(self, f: torch.Tensor, sd: P1ShardData, rep: bool):
        """Local sums per local interface id (L + 1, the last 0): of every
        replica, or of the representative slots only."""
        nb = sd.nbr
        lsum = torch.zeros(nb.L + 1, dtype=f.dtype, device=f.device)
        if rep:
            rep_flat, _ = sd.rep_slots
            lsum[nb.rep_lid] = f[rep_flat]
        else:
            lsum.index_add_(0, nb.slot_lid, f[sd.slot_flat])
        return lsum

    def _nbr_start(self, lsum: torch.Tensor, sd: P1ShardData):
        """Send each round's packed partial sums to its peer."""
        return sd.group.exchange_start(
            [None if r is None else (r[0], lsum[r[1]])
             for r in sd.nbr.rounds])

    def _nbr_finish_(self, f, lsum, pending, sd: P1ShardData):
        """Add the received partial sums and scatter the totals to every
        replica slot of ``f`` (in place). Every shard adds the partial sums
        of a shared DoF in rank order, its own at its rank, so all replicas
        get the same bits (0 + x is exact): they stay equal through a solve
        instead of drifting apart by round-off."""
        received = sd.group.exchange_finish(pending)
        parts = sorted(((r[0], r[2], rv) for r, rv in
                        zip(sd.nbr.rounds, received) if rv is not None),
                       key=lambda p: p[0])
        lower = [p for p in parts if p[0] < sd.group.rank]
        acc = torch.zeros_like(lsum) if lower else lsum
        for _, lids, rv in lower:
            acc.index_add_(0, lids, rv)
        if lower:
            acc += lsum
        for _, lids, rv in parts[len(lower):]:
            acc.index_add_(0, lids, rv)
        f[sd.slot_flat] = acc[sd.nbr.slot_lid]

    def _exchange_(self, u: torch.Tensor, sd: P1ShardData, rep: bool):
        f = u.view(-1)
        if sd.group is not None and sd.nbr is not None:
            lsum = self._nbr_sums(f, sd, rep)
            self._nbr_finish_(f, lsum, self._nbr_start(lsum, sd), sd)
            return u
        g = torch.zeros(self.maps.num_ifc, dtype=u.dtype, device=u.device)
        if rep:
            rep_flat, rep_gid = sd.rep_slots
            g[rep_gid] = f[rep_flat]
        else:
            g.index_add_(0, sd.slot_gid, f[sd.slot_flat])
        if sd.group is not None:  # the global-interface fallback
            g = sd.group.all_reduce(g)
        f[sd.slot_flat] = g[sd.slot_gid]
        return u

    def _exchange_add_(self, u: torch.Tensor, sd: P1ShardData) -> torch.Tensor:
        """exchange_add in place on ``u``."""
        return self._exchange_(u, sd, rep=False)

    def _exchange_rep_(self, u: torch.Tensor, sd: P1ShardData) -> torch.Tensor:
        """exchange_rep in place on ``u``."""
        return self._exchange_(u, sd, rep=True)

    def _ovl_start(self, y_ifc: torch.Tensor, sd: P1ShardData):
        """Start the additive exchange from the partial apply of the first
        K cells (``sd.ovl.ifc``): their sums over cross-shard slots are
        complete, so the sends need nothing of the interior cells."""
        ov = sd.ovl
        lsum = torch.zeros(sd.nbr.L + 1, dtype=y_ifc.dtype,
                           device=y_ifc.device)
        lsum.index_add_(0, ov.slot_lid, y_ifc.reshape(-1)[ov.slot_flat])
        return lsum, self._nbr_start(lsum, sd)

    def _ovl_finish_(self, y: torch.Tensor, started, sd: P1ShardData):
        """Finish on the whole partial apply ``y`` (in place): local sums
        of every replica plus the received cross-shard partials. A
        cross-shard DoF keeps the very sum this shard sent (the interior
        cells hold no replica of it), so its peers add the same bits."""
        sent, pending = started
        f = y.view(-1)
        lsum = self._nbr_sums(f, sd, rep=False)
        lid = sd.ovl.slot_lid
        lsum[lid] = sent[lid]
        self._nbr_finish_(f, lsum, pending, sd)
        return y

    def exchange_add(self, u, sd=None) -> torch.Tensor:
        """Replicas <- sum over replicas (additive halo exchange)."""
        return self._exchange_add_(u.clone(), self.resolve_sd(sd))

    def exchange_rep(self, u, sd=None) -> torch.Tensor:
        """Replicas <- representative's value (consistency sync)."""
        return self._exchange_rep_(u.clone(), self.resolve_sd(sd))

    # -- reductions ----------------------------------------------------------

    def _reduce(self, acc: torch.Tensor, sd: P1ShardData, op: str = "sum"):
        return acc if sd.group is None else sd.group.all_reduce(acc, op)

    def dot(self, u, v, flag: DoFType = DoFType.ALL, sd=None) -> torch.Tensor:
        """Global dot product counting every DoF once
        (reference: VertexDoFFunction::dotGlobal). A 0-dim tensor: no host
        sync. With a group, the sum over shards."""
        sd = self.resolve_sd(sd)
        acc = torch.zeros((), dtype=self.dtype, device=self.device)
        if flag & DoFType.INNER:
            uv = u * v
            if sd.pad_cells is not None:  # a product with 0 keeps a NaN
                uv.index_fill_(0, sd.pad_cells, 0.0)
            acc = acc + (uv * self._interior_w).sum()
        _, _, rep = sd._flag_slots(flag)
        acc = acc + (u.reshape(-1)[rep] * v.reshape(-1)[rep]).sum()
        return self._reduce(acc, sd)

    def dof_sum(self, u, flag: DoFType = DoFType.ALL, sd=None):
        return self.dot(u, torch.ones_like(u), flag, sd)

    def unique_weight(self, sd=None) -> torch.Tensor:
        """(C, N, lanes) weights so that sum(w * u) counts every global DoF
        once (interior: 1; interface replicas: 1/multiplicity; padding: 0).
        Used by histogram-style reductions (e.g. radial profiles)."""
        sd = self.resolve_sd(sd)
        w = self._interior_w.expand(self.block_shape).clone()
        if sd.pad_cells is not None:
            w.index_fill_(0, sd.pad_cells, 0.0)
        w.view(-1)[sd.slot_flat] = sd.slot_inv_mult
        return w

    def dof_max(self, u, flag: DoFType = DoFType.ALL, sd=None):
        sd = self.resolve_sd(sd)
        acc = torch.full((), -torch.inf, dtype=u.dtype, device=u.device)
        if flag & DoFType.INNER:
            vals = torch.where(self._interior_w > 0, u, -torch.inf)
            if sd.pad_cells is not None:
                vals.index_fill_(0, sd.pad_cells, -torch.inf)
            acc = vals.max()
        _, _, rep = sd._flag_slots(flag)
        if rep.numel():
            acc = torch.maximum(acc, u.reshape(-1)[rep].max())
        return self._reduce(acc, sd, "max")

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
        if sd.pad_cells is not None:  # padding cells hold no row
            if old is None:
                new.index_fill_(0, sd.pad_cells, 0.0)
            else:
                new[sd.pad_cells] = old[sd.pad_cells]
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
        return self._tensor(ref, self.coord_dtype)

    def coords_from(self, cell_vertices: torch.Tensor) -> torch.Tensor:
        """(C, N, lanes, 3) physical coordinates of every micro-vertex
        (cell_vertices (C, dim + 1, 3); a 2D mesh keeps z = 0)."""
        v0 = cell_vertices[:, 0]
        J = cell_vertices[:, 1:] - cell_vertices[:, :1]  # (C, dim, 3)
        return v0.reshape(-1, 1, 1, 3) + torch.einsum(
            "xld,cde->cxle", self._ref_coords, J)

    def coords(self, shard: int = 0) -> torch.Tensor:
        return self.coords_from(self._tensor(self.cell_vertices(shard),
                                             self.coord_dtype))

    def interpolate(self, expr, old, flag: DoFType, sd=None) -> torch.Tensor:
        """Evaluate ``expr`` (constant or callable of coords (..., 3)) on rows
        in ``flag``; replicas are forced consistent via the representative
        (each cell evaluates at its own affine image of a shared point, so
        replicas may differ in the last ulp). A lone shard of a sharded
        storage (no group) skips that: gids whose representative lies on
        another shard would read zero. The points are ``coord_dtype`` (f32
        on a bf16 space: each value is rounded once)."""
        sd = self.resolve_sd(sd)
        if callable(expr):
            vals = torch.as_tensor(expr(self.coords_from(sd.cell_vertices)),
                                   dtype=self.dtype, device=self.device)
            if sd.group is not None or self.storage.num_shards == 1:
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
