"""Sharded macro-cell storage + per-level DoF/interface maps.

TPU-native re-design of the reference's distributed mesh runtime
(reference: src/hyteg/primitivestorage/PrimitiveStorage.cpp:62-140 and the
PackInfo halo-exchange machinery, src/hyteg/communication/PackInfo.hpp:43-183).

Design: all top-dimensional macro-elements ("cells"; triangles in 2D) are
batched into same-shaped arrays and sharded over the device mesh. Per-level
micro-DoF data lives in dense masked blocks ``(C, N, N, N)`` (``(C, N, N)``
in 2D). DoFs on macro-interfaces are *replicated* in every adjacent cell
block; the invariant "all replicas equal" is maintained by an interface
exchange built from precomputed index maps:

    slot_flat[s]  : flat index of interface slot s into the local cell blocks
    slot_gid[s]   : global interface-DoF id of that slot

so the additive halo exchange of the reference (pack -> MPI -> unpack-add)
becomes ``segment_sum`` over slots + ``psum`` over the device mesh + gather —
pure XLA collectives riding ICI.

Global DoF numbering follows the owner-primitive scheme of the reference
(macro-vertex / macro-edge / macro-face / cell-interior blocks), using
*sorted global vertex ids* as the canonical orientation of every shared
sub-simplex — replacing the reference's orientation/permutation tables.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..indexing import levelinfo, micro
from ..mesh.meshinfo import MeshInfo
from .topology import MacroTopology, build_topology


# ---------------------------------------------------------------------------
# per-level maps
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class P1LevelMaps:
    """Static per-level index data for vertex-DoF (P1) storage.

    Shapes: D = number of shards, S = padded interface-slot count per shard,
    G = number of global interface DoFs.
    """

    level: int
    dim: int
    N: int                       # micro-vertices per macro-edge
    pitch: int                   # lane pitch of the flat 3D layout (== N in 2D)
    num_ifc: int                 # G
    slot_flat: np.ndarray        # (D, S) int32, flat index into local (C_loc * N^dim); == OOB for pad
    slot_gid: np.ndarray         # (D, S) int32, in [0, G); == G for padded slots
    slot_meshflag: np.ndarray    # (D, S) int8 mesh boundary flag of the slot's owner primitive
    ifc_meshflag: np.ndarray     # (G,) int8
    ifc_rep_dev: np.ndarray      # (G,) int32  shard holding the representative slot
    ifc_rep_slot: np.ndarray     # (G,) int32  slot index of representative within that shard
    ifc_mult: np.ndarray         # (G,) int32  replica count
    num_interior_per_cell: int
    num_global_dofs: int         # G + num_valid_cells * interior

    @property
    def slots_per_shard(self) -> int:
        return self.slot_flat.shape[1]


def _tri_pack(u: np.ndarray, v: np.ndarray, m: int) -> np.ndarray:
    """Row-major index of (u, v) in {u, v >= 0, u + v <= m}."""
    return u * (2 * m + 3 - u) // 2 + v


def _boundary_positions(level: int, dim: int) -> np.ndarray:
    """(P, dim) int coords of micro-vertices on the macro-boundary."""
    mask = micro.interface_mask(level, dim)
    return np.argwhere(mask)


@functools.lru_cache(maxsize=None)
def _position_weights(level: int, dim: int) -> tuple[np.ndarray, np.ndarray]:
    """Boundary positions and their integer barycentric weights.

    Returns (pos (P, dim), w (P, dim+1)) with w[:, 0] = n - sum(coords),
    w[:, 1 + i] = coords[:, i]; weights sum to n.
    """
    n = 1 << level
    pos = _boundary_positions(level, dim)
    w = np.concatenate([(n - pos.sum(axis=1))[:, None], pos], axis=1)
    return pos, w


_LOCAL_EDGES_3D = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
_LOCAL_FACES_3D = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]
_LOCAL_EDGES_2D = [(0, 1), (0, 2), (1, 2)]


def _encode_rows(arr: np.ndarray, base: int) -> np.ndarray:
    out = np.zeros(arr.shape[0], dtype=np.int64)
    for c in range(arr.shape[1]):
        out = out * base + arr[:, c]
    return out


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------


class CellStorage:
    """Batched, shardable macro-element storage.

    Cells are permuted so that shard d owns the contiguous block
    ``[d * C_loc, (d + 1) * C_loc)``; invalid padding cells (to equalize
    shard sizes) are marked in ``cell_valid``.
    """

    def __init__(self, mesh: MeshInfo, num_shards: int = 1,
                 partitioner: str = "round_robin",
                 assignment: np.ndarray | None = None):
        self.topo: MacroTopology = build_topology(mesh)
        self.mesh = mesh
        self.dim = mesh.dim
        self.num_shards = num_shards

        C_real = self.topo.num_cells
        if assignment is None:
            assignment = self._partition(C_real, num_shards, partitioner)
        else:
            assignment = np.asarray(assignment, dtype=np.int64)
            assert assignment.shape == (C_real,)
            assert assignment.min() >= 0 and assignment.max() < num_shards
        order = np.argsort(assignment, kind="stable")
        counts = np.bincount(assignment, minlength=num_shards)
        C_loc = int(counts.max())
        self.cells_per_shard = C_loc
        self.num_cells = C_loc * num_shards

        # Per-cell arrays in shard-major order with padding.
        elements = self.topo.elements  # (C_real, dim+1)
        self.cell_gids = np.zeros((self.num_cells, self.dim + 1), dtype=np.int64)
        self.cell_valid = np.zeros(self.num_cells, dtype=bool)
        self.cell_global_index = np.full(self.num_cells, -1, dtype=np.int64)
        write_ptr = np.array([d * C_loc for d in range(num_shards)])
        for cell in order:
            d = assignment[cell]
            slot = write_ptr[d]
            write_ptr[d] += 1
            self.cell_gids[slot] = elements[cell]
            self.cell_valid[slot] = True
            self.cell_global_index[slot] = cell
        # Padding cells replicate gids of the shard's first valid cell so that
        # geometry stays non-degenerate; their contributions are masked out.
        for d in range(num_shards):
            lo = d * C_loc
            if counts[d] == 0:
                raise ValueError(f"shard {d} received no cells — mesh too small")
            for s in range(lo + counts[d], lo + C_loc):
                self.cell_gids[s] = self.cell_gids[lo]

        self.cell_vertices = self.topo.points[self.cell_gids]  # (C, dim+1, 3)
        self._edge_index = None
        self._face_index = None
        self._level_maps: dict[int, P1LevelMaps] = {}

    # -- partitioning (reference: src/hyteg/primitivestorage/loadbalancing/) --

    @staticmethod
    def _partition(num_cells: int, num_shards: int, method: str) -> np.ndarray:
        if method == "round_robin":
            return np.arange(num_cells) % num_shards
        if method == "contiguous":
            return np.arange(num_cells) * num_shards // num_cells
        if method == "all_on_root":
            return np.zeros(num_cells, dtype=np.int64)
        raise ValueError(f"unknown partitioner {method}")

    # -- sub-simplex lookup tables ------------------------------------------

    def _ensure_subsimplex_tables(self):
        if self._edge_index is not None:
            return
        V = self.topo.num_vertices
        ekeys = _encode_rows(self.topo.edges, V)
        self._edge_index = (np.sort(ekeys), np.argsort(ekeys))
        if self.dim == 3:
            fkeys = _encode_rows(self.topo.faces, V)
            self._face_index = (np.sort(fkeys), np.argsort(fkeys))

    def _lookup_edges(self, pairs_sorted: np.ndarray) -> np.ndarray:
        """(..., 2) sorted vertex pairs -> edge row indices."""
        self._ensure_subsimplex_tables()
        V = self.topo.num_vertices
        keys = _encode_rows(pairs_sorted.reshape(-1, 2), V)
        skeys, perm = self._edge_index
        idx = np.searchsorted(skeys, keys)
        assert np.all(skeys[idx] == keys), "edge lookup failed"
        return perm[idx].reshape(pairs_sorted.shape[:-1])

    def _lookup_faces(self, triples_sorted: np.ndarray) -> np.ndarray:
        self._ensure_subsimplex_tables()
        V = self.topo.num_vertices
        keys = _encode_rows(triples_sorted.reshape(-1, 3), V)
        skeys, perm = self._face_index
        idx = np.searchsorted(skeys, keys)
        assert np.all(skeys[idx] == keys), "face lookup failed"
        return perm[idx].reshape(triples_sorted.shape[:-1])

    # -- P1 level maps -------------------------------------------------------

    def p1_level_maps(self, level: int, pitch: int | None = None) -> P1LevelMaps:
        if pitch is None:
            pitch = (1 << level) + 1
        key = (level, pitch)
        if key not in self._level_maps:
            self._level_maps[key] = self._build_p1_maps(level, pitch)
        return self._level_maps[key]

    def _interface_layout(self, level: int):
        """Global interface-DoF id layout: [vertices | edge blocks | face blocks]."""
        n = 1 << level
        V, E = self.topo.num_vertices, self.topo.num_edges
        edge_int = n - 1
        off_edge = V
        if self.dim == 3:
            F = self.topo.num_faces
            face_int = (n - 1) * (n - 2) // 2
            off_face = off_edge + E * edge_int
            G = off_face + F * face_int
            return off_edge, off_face, G, edge_int, face_int
        G = off_edge + E * edge_int
        return off_edge, None, G, edge_int, 0

    def _build_p1_maps(self, level: int, pitch: int) -> P1LevelMaps:
        n = 1 << level
        N = n + 1
        dim = self.dim
        pos, w = _position_weights(level, dim)  # (P, dim), (P, dim+1)
        P = pos.shape[0]
        off_edge, off_face, G, edge_int, face_int = self._interface_layout(level)

        # flat index of each boundary position within one cell block
        # (3D flat layout: (N, N*pitch), lane = y*pitch + z; see indexing/flat.py)
        if dim == 3:
            pos_flat = pos[:, 0] * (N * pitch) + pos[:, 1] * pitch + pos[:, 2]
        else:
            pos_flat = pos[:, 0] * N + pos[:, 1]

        # classification of boundary positions by support (static per level)
        nz = w > 0  # (P, dim+1)
        support_size = nz.sum(axis=1)

        C = self.num_cells
        gid = np.full((C, P), -1, dtype=np.int64)
        meshflag = np.zeros((C, P), dtype=np.int8)

        gids = self.cell_gids  # (C, dim+1)

        # --- support size 1: macro-vertices ---------------------------------
        sel = support_size == 1
        if sel.any():
            local_v = np.argmax(nz[sel], axis=1)  # (Pv,)
            gid[:, sel] = gids[:, local_v]
            meshflag[:, sel] = self.topo.vertex_flag[gids[:, local_v]]

        # --- support size 2: macro-edge interiors ---------------------------
        local_edges = _LOCAL_EDGES_3D if dim == 3 else _LOCAL_EDGES_2D
        for (i, j) in local_edges:
            sel = nz[:, i] & nz[:, j] & (support_size == 2)
            if not sel.any():
                continue
            wj = w[sel, j]  # (Pe,) weight of local endpoint j, in 1..n-1
            gi, gj = gids[:, i], gids[:, j]  # (C,)
            lo = np.minimum(gi, gj)
            hi = np.maximum(gi, gj)
            eidx = self._lookup_edges(np.stack([lo, hi], axis=-1))  # (C,)
            # canonical coordinate along the edge = weight of higher-id vertex
            w_hi = np.where((gj > gi)[:, None], wj[None, :], (n - wj)[None, :])
            gid[:, sel] = off_edge + (eidx * edge_int)[:, None] + (w_hi - 1)
            meshflag[:, sel] = self.topo.edge_flag[eidx][:, None]

        # --- support size 3 -------------------------------------------------
        if dim == 3:
            for lf, (i, j, k) in enumerate(_LOCAL_FACES_3D):
                sel = nz[:, i] & nz[:, j] & nz[:, k] & (support_size == 3)
                if not sel.any():
                    continue
                wf = w[np.ix_(sel, [i, j, k])]  # (Pf, 3)
                gf = gids[:, [i, j, k]]  # (C, 3)
                order = np.argsort(gf, axis=1)  # canonical a<b<c
                gf_sorted = np.take_along_axis(gf, order, axis=1)
                fidx = self._lookup_faces(gf_sorted)  # (C,)
                # canonical (w_b, w_c): weights permuted per cell
                w_perm = wf[:, order]  # (Pf, C, 3) via fancy broadcast
                # wf[:, order] -> shape (Pf, C, 3)
                wb = w_perm[:, :, 1].T  # (C, Pf)
                wc = w_perm[:, :, 2].T
                pack = _tri_pack(wb - 1, wc - 1, n - 3)
                gid[:, sel] = off_face + (fidx * face_int)[:, None] + pack
                meshflag[:, sel] = self.topo.face_flag[fidx][:, None]

        assert (gid[self.cell_valid] >= 0).all()
        assert (gid[self.cell_valid] < G).all()

        # --- assemble shard-major slot arrays -------------------------------
        D = self.num_shards
        C_loc = self.cells_per_shard
        block = N * N * pitch if dim == 3 else N * N
        S = C_loc * P  # includes slots of padding cells (masked below)

        slot_flat = np.zeros((D, S), dtype=np.int32)
        slot_gid = np.zeros((D, S), dtype=np.int32)
        slot_flag = np.zeros((D, S), dtype=np.int8)
        for d in range(D):
            lo = d * C_loc
            cells = np.arange(lo, lo + C_loc)
            valid = self.cell_valid[cells]  # (C_loc,)
            flat = (np.arange(C_loc)[:, None] * block + pos_flat[None, :]).astype(
                np.int32
            )
            g = gid[cells].astype(np.int32)
            fl = meshflag[cells]
            # padding cells: OOB flat index (dropped in scatter), dummy gid G
            flat[~valid] = C_loc * block
            g[~valid] = G
            slot_flat[d] = flat.reshape(-1)
            slot_gid[d] = g.reshape(-1)
            slot_flag[d] = fl.reshape(-1)

        # representative slot + multiplicity per interface DoF
        ifc_mult = np.zeros(G + 1, dtype=np.int64)
        np.add.at(ifc_mult, slot_gid.reshape(-1), 1)
        ifc_rep_dev = np.zeros(G, dtype=np.int32)
        ifc_rep_slot = np.zeros(G, dtype=np.int32)
        ifc_flag = np.zeros(G, dtype=np.int8)
        seen = np.zeros(G + 1, dtype=bool)
        for d in range(D):
            gids_d = slot_gid[d]
            first = np.full(G + 1, -1, dtype=np.int64)
            rev = np.arange(S - 1, -1, -1)
            first[gids_d[rev]] = rev  # first occurrence wins (reversed write)
            newly = (first >= 0) & ~seen
            newly[G] = False
            ifc_rep_dev[newly[:G]] = d
            ifc_rep_slot[newly[:G]] = first[:G][newly[:G]]
            ifc_flag[newly[:G]] = slot_flag[d][first[:G][newly[:G]]]
            seen |= first >= 0
        assert seen[:G].all(), "interface DoF without any slot"

        # strict interior of the macro-simplex: coords >= 1, sum <= n - 1
        interior = int(
            levelinfo.tet_region_size(max(N - 4, 0))
            if dim == 3
            else levelinfo.tri_region_size(max(N - 3, 0))
        )
        num_valid = int(self.cell_valid.sum())
        return P1LevelMaps(
            level=level,
            dim=dim,
            N=N,
            pitch=pitch,
            num_ifc=G,
            slot_flat=slot_flat,
            slot_gid=slot_gid,
            slot_meshflag=slot_flag,
            ifc_meshflag=ifc_flag,
            ifc_rep_dev=ifc_rep_dev,
            ifc_rep_slot=ifc_rep_slot,
            ifc_mult=ifc_mult[:G].astype(np.int32),
            num_interior_per_cell=interior,
            num_global_dofs=G + num_valid * interior,
        )

    # -- geometry ------------------------------------------------------------

    def jacobians(self) -> np.ndarray:
        """(C, dim, dim) affine Jacobians d(physical)/d(reference)."""
        v = self.cell_vertices  # (C, dim+1, 3)
        J = (v[:, 1:, :] - v[:, :1, :]).transpose(0, 2, 1)  # (C, 3, dim)
        if self.dim == 2:
            # project out the embedding: use first two coordinates for planar
            # meshes; general manifolds handled by geometry maps later
            return J[:, :2, :]
        return J

    def global_num_cells(self) -> int:
        return int(self.cell_valid.sum())
