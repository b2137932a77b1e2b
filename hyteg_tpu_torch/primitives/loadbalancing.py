"""Load balancers and cell migration over the sharded macro-cell storage
(torch counterpart of hyteg_tpu/primitives/loadbalancing.py; host numpy,
plus the one device gather that permutes per-cell blocks).

Reference: the balancers of
src/hyteg/primitivestorage/loadbalancing/SimpleBalancer.hpp:53-77
(roundRobin, greedy, allPrimitivesOnRoot), the space-filling-curve
balancer of adaptive refinement (src/hyteg/adaptiverefinement/mesh.hpp:195)
and primitive migration (PrimitiveStorage::migratePrimitives +
MigrationInfo). Here "rank" is a shard; migration permutes per-cell blocks
from the old layout into the new one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mesh.meshinfo import MeshInfo
from .storage import CellStorage


# -- partitioners (return the shard of every cell) ----------------------------


def morton_codes(points: np.ndarray, bits: int = 16) -> np.ndarray:
    """Morton (Z-order) codes of points normalised to their bounding box:
    bit b of axis d lands at bit b * dim + d (the native setup core, or
    its numpy fallback when it does not build)."""
    from .. import native

    return native.morton_codes(points, bits)


def partition_sfc(centroids: np.ndarray, num_shards: int,
                  weights: np.ndarray | None = None) -> np.ndarray:
    """Space-filling-curve balancer: sort by Morton code, split into
    contiguous chunks of equal weight (locality cuts the interface)."""
    order = np.argsort(morton_codes(centroids), kind="stable")
    n = len(order)
    if num_shards > n:
        raise ValueError(f"{num_shards} shards for {n} cells")
    w = np.ones(n) if weights is None else np.asarray(weights, dtype=float)
    csum = np.cumsum(w[order])
    targets = csum[-1] * (np.arange(1, num_shards + 1) / num_shards)
    bounds = np.searchsorted(csum, targets, side="left")
    assignment = np.zeros(n, dtype=np.int64)
    start = 0
    for d, end in enumerate(bounds):
        end = max(int(end) + 1, start + 1) if d < num_shards - 1 else n
        end = min(end, n - (num_shards - 1 - d))  # >= 1 cell per shard
        assignment[order[start:end]] = d
        start = end
    return assignment


def partition_greedy(num_shards: int, weights: np.ndarray) -> np.ndarray:
    """Greedy weighted bin packing: heaviest cell to the lightest shard
    (reference: loadbalancing::greedy / roundRobinVolume)."""
    w = np.asarray(weights, dtype=float)
    n = len(w)
    if num_shards > n:
        raise ValueError(f"{num_shards} shards for {n} cells")
    order = np.argsort(-w, kind="stable")
    loads = np.zeros(num_shards)
    counts = np.zeros(num_shards, dtype=np.int64)
    assignment = np.zeros(n, dtype=np.int64)
    for i, cell in enumerate(order):
        need = counts == 0  # never leave a shard empty when cells run low
        if need.any() and n - i <= int(need.sum()):
            d = int(np.argmax(need))
        else:
            d = int(np.argmin(loads))
        assignment[cell] = d
        loads[d] += w[cell]
        counts[d] += 1
    return assignment


def cell_volumes(mesh: MeshInfo) -> np.ndarray:
    pts = mesh.points[mesh.elements][..., : mesh.dim]
    det = np.abs(np.linalg.det(pts[:, 1:, :] - pts[:, :1, :]))
    return det / (6.0 if mesh.dim == 3 else 2.0)


def cell_centroids(mesh: MeshInfo) -> np.ndarray:
    return mesh.points[mesh.elements].mean(axis=1)


def make_storage(mesh: MeshInfo, num_shards: int,
                 method: str = "sfc") -> CellStorage:
    """A CellStorage under a named balancer: 'round_robin', 'contiguous',
    'all_on_root', 'sfc', 'greedy_volume'."""
    return CellStorage(mesh, num_shards, partitioner=method)


def interface_cut(storage: CellStorage, level: int) -> int:
    """Interface DoFs whose replicas span more than one shard: the
    communication volume a balancer should minimise."""
    maps = storage.p1_level_maps(level)
    D, G = maps.slot_gid.shape[0], maps.num_ifc
    seen = np.zeros((G + 1, D), dtype=bool)
    for d in range(D):
        seen[maps.slot_gid[d], d] = True
    return int((seen[:G].sum(axis=1) > 1).sum())


# -- migration ----------------------------------------------------------------


@dataclasses.dataclass
class MigrationInfo:
    """Old-layout -> new-layout cell permutation
    (reference: PrimitiveStorage MigrationInfo)."""

    src_slot: np.ndarray   # (C_new,) old slot per new slot; -1 = padding
    old_storage: CellStorage
    new_storage: CellStorage

    def migrate_cellwise(self, u_old: torch.Tensor) -> torch.Tensor:
        """Permute a per-cell block (C_old, ...) into the new layout
        (C_new, ...); padding cells come out zero."""
        idx = torch.as_tensor(np.maximum(self.src_slot, 0),
                              device=u_old.device)
        out = u_old.index_select(0, idx)
        pad = torch.as_tensor(self.src_slot < 0, device=u_old.device)
        return out.masked_fill_(
            pad.reshape((-1,) + (1,) * (u_old.dim() - 1)), 0)


def migrate(old: CellStorage, new: CellStorage) -> MigrationInfo:
    """Plan a migration between two storages of one mesh."""
    if old.topo.num_cells != new.topo.num_cells:
        raise ValueError("migration needs two storages of one mesh")
    old_slot_of_cell = np.full(old.topo.num_cells, -1, dtype=np.int64)
    valid = np.flatnonzero(old.cell_valid)
    old_slot_of_cell[old.cell_global_index[valid]] = valid
    src = np.full(new.num_cells, -1, dtype=np.int64)
    nv = np.flatnonzero(new.cell_valid)
    src[nv] = old_slot_of_cell[new.cell_global_index[nv]]
    return MigrationInfo(src_slot=src, old_storage=old, new_storage=new)


def rebalance(storage: CellStorage, method: str = "sfc") -> MigrationInfo:
    """Re-balance a live storage under another balancer (reference:
    DistributedBalancer.cpp:51)."""
    return migrate(storage, make_storage(storage.mesh, storage.num_shards,
                                         method))
