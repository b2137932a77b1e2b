"""Particle migration between shards (torch counterpart of
hyteg_tpu/transport/migration.py).

Reference: src/convection_particles/mpi/SyncNextNeighbors.{h,cpp}:
particles that left their shard's cells are packed per destination and
handed over. The protocol is one collective with fixed slot counts: each
shard packs its emigrants into a (D, M) slot matrix ordered by destination
shard, one ``all_to_all`` over the group delivers row d to shard d, and the
arrivals fill the free local slots in order. Slot counts are fixed; an
overflow count reports the particles dropped (the caller picks M).
"""

from __future__ import annotations

import torch

from .particles import ParticleSet

_FIELDS = ("position", "velocity", "temperature", "start_value")


def _pack_by_dest(ps: ParticleSet, dest: torch.Tensor, D: int, M: int):
    """(D, M, ...) send slots: row d holds the first M active particles
    with dest == d, in slot order, inactive zeros elsewhere. Returns
    (slots: dict of field -> (D, M, ...), valid (D, M), overflow)."""
    P = ps.capacity
    dev = dest.device
    leaving = ps.active & (dest >= 0)
    onehot = (dest[None, :] == torch.arange(D, device=dev)[:, None]) \
        & leaving[None, :]
    rank = torch.cumsum(onehot.to(torch.int64), dim=1) - 1    # (D, P)
    keep = onehot & (rank < M)
    overflow = (onehot & (rank >= M)).sum()
    idx = torch.full((D, M + 1), P, dtype=torch.int64, device=dev)
    slot = torch.where(keep, rank, torch.full_like(rank, M))  # M = dump
    src = torch.arange(P, device=dev).expand(D, P)
    idx.scatter_(1, slot, torch.where(keep, src, torch.full_like(src, P)))
    idx = idx[:, :M]
    valid = idx < P
    gidx = torch.clamp(idx, max=P - 1)

    def gather(col):
        g = col[gidx]
        return torch.where(valid.reshape(valid.shape + (1,) * (col.dim() - 1)),
                           g, torch.zeros((), dtype=g.dtype, device=dev))

    return {f: gather(getattr(ps, f)) for f in _FIELDS}, valid, overflow


def migrate(ps: ParticleSet, owner_shard: torch.Tensor, group,
            M: int | None = None):
    """Hand particles to their owner shards over ``group`` (per-shard
    code). ``owner_shard``: (P,) destination of each particle; particles
    owned here keep their slots. Returns (the updated local set, the
    number of particles dropped to slot overflow: 0 in a healthy run)."""
    D = group.size
    P = ps.capacity
    M = M or max(1, P // max(1, D))
    dest = torch.where(ps.active & (owner_shard != group.rank), owner_shard,
                       torch.full_like(owner_shard, -1))
    slots, valid, overflow = _pack_by_dest(ps, dest, D, M)

    # row d of the send slots goes to shard d; row j of what comes back
    # came from shard j
    recv = {f: torch.cat(group.all_to_all(list(slots[f].unbind(0))), dim=0)
            for f in _FIELDS}
    recv_valid = torch.cat(group.all_to_all(
        list(valid.to(torch.uint8).unbind(0))), dim=0).bool()

    stay = ps.active & ~(dest >= 0)
    free = ~stay
    free_idx = torch.nonzero(free, as_tuple=True)[0]            # ascending
    arr_rank = torch.cumsum(recv_valid.to(torch.int64), dim=0) - 1
    ok = recv_valid & (arr_rank < free_idx.numel())
    lost = (recv_valid & ~ok).sum()
    tgt = free_idx[torch.clamp(arr_rank, 0, max(free_idx.numel() - 1, 0))[ok]] \
        if free_idx.numel() else arr_rank[:0]
    out = {}
    for f in _FIELDS:
        col = getattr(ps, f).clone()
        col[tgt] = recv[f][ok]
        out[f] = col
    active = stay.clone()
    active[tgt] = True
    return ParticleSet(active=active, **out), overflow + lost
