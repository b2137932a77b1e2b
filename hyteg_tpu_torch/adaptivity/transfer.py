"""DoF transfer between storages built on different macro meshes (torch
counterpart of hyteg_tpu/adaptivity/transfer.py).

The reference migrates FunctionMemory alongside primitives when the mesh is
re-partitioned or refined (reference: PrimitiveStorage::migratePrimitives,
adaptiverefinement MigrationInfo). With batched point location the transfer
is one device computation: evaluate the old field at every node of the new
storage's grid.
"""

from __future__ import annotations

import torch

from ..functions.evaluate import FieldEvaluator


def interpolate_between_storages(old_storage, old_level: int, degree: int,
                                 u_old, new_storage,
                                 new_level: int | None = None, *, device,
                                 dtype=torch.float32) -> torch.Tensor:
    """The DoF block of the same-degree space on ``new_storage`` (0 outside
    the macro-simplices; interface replicas made consistent on a one-shard
    storage). ``device`` has no default."""
    new_level = old_level if new_level is None else new_level
    if degree == 2:
        from ..functions.p2 import P2Space

        node_sp = P2Space(new_storage, new_level, device=device,
                          dtype=dtype).node_space
    else:
        from ..functions.p1 import P1Space

        node_sp = P1Space(new_storage, new_level, device=device, dtype=dtype)
    ev = FieldEvaluator(old_storage, old_level, degree, device=device,
                        dtype=dtype)
    pts = node_sp.coords().reshape(-1, 3)[:, : node_sp.dim]
    vals = ev.evaluate(u_old, pts).reshape(node_sp.block_shape)
    vals = vals * node_sp.vertex_mask_t
    if new_storage.num_shards == 1:
        vals = node_sp.exchange_rep(vals, node_sp.resolve_sd(None))
    return vals
