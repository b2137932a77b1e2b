"""Carry state over from the JAX package (hyteg_tpu) as numpy arrays.

Both packages lay a P1 block out as (C, N, N*pitch) with the same lane
map, so no conversion repacks: these functions only change the array
type, dtype and device, and copy (an array read from JAX is read-only).
They let a test run both packages on identical operators (element
matrices, eigenvalue bounds) and identical states.
"""

from __future__ import annotations

import numpy as np
import torch


def elmats_from_reference(elmats: np.ndarray, device="cpu",
                          dtype=torch.float32) -> torch.Tensor:
    """(C, 6, 4, 4) element matrices -> tensor for
    ``P1ElementwiseOperator(space, form, elmats=...)`` or
    ``make_p1_gmg(..., elmats={level: ...})``."""
    return torch.tensor(np.asarray(elmats), dtype=dtype, device=device)


def block_from_reference(block: np.ndarray, device="cpu",
                         dtype=torch.float32) -> torch.Tensor:
    """A (C, N, N*pitch) state block -> tensor on ``device``."""
    return torch.tensor(np.asarray(block), dtype=dtype, device=device)


def block_to_numpy(block: torch.Tensor) -> np.ndarray:
    """A (C, N, N*pitch) tensor -> numpy on the host."""
    return block.detach().cpu().numpy()
