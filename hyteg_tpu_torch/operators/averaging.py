"""Coefficient averaging schemes for variable-coefficient operators
(torch counterpart of hyteg_tpu/operators/averaging.py).

Each element's matrix is scaled by the chosen mean of the coefficient
values at its vertices (reference: src/hyteg/forms/CoefficientAveraging.hpp).
"""

from __future__ import annotations

import torch

MODES = ("arithmetic", "harmonic", "geometric")


def coeff_average(reads, mode: str = "arithmetic"):
    """Mean of per-vertex coefficient reads (list of equal-shaped tensors).

    harmonic/geometric assume a positive coefficient; values are clamped
    away from zero for stability."""
    nv = len(reads)
    if mode == "arithmetic":
        s = reads[0]
        for r in reads[1:]:
            s = s + r
        return s / nv
    if mode == "harmonic":
        s = None
        for r in reads:
            t = 1.0 / torch.clamp(r, min=1e-30)
            s = t if s is None else s + t
        return nv / s
    if mode == "geometric":
        s = None
        for r in reads:
            t = torch.log(torch.clamp(r, min=1e-30))
            s = t if s is None else s + t
        return torch.exp(s / nv)
    raise ValueError(f"unknown averaging mode {mode!r} (use one of {MODES})")
