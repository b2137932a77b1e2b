"""Plate-velocity surface boundary conditions for mantle convection
(torch counterpart of hyteg_tpu/terraneo/plates.py).

Reference: src/terraneo/plates/PlateVelocityProvider.hpp — plate
reconstruction surface BCs with rotations and boundary smoothing. The
reference reads GPlates reconstruction files; here the same API is served
by an analytic plate model: the sphere surface is partitioned into plates
by nearest seed direction (a spherical Voronoi diagram), each plate moves
as a rigid rotation v = omega x x about its Euler pole, and velocities are
blended across plate boundaries with a smooth distance weight. Stages
(time keys) give piecewise-constant-in-time plate stages like the
reference's reconstruction ages."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class PlateStage:
    """One reconstruction stage: seed directions (P, 3) on the unit sphere
    and Euler rotation vectors (P, 3) (rad / time unit)."""

    seeds: np.ndarray
    omegas: np.ndarray
    age: float = 0.0


def synthetic_stage(num_plates: int = 6, seed: int = 0,
                    max_rate: float = 1.0, age: float = 0.0) -> PlateStage:
    """Random plate layout (deterministic in ``seed``)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(num_plates, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    om = rng.normal(size=(num_plates, 3))
    om *= max_rate / np.maximum(np.linalg.norm(om, axis=-1, keepdims=True),
                                1e-12)
    return PlateStage(seeds=v, omegas=om, age=age)


class PlateVelocityProvider:
    """Surface velocity provider (reference: plates::PlateVelocityProvider).

    ``smoothing``: angular half-width (radians) of the soft-min blend across
    plate boundaries; 0 gives hard (discontinuous) plate edges."""

    def __init__(self, stages: list[PlateStage], smoothing: float = 0.05):
        if not stages:
            raise ValueError("need at least one plate stage")
        self.stages = sorted(stages, key=lambda s: s.age)
        self.smoothing = float(smoothing)

    def _stage_at(self, age: float) -> PlateStage:
        """Piecewise-constant stage lookup (latest stage with s.age <= age)."""
        best = self.stages[0]
        for s in self.stages:
            if s.age <= age:
                best = s
        return best

    def velocity(self, x: torch.Tensor, age: float = 0.0) -> torch.Tensor:
        """(..., 3) positions -> (..., 3) plate velocities (tangential).

        Velocities scale linearly with |x| (rigid rotation), so the same
        provider serves any sphere radius."""
        st = self._stage_at(age)
        seeds = torch.as_tensor(st.seeds, dtype=x.dtype, device=x.device)
        omegas = torch.as_tensor(st.omegas, dtype=x.dtype, device=x.device)
        r = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        xhat = x / torch.where(r == 0, 1.0, r)
        # angular distance to each plate seed
        cosd = torch.clamp((xhat[..., None, :] * seeds).sum(-1), -1.0, 1.0)
        ang = torch.arccos(cosd)                          # (..., P)
        if self.smoothing > 0:
            w = softmin_weights(ang, self.smoothing)
        else:
            w = (ang == ang.amin(-1, keepdim=True)).to(x.dtype)
            w = w / w.sum(-1, keepdim=True)
        v_each = torch.linalg.cross(
            omegas.expand(x.shape[:-1] + omegas.shape),
            x[..., None, :].expand(x.shape[:-1] + omegas.shape))  # (..., P, 3)
        return torch.sum(w[..., None] * v_each, dim=-2)

    def rms_velocity(self, x: torch.Tensor, age: float = 0.0) -> torch.Tensor:
        v = self.velocity(x, age)
        return torch.sqrt(torch.mean(torch.sum(v * v, dim=-1)))


def softmin_weights(ang: torch.Tensor, width: float) -> torch.Tensor:
    """Distance-softmin weights: exp(-(d - d_min)/width), normalized (the
    JAX package's ``jax_softmin``)."""
    dmin = ang.amin(-1, keepdim=True)
    w = torch.exp(-(ang - dmin) / width)
    return w / w.sum(-1, keepdim=True)
