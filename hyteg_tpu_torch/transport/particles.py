"""Batched Lagrangian particle engine on one shard (torch counterpart of
hyteg_tpu/transport/particles.py).

Reference: src/convection_particles/data/ParticleStorage.hpp AoS particle
records with flags + linked cells; src/convection_particles/mpi/
SyncNextNeighbors.h particle migration between ranks;
src/convection_particles/kernel/{ExplicitEuler,TemperatureIntegration}.h.

- **SoA, fixed capacity.** Particles live in one struct of fixed-shape
  tensors (positions (P, dim), scalar payloads (P,), an ``active`` mask).
  Creation and deletion flip mask bits.
- **No linked cells, no neighbor sync.** Owner assignment ("which
  macro-cell contains this particle") is recomputed on demand by the point
  location of :class:`~hyteg_tpu_torch.functions.evaluate.FieldEvaluator`;
  on one shard no particle migrates (the sharded exchange is ROADMAP A8's).
- **Integrators as functions.** Explicit Euler / RK2 / RK4 through an
  FE velocity field, and a temperature relaxation kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..functions.evaluate import FieldEvaluator
from ..primitives.storage import CellStorage


@dataclasses.dataclass
class ParticleSet:
    """Fixed-capacity SoA particle container (ParticleStorage analog):
    position, velocity, temperature, flags per particle; ``active``
    replaces the GHOST/GLOBAL flag machinery (no ghosts exist: ownership
    is implicit in point location)."""

    position: torch.Tensor         # (P, dim)
    velocity: torch.Tensor         # (P, dim) last sampled velocity
    temperature: torch.Tensor      # (P,) scalar payload
    start_value: torch.Tensor      # (P,) payload carried from departure point
    active: torch.Tensor           # (P,) bool

    @property
    def capacity(self) -> int:
        return self.position.shape[0]

    def num_active(self) -> torch.Tensor:
        return self.active.sum()


def create_particles(points: np.ndarray, capacity: int | None = None, *,
                     device, dtype=torch.float32) -> ParticleSet:
    """Create a particle set from seed ``points`` (Q, dim), padding to
    ``capacity`` with inactive slots. ``device`` has no default."""
    pts = np.asarray(points, dtype=np.float64)
    q, dim = pts.shape
    cap = int(capacity) if capacity is not None else q
    if cap < q:
        raise ValueError(f"capacity {cap} < {q} seed points")
    pos = np.zeros((cap, dim))
    pos[:q] = pts
    active = np.zeros((cap,), dtype=bool)
    active[:q] = True
    z = torch.zeros((cap,), dtype=dtype, device=device)
    return ParticleSet(
        position=torch.as_tensor(pos, dtype=dtype, device=device),
        velocity=torch.zeros((cap, dim), dtype=dtype, device=device),
        temperature=z,
        start_value=z.clone(),
        active=torch.as_tensor(active, device=device),
    )


class ParticleDomain:
    """Couples particles to a :class:`CellStorage` (the analog of
    src/convection_particles/domain/ coupling to PrimitiveStorage).

    Provides owner lookup (containing macro-cell), velocity sampling and the
    time integrators. ``degree`` selects the FE degree of sampled fields.
    """

    def __init__(self, storage: CellStorage, level: int, degree: int = 1, *,
                 device, dtype=torch.float32):
        self.storage = storage
        self.level = level
        self.degree = degree
        self.ev = FieldEvaluator(storage, level, degree=degree, device=device,
                                 dtype=dtype)

    # -- ownership ---------------------------------------------------------------

    def owners(self, ps: ParticleSet) -> torch.Tensor:
        """(P,) containing macro-cell index per particle (clamped for points
        outside the domain — the reference clamps departure points too).
        Ownership is recomputed, not communicated (reference:
        SyncNextNeighbors.h)."""
        c, _ = self.ev.locate_cells(ps.position)
        return c

    # -- field sampling -----------------------------------------------------------

    def sample(self, u_blocks, ps: ParticleSet) -> torch.Tensor:
        """Evaluate a scalar FE field at the particle positions."""
        return self.ev.evaluate(u_blocks, ps.position)

    def sample_velocity(self, vel_blocks, ps: ParticleSet) -> torch.Tensor:
        """Evaluate a velocity field (``dim`` component blocks: a sequence
        or a (dim, C, N, lanes) tensor) at the particle positions ->
        (P, dim)."""
        vel = (vel_blocks if isinstance(vel_blocks, torch.Tensor)
               else torch.stack(list(vel_blocks)))
        # one pass locates each point once for all components
        return self.ev.evaluate(vel, ps.position).T

    # -- integration kernels (reference: kernel/ExplicitEuler.h etc.) -------------

    def explicit_euler(self, ps: ParticleSet, vel_blocks, dt) -> ParticleSet:
        v = self.sample_velocity(vel_blocks, ps)
        newpos = ps.position + dt * v
        pos = torch.where(ps.active[:, None], newpos, ps.position)
        return dataclasses.replace(ps, position=pos, velocity=v)

    def rk2(self, ps: ParticleSet, vel_blocks, dt) -> ParticleSet:
        v1 = self.sample_velocity(vel_blocks, ps)
        mid = dataclasses.replace(ps, position=ps.position + 0.5 * dt * v1)
        v2 = self.sample_velocity(vel_blocks, mid)
        pos = torch.where(ps.active[:, None], ps.position + dt * v2,
                          ps.position)
        return dataclasses.replace(ps, position=pos, velocity=v2)

    def rk4(self, ps: ParticleSet, vel_blocks, dt) -> ParticleSet:
        p0 = ps.position
        k1 = self.sample_velocity(vel_blocks, ps)
        k2 = self.sample_velocity(
            vel_blocks, dataclasses.replace(ps, position=p0 + 0.5 * dt * k1))
        k3 = self.sample_velocity(
            vel_blocks, dataclasses.replace(ps, position=p0 + 0.5 * dt * k2))
        k4 = self.sample_velocity(
            vel_blocks, dataclasses.replace(ps, position=p0 + dt * k3))
        v = (k1 + 2 * k2 + 2 * k3 + k4) / 6.0
        pos = torch.where(ps.active[:, None], p0 + dt * v, p0)
        return dataclasses.replace(ps, position=pos, velocity=v)

    def integrate(self, ps: ParticleSet, vel_blocks, dt, steps: int = 1,
                  method: str = "rk4") -> ParticleSet:
        """``steps`` sub-steps of the chosen integrator."""
        step_fn: Callable = {"euler": self.explicit_euler, "rk2": self.rk2,
                             "rk4": self.rk4}[method]
        sub = dt / steps
        for _ in range(steps):
            ps = step_fn(ps, vel_blocks, sub)
        return ps

    def integrate_temperature(self, ps: ParticleSet, t_blocks, dt,
                              rate: float = 1.0) -> ParticleSet:
        """Relax particle temperature toward the background FE field
        (reference: kernel/TemperatureIntegration.h)."""
        tb = self.sample(t_blocks, ps)
        newt = ps.temperature + dt * rate * (tb - ps.temperature)
        temp = torch.where(ps.active, newt, ps.temperature)
        return dataclasses.replace(ps, temperature=temp)
