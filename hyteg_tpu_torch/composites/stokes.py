"""P2-P1 Taylor-Hood Stokes composite (vector + block operator); torch
counterpart of hyteg_tpu/composites/stokes.py (one shard of a storage;
with group shard data, one shard of a sharded solve).

Reference: src/hyteg/composites/P2P1TaylorHoodFunction.hpp,
src/mixed_operator/P2P1TaylorHoodStokesOperator.hpp. The block system

    [ K   B^T ] [u]   [f]
    [ B   0   ] [p] = [g]

with K = vector P2 viscous block (componentwise Laplace for constant
viscosity, kernel B5 once per component; the epsilon operator for a
variable viscosity; the blended epsilon operator on curved geometry),
B = P2 -> P1 divergence (blended on curved geometry). Velocity Dirichlet
rows are masked per component; the pressure carries no BC (its constant
nullspace is removed by mean projection, the reference's projectMean).

The velocity of a TaylorHoodVec is one (dim, C, M, lanes) block: each
component ``vel[d]`` is a contiguous view, which the kernels take as it
is, and the smoother's Chebyshev steps run on the whole block without
stacking copies.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..core.types import BoundaryCondition, DoFType, FLAG_INNER
from ..functions.p1 import P1Space
from ..functions.p2 import P2Space
from ..operators import forms
from ..operators.mixed import P2ToP1DivOperator
from ..operators.p1_elementwise import P1ElementwiseOperator
from ..operators.p2_elementwise import P2ElementwiseOperator


@dataclasses.dataclass
class TaylorHoodVec:
    """Velocity (dim, C, M, lanes) and pressure (C, N, lanes) blocks.
    Supports +, - and multiplication by a scalar (a float or a 0-dim
    tensor, on either side)."""

    vel: torch.Tensor
    pre: torch.Tensor

    def __add__(self, o: "TaylorHoodVec") -> "TaylorHoodVec":
        return TaylorHoodVec(self.vel + o.vel, self.pre + o.pre)

    def __sub__(self, o: "TaylorHoodVec") -> "TaylorHoodVec":
        return TaylorHoodVec(self.vel - o.vel, self.pre - o.pre)

    def __mul__(self, s) -> "TaylorHoodVec":
        return TaylorHoodVec(s * self.vel, s * self.pre)

    __rmul__ = __mul__

    def zeros_like(self) -> "TaylorHoodVec":
        return TaylorHoodVec(torch.zeros_like(self.vel),
                             torch.zeros_like(self.pre))


def stokes_spaces(storage, level: int, pitch: int, *, device,
                  dtype=torch.float32) -> tuple:
    """(velocity P2Space, pressure P1Space) of one level on one lane
    pitch: what P2P1TaylorHoodStokes builds, for shards to share."""
    return (P2Space(storage, level, device=device, dtype=dtype, pitch=pitch),
            P1Space(storage, level, device=device, dtype=dtype, pitch=pitch))


class P2P1TaylorHoodStokes:
    """Spaces, operators and BC handling of the Stokes system on one level.

    ``mu_field``: nodal viscosity on the velocity node grid (or a callable
    of coords): switches K to the variable-viscosity epsilon operator
    (reference: P2P1ElementwiseBlendingStokesOperator with epsilon forms).
    ``epsilon`` forces the epsilon form at constant viscosity;
    ``full_viscous`` adds the -2/3 mu div u div v term. ``elmats``
    (optional): precomputed element matrices by name, "laplace" (C, T,
    nn, nn), "div" (C, T, nv, nn, dim), "p1_mass" (C, T, nv, nv),
    "epsilon" (C, T, dim, dim, nn, nn), e.g. carried over from the JAX
    package with interop.stokes_elmats_from_reference. ``gmap``: a
    geometry (blending) map: K is the blended epsilon operator and B the
    blended div / grad, both evaluated on the blended node field, which is
    built once and shared (operators/p2_blended_stokes.py); the pressure
    mass of the preconditioners stays the affine lumped P1 mass, as in the
    reference. ``device`` has no default.

    Sharded (the JAX package's ``shard``, ``vel_sd``, ``pre_sd`` and
    ``axis_name``): ``shard`` names the shard whose cells the operators
    hold; ``vel_sd`` / ``pre_sd`` replace the velocity (node grid, under
    ``bc``) and pressure (all-Neumann) shard data, and when they carry a
    group every exchange and dot of the composite runs over it;
    ``spaces`` (stokes_spaces) lets shards share their spaces."""

    def __init__(self, storage, level: int, bc: BoundaryCondition | None = None,
                 viscosity: float = 1.0, *, device, dtype=torch.float32,
                 pitch: int | None = None, mu_field=None, epsilon: bool = False,
                 full_viscous: bool = False, elmats: dict | None = None,
                 gmap=None, shard: int = 0, vel_sd=None, pre_sd=None,
                 spaces: tuple | None = None):
        self.storage = storage
        self.level = level
        self.dim = storage.dim
        self.bc = bc or BoundaryCondition.all_dirichlet()
        # velocity node grid and pressure vertex grid share one lane pitch
        # so the mixed operators are pure strided views (see mixed.py);
        # multi-level (GMG) stacks pass the max-level pitch explicitly
        pitch = ((1 << (level + 1)) + 1) if pitch is None else pitch
        self.pitch = pitch
        self.vel_space, self.pre_space = spaces or stokes_spaces(
            storage, level, pitch, device=device, dtype=dtype)
        self.device = self.vel_space.device
        self.visc = viscosity
        self.shard = shard
        self._vel_sd = vel_sd or self.vel_space.shard_data(shard, self.bc)
        self._pre_sd = pre_sd or self.pre_space.shard_data(
            shard, BoundaryCondition.all_neumann())
        self.group = self._vel_sd.group
        elmats = elmats or {}
        self.gmap = gmap
        self.use_epsilon = (epsilon or full_viscous or (mu_field is not None)
                            or gmap is not None)
        if callable(mu_field):
            mu_field = self.vel_space.interpolate(
                mu_field, self.vel_space.zeros(), DoFType.ALL, self._vel_sd)
        self.mu_field = mu_field
        if gmap is not None:
            if not callable(getattr(gmap, "apply", None)):
                raise TypeError(f"gmap {gmap!r} is no geometry map: it "
                                "needs apply(affine, ref, cell_vertices)")
            from ..operators.p2_blended_stokes import (
                P2BlendedEpsilonOperator, P2P1BlendedDivOperator,
                node_components_blended)

            comps = node_components_blended(self.vel_space, gmap)
            self.K_eps = P2BlendedEpsilonOperator(
                self.vel_space, gmap, full=full_viscous, coords=comps)
            self.K = None
            self.B = P2P1BlendedDivOperator(self.vel_space, self.pre_space,
                                            gmap, coords=comps)
        else:
            if self.use_epsilon:
                from ..operators.p2_epsilon import P2VectorEpsilonOperator

                self.K_eps = P2VectorEpsilonOperator(
                    self.vel_space, full=full_viscous,
                    elmats=elmats.get("epsilon"),
                    cell_vertices=self.vel_space.cell_vertices(shard))
                self.K = None
            else:
                self.K = P2ElementwiseOperator(self.vel_space, "laplace",
                                               shard=shard,
                                               elmats=elmats.get("laplace"))
                self.K_eps = None
            self.B = P2ToP1DivOperator(self.vel_space, self.pre_space,
                                       shard=shard, elmats=elmats.get("div"))
        self.pmass = P1ElementwiseOperator(self.pre_space, forms.mass_form,
                                           shard=shard,
                                           elmats=elmats.get("p1_mass"))

    # -- vectors -------------------------------------------------------------

    def zeros(self) -> TaylorHoodVec:
        return TaylorHoodVec(
            torch.zeros((self.dim,) + tuple(self.vel_space.block_shape),
                        dtype=self.vel_space.dtype, device=self.device),
            self.pre_space.zeros())

    def interpolate_velocity(self, fns: Sequence, x: TaylorHoodVec,
                             flag: DoFType = DoFType.ALL) -> TaylorHoodVec:
        vel = torch.stack([
            self.vel_space.interpolate(fns[d], x.vel[d], flag, self._vel_sd)
            for d in range(self.dim)])
        return TaylorHoodVec(vel, x.pre)

    def interpolate_pressure(self, fn, x: TaylorHoodVec,
                             flag: DoFType = DoFType.ALL) -> TaylorHoodVec:
        return TaylorHoodVec(
            x.vel, self.pre_space.interpolate(fn, x.pre, flag, self._pre_sd))

    def dot(self, a: TaylorHoodVec, b: TaylorHoodVec,
            flag: DoFType = FLAG_INNER) -> torch.Tensor:
        """Global dot product, each DoF once: velocity rows in ``flag``,
        every pressure row. A 0-dim tensor (no host sync)."""
        acc = self.pre_space.dot(a.pre, b.pre, DoFType.ALL, self._pre_sd)
        for d in range(self.dim):
            acc = acc + self.vel_space.dot(a.vel[d], b.vel[d], flag,
                                           self._vel_sd)
        return acc

    def norm(self, a: TaylorHoodVec, flag: DoFType = FLAG_INNER) -> torch.Tensor:
        return torch.sqrt(self.dot(a, a, flag))

    def project_mean(self, p: torch.Tensor) -> torch.Tensor:
        """Subtract the algebraic mean over pressure DoFs
        (reference: vertexdof::projectMean)."""
        sp = self.pre_space
        mean = sp.dof_sum(p, DoFType.ALL, self._pre_sd) / sp.num_global_dofs()
        return (p - mean) * sp.vertex_mask_t

    def _mask_pressure_(self, p: torch.Tensor) -> torch.Tensor:
        return p.mul_(self.pre_space.vertex_mask_t)

    def _restore_vel_(self, vel: torch.Tensor, old, flag: DoFType) -> torch.Tensor:
        """Per component, rows outside ``flag`` from ``old`` (None: zeros),
        in place on a fresh ``vel``."""
        for d in range(self.dim):
            v = vel[d]
            if flag & DoFType.INNER:
                self.vel_space._restore_rows_(
                    v, None if old is None else old[d], flag, self._vel_sd)
            else:
                o = torch.zeros_like(v) if old is None else old[d]
                v.copy_(self.vel_space.restore_rows(v, o, flag, self._vel_sd))
        return vel

    def _exchange_vel_(self, vel: torch.Tensor) -> torch.Tensor:
        for d in range(self.dim):
            self.vel_space._exchange_add_(vel[d], self._vel_sd)
        return vel

    # -- operator ------------------------------------------------------------

    def _apply_K_local(self, vel: torch.Tensor, mu=None) -> torch.Tensor:
        """Per-cell partial visc * K u, a fresh (dim, C, M, lanes) block."""
        if self.use_epsilon:
            mu = self.mu_field if mu is None else mu
            y = self.K_eps.apply_local(vel, mu)
        else:
            y = torch.empty_like(vel)
            for d in range(self.dim):
                self.K._apply_local(vel[d], out=y[d])  # kernel B5
        return y if self.visc == 1.0 else y.mul_(self.visc)

    def apply_K(self, vel: torch.Tensor, mu=None) -> torch.Tensor:
        """Viscous block only (componentwise Laplace or epsilon)."""
        return self._exchange_vel_(self._apply_K_local(vel, mu))

    def K_inverse_diagonal(self, mu=None) -> torch.Tensor:
        """Per-component 1/diag of the viscous block, (dim, C, M, lanes)
        (for the Laplace, one block expanded over the components)."""
        if self.use_epsilon:
            mu = self.mu_field if mu is None else mu
            return self.K_eps.inverse_diagonal(coeff=mu, sd=self._vel_sd) / self.visc
        d = self.K.inverse_diagonal(sd=self._vel_sd) / self.visc
        return d.expand((self.dim,) + tuple(d.shape))

    def apply_raw(self, x: TaylorHoodVec, mu=None) -> TaylorHoodVec:
        """Full block apply (no row masking). ``mu``: per-call nodal
        viscosity override (e.g. eta(T) updated every time step). K's and
        B^T's partial sums are added before one exchange per component."""
        vel = self._apply_K_local(x.vel, mu)
        vel.add_(self.B.apply_gradient_local(x.pre))
        div = self.B.apply_div_local(x.vel.unbind(0))
        return TaylorHoodVec(
            self._exchange_vel_(vel),
            self.pre_space._exchange_add_(div, self._pre_sd))

    def apply_inner(self, x: TaylorHoodVec, flag: DoFType = FLAG_INNER,
                    mu=None) -> TaylorHoodVec:
        """Velocity rows restricted to ``flag`` (Dirichlet rows zeroed);
        pressure rows free."""
        y = self.apply_raw(x, mu=mu)
        return TaylorHoodVec(self._restore_vel_(y.vel, None, flag),
                             self._mask_pressure_(y.pre))

    # -- block-diagonal preconditioner ---------------------------------------

    def pressure_mass_inverse(self) -> torch.Tensor:
        """1 / lumped P1 pressure mass (kernel B3 on the card)."""
        return self.pmass.lumped_inverse_diagonal(sd=self._pre_sd)

    def block_diag_preconditioner(self, mu=None):
        """SPD diagonal preconditioner: inverse diag of K per velocity
        component, inverse lumped P1 mass for pressure (reference:
        P2P1StokesBlockPreconditioner)."""
        kdiag = self.K_inverse_diagonal(mu=mu)
        pinv = self.pressure_mass_inverse()

        def prec(r: TaylorHoodVec) -> TaylorHoodVec:
            return TaylorHoodVec(kdiag * r.vel, pinv * r.pre)

        return prec
