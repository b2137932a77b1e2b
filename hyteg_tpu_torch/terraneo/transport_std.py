"""Eulerian energy-transport operator with SUPG, shear and adiabatic
heating on P1 temperature fields (torch counterpart of
hyteg_tpu/terraneo/transport_std.py).

Reference: src/terraneo/operators/TransportOperatorStd.hpp:69-360 — term
dictionary {DIFFUSION, ADVECTION, ADIABATIC_HEATING, SHEAR_HEATING,
INTERNAL_HEATING, SUPG_STABILISATION}. Where the reference's SUPG branch
aborts ("SUPG not yet tested and supported", TransportOperatorStd.hpp:222),
the JAX package implements it, and so does this module: the advection
element matrices with per-element-mean velocity v̄,

    A_adv[a,b]  = (v̄·∇φ_b) |e| / nv          (Galerkin term)
                 + τ_e (v̄·∇φ_a)(v̄·∇φ_b) |e|   (SUPG streamline term)
    τ_e = h_e / (2 |v̄|)  (clamped)

are formed per micro-element from the constant P1 basis gradients and
contracted in the masked shifted-read pattern of the elementwise
operators. Shear heating is the viscous dissipation Φ = 2 η ε(u):ε(u)
of the per-element-constant strain rate, lumped-projected to nodes. SUPG
and shear heating are plain torch, as in the JAX package (no Pallas
kernel). The implicit step's Laplace and mass apply through kernel B2,
its adiabatic term (the mass with a nodal coefficient) through B4.
"""

from __future__ import annotations

import weakref

import torch

from ..core.types import BoundaryCondition, DoFType, FLAG_INNER
from ..functions.p1 import P1Space
from ..indexing import flat, micro
from ..kernels.p1_stencil import _class_masks
from ..operators import forms
from ..operators.p1_elementwise import P1ElementwiseOperator
from ..solvers.krylov import cg_solve


def _micro_edges(space: P1Space, cell_vertices) -> torch.Tensor:
    """(C, T, dim, dim) float64 micro-element edge matrices
    E[t] = (p_a - p_0) of each congruence class (affine cells)."""
    dim = space.dim
    verts = torch.as_tensor(cell_vertices, dtype=torch.float64)[..., :dim]
    J = verts[:, 1:, :] - verts[:, :1, :]  # (C, dim, dim), rows = edges
    offs = torch.as_tensor(micro.offsets(dim), dtype=torch.float64,
                           device=verts.device) / space.n
    return torch.einsum("tvd,cde->ctve", offs[:, 1:] - offs[:, :1], J)


def element_basis_gradients(space: P1Space, cell_vertices) -> torch.Tensor:
    """(C, T, nv, dim) constant gradients of the P1 basis on each
    micro-element congruence class (affine cells), in the space's dtype
    (computed in float64)."""
    Einv = torch.linalg.inv(_micro_edges(space, cell_vertices))
    # grad lambda_a (a >= 1) are the rows of E^-T; grad lambda_0 = -sum
    g = Einv.transpose(-1, -2)
    g = torch.cat([-g.sum(-2, keepdim=True), g], dim=-2)
    return g.to(space.dtype)


def element_volumes(space: P1Space, cell_vertices) -> torch.Tensor:
    """(C, T) micro-element volumes (areas in 2D), in the space's dtype."""
    fact = 2.0 if space.dim == 2 else 6.0
    E = _micro_edges(space, cell_vertices)
    return (torch.linalg.det(E).abs() / fact).to(space.dtype)


#: per space and shard, (element_basis_gradients, element_volumes): a
#: float64 batched inverse and determinant over (C, T), built once
_ELEMENT_TABLES: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def element_tables(space: P1Space, shard: int = 0):
    """(gradients (C, T, nv, dim), volumes (C, T)) of the shard's
    micro-elements, computed on the first call for a space and kept."""
    per_shard = _ELEMENT_TABLES.setdefault(space, {})
    if shard not in per_shard:
        cv = space.resolve_sd(None, shard).cell_vertices
        per_shard[shard] = (element_basis_gradients(space, cv),
                            element_volumes(space, cv))
    return per_shard[shard]


def _col(a: torch.Tensor) -> torch.Tensor:
    """(C,) per-cell value -> (C, 1, 1), broadcasting over a block."""
    return a.reshape(-1, 1, 1)


class SUPGAdvectionOperator:
    """T -> advection (+ optional SUPG) applied to T, per-element-mean
    velocity read from nodal P1 velocity component fields."""

    def __init__(self, space: P1Space, supg: bool = True, shard: int = 0,
                 kappa: float = 0.0):
        self.space = space
        self.supg = supg
        #: diffusivity for the Peclet-limited tau (0 = pure advective tau)
        self.kappa = float(kappa)
        self.grads, self.vols = element_tables(space, shard)
        # characteristic element size for tau: h = vol^(1/dim)
        self.h_e = self.vols ** (1.0 / space.dim)

    def apply_raw(self, T, vel, sd=None) -> torch.Tensor:
        """vel: dim nodal component fields (same block shape), a sequence
        or a (dim, C, N, lanes) tensor."""
        sp = self.space
        return sp._exchange_add_(self._apply_local(T, vel),
                                 sp.resolve_sd(sd))

    def _apply_local(self, T, vel):
        sp = self.space
        dim, level, pitch = sp.dim, sp.level, sp.pitch
        offs = micro.offsets(dim)
        Tn, nv = offs.shape[0], offs.shape[1]
        masks = _class_masks(level, dim, pitch, T.dtype, T.device)
        dst = torch.zeros_like(T)
        for t in range(Tn):
            reads = [flat.shift_read(T, offs[t, b], pitch, dim)
                     for b in range(nv)]
            vbar = [sum(flat.shift_read(v, offs[t, b], pitch, dim)
                        for b in range(nv)) / nv for v in vel]
            # w_b = vbar . grad phi_b, per-cell gradients broadcast
            w = [sum(_col(self.grads[:, t, b, i]) * vbar[i]
                     for i in range(dim)) for b in range(nv)]
            vT = sum(w[b] * reads[b] for b in range(nv))  # vbar . grad T
            vol = _col(self.vols[:, t])
            gal = (vol / nv) * vT * masks[t]
            if self.supg:
                vmag = torch.sqrt(sum(v * v for v in vbar))
                h = _col(self.h_e[:, t])
                tau = h / torch.clamp(2.0 * vmag, min=1e-12)
                if self.kappa > 0.0:
                    # Peclet limit (doubly-asymptotic xi ~ min(1, Pe/3)):
                    # diffusion-dominated elements get tau -> h^2/(12 k)
                    # instead of spurious O(h) streamline diffusion
                    pe = vmag * h / (2.0 * self.kappa)
                    tau = tau * torch.clamp(pe / 3.0, max=1.0)
                su = tau * vol * vT * masks[t]
            for a in range(nv):
                contrib = gal + w[a] * su if self.supg else gal
                dst = dst + flat.shift_write(contrib, offs[t, a], pitch, dim)
        return dst


def shear_heating_source(space: P1Space, vel, eta, sd=None,
                         shard: int = 0) -> torch.Tensor:
    """Nodal viscous dissipation Q = 2 eta eps(u):eps(u), lumped-projected
    (reference: the shearHeatingOperator_ + coefficient product,
    TransportOperatorStd.hpp:264-266). ``vel``: dim nodal component
    fields (a sequence or a (dim, C, N, lanes) tensor)."""
    sp = space
    dim, level, pitch = sp.dim, sp.level, sp.pitch
    grads, vols = element_tables(sp, shard)
    offs = micro.offsets(dim)
    Tn, nv = offs.shape[0], offs.shape[1]
    masks = _class_masks(level, dim, pitch, eta.dtype, eta.device)
    num = torch.zeros_like(eta)
    den = torch.zeros_like(eta)
    for t in range(Tn):
        vreads = [[flat.shift_read(v, offs[t, b], pitch, dim)
                   for b in range(nv)] for v in vel]
        eta_e = sum(flat.shift_read(eta, offs[t, b], pitch, dim)
                    for b in range(nv)) / nv
        # du_j/dx_i per element: sum_b g[b,i] * u_j[b]
        phi = None
        for i in range(dim):
            for j in range(dim):
                gi = sum(_col(grads[:, t, b, i]) * vreads[j][b]
                         for b in range(nv))
                gj = sum(_col(grads[:, t, b, j]) * vreads[i][b]
                         for b in range(nv))
                eij = 0.5 * (gi + gj)
                phi = eij * eij if phi is None else phi + eij * eij
        Q_e = 2.0 * eta_e * phi  # per-element dissipation density
        wgt = (_col(vols[:, t]) / nv) * masks[t]
        for a in range(nv):
            num = num + flat.shift_write(wgt * Q_e, offs[t, a], pitch, dim)
            den = den + flat.shift_write(wgt, offs[t, a], pitch, dim)
    sd = sp.resolve_sd(sd)
    num = sp._exchange_add_(num, sd)
    den = sp._exchange_add_(den, sd)
    return torch.where(den > 0, num / torch.clamp(den, min=1e-30), 0.0)


class TransportOperatorStd:
    """Implicit BDF1 energy step with the reference's term dictionary.

        (M + dt kappa A + dt M[C_adiabatic]) T^{n+1}
            (+ dt A_supg-advection if Eulerian advection is on)
          = M T_* + dt (Q_shear + H_int) mass-weighted

    T_* is the MMOC-advected field when advection is handled
    semi-Lagrangially (the reference's only working mode), or T^n with
    the Eulerian SUPG advection folded into the lhs. The last step's CG
    iteration count is ``last_iterations``."""

    def __init__(self, space: P1Space, bc: BoundaryCondition | None = None,
                 kappa: float = 1.0, terms: dict | None = None,
                 cg_iters: int = 200, cg_rtol: float = 1e-7):
        self.space = space
        self.bc = bc or BoundaryCondition.all_dirichlet()
        self.kappa = kappa
        self.terms = {
            "DIFFUSION": True,
            "ADVECTION_EULERIAN": False,
            "ADIABATIC_HEATING": False,
            "SHEAR_HEATING": False,
            "INTERNAL_HEATING": False,
            "SUPG_STABILISATION": True,
            **(terms or {}),
        }
        self.A = P1ElementwiseOperator(space, forms.laplace_form)
        self.M = P1ElementwiseOperator(space, forms.mass_form)
        self.adv = SUPGAdvectionOperator(
            space, supg=self.terms["SUPG_STABILISATION"], kappa=kappa)
        self.cg_iters = cg_iters
        self.cg_rtol = cg_rtol
        self._sd = space.resolve_sd(self.bc)
        self.adiabatic_coeff = None   # nodal field C_adiabatic
        self.internal_heating = 0.0   # scalar H
        self.last_iterations = 0

    def _lhs(self, x, dt, vel):
        sd = self._sd
        y = self.M.apply_raw(x, sd=sd)
        if self.terms["DIFFUSION"]:
            y = y + dt * self.kappa * self.A.apply_raw(x, sd=sd)
        if self.terms["ADIABATIC_HEATING"] and self.adiabatic_coeff is not None:
            y = y + dt * self.M.apply_raw(x, coeff=self.adiabatic_coeff,
                                          sd=sd)
        if self.terms["ADVECTION_EULERIAN"] and vel is not None:
            y = y + dt * self.adv.apply_raw(x, vel, sd=sd)
        return y

    def step(self, T, dt, vel=None, eta=None):
        """One implicit step; T keeps its Dirichlet rows."""
        sp = self.space
        sd = self._sd
        b = self.M.apply_raw(T, sd=sd)
        if self.terms["SHEAR_HEATING"] and vel is not None and eta is not None:
            Q = shear_heating_source(sp, vel, eta)
            b = b + dt * self.M.apply_raw(Q, sd=sd)
        if self.terms["INTERNAL_HEATING"]:
            H = torch.full_like(T, self.internal_heating)
            b = b + dt * self.M.apply_raw(H, sd=sd)

        inner = self._inner_mask(T.dtype)
        # eliminate Dirichlet rows: correction equation on the interior
        b_in = inner * (b - self._lhs(T, dt, vel))

        def apply_fn(x):
            return inner * self._lhs(inner * x, dt, vel)

        def dot_fn(a, bb):
            return sp.dot(a, bb, DoFType.ALL, sd)

        res = cg_solve(apply_fn, dot_fn, b_in, torch.zeros_like(b_in),
                       max_iter=self.cg_iters, rtol=self.cg_rtol)
        self.last_iterations = res.iterations
        return T + inner * res.x

    def _inner_mask(self, dtype):
        sp = self.space
        ones = torch.ones(sp.block_shape, dtype=dtype, device=sp.device)
        m = sp.restore_rows(ones, None, FLAG_INNER, self._sd)
        return m * sp.vertex_mask_t.to(dtype)
