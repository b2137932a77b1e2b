"""Radial profiles: binned radial averages of fields and radial viscosity
laws (torch counterpart of hyteg_tpu/terraneo/profiles.py; reference:
src/terraneo/helpers/RadialProfiles.hpp, src/terraneo/helpers/Viscosity.hpp)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def viscosity_profile_arrhenius(E: float):
    """eta(T) = exp(E * (0.5 - T)): Frank-Kamenetskii / Arrhenius-lite law
    (temperature-dependent viscosity; E = 0 gives constant eta = 1)."""

    def eta(T):
        return torch.exp(E * (0.5 - T))

    return eta


@dataclasses.dataclass
class RadialProfile:
    """Mean / min / max of a nodal field per radial shell bin
    (reference: terraneo RadialProfiles computed via MPI reductions —
    here one-shot segment reductions on the device)."""

    radii: np.ndarray
    mean: np.ndarray
    vmin: np.ndarray
    vmax: np.ndarray


def radial_profile(space, u, rmin: float, rmax: float, nbins: int,
                   sd=None) -> RadialProfile:
    """space: P1Space-like (with coords/unique_weight); u: its DoF block."""
    node_sp = getattr(space, "node_space", space)
    sd = node_sp.resolve_sd(sd)
    xyz = node_sp.coords_from(sd.cell_vertices)
    r = torch.sqrt(torch.sum(xyz[..., : node_sp.dim] ** 2, dim=-1))
    w = node_sp.unique_weight(sd)
    bins = torch.clamp(((r - rmin) / (rmax - rmin) * nbins).to(torch.int64),
                       0, nbins - 1)
    bflat, wflat, uflat = bins.reshape(-1), w.reshape(-1), u.reshape(-1)
    zeros = torch.zeros(nbins, dtype=u.dtype, device=u.device)
    wsum = zeros.index_add(0, bflat, wflat)
    usum = zeros.index_add(0, bflat, wflat * uflat)
    mean = usum / torch.clamp(wsum, min=1e-30)
    kept = wflat > 0
    umin = torch.full_like(zeros, torch.inf).scatter_reduce(
        0, bflat, torch.where(kept, uflat, torch.inf), "amin")
    umax = torch.full_like(zeros, -torch.inf).scatter_reduce(
        0, bflat, torch.where(kept, uflat, -torch.inf), "amax")
    centers = rmin + (np.arange(nbins) + 0.5) / nbins * (rmax - rmin)
    return RadialProfile(
        radii=centers,
        mean=mean.cpu().numpy(),
        vmin=umin.cpu().numpy(),
        vmax=umax.cpu().numpy(),
    )
