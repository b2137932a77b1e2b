"""Mantle-convection run parameters (copy of hyteg_tpu/terraneo/params.py).

Reference: src/terraneo/helpers/TerraNeoParameters.hpp + the .prm config of
apps/TerraNeo/Origin/parameters.prm. Non-dimensional Boussinesq setup:
Rayleigh number Ra drives buoyancy; temperatures are scaled to [0, 1]
(1 = hot inner boundary / CMB, 0 = cold outer boundary / surface).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ConvectionParameters:
    # domain (annulus in 2D, icosahedral spherical shell in 3D)
    dim: int = 2
    rmin: float = 0.55
    rmax: float = 1.0
    ntan: int = 8            # tangential macro resolution
    nrad: int = 2            # radial macro layers
    level: int = 3           # micro refinement level
    min_level: int = 0       # GMG coarse level for Stokes

    # physics (non-dimensional)
    rayleigh: float = 1.0e4
    diffusivity: float = 1.0
    internal_heating: float = 0.0
    viscosity: float = 1.0          # constant reference viscosity
    visc_activation: float = 0.0    # >0: eta(T)=exp(E (0.5 - T)) Arrhenius-lite
    shear_heating: bool = False     # viscous dissipation source 2 eta eps:eps
    adiabatic_heating: float = 0.0  # C_a: dT/dt -= C_a T (adiabatic analog)

    # time stepping
    cfl: float = 0.8
    max_dt: float = 1.0e-2
    theta: float = 1.0              # implicit Euler for the energy equation
    mmoc_rk: int = 4
    mmoc_substeps: int = 1

    # solvers
    stokes_rtol: float = 1e-6
    stokes_iters: int = 120
    energy_cg_iters: int = 200
    energy_cg_rtol: float = 1e-7
    stokes_every: int = 1           # re-solve Stokes every k steps

    # io
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0
    profile_bins: int = 16
