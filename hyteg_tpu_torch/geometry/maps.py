"""Geometry (blending) maps: computational -> physical domain; torch
counterpart of hyteg_tpu/geometry/maps.py.

Reference: src/hyteg/geometry/GeometryMap.hpp:66-106 and the concrete
maps (AnnulusMap, IcosahedralShellMap, ThinShellMap, AffineMap, ...). A map
is a plain function of tensors, evaluated on whole micro-vertex coordinate
fields; operators consume the *blended vertex field* (isoparametric P1:
micro-vertices are snapped onto the curved geometry on each level, which
matches the P1 discretization order).

The radial map Phi(x) = (x/|x|) * sum_i lambda_i |v_i| reproduces the
reference's AnnulusMap and IcosahedralShellMap on the generator meshes
(rings / shell layers of constant radius): directions stay straight,
radii interpolate linearly in the barycentric radial parameter, boundary
micro-vertices land on the circles / spheres.
"""

from __future__ import annotations

import numpy as np
import torch


def _barycentric(ref_coords: torch.Tensor) -> torch.Tensor:
    """(N..., dim) reference grid -> (N..., dim + 1) barycentric weights
    (lambda_0 = 1 - sum of the others)."""
    lam0 = 1.0 - ref_coords.sum(-1, keepdim=True)
    return torch.cat([lam0, ref_coords], dim=-1)


def _interpolate_vertex_values(ref_coords, values) -> torch.Tensor:
    """(C, N...) barycentric interpolation of per-vertex values (C, nv)."""
    return torch.einsum("...v,cv->c...", _barycentric(ref_coords),
                        values.to(ref_coords.dtype))


class GeometryMap:
    """Identity map (affine geometry)."""

    def apply(self, affine_coords, ref_coords, cell_vertices):
        """affine_coords: (C, N..., 3); ref_coords: (N..., dim) barycentric
        grid; cell_vertices: (C, nv, 3). Returns blended (C, N..., 3)."""
        return affine_coords


IdentityMap = GeometryMap


class AffineMap(GeometryMap):
    """x -> M x + b (reference: AffineMap2D/3D)."""

    def __init__(self, M, b):
        self.M = np.asarray(M, dtype=np.float32)
        self.b = np.asarray(b, dtype=np.float32)

    def apply(self, affine_coords, ref_coords, cell_vertices):
        kw = dict(dtype=affine_coords.dtype, device=affine_coords.device)
        return (torch.einsum("...d,ed->...e", affine_coords,
                             torch.as_tensor(self.M, **kw))
                + torch.as_tensor(self.b, **kw))


class RadialMap(GeometryMap):
    """Annulus / spherical-shell blending (reference: AnnulusMap,
    IcosahedralShellMap): keep the ray direction of the affine point, set
    the radius to the barycentric interpolation of the macro-vertex radii."""

    def __init__(self, eps: float = 1e-12):
        self.eps = eps

    def apply(self, affine_coords, ref_coords, cell_vertices):
        rho = _interpolate_vertex_values(
            ref_coords, torch.linalg.vector_norm(cell_vertices, dim=-1))
        norm = torch.linalg.vector_norm(affine_coords, dim=-1)
        scale = rho / torch.clamp(norm, min=self.eps)
        return affine_coords * scale[..., None]


AnnulusMap = RadialMap
IcosahedralShellMap = RadialMap


class PolarCoordsMap(GeometryMap):
    """(r, phi) computational -> cartesian (reference: PolarCoordsMap)."""

    def apply(self, affine_coords, ref_coords, cell_vertices):
        r, phi = affine_coords[..., 0], affine_coords[..., 1]
        return torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                            affine_coords[..., 2]], dim=-1)


class SphericalCoordsMap(GeometryMap):
    """(r, theta, phi) computational -> cartesian
    (reference: SphericalCoordsMap)."""

    def apply(self, affine_coords, ref_coords, cell_vertices):
        r, th, ph = (affine_coords[..., i] for i in range(3))
        st = torch.sin(th)
        return torch.stack([r * st * torch.cos(ph), r * st * torch.sin(ph),
                            r * torch.cos(th)], dim=-1)


class ThinShellMap(RadialMap):
    """Thin spherical shell of fixed radius (reference: ThinShellMap):
    every point is snapped radially onto the sphere of radius R."""

    def __init__(self, radius: float, eps: float = 1e-12):
        super().__init__(eps)
        self.R = radius

    def apply(self, affine_coords, ref_coords, cell_vertices):
        norm = torch.linalg.vector_norm(affine_coords, dim=-1, keepdim=True)
        return affine_coords / torch.clamp(norm, min=self.eps) * self.R


#: the reference's "aligned" shell map aligns its radial rays with the
#: refined lateral grid; with isoparametric blending the radial
#: interpolation is identical (reference: IcosahedralShellAlignedMap)
IcosahedralShellAlignedMap = RadialMap


class TokamakMap(GeometryMap):
    """D-shaped tokamak blending (reference: TokamakMap): the straight
    torus mesh is mapped so the circular poloidal cross-section becomes

        R(theta) = R0 + r cos(theta + delta sin theta)
        Z(theta) = kappa r sin(theta)

    with elongation ``kappa`` and triangularity ``delta``."""

    def __init__(self, ring_radius: float = 2.0, kappa: float = 1.6,
                 delta: float = 0.3):
        self.R0 = ring_radius
        self.kappa = kappa
        self.delta = delta

    def apply(self, affine_coords, ref_coords, cell_vertices):
        x, y, z = (affine_coords[..., i] for i in range(3))
        phi = torch.atan2(y, x)
        dr = torch.sqrt(x * x + y * y) - self.R0
        r = torch.sqrt(dr * dr + z * z)
        theta = torch.atan2(z, dr)
        Rs = self.R0 + r * torch.cos(theta + self.delta * torch.sin(theta))
        Zs = self.kappa * r * torch.sin(theta)
        return torch.stack([Rs * torch.cos(phi), Rs * torch.sin(phi), Zs],
                           dim=-1)


class TorusMap(GeometryMap):
    """Blend the straight torus mesh onto the true torus (reference:
    TokamakMap / TorusMap family): the poloidal radius snaps to the
    interpolated distance from the ring, the toroidal direction is kept."""

    def __init__(self, ring_radius: float = 2.0):
        self.R = ring_radius

    def _ring(self, p):
        phi = torch.atan2(p[..., 1], p[..., 0])
        return torch.stack([self.R * torch.cos(phi), self.R * torch.sin(phi),
                            torch.zeros_like(phi)], dim=-1)

    def apply(self, affine_coords, ref_coords, cell_vertices):
        ring = self._ring(affine_coords)
        d = affine_coords - ring
        vr = torch.linalg.vector_norm(cell_vertices - self._ring(cell_vertices),
                                      dim=-1)  # (C, nv)
        rho = _interpolate_vertex_values(ref_coords, vr)
        dn = torch.linalg.vector_norm(d, dim=-1)
        scale = torch.where(dn > 1e-12, rho / torch.clamp(dn, min=1e-12), 1.0)
        return ring + d * scale[..., None]
