"""Element-matrix forms for affine simplices (torch counterpart of
hyteg_tpu/operators/forms.py).

A form maps physical element-vertex coordinates ``verts`` of shape
(..., nv, dim) (nv = dim + 1) to the local element matrix (..., nv, nv).
"""

from __future__ import annotations

import torch


def _jacobian(verts: torch.Tensor) -> torch.Tensor:
    """(..., dim, dim): columns are edge vectors v_i - v_0."""
    return (verts[..., 1:, :] - verts[..., :1, :]).transpose(-1, -2)


def det_small(J: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of batched 2x2 / 3x3 matrices."""
    d = J.shape[-1]
    if d == 2:
        return J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    a, b, c = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
    p, q, r = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
    u, v, w = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
    return (a * (q * w - r * v) - b * (p * w - r * u)
            + c * (p * v - q * u))


def inv_small(J: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of batched 2x2 / 3x3 matrices."""
    d = J.shape[-1]
    idet = 1.0 / det_small(J)
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, dd = J[..., 1, 0], J[..., 1, 1]
        rows = [[dd, -b], [-c, a]]
    else:
        a, b, c = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
        p, q, r = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
        u, v, w = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
        rows = [
            [q * w - r * v, c * v - b * w, b * r - c * q],
            [r * u - p * w, a * w - c * u, c * p - a * r],
            [p * v - q * u, b * u - a * v, a * q - b * p],
        ]
    adj = torch.stack([torch.stack(rw, dim=-1) for rw in rows], dim=-2)
    return adj * idet[..., None, None]


def simplex_volume(verts: torch.Tensor) -> torch.Tensor:
    """Unsigned volume (area in 2D) of the simplices."""
    factor = 6.0 if verts.shape[-1] == 3 else 2.0
    return det_small(_jacobian(verts)).abs() / factor


def p1_gradients(verts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Physical gradients of the P1 basis: (..., nv, dim), and volumes.

    Reference gradients: hat_0 = -1 vector, hat_i = e_i; physical
    g = J^{-T} ghat.
    """
    dim = verts.shape[-1]
    kw = dict(dtype=verts.dtype, device=verts.device)
    ghat = torch.cat([-torch.ones((1, dim), **kw), torch.eye(dim, **kw)])
    g = torch.einsum("ad,...de->...ae", ghat, inv_small(_jacobian(verts)))
    return g, simplex_volume(verts)


def laplace_form(verts: torch.Tensor) -> torch.Tensor:
    """Stiffness matrix of -div(grad u): vol * g g^T."""
    g, vol = p1_gradients(verts)
    return vol[..., None, None] * torch.einsum("...ad,...bd->...ab", g, g)


def mass_form(verts: torch.Tensor) -> torch.Tensor:
    """Consistent P1 mass matrix: vol (1 + I) / 20 (3D) or / 12 (2D)."""
    dim = verts.shape[-1]
    nv = dim + 1
    kw = dict(dtype=verts.dtype, device=verts.device)
    base = (torch.ones((nv, nv), **kw) + torch.eye(nv, **kw)) / (
        20.0 if dim == 3 else 12.0)
    return simplex_volume(verts)[..., None, None] * base
