"""Quadrature rules and reference bases on simplices (torch counterpart of
hyteg_tpu/operators/quadrature.py).

The rules and nodal bases are host-side numpy, copied from the JAX
package: moment-fitted rules (weights solved from the exact monomial
moments over the reference simplex) and nodal P1/P2 bases indexed by
node-grid offsets (P2 node at offset g in {0,1,2}^dim <-> barycentric
point g/2), matching the level-(L+1) node-grid storage of the P2 space.
The element matrices are assembled in torch with the closed-form small
determinant and inverse of operators/forms.py.
"""

from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch

from .forms import _jacobian, det_small, inv_small


# ---------------------------------------------------------------------------
# quadrature on the reference simplex (vertices 0, e_1, ..., e_dim)
# ---------------------------------------------------------------------------


def monomial_integral(powers: tuple[int, ...]) -> float:
    """Exact integral of prod(x_i^p_i) over the unit reference simplex."""
    dim = len(powers)
    num = 1.0
    for p in powers:
        num *= math.factorial(p)
    return num / math.factorial(sum(powers) + dim)


def _lattice_points(dim: int, m: int) -> np.ndarray:
    """Barycentric lattice points i/m with sum <= m."""
    pts = []
    for combo in itertools.product(range(m + 1), repeat=dim):
        if sum(combo) <= m:
            pts.append([c / m for c in combo])
    return np.array(pts)


@functools.lru_cache(maxsize=None)
def simplex_rule(dim: int, degree: int) -> tuple[np.ndarray, np.ndarray]:
    """(points (Q, dim), weights (Q,)) exact for polynomials of total degree
    <= ``degree``, built by least-squares moment fitting on a lattice."""
    m = max(degree, 1) + 1
    pts = _lattice_points(dim, m)
    # shrink the lattice toward the centroid to avoid boundary-only fits
    centroid = np.full(dim, 1.0 / (dim + 1))
    pts = centroid + 0.85 * (pts - centroid)
    monos = [p for p in itertools.product(range(degree + 1), repeat=dim)
             if sum(p) <= degree]
    V = np.stack([np.prod(pts ** np.array(p), axis=1) for p in monos], axis=0)
    b = np.array([monomial_integral(p) for p in monos])
    w, *_ = np.linalg.lstsq(V, b, rcond=None)
    resid = np.abs(V @ w - b).max()
    assert resid < 1e-12, f"moment fit failed: {resid}"
    return pts, w


# ---------------------------------------------------------------------------
# nodal bases (indexed by node-grid offsets)
# ---------------------------------------------------------------------------


def p1_offsets(dim: int) -> np.ndarray:
    """P1 nodes at simplex vertices: offsets in the {0,1}^dim vertex grid."""
    return np.concatenate([np.zeros((1, dim), np.int64),
                           np.eye(dim, dtype=np.int64)])


def p2_offsets(dim: int) -> np.ndarray:
    """P2 nodes on the {0,1,2}^dim node grid (sum <= 2): 6 in 2D, 10 in 3D.
    Offset g is the barycentric point g/2 of the element: even offsets
    are vertices, the rest edge midpoints."""
    out = [g for g in itertools.product(range(3), repeat=dim) if sum(g) <= 2]
    return np.array(sorted(out), dtype=np.int64)


def _bary(dim, x):
    """Barycentric coordinates (lam_0, ..., lam_dim) of reference point x."""
    lam0 = 1.0 - np.sum(x, axis=-1, keepdims=True)
    return np.concatenate([lam0, x], axis=-1)


def p1_basis_at(dim: int, pts: np.ndarray) -> np.ndarray:
    """(nv, Q) values of the P1 nodal basis at reference points."""
    return _bary(dim, pts).T


def p1_grads_at(dim: int, pts: np.ndarray) -> np.ndarray:
    """(nv, Q, dim) reference gradients (constant for P1)."""
    Q = pts.shape[0]
    g = np.concatenate([-np.ones((1, dim)), np.eye(dim)], axis=0)
    return np.broadcast_to(g[:, None, :], (dim + 1, Q, dim)).copy()


def _p2_node_pairs(dim: int) -> list[tuple[int, int]]:
    """For each P2 node offset, the (i, j) vertex pair it interpolates:
    i == j for vertex nodes, i != j for edge midpoints (barycentric ids)."""
    pairs = []
    for g in p2_offsets(dim):
        bary = [2 - int(np.sum(g))] + [int(v) for v in g]  # weights out of 2
        nz = [i for i, w in enumerate(bary) if w > 0]
        pairs.append((nz[0], nz[0]) if len(nz) == 1 else (nz[0], nz[1]))
    return pairs


def p2_basis_at(dim: int, pts: np.ndarray) -> np.ndarray:
    """(n_nodes, Q) P2 nodal basis values at reference points."""
    lam = _bary(dim, pts)
    out = []
    for i, j in _p2_node_pairs(dim):
        if i == j:
            out.append(lam[:, i] * (2 * lam[:, i] - 1))
        else:
            out.append(4 * lam[:, i] * lam[:, j])
    return np.stack(out, axis=0)


def p2_grads_at(dim: int, pts: np.ndarray) -> np.ndarray:
    """(n_nodes, Q, dim) reference gradients of the P2 nodal basis."""
    lam = _bary(dim, pts)
    dlam = np.concatenate([-np.ones((1, dim)), np.eye(dim)], axis=0)
    out = []
    for i, j in _p2_node_pairs(dim):
        if i == j:
            g = (4 * lam[:, i, None] - 1) * dlam[i][None, :]
        else:
            g = 4 * (lam[:, i, None] * dlam[j][None, :]
                     + lam[:, j, None] * dlam[i][None, :])
        out.append(g)
    return np.stack(out, axis=0)


# ---------------------------------------------------------------------------
# element-matrix assembly from (basis, rule)
# ---------------------------------------------------------------------------


def stiffness_elmat(verts: torch.Tensor, basis_grads, weights) -> torch.Tensor:
    """Element stiffness: verts (..., nv_geom, dim) affine element;
    basis_grads (n, Q, dim) reference gradients; weights (Q,).
    Returns (..., n, n): sum_q w_q |J| (g_A J^-1) . (g_B J^-1)."""
    kw = dict(dtype=verts.dtype, device=verts.device)
    J = _jacobian(verts)
    g = torch.einsum("aqd,...de->...aqe", torch.as_tensor(basis_grads, **kw),
                     inv_small(J))
    M = torch.einsum("q,...aqe,...bqe->...ab", torch.as_tensor(weights, **kw),
                     g, g)
    return det_small(J).abs()[..., None, None] * M


def mass_elmat(verts: torch.Tensor, basis_vals, weights) -> torch.Tensor:
    """Element mass matrix: (..., n, n) = |J| sum_q w_q phi_A phi_B."""
    kw = dict(dtype=verts.dtype, device=verts.device)
    phi = torch.as_tensor(basis_vals, **kw)
    M = torch.einsum("q,aq,bq->ab", torch.as_tensor(weights, **kw), phi, phi)
    return det_small(_jacobian(verts)).abs()[..., None, None] * M
