"""Per-macro-cell error indicators and Dörfler marking (torch counterpart
of hyteg_tpu/adaptivity/estimator.py).

Reference: src/hyteg/adaptiverefinement/error_estimator.hpp:40. The
reference estimates per-macro error from hierarchical residuals; here the
indicator is the scaled gradient energy per macro cell

    eta_c^2 = h_c * sum_{K in c} |grad u|_K|^2 |K|

which concentrates refinement where the solution varies fastest.

The per-cell geometry (edge matrices, volumes, h) is the JAX package's
host numpy on the shard data's vertices, so it rounds as the reference
does; the sums over every micro-element run in float64 on the space's
device, over strided views of the node grid (a level-7 block of 106
cells holds 1.8e8 slots: the reference pulls it to the host and loops in
numpy).
"""

from __future__ import annotations

import numpy as np
import torch

from ..indexing import micro


def _geometry(verts: np.ndarray, valid: np.ndarray, n: int, dim: int):
    """(JTinv, vol, h) per cell from (C, dim + 1, dim) vertices, as the
    reference computes them (in the vertices' dtype)."""
    J = verts[:, 1:, :] - verts[:, :1, :]
    det = np.abs(np.linalg.det(J))
    JTinv = np.zeros_like(J)
    JTinv[valid] = np.linalg.inv(np.transpose(J[valid], (0, 2, 1)))
    vol = det / (2.0 if dim == 2 else 6.0) / (n ** dim)
    h = det ** (1.0 / dim)
    return JTinv, vol, h


def macro_gradient_indicator(p1_space, u, sd=None) -> np.ndarray:
    """(C,) indicator per macro cell of the shard, in slot order (padding
    cells get 0), as a float64 numpy array."""
    sp = p1_space
    sd = sp.resolve_sd(sd)
    dim, n = sp.dim, sp.n
    verts = sd.cell_vertices.cpu().numpy()[..., :dim]
    C = verts.shape[0]
    valid = np.ones(C, dtype=bool)
    if sd.pad_cells is not None:
        valid[sd.pad_cells.cpu().numpy()] = False
    JTinv, vol, h = _geometry(verts, valid, n, dim)
    offs = micro.offsets(dim)

    u = torch.as_tensor(u)
    if dim == 3:  # flat (C, N, lanes) -> grid (C, N, N, N) view
        u = u.reshape(C, sp.N, sp.N, sp.pitch)[..., : sp.N]
    dev = u.device
    eta2 = torch.zeros(C, dtype=torch.float64, device=dev)
    for t in range(offs.shape[0]):
        # element-local vertex reads (strided views of the node grid)
        reads = []
        for k in range(offs.shape[1]):
            o = offs[t, k]
            sl = (slice(None),) + tuple(slice(int(o[d]), int(o[d]) + n)
                                        for d in range(dim))
            reads.append(u[sl])
        # u = u0 + sum_k du_k mu_k,  mu = Minv (n lam - base - O0),
        # lam = JTinv (x - v0)  =>  d mu_k / dx_f = n Minv[k,d] JTinv[d,f];
        # du in u's dtype, as the reference takes the difference
        M = (offs[t, 1:] - offs[t, :1]).astype(np.float64)
        Minv = np.linalg.inv(M.T)
        G = torch.as_tensor(n * np.einsum("kd,cdf->ckf", Minv, JTinv),
                            dtype=torch.float64, device=dev)
        G = G.reshape((C,) + (1,) * dim + G.shape[1:])
        du = [(reads[k + 1] - reads[0]).to(torch.float64)
              for k in range(dim)]
        g2 = None
        for f in range(dim):
            gf = du[0] * G[..., 0, f]
            for k in range(1, dim):
                gf = gf + du[k] * G[..., k, f]
            g2 = gf * gf if g2 is None else g2 + gf * gf
        mask = torch.as_tensor(
            micro.elem_base_mask(sp.level, t, dim)[
                tuple(slice(0, n) for _ in range(dim))], device=dev)
        eta2 += torch.where(mask, g2, 0.0).reshape(C, -1).sum(-1)
        del reads, du, g2
    eta2 = eta2.cpu().numpy() * vol
    eta2 *= h
    eta2[~valid] = 0.0
    return np.sqrt(eta2)


def mark_dorfler(eta: np.ndarray, frac: float = 0.5) -> np.ndarray:
    """Smallest element set carrying ``frac`` of the total indicator mass
    (Dörfler / bulk marking). Returns sorted element indices."""
    order = np.argsort(eta)[::-1]
    csum = np.cumsum(eta[order] ** 2)
    total = csum[-1]
    if total <= 0:
        return np.array([], dtype=np.int64)
    k = int(np.searchsorted(csum, frac * total)) + 1
    return np.sort(order[:k])
