"""DG operators: facet-coupled SIP Laplace (DG1) and P0 upwind advection;
torch counterpart of hyteg_tpu/operators/dg_ops.py.

Reference: src/hyteg/dgfunctionspace/DGOperator.hpp (volume, inner-facet
and Dirichlet-facet forms) and the P0/FV upwind transport operators.

The facet-neighbor search becomes a static class-adjacency table (derived
numerically once per dimension): for every (element class t, facet f) the
facet's other element is class ``t2`` at a fixed base shift ``s``. Every
facet integral is then a masked shifted dense multiply-add over the
element grid. The set-up (facet quadrature, normals, penalties) is numpy,
copied from the JAX package; the applies run on tensors.

Facet coupling across *macro*-cell interfaces is a boundary-sized sparse
correction: element facets without an in-macro neighbor are matched
across cells by physical facet centroid at set-up, their per-facet SIP
coupling matrices precomputed, and the apply adds one gather/scatter pass
over the matched facets (replacing the Nitsche boundary term the dense
path charged there). An element with several matched facets appears
several times in that pass, so the scatter is an ``index_add_``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..functions.dg import DG1Space
from ..functions.volume import VolumeDoFSpace
from ..indexing import micro


@functools.lru_cache(maxsize=None)
def facet_tables(dim: int):
    """Static facet-adjacency tables.

    Returns (nbr_class, nbr_shift, facet_verts):
      nbr_class:  (T, F) int — element class across facet f of class t
      nbr_shift:  (T, F, dim) int — base shift of the neighbor element
      facet_verts:(T, F, dim) int — local vertex indices spanning facet f
                  (facet f is opposite local vertex f)
    """
    offs = micro.offsets(dim)
    T, nv = offs.shape[0], offs.shape[1]
    F = nv
    nbr_class = -np.ones((T, F), dtype=np.int64)
    nbr_shift = np.zeros((T, F, dim), dtype=np.int64)
    facet_verts = np.zeros((T, F, dim), dtype=np.int64)
    shifts = [np.array(s) for s in np.ndindex(*((3,) * dim))]
    for t in range(T):
        for f in range(F):
            fv = [v for v in range(nv) if v != f]
            facet_verts[t, f] = fv
            target = {tuple(offs[t, v]) for v in fv}
            found = False
            for t2 in range(T):
                for s3 in shifts:
                    s = s3 - 1
                    if t2 == t and not s.any():
                        continue
                    pts = {tuple(offs[t2, v] + s) for v in range(nv)}
                    if target <= pts:
                        nbr_class[t, f] = t2
                        nbr_shift[t, f] = s
                        found = True
                        break
                if found:
                    break
            assert found, f"no neighbor for class {t} facet {f}"
    return nbr_class, nbr_shift, facet_verts


def _facet_quad(fverts: np.ndarray):
    """Physical quadrature on facets. fverts: (..., d, dim) facet vertex
    coords (d = dim of the volume element's facet + 1 = dim). Returns
    (pts (..., Q, dim), wts (..., Q), area (...))."""
    dim = fverts.shape[-1]
    if dim == 2:  # facet = segment, 2-pt Gauss
        a, b = fverts[..., 0, :], fverts[..., 1, :]
        g = 1.0 / (2.0 * np.sqrt(3.0))
        p1 = (0.5 + g) * a + (0.5 - g) * b
        p2 = (0.5 - g) * a + (0.5 + g) * b
        area = np.linalg.norm(b - a, axis=-1)
        pts = np.stack([p1, p2], axis=-2)
        wts = np.stack([area / 2, area / 2], axis=-1)
        return pts, wts, area
    # facet = triangle, edge-midpoint rule (exact deg 2)
    a, b, c = fverts[..., 0, :], fverts[..., 1, :], fverts[..., 2, :]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
    pts = np.stack([(a + b) / 2, (b + c) / 2, (a + c) / 2], axis=-2)
    wts = np.repeat(area[..., None] / 3.0, 3, axis=-1)
    return pts, wts, area


def _p1_basis_grads(verts: np.ndarray):
    """verts (..., nv, dim): returns grads (..., nv, dim) and vols (...)."""
    dim = verts.shape[-1]
    J = np.swapaxes(verts[..., 1:, :] - verts[..., :1, :], -1, -2)
    Jinv = np.linalg.inv(J)
    ghat = np.concatenate([-np.ones((1, dim)), np.eye(dim)], axis=0)
    g = np.einsum("ad,...de->...ae", ghat, Jinv)
    det = np.abs(np.linalg.det(J))
    vol = det / (6.0 if dim == 3 else 2.0)
    return g, vol


def _p1_basis_at(verts: np.ndarray, pts: np.ndarray):
    """Barycentric basis values of element ``verts`` (..., nv, dim) at
    physical points ``pts`` (..., Q, dim) -> (..., Q, nv)."""
    dim = verts.shape[-1]
    J = np.swapaxes(verts[..., 1:, :] - verts[..., :1, :], -1, -2)
    Jinv = np.linalg.inv(J)
    xi = np.einsum("...de,...qe->...qd", Jinv, pts - verts[..., :1, :])
    lam0 = 1.0 - xi.sum(axis=-1, keepdims=True)
    return np.concatenate([lam0, xi], axis=-1)


def _rep_elem_verts(space: VolumeDoFSpace):
    """(C, T, nv, dim) representative (base-0) element vertices, and the
    physical base-shift vectors (C, dim, dim) J/n (one micro step)."""
    cv = np.asarray(space.storage.cell_vertices[
        : space.storage.cells_per_shard * space.storage.num_shards])
    verts = cv[..., : space.dim]
    v0 = verts[:, :1, :]
    J = verts[:, 1:, :] - v0  # (C, dim, dim), rows = macro edges
    offs = micro.offsets(space.dim).astype(np.float64)  # (T, nv, dim)
    ev = v0[:, None] + np.einsum("tvd,cde->ctve", offs, J) / space.n
    return ev, J / space.n


def _shift_elem(u: torch.Tensor, s, dim: int) -> torch.Tensor:
    """out[b] = u[b + s] over the element grid (axes 1..dim), zero fill
    (each |s_i| <= 1)."""
    out = torch.zeros_like(u)
    n = u.shape[1]
    dst, src = [slice(None)], [slice(None)]
    for i in range(dim):
        si = int(s[i])
        dst.append(slice(max(0, -si), n - max(0, si)))
        src.append(slice(max(0, si), n + min(0, si)))
    out[tuple(dst)] = u[tuple(src)]
    return out


@functools.lru_cache(maxsize=None)
def _nbr_masks(level: int, dim: int):
    """Per (t, f): (interior_mask, boundary_mask) on the element grid —
    whether the facet's neighbor element exists inside the macro-cell."""
    nbr_class, nbr_shift, _ = facet_tables(dim)
    n = 1 << level
    crop = (slice(0, n),) * dim
    base = [np.ascontiguousarray(
        micro.elem_base_mask(level, t, dim)[crop]) for t in
        range(micro.num_classes(dim))]
    out = {}
    for t in range(len(base)):
        for f in range(dim + 1):
            t2, s = int(nbr_class[t, f]), nbr_shift[t, f]
            m2 = np.zeros_like(base[t2])
            src = tuple(slice(max(0, int(si)), min(n, n + int(si)))
                        for si in s)
            dst = tuple(slice(max(0, -int(si)), min(n, n - int(si)))
                        for si in s)
            m2[dst] = base[t2][src]
            interior = base[t] & m2
            boundary = base[t] & ~m2
            out[(t, f)] = (interior.astype(np.float32),
                           boundary.astype(np.float32))
    return out


def _boundary_facets(space, Abb_np, sigma):
    """Match no-in-macro-neighbor facets across macro cells by centroid.

    Returns None (single macro / nothing matched) or numpy arrays
    (self_lin (B,), nbr_lin (B,), App (B,nv,nv), Apm (B,nv,nv),
    Abb_sub (B,nv,nv)) with linear element indices into the flattened
    (C*T*n^dim, nv) DoF view. The JAX package's per-facet loop, batched
    over all matched facets: the same keys (centroids rounded to 1e-9),
    the same pair order (by each key's first record, records in order,
    each pair then its reverse) and the same per-facet formulas."""
    dim, n, nv = space.dim, space.n, space.dim + 1
    T = space.T
    C = space.storage.cells_per_shard * space.storage.num_shards
    if C <= 1:
        return None
    _, _, facet_verts = facet_tables(dim)
    masks = _nbr_masks(space.level, dim)
    cv = np.asarray(space.storage.cell_vertices[:C])[..., :dim]
    valid = np.asarray(space.storage.cell_valid[:C])
    v0 = cv[:, :1, :]
    J = cv[:, 1:, :] - v0
    offs = micro.offsets(dim).astype(np.float64)

    # every record (c, t, f, base) in the reference's insertion order
    rc, rt, rf, rb, keys = [], [], [], [], []
    for c in range(C):
        if not valid[c]:
            continue
        for t in range(T):
            for f in range(nv):
                bases = np.argwhere(masks[(t, f)][1] > 0)
                if bases.size == 0:
                    continue
                ref = (bases[:, None, :] + offs[t][facet_verts[t, f]][None]) / n
                keys.append(np.round(v0[c] + ref.mean(axis=1) @ J[c], 9) + 0.0)
                k = len(bases)
                rc.append(np.full(k, c))
                rt.append(np.full(k, t))
                rf.append(np.full(k, f))
                rb.append(bases)
    if not keys:
        return None
    rc, rt, rf = (np.concatenate(a) for a in (rc, rt, rf))
    rb, keys = np.concatenate(rb), np.concatenate(keys)
    _, first, inv, counts = np.unique(keys, axis=0, return_index=True,
                                      return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    paired = counts[inv] == 2
    if not paired.any():
        return None
    rec = np.nonzero(paired)[0]
    # pairs by their key's first record; records within a pair in order
    order = np.lexsort((rec, first[inv[rec]]))
    rec = rec[order].reshape(-1, 2)
    s_idx = rec.reshape(-1)                  # self: a, b of each pair
    n_idx = rec[:, ::-1].reshape(-1)         # neighbour: b, a
    c1, t1, f1, b1 = rc[s_idx], rt[s_idx], rf[s_idx], rb[s_idx]
    c2, t2, b2 = rc[n_idx], rt[n_idx], rb[n_idx]
    ev1 = v0[c1] + np.einsum("kvd,kde->kve", (b1[:, None, :] + offs[t1]) / n,
                             J[c1])
    ev2 = v0[c2] + np.einsum("kvd,kde->kve", (b2[:, None, :] + offs[t2]) / n,
                             J[c2])
    g1, vol1 = _p1_basis_grads(ev1)
    g2, vol2 = _p1_basis_grads(ev2)
    fverts = np.take_along_axis(ev1, facet_verts[t1, f1][..., None], axis=1)
    pts, wts, area = _facet_quad(fverts)
    phi_s = _p1_basis_at(ev1, pts)  # (K, Q, nv)
    phi_n = _p1_basis_at(ev2, pts)
    centroid = ev1.mean(axis=1)
    if dim == 2:
        e = fverts[:, 1] - fverts[:, 0]
        nrm = np.stack([e[:, 1], -e[:, 0]], axis=-1)
    else:
        nrm = np.cross(fverts[:, 1] - fverts[:, 0], fverts[:, 2] - fverts[:, 0])
    nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    out = np.einsum("kd,kd->k", nrm, centroid - fverts[:, 0]) > 0
    nrm[out] = -nrm[out]
    dgs = np.einsum("kad,kd->ka", g1, nrm)
    dgn = np.einsum("kad,kd->ka", g2, nrm)
    h = dim * np.minimum(vol1, vol2) / np.maximum(area, 1e-300)
    pen = (sigma / h)[:, None, None]
    Iss = np.einsum("kq,kqa,kqb->kab", wts, phi_s, phi_s)
    Isn = np.einsum("kq,kqa,kqb->kab", wts, phi_s, phi_n)
    ws = np.einsum("kq,kqa->ka", wts, phi_s)
    wn = np.einsum("kq,kqa->ka", wts, phi_n)
    App = (-0.5 * ws[:, :, None] * dgs[:, None, :]
           - 0.5 * dgs[:, :, None] * ws[:, None, :] + pen * Iss)
    Apm = (-0.5 * ws[:, :, None] * dgn[:, None, :]
           + 0.5 * dgs[:, :, None] * wn[:, None, :] - pen * Isn)
    grid = (C, T) + (n,) * dim
    self_lin = np.ravel_multi_index((c1, t1) + tuple(b1.T), grid)
    nbr_lin = np.ravel_multi_index((c2, t2) + tuple(b2.T), grid)
    return (self_lin.astype(np.int64), nbr_lin.astype(np.int64), App, Apm,
            Abb_np[c1, t1, f1])


@functools.lru_cache(maxsize=16)
def _nbr_mask_tensors(level: int, dim: int, dtype, device):
    """``_nbr_masks`` as tensors (interior, boundary) per (t, f)."""
    return {k: tuple(torch.as_tensor(m, dtype=dtype, device=device)
                     for m in v) for k, v in _nbr_masks(level, dim).items()}


class DG1SIPLaplaceOperator(nn.Module):
    """Symmetric interior-penalty DG Laplacian on DG1
    (reference: DGOperator with the dg_diffusion forms). The per-cell
    facet and volume matrices, and the cross-macro tables, are registered
    buffers."""

    def __init__(self, space: DG1Space, sigma: float | None = None):
        super().__init__()
        self.space = space
        dim, nv = space.dim, space.ndofs
        self.sigma = float(sigma if sigma is not None else 6.0 * dim)
        nbr_class, nbr_shift, facet_verts = facet_tables(dim)
        ev, _ = _rep_elem_verts(space)  # (C, T, nv, dim)
        g_self, vol_self = _p1_basis_grads(ev)
        C, T = ev.shape[0], ev.shape[1]
        F = nv
        App = np.zeros((C, T, F, nv, nv))
        Apm = np.zeros((C, T, F, nv, nv))
        Abb = np.zeros((C, T, F, nv, nv))
        cv = np.asarray(space.storage.cell_vertices[
            : C])[..., :dim]
        J = (cv[:, 1:, :] - cv[:, :1, :])
        offs = micro.offsets(dim).astype(np.float64)
        for t in range(T):
            for f in range(F):
                fv = facet_verts[t, f]
                fverts = ev[:, t][:, fv, :]  # (C, d, dim)
                pts, wts, area = _facet_quad(fverts)  # (C,Q,dim),(C,Q),(C,)
                t2, s = int(nbr_class[t, f]), nbr_shift[t, f]
                nverts = cv[:, :1, :] + np.einsum(
                    "vd,cde->cve", offs[t2] + s, J) / space.n
                gs = g_self[:, t]  # (C, nv, dim)
                gn, vol_n = _p1_basis_grads(nverts)
                phi_s = _p1_basis_at(ev[:, t], pts)  # (C, Q, nv)
                phi_n = _p1_basis_at(nverts, pts)
                # outward normal of self facet
                centroid_s = ev[:, t].mean(axis=1)
                if dim == 2:
                    e = fverts[:, 1] - fverts[:, 0]
                    nrm = np.stack([e[:, 1], -e[:, 0]], axis=-1)
                else:
                    nrm = np.cross(fverts[:, 1] - fverts[:, 0],
                                   fverts[:, 2] - fverts[:, 0])
                nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
                flip = np.sign(np.einsum(
                    "cd,cd->c", nrm, centroid_s - fverts[:, 0]))
                nrm *= -np.where(flip == 0, 1.0, flip)[:, None]
                dgs = np.einsum("cad,cd->ca", gs, nrm)  # grad phi_s . n
                dgn = np.einsum("cad,cd->ca", gn, nrm)
                h = dim * np.minimum(vol_self[:, t], vol_n) / np.maximum(
                    area, 1e-300)
                pen = (self.sigma / h)[:, None, None]
                Iss = np.einsum("cq,cqa,cqb->cab", wts, phi_s, phi_s)
                Isn = np.einsum("cq,cqa,cqb->cab", wts, phi_s, phi_n)
                ws = np.einsum("cq,cqa->ca", wts, phi_s)  # int phi_s
                wn = np.einsum("cq,cqa->ca", wts, phi_n)
                # interior SIP rows for v = phi_i^self
                App[:, t, f] = (-0.5 * ws[:, :, None] * dgs[:, None, :]
                                - 0.5 * dgs[:, :, None] * ws[:, None, :]
                                + pen * Iss)
                Apm[:, t, f] = (-0.5 * ws[:, :, None] * dgn[:, None, :]
                                + 0.5 * dgs[:, :, None] * wn[:, None, :]
                                - pen * Isn)
                # boundary (Nitsche-Dirichlet, g = 0) rows
                Abb[:, t, f] = (-ws[:, :, None] * dgs[:, None, :]
                                - dgs[:, :, None] * ws[:, None, :]
                                + pen * Iss)
        for name, a in (("App", App), ("Apm", Apm), ("Abb", Abb)):
            self.register_buffer(name, space._tensor(a))
        # volume stiffness per class
        Kv = vol_self[..., None, None] * np.einsum(
            "ctad,ctbd->ctab", g_self, g_self)
        self.register_buffer("Kvol", space._tensor(Kv))
        self._nbr = (nbr_class, nbr_shift)
        # cross-macro facet coupling (boundary-sized gather correction)
        cross = _boundary_facets(space, Abb, self.sigma)
        self.has_cross = cross is not None
        if self.has_cross:
            si, ni, Appx, Apmx, Abbx = cross
            i64 = lambda a: torch.as_tensor(a, device=space.device)
            self.register_buffer("cross_self", i64(si))
            self.register_buffer("cross_nbr", i64(ni))
            self.register_buffer("cross_self_mat", space._tensor(Appx - Abbx))
            self.register_buffer("cross_nbr_mat", space._tensor(Apmx))

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        return self.apply(u)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """u, out: (C, T, n..., nv)."""
        sp = self.space
        dim, T, F = sp.dim, sp.T, sp.dim + 1
        masks = _nbr_mask_tensors(sp.level, dim, u.dtype, u.device)
        nbr_class, nbr_shift = self._nbr

        def mul(M, v):
            # M: (C, nv, nv) per class slice; v: (C, n..., nv)
            return torch.einsum("cab,c...b->c...a", M, v)

        out = torch.empty_like(u)
        for t in range(T):
            acc = mul(self.Kvol[:, t], u[:, t])
            for f in range(F):
                mi, mb = masks[(t, f)]
                mi, mb = mi[None, ..., None], mb[None, ..., None]
                t2, s = int(nbr_class[t, f]), nbr_shift[t, f]
                un = _shift_elem(u[:, t2], s, dim)
                acc = acc + mi * (mul(self.App[:, t, f], u[:, t])
                                  + mul(self.Apm[:, t, f], un))
                acc = acc + mb * mul(self.Abb[:, t, f], u[:, t])
            out[:, t] = acc
        if self.has_cross:
            # macro-interface facets: replace the Nitsche boundary term by
            # the true SIP interior coupling with the neighbor cell; an
            # element may own several such facets (repeated indices add)
            nvv = u.shape[-1]
            uf = u.reshape(-1, nvv)
            corr = (torch.einsum("bij,bj->bi", self.cross_self_mat,
                                 uf[self.cross_self])
                    + torch.einsum("bij,bj->bi", self.cross_nbr_mat,
                                   uf[self.cross_nbr]))
            out.view(-1, nvv).index_add_(0, self.cross_self, corr)
        return out * sp._weight(u.dtype)


class P0UpwindAdvectionOperator(nn.Module):
    """First-order upwind finite-volume advection of a P0 field
    (reference: upwind DG transport in src/hyteg/composites/ and the P0
    transport operators). ``apply`` returns the weak divergence
    sum_F flux_F (multiply by 1/|K| for the semi-discrete time derivative);
    inflow boundary values default to zero."""

    def __init__(self, space: VolumeDoFSpace, velocity):
        assert space.ndofs == 1
        super().__init__()
        self.space = space
        dim = space.dim
        nbr_class, nbr_shift, facet_verts = facet_tables(dim)
        ev, _ = _rep_elem_verts(space)
        C, T = ev.shape[0], ev.shape[1]
        F = dim + 1
        an = np.zeros((C, T, F))
        for t in range(T):
            for f in range(F):
                fverts = ev[:, t][:, facet_verts[t, f], :]
                if dim == 2:
                    e = fverts[:, 1] - fverts[:, 0]
                    nrm = np.stack([e[:, 1], -e[:, 0]], axis=-1)
                    area = np.linalg.norm(e, axis=-1)
                    nrm /= np.maximum(
                        np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-300)
                else:
                    cr = np.cross(fverts[:, 1] - fverts[:, 0],
                                  fverts[:, 2] - fverts[:, 0])
                    area = 0.5 * np.linalg.norm(cr, axis=-1)
                    nrm = cr / np.maximum(
                        np.linalg.norm(cr, axis=-1, keepdims=True), 1e-300)
                centroid_s = ev[:, t].mean(axis=1)
                flip = np.sign(np.einsum(
                    "cd,cd->c", nrm, centroid_s - fverts[:, 0]))
                nrm *= -np.where(flip == 0, 1.0, flip)[:, None]
                fc = fverts.mean(axis=1)  # facet centroid (C, dim)
                if callable(velocity):
                    a = np.asarray(velocity(fc))
                else:
                    a = np.broadcast_to(np.asarray(velocity, dtype=float),
                                        fc.shape)
                an[:, t, f] = area * np.einsum("cd,cd->c", a, nrm)
        self.register_buffer("an", space._tensor(an))
        self._nbr = (nbr_class, nbr_shift)

    def forward(self, u: torch.Tensor, inflow=0.0) -> torch.Tensor:
        return self.apply(u, inflow)

    def apply(self, u: torch.Tensor, inflow=0.0) -> torch.Tensor:
        sp = self.space
        dim, T, F = sp.dim, sp.T, sp.dim + 1
        masks = _nbr_mask_tensors(sp.level, dim, u.dtype, u.device)
        nbr_class, nbr_shift = self._nbr
        out = torch.empty_like(u)
        for t in range(T):
            acc = torch.zeros_like(u[:, t])
            for f in range(F):
                mi, mb = masks[(t, f)]
                mi, mb = mi[None], mb[None]
                t2, s = int(nbr_class[t, f]), nbr_shift[t, f]
                un = _shift_elem(u[:, t2], s, dim)
                a = self.an[:, t, f].reshape((-1,) + (1,) * dim)
                apos, aneg = a.clamp(min=0.0), a.clamp(max=0.0)
                acc = acc + mi * (apos * u[:, t] + aneg * un)
                acc = acc + mb * (apos * u[:, t] + aneg * inflow)
            out[:, t] = acc
        return out * sp._weight(u.dtype)

    def step(self, u: torch.Tensor, dt: float, inflow=0.0) -> torch.Tensor:
        """Forward-Euler FV step: u - dt/|K| * sum_F flux_F."""
        div = self.apply(u, inflow)
        vols = self.space.elem_volumes
        return u - dt * torch.where(vols > 0, div / torch.where(
            vols > 0, vols, 1.0), 0.0)
