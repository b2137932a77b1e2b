"""EG vector Laplace with Nitsche boundary terms (first slice); torch
counterpart of hyteg_tpu/operators/eg_ops.py.

Reference: src/hyteg/egfunctionspace/ (EGOperators + the generated
Nitsche forms; ~180k LoC of generated code in the reference collapses
into one symmetric-interior-penalty assembly over the enrichment).

Discretization: u = u_CG + c psi with [P1]^dim CG part and per-element
scalar c, psi_T(x) = x - m_T (grad psi_T = I).  Bilinear form

    a(u, v) = int grad u : grad v
            + SIP terms over facets for the discontinuous enrichment
              (jump [u] carries only the enrichment; the CG gradient
              enters the facet averages)
            + Nitsche terms on the domain boundary for the enrichment
              (the CG part keeps the strong/eliminated Dirichlet
              treatment of the rest of the framework).

First slice scope: exact on single-macro-cell storages (facet coupling
within one macro micro-grid; the cross-macro gather correction of
operators/dg_ops.py applies identically and is the natural next step).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.types import DoFType, FLAG_INNER
from ..functions.eg import EGFunction, EGSpace
from ..indexing import flat, micro
from .dg_ops import (_facet_quad, _nbr_mask_tensors, _p1_basis_grads,
                     _shift_elem, facet_tables)


def _read_p1(grid, off, n, dim):
    """R[b] = grid[b + off] on the (C, N, ..) P1 grid view, off in
    [-1, n+1]^dim, zero-filled (out-of-range reads are masked)."""
    src, dst = [slice(None)], [slice(None)]
    whole = True
    for d in range(dim):
        o = int(off[d])
        lo, hi = max(o, 0), min(o + n, grid.shape[1 + d])
        src.append(slice(lo, hi))
        dst.append(slice(lo - o, hi - o))
        whole = whole and lo - o == 0 and hi - o == n
    if whole:
        return grid[tuple(src)]
    r = grid.new_zeros((grid.shape[0],) + (n,) * dim)
    r[tuple(dst)] = grid[tuple(src)]
    return r


def _p1_grids(p1, blocks):
    """The exact (C, N, ..., N) grid views of P1 blocks."""
    if p1.dim == 3:
        return [flat.to_grid(v, p1.N, p1.pitch)[..., :p1.N] for v in blocks]
    return list(blocks)


def _scatter_p1(grid, v, off, n, dim):
    """grid[b + off] += v[b] in place, off in [0, 1]^dim."""
    sl = (slice(None),) + tuple(
        slice(int(off[d]), int(off[d]) + n) for d in range(dim))
    grid[sl] += v


class EGLaplaceOperator(nn.Module):
    """A(u, v) for the EG vector viscous block (single-macro slice).

    ``form="laplace"``: a(u, v) = int grad u : grad v  (+ SIP/Nitsche
    terms for the enrichment), the reference's EGSIPGLaplaceForm.
    ``form="epsilon"``: a(u, v) = int 2 eps(u) : eps(v) with the matching
    facet terms ({2 eps(u) n} fluxes), the reference's
    EGEpsilonFormNitscheBC (src/hyteg/egfunctionspace/
    EGNitscheBCEpsilonForms.hpp) — the viscous block of the EG-P0
    Stokes discretization (operators/eg_stokes.py).
    """

    def __init__(self, space: EGSpace, sigma: float | None = None,
                 form: str = "laplace"):
        assert form in ("laplace", "epsilon"), form
        super().__init__()
        self.form = form
        st = space.storage
        # exact only on a single macro cell: a multi-macro storage would
        # silently get Nitsche terms at interior macro interfaces and no
        # cross-macro facet coupling (dg_ops has the gather correction;
        # this first EG slice does not)
        assert st.cells_per_shard * st.num_shards == 1, \
            "EGLaplaceOperator supports single-macro-cell storages only"
        self.space = space
        dim = space.dim
        n = space.p0.n
        self.sigma = float(sigma if sigma is not None
                           else (6.0 if form == "laplace" else 12.0) * dim)
        nbr_class, nbr_shift, facet_verts = facet_tables(dim)
        self._nbr = (nbr_class, nbr_shift)
        T, F, nv = space.p0.T, dim + 1, dim + 1

        cv = np.asarray(st.cell_vertices)[..., :dim]
        C = cv.shape[0]
        v0 = cv[:, :1, :]
        J = cv[:, 1:, :] - v0
        offs = micro.offsets(dim).astype(np.float64)
        # representative element (base 0) of each class, per cell
        ev = v0[:, None] + np.einsum("tvd,cde->ctve", offs, J) / n
        g, vol = _p1_basis_grads(ev)  # (C, T, nv, dim), (C, T)
        self.register_buffer("g", space.p0._tensor(g))
        self.register_buffer("vol", space.p0._tensor(vol))

        # facet tables (translation-invariant within a cell/class)
        a_s = np.zeros((C, T, F))            # int n . psi_self
        a_n = np.zeros((C, T, F))            # int n . psi_nbr
        Pss = np.zeros((C, T, F))            # int psi_s . psi_s
        Psn = np.zeros((C, T, F))            # int psi_s . psi_n
        vb_s = np.zeros((C, T, F, dim))      # int psi_s (vector)
        vb_n = np.zeros((C, T, F, dim))      # int psi_n
        gn_n = np.zeros((C, T, F, nv))       # g_a^self . n
        gnn = np.zeros((C, T, F, nv))        # g_a^nbr . n
        pen = np.zeros((C, T, F))
        nrm_t = np.zeros((C, T, F, dim))     # unit outward normal (self)
        gB = np.zeros((C, T, F, nv, dim))    # neighbor basis gradients
        for t in range(T):
            ms = ev[:, t].mean(axis=1)  # self centroid (C, dim)
            for f in range(F):
                fv = facet_verts[t, f]
                fverts = ev[:, t][:, fv, :]
                pts, wts, area = _facet_quad(fverts)
                t2, s = int(nbr_class[t, f]), nbr_shift[t, f]
                nverts = v0 + np.einsum(
                    "vd,cde->cve", offs[t2] + s, J) / n
                g2, vol2 = _p1_basis_grads(nverts)
                mn = nverts.mean(axis=1)
                if dim == 2:
                    e = fverts[:, 1] - fverts[:, 0]
                    nrm = np.stack([e[:, 1], -e[:, 0]], axis=-1)
                else:
                    nrm = np.cross(fverts[:, 1] - fverts[:, 0],
                                   fverts[:, 2] - fverts[:, 0])
                nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
                flip = np.sign(np.einsum("cd,cd->c", nrm, ms - fverts[:, 0]))
                nrm *= -np.where(flip == 0, 1.0, flip)[:, None]
                psi_s = pts - ms[:, None, :]   # (C, Q, dim)
                psi_n = pts - mn[:, None, :]
                a_s[:, t, f] = np.einsum("cq,cqd,cd->c", wts, psi_s, nrm)
                a_n[:, t, f] = np.einsum("cq,cqd,cd->c", wts, psi_n, nrm)
                Pss[:, t, f] = np.einsum("cq,cqd,cqd->c", wts, psi_s, psi_s)
                Psn[:, t, f] = np.einsum("cq,cqd,cqd->c", wts, psi_s, psi_n)
                vb_s[:, t, f] = np.einsum("cq,cqd->cd", wts, psi_s)
                vb_n[:, t, f] = np.einsum("cq,cqd->cd", wts, psi_n)
                gn_n[:, t, f] = np.einsum("cad,cd->ca", g[:, t], nrm)
                gnn[:, t, f] = np.einsum("cad,cd->ca", g2, nrm)
                nrm_t[:, t, f] = nrm
                gB[:, t, f] = g2
                h = dim * np.minimum(vol[:, t], vol2) / np.maximum(
                    area, 1e-300)
                pen[:, t, f] = self.sigma / h
        for name, a in (("a_s", a_s), ("a_n", a_n), ("Pss", Pss),
                        ("Psn", Psn), ("vb_s", vb_s), ("vb_n", vb_n),
                        ("gn", gn_n), ("gnn", gnn), ("pen", pen),
                        ("nrm", nrm_t), ("gB", gB)):
            self.register_buffer(name, space.p0._tensor(a))
        self.register_buffer("base_masks", space.p0._tensor(
            space.p0.base_mask.astype(np.float32)))

    def forward(self, u: EGFunction) -> EGFunction:
        return self.apply(u)

    # -- apply ---------------------------------------------------------------

    def apply(self, u: EGFunction) -> EGFunction:
        """Full EG operator apply (partial sums exchanged on the CG part;
        Dirichlet handling is the caller's restore_rows, as elsewhere)."""
        sp = self.space
        dim, n = sp.dim, sp.p0.n
        p1 = sp.p1
        N = p1.N
        T, F, nv = sp.p0.T, dim + 1, dim + 1
        offs = micro.offsets(dim)
        nbr_class, nbr_shift = self._nbr
        masks = _nbr_mask_tensors(sp.level, dim, u.enr.dtype, u.enr.device)

        # CG grid views; the results are written through the grid views
        # of fresh flat blocks
        grids = _p1_grids(p1, u.vel)
        out_v = [torch.zeros_like(v) for v in u.vel]
        out_g = _p1_grids(p1, out_v)
        out_e = torch.zeros_like(u.enr)
        sh = (slice(None),) + (None,) * dim  # broadcast (C,) over bases
        # fac doubles the enrichment coupling terms for the epsilon form
        # (2 eps(psi) = 2 I vs grad psi = I); eps switches on the
        # transposed-gradient pieces of the {2 eps(u) n} facet fluxes
        eps = 1.0 if self.form == "epsilon" else 0.0
        fac = 1.0 + eps

        for t in range(T):
            base_mask = self.base_masks[t][None]
            # element-local CG reads: (nv, dim) fields over bases
            rc = [[_read_p1(grids[d], offs[t, a], n, dim)
                   for d in range(dim)] for a in range(nv)]
            ue = u.enr[:, t]

            # volume: CG viscous block + div coupling + fac*dim*vol*c
            vol = self.vol[:, t][sh]
            g = self.g[:, t]  # (C, nv, dim)
            # epsilon extra: pd[e][d] = d_d u_e (constant per element)
            if eps:
                pd = [[sum(g[:, b2, d][sh] * rc[b2][e] for b2 in range(nv))
                       for d in range(dim)] for e in range(dim)]
            for a in range(nv):
                acc_d = []
                for d in range(dim):
                    acc = None
                    for b2 in range(nv):
                        gg = torch.einsum("ck,ck->c", g[:, a], g[:, b2])[sh]
                        term = vol * gg * rc[b2][d]
                        acc = term if acc is None else acc + term
                    if eps:
                        # + int grad u : grad v^T  (row (a,d) gets
                        #   vol * sum_e g[a,e] * d_d u_e)
                        acc = acc + vol * sum(
                            g[:, a, e][sh] * pd[e][d] for e in range(dim))
                    # div coupling: + fac * vol * g[a, d] * c
                    acc = acc + fac * vol * g[:, a, d][sh] * ue
                    acc_d.append(acc)
                for d in range(dim):
                    _scatter_p1(out_g[d], acc_d[d] * base_mask, offs[t, a],
                                n, dim)
            # e-row volume: fac*dim*vol*c + fac*sum_a,d vol*g[a,d]*u_c
            acc_e = fac * dim * vol * ue
            for a in range(nv):
                for d in range(dim):
                    acc_e = acc_e + fac * vol * g[:, a, d][sh] * rc[a][d]

            # facets
            for f in range(F):
                mi, mb = masks[(t, f)]
                mi, mb = mi[None], mb[None]
                t2, s = int(nbr_class[t, f]), nbr_shift[t, f]
                ue_n = _shift_elem(u.enr[:, t2], s, dim)
                rcn = [[_read_p1(grids[d],
                                 tuple(int(x) for x in
                                       (np.asarray(s) + offs[t2, a])),
                                 n, dim)
                        for d in range(dim)] for a in range(nv)]
                a_s = self.a_s[:, t, f][sh]
                a_n = self.a_n[:, t, f][sh]
                Pss = self.Pss[:, t, f][sh]
                Psn = self.Psn[:, t, f][sh]
                pen = self.pen[:, t, f][sh]
                vbs = self.vb_s[:, t, f]  # (C, dim)
                vbn = self.vb_n[:, t, f]
                gn = self.gn[:, t, f]     # (C, nv)
                gnn = self.gnn[:, t, f]

                # e-e interior SIP + boundary Nitsche (epsilon doubles
                # the consistency/symmetry fluxes, not the penalty)
                ee_int = ((-fac * a_s + pen * Pss) * ue
                          + (fac * (-0.5 * a_s + 0.5 * a_n)
                             - pen * Psn) * ue_n)
                ee_bnd = (-2.0 * fac * a_s + pen * Pss) * ue
                acc_e = acc_e + mi * ee_int + mb * ee_bnd

                # e <- CG: -{flux(u_c)} . int psi_s, flux = grad u . n
                # (laplace) or 2 eps(u) n (epsilon: adds (g_a.vb) n_d)
                if eps:
                    gvs = torch.einsum("cak,ck->ca", self.g[:, t], vbs)
                    gvn_s = torch.einsum("cak,ck->ca",
                                         self.gB[:, t, f], vbs)
                    gvb2 = torch.einsum("cak,ck->ca", self.g[:, t], vbn)
                    nn = self.nrm[:, t, f]  # (C, dim)
                ce = None
                for a in range(nv):
                    for d in range(dim):
                        ws = gn[:, a] * vbs[:, d]
                        wn = gnn[:, a] * vbs[:, d]
                        if eps:
                            ws = ws + gvs[:, a] * nn[:, d]
                            wn = wn + gvn_s[:, a] * nn[:, d]
                        w_i, w_in = -0.5 * ws[sh], -0.5 * wn[sh]
                        w_b = -ws[sh]
                        term = (mi * (w_i * rc[a][d] + w_in * rcn[a][d])
                                + mb * w_b * rc[a][d])
                        ce = term if ce is None else ce + term
                acc_e = acc_e + ce

                # CG <- e (symmetric): -{flux(v_c)} . [u_e]
                for a in range(nv):
                    for d in range(dim):
                        ws = gn[:, a] * vbs[:, d]
                        wn2 = gn[:, a] * vbn[:, d]
                        if eps:
                            ws = ws + gvs[:, a] * nn[:, d]
                            wn2 = wn2 + gvb2[:, a] * nn[:, d]
                        w_s = -0.5 * ws[sh]
                        w_nn = 0.5 * wn2[sh]
                        w_b = -ws[sh]
                        contrib = (mi * (w_s * ue + w_nn * ue_n)
                                   + mb * w_b * ue)
                        _scatter_p1(out_g[d], contrib * base_mask,
                                    offs[t, a], n, dim)

            out_e[:, t] = acc_e * base_mask

        # interface exchange of the flat P1 blocks (written in place)
        sd = p1.resolve_sd(None)
        vel = tuple(p1._exchange_add_(v, sd) for v in out_v)
        return EGFunction(vel, out_e * sp.p0._weight(out_e.dtype), sp)

    def apply_inner(self, u: EGFunction,
                    flag: DoFType = FLAG_INNER) -> EGFunction:
        """CG velocity rows restricted to ``flag`` (Dirichlet eliminated,
        as everywhere in the framework); enrichment rows always free."""
        sp = self.space
        y = self.apply(u)
        sd = sp.p1.resolve_sd(None)
        vel = tuple(sp.p1.restore_rows(v, torch.zeros_like(v), flag, sd)
                    for v in y.vel)
        return EGFunction(vel, y.enr, sp)
