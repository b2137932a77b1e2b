"""N1E1 (edge-element) grid transfers: Whitney-form interpolation; torch
counterpart of hyteg_tpu/operators/n1e1_transfer.py.

Reference: src/hyteg/gridtransferoperators/N1E1toN1E1Prolongation.cpp,
N1E1toN1E1Restriction.cpp. The canonical H(curl) prolongation takes the
coarse Whitney field u_c = sum_E c_E W_E and assigns every fine edge its
circulation. W_E . t is linear along any segment, so the midpoint rule is
exact:

    (P c)_e = W(x_mid(e)) . vec(e).

On the doubled-grid layout (functions/n1e1.py: edge DoFs at odd nodes of
the level+1 node grid) the map is a period-4 stencil: a fine edge's
geometry relative to its containing coarse micro-tet depends only on its
doubled-grid coordinates mod 4, so the weights form a closed-form table
{(m4 pattern, offset delta) -> weight} (numpy, copied from the JAX
package). The apply is masked zero-filled shifts of the even-embedded
coarse block on the exact (C, M, M, pitch) views; embedding and sampling
are stride-2 views, where the JAX package contracts one-hot band
matrices. Restriction is the exact transpose, with the interface prescale
by 1/multiplicity and the additive exchange. Per-cell canonical
orientation signs enter as sign fields on both sides. Float32 products
throughout (TF32 is off), as the JAX package's ``Precision.HIGHEST``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..functions import n1e1 as n1
from ..functions.n1e1 import N1E1Space
from ..indexing import micro


@functools.lru_cache(maxsize=None)
def _locate_class(frac: tuple) -> int:
    """Micro-element class whose closed reference tet contains ``frac``
    (coords in [0, 1]^3 of the unit micro-cube); ties broken by the
    largest minimum barycentric coordinate (consistent everywhere)."""
    offs = micro.offsets(3)
    x = np.asarray(frac, dtype=np.float64)
    best, best_t = -np.inf, -1
    for t in range(offs.shape[0]):
        V = offs[t].astype(np.float64)  # (4, 3)
        J = (V[1:] - V[:1]).T
        lam123 = np.linalg.solve(J, x - V[0])
        lam = np.concatenate([[1.0 - lam123.sum()], lam123])
        m = lam.min()
        if m > best + 1e-12:
            best, best_t = m, t
    assert best > -1e-9, f"point {frac} outside all classes"
    return best_t


@functools.lru_cache(maxsize=None)
def whitney_stencil_table():
    """{(m4 pattern, delta) -> weight} for the N1E1 prolongation.

    m4: fine doubled-grid coords mod 4 of the fine edge midpoint (odd
    pattern); delta: fine-doubled offset to the coarse edge's embedded
    position (2 * coarse odd node - fine node); weight: against the
    coarse edge DoF in its +d_parity local orientation, producing the
    fine DoF in its +d_parity local orientation. Scale-free (Whitney
    values ~ 1/h_c cancel the ~h_c fine edge length)."""
    offs = micro.offsets(3)
    node_offs, par_idx, s_local = n1.edge_tables(3)
    dirs = n1.directions(3)
    pars = n1.parities(3)
    table: dict = {}
    for m4 in np.ndindex(4, 4, 4):
        p = tuple(v % 2 for v in m4)
        if p == (0, 0, 0):
            continue  # even node: not an edge midpoint
        k = next(i for i in range(len(pars)) if tuple(pars[i]) == p)
        d = dirs[k].astype(np.float64)
        frac = tuple(v / 4.0 for v in m4)  # in micro-cube units (h_c = 1)
        t = _locate_class(frac)
        V = offs[t].astype(np.float64)
        J = (V[1:] - V[:1]).T
        Jinv = np.linalg.inv(J)
        lam123 = Jinv @ (np.asarray(frac) - V[0])
        lam = np.concatenate([[1.0 - lam123.sum()], lam123])
        G = np.vstack([-Jinv.sum(axis=0), Jinv])  # (4, 3) barycentric grads
        # fine edge vector in micro-cube units: d / 2 (half a coarse edge)
        vec = d / 2.0
        entries = []
        for e, (a, b) in enumerate(n1._local_edges(3)):
            w = (lam[a] * G[b] - lam[b] * G[a]) @ vec
            w = w * s_local[t, e]
            if abs(w) < 1e-14:
                continue
            delta = tuple(int(2 * no - m) for no, m in
                          zip(node_offs[t, e], m4))
            entries.append((delta, float(w)))
        table[m4] = entries
    return table


@functools.lru_cache(maxsize=None)
def _grouped_terms():
    """[(m4 pattern, delta, weight)] flattened, grouped by delta for
    shared shifted reads."""
    by_delta: dict = {}
    for m4, entries in whitney_stencil_table().items():
        for delta, w in entries:
            by_delta.setdefault(delta, []).append((m4, w))
    return tuple(sorted(by_delta.items()))


def _shift3(u: torch.Tensor, d) -> torch.Tensor:
    """out[p] = u[p + d] on the trailing 3 axes of a 4D view, zero fill."""
    if not any(int(v) for v in d):
        return u
    out = torch.zeros_like(u)
    dst, src = [slice(None)] * u.ndim, [slice(None)] * u.ndim
    for i, dv in enumerate(d):
        ax, dv, n = u.ndim - 3 + i, int(dv), u.shape[u.ndim - 3 + i]
        if abs(dv) >= n:
            return out
        dst[ax] = slice(max(0, -dv), n - max(0, dv))
        src[ax] = slice(max(0, dv), n + min(0, dv))
    out[tuple(dst)] = u[tuple(src)]
    return out


class N1E1Transfer(nn.Module):
    """Prolongation/restriction between N1E1 levels on one storage. The
    per-delta weight fields and the sign fields are registered buffers."""

    def __init__(self, coarse: N1E1Space, fine: N1E1Space):
        super().__init__()
        assert fine.level == coarse.level + 1
        assert fine.storage is coarse.storage
        self.coarse = coarse
        self.fine = fine
        self.deltas = tuple(delta for delta, _ in _grouped_terms())
        self.register_buffer("weights", fine.node_space._tensor(
            np.stack(self._delta_weights())))
        self.register_buffer("sign_fine", self._sign_field(fine))
        self.register_buffer("sign_coarse", self._sign_field(coarse))

    # -- static fields --------------------------------------------------------

    def _delta_weights(self) -> list:
        """Per delta (in ``_grouped_terms`` order): the (Mf, lanes) field
        sum_m4 w * [fine edge node with coords = m4 mod 4]."""
        fsp = self.fine
        M, P = fsp.M, fsp.node_space.pitch
        ly = np.arange(M * P) // P
        lz = np.arange(M * P) % P
        xs = np.arange(M)[:, None]
        em = fsp.edge_mask
        out = []
        for _, users in _grouped_terms():
            acc = np.zeros((M, M * P), dtype=np.float32)
            for m4, w in users:
                m = ((xs % 4 == m4[0]) & (ly[None] % 4 == m4[1])
                     & (lz[None] % 4 == m4[2]) & em)
                acc = acc + np.float32(w) * m.astype(np.float32)
            out.append(acc)
        return out

    @staticmethod
    def _sign_field(space: N1E1Space) -> torch.Tensor:
        """(C, M, lanes) canonical<->local orientation signs (1 off-edge)."""
        ns = space.node_space
        signs = ns._tensor(space.parity_signs(0))  # (C, P)
        masks = space.parity_masks_t
        field = torch.einsum("cp,pml->cml", signs,
                             masks.reshape(masks.shape[0], space.M, -1))
        return torch.where(space.edge_mask_t[None] > 0, field, 1.0)

    # -- embed / sample -------------------------------------------------------

    @staticmethod
    def _view(u, sp: N1E1Space):
        M, P = sp.M, sp.node_space.pitch
        return u.reshape(u.shape[0], M, M, P)

    def _expand(self, gc):
        """Coarse node view -> fine-sized view, values at doubled coords."""
        fsp = self.fine
        Mf, Pf = fsp.M, fsp.node_space.pitch
        e = gc.new_zeros((gc.shape[0], Mf, Mf, Pf))
        nx, ny, nz = ((k + 1) // 2 for k in (Mf, Mf, Pf))
        e[:, ::2, ::2, ::2] = gc[:, :nx, :ny, :nz]
        return e

    def _decimate(self, gf):
        csp = self.coarse
        Mc, Pc = csp.M, csp.node_space.pitch
        s = gf[:, ::2, ::2, ::2][:, :Mc, :Mc, :Pc]
        rc = gf.new_zeros((gf.shape[0], Mc, Mc, Pc))
        rc[:, :, : s.shape[2], : s.shape[3]] = s
        return rc

    # -- prolongation ---------------------------------------------------------

    def prolongate_local(self, uc: torch.Tensor) -> torch.Tensor:
        """(C, Mc, Lc) canonical coarse DoFs -> (C, Mf, Lf) fine."""
        uloc = uc * self.sign_coarse  # canonical -> local (+d) orientation
        e = self._expand(self._view(uloc, self.coarse))
        out = None
        for i, delta in enumerate(self.deltas):
            r = _shift3(e, delta).reshape(e.shape[0], e.shape[1], -1)
            term = self.weights[i] * r
            out = term if out is None else out + term
        return out * self.sign_fine  # local -> canonical

    def prolongate(self, uc, sd_fine=None):
        return self.prolongate_local(uc)

    def prolongate_and_add(self, uc, uf, sd_fine=None):
        return uf + self.prolongate_local(uc)

    # -- restriction (exact transpose) ---------------------------------------

    def _scale_slots(self, rf, sd_f):
        """Interface replicas times 1/multiplicity: the JAX package's
        ``fl.at[sf].set(fl[idx] * inv, mode="drop")``, with its in-range
        mask explicit (the port's slot tables hold valid slots only, so
        the mask keeps them all)."""
        fl = rf.reshape(-1).clone()
        sf, inv = sd_f.slot_flat, sd_f.slot_inv_mult.to(rf.dtype)
        keep = sf < fl.shape[0]
        idx = torch.minimum(sf, torch.full_like(sf, fl.shape[0] - 1))
        fl[sf[keep]] = (fl[idx] * inv)[keep]
        return fl.reshape(rf.shape)

    def restrict(self, rf: torch.Tensor, sd_fine=None,
                 sd_coarse=None) -> torch.Tensor:
        fsp, csp = self.fine, self.coarse
        nsp_f, nsp_c = fsp.node_space, csp.node_space
        sd_f = nsp_f.resolve_sd(sd_fine)
        sd_c = nsp_c.resolve_sd(sd_coarse)
        rfs = self._scale_slots(rf, sd_f) * self.sign_fine
        acc_f = None
        for i, delta in enumerate(self.deltas):
            term = _shift3(self._view(self.weights[i] * rfs, fsp),
                           tuple(-v for v in delta))
            acc_f = term if acc_f is None else acc_f + term
        rc = self._decimate(acc_f).reshape(acc_f.shape[0], csp.M, -1)
        rc = rc * self.sign_coarse * csp.edge_mask_t[None]
        return nsp_c._exchange_add_(rc, sd_c)  # rc is fresh
