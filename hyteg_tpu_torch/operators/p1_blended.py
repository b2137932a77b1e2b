"""P1 elementwise operators on blended (curved) geometry; torch counterpart
of hyteg_tpu/operators/p1_blended.py, plain torch on every device (the JAX
package has no Pallas kernel for it either).

Reference: the blending operator families (p1_diffusion_blending_q3 etc.,
src/hyteg/forms/form_hyteg_generated/) and P2P1ElementwiseBlendingStokes.
Blending is isoparametric-P1: the geometry map snaps every micro-vertex
onto the curved domain, and element matrices are computed per
micro-element from the *blended vertex coordinate field*: an exact
matrix-free variable-geometry apply (no stencil tables). The LSQP
surrogate (reference: P1SurrogateOperator) approximates it by polynomials.

The blended field is computed once, when an operator is built, and kept
on the device component-major, (dim, C, N, lanes); every apply recomputes
each class's element matrices from it. One per-class loop serves 2D and
3D: the class's vertex fields are shifted reads of the blended field, the
element matrices come from the form (the Laplace form component-wise,
``laplace_elmats_scalar``), and the rows are written with shifted adds.
Elements outside a class's base mask read zero coordinates past the block
and give NaN element matrices, so they are dropped with ``torch.where``,
never with a product by the mask.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..core.types import DoFType, FLAG_INNER
from ..functions.p1 import P1Space
from ..geometry.maps import GeometryMap
from ..indexing import flat, micro
from ..kernels.p1_stencil import _class_masks
from . import forms


def blended_coords(space: P1Space, gmap: GeometryMap,
                   shard: int = 0) -> torch.Tensor:
    """(C, N..., 3) micro-vertex coordinates on the blended geometry."""
    return gmap.apply(space.coords(shard), space._ref_coords,
                      space._tensor(space.cell_vertices(shard)))


def blended_components(space: P1Space, gmap: GeometryMap,
                       shard: int = 0) -> torch.Tensor:
    """(dim, C, N, lanes) blended coordinates, component-major (a 2D mesh's
    z = 0 dropped): the field the blended operators keep."""
    co = blended_coords(space, gmap, shard)
    return co.movedim(-1, 0)[:space.dim].contiguous()


def laplace_elmats_scalar(verts):
    """Laplace element matrices from component-wise vertex fields.

    verts: nested [b][j] of (...) tensors (nv = dim + 1 vertices x dim
    components); returns nested [a][b] of (...) tensors, every op on the
    large fields (``forms.laplace_form`` evaluates on trailing (nv, dim)
    axes instead). det == 0 (an element of zero coordinates past the
    block) gives zero gradients, not inf."""
    dim = len(verts) - 1
    # J[j][k] = component j of edge k = verts[k + 1][j] - verts[0][j]
    J = [[verts[k + 1][j] - verts[0][j] for k in range(dim)]
         for j in range(dim)]
    if dim == 2:
        cof = [[J[1][1], -J[1][0]], [-J[0][1], J[0][0]]]
    else:
        cof = [[None] * 3 for _ in range(3)]
        for j in range(3):
            j1, j2 = [r for r in range(3) if r != j]
            for k in range(3):
                k1, k2 = [c for c in range(3) if c != k]
                m = J[j1][k1] * J[j2][k2] - J[j1][k2] * J[j2][k1]
                cof[j][k] = m if (j + k) % 2 == 0 else -m
    det = J[0][0] * cof[0][0]
    for k in range(1, dim):
        det = det + J[0][k] * cof[0][k]
    inv_det = 1.0 / torch.where(det == 0, 1.0, det)
    # grad lambda_(k+1) = row k of J^-1 = cof[:, k] / det
    g = [[cof[j][k] * inv_det for j in range(dim)] for k in range(dim)]
    g0 = [-sum(g[k][j] for k in range(dim)) for j in range(dim)]
    grads = [g0] + g
    vol = det.abs() / (6.0 if dim == 3 else 2.0)
    nv = dim + 1
    el = [[None] * nv for _ in range(nv)]
    for a in range(nv):
        for b in range(a, nv):
            s = grads[a][0] * grads[b][0]
            for j in range(1, dim):
                s = s + grads[a][j] * grads[b][j]
            el[a][b] = el[b][a] = vol * s
    return el


#: forms with a component-wise evaluation
_SCALAR_FORMS = {forms.laplace_form: laplace_elmats_scalar}


def _class_elmats(comps, t: int, dim: int, pitch: int, form):
    """Nested [a][b] (C, N, lanes) element-matrix fields of class ``t`` at
    every base, from the blended field ``comps`` (dim, C, N, lanes)."""
    offs = micro.offsets(dim)
    verts = [flat.shift_read(comps, offs[t, b], pitch, dim)
             for b in range(dim + 1)]  # each (dim, C, N, lanes)
    scalar = _SCALAR_FORMS.get(form)
    if scalar is not None:
        return scalar(verts)
    el = form(torch.stack([v.movedim(0, -1) for v in verts], dim=-2))
    return [[el[..., a, b] for b in range(dim + 1)] for a in range(dim + 1)]


def _pitch(level: int, dim: int, pitch) -> int:
    N = (1 << level) + 1
    return N if (pitch is None or dim == 2) else pitch


def p1_apply_local_vargeom(src, comps, level: int, dim: int, form,
                           pitch: int | None = None) -> torch.Tensor:
    """Per-cell partial apply with per-micro-element geometry.

    src: (C, N, lanes); comps: (dim, C, N, lanes) blended vertex field;
    form: (..., nv, dim) -> (..., nv, nv). Each class's temporaries are
    freed before the next class."""
    pitch = _pitch(level, dim, pitch)
    offs = micro.offsets(dim)
    T, nv = offs.shape[:2]
    masks = _class_masks(level, dim, pitch, src.dtype, src.device)
    dst = torch.zeros_like(src)
    for t in range(T):
        el = _class_elmats(comps, t, dim, pitch, form)
        reads = [flat.shift_read(src, offs[t, b], pitch, dim)
                 for b in range(nv)]
        keep = masks[t] > 0
        for a in range(nv):
            acc = el[a][0] * reads[0]
            for b in range(1, nv):
                acc.addcmul_(el[a][b], reads[b])
            # where (not *): el is NaN on elements past the block
            dst += flat.shift_write(torch.where(keep, acc, 0.0), offs[t, a],
                                    pitch, dim)
        del el, reads
    return dst


def p1_diagonal_local_vargeom(comps, level: int, dim: int, form, block_shape,
                              pitch: int | None = None) -> torch.Tensor:
    """Per-cell partial diagonal with per-micro-element geometry."""
    pitch = _pitch(level, dim, pitch)
    offs = micro.offsets(dim)
    T, nv = offs.shape[:2]
    masks = _class_masks(level, dim, pitch, comps.dtype, comps.device)
    dst = torch.zeros(block_shape, dtype=comps.dtype, device=comps.device)
    for t in range(T):
        el = _class_elmats(comps, t, dim, pitch, form)
        keep = masks[t] > 0
        for a in range(nv):
            dst += flat.shift_write(torch.where(keep, el[a][a], 0.0),
                                    offs[t, a], pitch, dim)
        del el
    return dst


class P1BlendedOperator:
    """Variable-geometry P1 operator (exact, matrix-free)."""

    def __init__(self, space: P1Space, form, gmap: GeometryMap,
                 shard: int = 0):
        self.space = space
        self.form = form
        self.gmap = gmap
        self.shard = shard
        #: the blended micro-vertex field, (dim, C, N, lanes), built once
        self.comps = blended_components(space, gmap, shard)

    def apply_raw(self, x, sd=None) -> torch.Tensor:
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        y = p1_apply_local_vargeom(x, self.comps, sp.level, sp.dim,
                                   self.form, sp.pitch)
        return sp._exchange_add_(y, sd)  # y is fresh

    def apply_inner(self, x, sd_or_bc=None,
                    flag: DoFType = FLAG_INNER) -> torch.Tensor:
        sd = self.space.resolve_sd(sd_or_bc, self.shard)
        y = self.apply_raw(x, sd)
        if flag & DoFType.INNER:
            return self.space._restore_rows_(y, None, flag, sd)
        return self.space.restore_rows(y, torch.zeros_like(y), flag, sd)

    def diagonal_raw(self, sd=None) -> torch.Tensor:
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        d = p1_diagonal_local_vargeom(self.comps, sp.level, sp.dim, self.form,
                                      sp.block_shape, sp.pitch)
        return sp._exchange_add_(d, sd)

    def inverse_diagonal(self, sd=None) -> torch.Tensor:
        d = self.diagonal_raw(sd)
        ok = self.space.vertex_mask_t.bool() & (d != 0)
        return torch.where(ok, 1.0 / torch.where(d == 0, 1.0, d), 0.0)


# ---------------------------------------------------------------------------
# LSQP surrogate operator (reference: src/hyteg/polynomial/LSQPInterpolator,
# P1SurrogateOperator.hpp:36-118): approximate each (class, a, b) weight
# field of the blended operator by a low-degree polynomial in the reference
# coordinates, least-squares fitted per cell.
# ---------------------------------------------------------------------------


def _monomials(dim: int, degree: int) -> list[tuple[int, ...]]:
    return [p for p in itertools.product(range(degree + 1), repeat=dim)
            if sum(p) <= degree]


def _monomial_values(X: np.ndarray, monos) -> np.ndarray:
    """(..., n_mono) float64 monomials at points X (..., dim)."""
    X = np.asarray(X, dtype=np.float64)
    return np.stack([np.prod(X ** np.array(m), axis=-1) for m in monos],
                    axis=-1)


class P1SurrogateOperator:
    """Polynomial surrogate of a blended operator's element matrices.

    The exact per-(class, a, b) weight fields w(x) are sampled on each
    class's valid bases and fitted with total-degree-``degree`` polynomials
    per cell: the least-squares pseudo-inverse of the small monomial matrix
    is taken on the host in float64, the fit (its product with the sampled
    weights) runs on the device in float64. The apply evaluates the
    polynomials, (C, n_mono) @ (n_mono, N * lanes) products in float32,
    and runs the shifted accumulation. ``coeffs`` (a list per class of (C,
    n_mono, nv, nv)) and ``mono_fields`` ((n_mono, N, lanes)) skip the fit,
    e.g. carried over with interop.surrogate_from_reference."""

    def __init__(self, space: P1Space, form, gmap: GeometryMap | None,
                 degree: int = 2, shard: int = 0, *, coeffs=None,
                 mono_fields=None):
        self.space = space
        self.degree = degree
        self.shard = shard
        self.monos = _monomials(space.dim, degree)
        ref = space._ref_coords.cpu().numpy()  # (N, lanes, dim)
        if coeffs is None:
            coeffs = self._fit(form, gmap, ref)
        self._coeffs = [torch.as_tensor(c, dtype=space.dtype,
                                        device=space.device).contiguous()
                        for c in coeffs]
        if mono_fields is None:
            mono_fields = np.moveaxis(_monomial_values(ref, self.monos), -1, 0)
        self._mono_fields = torch.as_tensor(
            mono_fields, dtype=space.dtype,
            device=space.device).contiguous()  # (n_mono, N, lanes)

    def _fit(self, form, gmap, ref) -> list:
        sp = self.space
        dim, dev = sp.dim, sp.device
        comps = blended_components(sp, gmap, self.shard)
        nv = dim + 1
        out = []
        for t in range(micro.num_classes(dim)):
            sel = np.flatnonzero(
                micro.elem_base_mask_flat(sp.level, t, dim, sp.pitch))
            V = _monomial_values(ref.reshape(-1, dim)[sel], self.monos)
            pinv = torch.as_tensor(np.linalg.pinv(V), device=dev)  # f64
            idx = torch.as_tensor(sel, device=dev)
            el = _class_elmats(comps, t, dim, sp.pitch, form)
            Y = torch.stack([el[a][b].reshape(el[a][b].shape[0], -1)[:, idx]
                             for a in range(nv) for b in range(nv)], dim=-1)
            del el
            coefs = torch.matmul(pinv, Y.double())  # (C, n_mono, nv * nv)
            out.append(coefs.reshape(coefs.shape[:2] + (nv, nv)))
            del Y
        return out

    def apply_raw(self, x, sd=None) -> torch.Tensor:
        sp = self.space
        sd = sp.resolve_sd(sd, self.shard)
        dim = sp.dim
        offs = micro.offsets(dim)
        T, nv = offs.shape[:2]
        masks = _class_masks(sp.level, dim, sp.pitch, x.dtype, x.device)
        mono = self._mono_fields.reshape(self._mono_fields.shape[0], -1)
        dst = torch.zeros_like(x)
        for t in range(T):
            reads = [flat.shift_read(x, offs[t, b], sp.pitch, dim)
                     for b in range(nv)]
            keep = masks[t] > 0
            for a in range(nv):
                # row a's nv weight fields: (C, nv, n_mono) @ (n_mono, N*L)
                w = torch.matmul(self._coeffs[t][:, :, a, :].transpose(1, 2),
                                 mono).view((x.shape[0], nv) + x.shape[1:])
                acc = w[:, 0] * reads[0]
                for b in range(1, nv):
                    acc.addcmul_(w[:, b], reads[b])
                dst += flat.shift_write(torch.where(keep, acc, 0.0),
                                        offs[t, a], sp.pitch, dim)
            del reads
        return sp._exchange_add_(dst, sd)

    def compute_surrogate_error(self, exact_op: P1BlendedOperator,
                                x) -> torch.Tensor:
        """Relative L2 apply error against the exact blended operator
        (reference: P1SurrogateOperator::computeSurrogateError), a 0-dim
        tensor."""
        ye = exact_op.apply_raw(x)
        e = ye - self.apply_raw(x)
        sp = self.space
        return torch.sqrt(sp.dot(e, e) / torch.clamp(sp.dot(ye, ye),
                                                     min=1e-30))
