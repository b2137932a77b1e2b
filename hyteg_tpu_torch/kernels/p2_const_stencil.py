"""Constant-stencil P2 apply on the dense node grid (kernel B5).

Torch counterpart of hyteg_tpu/kernels/p2_const_stencil.py. On the
level-(L+1) node grid all P2 DoFs are nodes (functions/p2.py), so the P2
elementwise apply collapses into one stencil over the node grid with
*parity-resolved* weights: node p couples to p + s with weight

    c_s(p) = sum over {(t,A,B): O_t(A) == p (mod 2), O_t(B) - O_t(A) = s,
                        base (p - O_t(A))/2 valid in class t} elm[t,A,B]

Base validity mirrors the P1 constant stencil (kernels/p1_const_stencil.py):

  * shell: S(base) <= n - margin_t  <=>  S(p) <= 2n - j,
    j = max(0, 2 margin_t - S(O_A)) in {0, 1, 2} (the weight slot j);
  * coordinate faces: base_i >= 0 fails only for p_i = 0 with O_A_i = 2,
    corrected by inclusion-exclusion over G <= supp2(O_A) with sign
    (-1)^(|G|+1) (the face table E).

In 3D: 65 directions, 8 parities, 3 shell slots, 7 face groups; in 2D
(macro-faces, blocks (C, M, M)): 19 directions, 4 parities, 3 shell
slots, 3 face groups. The JAX package keeps the tables A (C, n_par, n_s,
3) and E (C, n_g, n_par, n_s, 3) and sums masked accumulators. Here both
tables are folded once per operator into one weight row per node class
(``p2_folded_weights``): a node's face set f (which coordinates are 0),
parity and shell key k = min(2, 2n - S) select a row of n_s weights,

    W[f, par, k, s] = sum_{j <= k} (A[par, s, j] - sum_{G <= f} E[G, par, s, j]),

and the apply is dst[p] = [p in the simplex] * sum_s W[row(p), s] src[p + s]
(192 rows of 65 in 3D, 48 rows of 19 in 2D). Reads follow
``flat.shift_read``: zero beyond the block on the x axis and on the lane
axis. The weights are pointwise exact up to rounding, so reads that leave
the simplex (or alias across a 3D lane row) meet zero weights.

``p2_const_apply`` launches the CUDA kernel ``csrc/p2_const_stencil.cu``
(3D) or its 2D form, each on f32 or bf16 storage, for a CUDA tensor and
runs the plain version ``p2_const_apply_torch`` for a CPU tensor.

bf16: the source is bf16 and W is rounded to its type (``bf16_weights``,
the contract of B2's bf16 form); the loads widen to f32, every sum runs in
f32, and the result is rounded to bf16 once. The JAX package's plain
``p2_const_apply_xla`` and its Pallas kernel round the tables A and E to
the source's type (``kernels/p2_const_stencil.py:409-410``); its bf16
operator sums them in bf16 (ROADMAP C-ref14).
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from ..indexing import flat, micro
from . import build
from .p1_const_stencil import _check_cuda_input, bf16_weights

N_SHELL = 3       # shell key k = min(2, 2n - S)


def _par_index(par) -> int:
    """Parity class of a node: its coordinates' parity bits, the first
    coordinate highest (x, y, z in 3D; x, z in 2D)."""
    return sum(int(b) << (len(par) - 1 - i) for i, b in enumerate(par))


def n_rows(dim: int) -> int:
    """Folded weight rows per cell: face sets x parities x shell keys
    (192 in 3D, 48 in 2D)."""
    return (1 << dim) * (1 << dim) * N_SHELL


@functools.lru_cache(maxsize=None)
def p2_stencil_tables(dim: int):
    """Static scatter tables for the parity-resolved P2 stencil.

    Returns (dirs (n_s, dim) int, rows, cols, n_par, n_j): the flat
    element-matrix entry rows[k] adds into weight slot cols[k] of the
    (n_par, n_s, n_j) table."""
    from ..operators.p2_elementwise import p2_node_offsets

    node_offs = p2_node_offsets(dim)
    margins = micro.base_margin(dim)
    T, nn = node_offs.shape[:2]
    dirset = sorted({tuple(int(x) for x in node_offs[t, B] - node_offs[t, A])
                     for t in range(T) for A in range(nn) for B in range(nn)})
    key = {d: i for i, d in enumerate(dirset)}
    n_par, n_j = 1 << dim, 3
    rows, cols = [], []
    for t in range(T):
        for A in range(nn):
            OA = node_offs[t, A]
            par = _par_index(tuple(int(x) % 2 for x in OA))
            j = max(0, 2 * int(margins[t]) - int(OA.sum()))
            assert j < n_j
            for B in range(nn):
                s = key[tuple(int(x) for x in node_offs[t, B] - OA)]
                rows.append((t * nn + A) * nn + B)
                cols.append((par * len(dirset) + s) * n_j + j)
    return (np.asarray(dirset, dtype=np.int64), np.asarray(rows, np.int64),
            np.asarray(cols, np.int64), n_par, n_j)


def p2_stencil_weights(elmats: torch.Tensor, dim: int) -> torch.Tensor:
    """(C, T, nn, nn) -> (C, n_par, n_s, n_j) parity/shell weights A."""
    dirs, rows, cols, n_par, n_j = p2_stencil_tables(dim)
    C, dev = elmats.shape[0], elmats.device
    A = torch.zeros((C, n_par * dirs.shape[0] * n_j), dtype=elmats.dtype,
                    device=dev)
    A.index_add_(1, torch.as_tensor(cols, device=dev),
                 elmats.reshape(C, -1)[:, torch.as_tensor(rows, device=dev)])
    return A.reshape(C, n_par, dirs.shape[0], n_j)


@functools.lru_cache(maxsize=None)
def p2_face_tables(dim: int):
    """Signed full-scheme face corrections over G <= {i: O_A_i == 2}.

    Returns (groups, rows, cols, signs) into the (n_g, n_par, n_s, n_j)
    table."""
    from ..operators.p2_elementwise import p2_node_offsets

    node_offs = p2_node_offsets(dim)
    margins = micro.base_margin(dim)
    T, nn = node_offs.shape[:2]
    dirs, _, _, n_par, n_j = p2_stencil_tables(dim)
    key = {tuple(int(x) for x in d): i for i, d in enumerate(dirs)}
    groups = []
    for r in range(1, dim + 1):
        groups.extend(itertools.combinations(range(dim), r))
    gidx = {G: i for i, G in enumerate(groups)}
    n_s = dirs.shape[0]
    rows, cols, signs = [], [], []
    for t in range(T):
        for A in range(nn):
            OA = node_offs[t, A]
            par = _par_index(tuple(int(x) % 2 for x in OA))
            j = max(0, 2 * int(margins[t]) - int(OA.sum()))
            supp2 = tuple(i for i in range(dim) if OA[i] == 2)
            for B in range(nn if supp2 else 0):
                s = key[tuple(int(x) for x in node_offs[t, B] - OA)]
                for r in range(1, len(supp2) + 1):
                    for G in itertools.combinations(supp2, r):
                        rows.append((t * nn + A) * nn + B)
                        cols.append(((gidx[G] * n_par + par) * n_s + s)
                                    * n_j + j)
                        signs.append(1.0 if r % 2 == 1 else -1.0)
    return (tuple(groups), np.asarray(rows, np.int64),
            np.asarray(cols, np.int64), np.asarray(signs, np.float64))


def p2_face_weights(elmats: torch.Tensor, dim: int) -> torch.Tensor:
    """(C, n_g, n_par, n_s, n_j) signed face-correction weights E."""
    groups, rows, cols, signs = p2_face_tables(dim)
    dirs, _, _, n_par, n_j = p2_stencil_tables(dim)
    C, dev = elmats.shape[0], elmats.device
    vals = elmats.reshape(C, -1)[:, torch.as_tensor(rows, device=dev)]
    vals = vals * torch.as_tensor(signs, dtype=elmats.dtype, device=dev)
    E = torch.zeros((C, len(groups) * n_par * dirs.shape[0] * n_j),
                    dtype=elmats.dtype, device=dev)
    E.index_add_(1, torch.as_tensor(cols, device=dev), vals)
    return E.reshape(C, len(groups), n_par, dirs.shape[0], n_j)


@functools.lru_cache(maxsize=None)
def _nz_tables(dim: int):
    """Structural nonzero masks of the A and E slots."""
    dirs, _, cols, n_par, n_j = p2_stencil_tables(dim)
    n_s = dirs.shape[0]
    nzm = np.zeros(n_par * n_s * n_j, dtype=bool)
    nzm[cols] = True
    groups, _, fcols, _ = p2_face_tables(dim)
    nzf = np.zeros(len(groups) * n_par * n_s * n_j, dtype=bool)
    nzf[fcols] = True
    return (nzm.reshape(n_par, n_s, n_j),
            nzf.reshape(len(groups), n_par, n_s, n_j))


@functools.lru_cache(maxsize=None)
def _mask_arrays_p2(level: int, dim: int, pitch: int):
    """Static (M, lanes) numpy float32 masks on the node grid: K0 (in the
    simplex), the shells S = 2n - m (m = 0, 1), the face indicators
    p_i = 0, and the 2^dim parity masks. A 2D block (M, M) has no pitch."""
    n = 1 << level
    M = 2 * n + 1
    xs = np.arange(M)[:, None]
    if dim == 3:
        y, z = flat.yz_maps(M, pitch)
        axes = (xs, y[None, :], z[None, :])
        in_z = axes[2] < M
    else:
        axes = (xs, np.arange(M)[None, :])
        in_z = True
    ssum = sum(axes)
    coords = [np.broadcast_to(c, ssum.shape) for c in axes]
    K0 = ((ssum <= 2 * n) & in_z).astype(np.float32)
    shells = tuple(((ssum == 2 * n - m) & in_z).astype(np.float32)
                   for m in range(2))
    faces = tuple((c == 0).astype(np.float32) * K0 for c in coords)
    pars = []
    for p in range(1 << dim):
        m = np.ones_like(K0)
        for i, c in enumerate(coords):
            m = m * (c % 2 == ((p >> (dim - 1 - i)) & 1))
        pars.append(m.astype(np.float32))
    return K0, shells, faces, tuple(pars)


# ---------------------------------------------------------------------------
# folded weights: one row of n_s per (face set, parity, shell key)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _face_subsets(dim: int) -> tuple:
    """For each face set f (bit i: coordinate i is 0), the groups G <= f."""
    groups, *_ = p2_face_tables(dim)
    return tuple(tuple(g for g, G in enumerate(groups)
                       if all((f >> i) & 1 for i in G))
                 for f in range(1 << dim))


def p2_folded_weights(A: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """(C, n_par, n_s, 3) A and (C, n_g, n_par, n_s, 3) E -> (C, rows, n_s)
    W[(f * n_par + par) * 3 + k, s] = sum_{j <= k} (A - sum_{G <= f} E)[par, s, j]
    (see the module docstring): (C, 192, 65) in 3D, (C, 48, 19) in 2D.
    Computed once per operator."""
    C, n_par = A.shape[:2]
    dim = n_par.bit_length() - 1
    rows = []
    for subset in _face_subsets(dim):
        EF = torch.zeros_like(A)
        for g in subset:
            EF = EF + E[:, g]
        rows.append(A - EF)
    D = torch.stack(rows, dim=1)                 # (C, f, par, s, j)
    W = D.cumsum(dim=-1).permute(0, 1, 2, 4, 3)  # (C, f, par, k, s)
    return W.reshape(C, n_rows(dim), A.shape[2]).contiguous()


@functools.lru_cache(maxsize=None)
def _row_index_np(level: int, dim: int,
                  pitch: int) -> tuple[np.ndarray, np.ndarray]:
    """(M, lanes) int64 weight-row index of every node and its K0 mask
    (rows of nodes outside the simplex are 0 and masked off)."""
    K0, shells, faces, pars = _mask_arrays_p2(level, dim, pitch)
    f = sum((1 << i) * m for i, m in enumerate(faces))
    par = sum(p * m for p, m in enumerate(pars))
    k = 2 - 2 * shells[0] - shells[1]
    row = np.where(K0 > 0, (f * len(pars) + par) * N_SHELL + k, 0)
    return row.astype(np.int64), K0


@functools.lru_cache(maxsize=8)
def _row_index(level: int, dim: int, pitch: int, dtype, device):
    row, K0 = _row_index_np(level, dim, pitch)
    return (torch.as_tensor(row, device=device),
            torch.as_tensor(K0, dtype=dtype, device=device))


def p2_const_apply_torch(src, W, level: int, pitch: int, dim: int = 3):
    """Plain-torch parity-stencil P2 apply (counterpart of hyteg_tpu's
    p2_const_apply_xla; partial sums on interface rows). src: (C, M,
    M*pitch) in 3D, (C, M, M) in 2D; W: (C, n_rows(dim), n_s) from
    p2_folded_weights.

    One direction at a time: gather the per-node weight of direction s
    from its row, multiply-add the shifted read. Three or four blocks are
    alive at once, not the n_s shifted reads of the JAX formulation, so it
    fits beside a GMG stack at level 6.

    A bf16 source: W rounded to bf16, the apply computed in f32 on the
    widened values, the result rounded to bf16 once (kernel B5's bf16
    rule)."""
    if src.dtype == torch.bfloat16:
        wide = lambda t: t.to(torch.bfloat16).to(torch.float32)
        return p2_const_apply_torch(wide(src), wide(W), level, pitch,
                                    dim).to(torch.bfloat16)
    dirs, *_ = p2_stencil_tables(dim)
    row, K0 = _row_index(level, dim, pitch, src.dtype, src.device)
    dst = torch.zeros_like(src)
    for s in range(dirs.shape[0]):
        w = W[:, :, s][:, row]  # (C, M, lanes)
        dst.addcmul_(w, flat.shift_read(src, tuple(int(v) for v in dirs[s]),
                                        pitch, dim))
    return dst.mul_(K0)


@functools.lru_cache(maxsize=None)
def _kernel_dirs(dim: int = 3) -> np.ndarray:
    """Host (n_s, dim) int32 stencil directions for the CUDA launcher:
    (65, 3) in 3D (the launcher refuses them unless they equal the
    kernel's compile-time list), (19, 2) in 2D."""
    dirs, *_ = p2_stencil_tables(dim)
    return np.ascontiguousarray(dirs, dtype=np.int32)


def p2_const_apply(src, W, level: int, pitch: int, dim: int = 3, out=None):
    """Per-cell parity-stencil P2 apply (partial sums on interface rows).

    src: (C, M, M*pitch) in 3D or (C, M, M) in 2D, M = 2^(level+1)+1; W:
    the (C, n_rows(dim), n_s) p2_folded_weights of the stencil tables A
    (p2_stencil_weights) and E (p2_face_weights); ``out``: an optional
    contiguous block like src that receives the result (every slot is
    written), e.g. one component of a stacked vector. A CPU tensor runs
    the plain version; a CUDA tensor launches kernel B5
    (csrc/p2_const_stencil.cu) and counts the launch in
    ``p2_const_apply.launches`` (3D) or ``p2_const_apply.launches_2d``.
    The storage may be f32 or bf16 in either dimension (a bf16 launch also
    counts in ``p2_const_apply.launches_bf16`` or ``launches_2d_bf16``);
    W follows ``bf16_weights`` on either device."""
    (W,) = bf16_weights(src, W)
    if src.device.type == "cpu":
        y = p2_const_apply_torch(src, W, level, pitch, dim)
        return y if out is None else out.copy_(y)
    M = (2 << level) + 1
    C = src.shape[0]
    dirs = _kernel_dirs(dim)
    lanes = M * pitch if dim == 3 else M
    dt = torch.bfloat16 if src.dtype == torch.bfloat16 else torch.float32
    _check_cuda_input("src", src, (C, M, lanes), dt)
    _check_cuda_input("W", W, (C, n_rows(dim), dirs.shape[0]), dt)
    if out is None:
        dst = torch.empty_like(src)
    else:
        _check_cuda_input("out", out, (C, M, lanes), dt)
        lo, hi = src.data_ptr(), src.data_ptr() + src.nbytes
        if lo < out.data_ptr() + out.nbytes and out.data_ptr() < hi:
            raise ValueError("out must not overlap src")
        dst = out
    lib = build.library()
    bf = "_bf16" if dt == torch.bfloat16 else ""
    if dim == 3:
        rc = getattr(lib, "hyteg_p2_const_apply" + bf)(
            src.data_ptr(), W.data_ptr(), dst.data_ptr(), C, M, pitch,
            dirs.ctypes.data, build.current_stream())
    else:
        rc = getattr(lib, "hyteg_p2_const_apply_2d" + bf)(
            src.data_ptr(), W.data_ptr(), dst.data_ptr(), C, M,
            dirs.ctypes.data, build.current_stream())
    build.check_launch(rc, "p2_const_apply")
    build.count_launch(p2_const_apply, dim, level)
    if bf:
        build.count_bf16(p2_const_apply, dim)
    return dst


p2_const_apply.launches = 0
p2_const_apply.launches_bf16 = 0
p2_const_apply.launches_2d = 0
p2_const_apply.launches_2d_bf16 = 0
p2_const_apply.launches_by_level = {}
p2_const_apply.launches_by_level_2d = {}
