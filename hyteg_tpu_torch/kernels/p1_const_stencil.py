"""Constant-stencil P1 apply: the 15-point-stencil fast path (kernel B2).

Torch counterpart of hyteg_tpu/kernels/p1_const_stencil.py. With
per-cell-constant element matrices the elementwise apply collapses into a
stencil, dst[p] = sum_s c_s(p) * src[p + s], whose weights depend on the
position only near the four macro-tet faces: the diagonal shell
S = x+y+z = n loses the terms of elements that would leave the tet, and
the coordinate faces p_i = 0 lose theirs by inclusion-exclusion over face
subsets G. The resulting weights are pointwise exact, so any read whose
target leaves the macro-tet carries a zero weight (up to rounding) —
provided the block's padding lanes hold zeros.

In 2D (macro-faces, blocks (C, N, N) with lane = z) the same scheme has 7
directions and the edge groups {x = 0}, {z = 0} and both.

``p1_const_apply`` launches the CUDA kernel ``csrc/p1_const_stencil.cu``
(its 3D or 2D form; in 3D also on bf16 storage) for a CUDA tensor and runs
the plain version ``p1_const_apply_torch`` for a CPU tensor.

bf16: the source is bf16 and the weights are rounded to its type (as the
JAX package's Pallas kernel rounds them); the loads widen to f32, every
sum runs in f32, and the result is rounded to bf16 once. The JAX
package's plain ``p1_const_apply_xla`` instead accumulates in bf16.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from ..indexing import flat, micro
from . import build


@functools.lru_cache(maxsize=None)
def stencil_tables(dim: int):
    """Static (t,a,b) -> (s, j) scatter tables.

    Returns (dirs (n_s, dim) int, tab (T*nv*nv, 2) int with columns
    (s_index, j), n_j)."""
    offs = micro.offsets(dim)  # (T, nv, dim)
    margins = micro.base_margin(dim)
    T, nv = offs.shape[0], offs.shape[1]
    dirs = micro.stencil_directions(dim)  # (n_s, dim), includes 0
    key = {tuple(int(x) for x in d): i for i, d in enumerate(dirs)}
    rows = []
    for t in range(T):
        for a in range(nv):
            j = int(margins[t]) - int(offs[t, a].sum())
            assert j >= 0
            for b in range(nv):
                s = tuple(int(x) for x in (offs[t, b] - offs[t, a]))
                rows.append((key[s], j))
    tab = np.asarray(rows, dtype=np.int64)
    return dirs, tab, int(tab[:, 1].max()) + 1


def stencil_weights(elmats: torch.Tensor, dim: int) -> torch.Tensor:
    """(C, T, nv, nv) element matrices -> (C, n_s, n_j) shell-resolved
    stencil weights A (scatter-add over static tables)."""
    dirs, tab, n_j = stencil_tables(dim)
    C = elmats.shape[0]
    idx = torch.as_tensor(tab[:, 0] * n_j + tab[:, 1], device=elmats.device)
    A = torch.zeros((C, dirs.shape[0] * n_j), dtype=elmats.dtype,
                    device=elmats.device)
    A.index_add_(1, idx, elmats.reshape(C, -1))
    return A.reshape(C, dirs.shape[0], n_j)


@functools.lru_cache(maxsize=None)
def _structural_nonzero(dim: int):
    """Which (s, j) slots receive any element-matrix entry (static)."""
    dirs, tab, n_j = stencil_tables(dim)
    nz = np.zeros((dirs.shape[0], n_j), dtype=bool)
    nz[tab[:, 0], tab[:, 1]] = True
    return nz


# ---------------------------------------------------------------------------
# coordinate-face corrections (inclusion-exclusion over face subsets)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def face_tables_full(dim: int):
    """Face corrections with G <= supp(off_a): they make the stencil
    weights pointwise exact regardless of read semantics (any read whose
    target leaves the macro-tet gets a zero total weight).

    Returns (groups, rows, cols, signs, n_j): element-matrix entry
    ``rows[k]`` adds ``signs[k]`` times itself at flat position ``cols[k]``
    of the (n_G, n_j, n_s) correction table."""
    offs = micro.offsets(dim)
    margins = micro.base_margin(dim)
    T, nv = offs.shape[0], offs.shape[1]
    dirs, _, n_j = stencil_tables(dim)
    key = {tuple(int(x) for x in d): i for i, d in enumerate(dirs)}
    groups = []
    for r in range(1, dim + 1):
        groups.extend(itertools.combinations(range(dim), r))
    gidx = {G: i for i, G in enumerate(groups)}
    rows, cols, signs = [], [], []
    for t in range(T):
        for a in range(nv):
            j = int(margins[t]) - int(offs[t, a].sum())
            supp = tuple(i for i in range(dim) if offs[t, a, i] == 1)
            if not supp:
                continue
            for b in range(nv):
                s = key[tuple(int(x) for x in offs[t, b] - offs[t, a])]
                src_row = (t * nv + a) * nv + b
                for r in range(1, len(supp) + 1):
                    for G in itertools.combinations(supp, r):
                        rows.append(src_row)
                        cols.append((gidx[G] * n_j + j) * len(dirs) + s)
                        signs.append(1.0 if (r % 2 == 1) else -1.0)
    return (
        tuple(groups),
        np.asarray(rows, dtype=np.int64),
        np.asarray(cols, dtype=np.int64),
        np.asarray(signs, dtype=np.float64),
        n_j,
    )


def face_weights_full(elmats: torch.Tensor, dim: int) -> torch.Tensor:
    """(C, n_G, n_j, n_s) signed full-scheme face corrections."""
    groups, rows, cols, signs, n_j = face_tables_full(dim)
    dirs, _, _ = stencil_tables(dim)
    C = elmats.shape[0]
    dev = elmats.device
    vals = elmats.reshape(C, -1)[:, torch.as_tensor(rows, device=dev)]
    vals = vals * torch.as_tensor(signs, dtype=elmats.dtype, device=dev)
    E = torch.zeros((C, len(groups) * n_j * dirs.shape[0]),
                    dtype=elmats.dtype, device=dev)
    E.index_add_(1, torch.as_tensor(cols, device=dev), vals)
    return E.reshape(C, len(groups), n_j, dirs.shape[0])


@functools.lru_cache(maxsize=None)
def _face_nonzero_full(dim: int):
    groups, rows, cols, signs, n_j = face_tables_full(dim)
    dirs, _, _ = stencil_tables(dim)
    nz = np.zeros(len(groups) * n_j * dirs.shape[0], dtype=bool)
    nz[cols] = True
    return nz.reshape(len(groups), n_j, dirs.shape[0])


@functools.lru_cache(maxsize=None)
def _mask_arrays(level: int, dim: int, pitch: int):
    """Static (N, lanes) masks: K0 (inside tet), shells S = n - m, and the
    coordinate-face indicators p_i = 0 (numpy float32)."""
    n = 1 << level
    N = n + 1
    if dim == 3:
        ysum = flat.yz_sum(N, pitch)
        y, z = flat.yz_maps(N, pitch)
        ssum = ysum[None, :] + np.arange(N)[:, None]
        coord = [
            np.broadcast_to(np.arange(N)[:, None], (N, N * pitch)),
            np.broadcast_to(y[None, :], (N, N * pitch)),
            np.broadcast_to(z[None, :], (N, N * pitch)),
        ]
    else:
        ssum = np.add.outer(np.arange(N), np.arange(N))
        coord = [
            np.broadcast_to(np.arange(N)[:, None], (N, N)),
            np.broadcast_to(np.arange(N)[None, :], (N, N)),
        ]
    K0 = (ssum <= n).astype(np.float32)
    _, _, n_j = stencil_tables(dim)
    shells = tuple(
        (ssum == n - m).astype(np.float32) for m in range(n_j - 1)
    )
    faces = tuple((c == 0).astype(np.float32) * K0 for c in coord)
    return K0, shells, faces


@functools.lru_cache(maxsize=8)
def _mask_tensors(level: int, dim: int, pitch: int, dtype, device):
    K0, shells, faces = _mask_arrays(level, dim, pitch)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return t(K0), tuple(t(s) for s in shells), tuple(t(f) for f in faces)


def _combine(reads, main_w, main_tail, face_w, dim, masks):
    """Accumulation of the stencil apply (the math of the Pallas kernel).

    reads: list of n_s shifted-read arrays (strictly zero-filled).
    main_w(s): total interior weight W_s (broadcastable against reads[s]).
    main_tail(s, m): sum_{j > m} A[s, j] or None (shell-correction tail).
    face_w(g, j, s): signed face-correction weight E or None.
    masks: (K0, shells, faces) arrays broadcastable against reads.
    """
    dirs, _, n_j = stencil_tables(dim)
    groups, *_ = face_tables_full(dim)
    K0, shells, faces = masks
    n_s = dirs.shape[0]

    # main: K0 * sum_s W_s r_s - sum_m shell_m * (sum_s A_{>m,s} r_s)
    acc_w = None
    acc_shell = [None] * (n_j - 1)
    for s in range(n_s):
        term = main_w(s) * reads[s]
        acc_w = term if acc_w is None else acc_w + term
        for m in range(n_j - 1):
            corr = main_tail(s, m)
            if corr is None:
                continue
            t2 = corr * reads[s]
            acc_shell[m] = t2 if acc_shell[m] is None else acc_shell[m] + t2
    dst = K0 * acc_w
    for m in range(n_j - 1):
        if acc_shell[m] is not None:
            dst = dst - shells[m] * acc_shell[m]

    # face corrections: - sum_G sigma_G * sum_j [S <= n-j] sum_s E r_s.
    # sigma_G already includes K0; [S <= n-j] restricted there equals
    # (1 - sum_{m<j} [S = n-m]).
    for g, G in enumerate(groups):
        sigma = faces[G[0]]
        for i in G[1:]:
            sigma = sigma * faces[i]
        acc_g = [None] * n_j
        for j in range(n_j):
            for s in range(n_s):
                w = face_w(g, j, s)
                if w is None:
                    continue
                t2 = w * reads[s]
                acc_g[j] = t2 if acc_g[j] is None else acc_g[j] + t2
        total = None
        for j in range(n_j):
            if acc_g[j] is None:
                continue
            term = acc_g[j]
            for m in range(j):
                term = term - shells[m] * acc_g[j]
            total = term if total is None else total + term
        if total is not None:
            dst = dst - sigma * total
    return dst


def _torch_accessors(A, E, dim, dtype):
    """Weight accessors for the plain path ((C, 1, 1)-shaped factors)."""
    _, _, n_j = stencil_tables(dim)
    nzs = _structural_nonzero(dim)
    nzf = _face_nonzero_full(dim)

    def wk(arr):
        return arr.reshape(-1, 1, 1).to(dtype)

    def main_w(s):
        return wk(A[:, s, :].sum(-1))

    def main_tail(s, m):
        js = [j for j in range(m + 1, n_j) if nzs[s, j]]
        if not js:
            return None
        corr = A[:, s, js[0]]
        for j in js[1:]:
            corr = corr + A[:, s, j]
        return wk(corr)

    def face_w(g, j, s):
        if not nzf[g, j, s]:
            return None
        return wk(E[:, g, j, s])

    return main_w, main_tail, face_w


def p1_const_apply_torch(src, A, level: int, dim: int, pitch: int, E=None):
    """Plain-torch constant-stencil apply (counterpart of
    hyteg_tpu's p1_const_apply_xla; partial sums on interface rows).

    Reads are plain flat shifts (ends zero-filled, lane aliasing allowed):
    the full-scheme weights are pointwise exact, so every out-of-tet read
    carries a zero coefficient (see face_tables_full).

    A bf16 source: A and E rounded to bf16, the apply computed in f32 on
    the widened values, the result rounded to bf16 once (kernel B2's bf16
    rule)."""
    if E is None:
        raise ValueError("pass E = face_weights_full(elmats, dim)")
    if src.dtype == torch.bfloat16:
        wide = lambda t: t.to(torch.bfloat16).to(torch.float32)
        return p1_const_apply_torch(wide(src), wide(A), level, dim, pitch,
                                    E=wide(E)).to(torch.bfloat16)
    dirs, _, _ = stencil_tables(dim)
    reads = [
        flat.shift_read(src, tuple(int(x) for x in dirs[i]), pitch, dim)
        for i in range(dirs.shape[0])
    ]
    masks = _mask_tensors(level, dim, pitch, src.dtype, src.device)
    return _combine(reads, *_torch_accessors(A, E, dim, src.dtype), dim, masks)


@functools.lru_cache(maxsize=None)
def _kernel_tables(dim: int = 3):
    """Host int32 tables handed to the CUDA launcher: the stencil
    directions ((15, 3) in 3D, (7, 2) in 2D) and the face-group bit masks
    ((7,) in 3D, (3,) in 2D)."""
    dirs, _, _ = stencil_tables(dim)
    groups, *_ = face_tables_full(dim)
    gmask = [sum(1 << i for i in G) for G in groups]
    return (np.ascontiguousarray(dirs, dtype=np.int32),
            np.asarray(gmask, dtype=np.int32))


def _check_cuda_input(name, t, shape, dtype=torch.float32):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def p1_const_apply(src, A, E, level: int, dim: int, pitch: int):
    """Per-cell constant-stencil apply (partial sums on interface rows).

    src: (C, N, N*pitch) in 3D, (C, N, N) in 2D; A: (C, n_s, 2) from
    stencil_weights (n_s 15 or 7); E: (C, n_G, 2, n_s) from
    face_weights_full (n_G 7 or 3). A CPU tensor runs the plain version;
    a CUDA tensor launches kernel B2 (csrc/p1_const_stencil.cu) and counts
    the launch in ``p1_const_apply.launches`` (3D) or
    ``p1_const_apply.launches_2d``. In 3D the storage may be f32 or bf16
    (a bf16 launch also counts in ``p1_const_apply.launches_bf16``); the
    2D kernel takes f32 only. With a bf16 source, f32 weights are rounded
    to bf16 as the Pallas kernel rounds them, on either device; the source
    is never cast, and any other type raises."""
    if src.device.type == "cpu":
        return p1_const_apply_torch(src, A, level, dim, pitch, E=E)
    N = (1 << level) + 1
    C = src.shape[0]
    dirs, gmask = _kernel_tables(dim)
    dt = src.dtype if dim == 3 and src.dtype == torch.bfloat16 else torch.float32
    _check_cuda_input("src", src, (C, N, N * pitch if dim == 3 else N), dt)
    if dt == torch.bfloat16:
        A, E = (w.to(dt) if w.dtype == torch.float32 else w for w in (A, E))
    _check_cuda_input("A", A, (C, dirs.shape[0], 2), dt)
    _check_cuda_input("E", E, (C, gmask.shape[0], 2, dirs.shape[0]), dt)
    dst = torch.empty_like(src)
    lib = build.library()
    if dt == torch.bfloat16:
        rc = lib.hyteg_p1_const_apply_bf16(
            src.data_ptr(), A.data_ptr(), E.data_ptr(), dst.data_ptr(), C, N,
            pitch, dirs.ctypes.data, gmask.ctypes.data, build.current_stream())
    elif dim == 3:
        rc = lib.hyteg_p1_const_apply(
            src.data_ptr(), A.data_ptr(), E.data_ptr(), dst.data_ptr(), C, N,
            pitch, dirs.ctypes.data, gmask.ctypes.data, build.current_stream())
    else:
        rc = lib.hyteg_p1_const_apply_2d(
            src.data_ptr(), A.data_ptr(), E.data_ptr(), dst.data_ptr(), C, N,
            dirs.ctypes.data, gmask.ctypes.data, build.current_stream())
    build.check_launch(rc, "p1_const_apply")
    build.count_launch(p1_const_apply, dim, level)
    if dt == torch.bfloat16:
        p1_const_apply.launches_bf16 += 1
    return dst


p1_const_apply.launches = 0
p1_const_apply.launches_bf16 = 0
p1_const_apply.launches_2d = 0
p1_const_apply.launches_by_level = {}
p1_const_apply.launches_by_level_2d = {}
