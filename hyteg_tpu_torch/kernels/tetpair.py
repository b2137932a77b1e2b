"""Paired-tet kernels B6 (fused exchanged apply), B7 (install) and B8
(extract): torch counterparts of hyteg_tpu/tetpair/kernel.py.

Two macro-tets share one (N, L = N * P) block per pair, lane l = ly * P +
lz: tet A in the lower corner (s = x + ly + lz <= n), tet B
point-reflected into the upper one (s >= 2n, lz <= n). The boundary
values of a block are authoritative in four compact face arrays per pair:

    xf (Cp, 2, L)     x-faces: A on row 0, B on row n, flattened (y, z)
    yf (Cp, 2, N, P)  y-faces: A lanes [0, P), B lanes [nP, nP + P)
    zf (Cp, 2, N, N)  z-faces: params (x, y), A at lz = 0, B at lz = n
    df (Cp, 2, L)     diagonal shells: A at s = n, B at s = 2n

``pair_install`` writes them into the block (x-face over y-face over
z-face over shell); ``pair_extract`` copies the block's boundary values
out (0 in every slot whose position lies outside its face); ``pair_apply``
installs on read, applies the per-pair constant stencil with per-lane
weights (tetpair/plan.py) and extracts from the result.

Reads follow flat.shift_read: lanes wrap into the neighbouring y-row,
and a read that leaves the rows or the lanes of the block is 0. The
Pallas kernel rolls lanes and splices rows cyclically instead; both meet
an effective weight of 0 there up to f32 cancellation, so the two agree
to rounding, and the CUDA kernels agree with the plain versions here on
any mesh.

Each wrapper runs its plain version for a CPU tensor and launches its
CUDA kernel (csrc/tetpair.cu) for a CUDA tensor, counting the launch in
``<wrapper>.launches``. On either device a block or face array that is not
f32 raises ``ValueError``: the reference's Pallas kernels have no other
form (their face arrays are f32 and the stores refuse a mixed type,
ROADMAP C-ref18).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..indexing import flat
from ..tetpair import plan as tp
from . import build
from .p1_const_stencil import _check_cuda_input


@functools.lru_cache(maxsize=8)
def _geometry(N: int, P: int, device):
    """Static (N, L) position masks and lane maps as tensors on device."""
    n = N - 1
    plan = tp.PairPlan(N, P)
    ly, lz = (torch.as_tensor(a, dtype=torch.long, device=device)
              for a in plan.yz)
    s = torch.as_tensor(plan.s_raw, device=device)
    in_a = torch.as_tensor(plan.in_a, device=device)
    in_b = torch.as_tensor(plan.in_b, device=device)
    okz = lz <= n
    return {
        "ly": ly, "lz": lz, "in_a": in_a, "in_b": in_b,
        "sh_a": s == n, "sh_b": (s == 2 * n) & okz,
        "x0": s[0] <= n, "xn": s[n] >= 2 * n,
        "ya": (ly == 0) & in_a, "yb": (ly == n) & in_b,
        "za": (lz == 0) & in_a, "zb": (lz == n) & in_b,
        "masks": torch.as_tensor(plan.masks, device=device),
        "row0": (torch.arange(N, device=device) == 0)[:, None],
        "rown": (torch.arange(N, device=device) == n)[:, None],
    }


def _face_shapes(Cp: int, N: int, P: int):
    L = N * P
    return (Cp, 2, L), (Cp, 2, N, P), (Cp, 2, N, N), (Cp, 2, L)


def pair_install_torch(u, xf, yf, zf, df, N: int, P: int) -> torch.Tensor:
    """Plain install: u (Cp, N, L) with the face values written into the
    boundary positions."""
    g = _geometry(N, P, u.device)
    ly, lz = g["ly"], g["lz"]
    out = torch.where(g["sh_a"], df[:, 0:1], u)
    out = torch.where(g["sh_b"], df[:, 1:2], out)
    out = torch.where(g["za"], zf[:, 0][:, :, ly], out)
    out = torch.where(g["zb"], zf[:, 1][:, :, ly], out)
    out = torch.where(g["ya"], yf[:, 0][:, :, lz], out)
    out = torch.where(g["yb"], yf[:, 1][:, :, lz], out)
    out[:, 0] = torch.where(g["x0"], xf[:, 0], out[:, 0])
    out[:, N - 1] = torch.where(g["xn"], xf[:, 1], out[:, N - 1])
    return out


def pair_extract_torch(u, N: int, P: int):
    """Plain extract: the face arrays (xf, yf, zf, df) of blocks u."""
    n = N - 1
    g = _geometry(N, P, u.device)
    zero = u.new_zeros(())
    xf = torch.stack([torch.where(g["x0"], u[:, 0], zero),
                      torch.where(g["xn"], u[:, n], zero)], dim=1)
    ua = torch.where(g["in_a"], u, zero)
    ub = torch.where(g["in_b"], u, zero)
    yf = torch.stack([ua[:, :, :P], ub[:, :, n * P:n * P + P]], dim=1)
    za = torch.arange(N, device=u.device) * P
    zf = torch.stack([ua[:, :, za], ub[:, :, za + n]], dim=1)
    df = torch.stack([torch.where(g["sh_a"], u, zero).sum(dim=1),
                      torch.where(g["sh_b"], u, zero).sum(dim=1)], dim=1)
    return xf, yf, zf, df


def pair_apply_torch(u, W, xf, yf, zf, df, N: int, P: int):
    """Plain fused exchanged apply. Returns (dst, xfo, yfo, zfo, dfo):
    dst holds the per-pair partial sums on tet positions and 0 elsewhere,
    the faces its extracted boundary values."""
    g = _geometry(N, P, u.device)
    dirs, _, tail_a, tail_b = tp.dir_tables()
    ui = pair_install_torch(u, xf, yf, zf, df, N, P)
    m = g["masks"]
    vec = W[:, :, 0:1] * m[0]
    for j in range(1, tp.N_MASKCOL):  # (Cp, 120, L), column order
        vec = vec + W[:, :, j:j + 1] * m[j]
    vec = vec.reshape(W.shape[0], 8, tp.N_DIRS, -1)

    def weight(d, h, edge_row, tails, shell):
        kv = 4 * h  # V kinds 0 (A) / 4 (B); V0 = V + 2, T = V + 1
        w = torch.where(edge_row, vec[:, kv + 2, d, None],
                        vec[:, kv, d, None])
        if d in tails:
            t = torch.where(edge_row, vec[:, kv + 3, d, None],
                            vec[:, kv + 1, d, None])
            w = w - shell * t
        return w

    sh_a = g["sh_a"].to(u.dtype)
    sh_b = g["sh_b"].to(u.dtype)
    acc_a = torch.zeros_like(u)
    acc_b = torch.zeros_like(u)
    for d in range(tp.N_DIRS):
        r = flat.shift_read(ui, tuple(int(v) for v in dirs[d]), P, 3)
        acc_a += weight(d, 0, g["row0"], tail_a, sh_a) * r
        acc_b += weight(d, 1, g["rown"], tail_b, sh_b) * r
    zero = u.new_zeros(())
    dst = torch.where(g["in_a"], acc_a, torch.where(g["in_b"], acc_b, zero))
    return (dst, *pair_extract_torch(dst, N, P))


@functools.lru_cache(maxsize=None)
def _kernel_tables():
    """Host (15, 3) int32 directions and the tail bit masks of both halves."""
    dirs, _, tail_a, tail_b = tp.dir_tables()
    return (np.ascontiguousarray(dirs, dtype=np.int32),
            sum(1 << d for d in tail_a), sum(1 << d for d in tail_b))


def _check_f32(what: str, names, tensors):
    """Refuse a block or face array that is not f32, on both devices."""
    for name, t in zip(names, tensors):
        if t.dtype != torch.float32:
            raise ValueError(
                f"{what}: {name} is {t.dtype}; the paired-tet kernels take "
                "f32 blocks and faces only, and the reference's Pallas "
                "kernels refuse a bf16 block too (their face arrays are f32 "
                "and the store into the block rejects the other type, "
                "ROADMAP C-ref18)")


def _check_faces(names, faces, Cp: int, N: int, P: int):
    for name, t, shape in zip(names, faces, _face_shapes(Cp, N, P)):
        _check_cuda_input(name, t, shape)


def pair_apply(u, W, xf, yf, zf, df, N: int, P: int):
    """Fused exchanged apply on paired blocks (kernel B6).

    u: (Cp, N, N*P) f32 blocks, consistent except on the boundary (the
    face arrays are authoritative there); W: (Cp, 120, 7) from
    plan.weight_matrix. Returns (dst, xfo, yfo, zfo, dfo)."""
    _check_f32("pair_apply", ("u", "xf", "yf", "zf", "df"),
               (u, xf, yf, zf, df))
    if u.device.type == "cpu":
        return pair_apply_torch(u, W, xf, yf, zf, df, N, P)
    Cp = u.shape[0]
    _check_cuda_input("u", u, (Cp, N, N * P))
    _check_cuda_input("W", W, (Cp, tp.N_VEC, tp.N_MASKCOL))
    _check_faces(("xf", "yf", "zf", "df"), (xf, yf, zf, df), Cp, N, P)
    dirs, tail_a, tail_b = _kernel_tables()
    dst = torch.empty_like(u)
    outs = [torch.empty(s, dtype=u.dtype, device=u.device)
            for s in _face_shapes(Cp, N, P)]
    rc = build.library().hyteg_pair_apply(
        u.data_ptr(), W.data_ptr(), xf.data_ptr(), yf.data_ptr(),
        zf.data_ptr(), df.data_ptr(), dst.data_ptr(),
        *(o.data_ptr() for o in outs), Cp, N, P, dirs.ctypes.data, tail_a,
        tail_b, build.current_stream())
    build.check_launch(rc, "pair_apply")
    pair_apply.launches += 1
    return (dst, *outs)


def pair_install(u, xf, yf, zf, df, N: int, P: int) -> torch.Tensor:
    """Consistent blocks: the face values written back into the block
    boundaries (kernel B7; the finalize step of a chain)."""
    _check_f32("pair_install", ("u", "xf", "yf", "zf", "df"),
               (u, xf, yf, zf, df))
    if u.device.type == "cpu":
        return pair_install_torch(u, xf, yf, zf, df, N, P)
    Cp = u.shape[0]
    _check_cuda_input("u", u, (Cp, N, N * P))
    _check_faces(("xf", "yf", "zf", "df"), (xf, yf, zf, df), Cp, N, P)
    out = torch.empty_like(u)
    rc = build.library().hyteg_pair_install(
        u.data_ptr(), xf.data_ptr(), yf.data_ptr(), zf.data_ptr(),
        df.data_ptr(), out.data_ptr(), Cp, N, P, build.current_stream())
    build.check_launch(rc, "pair_install")
    pair_install.launches += 1
    return out


def pair_extract(u, N: int, P: int):
    """The boundary values of consistent blocks as face arrays (kernel B8;
    the chain-start step)."""
    _check_f32("pair_extract", ("u",), (u,))
    if u.device.type == "cpu":
        return pair_extract_torch(u, N, P)
    Cp = u.shape[0]
    _check_cuda_input("u", u, (Cp, N, N * P))
    outs = [torch.empty(s, dtype=u.dtype, device=u.device)
            for s in _face_shapes(Cp, N, P)]
    rc = build.library().hyteg_pair_extract(
        u.data_ptr(), *(o.data_ptr() for o in outs), Cp, N, P,
        build.current_stream())
    build.check_launch(rc, "pair_extract")
    pair_extract.launches += 1
    return tuple(outs)


pair_apply.launches = 0
pair_install.launches = 0
pair_extract.launches = 0
