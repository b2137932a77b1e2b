"""Static plan for the paired-tet apply: pairing, masks, weight tables
(torch counterpart of hyteg_tpu/tetpair/plan.py).

Weight algebra. The pointwise-exact constant-stencil weight of direction d
at position p inside a macro-tet (kernels/p1_const_stencil.py, n_j = 2 in
3D) is

    w_d(p) = (A0_d + A1_d) - [s(p) = n] * A1_d
             - sum_{G: p on all faces in G} (E[G,0,d] + E[G,1,d] [s<=n-1])

with s = x + y + z, A = stencil_weights, E = face_weights_full. Using
[s <= n-1] = 1 - [s = n] inside the tet, and splitting the face groups
into lane-only (G a subset of {y, z}) and x-containing (row 0) ones, this
collapses to

    w_d(p) = V_d[l] - [s = n] * T_d[l]          (x in 1..n-1)
    w_d(0, l) = V0_d[l] - [s = n] * T0_d[l]     (row 0)

where V/T/V0/T0 are per-lane vectors, each a 4-term combination of the
static lane masks (1, [y=0], [z=0], [y=0][z=0]) with per-cell scalar
coefficients: the rows of W (``weight_matrix``) against the columns of
``mask_stack``.

Tet B is point-reflected: stored[x,y,z] = u_B[n-x, n-y, n-z]. Since the
15-direction set is symmetric, the stored-space apply for B uses B's
tables at the negated direction and mirrored lane masks ([y=n], [z=n]);
its x-face fix sits on row n and its diagonal shell on s = 2n.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..indexing import flat
from ..kernels.p1_const_stencil import (_structural_nonzero,
                                        face_tables_full, face_weights_full,
                                        stencil_tables, stencil_weights)

#: row layout of the per-pair coefficient matrix W (N_VEC rows):
#: kind-major [VA, TA, V0A, T0A, VB, TB, V0B, T0B], 15 directions each.
KINDS = ("VA", "TA", "V0A", "T0A", "VB", "TB", "V0B", "T0B")
N_DIRS = 15
N_VEC = len(KINDS) * N_DIRS  # 120
N_MASKCOL = 7  # [1, yA, zA, yzA, yB, zB, yzB]


@functools.lru_cache(maxsize=None)
def dir_tables():
    """(dirs (15, 3), neg (15,), tail_a, tail_b).

    ``neg[s]`` is the index of -dirs[s]. ``tail_a`` are the stored
    directions with a structurally nonzero shell tail for the A half;
    ``tail_b`` is the same set for the reflected B half, whose stored
    direction e carries the own-coords tables of -e (so its tail pattern
    is the neg-mapped one)."""
    dirs, _, n_j = stencil_tables(3)
    if n_j != 2:
        raise ValueError("the paired plan assumes the 3D two-shell structure")
    key = {tuple(int(v) for v in d): i for i, d in enumerate(dirs)}
    neg = np.array([key[tuple(-int(v) for v in d)] for d in dirs],
                   dtype=np.int64)
    nzs = _structural_nonzero(3)
    tail_a = tuple(s for s in range(dirs.shape[0]) if nzs[s, 1])
    tail_b = tuple(s for s in range(dirs.shape[0]) if nzs[neg[s], 1])
    return dirs, neg, tail_a, tail_b


@functools.lru_cache(maxsize=None)
def _group_index():
    groups, *_ = face_tables_full(3)
    return {G: i for i, G in enumerate(groups)}


def _half_tables(A: np.ndarray, E: np.ndarray) -> np.ndarray:
    """(C, 4 kinds, 15, 4 cols) per-half coefficient tables in OWN coords.

    cols = coefficients against [1, my, mz, my*mz]; kinds = V, T, V0, T0.
    A: (C, 15, 2); E: (C, 7, 2, 15), both float64."""
    g = _group_index()
    g0, gy, gz = g[(0,)], g[(1,)], g[(2,)]
    gxy, gxz, gyz, gxyz = g[(0, 1)], g[(0, 2)], g[(1, 2)], g[(0, 1, 2)]
    C = A.shape[0]
    out = np.zeros((C, 4, N_DIRS, 4), dtype=np.float64)
    Et = lambda gi: E[:, gi, 0, :] + E[:, gi, 1, :]  # (C, 15) total
    E1 = lambda gi: E[:, gi, 1, :]
    # V
    out[:, 0, :, 0] = A[:, :, 0] + A[:, :, 1]
    out[:, 0, :, 1] = -Et(gy)
    out[:, 0, :, 2] = -Et(gz)
    out[:, 0, :, 3] = -Et(gyz)
    # T
    out[:, 1, :, 0] = A[:, :, 1]
    out[:, 1, :, 1] = -E1(gy)
    out[:, 1, :, 2] = -E1(gz)
    out[:, 1, :, 3] = -E1(gyz)
    # V0 = V - x-face groups
    out[:, 2] = out[:, 0]
    out[:, 2, :, 0] -= Et(g0)
    out[:, 2, :, 1] -= Et(gxy)
    out[:, 2, :, 2] -= Et(gxz)
    out[:, 2, :, 3] -= Et(gxyz)
    # T0 = T - x-face groups (j = 1 parts)
    out[:, 3] = out[:, 1]
    out[:, 3, :, 0] -= E1(g0)
    out[:, 3, :, 1] -= E1(gxy)
    out[:, 3, :, 2] -= E1(gxz)
    out[:, 3, :, 3] -= E1(gxyz)
    return out


def weight_matrix(elmats: torch.Tensor) -> torch.Tensor:
    """(Cp, N_VEC, N_MASKCOL) f32 coefficient matrices on elmats' device
    from per-cell element matrices (C, T, nv, nv), C even, pairs (2i, 2i+1).

    The stencil tables A and E and their combinations are taken in
    float64 on the host and rounded to f32 once."""
    C = elmats.shape[0]
    if C % 2:
        raise ValueError("tetpair requires an even macro-cell count")
    e64 = elmats.detach().to("cpu", torch.float64)
    A = stencil_weights(e64, 3).numpy()
    E = face_weights_full(e64, 3).numpy()
    tabs = _half_tables(A, E)  # (C, 4, 15, 4) own-coords
    _, neg, _, _ = dir_tables()
    W = np.zeros((C // 2, N_VEC, N_MASKCOL), dtype=np.float64)
    tA = tabs[0::2]  # (Cp, 4, 15, 4)
    tB = tabs[1::2][:, :, neg, :]  # stored direction e uses B table at -e
    for k in range(4):  # VA, TA, V0A, T0A
        W[:, k * N_DIRS:(k + 1) * N_DIRS, 0:4] = tA[:, k]
    for k in range(4):  # VB, TB, V0B, T0B
        r0 = (4 + k) * N_DIRS
        W[:, r0:r0 + N_DIRS, 0] = tB[:, k, :, 0]
        W[:, r0:r0 + N_DIRS, 4:7] = tB[:, k, :, 1:4]
    return torch.tensor(W, dtype=torch.float32, device=elmats.device)


@functools.lru_cache(maxsize=None)
def mask_stack(N: int, pitch: int) -> np.ndarray:
    """(N_MASKCOL, L) static lane-mask stack [1, yA, zA, yzA, yB, zB, yzB].

    A masks: [ly = 0], [lz = 0]; B masks (stored coords): [ly = n],
    [lz = n]. Padding lanes (lz > n) carry zeros everywhere except the
    constant row, which is harmless: positions there are outside both
    tets, and the apply writes 0 there."""
    n = N - 1
    ly, lz = flat.yz_maps(N, pitch)
    m = np.zeros((N_MASKCOL, N * pitch), dtype=np.float32)
    m[0] = 1.0
    m[1] = ly == 0
    m[2] = lz == 0
    m[3] = m[1] * m[2]
    m[4] = ly == n
    m[5] = lz == n
    m[6] = m[4] * m[5]
    return m


@dataclasses.dataclass(frozen=True)
class PairPlan:
    """Static geometry of the paired layout for one (level, pitch)."""

    N: int
    pitch: int

    @property
    def n(self) -> int:
        return self.N - 1

    @property
    def L(self) -> int:
        return self.N * self.pitch

    @functools.cached_property
    def yz(self) -> np.ndarray:
        """(2, L) int32 [ly, lz] per lane."""
        y, z = flat.yz_maps(self.N, self.pitch)
        return np.stack([y, z]).astype(np.int32)

    @functools.cached_property
    def masks(self) -> np.ndarray:
        return mask_stack(self.N, self.pitch)

    @functools.cached_property
    def s_raw(self) -> np.ndarray:
        """(N, L) x + ly + lz, padding lanes included (the kernels' s)."""
        ly, lz = self.yz
        return np.arange(self.N)[:, None] + ly[None] + lz[None]

    @functools.cached_property
    def in_a(self) -> np.ndarray:
        """(N, L) bool: positions of tet A (s <= n)."""
        return self.s_raw <= self.n

    @functools.cached_property
    def in_b(self) -> np.ndarray:
        """(N, L) bool: positions of the reflected tet B (s >= 2n, lz <= n)."""
        return (self.s_raw >= 2 * self.n) & (self.yz[1][None] <= self.n)


@functools.lru_cache(maxsize=8)
def _half_masks(N: int, pitch: int, dtype, device):
    plan = PairPlan(N, pitch)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return t(plan.in_a), t(plan.in_b)


def _reflect(g: torch.Tensor, N: int, pitch: int) -> torch.Tensor:
    """(.., N, N*pitch) -> the point reflection (x,y,z) -> (n-x, n-y, n-z),
    padding lanes kept in place."""
    g = g.reshape(-1, N, N, pitch).flip(1, 2)
    gz = g[..., :N].flip(-1)
    if pitch > N:
        gz = torch.cat([gz, g[..., N:]], dim=-1)
    return gz.reshape(-1, N, N * pitch)


def pack_blocks(u: torch.Tensor, N: int, pitch: int) -> torch.Tensor:
    """(C, N, L) per-tet blocks -> (C/2, N, L) paired blocks.

    Even cells become the A half (copied through); odd cells are
    point-reflected into the upper corner. Values outside each tet are
    masked away."""
    ma, mb = _half_masks(N, pitch, u.dtype, u.device)
    return u[0::2] * ma + _reflect(u[1::2], N, pitch) * mb


def unpack_blocks(up: torch.Tensor, N: int, pitch: int) -> torch.Tensor:
    """(C/2, N, L) paired blocks -> (C, N, L) per-tet blocks (masked)."""
    ma, mb = _half_masks(N, pitch, up.dtype, up.device)
    out = torch.empty((2 * up.shape[0],) + tuple(up.shape[1:]),
                      dtype=up.dtype, device=up.device)
    out[0::2] = up * ma
    out[1::2] = _reflect(up * mb, N, pitch)
    return out
