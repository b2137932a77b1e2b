"""TetPairEngine: the paired-tet apply bound to a (space, operator) (torch
counterpart of hyteg_tpu/tetpair/engine.py).

Usage (the bench hot loop):

    eng = TetPairEngine(space, elmats)
    st = eng.lift(u)                  # pack + extract (chain start)
    st = eng.apply_ex(st)             # fused exchanged apply (hot)
    u2 = eng.lower(st)                # install + unpack (chain end)

``lower(lift(u)) == u`` on tet positions, and ``lower(apply_ex(lift(u)))``
equals the classic ``P1ElementwiseOperator.apply_raw``
(tests/test_torch_tetpair.py and chip_smoke.py check both). As in the JAX
package, no solver calls the engine.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import tetpair as tk
from . import plan as tp
from . import small as ts
from .ifc import build_ifc


@dataclasses.dataclass
class PairState:
    """Paired blocks + authoritative boundary values (compact faces)."""

    u: torch.Tensor   # (Cp, N, L)
    xf: torch.Tensor  # (Cp, 2, L)
    yf: torch.Tensor  # (Cp, 2, N, P)
    zf: torch.Tensor  # (Cp, 2, N, N)
    df: torch.Tensor  # (Cp, 2, L)


class TetPairEngine:
    """Fast constant-stencil apply for a single-shard 3D P1 space."""

    def __init__(self, space, elmats):
        if space.dim != 3:
            raise ValueError("tetpair is the 3D fast path")
        if space.storage.num_shards != 1:
            raise ValueError(
                "tetpair requires a single-shard storage: the paired-tet "
                "engine has no sharded exchange of its face arrays, and the "
                "JAX package has no sharded paired-tet path to port "
                "(ROADMAP A8); run a sharded storage through "
                "P1ElementwiseOperator")
        if not bool(np.all(space.storage.cell_valid)):
            raise ValueError("tetpair requires a padding-free storage")
        if space.C_loc % 2:
            raise ValueError("tetpair requires an even macro-cell count")
        if space.dtype != torch.float32:
            raise ValueError(
                f"tetpair requires an f32 space, got {space.dtype}: the "
                "paired-tet kernels B6-B8 have no other form, and the "
                "reference's refuse a bf16 block too (ROADMAP C-ref18)")
        self.space = space
        self.N = space.N
        self.P = space.pitch
        self.Cp = space.C_loc // 2
        self.W = tp.weight_matrix(torch.as_tensor(elmats)).to(space.device)
        self.ifc = build_ifc(space.storage, space.level)

    # -- state conversions ---------------------------------------------------

    def pack(self, u: torch.Tensor) -> torch.Tensor:
        return tp.pack_blocks(u, self.N, self.P)

    def unpack(self, up: torch.Tensor) -> torch.Tensor:
        return tp.unpack_blocks(up, self.N, self.P)

    def lift(self, u: torch.Tensor) -> PairState:
        """Consistent per-tet blocks (C, N, L) -> PairState."""
        up = self.pack(u)
        return PairState(up, *tk.pair_extract(up, self.N, self.P))

    def install(self, st: PairState) -> torch.Tensor:
        """Materialized consistent paired blocks."""
        return tk.pair_install(st.u, st.xf, st.yf, st.zf, st.df,
                               self.N, self.P)

    def lower(self, st: PairState) -> torch.Tensor:
        """PairState -> consistent per-tet blocks (C, N, L)."""
        return self.unpack(self.install(st))

    # -- the hot apply -------------------------------------------------------

    def exchange_faces(self, xfo, yfo, zfo, dfo):
        planes = ts.faces_to_planes(xfo, yfo, zfo, dfo, self.N, self.P)
        summed = ts.exchange_planes(self.ifc, planes)
        return ts.planes_to_faces(summed, self.N, self.P)

    def apply_ex(self, st: PairState) -> PairState:
        """One exchanged operator apply: one block stream + small faces."""
        dst, xfo, yfo, zfo, dfo = tk.pair_apply(
            st.u, self.W, st.xf, st.yf, st.zf, st.df, self.N, self.P)
        return PairState(dst, *self.exchange_faces(xfo, yfo, zfo, dfo))

    def apply_full(self, u: torch.Tensor) -> torch.Tensor:
        """Gate path: classic blocks in, exchanged apply, classic out."""
        return self.lower(self.apply_ex(self.lift(u)))
