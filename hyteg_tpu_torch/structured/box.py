"""BoxDomain: a box-structured Kuhn-tet macro aggregated into one grid
(torch counterpart of hyteg_tpu/structured/box.py).

The whole domain is ONE dense node grid

    block shape (X, Y*Z),  X = mx*2^l + 1, lane = y*Z + z

with every global DoF stored exactly once. At level 9 on m = (2, 2, 2) a
block is 1,076,890,625 nodes (4.31 GB in f32), so nothing here
materializes a coordinate or mask array of that shape: coordinates are
handed out as broadcastable factors, x (X, 1) and y, z (1, L), and masks
as row-class lane vectors (3, L) — row class 0 for the interior rows,
1 for row 0, 2 for row X-1 — that ``rowclass_mul`` broadcasts.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import torch


def rowclass_mul_(v: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """In place: v[x, :] *= w3[c(x)] with the row class c(x) (0 interior,
    1 row 0, 2 row X-1). Returns v."""
    X = v.shape[0]
    v[1 : X - 1].mul_(w3[0])
    v[0].mul_(w3[1])
    v[X - 1].mul_(w3[2])
    return v


def rowclass_mul(v: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """v[x, :] * w3[c(x)] into a fresh tensor of v's dtype."""
    X = v.shape[0]
    out = torch.empty_like(v)
    torch.mul(v[1 : X - 1], w3[0], out=out[1 : X - 1])
    torch.mul(v[0], w3[1], out=out[0])
    torch.mul(v[X - 1], w3[2], out=out[X - 1])
    return out


@dataclass(frozen=True)
class BoxDomain:
    """Structured grid of mx*my*mz unit cubes at refinement ``level``,
    physically spanning [0, ax] x [0, ay] x [0, az], with its fields on
    ``device`` in ``dtype``. ``device`` is a required keyword: the box
    path runs where the caller says, never on a default."""

    m: tuple[int, int, int]
    level: int
    extent: tuple[float, float, float] = (1.0, 1.0, 1.0)
    dtype: torch.dtype = torch.float32
    device: torch.device | str = field(kw_only=True)

    @property
    def dims(self) -> tuple[int, int, int]:
        s = 1 << self.level
        return tuple(mi * s + 1 for mi in self.m)

    @property
    def h(self) -> tuple[float, float, float]:
        s = 1 << self.level
        return tuple(a / (mi * s) for a, mi in zip(self.extent, self.m))

    @property
    def X(self) -> int:
        return self.dims[0]

    @property
    def L(self) -> int:
        _, Y, Z = self.dims
        return Y * Z

    @property
    def block_shape(self) -> tuple[int, int]:
        return (self.X, self.L)

    def num_dofs(self) -> int:
        X, Y, Z = self.dims
        return X * Y * Z

    def coarse(self) -> "BoxDomain":
        assert self.level > 0
        return BoxDomain(self.m, self.level - 1, self.extent, self.dtype,
                         device=self.device)

    # -- coordinates / fields -------------------------------------------------

    @functools.cached_property
    def lane_yz(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-lane (y, z) index maps on the device, each (L,) int64."""
        Z = self.dims[2]
        lane = torch.arange(self.L, device=self.device)
        y = torch.div(lane, Z, rounding_mode="floor")
        return y, lane - y * Z

    def coord_factors(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """f32 node coordinates as broadcastable factors: x (X, 1),
        y (1, L), z (1, L) (index * h in f64, rounded once to f32)."""
        hx, hy, hz = self.h
        y, z = self.lane_yz
        x = torch.arange(self.X, dtype=torch.float64, device=self.device) * hx
        return (x.to(torch.float32)[:, None],
                (y.to(torch.float64) * hy).to(torch.float32)[None, :],
                (z.to(torch.float64) * hz).to(torch.float32)[None, :])

    def interpolate(self, fn) -> torch.Tensor:
        """Nodal interpolation of fn(x, y, z), called once on the
        broadcastable coordinate factors (x (X, 1), y and z (1, L))."""
        out = torch.as_tensor(fn(*self.coord_factors()), device=self.device)
        return torch.broadcast_to(out, self.block_shape).to(
            self.dtype).contiguous()

    # -- masks (row-class lane vectors) ---------------------------------------

    @functools.cached_property
    def lane_interior(self) -> torch.Tensor:
        """(L,) f32: 1 on lanes off the four y/z boundary faces."""
        _, Y, Z = self.dims
        y, z = self.lane_yz
        inner = (y > 0) & (y < Y - 1) & (z > 0) & (z < Z - 1)
        return inner.to(torch.float32)

    @functools.cached_property
    def interior_rowclass(self) -> torch.Tensor:
        """(3, L) f32 interior mask: the lane mask on interior rows, 0 on
        rows 0 and X-1."""
        zero = torch.zeros_like(self.lane_interior)
        return torch.stack([self.lane_interior, zero, zero])

    @functools.cached_property
    def boundary_rowclass(self) -> torch.Tensor:
        """(3, L) f32 boundary mask: 1 on the 6 domain boundary faces."""
        one = torch.ones_like(self.lane_interior)
        return torch.stack([1.0 - self.lane_interior, one, one])

    def mask_interior(self, v: torch.Tensor) -> torch.Tensor:
        """v on interior nodes, 0 on the boundary (fresh tensor)."""
        return rowclass_mul(v, self.interior_rowclass)

    def mask_boundary(self, v: torch.Tensor) -> torch.Tensor:
        """v on boundary nodes, 0 inside (fresh tensor)."""
        return rowclass_mul(v, self.boundary_rowclass)

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.block_shape, dtype=self.dtype,
                           device=self.device)

    # -- reductions (every DoF stored exactly once) ---------------------------

    def dot(self, u, v, interior_only: bool = False) -> torch.Tensor:
        p = u * v
        if interior_only:
            rowclass_mul_(p, self.interior_rowclass)
        return torch.sum(p)

    def norm(self, u, interior_only: bool = False) -> torch.Tensor:
        return torch.sqrt(self.dot(u, u, interior_only))
