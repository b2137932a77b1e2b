"""Stripped-stencil probes (kernels P2): box_variant and tet_stripped.

Torch counterparts of the Pallas probes that the JAX package's profiling
scripts time to take its stencil kernels apart:

- ``box_variant`` replaces ``scripts/prof_r5.py::bench_box_variants``'s
  ``make`` (the box kernel B1 stripped to lane rolls and multiply-adds):

      y[x, l] = sum_{k < n_taps} w[s_k, l] * u[x, (l + ls_k) mod L]

  u (X, L) with L = Y*Z, w (15, L) per-lane weights (ones in the probe),
  taps in the script's order: the lane classes ls = dy*Z + dz of
  ``kuhn.stencil_dirs()`` in ascending order, then the direction index.
  Without the shift every tap reads u[x, l], which leaves the
  multiply-adds without the neighbour loads. The x axis is never shifted.
- ``tet_stripped`` replaces ``scripts/prof_r5b.py::bench_fma`` and
  ``scripts/kernel_probe.py::make_stripped`` (the tet kernel B2 stripped
  to rolls, multiply-adds and masks):

      y[c, x, l] = M * sum_{s < n_taps} w[c, s]
                   * u[c, (x + dx_s) mod N, (l + dy_s*pitch + dz_s) mod L]

  u (C, N, N*pitch), w (C, 15) per-cell weights, directions in the order
  of ``stencil_tables(3)``; M = 1 (``"none"``), K0 = [x+y+z <= n and
  z < N] (``"k0"``, make_stripped) or K0 times prod_{m < n_j-1}
  (1 - [x+y+z = n-m and z < N]) (``"k0_shells"``, bench_fma's masks).

Reads are cyclic (``pltpu.roll`` is ``jnp.roll`` is ``torch.roll``), so
the probes are wrong at shells and faces by design: they time work, they
solve nothing.

Each wrapper launches its CUDA kernel (``csrc/stripped_stencil.cu``) for
a CUDA tensor, runs its plain version (``*_torch``) for a CPU tensor, and
counts its launches in ``.launches``. The plain versions accumulate one
tap at a time, so a block never holds 15 shifted copies.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..indexing import flat
from ..structured import kuhn
from . import build
from .p1_const_stencil import _check_cuda_input, stencil_tables

#: tap counts with a CUDA kernel (those the probes time)
KERNEL_TAPS = (1, 6, 15)
#: mask modes of tet_stripped, in the kernel's numbering
MASKS = ("none", "k0", "k0_shells")
N_DIRS = 15


def _check_setting(n_taps: int, mask: str = "none") -> None:
    if not 1 <= n_taps <= N_DIRS:
        raise ValueError(f"n_taps must be in 1..{N_DIRS}, got {n_taps}")
    if mask not in MASKS:
        raise ValueError(f"mask must be one of {MASKS}, got {mask!r}")


@functools.lru_cache(maxsize=None)
def box_tap_order(Z: int) -> tuple[tuple[int, int], ...]:
    """The box probe's taps as (direction s, lane offset ls) pairs: lane
    classes ls = dy*Z + dz ascending, then the direction index
    (prof_r5.py:84,93-99)."""
    dirs = kuhn.stencil_dirs()
    ls = [int(d[1]) * Z + int(d[2]) for d in dirs]
    return tuple((s, ls[s]) for c in sorted(set(ls))
                 for s in range(len(dirs)) if ls[s] == c)


def box_variant_torch(u: torch.Tensor, w: torch.Tensor, Z: int, shift: bool,
                      n_taps: int) -> torch.Tensor:
    """Plain box probe: u (X, L) f32, w (15, L) f32."""
    _check_setting(n_taps)
    acc = torch.zeros_like(u)
    for s, ls in box_tap_order(Z)[:n_taps]:
        v = torch.roll(u, -ls, dims=1) if shift and ls else u
        acc.addcmul_(v, w[s])
    return acc


def box_variant(u: torch.Tensor, w: torch.Tensor, Z: int, shift: bool,
                n_taps: int) -> torch.Tensor:
    """The box probe. u: (X, L) f32 with L = Y*Z; w: (15, L) f32. A CPU
    tensor runs the plain version; a CUDA tensor launches the box kernel
    of csrc/stripped_stencil.cu (n_taps 1, 6 or 15) and counts the launch
    in ``box_variant.launches``."""
    if u.device.type == "cpu":
        return box_variant_torch(u, w, Z, shift, n_taps)
    _check_setting(n_taps)
    if n_taps not in KERNEL_TAPS:
        raise ValueError(f"no box_variant kernel for n_taps={n_taps}; "
                         f"built: {KERNEL_TAPS}")
    if u.dim() != 2:
        raise ValueError(f"u must be (X, L), got {tuple(u.shape)}")
    X, L = u.shape
    if Z < 2 or L % Z:
        raise ValueError(f"L = {L} is not Y * Z with Z = {Z} >= 2")
    _check_cuda_input("u", u, (X, L))
    _check_cuda_input("w", w, (N_DIRS, L))
    y = torch.empty_like(u)
    rc = build.library().hyteg_box_variant(
        u.data_ptr(), w.data_ptr(), y.data_ptr(), X, L, Z, int(bool(shift)),
        n_taps, build.current_stream())
    build.check_launch(rc, "box_variant")
    box_variant.launches += 1
    return y


box_variant.launches = 0


def tet_dirs() -> np.ndarray:
    """The (15, 3) directions of the P1 tet stencil (stencil_tables(3))."""
    return stencil_tables(3)[0]


@functools.lru_cache(maxsize=8)
def tet_mask(N: int, pitch: int, mask: str, device) -> torch.Tensor | None:
    """The (N, N*pitch) f32 mask M of a mask mode (None for "none"), with
    (y, z) from flat.yz_maps (bench_fma, prof_r5b.py:91-102)."""
    if mask == "none":
        return None
    n = N - 1
    y, z = flat.yz_maps(N, pitch)
    s = np.arange(N)[:, None] + (y + z)[None, :]
    in_z = (z < N)[None, :]
    m = (s <= n) & in_z
    if mask == "k0_shells":
        n_j = stencil_tables(3)[2]
        for j in range(n_j - 1):
            m &= ~((s == n - j) & in_z)
    return torch.as_tensor(m.astype(np.float32), device=device)


def tet_stripped_torch(u: torch.Tensor, w: torch.Tensor, dirs, n_taps: int,
                       pitch: int, mask: str) -> torch.Tensor:
    """Plain tet probe: u (C, N, N*pitch) f32, w (C, 15) f32, dirs (15, 3)."""
    _check_setting(n_taps, mask)
    C, N, _ = u.shape
    dirs = np.asarray(dirs)
    acc = torch.zeros_like(u)
    for s in range(n_taps):
        dx, dy, dz = (int(v) for v in dirs[s])
        v = torch.roll(u, (-dx, -(dy * pitch + dz)), dims=(1, 2))
        acc.addcmul_(v, w[:, s].view(C, 1, 1))
        del v
    M = tet_mask(N, pitch, mask, u.device)
    return acc if M is None else acc.mul_(M)


def tet_stripped(u: torch.Tensor, w: torch.Tensor, dirs, n_taps: int,
                 pitch: int, mask: str) -> torch.Tensor:
    """The tet probe. u: (C, N, N*pitch) f32; w: (C, 15) f32; dirs: the
    (15, 3) directions (``tet_dirs()``). A CPU tensor runs the plain
    version; a CUDA tensor launches the tet kernel of
    csrc/stripped_stencil.cu (n_taps 1, 6 or 15) and counts the launch in
    ``tet_stripped.launches``."""
    if u.device.type == "cpu":
        return tet_stripped_torch(u, w, dirs, n_taps, pitch, mask)
    _check_setting(n_taps, mask)
    if n_taps not in KERNEL_TAPS:
        raise ValueError(f"no tet_stripped kernel for n_taps={n_taps}; "
                         f"built: {KERNEL_TAPS}")
    if u.dim() != 3 or u.shape[2] != u.shape[1] * pitch or pitch < u.shape[1]:
        raise ValueError(f"u must be (C, N, N*pitch) with pitch >= N, got "
                         f"{tuple(u.shape)} at pitch {pitch}")
    C, N, L = u.shape
    table = np.ascontiguousarray(dirs, dtype=np.int32)
    if table.shape != (N_DIRS, 3):
        raise ValueError(f"dirs must be ({N_DIRS}, 3), got {table.shape}")
    _check_cuda_input("u", u, (C, N, L))
    _check_cuda_input("w", w, (C, N_DIRS))
    y = torch.empty_like(u)
    rc = build.library().hyteg_tet_stripped(
        u.data_ptr(), w.data_ptr(), y.data_ptr(), C, N, pitch,
        table.ctypes.data, n_taps, MASKS.index(mask), build.current_stream())
    build.check_launch(rc, "tet_stripped")
    tet_stripped.launches += 1
    return y


tet_stripped.launches = 0
