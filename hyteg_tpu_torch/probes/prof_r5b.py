"""Counterpart of scripts/prof_r5b.py: the tet stencil kernel B2 taken
apart on the P1 tet block (C, N, N*pitch).

- ``bench_copy_cells``: the copy rung over the block, kernel P1. The
  script times its Pallas copy with 1, 2 and 4 cells per grid step; a CUDA
  grid has no such step (the P1 kernel streams the flat block), so one
  rung stands for the three.
- ``bench_fma``: ``kernels.probes.tet_stripped`` with unit per-cell
  weights, the script's three settings: 15 taps and 6 taps without a
  mask, and 15 taps with the K0 and shell masks. Four settings the script
  does not time follow them. One tap without a mask, one with K0 and one
  with K0 and the shell: with one load per slot they cost B2's thread
  mapping (one thread per slot of the padded block, its 64-bit slot index
  divided into x and lane, the masked slots' early exit) over the copy,
  apart from the taps. And 15 taps with K0 and unit weights, which
  differs from kernel_probe's variant C only in the weights' values and
  from the shell rung only in the diagonal shell.
"""

from __future__ import annotations

import functools

import torch

from ..kernels.probes import N_DIRS, tet_dirs, tet_mask, tet_stripped
from ..kernels.stream import stream_scale
from . import Rung, TetSetup

SCRIPT = "scripts/prof_r5b.py"
#: (n_taps, mask, the script's tag, ladder rung), in the script's order
FMA_SETTINGS = ((15, "none", "tet fma (15 dirs, scalar w)", "shifted 15"),
                (6, "none", "tet fma (6 dirs, scalar w)", "shifted 6"),
                (15, "k0_shells", "tet fma+masks (15 dirs, scalar w)",
                 "+shells"))
#: the port's own settings: B2's mapping with a single tap, and K0 with
#: unit weights
MAPPING_SETTINGS = ((1, "none", "tet fma (1 dir, scalar w)", "shifted 1"),
                    (1, "k0", "tet fma+K0 (1 dir, scalar w)", "+k0 1 tap"),
                    (1, "k0_shells", "tet fma+masks (1 dir, scalar w)",
                     "+shells 1 tap"),
                    (15, "k0", "tet fma+K0 (15 dirs, scalar w)",
                     "+k0 unit w"))


def active_warps(N: int, pitch: int, mask: str, warp: int = 32) -> int:
    """Warps of one cell that hold a slot of the mask, in the grid B2 and
    tet_stripped share (a thread per slot of the flat (x, lane) index of
    the cell, in groups of ``warp``): the warps that run the taps."""
    M = tet_mask(N, pitch, mask, "cpu")
    if M is None:
        return -(-N * N * pitch // warp)
    M = M.flatten().bool()
    M = torch.cat([M, M.new_zeros((-M.numel()) % warp)])
    return int(M.view(-1, warp).any(1).sum())


def bench_copy_cells(tet: TetSetup) -> list[Rung]:
    return [Rung(SCRIPT, "copy tet-blocks", tuple(tet.x.shape),
                 functools.partial(stream_scale, tet.x), ladder="copy")]


def bench_fma(tet: TetSetup) -> list[Rung]:
    x, pitch = tet.x, tet.space.pitch
    w = torch.ones((x.shape[0], N_DIRS), device=x.device)
    return [Rung(SCRIPT, tag, tuple(x.shape),
                 functools.partial(tet_stripped, x, w, tet_dirs(), n_taps,
                                   pitch, mask), ladder=rung)
            for n_taps, mask, tag, rung in FMA_SETTINGS + MAPPING_SETTINGS]
