#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hyteg_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from hyteg_tpu_torch/csrc, checks each one
against its plain PyTorch version on the card, and drives the port's
paths, each with the kernels' launch counts set to 0 just before it and
read just after:

- the macro-tet path: a P1 Laplace GMG solve (Chebyshev smoothing,
  fixed-iteration CG coarse solve) on the 48-cell unit-cube macro mesh at
  levels 6 and 7 (kernels B2, B3), B2 and B3 first held against their
  plain versions at every level the level-7 stack launches them at
  (2-7, pitch 129, B2 timed at each; B3 also with a coefficient in the
  three means at each, and timed in each at level 7: ``b3_coeff``),
  with a torch.profiler breakdown of one level-7 V-cycle and B2's
  launches in it by level;
- the structured box path: box GMG V(2,2) solves of the manufactured
  Poisson problem on m = (2, 2, 2) at levels 6 and 7, then at level 9,
  1,076,890,625 DoFs on one card (kernel B1, f32 and bf16 storage, held
  against its plain version and timed beside its bound at every level
  3-9 of the stack), with a torch.profiler breakdown of one level-9
  V-cycle and B1's launches in it by level;
- the paired-tet engine (kernels B6, B7, B8): bench.py's bench_tet path,
  lift / apply_ex / lower gated against the classic apply (B2) on the
  unit cube at levels 6 and 7 and on the 1920-cell spherical shell at
  level 5, B6 timed beside its bound at each (``b6_levels``), B7 and B8
  beside theirs, their library calls and B8's sector floor at each, back
  to back and as CUDA graphs (``b7_b8_levels``), with a torch.profiler
  breakdown of chained applies at level 7;
- the variable-coefficient P1 operator (kernel B4, and B3 with a
  coefficient) at level 7: B4 against its plain version at every P1
  level 2-7 (pitch 129) without a coefficient and in the three averaging
  modes on two coefficients, B4 with k = 1 against B2, the operator's
  symmetry and positivity, and B4 timed in each mode beside its bound
  (``b4_coeff``, with B4-2D's at level 11);
- the P2 path (kernel B5): B5 against its plain version at every P2
  level the stack launches it at (1-6, pitch 129, timed at each);
  bench_vcycle.py's bench_p2 GMG stack on the unit cube at P2 level 6,
  16,974,593 DoFs, gated at a residual rate of 0.6, with a
  torch.profiler breakdown of one V-cycle and B5's launches in it by
  level; the manufactured P2 Poisson solve at levels 3-5; the P2
  coefficient apply at level 6;
- the Stokes path (kernels B5 and B3, their 2D forms in 2D):
  make_stokes_gmg's P2-P1 Taylor-Hood GMG with inexact-Uzawa smoothing,
  V(3,3), on the unit cube at P2 level 6, 53,070,468 DoFs, and on the
  rect at P2 level 8, 9,447,427 DoFs: B3 and B3-2D first held against
  their plain versions at P1 level 1 (pitch 129 in 3D); four V-cycles on
  A x = 0 from a random consistent start (gated as the JAX package's test
  gates them, each cycle's rate reported against 0.6); the block apply
  and the preconditioner against the plain B5 / B3, the operator's
  symmetry, a torch.profiler breakdown of one V-cycle with B5's launches
  by level, and the manufactured solve (MINRES) at two levels;
- the blended-geometry path (BASELINE config 4; kernels B2-2D, B2 and
  B3 on it, the blended operators plain torch): on the annulus
  mesh_annulus(0.5, 1, 12, 2) with the radial map, the rims and the area
  (against the affine mass, B2-2D) at P1 level 11, 100,687,872 DoFs, the
  exact blended Laplace apply timed there, the manufactured u = ln r by CG
  at levels 3-5 and the LSQP surrogate's error at level 4, degrees 1-3
  (``blend_2d``); on the 1920-tet shell with IcosahedralShellMap at P1
  level 5, 10,649,730 DoFs, the identity-map blended apply against the
  affine apply (B2), rims, volume, symmetry, the exact apply timed, the
  surrogate at degrees 1-3 timed and the manufactured u = 1/r at levels
  3-4 (``blend_shell``); tests/test_p2_blended.py's blended Stokes gate
  on mesh_spherical_shell(1, 2, 0.55, 1), then make_stokes_gmg(...,
  gmap=...) on the 1920-tet shell at P2 levels 0-3, 4,229,352 DoFs: two
  V(2,2) cycles on A x = 0 (each rate reported against 0.2), with a
  torch.profiler breakdown of one cycle and B3's launches at set-up
  (``blend_stokes``);
- the TerraNeo path (config 5's application; kernels B5, B3, B2, B4 and
  the 2D B5 and B3 on it): the kernels against their plain versions at
  the path's shapes (``terraneo_kernels``); ConvectionSimulation on the
  1920-tet shell with T at P2 level 4 (10,649,730 DoFs; the Stokes system
  33.3M DoFs), one coupled step (MINRES Stokes solve, MMOC transport,
  implicit energy step) timed from the simulation's TimingTree and gated as
  tests/test_terraneo.py gates them, with a torch.profiler breakdown of a
  second step (``terraneo_shell``); the same on the annulus at P2 level 8
  with eta(T), shear and adiabatic heating (``terraneo_annulus``);
  TransportOperatorStd's implicit step on the shell at P1 level 5 with
  adiabatic and shear heating (``terraneo_transport_std``); and the MMOC
  circular flow at P2 level 8 (``mmoc``);
- the sharded path (A8; kernels B2, B3, B5 and B1 on it): 4 shards of an
  SFC partition in one process on the one card (LocalGroup), each held
  against the one-shard run: at P1 level 7 the sharded applies against
  the one-shard apply, four V(3,3) cycles with the agglomerated coarse
  solve on the main path's problem against gmg_solve's residuals and on
  A x = 0 against the one-shard stack, a torch.profiler breakdown of one
  cycle, its B2 / B3 launches and the exchange's ms; on mesh_unit_cube(4)
  at level 5, where shards hold interior cells, the overlapped apply and
  B2 on its interface and interior sub-blocks against the plain version
  (``spmd_p1``); the Stokes V-cycle at 3D P2 level 6 from the Stokes
  path's start, one cycle against its residuals (``spmd_stokes``); the
  level-9 box solve over four row slabs against box_gmg_1e9's residuals,
  and B1 on a 3-row edge strip against its plain version
  (``spmd_box``); one convection step (one Stokes V-cycle) on the shell
  at P2 level 4, 4 shards against 1, both under torch's deterministic
  algorithms (``terraneo_spmd``); particle migration by one
  all_to_all (``migration``); and, only with 4 or more cards, the
  P1 V-cycle over NCCL, one process per card (``spmd_nccl``; on one card
  a line says it did not run);
- the stream-copy probe (kernel P1) at the level-7 and level-9 box sizes
  and the level-7 macro-tet and paired blocks: the card's measured
  bandwidth ceiling.
- the dissection probes (kernels P2): box_variant and tet_stripped
  checked against their plain versions, then every ladder of
  ``python -m hyteg_tpu_torch.probes`` (the B1 and B2 ladders at the
  profiling scripts' shapes and at the port's main-path blocks);
- the 2D arm on macro-faces (the 2D forms of B2, B3, B4 and B5): the
  kernels against their plain versions on the 12-face annulus at level 4
  and on the 32-face rectangle mesh_rectangle(nx=4, ny=4) at P1 level 11
  / P2 level 10, B2-2D, B3-2D and B4-2D also at every other P1 level
  2-10 and B5-2D at every other P2 level 1-9 of the stacks, B2-2D and B5-2D
  timed beside their bounds at each (``b2_2d_levels``,
  ``b5_2d_levels``); the P1 GMG solve of sin(pi x) sin(pi y) at level
  11, 67,125,249 DoFs, its rate gated on A x = 0 from a random start,
  with a torch.profiler breakdown of one V-cycle, B2-2D's launches in it
  by level and its ms lost against its per-level bounds; the P1
  coefficient operator at level 11 (B3-2D timed in each mean beside its
  bound: ``b3_2d_coeff``); the P2 GMG stack at P2 level 10, 67,125,249 DoFs, gated on a
  seeded rhs and on A x = 0, with a breakdown of one V-cycle and B5-2D's
  launches in it by level; the manufactured P2 solve at levels 1-3.
- the A10 phases (B2 and B3 in bf16; B2 and B3 in f32 under the other
  solvers): B2-bf16 and B3-bf16 against their plain versions at P1
  levels 2-7 (``bf16_kernels_vs_plain``); an f32 iterative refinement
  around the bf16 V(3,3) cycle of make_p1_gmg(dtype=bfloat16) at P1
  level 7 (``mixed_precision``); colored Gauss-Seidel under the flexible
  multigrid and FAS at level 7 (``solvers_extra``); Hiptmair-smoothed
  N1E1 cycles at element levels 4-6 (``n1e1``); DG1 SIP and EG Poisson
  solves and the operators' symmetry (``dg_eg``).
- the bf16 P2 and 2D GMGs (B5, B5-2D, B2-2D, B3-2D in bf16): an f32
  iterative refinement around one bf16 V(3,3) cycle a step of
  make_p2_gmg(dtype=bfloat16) on the P2 path's level-6 stack and rhs
  (``mixed_precision_p2``), of make_p1_gmg(dtype=bfloat16) on the 2D
  level-11 problem (``mixed_precision_2d``) and of make_p2_gmg on the 2D
  P2 level-10 rhs (``mixed_precision_p2_2d``), each on the f32 stack its
  phase built and gated against that stack's own plateau and the
  bf16-only loop; in 2D, where the scheme stops converging above P1
  level 8 / P2 level 6, the full-width runs report their histories and
  the gates hold at those levels (``*_gated``, MP_GATE_2D); B5-bf16 at every P2 level 1-6, B5-2D-bf16 at every 2D P2 level
  1-10 (``bf16_p2_kernels_vs_plain``), B2-2D-bf16 and B3-2D-bf16 at every
  2D P1 level 2-11 (``bf16_2d_kernels_vs_plain``), each within one bf16
  ulp and timed at its path's level; ``bf16_refusals`` checks the dtype
  contract of B2-B5 in 3D and 2D (f32 inputs beside a bf16 block give
  the bits of bf16 ones; what no kernel takes raises).
- the bf16 variable-coefficient path (B4, B4-2D, B3 and B3-2D with a
  coefficient in bf16): each form against its plain version at every P1
  level 2-7 (pitch 129) and 2-11 of the rect, B4 without a coefficient
  and every form in the three means on k = 1 + x + 0.5 y and a seeded
  random k, timed at the top level (``bf16_coeff_kernels``); an f32
  iterative refinement (B4 f32 residual) around one bf16 V(3,3) cycle a
  step of the coefficient hierarchy built by ``coeff_stack`` from
  make_p1_gmg's pieces (B4-bf16 applies, Chebyshev on the inverse
  diagonal with k, B3-bf16, its bounds from the f32 coefficient
  hierarchy) at 3D level 7 (``mixed_precision_coeff``) and on the rect
  at level 11 (``mixed_precision_coeff_2d``, reported) and level 8
  (``mixed_precision_coeff_2d_gated``), the f32 coefficient cycle's rate
  gated first.
- the AMR path (B2, B3, B2-2D, B3-2D on red-green refined meshes): on
  mesh_unit_cube(2) the bump's gradient indicator at P1 level 4 on the
  card (its Dörfler marks equal to the CPU's), red-green refinement to 106
  cells (conforming, volume and boundary measure kept), a linear field
  moved to the refined storage, the refined-mesh GMG at P1 levels 4-7
  (the nodal error dropping >= 3x from level 4 to 5; at level 7 each of
  cycles 1-4 on A x = 0 at rate <= 0.35),
  timed and profiled, and IO read back (a VTU of the field, the
  partitioning VTU, the mesh through Gmsh, one SQLite row) (``amr``); the
  same cycle on the rect, 40 faces, its GMG at level 11 on A x = 0
  (``amr_2d``); then B2, B3 at every level 2-7 of the refined cube and
  B2-2D, B3-2D at every level 2-11 of the refined rect against their plain
  versions (``amr_kernels``); the native setup core must build.

It times the kernels, the operator applies and the V-cycles with CUDA
events, and each kernel's least time on the card (its bytes over the
data-sheet memory rate or its f32 operations over the f32 peak) and,
where one exists, a single PyTorch call computing the same function.
Prints one JSON line per phase; the line before the last is
{"kernels": [...]}, and the last line is
{"ok": true, "device": {"platform": "gpu", ...}}. Any failed check raises,
so the exit code is non-zero and no result line is printed. Refuses to run
without CUDA. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from hyteg_tpu_torch.core.benchtime import card as smi_card
from hyteg_tpu_torch.core.benchtime import median_graph_ms, median_ms

START = time.perf_counter()
# cuBLAS's deterministic workspace, read when its first handle is made:
# terraneo_spmd runs under torch.use_deterministic_algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

MESH_N = 2            # mesh_unit_cube(2): 48 macro-tets
SLICE_LEVELS = (6, 7)
PITCH = (1 << 7) + 1  # one lane pitch for every level, as a GMG stack uses
N_CYCLES = 8
MIN_LEVEL = 2
# B2 and B3 vs plain at every level the level-7 GMG stack launches them at
# (pitch 129), B3 also with a coefficient
CHECK_LEVELS = tuple(range(MIN_LEVEL, SLICE_LEVELS[-1] + 1))
COARSE_ITERS = 30
B2_RTOL = 1e-5        # f32, 15-term sums taken in another order
B3_RTOL = 1e-6        # f32, <= 24-term sums taken in another order
RATE_MAX = 0.2        # geometric-mean residual reduction over cycles 1-4
ERR_DROP_MIN = 3.0    # O(h^2) predicts 4; f32 rounding eats into level 7
# the box path (bench.py's box settings: m = (2, 2, 2), V(2,2),
# min_level 3, 40 coarse CG iterations)
BOX_M = (2, 2, 2)
BOX_SLICE_LEVELS = (6, 7)
BOX_BIG_LEVEL = 9     # 1025^3 = 1,076,890,625 DoFs, 4.31 GB per f32 block
BOX_MIN_LEVEL = 3
# B1 vs plain (f32 and bf16) at every level of the level-9 box stack, each
# timed beside its bound (level 9 after its solve), and on m = (2, 1, 1)
BOX_CHECKS = (((2, 1, 1), BOX_MIN_LEVEL),) + tuple(
    (BOX_M, lv) for lv in range(BOX_MIN_LEVEL, BOX_BIG_LEVEL))
BOX_CYCLES = 12       # levels 6/7: down to the f32 floor
BOX_BIG_CYCLES = 6
BOX_RATE_MAX = 0.4    # bench.py's gate on the box V(2,2) residual rate
B1_RTOL = 1e-5        # f32, 15-term sums taken in another order
B1_BF16_ULP = 2.0 ** -7  # one bf16 ulp of an element is at most 2^-7 of it
B1_BF16_VS_F32 = 2e-2    # bench.py's gate, bf16 apply vs f32 apply
# the paired-tet engine (bench.py's bench_tet: Laplace, unit cube, level 6)
TETPAIR_CASES = (("cube", 6), ("cube", 7), ("shell", 5))
# (mesh, level, pitch) of the kernels-vs-plain checks: padding lanes, then
# every shape the path launches the kernels at
TETPAIR_CHECKS = (("cube", 4, PITCH),) + tuple(
    (mesh, level, None) for mesh, level in TETPAIR_CASES)
TETPAIR_TIME_LEVEL = 7
SHELL = (2, 2, 0.55, 1.0)  # mesh_spherical_shell: 1920 macro-tets
B6_RTOL = 1e-5        # f32, 15-term sums taken in another order
TETPAIR_RTOL = 1e-5   # bench_tet's gate (hyteg_tpu/core/benchgate.py:20)
# the P2 path (bench_vcycle.py's bench_p2: make_p2_gmg on the unit cube,
# min level 1, 20 coarse CG iterations, V(3,3), Chebyshev order 4)
P2_LEVEL = 6          # 16,974,593 DoFs; node block (48, 129, 16641)
P2_MIN_LEVEL = 1
# B5 vs plain at every level the P2 stack launches it at (pitch 129)
P2_CHECKS = tuple(range(P2_MIN_LEVEL, P2_LEVEL + 1))
P2_COARSE_ITERS = 20
P2_CYCLES = 4
P2_RATE_MAX = 0.6     # bench_vcycle.py's gate (:21-31)
P2_MANUFACTURED = (3, 4, 5)  # error drop gated from 3 to 4; 5 reported
P2_MANUFACTURED_CYCLES = 8
P2_ERR_DROP_MIN = 5.0  # O(h^3) predicts 8
B5_RTOL = 1e-5        # f32, 65-term sums taken in another order
# the variable-coefficient P1 operator (kernel B4): checked at every P1
# level the level-7 stack has (pitch 129)
B4_CHECKS = CHECK_LEVELS
B4_RTOL = 1e-5        # f32, 96-term sums and coefficient means reordered
SYM_RTOL = 1e-4       # <w, A v> against <v, A w>
# the dissection probes (kernels P2): (m, level, rows) of the box checks
# and (level, pitch) of the tet checks (None: the space's own pitch N) —
# padding lanes first, then the timed jax and main shapes. rows: None
# compares the whole block; (head, tail) runs the kernel on the whole
# level-9 block and the plain version on its first head and last tail
# rows (x is never shifted, so rows are independent; the last 65 of 1025
# rows hold the last whole 64-row tile and the 1-row tail tile)
PROBE_BOX_CHECKS = (((2, 1, 1), 3, None), ((2, 2, 2), 7, None),
                    ((2, 2, 2), 9, (64, 65)))
PROBE_TET_CHECKS = ((4, PITCH), (6, None), (7, None))
PROBE_RTOL = 1e-6     # f32, <= 15 terms in the same order, FMA contraction
# the 2D arm: macro-faces, blocks (C, N, N) with lane = z
RECT_2D = {"nx": 4, "ny": 4}      # mesh_rectangle: 32 macro-faces
ANNULUS_2D = (0.5, 1.0, 6, 1)     # mesh_annulus: 12 faces, all weights general
LEVEL_2D = 11         # N = 2049: (32, 2049, 2049) f32 = 537 MB, 67,125,249 DoFs
P2_LEVEL_2D = 10      # the same node grid and DoF count
# (mesh, P1 level, P2 level) of the 2D kernels-vs-plain checks
KERNEL_CHECKS_2D = (("annulus", 4, 4), ("rect", LEVEL_2D, P2_LEVEL_2D))
# the other levels of the rect P1 stack: B2-2D and B3-2D checked and B2-2D
# timed beside its bound at each
P1_CHECK_LEVELS_2D = tuple(range(MIN_LEVEL, LEVEL_2D))
# B5-2D vs plain also at every other level the rect P2 stack launches it
# at, each timed beside its bound
P2_CHECK_LEVELS_2D = tuple(range(1, P2_LEVEL_2D))
# B4-2D on the annulus at level 4 and at every level 2-11 of the rect stack
B4_CHECKS_2D = (("annulus", 4),) + tuple(
    ("rect", lv) for lv in range(MIN_LEVEL, LEVEL_2D + 1))
# f32 puts a floor under a 2D solve's nodal error and residual that rises
# with the level (b ~ h^2 against A x rounded at |x| ~ 1): the O(h^2) drop
# is gated from level 5 to 6, level 7 reports where the floor begins, and
# the level-11 rate is gated on A x = 0 from a random start (no floor)
ERR_LEVELS_2D = (5, 6, 7)
HOMOGENEOUS_CYCLES = 6   # rates over cycles 1-4 and 3-6, both gated
P2_CYCLES_2D = 8
# bench_vcycle's f32 floor for its gate is 1e-6 of r0 on the 3D level-6 P2
# grid (256 intervals per edge); the floor grows with the condition number,
# as h^-2, so on the 2D level-10 grid (8192 intervals) it is 1e-6 * 32^2.
# The level-10 rate itself is gated on A x = 0 (homogeneous_rates), which
# has no floor
P2_FLOOR_REL_2D = 1e-3
P2_MANUFACTURED_2D = (1, 2, 3)  # drop gated 1 -> 2; 3 sits at the f32 floor
P2_MANUFACTURED_MIN_2D = 0
# the Stokes path (BASELINE config 3): make_stokes_gmg's P2-P1 Taylor-Hood
# GMG with inexact-Uzawa smoothing, V(3,3), omega_p 0.4
# (tests/test_stokes.py:157), MINRES with the block-diagonal
# preconditioner on level 1 (make_stokes_gmg's 80 steps at most, rtol 1e-8)
STOKES_LEVEL = 6          # 3D, mesh_unit_cube(2): 53,070,468 DoFs
STOKES_LEVEL_2D = 8       # 2D, the rect: 9,447,427 DoFs
STOKES_MIN_LEVEL = 1
STOKES_KW = {"pre_smooth": 3, "post_smooth": 3, "omega_p": 0.4}
STOKES_APPLY_RTOL = 1e-5  # the block apply and the preconditioner vs plain
STOKES_SYM_RTOL = 2e-3    # <b, A a> vs <a, A b> (tests/test_stokes.py:97)
# V-cycle on A x = 0 from a random consistent start: the JAX package's
# gate (tests/test_stokes.py:179-180) on cycles 1-4, the best cycle's rate
# <= 0.6 and the residual below 0.02 of the start; each cycle's rate is
# reported against 0.6 (the method misses it: ROADMAP.md C-ref8)
STOKES_RATE_MAX = 0.6
STOKES_FINAL_MAX = 0.02
STOKES_CYCLES = 4
# manufactured solve (u = curl psi, tests/test_stokes.py:19-23 in 2D) by
# MINRES with the block-diagonal preconditioner (tests/test_stokes.py:
# 101-145), which must meet its own stopping test: the velocity L2 error
# drop (O(h^3): 8x), in 3D from level 2 to 3, in 2D (the rect's 32 faces)
# from 1 to 2. The true float32 residual is reported against the JAX
# test's 1e-4 of |b| (tests/test_stokes.py:133, 2D level 2): it grows
# with the level, ~5x a level, and misses 1e-4 at 3D level 4 in the JAX
# package alike (PERF.md section 6). 3D levels 3 -> 4 (977 MINRES steps
# at level 4, 62 s on the card) would not fit the script's time limit
STOKES_MANUFACTURED = {3: (2, 3), 2: (1, 2)}
STOKES_MINRES_RTOL = 1e-6
STOKES_MINRES_ITERS = 6000
STOKES_MINRES_RESIDUAL = 1e-4
STOKES_ERR_DROP_MIN = 4.0
# the blended path (BASELINE config 4): RadialMap on the annulus and
# IcosahedralShellMap on the shell, exact blended operators (plain torch)
BLEND_ANNULUS = (0.5, 1.0, 12, 2)  # mesh_annulus: 48 faces
BLEND_LEVEL_2D = 11    # 100,687,872 DoFs, one (48, 2049, 2049) 806 MB block
BLEND_LEVEL_3D = 5     # the shell (SHELL): 10,649,730 DoFs
RIM_ATOL = 1e-5        # tests/test_blending.py::test_radial_map_snaps_rims
AREA_RATIO_MAX = 0.05  # blended area / volume error below 0.05 x the affine
IDENTITY_RTOL = 2e-4   # identity-map blended apply vs affine, of max(1, |y|)
BLEND_CG_RTOL = 1e-7   # tests/test_blending.py:92
BLEND_CG_ITERS = 2000
BLEND_ERR_LEVELS_2D = (3, 4, 5)  # L2 error < 2e-3 at 3, drop >= 3x 4 -> 5
BLEND_ERR_LEVELS_3D = (3, 4)     # drop >= 3x (O(h^2) predicts 4x)
BLEND_L2_MAX = 2e-3    # tests/test_blending.py:99, level 3
BLEND_DROP_MIN = 3.0
SURROGATE_DEGREES = (1, 2, 3)
SURROGATE_LEVEL_2D = 4
SURROGATE_MAX = 0.05   # degree 3, tests/test_blending.py:125
# tests/test_p2_blended.py:104-132: mesh_spherical_shell(1, 2, 0.55, 1),
# P2 levels 0-1, epsilon, eigs 3.0, 40 MINRES steps, V(2,2): r3 < 0.2 r0
BLEND_STOKES_GATE_MESH = (1, 2, 0.55, 1.0)
BLEND_STOKES_GATE_LEVELS = (0, 1)
BLEND_STOKES_GATE_EIG = 3.0
BLEND_STOKES_GATE_COARSE_ITERS = 40
BLEND_STOKES_GATE_CYCLES = 3
BLEND_STOKES_GATE_RATIO = 0.2
BLEND_EPS_SYM_RTOL = 1e-3  # tests/test_p2_blended.py:96
# the 1920-tet shell at P2 levels 0-3 (4,229,352 DoFs), make_stokes_gmg's
# defaults (V(2,2), omega_p 0.3, 80 MINRES steps) and power-iteration
# eigs; only "every cycle finite" and "the first cycle cuts the residual"
# are gated (the affine 3D cycle grows after its first cycle, ROADMAP
# C-ref8); each rate is reported against 0.2. To fit the script's time
# limit, level 3 (level 4, 33,300,936 DoFs, took 31-37 s a cycle on the
# card, mostly host launches) and two cycles with a profiled third
BLEND_STOKES_LEVEL = 3
BLEND_STOKES_CYCLES = 2
BLEND_RATE_REF = 0.2
# cycle_profile's kernel groups on the blended path: B3 (set-up), cuBLAS
# products (the P2 quadrature's small products, the surrogate's
# polynomials), the exchanges and the reductions; the elementwise passes
# are the rest
BLEND_GROUPS = {"b3": ("p1_diag",), "gemm": ("gemm", "gemv"),
                "index": ("index", "scatter", "gather"), "reduce": ("reduce",)}
# the TerraNeo path (config 5's application, ConvectionSimulation): the
# 1920-tet shell (SHELL) with T at P2 level 4 (10,649,730 DoFs) and the
# P2-P1 Stokes system of 33.3M DoFs; the annulus at P2 level 8 with
# eta(T), shear and adiabatic heating; ConvectionParameters' defaults
# otherwise (120 MINRES steps, energy CG to rtol 1e-7 in 200 steps)
TERRANEO_SHELL = {"dim": 3, "ntan": 2, "nrad": 2, "level": 4}
TERRANEO_ANNULUS = {"dim": 2, "ntan": 12, "nrad": 2, "level": 8,
                    "visc_activation": 2.0, "shear_heating": True,
                    "adiabatic_heating": 0.1}
TERRANEO_ANNULUS_MESH = (0.55, 1.0, 12, 2)  # what ConvectionSimulation builds: 48 faces
TERRANEO_STEPS = 1  # and one more under the profiler
# tests/test_terraneo.py's gates: T within [-0.05, 1.05] after the steps,
# ||div u|| < 0.05 max|u| after the Stokes solve
TERRANEO_T_RANGE = (-0.05, 1.05)
TERRANEO_DIV_REL = 0.05
# TransportOperatorStd on the shell at P1 level 5 (10,649,730 DoFs)
TERRANEO_STD_LEVEL = 5
TERRANEO_STD_DT = 1e-3
# tests/test_transport.py's circular flow at P2 level 8 and its gates
MMOC_LEVEL = 8
MMOC_STEPS = 8
MMOC_ERR_MAX = 0.15
MMOC_MAX = 1.15
MMOC_MIN = -0.2
# the sharded path (A8): 4 shards of an SFC partition in one process on
# the one card (LocalGroup), each result held against the one-shard run
SPMD_SHARDS = 4
SPMD_P1_LEVEL = 7         # mesh_unit_cube(2): 16,974,593 DoFs
SPMD_P1_CYCLES = 4
# the overlapped apply splits only where a shard has interior cells: on
# mesh_unit_cube(2) every cell of a 12-cell shard touches the interface,
# on mesh_unit_cube(4) 72 of a shard's 96 cells do; the sharded P1
# path's level, so that B2 runs on the sub-blocks at the path's N = 129
SPMD_OVERLAP_CASE = (4, SPMD_P1_LEVEL)  # (mesh_unit_cube n, P1 level)
SPMD_CYCLE_REL = 1e-3     # each cycle's residual against the one-shard one
SPMD_APPLY_REL = 1e-5     # the sharded applies against the one-shard apply
SPMD_STOKES_CYCLES = 1    # 26 s a sharded cycle on the card
# the sharded convection step on TERRANEO_SHELL: one Stokes V-cycle a
# step (the model's default is two) to fit the script's time limit; the
# step is host-bound (P2 level 3 took as long as level 4 on the card)
SPMD_CONV_STOKES_CYCLES = 1
SPMD_CONV_REL = 2e-5      # tests/test_terraneo_spmd.py's bound
SPMD_PARTICLES = 4096     # per shard, with twice the slots
# A10 (mixed precision, colored GS / FAS, N1E1, DG1, EG)
BF16_CHECK_LEVELS = tuple(range(MIN_LEVEL, SLICE_LEVELS[-1] + 1))
MP_LEVEL = 7
MP_OUTER = 10            # f32 outer steps, one bf16 V(3,3) cycle each
MP_PLATEAU_FACTOR = 2.0  # refined residual <= 2 x the f32 GMG's plateau
MP_BF16_RATIO = 0.1      # and < 0.1 x the bf16-only loop's
# The 2D mixed-precision paths (rect, 32 faces) reach their f32 plateau in
# MP_OUTER steps only up to these levels (on an H100, NVIDIA H100 80GB
# HBM3, 700 W: 1.58x at P1 level 8, 1.46x at P2 level 6; 4.2x / 4.0x one
# level up; no convergence at P1 level 10-11, divergence at P2 level
# 9-10; ROADMAP C-ref15): the bf16 rounding of
# the correction and of the residual grows with the condition number,
# which at 8192 intervals a side is ~10^3 x that of the 3D paths. The
# gates hold there; the full-width runs (P1 level 11, P2 level 10) report
# their histories, with the bf16 types and a finite bf16 cycle gated.
MP_GATE_2D = {"p1": 8, "p2": 6}
# the f32 coefficient solve before its refinement: flat from cycle 4 (3D
# level 7) or earlier (2D) on the card, so its last 3 of 6 are its plateau
MP_COEFF_CYCLES = 6
XTRA_CYCLES = 4
XTRA_GS_SWEEPS = 2       # symmetric sweeps: one reaches rate 0.20 by cycle 5
FAS_REL = 0.05           # FAS vs the linear V-cycle, per cycle
N1E1_LEVELS = (4, 5, 6)  # element levels (nodes at level + 1)
N1E1_CYCLES = 4
N1E1_COARSE_SWEEPS = 30
N1E1_RATE_MAX = 0.5      # tests/test_n1e1_transfer.py's gates
N1E1_ALPHA, N1E1_BETA = 1.0, 0.1
CURL_GRAD_RTOL = 1e-5    # |curl grad p| against the size of its terms
DG_LEVELS = (3, 4)       # 48-cell cube: 196,608 and 786,432 DG1 DoFs; its
                         # CG is launch-bound (~15 ms a step at any level),
                         # so the levels set the steps: 4 -> 5 (6,291,456
                         # DoFs) took 85 s on a slow host (PERF.md 5)
DG_CG_ITERS, DG_CG_RTOL = 6000, 1e-8  # tests/test_dg.py's cross-macro rtol
DG_DROP_MIN = 2.8        # tests/test_dg.py:90-97 (O(h^2) predicts 4)
DG_F32_FACTOR = 2.0      # float32 error / float64 error at one level
EG_LEVELS = (3, 4)       # one macro-tet: the EG operator takes one cell;
                         # its apply is launch-bound (~0.3 s at any level):
                         # 4 -> 5 took 67.5 s on a slow host (PERF.md 5)
EG_CG_ITERS, EG_CG_RTOL = 4000, 1e-7
EG_DROP_MIN = 2.5        # tests/test_eg.py:138-141
A10_SYM_RTOL = 1e-4
# the AMR path (adaptivity, IO): mark, refine, transfer, the refined-mesh GMG
AMR_LEVEL = 4            # the 3D indicator's and transfer's P1 level
AMR_LEVEL_2D = 6         # the rect's
AMR_FRAC = 0.5           # Dörfler fraction: 3 of 48 cells -> 106 (48 green)
AMR_GMG_LEVELS = (4, 5, 6, 7)  # refined cube, manufactured; 7 timed
AMR_ERR_LEVELS = (4, 5)  # the error drop: on this mesh level 7's error sits
                         # on the f32 floor and level 6's carries its noise
                         # (5 -> 6 read 3.4-4.4x over five runs; PERF.md
                         # section 6)
AMR_GMG_LEVEL_2D = 11    # refined rect (40 faces): (40, 2049, 2049) blocks
AMR_CYCLES = 16          # the rate rises towards 0.4 (ROADMAP C-ref21): 8
                         # cycles leave the algebraic error above the nodal
AMR_RATE_MAX = 0.35      # on A x = 0 at the top level (3D and 2D): each of
                         # cycles 1-4, the means over 1-4 and 3-6
AMR_GROWTH_MAX = 2.0     # tests/test_gmg_regression.py: no cycle grows > 2x,
AMR_GROWTH_SLACK = 1e-4  # + 1e-4 r0 (its 1e-5 absolute at r0 ~ 0.1)
AMR_MEASURE_RTOL = 1e-12  # tests/test_amr.py: volume and boundary measure
AMR_TRANSFER_ATOL = 5e-5  # tests/test_amr.py:126-127, the linear field
# the card's data-sheet peaks: H100 SXM
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
REPLACES = {
    "p1_const_apply": ("hyteg_tpu_torch/csrc/p1_const_stencil.cu",
                       "hyteg_tpu/kernels/p1_const_stencil.py:746"),
    "p1_diagonal_local": ("hyteg_tpu_torch/csrc/p1_diag.cu",
                          "hyteg_tpu/kernels/p1_stencil.py:303"),
    "box_apply": ("hyteg_tpu_torch/csrc/box_stencil.cu",
                  "hyteg_tpu/kernels/box_stencil.py:210"),
    "stream_scale": ("hyteg_tpu_torch/csrc/stream.cu",
                     "scripts/prof_r5.py:46"),
    "pair_apply": ("hyteg_tpu_torch/csrc/tetpair.cu",
                   "hyteg_tpu/tetpair/kernel.py:295"),
    "pair_install": ("hyteg_tpu_torch/csrc/tetpair.cu",
                     "hyteg_tpu/tetpair/kernel.py:337"),
    "pair_extract": ("hyteg_tpu_torch/csrc/tetpair.cu",
                     "hyteg_tpu/tetpair/kernel.py:381"),
    "p1_apply_local": ("hyteg_tpu_torch/csrc/p1_apply.cu",
                       "hyteg_tpu/kernels/p1_stencil.py:222"),
    "p2_const_apply": ("hyteg_tpu_torch/csrc/p2_const_stencil.cu",
                       "hyteg_tpu/kernels/p2_const_stencil.py:432"),
    "box_variant": ("hyteg_tpu_torch/csrc/stripped_stencil.cu",
                    "scripts/prof_r5.py:111"),
    "tet_stripped": ("hyteg_tpu_torch/csrc/stripped_stencil.cu",
                     "scripts/prof_r5b.py:122, scripts/kernel_probe.py:101"),
    "p1_const_apply_2d": ("hyteg_tpu_torch/csrc/p1_const_stencil.cu",
                          "hyteg_tpu/kernels/p1_const_stencil.py:746 (dim 2)"),
    "p1_diagonal_local_2d": ("hyteg_tpu_torch/csrc/p1_tri.cu",
                             "hyteg_tpu/kernels/p1_stencil.py:303 (dim 2)"),
    "p1_apply_local_2d": ("hyteg_tpu_torch/csrc/p1_tri.cu",
                          "hyteg_tpu/kernels/p1_stencil.py:222 (dim 2)"),
    "p2_const_apply_2d": ("hyteg_tpu_torch/csrc/p2_const_stencil.cu",
                          "hyteg_tpu/kernels/p2_const_stencil.py:432 (dim 2)"),
    "p1_const_apply_bf16": ("hyteg_tpu_torch/csrc/p1_const_stencil.cu",
                            "hyteg_tpu/kernels/p1_const_stencil.py:746,776 "
                            "(bf16 source)"),
    "p1_diagonal_local_bf16": ("hyteg_tpu_torch/csrc/p1_diag.cu",
                               "hyteg_tpu/kernels/p1_stencil.py:303 (bf16 "
                               "element matrices)"),
    "p2_const_apply_bf16": ("hyteg_tpu_torch/csrc/p2_const_stencil.cu",
                            "hyteg_tpu/kernels/p2_const_stencil.py:432 "
                            "(bf16 source)"),
    "p2_const_apply_2d_bf16": ("hyteg_tpu_torch/csrc/p2_const_stencil.cu",
                               "hyteg_tpu/kernels/p2_const_stencil.py:432 "
                               "(dim 2, bf16 source)"),
    "p1_const_apply_2d_bf16": ("hyteg_tpu_torch/csrc/p1_const_stencil.cu",
                               "hyteg_tpu/kernels/p1_const_stencil.py:776 "
                               "(dim 2, bf16 source)"),
    "p1_diagonal_local_2d_bf16": ("hyteg_tpu_torch/csrc/p1_tri.cu",
                                  "hyteg_tpu/kernels/p1_stencil.py:303 (dim "
                                  "2, bf16 element matrices)"),
    "p1_apply_local_bf16": ("hyteg_tpu_torch/csrc/p1_apply.cu",
                            "hyteg_tpu/kernels/p1_stencil.py:222 (bf16 "
                            "source)"),
    "p1_apply_local_2d_bf16": ("hyteg_tpu_torch/csrc/p1_tri.cu",
                               "hyteg_tpu/kernels/p1_stencil.py:222 (dim 2, "
                               "bf16 source)"),
    "p1_diagonal_local_coeff_bf16": ("hyteg_tpu_torch/csrc/p1_diag.cu",
                                     "hyteg_tpu/kernels/p1_stencil.py:303 "
                                     "(bf16 element matrices, with a "
                                     "coefficient)"),
    "p1_diagonal_local_2d_coeff_bf16": ("hyteg_tpu_torch/csrc/p1_tri.cu",
                                        "hyteg_tpu/kernels/p1_stencil.py:303 "
                                        "(dim 2, bf16 element matrices, with "
                                        "a coefficient)"),
}
# the short names of the bf16 GMGs' rows (B5, B5-2D, B2-2D, B3-2D) and of
# the bf16 coefficient path's (B4, B4-2D, B3 and B3-2D with a coefficient)
BF16_LABELS = {"p2_const_apply_bf16": "b5_bf16",
               "p2_const_apply_2d_bf16": "b5_2d_bf16",
               "p1_const_apply_2d_bf16": "b2_2d_bf16",
               "p1_diagonal_local_2d_bf16": "b3_2d_bf16",
               "p1_apply_local_bf16": "b4_bf16",
               "p1_apply_local_2d_bf16": "b4_2d_bf16",
               "p1_diagonal_local_coeff_bf16": "b3_coeff_bf16",
               "p1_diagonal_local_2d_coeff_bf16": "b3_2d_coeff_bf16"}
# the one PyTorch call timed beside each kernel (library_ms), or why none
LIBRARY_CALLS = {
    "p1_const_apply": "F.conv3d grouped per cell, interior stencil (equal to "
                      "B2 on interior points only), cuDNN TF32 off",
    "p1_diagonal_local": None,  # no library call builds an FE diagonal
    "box_apply": "F.conv3d, an interior lane's 15 weights (equal to B1 on "
                 "interior points only), cuDNN TF32 off",
    "stream_scale": "torch.mul(src, 2.0, out=dst)",
    "pair_apply": None,    # a fused install + apply + extract: no such call
    "pair_install": "torch.index_put of the installed positions' values "
                    "into the flat block, out of place (indices and values "
                    "staged before the timed call)",
    "pair_extract": "torch.take of the kept face entries from the flat "
                    "block (the masked zeros left out)",
    "p1_apply_local": None,  # per-element coefficient means: no conv form
    "p2_const_apply": None,  # weights vary with node parity: no conv form
    "box_variant": "nn.Conv1d(1, 1, 2Z+3, padding=Z+1, padding_mode="
                   "'circular', bias=False), the taps' unit weights summed at "
                   "lane offsets ls + Z + 1, the X rows as the batch",
    "tet_stripped": None,  # a mask after a circular conv is no single call
    "p1_const_apply_2d": "F.conv2d grouped per face, interior 7-point "
                         "stencil (equal to B2-2D on interior points only), "
                         "cuDNN TF32 off",
    "p1_diagonal_local_2d": None,  # no library call builds an FE diagonal
    "p1_apply_local_2d": None,  # per-element coefficient means: no conv form
    "p2_const_apply_2d": None,  # weights vary with node parity: no conv form
    "p1_const_apply_bf16": "F.conv3d grouped per cell in bf16, interior "
                           "stencil (equal to B2-bf16 on interior points "
                           "only)",
    "p1_diagonal_local_bf16": None,  # no library call builds an FE diagonal
    "p2_const_apply_bf16": None,  # weights vary with node parity: no conv form
    "p2_const_apply_2d_bf16": None,  # the same
    "p1_const_apply_2d_bf16": "F.conv2d grouped per face in bf16, interior "
                              "7-point stencil (equal to B2-2D-bf16 on "
                              "interior points only)",
    "p1_diagonal_local_2d_bf16": None,  # no library call builds an FE diagonal
    "p1_apply_local_bf16": None,  # per-element coefficient means: no conv form
    "p1_apply_local_2d_bf16": None,  # the same
    "p1_diagonal_local_coeff_bf16": None,  # no call builds an FE diagonal
    "p1_diagonal_local_2d_coeff_bf16": None,  # the same
}


def ptxas_by_function(log: str) -> dict:
    """ptxas -v's report per compiled function, by mangled name: spill
    stores in bytes and, for a kernel, its registers."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                out[name]["spill_stores"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[name]["registers"] = int(m.group(1))
    return out


def emit(phase: str, **fields) -> None:
    """One JSON line; ``at_s`` is the script's wall clock when it is printed."""
    print(json.dumps({"phase": phase, "at_s": time.perf_counter() - START,
                      **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def exact(dim: int):
    """u = prod_i sin(pi x_i) over the first dim coordinates, and f =
    dim pi^2 u (-laplace u = f, u = 0 on the unit square's or cube's
    boundary)."""
    def u(p):
        out = torch.sin(math.pi * p[..., 0])
        for i in range(1, dim):
            out = out * torch.sin(math.pi * p[..., i])
        return out

    return u, lambda p: dim * math.pi ** 2 * u(p)


def check_kernels(storage, level: int, device, seed: int) -> dict:
    """Kernels B2 and B3 against their plain versions at one level (3D
    with pitch 129, or 2D), B2's Laplace apply timed beside its bound
    (``b2_ms``, ``b2_bound_ms``); B3 also with a coefficient in the three
    means."""
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.kernels import p1_stencil as b3
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.averaging import MODES
    from hyteg_tpu_torch.operators.p1_elementwise import compute_elmats

    sp = P1Space(storage, level, device=device, pitch=PITCH)
    dim, pitch = sp.dim, sp.pitch
    gen = torch.Generator(device=device).manual_seed(seed)
    outside = ~sp.vertex_mask_t.bool()
    out = {"level": level, "block": list(sp.block_shape),
           "global_dofs": sp.num_global_dofs()}
    cv = sp.resolve_sd().cell_vertices
    for name, form in (("laplace", forms.laplace_form),
                       ("mass", forms.mass_form)):
        elm = compute_elmats(sp, form, cv).contiguous()
        A = b2.stencil_weights(elm, dim).contiguous()
        E = b2.face_weights_full(elm, dim).contiguous()
        x = torch.randn(sp.block_shape, generator=gen, device=device)
        x *= sp.vertex_mask_t
        y = b2.p1_const_apply(x, A, E, level, dim, pitch)
        y_ref = b2.p1_const_apply_torch(x, A, level, dim, pitch, E=E)
        err = (y - y_ref).abs().max().item()
        scale = y_ref.abs().max().item()
        check(math.isfinite(err) and err <= B2_RTOL * scale,
              f"B2 {name} level {level}: max|dy| {err} > {B2_RTOL} * {scale}")
        check(not y[:, outside].any().item(),
              f"B2 {name} level {level}: nonzero outside the tet / padding")
        out[f"b2_{name}_max_abs_err"] = err
        out[f"b2_{name}_max_abs"] = scale
        if name == "laplace":
            out["b2_ms"] = median_ms(
                lambda: b2.p1_const_apply(x, A, E, level, dim, pitch), 10,
                batch=10)
            out["b2_bound_ms"] = bound(*b2_work(sp, x, A, E))[0]
        del x, y, y_ref
        # B3: diagonal (Laplace and mass), lumped (mass; Laplace row sums
        # vanish), and the coefficient modes
        co = torch.rand(sp.block_shape, generator=gen, device=device)
        co = (0.5 + 1.5 * co) * sp.vertex_mask_t
        cases = [(False, None, "arithmetic"), (True, None, "arithmetic")]
        cases += [(lumped, co, m) for lumped in (False, True) for m in MODES]
        for lumped, co, mode in cases:
            if lumped and name == "laplace":
                continue
            d = b3.p1_diagonal_local(elm, level, dim, pitch, lumped, co, mode)
            d_ref = b3.p1_diagonal_local_torch(elm, level, dim, pitch, lumped,
                                               co, mode)
            err = (d - d_ref).abs().max().item()
            scale = d_ref.abs().max().item()
            tag = (f"{name}{'_lumped' if lumped else ''}"
                   f"{'_' + mode if co is not None else ''}")
            check(math.isfinite(err) and err <= B3_RTOL * scale,
                  f"B3 {tag} level {level}: max|dd| {err} > {B3_RTOL} * {scale}")
            check(not d[:, outside].any().item(),
                  f"B3 {tag} level {level}: nonzero outside the tet / padding")
            out[f"b3_{tag}_max_abs_err"] = err
    return out


def manufactured(stack):
    """x0 = u on Dirichlet rows, b = M f on the solved rows, u exact."""
    from hyteg_tpu_torch.core.types import BoundaryCondition, DoFType, FLAG_INNER
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator

    sp, bc = stack.space(), BoundaryCondition.all_dirichlet()
    sol, rhs = exact(sp.dim)
    mass = P1ElementwiseOperator(sp, forms.mass_form)
    x0 = sp.interpolate(sol, sp.zeros(), DoFType.DIRICHLET, bc)
    f = sp.interpolate(rhs, sp.zeros(), DoFType.ALL, bc)
    b = sp.restore_rows(mass.apply_raw(f), sp.zeros(), FLAG_INNER, bc)
    u = sp.interpolate(sol, sp.zeros(), DoFType.ALL, bc)
    return x0, b, u


def solve(storage, level: int, device, gate_rate: bool = True,
          cycles: int = N_CYCLES) -> tuple[dict, object, tuple]:
    """The main path: GMG stack set-up plus ``cycles`` V-cycles (the rate
    over cycles 1-4 gated at RATE_MAX when ``gate_rate``)."""
    from hyteg_tpu_torch.solvers.templates import make_p1_gmg

    t0 = time.perf_counter()
    stack = make_p1_gmg(storage, min_level=MIN_LEVEL, max_level=level,
                        smoother="chebyshev", coarse_iters=COARSE_ITERS,
                        device=device)
    x, b, u = manufactured(stack)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    res = [stack.residual_norm(x, b).item()]
    t0 = time.perf_counter()
    for _ in range(cycles):
        x = stack.gmg.cycle(x, b)
        res.append(stack.residual_norm(x, b).item())
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    sp = stack.space()
    err = ((x - u).abs() * sp.vertex_mask_t).max().item()
    rate = (res[4] / res[0]) ** 0.25
    check(all(math.isfinite(r) for r in res) and math.isfinite(err),
          f"level {level}: non-finite residual or solution")
    check(not gate_rate or rate <= RATE_MAX,
          f"level {level}: residual rate {rate} > {RATE_MAX}")
    out = {"level": level, "global_dofs": sp.num_global_dofs(),
           "residuals": res, "rate_cycles_1_4": rate, "max_nodal_error": err,
           "setup_s": setup_s, "solve_s_incl_residual_norms": solve_s,
           "eigs": stack.eigs}
    return out, stack, (x, b)


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    d = a.float() - b.float()
    return d.abs_().max().item()


def bf16_ulp_excess(yb: torch.Tensor, ref: torch.Tensor, scale: float) -> float:
    """max |yb - ref| / (2^-7 |ref| + B1_RTOL * scale) over the block: at
    most 1 when every element is within one bf16 ulp of the plain value
    (the B1_RTOL term covers sums that cancel to near zero). A kernel that
    accumulated in bf16 lands several ulps off in many elements."""
    tol = ref.float().abs().mul_(B1_BF16_ULP).add_(B1_RTOL * scale)
    d = yb.float().sub(ref.float()).abs_()
    return d.div_(tol).max().item()


def box_sol(x, y, z):
    return (torch.sin(math.pi * x) * torch.sin(math.pi * y)
            * torch.sin(math.pi * z))


def check_box_kernels(m, level: int, device, seed: int) -> dict:
    """Kernel B1 against its plain version (f32 and bf16 storage) and the
    bf16 apply against the f32 one, for Laplace and mass, at one size; the
    Laplace apply timed in both storages (``b1_ms``, ``b1_bf16_ms``)
    beside its bounds."""
    from hyteg_tpu_torch.kernels import box_stencil as b1
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.structured import BoxDomain, BoxStencilOperator

    dom = BoxDomain(m, level, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {"m": list(m), "level": level, "block": list(dom.block_shape),
           "dofs": dom.num_dofs()}
    for name, form in (("laplace", forms.laplace_form),
                       ("mass", forms.mass_form)):
        w = BoxStencilOperator(dom, form).w_vecs
        u = torch.randn(dom.block_shape, generator=gen, device=device)
        y = b1.box_apply(u, w, dom.dims)
        y_ref = b1.box_apply_torch(u, w, dom.dims)
        err, scale = max_abs_diff(y, y_ref), y_ref.abs().max().item()
        check(math.isfinite(err) and err <= B1_RTOL * scale,
              f"B1 f32 {name} {dom.block_shape}: max|dy| {err} > "
              f"{B1_RTOL} * {scale}")
        del y_ref
        ub = u.to(torch.bfloat16)
        yb = b1.box_apply(ub, w, dom.dims)
        yb_ref = b1.box_apply_torch(ub, w, dom.dims)
        check(yb.dtype == torch.bfloat16, "B1 bf16 result is not bf16")
        err_b = max_abs_diff(yb, yb_ref)
        excess = bf16_ulp_excess(yb, yb_ref, scale)
        check(math.isfinite(excess) and excess <= 1.0,
              f"B1 bf16 {name} {dom.block_shape}: an element is "
              f"{excess} x (1 bf16 ulp + {B1_RTOL} * {scale}) off")
        del yb_ref
        rel = max_abs_diff(yb, y) / yb.float().abs().max().item()
        check(math.isfinite(rel) and rel <= B1_BF16_VS_F32,
              f"B1 bf16 vs f32 {name} {dom.block_shape}: rel {rel} > "
              f"{B1_BF16_VS_F32}")
        out[f"b1_{name}_max_abs_err"] = err
        out[f"b1_{name}_max_abs"] = scale
        out[f"b1_bf16_{name}_max_abs_err"] = err_b
        out[f"b1_bf16_{name}_ulp_excess"] = excess
        out[f"b1_bf16_vs_f32_{name}_rel"] = rel
        if name == "laplace":
            n = 5 if dom.num_dofs() > 5e8 else 10
            for tag, v in (("b1", u), ("b1_bf16", ub)):
                out[f"{tag}_ms"] = median_ms(
                    lambda: b1.box_apply(v, w, dom.dims), n, batch=n)
                out[f"{tag}_bound_ms"] = bound(2 * nbytes(v) + nbytes(w),
                                               30 * v.numel())[0]
        del u, y, yb, ub, w
        torch.cuda.empty_cache()
    return out


def box_solve(level: int, device, cycles: int) -> tuple[dict, list, tuple]:
    """The box path: hierarchy set-up, the manufactured rhs b = M f, and
    solve_poisson's V(2,2) cycles from u = 0."""
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.structured import BoxDomain, BoxStencilOperator
    from hyteg_tpu_torch.structured import gmg

    t0 = time.perf_counter()
    dom = BoxDomain(BOX_M, level, device=device)
    levels = gmg.build_hierarchy(dom, min_level=BOX_MIN_LEVEL)
    b = BoxStencilOperator(dom, forms.mass_form).apply_raw(dom.interpolate(
        lambda x, y, z: 3 * math.pi ** 2 * box_sol(x, y, z)))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    r0 = gmg._norm(dom.mask_interior(b)).item()
    t0 = time.perf_counter()
    u, rns = gmg.solve_poisson(levels, b, cycles=cycles)
    res = [r0] + rns.tolist()
    solve_s = time.perf_counter() - t0
    err = max_abs_diff(u, dom.interpolate(box_sol))
    rate = (res[4] / res[0]) ** 0.25
    check(all(math.isfinite(r) for r in res) and math.isfinite(err),
          f"box level {level}: non-finite residual or solution")
    check(rate <= BOX_RATE_MAX,
          f"box level {level}: residual rate {rate} > {BOX_RATE_MAX}")
    out = {"m": list(BOX_M), "level": level, "dofs": dom.num_dofs(),
           "block": list(dom.block_shape), "residuals": res,
           "rate_cycles_1_4": rate, "max_nodal_error": err,
           "setup_s": setup_s, "solve_s_incl_residual_norms": solve_s,
           "eig_max": [lvl.eig_max for lvl in levels]}
    return out, levels, (u, dom.mask_interior(b))


def stream_probe(sizes: dict, device) -> tuple[dict, dict]:
    """Kernel P1 against torch.mul (exact) at each size, then its rate:
    returns (errors, {size: (kernel ms, plain ms)}); the launch count is
    reset between the two so that it counts the probe alone."""
    from hyteg_tpu_torch.kernels import stream as p1

    gen = torch.Generator(device=device).manual_seed(7)
    errs = {}
    for name, n in sizes.items():
        src = torch.randn(n, generator=gen, device=device)
        errs[name] = max_abs_diff(p1.stream_scale(src),
                                  p1.stream_scale_torch(src))
        check(errs[name] == 0.0, f"P1 {name}: max|d| {errs[name]} != 0")
        del src
    p1.stream_scale.launches = 0
    times = {}
    for name, n in sizes.items():
        src = torch.randn(n, generator=gen, device=device)
        dst = torch.empty_like(src)
        times[name] = (
            median_ms(lambda: p1.stream_scale(src), 10, batch=10),
            median_ms(lambda: torch.mul(src, 2.0, out=dst), 10, batch=10))
        del src, dst
        torch.cuda.empty_cache()
    return errs, times


def tetpair_storage(mesh: str):
    from hyteg_tpu_torch.mesh.meshinfo import mesh_spherical_shell, mesh_unit_cube
    from hyteg_tpu_torch.primitives.storage import CellStorage

    return CellStorage(mesh_unit_cube(MESH_N) if mesh == "cube"
                       else mesh_spherical_shell(*SHELL))


def tetpair_setup(storage, level: int, device, seed: int, form=None,
                  pitch=None):
    """A space, its classic operator, the paired-tet engine bound to it and
    a consistent random x (interface replicas equal)."""
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
    from hyteg_tpu_torch.tetpair import TetPairEngine

    sp = P1Space(storage, level, device=device, pitch=pitch)
    op = P1ElementwiseOperator(sp, form or forms.laplace_form)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(sp.block_shape, generator=gen, device=device)
    x = sp.exchange_rep(x * sp.vertex_mask_t)
    return sp, op, TetPairEngine(sp, op.elmats), x


def check_tetpair_kernels(storage, level: int, pitch, device, seed: int) -> dict:
    """Kernels B6, B7, B8 against their plain versions at one level, on the
    state after one exchanged apply (nontrivial faces to install)."""
    from hyteg_tpu_torch.kernels import tetpair as tk
    from hyteg_tpu_torch.operators import forms

    out = {"level": level, "cells": storage.cells_per_shard}
    for name, form in (("laplace", forms.laplace_form),
                       ("mass", forms.mass_form)):
        sp, op, eng, x = tetpair_setup(storage, level, device, seed, form,
                                       pitch)
        N, P = eng.N, eng.P
        out.update(pitch=P, paired_block=[eng.Cp, N, N * P])
        st = eng.apply_ex(eng.lift(x))
        faces = (st.xf, st.yf, st.zf, st.df)
        got = tk.pair_apply(st.u, eng.W, *faces, N, P)
        ref = tk.pair_apply_torch(st.u, eng.W, *faces, N, P)
        for part, g, r in zip(("dst", "xf", "yf", "zf", "df"), got, ref):
            err, scale = max_abs_diff(g, r), r.abs().max().item()
            check(math.isfinite(err) and err <= B6_RTOL * scale,
                  f"B6 {name} level {level} {part}: max|d| {err} > "
                  f"{B6_RTOL} * {scale}")
            out[f"b6_{name}_{part}_max_abs_err"] = err
            out[f"b6_{name}_{part}_max_abs"] = scale
        # "shifted": the applied block one float into its storage, so that
        # it lies off out's place against 16-byte boundaries (B7's copy
        # phase then takes single loads and stores)
        shifted = torch.empty(st.u.numel() + 1, device=device)[1:].view(
            st.u.shape)
        shifted.copy_(st.u)
        for blk, u in (("packed", eng.pack(x)), ("applied", st.u),
                       ("shifted", shifted)):
            err = max_abs_diff(tk.pair_install(u, *faces, N, P),
                               tk.pair_install_torch(u, *faces, N, P))
            check(err == 0.0, f"B7 {name} level {level} {blk}: max|d| {err} != 0")
            out[f"b7_{name}_{blk}_max_abs_err"] = err
            if blk == "shifted":
                continue
            err = max(max_abs_diff(g, r) for g, r in zip(
                tk.pair_extract(u, N, P), tk.pair_extract_torch(u, N, P)))
            check(err == 0.0, f"B8 {name} level {level} {blk}: max|d| {err} != 0")
            out[f"b8_{name}_{blk}_max_abs_err"] = err
        del shifted, u
        del sp, op, eng, x, st, faces, got, ref
        torch.cuda.empty_cache()
    return out


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| / max|a|: bench.py's gate_close."""
    return max_abs_diff(a, b) / max(a.abs().max().item(), 1e-30)


def tetpair_apply(storage, level: int, device, seed: int):
    """bench_tet's path: the engine's apply_full, and two chained apply_ex
    then lower, against the classic apply (B2 + slot exchange) on every
    in-tet position."""
    t0 = time.perf_counter()
    sp, op, eng, x = tetpair_setup(storage, level, device, seed)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    from hyteg_tpu_torch.kernels import tetpair as tk

    mask = sp.vertex_mask_t
    names = ("pair_apply", "pair_install", "pair_extract")
    before = {name: getattr(tk, name).launches for name in names}
    y = eng.apply_full(x)
    per_full = {name: getattr(tk, name).launches - before[name]
                for name in names}
    check(all(n == 1 for n in per_full.values()),
          f"tetpair apply_full launched {per_full}, not one of each")
    full = rel_err(y * mask, op.apply_raw(x) * mask)
    chained = rel_err(
        eng.lower(eng.apply_ex(eng.apply_ex(eng.lift(x)))) * mask,
        op.apply_raw(op.apply_raw(x)) * mask)
    where = f"level {level}, {storage.cells_per_shard} cells"
    check(math.isfinite(full) and full <= TETPAIR_RTOL,
          f"tetpair apply_full vs apply_raw, {where}: rel {full} > {TETPAIR_RTOL}")
    check(math.isfinite(chained) and chained <= TETPAIR_RTOL,
          f"tetpair chained apply vs apply_raw, {where}: rel {chained} > "
          f"{TETPAIR_RTOL}")
    out = {"level": level, "cells": storage.cells_per_shard,
           "global_dofs": sp.num_global_dofs(), "block": list(sp.block_shape),
           "paired_block": [eng.Cp, eng.N, eng.N * eng.P],
           "paired_slots": eng.Cp * eng.N * eng.N * eng.P,
           "apply_full_rel_err": full, "chained_rel_err": chained,
           "launches_per_apply_full": per_full, "setup_s": setup_s}
    return out, (sp, op, eng, x)


def pair_read_bytes(eng) -> int:
    """Bytes that a stencil over both tets of the paired blocks must read,
    per pair times the pairs: every slot p + d with p in tet A or tet B and
    d one of the 15 directions, as flat.shift_read reads it (a move past
    the block reads nothing), read from u where pair_source reads the
    block and from the face array it names where it reads a face (the
    installed faces and shells, and row n of the padding lanes), each
    entry once. The middle of the block, the padding lanes and the face
    entries no stencil reads are not counted."""
    from hyteg_tpu_torch.indexing import flat
    from hyteg_tpu_torch.tetpair import plan as tp

    N, P = eng.N, eng.P
    plan = tp.PairPlan(N, P)
    M = torch.as_tensor(plan.in_a | plan.in_b)[None].float()
    need = torch.zeros(M.shape, dtype=torch.bool)
    for d in tp.dir_tables()[0]:
        need |= flat.shift_write(M, [int(v) for v in d], P, 3) != 0
    picked = pair_source_entries(N, P)[need[0].numpy().reshape(N, N, P)]
    face_entries = np.unique(picked[picked >= 0]).size
    return eng.Cp * (int((picked < 0).sum()) + face_entries) * 4


def pair_source_entries(N: int, P: int) -> np.ndarray:
    """pair_source's choice at every position (x, ly, lz) of a pair's
    block, (N, N, P): the entry of the face arrays (xf, yf, zf, df laid
    end to end) it reads, -1 where it reads the block. From the plain
    install of a zero block whose face entries each hold their index + 1,
    in float64 (exact)."""
    from hyteg_tpu_torch.kernels import tetpair as tk

    shapes = tk._face_shapes(1, N, P)
    sizes = [math.prod(sh) for sh in shapes]
    ids = torch.arange(1, sum(sizes) + 1, dtype=torch.float64)
    faces = [f.view(sh) for f, sh in zip(torch.split(ids, sizes), shapes)]
    u = torch.zeros(1, N, N * P, dtype=torch.float64)
    out = tk.pair_install_torch(u, *faces, N, P)
    return (out.long() - 1).numpy().reshape(N, N, P)


def pair_kept_entries(N: int, P: int) -> tuple[np.ndarray, np.ndarray]:
    """B8's kept entries of one pair: (entries, positions), the entries of
    the face arrays laid end to end that take a value of the block (not a
    masked 0) and the flat offset of that value's position in the block.
    From the plain extract of a block that holds each position's offset +
    1, in float64 (exact)."""
    from hyteg_tpu_torch.kernels import tetpair as tk

    ids = torch.arange(1, N * N * P + 1, dtype=torch.float64).view(1, N, -1)
    v = torch.cat([f.reshape(-1) for f in tk.pair_extract_torch(ids, N, P)])
    entries = torch.nonzero(v).squeeze(1)
    return entries.numpy(), (v[entries] - 1).long().numpy()


def b7_b8_timing(eng, x) -> dict:
    """Kernels B7 and B8 on the lifted state of x: each one's ms beside
    its bound, its plain version's ms and its library call's (checked
    equal to the kernel on the same inputs); B8's sector floor (its
    writes, and a 32-byte sector for each sector of the block its kept
    entries lie in). The bounds count what each function must move: B7
    reads the block where it keeps it and one face entry per installed
    position, and writes the block; B8 reads its kept entries and writes
    every entry. The earlier counts (the whole block and face arrays) are
    printed beside them (``*_bound_ms_whole_arrays``). ``*_ms``: back to
    back through the wrapper, as every kernel of the ``kernels`` line;
    ``*_graph_ms``: CUDA graphs of 10 calls, without the host's work per
    call, which for B8 exceeds the kernel's time."""
    from hyteg_tpu_torch.kernels import tetpair as tk

    N, P, Cp = eng.N, eng.P, eng.Cp
    L = N * P
    st = eng.lift(x)
    u, faces = st.u, (st.xf, st.yf, st.zf, st.df)
    uf = u.reshape(-1)
    pair0 = np.arange(Cp)[:, None] * (N * L)
    out = {"paired_block": [Cp, N, L]}

    def times(tag, call, library):
        out.update({
            f"{tag}_ms": median_ms(call, 10, batch=10),
            f"{tag}_graph_ms": median_graph_ms(call, 10),
            f"{tag}_library_ms": median_ms(library, 10, batch=10),
            f"{tag}_library_graph_ms": median_graph_ms(library, 10)})

    # B7 and its library call: the installed positions' values staged
    src = pair_source_entries(N, P).reshape(-1)
    installed = np.flatnonzero(src >= 0)
    idx = torch.as_tensor((pair0 + installed).reshape(-1), device=u.device)
    b7 = tk.pair_install(u, *faces, N, P)
    vals = b7.reshape(-1)[idx]
    err = max_abs_diff(torch.index_put(uf, (idx,), vals).view_as(b7), b7)
    check(err == 0.0, f"B7 library call vs B7: max|d| {err} != 0")
    reads = N * L - installed.size + np.unique(src[installed]).size
    b = bound(4 * Cp * reads + nbytes(u), 0)
    times("b7", lambda: tk.pair_install(u, *faces, N, P),
          lambda: torch.index_put(uf, (idx,), vals))
    out.update(
        b7_plain_ms=median_ms(
            lambda: tk.pair_install_torch(u, *faces, N, P), 5),
        b7_bound_ms=b[0], b7_bytes=b[2],
        b7_bound_ms_whole_arrays=bound(2 * nbytes(u) + nbytes(*faces), 0)[0],
        b7_installed_per_pair=installed.size)
    del b7, vals, idx
    # B8 and its library call; take leaves the masked zeros out, so the
    # same take with the zeros filled in (a zeroed output, the kept
    # entries copied into it) is timed beside it
    fo = tk.pair_extract(u, N, P)
    entries, kept = pair_kept_entries(N, P)
    kidx = torch.as_tensor((pair0 + kept).reshape(-1), device=u.device)
    E = sum(f[0].numel() for f in fo)
    eidx = torch.as_tensor((np.arange(Cp)[:, None] * E + entries).reshape(-1),
                           device=u.device)
    got = torch.cat([f.reshape(Cp, -1) for f in fo], dim=1)

    def take_fill():
        return uf.new_zeros(Cp * E).index_copy_(0, eidx, torch.take(uf, kidx))

    err = max(max_abs_diff(torch.take(uf, kidx), got.reshape(-1)[eidx]),
              max_abs_diff(take_fill(), got.reshape(-1)))
    check(err == 0.0, f"B8 library call vs B8: max|d| {err} != 0")
    b = bound(4 * Cp * np.unique(kept).size + nbytes(*fo), 0)
    sectors = np.unique((pair0 + kept) // 8).size
    floor = bound(32 * sectors + nbytes(*fo), 0)
    times("b8", lambda: tk.pair_extract(u, N, P), lambda: torch.take(uf, kidx))
    out.update(
        b8_plain_ms=median_ms(lambda: tk.pair_extract_torch(u, N, P), 5),
        b8_take_fill_ms=median_ms(take_fill, 10, batch=10),
        b8_take_fill_graph_ms=median_graph_ms(take_fill, 10),
        b8_bound_ms=b[0], b8_bytes=b[2],
        b8_bound_ms_whole_arrays=bound(2 * nbytes(*fo), 0)[0],
        b8_sector_floor_ms=floor[0], b8_sector_floor_bytes=floor[2],
        b8_kept_per_pair=kept.size)
    return out


def b6_work(eng, st, fo) -> tuple[int, int]:
    """B6's least work at one case: (bytes, operations). The reads a
    stencil over both tets needs (pair_read_bytes: u and the face
    entries), W, one write of the block and of the four face arrays; a
    multiply-add per direction at each in-tet slot."""
    return (pair_read_bytes(eng) + nbytes(st.u, eng.W, *fo),
            30 * 2 * eng.Cp * tet_points(eng.N - 1))


def b6_timing(eng, x) -> dict:
    """Kernel B6 on the lifted state of x: its ms beside its bound."""
    from hyteg_tpu_torch.kernels import tetpair as tk

    N, P = eng.N, eng.P
    st = eng.lift(x)
    faces = (st.xf, st.yf, st.zf, st.df)
    fo = tk.pair_apply(st.u, eng.W, *faces, N, P)[1:]
    ms = median_ms(lambda: tk.pair_apply(st.u, eng.W, *faces, N, P), 10,
                   batch=10)
    b = bound(*b6_work(eng, st, fo))
    return {"paired_block": [eng.Cp, N, N * P], "ms": ms, "bound_ms": b[0],
            "bound_by": b[1], "bytes": b[2], "operations": b[3]}


def tetpair_profile(eng, st, applies: int = 3) -> dict:
    """torch.profiler over chained apply_ex: device time by kernel and the
    device idle share of the window (1 - device time / host wall). Only
    kernel and copy records count: the profiler's own step annotation
    (``ProfilerStep*``) also carries a device time, that of the whole
    window. The profiler is enabled one apply before the window (a warm-up
    step, whose records it drops): started at the window, it lost the
    window's first kernel record on the card, a B6 launch. apply_ex
    launches B6 once, so the window must hold ``applies`` B6 records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        st = eng.apply_ex(st)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        st = eng.apply_ex(st)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(applies):
            st = eng.apply_ex(st)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("ProfilerStep")]
    b6_ms = sum(r[1] for r in rows if "pair_apply_kernel" in r[0])
    b6_launches = sum(r[2] for r in rows if "pair_apply_kernel" in r[0])
    check(b6_launches == applies,
          f"tetpair_profile: {b6_launches} B6 records for {applies} applies")
    device_ms = sum(r[1] for r in rows)
    idle = 1.0 - device_ms / wall_ms
    check(0.0 <= idle <= 1.0, f"tetpair_profile: idle share {idle}")
    rows.sort(key=lambda r: -r[1])
    return {"applies": applies, "wall_ms_per_apply": wall_ms / applies,
            "device_ms_per_apply": device_ms / applies,
            "b6_ms_per_apply": b6_ms / applies, "b6_launches": b6_launches,
            "b6_share": b6_ms / device_ms,
            "exchange_ms_per_apply": (device_ms - b6_ms) / applies,
            "device_kernels_per_apply": sum(r[2] for r in rows) / applies,
            "idle_share": idle,
            "top": [{"name": k[:80], "ms_per_apply": v / applies,
                     "count": c} for k, v, c in rows[:10]]}


def gate_residuals(res, what: str, max_rate: float, min_cycles: int = 4,
                   floor_rel: float = 1e-6) -> float:
    """bench_vcycle's convergence gate (hyteg_tpu/core/benchgate.py:44):
    residuals decrease and their mean rate is <= max_rate over the cycles
    before the f32 round-off floor (floor_rel of the first). Returns the
    rate."""
    check(len(res) > min_cycles and all(math.isfinite(r) for r in res),
          f"{what}: too few or non-finite residuals {res}")
    floor = floor_rel * res[0]
    end = next((i for i, r in enumerate(res) if r <= floor), len(res) - 1)
    window = res[: max(end, min_cycles) + 1]
    for a, b in zip(window, window[1:]):
        check(b < a or a <= floor,
              f"{what}: residuals not decreasing before the floor {res}")
    rate = (window[-1] / window[0]) ** (1.0 / (len(window) - 1))
    check(rate <= max_rate, f"{what}: mean rate {rate} > {max_rate}")
    return rate


def tet_points(n: int) -> int:
    """Micro-vertices of one refined tet with n intervals per edge (the
    base positions of a class with margin m are tet_points(n - m))."""
    return (n + 1) * (n + 2) * (n + 3) // 6 if n >= 0 else 0


def bound(nbytes: float, flops: float, bytes_per_s: float = PEAK_BYTES_PER_S
          ) -> tuple[float, str, float, float]:
    """Least time for the work on the card (ms) and what binds it: bytes
    (each input read once, each output written once) over the memory rate,
    by default the data sheet's, or f32 operations over the f32 peak.
    Returns (ms, "bytes" or "operations", bytes, operations)."""
    t_b, t_f = nbytes / bytes_per_s, flops / PEAK_F32_FLOPS
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations",
            nbytes, flops)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def masked_read_slots(N: int, pitch: int, mask: str, n_taps: int,
                      device) -> int:
    """Slots of one cell that tet_stripped reads under a mask: the mask's
    slots moved by each of the first n_taps directions, cyclically (a slot
    outside the mask returns before any load)."""
    from hyteg_tpu_torch.kernels import probes as p2

    M = p2.tet_mask(N, pitch, mask, device).bool()
    read = torch.zeros_like(M)
    for dx, dy, dz in p2.tet_dirs()[:n_taps].tolist():
        read |= torch.roll(M, (dx, dy * pitch + dz), dims=(0, 1))
    return int(read.sum())


def simplex_read_bytes(sp, dirs, C: int, itemsize: int = 4) -> int:
    """Bytes of one input block of ``sp`` (C cells, ``itemsize`` bytes an
    entry: 4 for f32, 2 for bf16) that a stencil over
    the simplex's slots must read: every slot p + d with p in the simplex
    and d in ``dirs``, as flat.shift_read reads it (a move past the block
    reads nothing). The slots past the simplex and the padding lanes are
    only written, so the bounds of B2, B4 and B5 count these reads and one
    write of the whole block, not two passes over it."""
    from hyteg_tpu_torch.indexing import flat

    M = sp.vertex_mask_t
    read = torch.zeros(M.shape, dtype=torch.bool, device=M.device)
    for d in dirs:
        read |= flat.shift_write(M, [int(v) for v in d], sp.pitch, sp.dim) != 0
    return C * int(read.sum()) * itemsize


def class_points(sp, margins=None) -> int:
    """Base positions of one cell summed over the micro-element classes
    with the given margins (default: each class's base margin)."""
    from hyteg_tpu_torch.indexing import micro

    pts = tet_points if sp.dim == 3 else tri_points
    ms = micro.base_margin(sp.dim) if margins is None else margins
    return sum(pts(sp.n - int(m)) for m in ms)


def b2_work(sp, x, A, E) -> tuple[int, int]:
    """B2's bytes and f32 operations on block x (C cells) of ``sp``: the
    stencil's reads of x on the simplex, one write, the stencils; a
    multiply-add per direction at each simplex slot."""
    from hyteg_tpu_torch.indexing import micro

    dirs = micro.stencil_directions(sp.dim)
    C = x.shape[0]
    return (nbytes(x) + simplex_read_bytes(sp, dirs, C, x.element_size())
            + nbytes(A, E), 2 * len(dirs) * C * class_points(sp, [0]))


def b3_work(sp, elm, y) -> tuple[int, int]:
    """B3's bytes and f32 operations writing block y of ``sp``: the element
    matrices read, the block written; nv adds per element and vertex."""
    return (nbytes(elm) + nbytes(y),
            (sp.dim + 1) * y.shape[0] * class_points(sp))


def b4_work(sp, x, elm) -> tuple[int, int]:
    """B4's bytes and f32 operations with a nodal coefficient on block x:
    x and the coefficient read on the simplex, one write, the element
    matrices; per element nv^2 multiply-adds, the nv-term mean and nv
    scalings."""
    nv, C = sp.dim + 1, x.shape[0]
    return (nbytes(x) + 2 * simplex_read_bytes(sp, [(0,) * sp.dim], C,
                                               x.element_size())
            + nbytes(elm), (2 * nv * nv + 2 * nv) * C * class_points(sp))


def b3_coeff_work(sp, elm, y) -> tuple[int, int]:
    """B3's bytes and f32 operations with a nodal coefficient, writing
    block y of ``sp``: the element matrices read, the coefficient read on
    the simplex, the block written; per (element, vertex) term nv adds of
    the mean, its division and a multiply-add."""
    nv, C = sp.dim + 1, y.shape[0]
    return (nbytes(elm) + nbytes(y)
            + simplex_read_bytes(sp, [(0,) * sp.dim], C, y.element_size()),
            (nv + 3) * nv * C * class_points(sp))


def b5_work(sp, x, W, level: int) -> tuple[int, float]:
    """B5's bytes and f32 operations on block x of ``sp`` with the folded
    stencil W: its reads of x on the simplex, one write, W; a multiply-add
    per nonzero weight of each slot's stencil row."""
    from hyteg_tpu_torch.kernels import p2_const_stencil as b5

    row, K0 = b5._row_index(level, sp.dim, sp.pitch, torch.float32, x.device)
    hist = torch.bincount(row[K0 > 0], minlength=W.shape[1]).double()
    return (nbytes(x) + simplex_read_bytes(sp, b5._kernel_dirs(sp.dim),
                                           x.shape[0], x.element_size())
            + nbytes(W),
            2 * ((W != 0).sum(-1).double() @ hist).sum().item())


def conv3d_stencil(weights, dirs) -> torch.Tensor:
    """(G, 1, 3, 3, 3) conv3d kernels from (G, n_s) weights on directions
    in {-1, 0, 1}^3 (cross-correlation: k[d + 1] multiplies u[p + d])."""
    k = torch.zeros((weights.shape[0], 27), dtype=torch.float32,
                    device=weights.device)
    idx = [(int(d[0]) + 1) * 9 + (int(d[1]) + 1) * 3 + int(d[2]) + 1
           for d in dirs]
    k[:, idx] = weights.float()
    return k.reshape(-1, 1, 3, 3, 3)


def p2_space_op(storage, level: int, kind: str, device):
    from hyteg_tpu_torch.functions.p2 import P2Space
    from hyteg_tpu_torch.operators.p2_elementwise import P2ElementwiseOperator

    sp = P2Space(storage, level, device=device, pitch=PITCH)
    return sp, P2ElementwiseOperator(sp, kind)


def check_p2_kernels(storage, level: int, device, seed: int,
                     vs_general: bool) -> dict:
    """Kernel B5 against its plain version (Laplace and mass) at one P2
    level (3D with pitch 129, or 2D), and when ``vs_general`` also against
    the independent general formulation p2_apply_local."""
    from hyteg_tpu_torch.kernels import p2_const_stencil as b5
    from hyteg_tpu_torch.operators.p2_elementwise import p2_apply_local

    gen = torch.Generator(device=device).manual_seed(seed)
    out = {"level": level}
    for kind in ("laplace", "mass"):
        sp, op = p2_space_op(storage, level, kind, device)
        out.update(block=list(sp.block_shape), pitch=sp.pitch,
                   global_dofs=sp.num_global_dofs())
        x = torch.randn(sp.block_shape, generator=gen, device=device)
        x *= sp.vertex_mask_t
        args = (op.stencil_folded, level, sp.pitch, sp.dim)
        y = b5.p2_const_apply(x, *args)
        y_ref = b5.p2_const_apply_torch(x, *args)
        err, scale = max_abs_diff(y, y_ref), y_ref.abs().max().item()
        check(math.isfinite(err) and err <= B5_RTOL * scale,
              f"B5 {kind} level {level}: max|dy| {err} > {B5_RTOL} * {scale}")
        check(not y[:, ~sp.vertex_mask_t.bool()].any().item(),
              f"B5 {kind} level {level}: nonzero outside the tet / padding")
        out[f"b5_{kind}_max_abs_err"] = err
        out[f"b5_{kind}_max_abs"] = scale
        if kind == "laplace":
            out["b5_ms"] = median_ms(lambda: b5.p2_const_apply(x, *args), 10,
                                     batch=10)
            read = simplex_read_bytes(sp, b5._kernel_dirs(sp.dim), x.shape[0])
            out["b5_bound_ms"] = bound(nbytes(x) + read + nbytes(args[0]),
                                       0)[0]
        del y_ref
        if vs_general:
            y_gen = p2_apply_local(x, op.elmats, level, sp.dim, sp.pitch)
            err, scale = max_abs_diff(y, y_gen), y_gen.abs().max().item()
            check(math.isfinite(err) and err <= B5_RTOL * scale,
                  f"B5 {kind} level {level} vs p2_apply_local: max|dy| "
                  f"{err} > {B5_RTOL} * {scale}")
            out[f"b5_{kind}_vs_general_max_abs_err"] = err
            del y_gen
        del sp, op, x, y
        torch.cuda.empty_cache()
    return out


def p2_gmg(storage, device, level: int = P2_LEVEL, cycles: int = P2_CYCLES,
           floor_rel: float = 1e-6) -> tuple[dict, object, tuple]:
    """The P2 path: bench_vcycle's bench_p2 stack (level 6 in 3D), a seeded
    random rhs made consistent across interface replicas and restricted to
    the solved rows, ``cycles`` V-cycles from 0 under bench_vcycle's gate
    with its f32 round-off floor at ``floor_rel`` of the first residual."""
    from hyteg_tpu_torch.solvers.templates import make_p2_gmg

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stack = make_p2_gmg(storage, min_level=P2_MIN_LEVEL, max_level=level,
                        coarse_iters=P2_COARSE_ITERS, device=device)
    sp = stack.space()
    gen = torch.Generator(device=device).manual_seed(0)
    b = torch.randn(sp.block_shape, generator=gen, device=device)
    b = stack.residual(torch.zeros_like(b),
                       sp.exchange_rep(b * sp.vertex_mask_t))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    x = torch.zeros_like(b)
    res = [stack.residual_norm(x, b).item()]
    t0 = time.perf_counter()
    for _ in range(cycles):
        x = stack.gmg.cycle(x, b)
        res.append(stack.residual_norm(x, b).item())
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    rate = gate_residuals(res, f"P2 V-cycle level {level}", P2_RATE_MAX,
                          floor_rel=floor_rel)
    out = {"level": level, "global_dofs": sp.num_global_dofs(),
           "block": list(sp.block_shape), "residuals": res,
           "mean_rate": rate, "gate_floor_rel": floor_rel, "setup_s": setup_s,
           "solve_s_incl_residual_norms": solve_s,
           "eigs": stack.eigs}
    return out, stack, (x, b)


def p2_cycle_profile(stack, x, b, cycle_ms: float) -> dict:
    """cycle_profile of one P2 V-cycle (B5 in 3D or 2D and the transfers'
    matrix products by name), plus CUDA-event times of every level's
    restriction and prolongation."""
    prof = cycle_profile(lambda: stack.gmg.cycle(x, b), cycle_ms,
                         {"b5": ("p2_const_apply_kernel",
                                 "p2_const_apply_2d_kernel"),
                          "transfer_gemm": ("gemm", "gemv")})
    transfer_ms = {}
    for l, tr in stack.transfers.items():
        rf = stack.spaces[l].zeros()
        rc = stack.spaces[l - 1].zeros()
        transfer_ms[l] = {
            "restrict": median_ms(lambda: tr.restrict(rf, stack.sds[l],
                                                      stack.sds[l - 1]), 3),
            "prolongate": median_ms(lambda: tr.prolongate(rc), 3)}
    return {**prof, "transfer_ms_by_fine_level": transfer_ms,
            "transfer_ms_per_cycle": sum(v["restrict"] + v["prolongate"]
                                         for v in transfer_ms.values())}


def p2_manufactured(storage, level: int, device,
                    min_level: int = P2_MIN_LEVEL) -> dict:
    """The sin sin (sin) Poisson solve of the JAX package's
    tests/test_p2_transfer.py:62-91 on the P2 stack: b = M f, Dirichlet
    values of u; max nodal error after P2_MANUFACTURED_CYCLES cycles."""
    from hyteg_tpu_torch.core.types import BoundaryCondition, DoFType, FLAG_INNER
    from hyteg_tpu_torch.operators.p2_elementwise import P2ElementwiseOperator
    from hyteg_tpu_torch.solvers.templates import make_p2_gmg

    stack = make_p2_gmg(storage, min_level=min_level, max_level=level,
                        coarse_iters=P2_COARSE_ITERS, device=device)
    sp, bc = stack.space(), BoundaryCondition.all_dirichlet()
    sol, rhs = exact(sp.dim)
    mass = P2ElementwiseOperator(sp, "mass")
    x = sp.interpolate(sol, sp.zeros(), DoFType.DIRICHLET, bc)
    f = sp.interpolate(rhs, sp.zeros(), DoFType.ALL, bc)
    b = sp.restore_rows(mass.apply_raw(f), sp.zeros(), FLAG_INNER, bc)
    res = [stack.residual_norm(x, b).item()]
    for _ in range(P2_MANUFACTURED_CYCLES):
        x = stack.gmg.cycle(x, b)
        res.append(stack.residual_norm(x, b).item())
    u = sp.interpolate(sol, sp.zeros(), DoFType.ALL, bc)
    err = ((x - u).abs() * sp.vertex_mask_t).max().item()
    check(all(math.isfinite(r) for r in res) and math.isfinite(err),
          f"P2 manufactured level {level}: non-finite residual or error")
    return {"level": level, "global_dofs": sp.num_global_dofs(),
            "residuals": res, "max_nodal_error": err}


def coeff_field(sp, device, gen, kind: str) -> torch.Tensor:
    """k = 1 + x + 0.5 y (the JAX package's tests/test_operator.py:189) or
    a seeded random k in [0.5, 1.5), on the simplex's nodes."""
    if kind == "linear":
        p = sp.coords()
        k = 1.0 + p[..., 0] + 0.5 * p[..., 1]
    else:
        k = 0.5 + torch.rand(sp.block_shape, generator=gen, device=device)
    return (k * sp.vertex_mask_t).contiguous()


def check_coeff_kernels(storage, level: int, device, seed: int) -> dict:
    """Kernel B4 against its plain version without a coefficient and in the
    three averaging modes for two coefficients, and with k = 1 against B2,
    at one P1 level (3D with pitch 129, or 2D)."""
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.kernels import p1_stencil as b4
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.averaging import MODES
    from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator

    sp = P1Space(storage, level, device=device, pitch=PITCH)
    dim, pitch = sp.dim, sp.pitch
    op = P1ElementwiseOperator(sp, forms.laplace_form)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(sp.block_shape, generator=gen, device=device)
    x *= sp.vertex_mask_t
    out = {"level": level, "block": list(sp.block_shape)}
    for ck in ("none", "linear", "random"):
        k = None if ck == "none" else coeff_field(sp, device, gen, ck)
        for mode in MODES if k is not None else ("arithmetic",):
            y_ref = b4.p1_apply_local_torch(x, op.elmats, level, dim, pitch, k,
                                            mode)
            scale = y_ref.abs().max().item()
            tag = ck if k is None else f"{ck}_{mode}"
            y = b4.p1_apply_local(x, op.elmats, level, dim, pitch, k, mode)
            err = max_abs_diff(y, y_ref)
            check(math.isfinite(err) and err <= B4_RTOL * scale,
                  f"B4 {tag} level {level}: max|dy| {err} > "
                  f"{B4_RTOL} * {scale}")
            check(not y[:, ~sp.vertex_mask_t.bool()].any().item(),
                  f"B4 {tag} level {level}: nonzero outside the simplex")
            out[f"b4_{tag}_max_abs_err"] = err
            out[f"b4_{tag}_max_abs"] = scale
            del y, y_ref
    ones = sp.vertex_mask_t.expand(sp.block_shape).contiguous()
    y = b4.p1_apply_local(x, op.elmats, level, dim, pitch, ones)
    y2 = b2.p1_const_apply(x, op.stencil, op.stencil_face, level, dim, pitch)
    err, scale = max_abs_diff(y, y2), y2.abs().max().item()
    check(math.isfinite(err) and err <= B4_RTOL * scale,
          f"B4 k=1 vs B2 level {level}: max|dy| {err} > {B4_RTOL} * {scale}")
    out["b4_unit_vs_b2_max_abs_err"] = err
    return out


def b4_mode_line(level: int, ms: dict, bound_ms: float,
                 bound_ms_none: float, apply_raw_coeff_ms: float) -> dict:
    """B4's ms without a coefficient ("none") and in each mean, beside
    its bound with a coefficient and without one, each one's share of its
    bound, and the operator's apply_raw with the linear coefficient (the
    user's call: B4 and the exchange)."""
    return {"level": level, "ms": ms, "bound_ms": bound_ms,
            "bound_ms_none": bound_ms_none,
            "apply_raw_coeff_ms": apply_raw_coeff_ms,
            "share": {m: (bound_ms_none if m == "none" else bound_ms) / v
                      for m, v in ms.items()}}


def symmetric_positive(sp, apply, seed: int, what: str) -> dict:
    """<w, A v> against <v, A w> within SYM_RTOL and <v, A v> > 0, for
    consistent random v, w (the JAX package's
    tests/test_p2_transfer.py:94-123)."""
    from hyteg_tpu_torch.core.types import DoFType

    gen = torch.Generator(device=sp.device).manual_seed(seed)
    v, w = (sp.exchange_rep(torch.randn(sp.block_shape, generator=gen,
                                        device=sp.device) * sp.vertex_mask_t)
            for _ in range(2))
    Av = apply(v)
    quad = sp.dot(v, Av, DoFType.ALL).item()
    s1 = sp.dot(w, Av, DoFType.ALL).item()
    del Av
    s2 = sp.dot(v, apply(w), DoFType.ALL).item()
    rel = abs(s1 - s2) / max(abs(s1), 1e-30)
    check(math.isfinite(quad) and quad > 0, f"{what}: <v, A v> = {quad}")
    check(math.isfinite(rel) and rel <= SYM_RTOL,
          f"{what}: <w,Av> {s1} vs <v,Aw> {s2}: rel {rel} > {SYM_RTOL}")
    return {"v_A_v": quad, "w_A_v": s1, "v_A_w": s2, "symmetry_rel": rel}


def check_probe_kernels(storage, device, seed: int) -> dict:
    """Kernels P2 against their plain versions on the card, in every
    setting the probes time: box_variant at PROBE_BOX_CHECKS with random
    per-lane weights, tet_stripped at PROBE_TET_CHECKS with unit and with
    the operator's interior weights, on unmasked blocks (so the padding
    lanes hold values)."""
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.kernels import probes as p2
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
    from hyteg_tpu_torch.probes import prof_r5, prof_r5b
    from hyteg_tpu_torch.structured import BoxDomain

    gen = torch.Generator(device=device).manual_seed(seed)
    out = {"box": [], "tet": []}

    def held(y, ref, what):
        err, scale = max_abs_diff(y, ref), ref.abs().max().item()
        check(math.isfinite(err) and scale > 0 and err <= PROBE_RTOL * scale,
              f"{what}: max|dy| {err} > {PROBE_RTOL} * {scale}")
        return err

    for m, level, rows in PROBE_BOX_CHECKS:
        dom = BoxDomain(m, level, device=device)
        X, Z = dom.block_shape[0], dom.dims[2]
        u = torch.randn(dom.block_shape, generator=gen, device=device)
        w = 0.5 + torch.rand((p2.N_DIRS, dom.L), generator=gen,
                             device=device)
        idx = (slice(None) if rows is None else torch.cat([
            torch.arange(rows[0], device=device),
            torch.arange(X - rows[1], X, device=device)]))
        u_rows = u[idx]
        for shift, n_taps, tag, _ in prof_r5.BOX_VARIANTS:
            err = held(p2.box_variant(u, w, Z, shift, n_taps)[idx],
                       p2.box_variant_torch(u_rows, w, Z, shift, n_taps),
                       f"box_variant {tag} {dom.block_shape}")
            out["box"].append({"block": list(dom.block_shape),
                               "rows_compared": X if rows is None
                               else sum(rows),
                               "variant": tag, "max_abs_err": err})
        del u, w, u_rows
        torch.cuda.empty_cache()
    for level, pitch in PROBE_TET_CHECKS:
        sp = P1Space(storage, level, device=device, pitch=pitch)
        x = torch.randn(sp.block_shape, generator=gen, device=device)
        ones = torch.ones((sp.C_loc, p2.N_DIRS), device=device)
        W = P1ElementwiseOperator(sp, forms.laplace_form).stencil.sum(-1)
        settings = [(n, mask, tag, ones) for n, mask, tag, _ in
                    prof_r5b.FMA_SETTINGS + prof_r5b.MAPPING_SETTINGS]
        settings.append((15, "k0", "stripped (kernel_probe C)",
                         W.contiguous()))
        for n_taps, mask, tag, w in settings:
            args = (x, w, p2.tet_dirs(), n_taps, sp.pitch, mask)
            err = held(p2.tet_stripped(*args), p2.tet_stripped_torch(*args),
                       f"tet_stripped {tag} {sp.block_shape}")
            out["tet"].append({"block": list(sp.block_shape),
                               "pitch": sp.pitch, "setting": tag,
                               "max_abs_err": err})
        del sp, x, ones, W
        torch.cuda.empty_cache()
    return out


def probe_kernel_rows(device, ladder_rows) -> tuple[dict, dict, dict]:
    """The kernels line's numbers of P2: each kernel's ms at its headline
    setting (from the ladder), its plain version's ms on a block of the
    same shape and seed, its bound's bytes and operations and the library
    call's ms. Returns (ms, bound inputs (bytes, operations), library ms).
    box_variant: rolls + 15 taps at box level 7 (the jax shape);
    tet_stripped: kernel_probe's stripped kernel (interior weights, K0) on
    the tet level-7 block with pitch 129 (the main shape)."""
    from hyteg_tpu_torch.kernels import probes as p2
    from hyteg_tpu_torch.probes import box_setup, tet_setup

    def row(shape_set, probe):
        (r,) = [r for r in ladder_rows
                if r["shape_set"] == shape_set and r["probe"] == probe]
        return r

    ms, work, lib = {}, {}, {}
    box = box_setup(7, device=device)
    u = box.u
    X, L = u.shape
    Z = box.dom.dims[2]
    w = torch.ones((p2.N_DIRS, L), device=device)
    ms["box_variant"] = row("jax", "box variant rolls+15fma")["ms"]
    ms["box_variant_plain"] = median_ms(
        lambda: p2.box_variant_torch(u, w, Z, True, 15), 3, warmup=1)
    work["box_variant"] = (2 * nbytes(u) + nbytes(w), 30 * u.numel())
    # the library call: a circular conv over each row with the 15 unit
    # weights summed at their lane offsets (uniform over lanes, so equal)
    conv = torch.nn.Conv1d(1, 1, 2 * Z + 3, padding=Z + 1,
                           padding_mode="circular", bias=False,
                           device=device).requires_grad_(False)
    conv.weight.zero_()
    for _, ls in p2.box_tap_order(Z):
        conv.weight[0, 0, ls + Z + 1] += 1.0
    uv = u.view(X, 1, L)
    ref = p2.box_variant(u, w, Z, True, 15)
    lib_err = max_abs_diff(conv(uv).view(X, L), ref)
    check(lib_err <= 1e-4 * ref.abs().max().item(),
          f"the circular conv differs from box_variant by {lib_err}")
    lib["box_variant"] = median_ms(lambda: conv(uv), 10, batch=10)
    del box, u, w, conv, uv, ref
    tet = tet_setup(7, device=device)
    x, sp = tet.x, tet.space
    W = tet.op.stencil.sum(-1).contiguous()
    ms["tet_stripped"] = row("main", "C  stripped whole-cell 15pt")["ms"]
    ms["tet_stripped_plain"] = median_ms(
        lambda: p2.tet_stripped_torch(x, W, p2.tet_dirs(), 15, sp.pitch,
                                      "k0"), 3, warmup=1)
    # the work this run's data needs: 15 multiply-adds on the K0 slots,
    # reads of the slots they touch, the whole y written
    read = sp.C_loc * masked_read_slots(sp.N, sp.pitch, "k0", 15, device)
    work["tet_stripped"] = (read * x.element_size() + nbytes(x, W),
                            30 * sp.C_loc * tet_points(sp.n))
    del tet, x, sp, W
    torch.cuda.empty_cache()
    return ms, work, lib


def tri_points(n: int) -> int:
    """Micro-vertices of one refined triangle with n intervals per edge
    (the base positions of a class with margin m are tri_points(n - m))."""
    return (n + 1) * (n + 2) // 2 if n >= 0 else 0


def conv2d_stencil(weights, dirs) -> torch.Tensor:
    """(G, 1, 3, 3) conv2d kernels from (G, n_s) weights on directions in
    {-1, 0, 1}^2 (cross-correlation: k[d + 1] multiplies u[p + d])."""
    k = torch.zeros((weights.shape[0], 9), dtype=torch.float32,
                    device=weights.device)
    idx = [(int(d[0]) + 1) * 3 + int(d[1]) + 1 for d in dirs]
    k[:, idx] = weights.float()
    return k.reshape(-1, 1, 3, 3)


def homogeneous_rates(stack, device, seed: int,
                      max_rate: float = RATE_MAX) -> dict:
    """The V-cycle on A x = 0 from a seeded random x0 (replicas consistent,
    0 on Dirichlet rows): the residual A x shrinks with x, so f32 puts no
    floor under it. Rates over cycles 1-4 and over cycles 3-6 (after the
    rough part of x0 is gone), both gated at ``max_rate``."""
    sp = stack.space()
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(sp.block_shape, generator=gen, device=device)
    x = stack.residual(torch.zeros_like(x), sp.exchange_rep(x * sp.vertex_mask_t))
    b = torch.zeros_like(x)
    res = [stack.residual_norm(x, b).item()]
    for _ in range(HOMOGENEOUS_CYCLES):
        x = stack.gmg.cycle(x, b)
        res.append(stack.residual_norm(x, b).item())
    rates = {"rate_cycles_1_4": (res[4] / res[0]) ** 0.25,
             "rate_cycles_3_6": (res[6] / res[2]) ** 0.25}
    check(all(math.isfinite(r) for r in res),
          f"homogeneous solve: non-finite residuals {res}")
    for name, r in rates.items():
        check(r <= max_rate, f"homogeneous solve {name} {r} > {max_rate}")
    return {"residuals": res, **rates}


def launches_by_level(stack, x, b, wrapper, dim: int = 3) -> dict:
    """The launches of a kernel wrapper's 3D (or 2D) kernel in one
    V-cycle, by level, from the wrapper's own count (set to 0 just before
    the cycle)."""
    counts = getattr(wrapper, "launches_by_level" + ("_2d" if dim == 2 else ""))
    counts.clear()
    stack.gmg.cycle(x, b)
    return dict(sorted(counts.items()))


def ms_lost(kernel_ms: float, launches: dict, bounds: dict) -> float:
    """Device ms of a kernel in one V-cycle less the least time of the same
    launches: sum over levels of launches x that level's bound."""
    return kernel_ms - sum(n * bounds[lv] for lv, n in launches.items())


def device_rows(prof) -> list:
    """(name, device ms, count) of each CUDA activity a profiler window
    recorded, summed by name off the profiler's raw records: what
    ``key_averages()`` gives for device events (a kernel has no children,
    so its self time is its duration), without building the event tree,
    which took ~200 s for the 738,712 kernels of one blended Stokes cycle
    (PERF.md section 6)."""
    from torch.autograd import DeviceType

    agg = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        ms, n = agg.get(e.name(), (0.0, 0))
        agg[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return [(k, ms, n) for k, (ms, n) in agg.items()]


def cycle_profile(cycle, cycle_ms: float, kernels: dict,
                  warmup: int = 2) -> dict:
    """torch.profiler over one V-cycle (``cycle()``) after ``warmup``
    warm-up cycles, CUDA activity only (the CPU ops' event tree of a cycle
    of ~10^5 launches takes minutes to build): device time, the idle share of the cycle (1 - device kernel time /
    ``cycle_ms``, the cycle's CUDA-event time from the same run: the
    profiled window's host wall, reported beside it, carries the
    profiler's own overhead), the ms and launches of each group in
    ``kernels`` (name -> substrings, any of which in the lower-cased CUDA
    symbol puts a kernel in it), and the top 12 by device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        cycle()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cycle()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    device_ms = sum(r[1] for r in rows)
    check(device_ms > 0, "the profiler recorded no device time")
    mine = {}
    for name, tags in kernels.items():
        sel = [r for r in rows if any(t in r[0].lower() for t in tags)]
        mine[name] = {"ms": sum(r[1] for r in sel),
                      "launches": sum(r[2] for r in sel)}
    rows.sort(key=lambda r: -r[1])
    return {"cycle_ms": cycle_ms, "profiled_wall_ms": wall_ms,
            "device_ms": device_ms, "idle_share": 1.0 - device_ms / cycle_ms,
            "device_kernels": sum(r[2] for r in rows), "kernels": mine,
            "other_device_ms": device_ms - sum(v["ms"] for v in mine.values()),
            "top": [{"name": k[:80], "ms": v, "count": c}
                    for k, v, c in rows[:12]]}


def stokes_fields(dim: int):
    """u = curl psi, p = cos(pi x) cos(pi y) (cos(pi z)) and the forcing
    f = -lap u + grad p, with psi = sin^2(pi x) sin^2(pi y) (2D,
    tests/test_stokes.py:19-23) or the z-component (0, 0, psi) of a
    vector potential, psi = sin^2(pi x) sin^2(pi y) sin^2(pi z) (3D).
    Callables of coords (..., 3); u vanishes on the boundary."""
    pi = math.pi
    S = lambda t: torch.sin(pi * t) ** 2
    S1 = lambda t: pi * torch.sin(2 * pi * t)
    S2 = lambda t: 2 * pi ** 2 * torch.cos(2 * pi * t)
    S3 = lambda t: -4 * pi ** 3 * torch.sin(2 * pi * t)
    c, s_ = (lambda t: torch.cos(pi * t)), (lambda t: torch.sin(pi * t))
    Z = (lambda z: S(z)) if dim == 3 else (lambda z: 1.0)
    Z2 = (lambda z: S2(z)) if dim == 3 else (lambda z: 0.0)
    C = (lambda z: c(z)) if dim == 3 else (lambda z: 1.0)
    xyz = lambda p: (p[..., 0], p[..., 1], p[..., 2])

    def u0(p):
        x, y, z = xyz(p)
        return S(x) * S1(y) * Z(z)

    def u1(p):
        x, y, z = xyz(p)
        return -S1(x) * S(y) * Z(z)

    def pres(p):
        x, y, z = xyz(p)
        return c(x) * c(y) * C(z)

    def f0(p):
        x, y, z = xyz(p)
        lap = (S2(x) * S1(y) * Z(z) + S(x) * S3(y) * Z(z)
               + S(x) * S1(y) * Z2(z))
        return -lap - pi * s_(x) * c(y) * C(z)

    def f1(p):
        x, y, z = xyz(p)
        lap = (S3(x) * S(y) * Z(z) + S1(x) * S2(y) * Z(z)
               + S1(x) * S(y) * Z2(z))
        return lap - pi * c(x) * s_(y) * C(z)

    vel, force = [u0, u1], [f0, f1]
    if dim == 3:
        vel.append(lambda p: torch.zeros_like(p[..., 0]))
        force.append(lambda p: -pi * c(p[..., 0]) * c(p[..., 1])
                     * s_(p[..., 2]))
    return vel, pres, force


def stokes_rand_vec(st, gen):
    """A random Taylor-Hood vector: replicas consistent, velocity 0 on
    Dirichlet rows, the pressure's mean projected out."""
    from hyteg_tpu_torch.composites.stokes import TaylorHoodVec
    from hyteg_tpu_torch.core.types import FLAG_INNER

    x = st.zeros()
    vel = torch.randn(x.vel.shape, generator=gen, device=x.vel.device)
    vel *= st.vel_space.vertex_mask_t
    for d in range(st.dim):
        vel[d] = st.vel_space.exchange_rep(vel[d], st._vel_sd)
    pre = torch.randn(x.pre.shape, generator=gen, device=x.pre.device)
    pre = st.pre_space.exchange_rep(pre * st.pre_space.vertex_mask_t,
                                    st._pre_sd)
    return TaylorHoodVec(st._restore_vel_(vel, None, FLAG_INNER),
                         st.project_mean(pre))


def stokes_plain(st):
    """The composite's apply_inner and block-diagonal preconditioner with
    the plain versions of B5 (K, per component) and B3 (the lumped
    pressure mass) in place of the kernels, on the same device."""
    from hyteg_tpu_torch.composites.stokes import TaylorHoodVec
    from hyteg_tpu_torch.core.types import FLAG_INNER
    from hyteg_tpu_torch.kernels import p1_stencil as b3
    from hyteg_tpu_torch.kernels import p2_const_stencil as b5

    vsp, psp = st.vel_space, st.pre_space

    def apply_inner(x):
        vel = torch.stack([b5.p2_const_apply_torch(
            x.vel[d], st.K.stencil_folded, vsp.level, vsp.pitch, st.dim)
            for d in range(st.dim)]) * st.visc
        vel += st.B.apply_gradient_local(x.pre)
        div = st.B.apply_div_local(x.vel.unbind(0))
        return TaylorHoodVec(
            st._restore_vel_(st._exchange_vel_(vel), None, FLAG_INNER),
            st._mask_pressure_(psp._exchange_add_(div, st._pre_sd)))

    d = b3.p1_diagonal_local_torch(st.pmass.elmats, psp.level, st.dim,
                                   psp.pitch, True)
    pinv = st.pmass._inverse(psp._exchange_add_(d, st._pre_sd))
    kdiag = st.K_inverse_diagonal()
    return apply_inner, lambda r: TaylorHoodVec(kdiag * r.vel, pinv * r.pre)


def stokes_vec_err(a, b) -> float:
    """max |a - b| over velocity and pressure / max |b|."""
    err = max((a.vel - b.vel).abs().max().item(),
              (a.pre - b.pre).abs().max().item())
    return err / max(b.vel.abs().max().item(), b.pre.abs().max().item())


def stokes_manufactured(storage, level: int, device) -> dict:
    """The manufactured Stokes solve at one level (mesh's own pitch): b =
    (M f, 0), x0 = 0, MINRES with the block-diagonal preconditioner to
    STOKES_MINRES_RTOL (its true residual reported against
    STOKES_MINRES_RESIDUAL); the velocity L2 error (P2 mass) against the
    interpolant of u and the pressure's discrete l2 error (both means
    projected) relative to the interpolant's."""
    from hyteg_tpu_torch.composites.stokes import (P2P1TaylorHoodStokes,
                                                   TaylorHoodVec)
    from hyteg_tpu_torch.core.types import DoFType, FLAG_INNER
    from hyteg_tpu_torch.operators.p2_elementwise import P2ElementwiseOperator
    from hyteg_tpu_torch.solvers.krylov import minres_solve

    st = P2P1TaylorHoodStokes(storage, level, device=device)
    vsp, psp = st.vel_space, st.pre_space
    vel, pres, force = stokes_fields(st.dim)
    mass = P2ElementwiseOperator(vsp, "mass")
    bvel = torch.stack([vsp.restore_rows(
        mass.apply_raw(vsp.interpolate(f, vsp.zeros(), DoFType.ALL,
                                       st._vel_sd)),
        vsp.zeros(), FLAG_INNER, st._vel_sd) for f in force])
    b = TaylorHoodVec(bvel, psp.zeros())
    t0 = time.perf_counter()
    x, iters, phibar = minres_solve(st.apply_inner, st.dot, b, st.zeros(),
                                    STOKES_MINRES_ITERS, STOKES_MINRES_RTOL,
                                    st.block_diag_preconditioner())
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    r = (st.norm(b - st.apply_inner(x)) / st.norm(b)).item()
    uex = st.interpolate_velocity(vel, st.zeros())
    e = x.vel - uex.vel
    vel_err = math.sqrt(sum(vsp.dot(e[d], mass.apply_raw(e[d])).item()
                            for d in range(st.dim)))
    pex = st.project_mean(st.interpolate_pressure(pres, st.zeros()).pre)
    pe = st.project_mean(x.pre) - pex
    pre_err = (torch.sqrt(psp.dot(pe, pe)) / torch.sqrt(psp.dot(pex, pex))
               ).item()
    check(iters < STOKES_MINRES_ITERS and math.isfinite(r),
          f"Stokes MINRES level {level}: {iters} steps, residual {r}")
    check(math.isfinite(vel_err) and math.isfinite(pre_err),
          f"Stokes manufactured level {level}: non-finite error")
    return {"level": level, "global_dofs": st.dim * vsp.num_global_dofs()
            + psp.num_global_dofs(), "minres_steps": iters,
            "relative_residual": r,
            "residual_le_1e_4": r <= STOKES_MINRES_RESIDUAL,
            "solve_s": solve_s,
            "velocity_l2_error": vel_err, "pressure_rel_l2_error": pre_err}


def stokes_run(storage, level: int, device, card: str, tag: str) -> dict:
    """The Stokes path at one size: make_stokes_gmg from P2 level 1 to
    ``level``, its V-cycle on A x = 0 from a random consistent start
    (kernels B5 and B3 counted: the main path), then the checks (block
    apply and preconditioner against the plain B5 / B3, symmetry), a
    profile of one V-cycle, and the manufactured solves."""
    from hyteg_tpu_torch.kernels import p1_stencil as b3
    from hyteg_tpu_torch.kernels import p2_const_stencil as b5
    from hyteg_tpu_torch.solvers.uzawa import make_stokes_gmg

    suffix = "_2d" if storage.dim == 2 else ""
    counted = (b5.p2_const_apply, b3.p1_diagonal_local)
    torch.cuda.reset_peak_memory_stats()
    for w in counted:  # the main path: every count starts at 0 here
        setattr(w, "launches" + suffix, 0)
    t0 = time.perf_counter()
    stack = make_stokes_gmg(storage, STOKES_MIN_LEVEL, level, device=device,
                            **STOKES_KW)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    st = stack.stokes[level]
    gen = torch.Generator(device=device).manual_seed(130 + storage.dim)
    x = stokes_rand_vec(st, gen)
    b = st.zeros()
    res, cycle_ms = [st.norm(b - st.apply_inner(x)).item()], []
    for _ in range(STOKES_CYCLES):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        x = stack.gmg.cycle(x, b)
        ev[1].record()
        res.append(st.norm(b - st.apply_inner(x)).item())
        cycle_ms.append(ev[0].elapsed_time(ev[1]))
    torch.cuda.synchronize()
    steps = {"setup": setup_s, "cycles": time.perf_counter() - t0 - setup_s}
    launches = {w.__name__ + suffix: getattr(w, "launches" + suffix)
                for w in counted}
    rates = [res[i + 1] / res[i] for i in range(STOKES_CYCLES)]
    out = {"mesh": tag, "level": level, "min_level": STOKES_MIN_LEVEL,
           "global_dofs": st.dim * st.vel_space.num_global_dofs()
           + st.pre_space.num_global_dofs(),
           "vel_block": [st.dim] + list(st.vel_space.block_shape),
           "pre_block": list(st.pre_space.block_shape),
           "eigs": stack.eigs, "setup_s": setup_s, "residuals": res,
           "rates": rates, "each_rate_le_0_6": all(r <= STOKES_RATE_MAX
                                                   for r in rates),
           "launches": launches}
    check(all(math.isfinite(r) for r in res),
          f"Stokes {tag} V-cycle: non-finite residuals {res}")
    check(min(rates) <= STOKES_RATE_MAX,
          f"Stokes {tag} V-cycle: best rate {min(rates)} > {STOKES_RATE_MAX}")
    check(res[-1] <= STOKES_FINAL_MAX * res[0],
          f"Stokes {tag} V-cycle: residual {res[-1]} > {STOKES_FINAL_MAX}"
          f" * {res[0]} after {STOKES_CYCLES} cycles")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the Stokes path ({tag})")

    # the block apply and the preconditioner against the plain B5 / B3
    apply_plain, prec_plain = stokes_plain(st)
    a = stokes_rand_vec(st, gen)
    y = st.apply_inner(a)
    out["apply_vs_plain_rel"] = stokes_vec_err(y, apply_plain(a))
    out["prec_vs_plain_rel"] = stokes_vec_err(
        st.block_diag_preconditioner()(y), prec_plain(y))
    for k in ("apply_vs_plain_rel", "prec_vs_plain_rel"):
        check(math.isfinite(out[k]) and out[k] <= STOKES_APPLY_RTOL,
              f"Stokes {tag} {k} {out[k]} > {STOKES_APPLY_RTOL}")
    c = stokes_rand_vec(st, gen)
    s1, s2 = st.dot(c, y).item(), st.dot(a, st.apply_inner(c)).item()
    out["symmetry"] = {"b_Aa": s1, "a_Ab": s2,
                       "rel": abs(s1 - s2) / abs(s1)}
    check(abs(s1 - s2) <= STOKES_SYM_RTOL * abs(s1),
          f"Stokes {tag} operator not symmetric: {s1} vs {s2}")
    del a, c, y
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    t1 = time.perf_counter()
    steps["checks"] = t1 - t0 - sum(steps.values())

    # one V-cycle's time split: CUDA events around each of the four cycles
    # above (their median), torch.profiler over one more, whose B5
    # launches by level the wrapper counts
    out["cycle_ms"] = cycle_ms
    out["ms_per_vcycle"] = sorted(cycle_ms)[len(cycle_ms) // 2]
    by_level = getattr(b5.p2_const_apply, "launches_by_level" + suffix)
    by_level.clear()
    prof = cycle_profile(lambda: stack.gmg.cycle(x, b), out["ms_per_vcycle"],
                         {"b5": ("p2_const_apply_kernel",
                                 "p2_const_apply_2d_kernel"),
                          "b3": ("p1_diag",),
                          "index": ("index", "scatter", "gather"),
                          "reduce": ("reduce",)}, warmup=0)
    by_level = dict(sorted(by_level.items()))
    steps["profile"] = time.perf_counter() - t1
    B = st.B
    div = lambda: B.apply_div_local(x.vel.unbind(0))
    grad = lambda: B.apply_gradient_local(x.pre)
    div_ms, grad_ms = median_ms(div, 3), median_ms(grad, 3)
    k_ms = median_ms(lambda: st.apply_K(x.vel), 3)
    # device time of one div and one gradient on the finest level (the
    # profiler's, as the cycle's device_ms); per level and cycle there is
    # one of each in every Uzawa sweep and in the residual
    div_dev = cycle_profile(div, div_ms, {}, warmup=1)["device_ms"]
    grad_dev = cycle_profile(grad, grad_ms, {}, warmup=1)["device_ms"]
    per_cycle = STOKES_KW["pre_smooth"] + STOKES_KW["post_smooth"] + 1
    emit("stokes_profile" + suffix, card=card, level=level, **prof,
         b5_launches_by_level=by_level,
         b5_launches_per_vcycle=sum(by_level.values()),
         div_ms=div_ms, grad_ms=grad_ms, apply_K_ms=k_ms,
         div_device_ms=div_dev, grad_device_ms=grad_dev,
         divgrad_device_ms_finest_level_per_cycle=per_cycle
         * (div_dev + grad_dev),
         divgrad_share_of_cycle_device_ms=per_cycle * (div_dev + grad_dev)
         / prof["device_ms"])
    out["b5_launches_per_vcycle"] = sum(by_level.values())
    del stack, st, x, b, B, apply_plain, prec_plain
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    steps["pass_timings"] = t2 - t0 - sum(steps.values())

    # the manufactured solve (the mesh's own pitch at each level)
    lo, hi = STOKES_MANUFACTURED[storage.dim]
    man = [stokes_manufactured(storage, lv, device) for lv in (lo, hi)]
    for m in man:
        emit("stokes_manufactured" + suffix, card=card, **m)
    drop = man[0]["velocity_l2_error"] / man[1]["velocity_l2_error"]
    out["velocity_error_drop"] = drop
    steps["manufactured"] = time.perf_counter() - t2
    out["step_s"] = steps
    out["pressure_error_drop"] = (man[0]["pressure_rel_l2_error"]
                                  / man[1]["pressure_rel_l2_error"])
    check(drop >= STOKES_ERR_DROP_MIN,
          f"Stokes {tag} velocity error dropped {drop}x from level {lo} "
          f"to {hi}, < {STOKES_ERR_DROP_MIN}x")
    torch.cuda.empty_cache()
    return out


def check_b3_stokes_levels(storage, levels, device, seed: int,
                          pitch: int = PITCH) -> dict:
    """B3 (B3-2D on a 2D mesh) against its plain version on the pressure
    mass (lumped and not) at P1 levels a Stokes stack reaches below the
    other phases' checks, on the stack's lane pitch (3D)."""
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.kernels import p1_stencil as b3
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.p1_elementwise import compute_elmats

    out = {}
    for level in levels:
        sp = P1Space(storage, level, device=device, pitch=pitch)
        elm = compute_elmats(sp, forms.mass_form,
                             sp.resolve_sd().cell_vertices).contiguous()
        outside = ~sp.vertex_mask_t.bool()
        for lumped in (False, True):
            args = (elm, level, sp.dim, sp.pitch, lumped)
            d, d_ref = b3.p1_diagonal_local(*args), \
                b3.p1_diagonal_local_torch(*args)
            err, scale = max_abs_diff(d, d_ref), d_ref.abs().max().item()
            tag = f"level{level}_mass{'_lumped' if lumped else ''}"
            check(math.isfinite(err) and err <= B3_RTOL * scale,
                  f"B3 ({sp.dim}D) {tag}: max|dd| {err} > {B3_RTOL} * "
                  f"{scale}")
            check(not d[:, outside].any().item(),
                  f"B3 ({sp.dim}D) {tag}: nonzero outside the simplex")
            out[tag] = {"max_abs_err": err, "max_abs": scale,
                        "block": list(sp.block_shape), "pitch": sp.pitch}
    return out


def run_stokes(storage3d, device, card: str) -> dict:
    """The Stokes path, 3D on mesh_unit_cube(2) at P2 level 6 and 2D on
    the rect at P2 level 8 (phases stokes_kernels, stokes, stokes_2d,
    stokes_profile(_2d), stokes_manufactured(_2d)). Returns the launches
    and errors for the kernels line."""
    from hyteg_tpu_torch.mesh.meshinfo import mesh_rectangle
    from hyteg_tpu_torch.primitives.storage import CellStorage

    rect = CellStorage(mesh_rectangle(**RECT_2D))
    t0 = time.perf_counter()
    b3c = {"3d": check_b3_stokes_levels(storage3d, (1,), device, 140),
           "2d": check_b3_stokes_levels(rect, (1,), device, 141)}
    emit("stokes_kernels", card=card, b3_vs_plain=b3c)
    errs = {"p1_diagonal_local": max(
        v["max_abs_err"] for v in b3c["3d"].values()),
        "p1_diagonal_local_2d": max(
            v["max_abs_err"] for v in b3c["2d"].values())}
    res3 = stokes_run(storage3d, STOKES_LEVEL, device, card,
                      f"mesh_unit_cube({MESH_N})")
    emit("stokes", card=card, **res3)
    res2 = stokes_run(rect, STOKES_LEVEL_2D, device, card,
                      "mesh_rectangle(nx=4, ny=4)")
    emit("stokes_2d", card=card, **res2)
    return {"launches": {**res3["launches"], **res2["launches"]},
            "errs": errs, "phase_s": time.perf_counter() - t0,
            "ref3d": {k: res3[k] for k in ("residuals", "eigs", "cycle_ms",
                                            "global_dofs")}}


def run_2d(device, card: str) -> dict:
    """The 2D arm on macro-faces: phases kernels_2d, gmg_2d, coeff_2d and
    p2_gmg_2d, each with its kernels' 2D launch counts set to 0 just
    before its main run (gmg_2d: the level-11 solve, after the small
    error-drop solves) and read just after. Returns the kernels line's inputs:
    launches, max_abs_err, ms and plain ms, the work of each bound
    (bytes, operations), library ms, and the 2D block's element count."""
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.indexing import micro
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.kernels import p1_stencil as b34
    from hyteg_tpu_torch.kernels import p2_const_stencil as b5
    from hyteg_tpu_torch.mesh.meshinfo import mesh_annulus, mesh_rectangle
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.averaging import MODES
    from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
    from hyteg_tpu_torch.primitives.storage import CellStorage

    storages = {"rect": CellStorage(mesh_rectangle(**RECT_2D)),
                "annulus": CellStorage(mesh_annulus(*ANNULUS_2D))}
    errs, launches, t, work, lib = {}, {}, {}, {}, {}

    # -- kernels_2d: B2-2D, B3-2D, B5-2D against their plain versions ------
    p1c, p2c = [], []
    for i, (mesh, lv, lv2) in enumerate(KERNEL_CHECKS_2D):
        p1c.append(check_kernels(storages[mesh], lv, device, seed=100 + i))
        torch.cuda.empty_cache()
        p2c.append(check_p2_kernels(storages[mesh], lv2, device, seed=110 + i,
                                    vs_general=lv2 == P2_LEVEL_2D))
        torch.cuda.empty_cache()
        emit("kernels_2d", card=card, mesh=mesh, p1=p1c[-1], p2=p2c[-1])
    rect_p1 = [c for c, (mesh, *_) in zip(p1c, KERNEL_CHECKS_2D)
               if mesh == "rect"]
    for lv in P1_CHECK_LEVELS_2D:
        rect_p1.append(check_kernels(storages["rect"], lv, device,
                                     seed=170 + lv))
        emit("p1_kernels_2d", card=card, mesh="rect", **rect_p1[-1])
    p1c += rect_p1[1:]
    torch.cuda.empty_cache()
    # B2-2D's ms and bound at every level of the rect P1 stack
    b2_levels = {c["level"]: (c["b2_ms"], c["b2_bound_ms"]) for c in rect_p1}
    emit("b2_2d_levels", card=card, level=sorted(b2_levels),
         b2_2d_ms=[b2_levels[lv][0] for lv in sorted(b2_levels)],
         b2_2d_bound_ms=[b2_levels[lv][1] for lv in sorted(b2_levels)])
    rect_p2 = [c for c, (mesh, *_) in zip(p2c, KERNEL_CHECKS_2D)
               if mesh == "rect"]
    for lv in P2_CHECK_LEVELS_2D:
        rect_p2.append(check_p2_kernels(storages["rect"], lv, device,
                                        seed=160 + lv, vs_general=False))
        emit("p2_kernels_2d", card=card, mesh="rect", **rect_p2[-1])
    p2c += rect_p2[1:]
    torch.cuda.empty_cache()
    # B5-2D's ms and bound at every level of the rect P2 stack
    b5_levels = {c["level"]: (c["b5_ms"], c["b5_bound_ms"]) for c in rect_p2}
    emit("b5_2d_levels", card=card, level=sorted(b5_levels),
         b5_2d_ms=[b5_levels[lv][0] for lv in sorted(b5_levels)],
         b5_2d_bound_ms=[b5_levels[lv][1] for lv in sorted(b5_levels)])
    for name, checks, tag in (("p1_const_apply_2d", p1c, "b2_"),
                              ("p1_diagonal_local_2d", p1c, "b3_"),
                              ("p2_const_apply_2d", p2c, "b5_")):
        errs[name] = max(v for c in checks for k, v in c.items()
                         if k.startswith(tag) and k.endswith("_max_abs_err"))

    # -- gmg_2d: the 2D main path (B2-2D, B3-2D) ---------------------------
    rect = storages["rect"]
    low = {}
    for lv in ERR_LEVELS_2D:
        low[lv], stack, _ = solve(rect, lv, device, gate_rate=False)
        del stack
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b2.p1_const_apply.launches_2d = 0
    b34.p1_diagonal_local.launches_2d = 0
    res, stack, (x, b) = solve(rect, LEVEL_2D, device, gate_rate=False)
    launches["p1_const_apply_2d"] = b2.p1_const_apply.launches_2d
    launches["p1_diagonal_local_2d"] = b34.p1_diagonal_local.launches_2d
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["peak_gb"] = res["peak_bytes"] / 1e9
    hom = homogeneous_rates(stack, device, seed=120)
    lo, hi = ERR_LEVELS_2D[:2]
    drop = low[lo]["max_nodal_error"] / low[hi]["max_nodal_error"]
    for lv in ERR_LEVELS_2D:
        emit("gmg_2d_levels", card=card, **low[lv])
    emit("gmg_2d", card=card, mesh="mesh_rectangle(nx=4, ny=4)", **res,
         homogeneous=hom, error_drop=drop, error_drop_levels=[lo, hi],
         launches={k: launches[k] for k in ("p1_const_apply_2d",
                                            "p1_diagonal_local_2d")})
    check(res["global_dofs"] == (4 * 2 ** LEVEL_2D + 1) ** 2,
          f"2D level {LEVEL_2D}: {res['global_dofs']} DoFs")
    check(drop >= ERR_DROP_MIN, f"2D nodal error dropped {drop}x from level "
          f"{lo} to {hi}, < {ERR_DROP_MIN}x")
    for name in ("p1_const_apply_2d", "p1_diagonal_local_2d"):
        check(launches[name] > 0, f"{name} was not launched on the 2D path")
    sp, op = stack.space(), stack.operators[LEVEL_2D]
    A, E, elm = op.stencil, op.stencil_face, op.elmats
    L, C = LEVEL_2D, sp.C_loc
    t["p1_const_apply_2d"] = median_ms(
        lambda: b2.p1_const_apply(x, A, E, L, 2, sp.pitch), 10, batch=10)
    t["p1_const_apply_2d_plain"] = median_ms(
        lambda: b2.p1_const_apply_torch(x, A, L, 2, sp.pitch, E=E), 5)
    t["p1_diagonal_local_2d"] = median_ms(
        lambda: b34.p1_diagonal_local(elm, L, 2, sp.pitch), 10, batch=10)
    t["p1_diagonal_local_2d_plain"] = median_ms(
        lambda: b34.p1_diagonal_local_torch(elm, L, 2, sp.pitch), 5)
    t["apply_raw_2d"] = median_ms(lambda: op.apply_raw(x), 10, batch=10)
    t["vcycle_2d"] = median_ms(lambda: stack.gmg.cycle(x, b), 10)
    margins = micro.base_margin(2)
    work["p1_const_apply_2d"] = b2_work(sp, x, A, E)
    work["p1_diagonal_local_2d"] = b3_work(sp, elm, x)
    xv = x.view(1, C, sp.N, sp.N)
    kern = conv2d_stencil(A.sum(-1), micro.stencil_directions(2))
    lib["p1_const_apply_2d"] = median_ms(
        lambda: F.conv2d(xv, kern, padding=1, groups=C), 10, batch=10)
    prof = cycle_profile(lambda: stack.gmg.cycle(x, b), t["vcycle_2d"], {
        "p1_const_apply_2d": ("p1_const_apply_2d_kernel",),
        "p1_diagonal_local_2d": ("p1_diag_2d_kernel",)})
    by_level = launches_by_level(stack, x, b, b2.p1_const_apply, dim=2)
    emit("gmg_2d_timings", card=card, level=L, ms={
        k: t[k] for k in ("apply_raw_2d", "vcycle_2d")}, profile=prof,
        b2_2d_launches_by_level=by_level,
        b2_2d_ms_lost_per_cycle=ms_lost(
            prof["kernels"]["p1_const_apply_2d"]["ms"], by_level,
            {lv: v[1] for lv, v in b2_levels.items()}))
    block_elements = x.numel()
    del A, E, elm, xv, kern, prof
    torch.cuda.empty_cache()
    # -- mixed_precision_2d: the bf16 2D P1 stack (B2-2D-bf16, B3-2D-bf16)
    # under an f32 refinement, on this phase's f32 stack and problem (its
    # histories reported), then gated at MP_GATE_2D["p1"] ----------------
    mixed = {}
    for path, run in (
            ("mixed_precision_2d", lambda: mixed_precision_on(
                stack, manufactured(stack)[0], b, res["residuals"],
                t["vcycle_2d"], device, "p1", gated=False)),
            ("mixed_precision_2d_gated", lambda: mixed_precision_2d_gate(
                rect, device, "p1"))):
        zero_counts()
        t1 = time.perf_counter()
        mixed[path] = run()
        emit(path, card=card, phase_s=time.perf_counter() - t1,
             mesh="mesh_rectangle(nx=4, ny=4)", **mixed[path])
        for name in ("p1_const_apply_2d_bf16", "p1_diagonal_local_2d_bf16"):
            check(mixed[path]["launches"].get(name, 0) > 0,
                  f"{name} was not launched on the {path} path")
        if path == "mixed_precision_2d":
            del stack, sp, op, x, b
            torch.cuda.empty_cache()

    # -- coeff_2d: the P1 coefficient operator (B4-2D; B3-2D with k) -------
    b4c = []
    for i, (mesh, lv) in enumerate(B4_CHECKS_2D):
        b4c.append(check_coeff_kernels(storages[mesh], lv, device,
                                       seed=130 + i))
        emit("coeff_2d_kernels", card=card, mesh=mesh, **b4c[-1])
        torch.cuda.empty_cache()
    errs["p1_apply_local_2d"] = max(v for c in b4c for k, v in c.items()
                                    if k.endswith("_max_abs_err"))
    sp = P1Space(rect, L, device=device)
    op = P1ElementwiseOperator(sp, forms.laplace_form)
    k = coeff_field(sp, device, None, "linear")
    b34.p1_apply_local.launches_2d = 0
    b34.p1_diagonal_local.launches_2d = 0
    sym = symmetric_positive(sp, lambda v: op.apply_raw(v, coeff=k), 140,
                             f"2D P1 coefficient operator level {L}")
    dinv = op.inverse_diagonal(coeff=k)[:, sp.vertex_mask_t.bool()]
    coeff_launches = {"p1_apply_local_2d": b34.p1_apply_local.launches_2d,
                      "p1_diagonal_local_2d": b34.p1_diagonal_local.launches_2d}
    emit("coeff_2d", card=card, level=L, coefficient="1 + x + 0.5 y", **sym,
         inv_diag_min=dinv.min().item(), inv_diag_max=dinv.max().item(),
         launches=coeff_launches)
    check(bool(torch.isfinite(dinv).all()) and dinv.min().item() > 0,
          "the 2D inverse diagonal with a coefficient is not finite and "
          "positive")
    for name, n in coeff_launches.items():
        check(n > 0, f"{name} was not launched on the 2D coefficient path")
    launches["p1_apply_local_2d"] = coeff_launches["p1_apply_local_2d"]
    x = sp.exchange_rep(torch.randn(
        sp.block_shape, device=device,
        generator=torch.Generator(device=device).manual_seed(141))
        * sp.vertex_mask_t)
    elm = op.elmats
    t["p1_apply_local_2d"] = median_ms(
        lambda: b34.p1_apply_local(x, elm, L, 2, sp.pitch, k), 10, batch=10)
    t["p1_apply_local_2d_plain"] = median_ms(
        lambda: b34.p1_apply_local_torch(x, elm, L, 2, sp.pitch, k), 3,
        warmup=1)
    t["p1_apply_local_2d_no_coeff"] = median_ms(
        lambda: b34.p1_apply_local(x, elm, L, 2, sp.pitch), 10, batch=10)
    t["apply_raw_coeff_2d"] = median_ms(lambda: op.apply_raw(x, coeff=k), 10,
                                        batch=10)
    work["p1_apply_local_2d"] = b4_work(sp, x, elm)
    b4_ms = {"none": t["p1_apply_local_2d_no_coeff"],
             "arithmetic": t["p1_apply_local_2d"]}
    for m in MODES[1:]:
        b4_ms[m] = median_ms(
            lambda m=m: b34.p1_apply_local(x, elm, L, 2, sp.pitch, k, m), 10,
            batch=10)
    b4_coeff = b4_mode_line(
        L, b4_ms, bound(*work["p1_apply_local_2d"])[0],
        bound(nbytes(x) + simplex_read_bytes(sp, [(0, 0)], C) + nbytes(elm),
              18 * C * sum(tri_points(sp.n - int(m)) for m in margins))[0],
        t["apply_raw_coeff_2d"])
    # B3-2D with the coefficient, in each mean (the inverse diagonal of a
    # variable-coefficient smoother): the block written once, the
    # coefficient read on the triangle; per (element, vertex) term 3 adds
    # of the mean, its division and a multiply-add
    b3_coeff = {"ms": {m: median_ms(
        lambda m=m: b34.p1_diagonal_local(elm, L, 2, sp.pitch, False, k, m),
        10, batch=10) for m in MODES}}
    b3_coeff["bound_ms"], b3_coeff["bound_by"], *_ = bound(
        nbytes(elm) + nbytes(x) + simplex_read_bytes(sp, [(0, 0)], C),
        6 * 3 * C * sum(tri_points(sp.n - int(m)) for m in margins))
    emit("b3_2d_coeff", card=card, level=L, coefficient="1 + x + 0.5 y",
         **b3_coeff)
    del sp, op, k, dinv, x, elm
    torch.cuda.empty_cache()

    # -- p2_gmg_2d: the P2 GMG stack (B5-2D) --------------------------------
    b5.p2_const_apply.launches_2d = 0
    p2res, stack, (x, b) = p2_gmg(rect, device, level=P2_LEVEL_2D,
                                  cycles=P2_CYCLES_2D,
                                  floor_rel=P2_FLOOR_REL_2D)
    launches["p2_const_apply_2d"] = b5.p2_const_apply.launches_2d
    p2res["homogeneous"] = homogeneous_rates(stack, device, seed=150,
                                             max_rate=P2_RATE_MAX)
    p2res["launches"] = {"p2_const_apply_2d": launches["p2_const_apply_2d"]}
    check(launches["p2_const_apply_2d"] > 0,
          "p2_const_apply_2d was not launched on the 2D P2 path")
    check(p2res["global_dofs"] == (4 * 2 ** LEVEL_2D + 1) ** 2,
          f"2D P2 level {P2_LEVEL_2D}: {p2res['global_dofs']} DoFs")
    p2res["ms_per_vcycle"] = median_ms(lambda: stack.gmg.cycle(x, b), 3,
                                       warmup=1)
    p2res["peak_bytes"] = torch.cuda.max_memory_allocated()
    p2res["peak_gb"] = p2res["peak_bytes"] / 1e9
    n0 = b5.p2_const_apply.launches_2d
    stack.gmg.cycle(x, b)
    p2res["b5_launches_per_vcycle"] = b5.p2_const_apply.launches_2d - n0
    emit("p2_gmg_2d", card=card, **p2res)
    prof = p2_cycle_profile(stack, x, b, p2res["ms_per_vcycle"])
    by_level = launches_by_level(stack, x, b, b5.p2_const_apply, dim=2)
    emit("p2_profile_2d", card=card, level=P2_LEVEL_2D, **prof,
         b5_launches_by_level=by_level,
         b5_ms_lost_per_cycle=ms_lost(prof["kernels"]["b5"]["ms"], by_level,
                                      {lv: v[1] for lv, v in b5_levels.items()}))
    sp, op = stack.space(), stack.operators[P2_LEVEL_2D]
    W = op.stencil_folded
    t["p2_const_apply_2d"] = median_ms(
        lambda: b5.p2_const_apply(x, W, P2_LEVEL_2D, sp.pitch, 2), 10,
        batch=10)
    t["p2_const_apply_2d_plain"] = median_ms(
        lambda: b5.p2_const_apply_torch(x, W, P2_LEVEL_2D, sp.pitch, 2), 3,
        warmup=1)
    t["p2_apply_raw_2d"] = median_ms(lambda: op.apply_raw(x), 10, batch=10)
    t["p2_vcycle_2d"] = p2res["ms_per_vcycle"]
    work["p2_const_apply_2d"] = b5_work(sp, x, W, P2_LEVEL_2D)
    del op, W
    # -- mixed_precision_p2_2d: the bf16 2D P2 stack (B5-2D-bf16) under an
    # f32 refinement, on this phase's f32 stack and rhs (its histories
    # reported), then gated at MP_GATE_2D["p2"] ------------------------------
    for path, run in (
            ("mixed_precision_p2_2d", lambda: mixed_precision_on(
                stack, torch.zeros_like(b), b, p2res["residuals"],
                p2res["ms_per_vcycle"], device, "p2", gated=False)),
            ("mixed_precision_p2_2d_gated", lambda: mixed_precision_2d_gate(
                rect, device, "p2"))):
        zero_counts()
        t1 = time.perf_counter()
        mixed[path] = run()
        emit(path, card=card, phase_s=time.perf_counter() - t1,
             mesh="mesh_rectangle(nx=4, ny=4)", **mixed[path])
        check(mixed[path]["launches"].get("p2_const_apply_2d_bf16", 0) > 0,
              f"p2_const_apply_2d_bf16 was not launched on the {path} path")
        if path == "mixed_precision_p2_2d":
            del stack, sp, x, b
            torch.cuda.empty_cache()
    man = {}
    for lv in P2_MANUFACTURED_2D:
        man[lv] = p2_manufactured(rect, lv, device,
                                  min_level=P2_MANUFACTURED_MIN_2D)
        emit("p2_manufactured_2d", card=card, **man[lv])
    lo, hi = P2_MANUFACTURED_2D[:2]
    drop = man[lo]["max_nodal_error"] / man[hi]["max_nodal_error"]
    emit("p2_2d_checks", error_drop=drop, error_drop_levels=[lo, hi])
    check(drop >= P2_ERR_DROP_MIN, f"2D P2 nodal error dropped {drop}x from "
          f"level {lo} to {hi}, < {P2_ERR_DROP_MIN}x")
    return {"errs": errs, "launches": launches, "ms": t, "work": work,
            "library_ms": lib, "block_elements": block_elements,
            "b4_coeff": b4_coeff, "b3_coeff": b3_coeff, "mixed": mixed}


def rim_deviation(sp, comps, radii: tuple) -> dict:
    """Radii of a blended micro-vertex field (comps: (dim, C, N, lanes)):
    their range over every vertex slot, and the largest distance from the
    rim's radius of the slots flagged 1 (inner) and 2 (outer)
    (tests/test_blending.py::test_radial_map_snaps_rims)."""
    r = torch.linalg.vector_norm(comps, dim=0)
    rv = r[:, sp.vertex_mask_t.bool()]
    out = {"r_min": rv.min().item(), "r_max": rv.max().item()}
    m = sp.maps
    sf, fl = m.slot_flat[0], m.slot_meshflag[0]
    ok = sf < r.numel()
    for flag, rad in zip((1, 2), radii):
        idx = torch.as_tensor(sf[ok][fl[ok] == flag], device=r.device)
        check(idx.numel() > 0, f"no slot flagged {flag}")
        out[f"flag{flag}_max_dev"] = (r.reshape(-1)[idx] - rad).abs().max().item()
    check(out["r_min"] > radii[0] - RIM_ATOL
          and out["r_max"] < radii[1] + RIM_ATOL,
          f"blended radii outside [{radii[0]}, {radii[1]}]: {out}")
    for flag in (1, 2):
        check(out[f"flag{flag}_max_dev"] <= RIM_ATOL,
              f"rim {flag} off its radius by {out[f'flag{flag}_max_dev']}")
    return out


def blended_measure(sp, gmap, exact: float) -> dict:
    """Area (2D) or volume (3D) as 1^T M 1 with the blended mass and with
    the affine one (kernel B2 / B2-2D): the blended error must be below
    AREA_RATIO_MAX of the affine (polygonal) one
    (tests/test_blending.py::test_blended_mass_matches_true_area)."""
    from hyteg_tpu_torch.core.types import DoFType
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.p1_blended import P1BlendedOperator
    from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator

    ones = sp.interpolate(1.0, None, DoFType.ALL)
    aff = sp.dot(ones, P1ElementwiseOperator(sp, forms.mass_form)
                 .apply_raw(ones)).item()
    ble = sp.dot(ones, P1BlendedOperator(sp, forms.mass_form, gmap)
                 .apply_raw(ones)).item()
    ratio = abs(ble - exact) / abs(aff - exact)
    check(ratio < AREA_RATIO_MAX,
          f"blended measure error {abs(ble - exact)} not below "
          f"{AREA_RATIO_MAX} x the affine {abs(aff - exact)}")
    return {"exact": exact, "affine": aff, "blended": ble,
            "affine_error": aff - exact, "blended_error": ble - exact,
            "error_ratio": ratio}


def check_blend_kernels(device) -> dict:
    """Kernels B2-2D and B2 against their plain versions at the shapes the
    blended path launches them at (the annulus at P1 level 11, the shell
    at level 5), on the Laplace and mass stencils of the affine operator
    and a random consistent block."""
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.mesh.meshinfo import mesh_annulus, mesh_spherical_shell
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
    from hyteg_tpu_torch.primitives.storage import CellStorage

    gen = torch.Generator(device=device).manual_seed(151)
    out = {}
    for name, mesh, level in (
            ("p1_const_apply_2d", mesh_annulus(*BLEND_ANNULUS), BLEND_LEVEL_2D),
            ("p1_const_apply", mesh_spherical_shell(*SHELL), BLEND_LEVEL_3D)):
        sp = P1Space(CellStorage(mesh), level, device=device)
        x = consistent_randn(sp, gen)
        args = (sp.level, sp.dim, sp.pitch)
        for form in (forms.laplace_form, forms.mass_form):
            op = P1ElementwiseOperator(sp, form)
            y = b2.p1_const_apply(x, op.stencil, op.stencil_face, *args)
            y_ref = b2.p1_const_apply_torch(x, op.stencil, *args,
                                            E=op.stencil_face)
            err, scale = max_abs_diff(y, y_ref), y_ref.abs().max().item()
            check(math.isfinite(err) and err <= B2_RTOL * scale,
                  f"{name} blending level {level}: max|dy| {err} > "
                  f"{B2_RTOL} * {scale}")
            check(not y[:, ~sp.vertex_mask_t.bool()].any().item(),
                  f"{name} blending: nonzero outside the simplex")
            out[name] = max(out.get(name, 0.0), err)
            del y, y_ref
        del sp, x
        torch.cuda.empty_cache()
    return out


def blended_apply_timing(sp, op, x, tag: str) -> dict:
    """The exact blended apply's ms (CUDA events, median of 3), GDoF/s,
    peak memory over the calls and a profile of one call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = median_ms(lambda: op.apply_raw(x), 3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = cycle_profile(lambda: op.apply_raw(x), ms, BLEND_GROUPS,
                         warmup=0)
    return {f"{tag}_ms": ms, f"{tag}_gdofs_per_s":
            sp.num_global_dofs() / (ms * 1e-3) / 1e9,
            f"{tag}_peak_gb": peak, f"{tag}_profile": prof}


def blend_manufactured(storage, level: int, device, u_of_r) -> dict:
    """-lap u = 0 with u = u_of_r(r) on the blended domain (RadialMap),
    Dirichlet on both rims, by CG from the interpolated boundary values
    (rtol BLEND_CG_RTOL): the blended-mass L2 error of the solution
    (tests/test_blending.py::test_blended_annulus_poisson_gmg)."""
    from hyteg_tpu_torch.core.types import (BoundaryCondition, DoFType,
                                            FLAG_INNER)
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.geometry.maps import RadialMap
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.p1_blended import P1BlendedOperator
    from hyteg_tpu_torch.solvers.krylov import cg_solve

    sp = P1Space(storage, level, device=device)
    sd = sp.shard_data(0, BoundaryCondition.all_dirichlet())
    lap = P1BlendedOperator(sp, forms.laplace_form, RadialMap())
    mass = P1BlendedOperator(sp, forms.mass_form, RadialMap())
    r = torch.clamp(torch.linalg.vector_norm(lap.comps, dim=0), min=1e-9)
    uex = sp.exchange_rep(u_of_r(r) * sp.vertex_mask_t, sd)
    x0 = sp.restore_rows(uex, sp.zeros(), DoFType.DIRICHLET, sd)
    apply = lambda v: lap.apply_inner(v, sd)
    dot = lambda u, v: sp.dot(u, v, FLAG_INNER, sd)
    r0 = apply(x0)  # b = 0
    t0 = time.perf_counter()
    res = cg_solve(apply, dot, sp.zeros(), x0, BLEND_CG_ITERS,
                   rtol=BLEND_CG_RTOL)
    torch.cuda.synchronize()
    e = res.x - uex
    l2 = torch.sqrt(sp.dot(e, mass.apply_raw(e), DoFType.ALL, sd)).item()
    check(math.isfinite(l2), f"blended solve level {level}: L2 error {l2}")
    return {"level": level, "global_dofs": sp.num_global_dofs(),
            "cg_iterations": res.iterations, "cg_rel_residual": math.sqrt(
                res.residual_norm2.item() / dot(r0, r0).item()),
            "solve_s": time.perf_counter() - t0, "l2_error": l2}


def surrogate_rows(sp, exact, x, degrees, timed: bool) -> list:
    """The LSQP surrogate of ``exact``'s form at each degree: its fit's
    seconds, its error against the exact apply (computeSurrogateError) and,
    if ``timed``, its apply's ms and GDoF/s."""
    from hyteg_tpu_torch.operators.p1_blended import P1SurrogateOperator

    rows = []
    for deg in degrees:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sur = P1SurrogateOperator(sp, exact.form, exact.gmap, degree=deg)
        torch.cuda.synchronize()
        row = {"degree": deg, "setup_s": time.perf_counter() - t0,
               "error": sur.compute_surrogate_error(exact, x).item()}
        check(math.isfinite(row["error"]),
              f"surrogate degree {deg}: error {row['error']}")
        if timed:
            row["apply_ms"] = median_ms(lambda: sur.apply_raw(x), 3,
                                        warmup=1)
            row["apply_gdofs_per_s"] = (sp.num_global_dofs()
                                        / (row["apply_ms"] * 1e-3) / 1e9)
        rows.append(row)
        del sur
    return rows


def consistent_randn(sp, gen) -> torch.Tensor:
    return sp.exchange_rep(torch.randn(sp.block_shape, generator=gen,
                                       device=sp.device) * sp.vertex_mask_t)


def blend_2d(device) -> dict:
    """The blended annulus mesh_annulus(0.5, 1, 12, 2) (RadialMap): rims
    and area at P1 level 11 (100,687,872 DoFs; the affine mass through
    B2-2D), the exact blended Laplace apply timed there, the manufactured u = ln r at levels 3-5, and
    the surrogate's error at level 4, degrees 1-3."""
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.geometry.maps import RadialMap
    from hyteg_tpu_torch.mesh.meshinfo import mesh_annulus
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.p1_blended import P1BlendedOperator
    from hyteg_tpu_torch.primitives.storage import CellStorage

    storage = CellStorage(mesh_annulus(*BLEND_ANNULUS))
    rmin, rmax = BLEND_ANNULUS[:2]
    gen = torch.Generator(device=device).manual_seed(150)
    sp = P1Space(storage, BLEND_LEVEL_2D, device=device)
    out = {"mesh": f"mesh_annulus{BLEND_ANNULUS}", "level": BLEND_LEVEL_2D,
           "global_dofs": sp.num_global_dofs(),
           "block": list(sp.block_shape)}
    op = P1BlendedOperator(sp, forms.laplace_form, RadialMap())
    out["rims"] = rim_deviation(sp, op.comps, (rmin, rmax))
    out["area"] = blended_measure(sp, RadialMap(),
                                  math.pi * (rmax ** 2 - rmin ** 2))
    x = consistent_randn(sp, gen)
    out.update(blended_apply_timing(sp, op, x, "blended_laplace_apply"))
    del op, x
    torch.cuda.empty_cache()
    man = [blend_manufactured(storage, lv, device, torch.log)
           for lv in BLEND_ERR_LEVELS_2D]
    out["manufactured"] = man
    out["l2_error_drop"] = man[1]["l2_error"] / man[2]["l2_error"]
    check(man[0]["l2_error"] < BLEND_L2_MAX,
          f"blended annulus L2 error {man[0]['l2_error']} >= {BLEND_L2_MAX}"
          f" at level {man[0]['level']}")
    check(out["l2_error_drop"] >= BLEND_DROP_MIN,
          f"blended annulus L2 error dropped {out['l2_error_drop']}x from "
          f"level {man[1]['level']} to {man[2]['level']}")
    sp = P1Space(storage, SURROGATE_LEVEL_2D, device=device)
    exact = P1BlendedOperator(sp, forms.laplace_form, RadialMap())
    sur = surrogate_rows(sp, exact, consistent_randn(sp, gen),
                         SURROGATE_DEGREES, timed=False)
    out["surrogate"] = {"level": SURROGATE_LEVEL_2D, "rows": sur}
    errs = [r["error"] for r in sur]
    check(all(a > b for a, b in zip(errs, errs[1:])),
          f"surrogate errors do not fall with the degree: {errs}")
    check(errs[-1] < SURROGATE_MAX, f"surrogate degree 3 error {errs[-1]}")
    return out


def blend_shell(device) -> dict:
    """The icosahedral shell mesh_spherical_shell(2, 2, 0.55, 1)
    (IcosahedralShellMap) at P1 level 5 (10,649,730 DoFs): the blended
    apply on the identity map against the affine apply (kernel B2), rims,
    volume (against the affine mass, B2), symmetry, the exact blended
    apply timed; the manufactured u = 1/r at levels 3-4; the
    surrogate at degrees 1-3."""
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.geometry.maps import (GeometryMap,
                                               IcosahedralShellMap)
    from hyteg_tpu_torch.mesh.meshinfo import mesh_spherical_shell
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.p1_blended import P1BlendedOperator
    from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
    from hyteg_tpu_torch.primitives.storage import CellStorage

    storage = CellStorage(mesh_spherical_shell(*SHELL))
    rmin, rmax = SHELL[2:]
    gen = torch.Generator(device=device).manual_seed(160)
    sp = P1Space(storage, BLEND_LEVEL_3D, device=device)
    out = {"mesh": f"mesh_spherical_shell{SHELL}", "level": BLEND_LEVEL_3D,
           "global_dofs": sp.num_global_dofs(),
           "block": list(sp.block_shape)}
    x = consistent_randn(sp, gen)
    ya = P1ElementwiseOperator(sp, forms.laplace_form).apply_raw(x)  # B2
    yb = P1BlendedOperator(sp, forms.laplace_form, GeometryMap()).apply_raw(x)
    out["identity_vs_affine"] = max_abs_diff(yb, ya)
    out["identity_vs_affine_scale"] = ya.abs().max().item()
    check(out["identity_vs_affine"] <= IDENTITY_RTOL
          * max(1.0, out["identity_vs_affine_scale"]),
          f"blended apply on the identity map vs affine: "
          f"{out['identity_vs_affine']}")
    del ya, yb
    gmap = IcosahedralShellMap()
    op = P1BlendedOperator(sp, forms.laplace_form, gmap)
    out["rims"] = rim_deviation(sp, op.comps, (rmin, rmax))
    out["volume"] = blended_measure(sp, gmap, 4 * math.pi / 3
                                    * (rmax ** 3 - rmin ** 3))
    out["symmetry"] = symmetric_positive(sp, op.apply_raw, 161,
                                         "blended shell Laplace")
    out.update(blended_apply_timing(sp, op, x, "blended_laplace_apply"))
    out["surrogate"] = {"level": BLEND_LEVEL_3D, "rows": surrogate_rows(
        sp, op, x, SURROGATE_DEGREES, timed=True)}
    del op, x
    torch.cuda.empty_cache()
    man = [blend_manufactured(storage, lv, device, torch.reciprocal)
           for lv in BLEND_ERR_LEVELS_3D]
    out["manufactured"] = man
    out["l2_error_drop"] = man[0]["l2_error"] / man[1]["l2_error"]
    check(out["l2_error_drop"] >= BLEND_DROP_MIN,
          f"blended shell L2 error dropped {out['l2_error_drop']}x from "
          f"level {man[0]['level']} to {man[1]['level']}")
    return out


def blend_stokes(device) -> dict:
    """The blended Stokes path (IcosahedralShellMap, epsilon viscous
    block): tests/test_p2_blended.py's gate on mesh_spherical_shell(1, 2,
    0.55, 1), P2 levels 0-1; the epsilon operator's symmetry there; then
    make_stokes_gmg(..., gmap=...) on the 1920-tet shell at P2 levels 0-3
    with power-iteration eigs, V(2,2), its cycles on A x = 0 from a random
    consistent start (kernel B3 counted: the lumped pressure mass of every
    level's smoother and of the coarse preconditioner, held against its
    plain version on the stack's P1 levels first)."""
    from hyteg_tpu_torch.composites.stokes import TaylorHoodVec
    from hyteg_tpu_torch.core.types import DoFType
    from hyteg_tpu_torch.functions.p2 import P2Space
    from hyteg_tpu_torch.geometry.maps import IcosahedralShellMap
    from hyteg_tpu_torch.kernels import p1_stencil as b3
    from hyteg_tpu_torch.mesh.meshinfo import mesh_spherical_shell
    from hyteg_tpu_torch.operators.p2_blended_stokes import (
        P2BlendedEpsilonOperator)
    from hyteg_tpu_torch.primitives.storage import CellStorage
    from hyteg_tpu_torch.solvers.uzawa import make_stokes_gmg

    gmap = IcosahedralShellMap()
    gen = torch.Generator(device=device).manual_seed(170)
    # the JAX package's gate (tests/test_p2_blended.py:104-132)
    small = CellStorage(mesh_spherical_shell(*BLEND_STOKES_GATE_MESH))
    lo, hi = BLEND_STOKES_GATE_LEVELS
    stack = make_stokes_gmg(small, lo, hi, epsilon=True, gmap=gmap,
                            coarse_iters=BLEND_STOKES_GATE_COARSE_ITERS,
                            eigs={l: BLEND_STOKES_GATE_EIG
                                  for l in range(lo, hi + 1)}, device=device)
    st = stack.stokes[hi]
    vel = torch.randn((st.dim,) + tuple(st.vel_space.block_shape),
                      generator=gen, device=device) * st.vel_space.vertex_mask_t
    b = st.apply_inner(TaylorHoodVec(vel, st.pre_space.zeros()))
    x = st.zeros()
    res = [st.norm(b - st.apply_inner(x)).item()]
    for _ in range(BLEND_STOKES_GATE_CYCLES):
        x = stack.gmg.cycle(x, b)
        res.append(st.norm(b - st.apply_inner(x)).item())
    gate = {"mesh": f"mesh_spherical_shell{BLEND_STOKES_GATE_MESH}",
            "levels": [lo, hi], "residuals": res, "ratio": res[-1] / res[0]}
    check(all(math.isfinite(r) for r in res)
          and res[-1] < BLEND_STOKES_GATE_RATIO * res[0],
          f"blended Stokes gate: r{BLEND_STOKES_GATE_CYCLES} {res[-1]} not "
          f"below {BLEND_STOKES_GATE_RATIO} r0 {res[0]}")
    # the epsilon operator's symmetry and positivity
    # (tests/test_p2_blended.py::test_blended_epsilon_symmetric_on_shell)
    p2 = P2Space(small, hi, device=device)
    K = P2BlendedEpsilonOperator(p2, gmap)
    us, vs = (torch.stack([consistent_randn(p2.node_space, gen)
                           for _ in range(3)]) for _ in range(2))
    Ku, Kv = K.apply_raw(us), K.apply_raw(vs)
    dot = lambda a, c: sum(p2.dot(a[d], c[d], DoFType.ALL).item()
                           for d in range(3))
    s1, s2, quad = dot(Ku, vs), dot(us, Kv), dot(Ku, us)
    sym = {"Ku_v": s1, "u_Kv": s2, "Ku_u": quad,
           "rel": abs(s1 - s2) / max(abs(s1), 1.0)}
    check(abs(s1 - s2) < BLEND_EPS_SYM_RTOL * max(abs(s1), 1.0) and quad > 0,
          f"blended epsilon operator: {sym}")
    emit("blend_stokes_gate", gate=gate, epsilon_symmetry=sym)
    del stack, st, vel, b, x, p2, K, us, vs, Ku, Kv
    torch.cuda.empty_cache()

    # the 1920-tet shell, P2 levels 0-BLEND_STOKES_LEVEL
    shell = CellStorage(mesh_spherical_shell(*SHELL))
    lo, hi = 0, BLEND_STOKES_LEVEL
    pitch = (1 << (hi + 1)) + 1
    out = {"b3_vs_plain": check_b3_stokes_levels(shell, range(lo, hi + 1),
                                                 device, 171, pitch=pitch)}
    b3.p1_diagonal_local.launches = 0  # the main path starts here
    b3.p1_diagonal_local.launches_by_level.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stack = make_stokes_gmg(shell, lo, hi, epsilon=True, gmap=gmap,
                            device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    st = stack.stokes[hi]
    x, b = stokes_rand_vec(st, gen), st.zeros()
    res, cycle_ms = [st.norm(b - st.apply_inner(x)).item()], []
    for _ in range(BLEND_STOKES_CYCLES):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        x = stack.gmg.cycle(x, b)
        ev[1].record()
        res.append(st.norm(b - st.apply_inner(x)).item())
        cycle_ms.append(ev[0].elapsed_time(ev[1]))
    torch.cuda.synchronize()
    launches = {"p1_diagonal_local": b3.p1_diagonal_local.launches}
    rates = [res[i + 1] / res[i] for i in range(BLEND_STOKES_CYCLES)]
    out.update({
        "mesh": f"mesh_spherical_shell{SHELL}", "levels": [lo, hi],
        "global_dofs": st.dim * st.vel_space.num_global_dofs()
        + st.pre_space.num_global_dofs(),
        "vel_block": [st.dim] + list(st.vel_space.block_shape),
        "pre_block": list(st.pre_space.block_shape), "eigs": stack.eigs,
        "setup_s": setup_s, "residuals": res, "rates": rates,
        "each_rate_le_0_2": all(r <= BLEND_RATE_REF for r in rates),
        "cycle_ms": cycle_ms, "ms_per_vcycle": sorted(cycle_ms)[
            len(cycle_ms) // 2], "launches": launches,
        "b3_launches_by_level": dict(sorted(
            b3.p1_diagonal_local.launches_by_level.items())),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    check(all(math.isfinite(r) for r in res),
          f"blended Stokes V-cycle: non-finite residuals {res}")
    check(rates[0] < 1.0, f"blended Stokes: the first cycle's rate {rates[0]}")
    check(launches["p1_diagonal_local"] > 0,
          "p1_diagonal_local was not launched on the blended Stokes path")
    # one V-cycle's time split, and the blocks' times at the finest level
    out["profile"] = cycle_profile(lambda: stack.gmg.cycle(x, b),
                                   out["ms_per_vcycle"], BLEND_GROUPS,
                                   warmup=0)
    # one call each (CUDA events; their device time is the event time
    # within 1%: a call is seconds of work in ~10^4 launches)
    K, B = st.K_eps, st.B
    for name, fn in (("apply_K", lambda: K.apply_local(x.vel)),
                     ("div", lambda: B.apply_div_local(x.vel.unbind(0))),
                     ("grad", lambda: B.apply_gradient_local(x.pre))):
        out[f"{name}_ms"] = median_ms(fn, 1, warmup=0)
    del stack, st, x, b, K, B
    torch.cuda.empty_cache()
    return out


def run_blending(device, card: str) -> dict:
    """The blended-geometry path (BASELINE config 4), phases blend_2d,
    blend_shell and blend_stokes, each with its kernels' counts set to 0
    just before it and read just after: B2-2D on the annulus's affine mass,
    B2 on the shell's identity-map check and affine mass, B3 on the blended
    Stokes set-up. Returns the launches and errors for the kernels line."""
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.kernels import p1_stencil as b3

    t0 = time.perf_counter()
    errs = check_blend_kernels(device)
    emit("blend_kernels", max_abs_err=errs, rtol=B2_RTOL)
    b2.p1_const_apply.launches_2d = 0
    res2 = blend_2d(device)
    launches = {"p1_const_apply_2d": b2.p1_const_apply.launches_2d}
    t1 = time.perf_counter()
    emit("blend_2d", card=card, launches=launches, phase_s=t1 - t0, **res2)
    b2.p1_const_apply.launches = 0
    res3 = blend_shell(device)
    launches["p1_const_apply"] = b2.p1_const_apply.launches
    t2 = time.perf_counter()
    emit("blend_shell", card=card, launches={
        "p1_const_apply": launches["p1_const_apply"]}, phase_s=t2 - t1,
        **res3)
    resS = blend_stokes(device)
    launches.update(resS["launches"])
    emit("blend_stokes", card=card, phase_s=time.perf_counter() - t2, **resS)
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the blended path")
    errs["p1_diagonal_local"] = max(v["max_abs_err"] for v in
                                    resS["b3_vs_plain"].values())
    return {"launches": launches, "errs": errs,
            "phase_s": time.perf_counter() - t0}


def check_terraneo_kernels(device, seed: int, shell_p2: int = TERRANEO_SHELL["level"],
                           shell_p1: int = TERRANEO_STD_LEVEL,
                           annulus_p2: int = TERRANEO_ANNULUS["level"]) -> dict:
    """The kernels of the TerraNeo path against their plain versions at
    the shapes it gives them, on each space's own lane pitch: B5 (Laplace
    and mass) at the shell's P2 level, B3 lumped on its pressure mass, B2
    (Laplace, mass) and B4 (the mass with a nodal coefficient) at
    TransportOperatorStd's P1 level; B5-2D and B3-2D on the annulus.
    Each is also timed there with CUDA events, back to back as the
    kernels line times it, beside its bound for the same work (``ms``,
    ``bound_ms``, ``bound_by``, ``share_of_bound``)."""
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.functions.p2 import P2Space
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.kernels import p1_stencil as b4
    from hyteg_tpu_torch.kernels import p2_const_stencil as b5
    from hyteg_tpu_torch.mesh.meshinfo import mesh_annulus, mesh_spherical_shell
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
    from hyteg_tpu_torch.operators.p2_elementwise import P2ElementwiseOperator
    from hyteg_tpu_torch.primitives.storage import CellStorage

    gen = torch.Generator(device=device).manual_seed(seed)
    shell = CellStorage(mesh_spherical_shell(*SHELL))
    annulus = CellStorage(mesh_annulus(*TERRANEO_ANNULUS_MESH))
    out, errs = {}, {}

    def held(name, tag, y, y_ref, rtol, sp):
        err, scale = max_abs_diff(y, y_ref), y_ref.abs().max().item()
        check(math.isfinite(err) and err <= rtol * scale,
              f"{tag}: max|dy| {err} > {rtol} * {scale}")
        check(not y[:, ~sp.vertex_mask_t.bool()].any().item(),
              f"{tag}: nonzero outside the simplex")
        out[tag] = {"max_abs_err": err, "max_abs": scale,
                    "block": list(y.shape), "pitch": sp.pitch}
        errs[name] = max(errs.get(name, 0.0), err)

    def timed(tag, call, work):
        ms = median_ms(call, 10, batch=10)
        b = bound(*work)
        out[tag].update(ms=ms, bound_ms=b[0], bound_by=b[1],
                        share_of_bound=b[0] / ms)

    for storage, level, name in ((shell, shell_p2, "p2_const_apply"),
                                 (annulus, annulus_p2, "p2_const_apply_2d")):
        sp = P2Space(storage, level, device=device)
        x = torch.randn(sp.block_shape, generator=gen, device=device)
        x *= sp.vertex_mask_t
        for kind in ("laplace", "mass"):
            op = P2ElementwiseOperator(sp, kind)
            args = (op.stencil_folded, level, sp.pitch, sp.dim)
            tag = f"{name}_{kind}_level{level}"
            held(name, tag, b5.p2_const_apply(x, *args),
                 b5.p2_const_apply_torch(x, *args), B5_RTOL, sp)
            timed(tag, lambda: b5.p2_const_apply(x, *args),
                  b5_work(sp, x, args[0], level))
        del x, op
        pname = "p1_diagonal_local" + name[len("p2_const_apply"):]
        pre = P1Space(storage, level, device=device,
                      pitch=(1 << (level + 1)) + 1)
        pm = P1ElementwiseOperator(pre, forms.mass_form)
        args = (pm.elmats, level, pre.dim, pre.pitch, True)
        y = b4.p1_diagonal_local(*args)
        tag = f"{pname}_lumped_mass_level{level}"
        held(pname, tag, y, b4.p1_diagonal_local_torch(*args), B3_RTOL, pre)
        timed(tag, lambda: b4.p1_diagonal_local(*args),
              b3_work(pre, pm.elmats, y))
        torch.cuda.empty_cache()
    sp = P1Space(shell, shell_p1, device=device)
    x = torch.randn(sp.block_shape, generator=gen, device=device)
    x *= sp.vertex_mask_t
    k = coeff_field(sp, device, gen, "random")
    for kind, form in (("laplace", forms.laplace_form),
                       ("mass", forms.mass_form)):
        op = P1ElementwiseOperator(sp, form)
        args = (op.stencil, op.stencil_face, shell_p1, 3, sp.pitch)
        tag = f"p1_const_apply_{kind}_level{shell_p1}"
        held("p1_const_apply", tag, b2.p1_const_apply(x, *args),
             b2.p1_const_apply_torch(x, op.stencil, shell_p1, 3, sp.pitch,
                                     E=op.stencil_face), B2_RTOL, sp)
        timed(tag, lambda: b2.p1_const_apply(x, *args),
              b2_work(sp, x, op.stencil, op.stencil_face))
    args = (x, op.elmats, shell_p1, 3, sp.pitch, k)
    tag = f"p1_apply_local_mass_coeff_level{shell_p1}"
    held("p1_apply_local", tag, b4.p1_apply_local(*args),
         b4.p1_apply_local_torch(*args), B4_RTOL, sp)
    timed(tag, lambda: b4.p1_apply_local(*args), b4_work(sp, x, op.elmats))
    return {"checks": out, "errs": errs}


def convection_gates(sim) -> dict:
    """tests/test_terraneo.py's gates on a simulation's state: T finite within
    [-0.05, 1.05], the radial profile's inner mean above its outer mean,
    max|u| > 0 and ||div u|| < 0.05 max|u| after the Stokes solve; with
    vrms (the app's), T's range and the profile's means."""
    from hyteg_tpu_torch.core.types import DoFType

    st, sp = sim.stokes, sim.T_space
    vmax = max(float(sp.dof_max(v.abs(), DoFType.ALL)) for v in sim.x.vel)
    div = st.pre_space.exchange_add(st.B.apply_div_local(
        sim.x.vel.unbind(0)), st._pre_sd)
    div_norm = math.sqrt(float(st.pre_space.dot(div, div, DoFType.ALL,
                                                st._pre_sd)))
    Tk = sim.T[sp.vertex_mask_t.bool().expand(sim.T.shape)]
    prof = sim.temperature_profile()
    vrms = math.sqrt(max(0.0, sum(float(sp.dot(v, v)) for v in sim.x.vel)
                         / sp.num_global_dofs()))
    lo, hi = TERRANEO_T_RANGE
    g = {"T_min": float(Tk.min()), "T_max": float(Tk.max()),
         "T_finite": bool(torch.isfinite(Tk).all()), "max_abs_u": vmax,
         "vrms": vrms, "div_norm": div_norm,
         "div_over_max_u": div_norm / vmax if vmax > 0 else math.inf,
         "profile_radii": prof.radii.tolist(),
         "profile_mean": prof.mean.tolist()}
    g["gates"] = {
        "T_finite_in_range": g["T_finite"] and lo <= g["T_min"]
        and g["T_max"] <= hi,
        "inner_mean_above_outer": bool(prof.mean[0] > prof.mean[-1]),
        "max_u_positive": vmax > 0,
        "div_below_0_05_max_u": div_norm < TERRANEO_DIV_REL * vmax}
    return g


def stokes_solve_residual(sim, T) -> dict:
    """The simulation's last Stokes solve, made on temperature T, against
    its rhs b, in the norm whose estimate MINRES's phibar is (||v||_P =
    <v, P v>^1/2, P the block-diagonal preconditioner): phibar / ||b||_P
    (the estimate against a zero start), the true residual
    ||b - A x||_P / ||b||_P, and ||b - A x|| / ||b||. The kernels'
    launch counts are left as they were."""
    from hyteg_tpu_torch.core.types import FLAG_INNER
    from hyteg_tpu_torch.kernels import p1_stencil as b34
    from hyteg_tpu_torch.kernels import p2_const_stencil as b5

    counts = [(w, k, getattr(w, k)) for w in (b5.p2_const_apply,
                                              b34.p1_diagonal_local)
              for k in ("launches", "launches_2d")]
    st, mu = sim.stokes, sim.viscosity_field(T)
    b = sim.buoyancy_rhs(T)
    prec = st.block_diag_preconditioner(mu=mu)
    r = b - st.apply_inner(sim.x, FLAG_INNER, mu=mu)

    def norms(v):
        return (math.sqrt(float(st.dot(v, prec(v), FLAG_INNER))),
                math.sqrt(float(st.dot(v, v, FLAG_INNER))))

    (b_p, b_l2), (r_p, r_l2) = norms(b), norms(r)
    for w, k, n in counts:
        setattr(w, k, n)
    return {"minres_phibar_over_b": sim.stokes_residual / b_p,
            "minres_true_residual_over_b": r_p / b_p,
            "minres_true_residual_l2_over_b": r_l2 / b_l2}


def convection_run(params: dict, device, steps: int = TERRANEO_STEPS,
                   profile: bool = True) -> dict:
    """ConvectionSimulation at ``params``: set-up seconds, then ``steps``
    coupled steps, each with dt, the MINRES steps, its final residual
    estimate and the solve's residuals against |b| (stokes_solve_residual),
    the energy CG steps, and the ms of the Stokes solve, MMOC and
    the energy step from the simulation's TimingTree; the gates after the last
    step; peak memory; and, with ``profile``, one more step under
    torch.profiler (its device time against the last unprofiled step's
    wall: the idle share)."""
    from hyteg_tpu_torch.terraneo import ConvectionParameters, ConvectionSimulation

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = ConvectionSimulation(ConvectionParameters(**params), device=device)
    torch.cuda.synchronize()
    out = {"params": params, "setup_s": time.perf_counter() - t0,
           "T_global_dofs": sim.T_space.num_global_dofs(),
           "stokes_global_dofs": sim.dim * sim.T_space.num_global_dofs()
           + sim.stokes.pre_space.num_global_dofs(),
           "T_block": list(sim.T_space.block_shape), "steps": []}
    nodes = sim.timing.root.children

    def totals():
        e = nodes.get("solveEnergy")
        return (nodes["solveStokes"].total if "solveStokes" in nodes else 0,
                e.children["MMOC"].total if e else 0,
                e.children["energyStep"].total if e else 0)

    peak = 0
    for _ in range(steps):
        before, T_solve = totals(), sim.T.clone()
        t0 = time.perf_counter()
        dt = sim.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ms = [(a - b) * 1e3 for a, b in zip(totals(), before)]
        # the peak of the set-up and the steps, not of the check below
        peak = max(peak, torch.cuda.max_memory_allocated())
        out["steps"].append({
            "dt": dt, "step_ms": wall, "stokes_ms": ms[0], "mmoc_ms": ms[1],
            "energy_ms": ms[2], "minres_iterations": sim.stokes_iterations,
            "minres_residual": sim.stokes_residual,
            **stokes_solve_residual(sim, T_solve),
            "energy_cg_iterations": sim.energy.last_iterations})
        del T_solve
        torch.cuda.reset_peak_memory_stats()
    out.update(convection_gates(sim))
    out["peak_gb"] = peak / 1e9
    out["mmoc_nodes"] = sim.transport._kept.numel()
    if profile:
        out["profile"] = cycle_profile(
            sim.step, out["steps"][-1]["step_ms"],
            {"b5": ("p2_const_apply_kernel", "p2_const_apply_2d_kernel"),
             "b3": ("p1_diag",), "index": ("index", "scatter", "gather"),
             "reduce": ("reduce",)}, warmup=0)
    del sim
    torch.cuda.empty_cache()
    return out


def transport_std_run(device, level: int = TERRANEO_STD_LEVEL) -> dict:
    """TransportOperatorStd.step on the 1920-tet shell at P1 level
    ``level`` with ADIABATIC_HEATING and SHEAR_HEATING on: T the conductive
    profile plus a lateral perturbation, u a rigid rotation about z plus a
    radial part, eta = exp(0.5 - T), C_a = 0.1. Gates: T finite, the
    Dirichlet rows unchanged."""
    from hyteg_tpu_torch.core.types import DoFType
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.mesh.meshinfo import mesh_spherical_shell
    from hyteg_tpu_torch.primitives.storage import CellStorage
    from hyteg_tpu_torch.terraneo.transport_std import TransportOperatorStd

    sp = P1Space(CellStorage(mesh_spherical_shell(*SHELL)), level,
                 device=device)
    rmin, rmax = SHELL[2], SHELL[3]

    def T0(x):
        r = torch.sqrt((x * x).sum(-1))
        base = torch.clamp((rmax - r) / (rmax - rmin), 0.0, 1.0)
        return base + 0.05 * torch.sin(3 * x[..., 0]) * torch.sin(
            math.pi * torch.clamp((r - rmin) / (rmax - rmin), 0.0, 1.0))

    T = sp.interpolate(T0, sp.zeros(), DoFType.ALL)
    vel = torch.stack([sp.interpolate(f, sp.zeros(), DoFType.ALL) for f in (
        lambda x: -x[..., 1] + 0.1 * x[..., 0],
        lambda x: x[..., 0] + 0.1 * x[..., 1],
        lambda x: 0.1 * x[..., 2])])
    eta = torch.exp(0.5 - T) * sp.vertex_mask_t
    op = TransportOperatorStd(sp, kappa=1.0, terms={
        "ADIABATIC_HEATING": True, "SHEAR_HEATING": True})
    op.adiabatic_coeff = torch.full_like(T, 0.1) * sp.vertex_mask_t
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T1 = op.step(T, TERRANEO_STD_DT, vel=vel, eta=eta)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    inner = op._inner_mask(T.dtype).bool()
    dirichlet = ~inner & sp.vertex_mask_t.bool().expand(T.shape)
    out = {"mesh": f"mesh_spherical_shell{SHELL}", "level": level,
           "global_dofs": sp.num_global_dofs(), "block": list(sp.block_shape),
           "dt": TERRANEO_STD_DT, "step_ms": step_ms,
           "cg_iterations": op.last_iterations,
           "T_finite": bool(torch.isfinite(T1).all()),
           "dirichlet_rows": int(dirichlet.sum()),
           "dirichlet_max_change": float((T1 - T)[dirichlet].abs().max()),
           "max_change": float((T1 - T).abs().max())}
    check(out["T_finite"], "TransportOperatorStd: T not finite")
    check(out["dirichlet_max_change"] == 0.0,
          f"TransportOperatorStd: Dirichlet rows moved by "
          f"{out['dirichlet_max_change']}")
    check(out["cg_iterations"] > 0 and out["max_change"] > 0,
          "TransportOperatorStd: the step did nothing")
    return out


def mmoc_run(device, level: int = MMOC_LEVEL) -> dict:
    """tests/test_transport.py's circular flow: a Gaussian blob an
    eighth-turn around the origin on the square mesh_rectangle((-1, -1),
    (1, 1), 2, 2) at P2 level ``level``, MMOC_STEPS RK4 steps; its gates
    (relative L2 error < 0.15, max < 1.15, min > -0.2), the ms per RK4
    step and the points evaluated per second (per kept node, four
    velocity evaluations and one of the field)."""
    from hyteg_tpu_torch.core.types import DoFType
    from hyteg_tpu_torch.mesh.meshinfo import mesh_rectangle
    from hyteg_tpu_torch.primitives.storage import CellStorage
    from hyteg_tpu_torch.transport import MMOCTransport

    storage = CellStorage(mesh_rectangle(lower=(-1.0, -1.0),
                                         upper=(1.0, 1.0), nx=2, ny=2))
    mm = MMOCTransport(storage, level, degree=2, vel_degree=2, device=device)
    sp = mm.space

    def blob(cx, cy, s=0.08):
        return lambda x: torch.exp(-((x[..., 0] - cx) ** 2
                                     + (x[..., 1] - cy) ** 2) / (2 * s * s))

    c = sp.interpolate(blob(0.5, 0.0), sp.zeros(), DoFType.ALL)
    vel = torch.stack([sp.interpolate(lambda x: -x[..., 1], sp.zeros(),
                                      DoFType.ALL),
                       sp.interpolate(lambda x: x[..., 0], sp.zeros(),
                                      DoFType.ALL)])
    theta = math.pi / 4.0
    dt = theta / MMOC_STEPS
    step_ms = []
    for _ in range(MMOC_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        c = mm.step(c, vel, dt, rk=4)
        ev[1].record()
        ev[1].synchronize()
        step_ms.append(ev[0].elapsed_time(ev[1]))
    want = sp.interpolate(blob(0.5 * math.cos(theta), 0.5 * math.sin(theta)),
                          sp.zeros(), DoFType.ALL)
    err = math.sqrt(float(sp.dot(c - want, c - want, DoFType.ALL))
                    / float(sp.dot(want, want, DoFType.ALL)))
    cmax, cmin = float(sp.dof_max(c, DoFType.ALL)), -float(
        sp.dof_max(-c, DoFType.ALL))
    ms = sorted(step_ms)[len(step_ms) // 2]
    nodes = mm._kept.numel()
    out = {"mesh": "mesh_rectangle((-1, -1), (1, 1), 2, 2)", "level": level,
           "global_dofs": sp.num_global_dofs(), "kept_nodes": nodes,
           "steps": MMOC_STEPS, "step_ms": step_ms, "ms_per_rk4_step": ms,
           "points_per_step": 5 * nodes,
           "points_per_s": 5 * nodes / (ms * 1e-3), "rel_l2_error": err,
           "max": cmax, "min": cmin}
    check(err < MMOC_ERR_MAX, f"MMOC circular flow: error {err}")
    check(cmax < MMOC_MAX and cmin > MMOC_MIN,
          f"MMOC circular flow: range [{cmin}, {cmax}]")
    return out


def run_terraneo(device, card: str) -> dict:
    """The TerraNeo path (config 5's application): terraneo_kernels (B5,
    B3, B2, B4 and the 2D B5, B3 against their plain versions at the
    path's shapes), then terraneo_shell, terraneo_annulus,
    terraneo_transport_std and mmoc, each with its kernels' counts set to
    0 just before it and read just after. Returns the launches and errors
    for the kernels line."""
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.kernels import p1_stencil as b34
    from hyteg_tpu_torch.kernels import p2_const_stencil as b5

    t0 = time.perf_counter()
    kc = check_terraneo_kernels(device, 180)
    emit("terraneo_kernels", card=card, **kc["checks"])
    launches = {}
    b5.p2_const_apply.launches = 0
    b34.p1_diagonal_local.launches = 0
    res = convection_run(TERRANEO_SHELL, device)
    launches["p2_const_apply"] = b5.p2_const_apply.launches
    launches["p1_diagonal_local"] = b34.p1_diagonal_local.launches
    res["launches"] = {k: launches[k] for k in ("p2_const_apply",
                                                 "p1_diagonal_local")}
    t1 = time.perf_counter()
    emit("terraneo_shell", card=card, phase_s=t1 - t0,
         mesh=f"mesh_spherical_shell{SHELL}", **res)
    shell_gates = res["gates"]
    b5.p2_const_apply.launches_2d = 0
    b34.p1_diagonal_local.launches_2d = 0
    res = convection_run(TERRANEO_ANNULUS, device)
    launches["p2_const_apply_2d"] = b5.p2_const_apply.launches_2d
    launches["p1_diagonal_local_2d"] = b34.p1_diagonal_local.launches_2d
    res["launches"] = {k: launches[k] for k in ("p2_const_apply_2d",
                                                 "p1_diagonal_local_2d")}
    t2 = time.perf_counter()
    emit("terraneo_annulus", card=card, phase_s=t2 - t1,
         mesh=f"mesh_annulus{TERRANEO_ANNULUS_MESH}", **res)
    annulus_gates = res["gates"]
    b2.p1_const_apply.launches = 0
    b34.p1_apply_local.launches = 0
    res = transport_std_run(device)
    launches["p1_const_apply"] = b2.p1_const_apply.launches
    launches["p1_apply_local"] = b34.p1_apply_local.launches
    res["launches"] = {k: launches[k] for k in ("p1_const_apply",
                                                 "p1_apply_local")}
    t3 = time.perf_counter()
    emit("terraneo_transport_std", card=card, phase_s=t3 - t2, **res)
    res = mmoc_run(device)
    emit("mmoc", card=card, phase_s=time.perf_counter() - t3, **res)
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the TerraNeo path")
    for tag, gates in (("shell", shell_gates), ("annulus", annulus_gates)):
        for gate, ok in gates.items():
            check(ok, f"terraneo_{tag}: gate {gate} missed")
    return {"launches": launches, "errs": kc["errs"],
            "phase_s": time.perf_counter() - t0}


# -- the sharded path (A8) ---------------------------------------------------


def spmd_gather(storage, parts: list, axis: int = 0) -> torch.Tensor:
    """Every shard's blocks -> the one-shard storage's cell order (its
    cells are the mesh's, in order), padding cells dropped."""
    cat = torch.cat(parts, dim=axis)
    valid = torch.as_tensor(storage.cell_valid, device=cat.device)
    cgi = torch.as_tensor(storage.cell_global_index, device=cat.device)
    out = torch.empty_like(cat.narrow(axis, 0, storage.topo.num_cells))
    out.index_copy_(axis, cgi[valid], cat.index_select(
        axis, torch.nonzero(valid)[:, 0]))
    return out


def spmd_split(storage, whole: torch.Tensor, axis: int = 0) -> list:
    """The one-shard layout -> each shard's blocks (padding cells 0)."""
    C = storage.cells_per_shard
    out = []
    for d in range(storage.num_shards):
        cgi = storage.cell_global_index[d * C:(d + 1) * C]
        idx = torch.as_tensor(np.maximum(cgi, 0), device=whole.device)
        blk = whole.index_select(axis, idx)
        pad = np.flatnonzero(cgi < 0)
        if pad.size:
            blk.index_fill_(axis, torch.as_tensor(pad, device=whole.device), 0)
        out.append(blk)
    return out


def spmd_cycle_rel(res: list, ref: list, what: str,
                   noise: float = 0.0) -> list:
    """Each cycle's |r - r_ref| / r_ref. Every cycle is gated:
    |r - r_ref| <= SPMD_CYCLE_REL * r_ref + ``noise``, where ``noise`` is
    the one-shard run's own spread on its f32 round-off plateau, measured
    in the same run (0 for a history that has no plateau)."""
    rel = [abs(a - b) / b for a, b in zip(res, ref)]
    check(all(math.isfinite(r) for r in res), f"{what}: residuals {res}")
    bad = [k for k, (a, b) in enumerate(zip(res, ref))
           if abs(a - b) > SPMD_CYCLE_REL * b + noise]
    check(not bad, f"{what}: cycles {bad}: residuals {res} vs one shard "
          f"{ref}: {rel} (noise {noise})")
    return rel


def spmd_overlap_case(device) -> dict:
    """The overlapped apply where it splits (SPMD_OVERLAP_CASE, 4 SFC
    shards): overlapped, neighbour and all-reduce applies against the
    one-shard apply on a random consistent u, B2 on the interface and
    interior sub-blocks against its plain version, and the overlapped and
    neighbour applies timed."""
    import dataclasses

    from hyteg_tpu_torch.core.types import BoundaryCondition
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.mesh.meshinfo import mesh_unit_cube
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
    from hyteg_tpu_torch.parallel import spmd
    from hyteg_tpu_torch.parallel.comm import LocalGroup
    from hyteg_tpu_torch.primitives.storage import CellStorage

    n, level = SPMD_OVERLAP_CASE
    bc = BoundaryCondition.all_dirichlet()
    storage = CellStorage(mesh_unit_cube(n), num_shards=SPMD_SHARDS,
                          partitioner="sfc")
    ctx = spmd.SpmdContext(storage, LocalGroup(SPMD_SHARDS), bc,
                           device=device)
    sp = ctx.space(level)
    sp1 = P1Space(CellStorage(mesh_unit_cube(n)), level, device=device)
    op1 = P1ElementwiseOperator(sp1, forms.laplace_form)
    gen = torch.Generator(device=device).manual_seed(161)
    u1 = sp1.exchange_rep(torch.randn(
        sp1.block_shape, generator=gen, device=device) * sp1.vertex_mask_t,
        sp1.shard_data(0, bc))
    y1 = op1.apply_raw(u1)
    us = spmd_split(storage, u1)
    ops = ctx.run(lambda g: P1ElementwiseOperator(sp, forms.laplace_form,
                                                  shard=g.rank))
    sds = {"overlapped": lambda g: ctx.sd(g, level),
           "neighbour": lambda g: dataclasses.replace(ctx.sd(g, level),
                                                      ovl=None),
           "all_reduce": lambda g: sp.group_shard_data(g, bc, False)}
    scale = y1.abs().max().item()
    ovl = ctx.run(lambda g: ctx.sd(g, level).ovl)
    out = {"mesh": f"mesh_unit_cube({n})", "level": level,
           "cells_per_shard": storage.cells_per_shard,
           "interface_cells": [ov.K for ov in ovl]}
    for name, sd_of in sds.items():
        run = lambda: ctx.run(lambda g, op, u: op.apply_raw(u, sd=sd_of(g)),
                              ops, us)
        out[f"{name}_rel"] = max_abs_diff(spmd_gather(storage, run()),
                                          y1) / scale
        check(out[f"{name}_rel"] <= SPMD_APPLY_REL,
              f"spmd overlap case: {name} apply {out[name + '_rel']}")
        out[f"{name}_ms"] = median_ms(run, 10)
    out["one_shard_ms"] = median_ms(lambda: op1.apply_raw(u1), 10)
    # B2 on each sub-block of a shard that splits
    r = next(i for i, ov in enumerate(ovl)
             if 0 < ov.K < storage.cells_per_shard)
    ov, op = ovl[r], ops[r]
    for name, cells in (("interface", ov.ifc), ("interior", ov.interior)):
        x_sub = us[r].index_select(0, cells)
        _, A, E = op._tables(cells)
        yk = b2.p1_const_apply(x_sub, A, E, level, 3, sp.pitch)
        yp = b2.p1_const_apply_torch(x_sub, A, level, 3, sp.pitch, E=E)
        err = max_abs_diff(yk, yp)
        out[f"b2_{name}_cells"] = cells.numel()
        out[f"b2_{name}_max_abs_err"] = err
        check(err <= B2_RTOL * yp.abs().max().item(),
              f"B2 on the {name} sub-block: {err}")
    return out


def spmd_p1(device, card: str, ref: dict) -> dict:
    """The sharded P1 path at level 7: SPMD_P1_CYCLES V(3,3) cycles with
    the agglomerated coarse solve on the main path's manufactured problem
    against gmg_solve's history (``ref``) and on A x = 0 against the
    one-shard stack; the overlapped (here unsplit: every cell touches the
    interface), neighbour and all-reduce sharded applies against the
    one-shard apply; spmd_overlap_case; a cycle's profile, launches and
    the exchange's ms."""
    import dataclasses

    from hyteg_tpu_torch.core.types import BoundaryCondition, DoFType, FLAG_INNER
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.kernels import p1_stencil as b3
    from hyteg_tpu_torch.mesh.meshinfo import mesh_unit_cube
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
    from hyteg_tpu_torch.parallel import spmd
    from hyteg_tpu_torch.parallel.comm import LocalGroup
    from hyteg_tpu_torch.primitives.storage import CellStorage
    from hyteg_tpu_torch.solvers.templates import make_p1_gmg

    level, bc = SPMD_P1_LEVEL, BoundaryCondition.all_dirichlet()
    storage = CellStorage(mesh_unit_cube(MESH_N), num_shards=SPMD_SHARDS,
                          partitioner="sfc")
    ctx = spmd.SpmdContext(storage, LocalGroup(SPMD_SHARDS), bc,
                           device=device)
    sol, rhs = exact(3)
    # A x = 0 from a random consistent start (no round-off floor): the
    # one-shard stack's history first, before the sharded path's counts
    one = CellStorage(mesh_unit_cube(MESH_N))
    stack1 = make_p1_gmg(one, min_level=MIN_LEVEL, max_level=level,
                         coarse_iters=COARSE_ITERS, device=device)
    sp1, sd1 = stack1.space(), stack1.sd()
    gen = torch.Generator(device=device).manual_seed(160)
    z1 = sp1.exchange_rep(torch.randn(sp1.block_shape, generator=gen,
                                      device=device) * sp1.vertex_mask_t, sd1)
    z1 = sp1._restore_rows_(z1, None, FLAG_INNER, sd1)
    zs = spmd_split(storage, z1)
    zero1 = sp1.zeros()
    hom1 = [stack1.residual_norm(z1, zero1).item()]
    for _ in range(SPMD_P1_CYCLES):
        z1 = stack1.gmg.cycle(z1, zero1)
        hom1.append(stack1.residual_norm(z1, zero1).item())
    del stack1, z1, zero1
    torch.cuda.empty_cache()

    b2.p1_const_apply.launches = 0  # the sharded path: counts start here
    b3.p1_diagonal_local.launches = 0
    t0 = time.perf_counter()
    vc = spmd.build_spmd_poisson_vcycle(
        ctx, MIN_LEVEL, level, coarse_iters=COARSE_ITERS,
        agglomerate_coarse=True)
    ctx, sp = vc.ctx, vc.ctx.space(level)

    def problem(g, st):
        sd = st.sds[level]
        mass = P1ElementwiseOperator(sp, forms.mass_form, shard=g.rank)
        f = sp.interpolate(rhs, sp.zeros(), DoFType.ALL, sd)
        return (sp.interpolate(sol, sp.zeros(), DoFType.DIRICHLET, sd),
                sp.restore_rows(mass.apply_raw(f, sd=sd), sp.zeros(),
                                FLAG_INNER, sd))

    xb = ctx.run(problem, vc.stacks)
    xs, bs = [p[0] for p in xb], [p[1] for p in xb]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def rnorm(xs, bs):
        return ctx.run(lambda g, st, x, b: st.residual_norm(x, b).item(),
                       vc.stacks, xs, bs)[0]

    res, cycle_ms = [rnorm(xs, bs)], []
    for _ in range(SPMD_P1_CYCLES):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        xs = vc(xs, bs)
        ev[1].record()
        res.append(rnorm(xs, bs))
        cycle_ms.append(ev[0].elapsed_time(ev[1]))
    zeros = [torch.zeros_like(z) for z in zs]
    hom = [rnorm(zs, zeros)]
    for _ in range(SPMD_P1_CYCLES):
        zs = vc(zs, zeros)
        hom.append(rnorm(zs, zeros))
    # read straight after the sharded work: nothing one-shard ran since 0
    launches = {"p1_const_apply": b2.p1_const_apply.launches,
                "p1_diagonal_local": b3.p1_diagonal_local.launches}
    del zs, zeros
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the sharded P1 path")
    # gmg_solve's cycles past those compared sit on its f32 plateau: their
    # spread is the noise of a residual there
    plateau = ref["residuals"][SPMD_P1_CYCLES + 1:]
    noise = max(plateau) - min(plateau)
    ref_res = ref["residuals"][:SPMD_P1_CYCLES + 1]
    rel = spmd_cycle_rel(res, ref_res, "spmd_p1 manufactured", noise)
    hom_rel = spmd_cycle_rel(hom, hom1, "spmd_p1 A x = 0")
    rate = (res[SPMD_P1_CYCLES] / res[0]) ** (1.0 / SPMD_P1_CYCLES)
    check(rate <= RATE_MAX, f"spmd_p1: rate {rate} > {RATE_MAX}")

    # the applies against the one-shard apply, on the same random
    # consistent u (a smooth u makes A u cancel to O(h^2) of its terms,
    # and any order of the interface sums then moves it by 1e-4 of max|y|)
    sp1 = P1Space(one, level, device=device, pitch=sp.pitch)
    op1 = P1ElementwiseOperator(sp1, forms.laplace_form)
    u1 = sp1.exchange_rep(torch.randn(
        sp1.block_shape, generator=gen, device=device) * sp1.vertex_mask_t,
        sp1.shard_data(0, bc))
    y1 = op1.apply_raw(u1)
    us = spmd_split(storage, u1)
    sds = {"overlapped": lambda g, st: st.sds[level],
           "neighbour": lambda g, st: dataclasses.replace(st.sds[level],
                                                          ovl=None),
           "all_reduce": lambda g, st: sp.group_shard_data(g, bc, False)}
    scale = y1.abs().max().item()
    apply_rel = {}
    for name, sd_of in sds.items():
        ys = ctx.run(lambda g, st, u: st.operators[level].apply_raw(
            u, sd=sd_of(g, st)), vc.stacks, us)
        apply_rel[name] = max_abs_diff(spmd_gather(storage, ys), y1) / scale
        check(apply_rel[name] <= SPMD_APPLY_REL,
              f"spmd_p1: {name} apply {apply_rel[name]} > {SPMD_APPLY_REL}")
    K = [st.sds[level].ovl.K for st in vc.stacks]

    # times: a cycle, its profile, launches per cycle, apply and exchange
    ms = sorted(cycle_ms)[len(cycle_ms) // 2]
    prof = cycle_profile(lambda: vc(xs, bs), ms,
                         {"b2": ("p1_const_apply_kernel",),
                          "b3": ("p1_diag_kernel",),
                          "index": ("index", "scatter", "gather"),
                          "reduce": ("reduce",)}, warmup=0)
    b2.p1_const_apply.launches = 0
    b3.p1_diagonal_local.launches = 0
    vc(xs, bs)
    per_cycle = {"p1_const_apply": b2.p1_const_apply.launches,
                 "p1_diagonal_local": b3.p1_diagonal_local.launches}
    # B3 builds the diagonals once, at set-up; a cycle launches B2 only
    check(per_cycle["p1_const_apply"] > 0,
          "p1_const_apply was not launched in a sharded V-cycle")
    # an exchange works in place: each timed call first copies the apply
    # result back in, and the copies alone are timed too
    scratch = [torch.empty_like(u) for u in us]
    y1c, sd1 = torch.empty_like(y1), sp1.shard_data(0, bc)
    times = {
        "apply_sharded_ms": median_ms(lambda: ctx.run(
            lambda g, st, u: st.operators[level].apply_raw(
                u, sd=st.sds[level]), vc.stacks, us), 10),
        "apply_one_shard_ms": median_ms(lambda: op1.apply_raw(u1), 10),
        "exchange_sharded_ms_incl_copy": median_ms(lambda: ctx.run(
            lambda g, st, u, y: sp._exchange_add_(y.copy_(u),
                                                  st.sds[level]),
            vc.stacks, us, scratch), 10),
        "copy_sharded_ms": median_ms(lambda: [
            y.copy_(u) for y, u in zip(scratch, us)], 10),
        "exchange_one_shard_ms_incl_copy": median_ms(
            lambda: sp1._exchange_add_(y1c.copy_(y1), sd1), 10),
        "copy_one_shard_ms": median_ms(lambda: y1c.copy_(y1), 10)}
    return {"mesh": f"mesh_unit_cube({MESH_N})", "level": level,
            "shards": SPMD_SHARDS, "partitioner": "sfc",
            "global_dofs": sp.num_global_dofs(),
            "shard_block": list(sp.block_shape), "interface_cells": K,
            "setup_s": setup_s, "residuals": res,
            "one_shard_residuals": ref_res, "cycle_rel": rel,
            "one_shard_plateau_noise": noise,
            "homogeneous_residuals": hom,
            "homogeneous_one_shard_residuals": hom1,
            "homogeneous_cycle_rel": hom_rel,
            "rate_cycles_1_4": rate, "cycle_ms": cycle_ms,
            "ms_per_vcycle": ms, "one_shard_ms_per_vcycle": ref.get("vcycle_ms"),
            "apply_rel": apply_rel, "overlap": spmd_overlap_case(device),
            "profile": prof,
            "launches_per_vcycle": per_cycle, **times, "launches": launches}


def spmd_stokes(device, card: str, ref: dict) -> dict:
    """The sharded Stokes (Uzawa) V-cycle at 3D P2 level 6: stokes_run's
    start (its seed) split over the shards, SPMD_STOKES_CYCLES cycles on
    A x = 0 against stokes_run's residuals (``ref``)."""
    from hyteg_tpu_torch.composites.stokes import (P2P1TaylorHoodStokes,
                                                   TaylorHoodVec)
    from hyteg_tpu_torch.kernels import p1_stencil as b3
    from hyteg_tpu_torch.kernels import p2_const_stencil as b5
    from hyteg_tpu_torch.mesh.meshinfo import mesh_unit_cube
    from hyteg_tpu_torch.parallel import spmd
    from hyteg_tpu_torch.parallel.comm import LocalGroup
    from hyteg_tpu_torch.primitives.storage import CellStorage

    level = STOKES_LEVEL
    one = CellStorage(mesh_unit_cube(MESH_N))
    st1 = P2P1TaylorHoodStokes(one, level, device=device)
    x1 = stokes_rand_vec(st1, torch.Generator(device=device).manual_seed(
        130 + one.dim))
    del st1
    storage = CellStorage(mesh_unit_cube(MESH_N), num_shards=SPMD_SHARDS,
                          partitioner="sfc")
    ctx = spmd.SpmdContext(storage, LocalGroup(SPMD_SHARDS), device=device)
    b5.p2_const_apply.launches = 0  # the sharded path: counts start here
    b3.p1_diagonal_local.launches = 0
    t0 = time.perf_counter()
    vc = spmd.build_spmd_stokes_vcycle(ctx, STOKES_MIN_LEVEL, level,
                                       eigs=ref["eigs"], **STOKES_KW)
    xs = [TaylorHoodVec(v, p) for v, p in zip(
        spmd_split(storage, x1.vel, axis=1), spmd_split(storage, x1.pre))]
    del x1
    bs = ctx.run(lambda g, stack: stack.stokes[level].zeros(), vc.stacks)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def rnorm(xs):
        return ctx.run(lambda g, stack, x, b: stack.stokes[level].norm(
            b - stack.stokes[level].apply_inner(x)).item(),
            vc.stacks, xs, bs)[0]

    res, cycle_ms = [rnorm(xs)], []
    for _ in range(SPMD_STOKES_CYCLES):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        xs = vc(xs, bs)
        ev[1].record()
        res.append(rnorm(xs))
        cycle_ms.append(ev[0].elapsed_time(ev[1]))
    launches = {"p2_const_apply": b5.p2_const_apply.launches,
                "p1_diagonal_local": b3.p1_diagonal_local.launches}
    ref_res = ref["residuals"][:SPMD_STOKES_CYCLES + 1]
    rel = [abs(a - b) / b for a, b in zip(res, ref_res)]
    check(all(math.isfinite(r) for r in res), f"spmd_stokes: {res}")
    check(max(rel) <= SPMD_CYCLE_REL,  # both diverge alike after cycle 1
          f"spmd_stokes: residuals {res} vs one shard {ref_res}: {rel}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the sharded Stokes path")
    st = vc.stacks[0].stokes[level]
    return {"mesh": f"mesh_unit_cube({MESH_N})", "level": level,
            "shards": SPMD_SHARDS, "global_dofs": ref["global_dofs"],
            "vel_shard_block": [st.dim] + list(st.vel_space.block_shape),
            "setup_s": setup_s, "residuals": res,
            "one_shard_residuals": ref_res, "cycle_rel": rel,
            "cycle_ms": cycle_ms, "one_shard_cycle_ms": ref["cycle_ms"],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches}


def spmd_box(device, card: str, ref: dict) -> dict:
    """The sharded box path at level 9 over SPMD_SHARDS row slabs: the
    manufactured solve of box_solve (V(2,2), BOX_BIG_CYCLES cycles)
    against box_gmg_1e9's recorded residuals (``ref``); B1 on a 3-row
    edge strip against its plain version."""
    from hyteg_tpu_torch.kernels import box_stencil as b1
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.parallel.comm import LocalGroup
    from hyteg_tpu_torch.structured import BoxDomain, BoxStencilOperator
    from hyteg_tpu_torch.structured import spmd as box_spmd

    torch.cuda.reset_peak_memory_stats()
    dom = BoxDomain(BOX_M, BOX_BIG_LEVEL, device=device)
    group = LocalGroup(SPMD_SHARDS)
    b1.box_apply.launches = 0  # the sharded path: counts start here
    t0 = time.perf_counter()
    levels = box_spmd.build_spmd_hierarchy(dom, SPMD_SHARDS,
                                           min_level=BOX_MIN_LEVEL)
    rows = levels[0].rows
    mass = box_spmd.SpmdBoxOperator(BoxStencilOperator(dom, forms.mass_form),
                                    rows)
    xf, yf, zf = dom.coord_factors()

    def rhs(g):
        s, e = rows[g.rank]
        f = (3 * math.pi ** 2 * box_sol(xf[s:e], yf, zf)).contiguous()
        return mass.apply_raw(g, f)

    bs = group.run(rhs)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def solve(g, b):
        r = levels[0].inner_(g, b.clone())
        r0 = torch.sqrt(g.all_reduce(torch.sum(r * r)))
        x, rns = box_spmd.spmd_solve_poisson(g, levels, b,
                                             cycles=BOX_BIG_CYCLES)
        return x, [r0.item()] + rns.tolist()

    t0 = time.perf_counter()
    out = group.run(solve, bs)
    solve_s = time.perf_counter() - t0
    launches = {"box_apply": b1.box_apply.launches}
    res = out[0][1]
    xs = [o[0] for o in out]
    del out
    ref_res = ref["residuals"]
    rel = spmd_cycle_rel(res, ref_res, "spmd_box")
    rate = (res[4] / res[0]) ** 0.25
    check(rate <= BOX_RATE_MAX, f"spmd_box: rate {rate} > {BOX_RATE_MAX}")
    check(launches["box_apply"] > 0, "box_apply was not launched on the "
          "sharded box path")
    eig_same = [l.eig_max for l in levels] == ref["eig_max"]
    check(eig_same, "spmd_box: the slabs' Chebyshev bounds differ")

    # one cycle's time, and B1 on a 3-row strip at a slab edge vs plain
    ms = median_ms(lambda: group.run(
        lambda g, x, b: box_spmd.spmd_vcycle(g, levels, x, b), xs, bs), 3,
        warmup=1)
    s1 = rows[1][0]
    X, Y, Z = dom.dims
    strip = (3 * math.pi ** 2 * box_sol(xf[s1 - 1:s1 + 2], yf, zf)).contiguous()
    w = levels[0].op.op.w_vecs
    yk = b1.box_apply(strip, w, (3, Y, Z))
    yp = b1.box_apply_torch(strip, w, (3, Y, Z))
    strip_err = max_abs_diff(yk, yp)
    check(strip_err <= B1_RTOL * yp.abs().max().item(),
          f"B1 on a 3-row strip: {strip_err}")
    return {"m": list(BOX_M), "level": BOX_BIG_LEVEL, "dofs": dom.num_dofs(),
            "shards": SPMD_SHARDS, "rows": rows, "setup_s": setup_s,
            "solve_s_incl_residual_norms": solve_s, "residuals": res,
            "one_slab_residuals": ref_res, "cycle_rel": rel,
            "rate_cycles_1_4": rate, "ms_per_vcycle": ms,
            "one_slab_ms_per_vcycle": ref["ms_per_vcycle"],
            "b1_strip_max_abs_err": strip_err,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches}


def spmd_by_gid(space, blocks: list) -> torch.Tensor:
    """A one-shard run's field by global DoF id (interface replicas agree:
    any one of them is kept), on the blocks' device."""
    out = torch.zeros(space.num_global_dofs(), dtype=blocks[0].dtype,
                      device=blocks[0].device)
    for d, blk in enumerate(blocks):
        ids = torch.as_tensor(space.global_ids(d), device=blk.device)
        sel = ids >= 0
        out[ids[sel]] = blk[sel]
    return out


def spmd_gid_err(space, blocks: list, want: torch.Tensor) -> float:
    """max |blocks - want| over every shard's copy of every global DoF,
    interface replicas included."""
    err = 0.0
    for d, blk in enumerate(blocks):
        ids = torch.as_tensor(space.global_ids(d), device=blk.device)
        sel = ids >= 0
        err = max(err, (blk[sel] - want[ids[sel]]).abs().max().item())
    return err


def spmd_energy_floor(sim, T0: list, x: list, T: list) -> float:
    """The one-shard energy step's own f32 floor: the largest change of
    its result T (from T0 and the Stokes velocity x) when each cell's mass
    and Laplace stencils move by one ulp, with a fixed random sign per
    cell, as another order of the interface sums moves them."""
    e = sim._energy[0]
    gen = torch.Generator(device=T[0].device).manual_seed(16)
    for op in (e.M, e.A):
        C = op.stencil.shape[0]
        s = 1.0 + 2.0 ** -23 * (2.0 * torch.randint(
            0, 2, (C,), generator=gen, device=T[0].device) - 1.0)
        for w in (op.stencil, op.stencil_face):
            w.mul_(s.view(-1, *[1] * (w.dim() - 1)))
    Tp = sim.ctx.run(lambda g, en, t, xx: sim._energy_step(en, t, xx.vel),
                     sim._energy, T0, x)
    return (Tp[0] - T[0]).abs().max().item()


@contextlib.contextmanager
def deterministic_algorithms():
    """torch.use_deterministic_algorithms(True) inside the block, the
    previous setting after it. On CUDA, index_add_ then adds in a fixed
    order instead of with atomics, so a run's sums over replicas, its
    transfers and its stencil tables have the same bits in every run."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def spmd_convection(device, card: str) -> dict:
    """One sharded convection step on the shell (TERRANEO_SHELL, with
    SPMD_CONV_STOKES_CYCLES Stokes V-cycles), 4 shards against 1 of the
    same code: |T| and |u_i| within SPMD_CONV_REL;
    at every shard's copy of every global node, each velocity component
    within SPMD_CONV_REL of its one-shard max, T within SPMD_CONV_REL of
    max|T| plus the one-shard step's own f32 floor (spmd_energy_floor);
    T finite in TERRANEO_T_RANGE. The one-shard run comes first, outside
    the counts.

    Both runs and the floor run under deterministic_algorithms. With
    atomic sums the per-node T of runs of the same code on an H100 read
    4.2e-5 to 6.0e-5 of max|T| apart, and the floor moved with them: each
    reading was a draw of the sums' order. With fixed-order sums it reads
    9.5e-7 in every run. The one-shard step runs twice, and its T and u
    must have the same bits both times."""
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.kernels import p1_stencil as b3
    from hyteg_tpu_torch.kernels import p2_const_stencil as b5
    from hyteg_tpu_torch.terraneo.params import ConvectionParameters
    from hyteg_tpu_torch.terraneo.spmd_sim import ShardedConvectionSimulation

    counted = (b2.p1_const_apply, b3.p1_diagonal_local, b5.p2_const_apply)
    names = ["T"] + [f"u_{c}" for c in "xyz"[:TERRANEO_SHELL["dim"]]]
    out, launches, want, node_rel = {}, {}, {}, {}
    with deterministic_algorithms():
        for S in (1, SPMD_SHARDS):
            if S == SPMD_SHARDS:
                for w in counted:  # the sharded path: counts start here
                    w.launches = 0
            t0 = time.perf_counter()
            sim = ShardedConvectionSimulation(
                ConvectionParameters(**TERRANEO_SHELL), num_shards=S,
                stokes_cycles=SPMD_CONV_STOKES_CYCLES,
                device=device, partitioner="sfc")
            T0, x = sim.initial_state()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            T, x = sim.step(T0, x)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if S == SPMD_SHARDS:
                launches = {w.__name__: w.launches for w in counted}
            lo = min(t.min().item() for t in T)
            hi = max(t.max().item() for t in T)
            out[S] = {"setup_s": t1 - t0, "step_s": t2 - t1,
                      "observables": sim.observables(T, x), "T_min": lo,
                      "T_max": hi}
            check(all(math.isfinite(v) for v in out[S]["observables"]),
                  f"terraneo_spmd {S} shards: non-finite state")
            check(TERRANEO_T_RANGE[0] <= lo and hi <= TERRANEO_T_RANGE[1],
                  f"terraneo_spmd {S} shards: T in [{lo}, {hi}]")
            fields = {"T": T}
            for c, name in enumerate(names[1:]):
                fields[name] = [xx.vel[c] for xx in x]
            for name, blocks in fields.items():
                if S == 1:
                    nodes = sim.T_sp.num_global_dofs()
                    want[name] = spmd_by_gid(sim.T_sp, blocks)
                    if name == "T":
                        t_max = want[name].abs().max().item()
                else:
                    node_rel[name] = (
                        spmd_gid_err(sim.T_sp, blocks, want[name])
                        / want[name].abs().max().item())
            if S == 1:
                # the same step again: the same bits, or the comparison
                # below would read one draw of the rounding
                T_re, x_re = sim.step(*sim.initial_state())
                same = all(torch.equal(a, b) for a, b in zip(T_re, T)) and \
                    all(torch.equal(a.vel, b.vel) for a, b in zip(x_re, x))
                check(same, "terraneo_spmd: the one-shard step's rerun "
                      "differs")
                del T_re, x_re
                # last: it changes the one-shard operators
                floor = spmd_energy_floor(sim, T0, x, T)
            del sim, T0, T, x, fields
            torch.cuda.empty_cache()
    del want
    rel = [abs(a - b) / abs(b) for a, b in zip(
        out[SPMD_SHARDS]["observables"], out[1]["observables"])]
    check(max(rel) <= SPMD_CONV_REL,
          f"terraneo_spmd: {SPMD_SHARDS} shards vs 1: {rel}")
    floor_rel = floor / t_max
    node_bound = {k: SPMD_CONV_REL + (floor_rel if k == "T" else 0.0)
                  for k in node_rel}
    check(all(node_rel[k] <= node_bound[k] for k in node_rel),
          f"terraneo_spmd: {SPMD_SHARDS} shards vs 1 per node: {node_rel}, "
          f"bounds {node_bound}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the sharded convection "
              "step")
    return {"params": TERRANEO_SHELL, "shards": SPMD_SHARDS,
            "stokes_cycles": SPMD_CONV_STOKES_CYCLES,
            "one_shard": out[1], "sharded": out[SPMD_SHARDS],
            "observables": "[|T|, |u_x|, |u_y|, |u_z|] over the blocks",
            "rel": rel, "node_rel": node_rel,
            "one_shard_T_floor_rel": floor_rel, "node_bound": node_bound,
            "T_nodes": nodes, "launches": launches}


def spmd_migration(device, card: str) -> dict:
    """Particles seeded on every shard over the whole cube handed to
    their owner shards by one all_to_all: counts conserved, overflow 0,
    every particle on its owner."""
    from hyteg_tpu_torch.mesh.meshinfo import mesh_unit_cube
    from hyteg_tpu_torch.parallel.comm import LocalGroup
    from hyteg_tpu_torch.primitives.storage import CellStorage
    from hyteg_tpu_torch.transport.migration import migrate
    from hyteg_tpu_torch.transport.particles import (ParticleDomain,
                                                     create_particles)

    storage = CellStorage(mesh_unit_cube(MESH_N), num_shards=SPMD_SHARDS,
                          partitioner="sfc")
    dom = ParticleDomain(storage, level=2, device=device)
    cps, P = storage.cells_per_shard, SPMD_PARTICLES
    rng = np.random.default_rng(16)
    sets = []
    for d in range(SPMD_SHARDS):
        ps = create_particles(rng.uniform(0.05, 0.95, (P, 3)),
                              capacity=2 * P, device=device)
        ps.temperature[:P] = torch.as_tensor(
            rng.standard_normal(P).astype(np.float32), device=device)
        sets.append(ps)
    moved = sum(int((dom.owners(ps)[:P] // cps != d).sum())
                for d, ps in enumerate(sets))
    t0 = time.perf_counter()
    out = LocalGroup(SPMD_SHARDS).run(
        lambda g, ps: migrate(ps, dom.owners(ps) // cps, g, M=P), sets)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    total = sum(int(ps.active.sum()) for ps, _ in out)
    dropped = sum(int(n) for _, n in out)
    misplaced = sum(int((dom.owners(ps)[ps.active] // cps != d).sum())
                    for d, (ps, _) in enumerate(out))
    check(total == SPMD_SHARDS * P, f"migration: {total} particles after, "
          f"{SPMD_SHARDS * P} before")
    check(dropped == 0, f"migration: {dropped} dropped")
    check(misplaced == 0, f"migration: {misplaced} particles off their owner")
    return {"shards": SPMD_SHARDS, "particles_per_shard": P,
            "slots_per_destination": P, "moved": moved, "after": total,
            "dropped": dropped, "misplaced": misplaced,
            "host_ms_incl_owner_lookup": ms}


def _nccl_worker(rank: int, world: int, tmp: str) -> None:
    """One card per process: the sharded exchange and P1 V-cycle over
    NCCL, the results saved for the parent to compare."""
    from hyteg_tpu_torch.mesh.meshinfo import mesh_unit_cube
    from hyteg_tpu_torch.parallel import spmd
    from hyteg_tpu_torch.parallel.comm import DistGroup
    from hyteg_tpu_torch.primitives.storage import CellStorage

    device = torch.device("cuda", rank)
    g = DistGroup(init_method=f"file://{tmp}/rendezvous", rank=rank,
                  world_size=world, backend="nccl", device=device)
    try:
        np.save(f"{tmp}/rank{rank}.npy", spmd_nccl_cycle(
            g, CellStorage(mesh_unit_cube(MESH_N), num_shards=world,
                           partitioner="sfc"), device)[0])
    finally:
        g.close()


def spmd_nccl_cycle(group, storage, device) -> list:
    """Two sharded P1 V-cycles at level 5 from the manufactured solution
    with b = 0: the local shards' blocks (numpy)."""
    from hyteg_tpu_torch.parallel import spmd

    sol, _ = exact(3)
    ctx = spmd.SpmdContext(storage, group, device=device)
    vc = spmd.build_spmd_poisson_vcycle(ctx, MIN_LEVEL, 5,
                                        coarse_iters=COARSE_ITERS,
                                        agglomerate_coarse=True)
    xs = vc.ctx.interpolate(5, sol)
    bs = [torch.zeros_like(x) for x in xs]
    for _ in range(2):
        xs = vc(xs, bs)
    return [x.cpu().numpy() for x in xs]


def spmd_nccl(device, card: str) -> dict:
    """DistGroup over NCCL, one process per card, against the LocalGroup
    on this card: only with >= SPMD_SHARDS cards, else a line saying why
    it did not run. Never counted as passed."""
    import multiprocessing as mp
    import tempfile

    n = torch.cuda.device_count()
    if n < SPMD_SHARDS:
        return {"ran": False, "why": f"torch.cuda.device_count() is {n}: "
                f"NCCL puts one rank on each card, and the run needs "
                f"{SPMD_SHARDS}"}
    from hyteg_tpu_torch.mesh.meshinfo import mesh_unit_cube
    from hyteg_tpu_torch.parallel.comm import LocalGroup
    from hyteg_tpu_torch.primitives.storage import CellStorage

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_nccl_worker, args=(r, SPMD_SHARDS, tmp))
                 for r in range(SPMD_SHARDS)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        check(codes == [0] * SPMD_SHARDS, f"spmd_nccl: exit codes {codes}")
        dist = [np.load(f"{tmp}/rank{r}.npy") for r in range(SPMD_SHARDS)]
    storage = CellStorage(mesh_unit_cube(MESH_N), num_shards=SPMD_SHARDS,
                          partitioner="sfc")
    local = spmd_nccl_cycle(LocalGroup(SPMD_SHARDS), storage, device)
    diff = max(float(np.abs(a - b).max()) for a, b in zip(dist, local))
    scale = max(float(np.abs(b).max()) for b in local)
    check(diff <= SPMD_APPLY_REL * scale, f"spmd_nccl: {diff} of {scale}")
    return {"ran": True, "cards": n, "max_abs_diff": diff, "max_abs": scale}


def run_spmd(device, card: str, p1_ref: dict, stokes_ref: dict,
             box_ref: dict) -> dict:
    """The sharded path (A8) on the one card, SPMD_SHARDS shards of an SFC
    partition in one process: spmd_p1, spmd_stokes, spmd_box,
    terraneo_spmd, migration, then spmd_nccl (several cards only). Each
    phase's kernel counts are set to 0 just before it and read just
    after. Returns the launches for the kernels line."""
    t0 = time.perf_counter()
    launches = {}
    for name, fn, ref in (("spmd_p1", spmd_p1, p1_ref),
                          ("spmd_stokes", spmd_stokes, stokes_ref),
                          ("spmd_box", spmd_box, box_ref)):
        t1 = time.perf_counter()
        res = fn(device, card, ref)
        emit(name, card=card, phase_s=time.perf_counter() - t1, **res)
        for k, n in res["launches"].items():
            launches[k] = launches.get(k, 0) + n
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    res = spmd_convection(device, card)
    emit("terraneo_spmd", card=card, phase_s=time.perf_counter() - t1, **res)
    for k, n in res["launches"].items():
        launches[k] = launches.get(k, 0) + n
    for name, fn in (("migration", spmd_migration), ("spmd_nccl", spmd_nccl)):
        t1 = time.perf_counter()
        res = fn(device, card)
        emit(name, card=card, phase_s=time.perf_counter() - t1, **res)
    return {"launches": launches, "phase_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# A10: mixed precision (B2 and B3 in bf16), colored GS and FAS, N1E1 with
# Hiptmair, DG1 and EG
# ---------------------------------------------------------------------------


def bf16_kernel_check(storage, level: int, device, seed: int,
                      timed: bool = False) -> dict:
    """B2-bf16 and B3-bf16 (3D, pitch 129; or their 2D forms on 2D
    storage) against their plain versions at one level, Laplace and mass:
    each element within one bf16 ulp of the f32 result of the same bf16
    values (bf16_ulp_excess <= 1, B1's rule), and of the plain bf16
    version; 0 outside the simplex and on padding lanes. ``timed``: B2's
    and B3's ms at this level beside their bounds (the f32 rows' bytes
    with the block's bytes halved), Laplace."""
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.kernels import p1_stencil as b3
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator

    sp = P1Space(storage, level, device=device, dtype=torch.bfloat16,
                 pitch=PITCH)
    dim, pitch = sp.dim, sp.pitch
    gen = torch.Generator(device=device).manual_seed(seed)
    outside = ~sp.vertex_mask_t.bool()
    out = {"level": level, "block": list(sp.block_shape)}
    for name, form in (("laplace", forms.laplace_form),
                       ("mass", forms.mass_form)):
        op = P1ElementwiseOperator(sp, form)
        A, E, elm = op.stencil, op.stencil_face, op.elmats
        x = (torch.randn(sp.block_shape, generator=gen, device=device)
             * sp.vertex_mask_t).to(torch.bfloat16)
        y = b2.p1_const_apply(x, A, E, level, dim, pitch)
        exact = b2.p1_const_apply_torch(x.float(), A.float(), level, dim,
                                        pitch, E=E.float())
        plain = b2.p1_const_apply_torch(x, A, level, dim, pitch, E=E)
        scale = exact.abs().max().item()
        ex = bf16_ulp_excess(y, exact, scale)
        ex_plain = bf16_ulp_excess(y, plain, scale)
        check(y.dtype == torch.bfloat16 and ex <= 1.0 and ex_plain <= 1.0,
              f"B2-bf16 {name} level {level}: {ex} / {ex_plain} ulp excess")
        check(not y[:, outside].any().item(),
              f"B2-bf16 {name} level {level}: nonzero outside the tet")
        out[f"b2_bf16_{name}_ulp_excess"] = ex
        out[f"b2_bf16_{name}_max_abs_err"] = max_abs_diff(y, plain)
        if timed and name == "laplace":
            out["b2_bf16_ms"] = median_ms(
                lambda: b2.p1_const_apply(x, A, E, level, dim, pitch), 10,
                batch=10)
            out["b2_bf16_plain_ms"] = median_ms(
                lambda: b2.p1_const_apply_torch(x, A, level, dim, pitch, E=E),
                3, warmup=1)
            out["b2_bf16_bound"] = bound(*b2_work(sp, x, A, E))
            d = b3.p1_diagonal_local(elm, level, dim, pitch)
            out["b3_bf16_ms"] = median_ms(
                lambda: b3.p1_diagonal_local(elm, level, dim, pitch), 10,
                batch=10)
            out["b3_bf16_plain_ms"] = median_ms(
                lambda: b3.p1_diagonal_local_torch(elm, level, dim, pitch), 3,
                warmup=1)
            out["b3_bf16_bound"] = bound(*b3_work(sp, elm, d))
            if dim == 2:  # the grouped conv2d of the f32 row, in bf16
                from hyteg_tpu_torch.indexing import micro

                C = sp.C_loc
                xv = x.view(1, C, sp.N, sp.N)
                kern = conv2d_stencil(A.float().sum(-1),
                                      micro.stencil_directions(2)).to(
                    torch.bfloat16)
                out["b2_bf16_library_ms"] = median_ms(
                    lambda: F.conv2d(xv, kern, padding=1, groups=C), 10,
                    batch=10)
                del xv, kern
            del d
        del x, y, exact, plain
        for lumped in ((False, True) if name == "mass" else (False,)):
            d = b3.p1_diagonal_local(elm, level, dim, pitch, lumped)
            exact = b3.p1_diagonal_local_torch(elm.float(), level, dim, pitch,
                                               lumped)
            plain = b3.p1_diagonal_local_torch(elm, level, dim, pitch, lumped)
            scale = exact.abs().max().item()
            ex = bf16_ulp_excess(d, exact, scale)
            ex_plain = bf16_ulp_excess(d, plain, scale)
            tag = name + ("_lumped" if lumped else "")
            check(d.dtype == torch.bfloat16 and ex <= 1.0 and ex_plain <= 1.0,
                  f"B3-bf16 {tag} level {level}: {ex} / {ex_plain} ulp excess")
            check(not d[:, outside].any().item(),
                  f"B3-bf16 {tag} level {level}: nonzero outside the tet")
            out[f"b3_bf16_{tag}_ulp_excess"] = ex
            out[f"b3_bf16_{tag}_max_abs_err"] = max_abs_diff(d, plain)
    return out


def bf16_p2_kernel_check(storage, level: int, device, seed: int,
                         timed: bool = False) -> dict:
    """B5-bf16 (3D, pitch 129; or B5-2D-bf16 on 2D storage) against its
    plain version at one P2 level on a bf16 operator's W, Laplace and mass:
    each element within one bf16 ulp of the f32 result of the same bf16
    values and of the plain bf16 version (bf16_ulp_excess <= 1); 0 outside
    the simplex and on padding lanes. ``timed``: its ms beside its bound
    (the f32 row's bytes with the block's bytes halved), Laplace."""
    from hyteg_tpu_torch.functions.p2 import P2Space
    from hyteg_tpu_torch.kernels import p2_const_stencil as b5
    from hyteg_tpu_torch.operators.p2_elementwise import P2ElementwiseOperator

    sp = P2Space(storage, level, device=device, dtype=torch.bfloat16,
                 pitch=PITCH)
    gen = torch.Generator(device=device).manual_seed(seed)
    outside = ~sp.vertex_mask_t.bool()
    out = {"level": level, "block": list(sp.block_shape)}
    for kind in ("laplace", "mass"):
        W = P2ElementwiseOperator(sp, kind).stencil_folded
        x = (torch.randn(sp.block_shape, generator=gen, device=device)
             * sp.vertex_mask_t).to(torch.bfloat16)
        args = (W, level, sp.pitch, sp.dim)
        y = b5.p2_const_apply(x, *args)
        exact = b5.p2_const_apply_torch(x.float(), W.float(), level, sp.pitch,
                                        sp.dim)
        plain = b5.p2_const_apply_torch(x, *args)
        scale = exact.abs().max().item()
        ex = bf16_ulp_excess(y, exact, scale)
        ex_plain = bf16_ulp_excess(y, plain, scale)
        tag = f"B5{'-2D' if sp.dim == 2 else ''}-bf16 {kind} level {level}"
        check(y.dtype == torch.bfloat16 and ex <= 1.0 and ex_plain <= 1.0,
              f"{tag}: {ex} / {ex_plain} ulp excess")
        check(not y[:, outside].any().item(),
              f"{tag}: nonzero outside the simplex / padding")
        out[f"b5_bf16_{kind}_ulp_excess"] = ex
        out[f"b5_bf16_{kind}_max_abs_err"] = max_abs_diff(y, plain)
        if timed and kind == "laplace":
            out["b5_bf16_ms"] = median_ms(lambda: b5.p2_const_apply(x, *args),
                                          10, batch=10)
            out["b5_bf16_plain_ms"] = median_ms(
                lambda: b5.p2_const_apply_torch(x, *args), 3, warmup=1)
            out["b5_bf16_bound"] = bound(*b5_work(sp, x, W, level))
        del W, x, y, exact, plain
        torch.cuda.empty_cache()
    return out


def bf16_refusals(storage, device) -> dict:
    """The dtype contract of the kernels with a bf16 form, on the card as
    on the CPU (kernels/p1_const_stencil.py::bf16_weights): with a bf16
    block, f32 weights, element matrices or coefficients are rounded to
    bf16 as the Pallas kernels cast them, so B2, B2-2D, B5 and B5-2D with
    f32 weights, B3 and B3-2D with bf16 element matrices and an f32
    coefficient, and B4 and B4-2D on a bf16 source with f32 element
    matrices and an f32 coefficient give, bit for bit, what bf16 inputs
    give. What no kernel takes raises, and no source is cast: B5 with f64
    weights, B4 with a bf16 coefficient beside an f32 source, B3 with a
    bf16 coefficient beside f32 element matrices."""
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.functions.p2 import P2Space
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.kernels import p1_stencil as b3
    from hyteg_tpu_torch.kernels import p2_const_stencil as b5
    from hyteg_tpu_torch.mesh.meshinfo import mesh_rectangle
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
    from hyteg_tpu_torch.operators.p2_elementwise import P2ElementwiseOperator
    from hyteg_tpu_torch.primitives.storage import CellStorage

    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(330)
    out, calls = {}, {}
    for dim, st in ((3, storage), (2, CellStorage(mesh_rectangle(**RECT_2D)))):
        tag = "" if dim == 3 else "_2d"
        sp = P1Space(st, 3, device=device, dtype=bf16, pitch=9)
        op = P1ElementwiseOperator(sp, forms.laplace_form)
        x = torch.randn(sp.block_shape, generator=gen, device=device).to(bf16)
        k = coeff_field(sp, device, gen, "random")  # f32
        elm = op.elmats
        out[f"b2{tag}_bf16_f32_weights_rounded"] = torch.equal(
            b2.p1_const_apply(x, op.stencil.float(), op.stencil_face.float(),
                              3, dim, sp.pitch),
            b2.p1_const_apply(x, op.stencil, op.stencil_face, 3, dim,
                              sp.pitch))
        out[f"b3{tag}_bf16_f32_coefficient_rounded"] = all(torch.equal(
            b3.p1_diagonal_local(elm, 3, dim, sp.pitch, lumped, k, m),
            b3.p1_diagonal_local(elm, 3, dim, sp.pitch, lumped, k.to(bf16),
                                 m)) for lumped in (False, True)
            for m in ("arithmetic", "harmonic"))
        out[f"b4{tag}_bf16_f32_inputs_rounded"] = all(torch.equal(
            b3.p1_apply_local(x, elm.float(), 3, dim, sp.pitch, kk, m),
            b3.p1_apply_local(x, elm, 3, dim, sp.pitch,
                              None if kk is None else kk.to(bf16), m))
            for kk in (None, k) for m in ("arithmetic", "geometric"))
        sp2 = P2Space(st, 2, device=device, dtype=bf16, pitch=9)
        W = P2ElementwiseOperator(sp2, "laplace").stencil_folded
        x2 = torch.randn(sp2.block_shape, generator=gen, device=device).to(bf16)
        out[f"b5{tag}_bf16_f32_weights_rounded"] = torch.equal(
            b5.p2_const_apply(x2, W.float(), 2, sp2.pitch, dim),
            b5.p2_const_apply(x2, W, 2, sp2.pitch, dim))
        for key in (f"b2{tag}_bf16_f32_weights_rounded",
                    f"b3{tag}_bf16_f32_coefficient_rounded",
                    f"b4{tag}_bf16_f32_inputs_rounded",
                    f"b5{tag}_bf16_f32_weights_rounded"):
            check(out[key], f"{key}: f32 inputs differ from bf16 inputs")
        calls.update({
            f"b3{tag}_f32_elmats_bf16_coefficient": lambda elm=elm, k=k,
            sp=sp, dim=dim: b3.p1_diagonal_local(elm.float(), 3, dim,
                                                 sp.pitch, False, k.to(bf16)),
            f"b4{tag}_f32_source_bf16_coefficient": lambda elm=elm, x=x, k=k,
            sp=sp, dim=dim: b3.p1_apply_local(x.float(), elm.float(), 3, dim,
                                              sp.pitch, k.to(bf16)),
            f"b5{tag}_bf16_with_f64_weights": lambda W=W, x2=x2, sp2=sp2,
            dim=dim: b5.p2_const_apply(x2, W.double(), 2, sp2.pitch, dim)})
    for name, call in calls.items():
        try:
            call()
            out[name] = "ran"
        except ValueError as e:
            out[name] = f"refused: {str(e)[:60]}"
        check(out[name].startswith("refused"), f"{name} was not refused")
    return out


def refine_around_bf16(s32, s16, x0, b, f32_residuals: list, kernels: dict,
                       per_cycle: dict, f32_cycle_ms: float | None = None,
                       gated: bool = True, reps: int = 5) -> dict:
    """The run and gates of a mixed-precision phase: an f32 outer
    iterative_refinement (the f32 stack's residual, its operator's f32
    apply) around one bf16 V(3,3) cycle of ``s16`` per step, MP_OUTER
    steps from x0; the same number of bf16-only outer steps; timings and
    one profiled bf16 cycle. Gates: the bf16 stack's blocks and inverse
    diagonals are bf16; the refined residual within MP_PLATEAU_FACTOR of
    the f32 stack's own plateau (the mean of its phase's last three
    residuals, ``f32_residuals``, read in this run) and below MP_BF16_RATIO
    x the bf16-only one. ``kernels``: profile group -> kernel name
    fragments; ``per_cycle``: name -> (wrapper, count attribute) of the
    bf16 launches counted over one cycle; ``f32_cycle_ms``: the f32 cycle's
    time from its own phase (None: timed here). ``gated`` False (the 2D
    paths at full width, where the scheme does not converge: MP_GATE_2D):
    the residual histories are reported, and only the bf16 types and one
    finite bf16 cycle are gated. ``reps``: the timed runs of each cycle
    and step (after 2 warm-up runs, 1 for the step). Stacks from coeff_stack run with their
    coefficient (its f32 apply in the outer residual)."""
    from hyteg_tpu_torch.core.types import FLAG_INNER
    from hyteg_tpu_torch.solvers.refinement import iterative_refinement

    bf16 = torch.bfloat16
    top = max(s32.spaces)
    sp, sd, sp16 = s32.space(), s32.sd(), s16.space()
    check(sp16.dtype == bf16 and all(
        d.dtype == bf16 for d in s16.inv_diags.values()),
        "the bf16 stack is not bf16")
    op = s32.operators[top]
    k32 = getattr(s32, "coeffs", {}).get(top)  # coeff_stack's, else None
    apply_hi = lambda v: op.apply_inner(v, sd, FLAG_INNER, coeff=k32)
    inner = lambda r: s16.gmg.cycle(sp16.zeros(), r)
    r0 = s32.residual_norm(x0, b).item()
    plateau = sum(f32_residuals[-3:]) / 3  # the flat end of the f32 solve
    x, rel = x0, []
    for _ in range(MP_OUTER):
        x = iterative_refinement(apply_hi, inner, b, x, 1)
        rel.append(s32.residual_norm(x, b).item() / r0)
    b16, x16, rel16 = b.to(bf16), x0.to(bf16), []
    for _ in range(MP_OUTER):
        x16 = x16 + inner(s16.residual(x16, b16))
        check(x16.dtype == bf16, "the bf16-only iterate left bf16")
        rel16.append(s32.residual_norm(x16.float(), b).item() / r0)
    del x16
    if gated:
        check(all(math.isfinite(r) for r in rel + rel16),
              "mixed precision: non-finite residuals")
        check(rel[-1] * r0 <= MP_PLATEAU_FACTOR * plateau,
              f"refined residual {rel[-1] * r0} > {MP_PLATEAU_FACTOR} x the "
              f"f32 plateau {plateau}")
        check(rel[-1] < MP_BF16_RATIO * rel16[-1],
              f"refined rel {rel[-1]} >= {MP_BF16_RATIO} x bf16-only "
              f"{rel16[-1]}")
    x1 = s16.residual(sp16.zeros(), b16)
    y1 = s16.gmg.cycle(sp16.zeros(), x1)
    check(y1.dtype == bf16 and bool(torch.isfinite(y1).all()),
          "the bf16 V-cycle is not bf16 and finite")
    del y1
    cyc16 = lambda: s16.gmg.cycle(sp16.zeros(), x1)
    ms16 = median_ms(cyc16, reps, warmup=2)
    ms32 = (median_ms(lambda: s32.gmg.cycle(x0, b), reps, warmup=2)
            if f32_cycle_ms is None else f32_cycle_ms)
    ms_step = median_ms(lambda: iterative_refinement(apply_hi, inner, b, x0, 1),
                        reps, warmup=1)
    n0 = {k: getattr(w, a) for k, (w, a) in per_cycle.items()}
    cyc16()
    launches = {k: getattr(w, a) - n0[k] for k, (w, a) in per_cycle.items()}
    prof = cycle_profile(cyc16, ms16, kernels)
    return {"level": top, "global_dofs": sp.num_global_dofs(),
            "block": list(sp.block_shape), "outer_steps": MP_OUTER,
            "gated": gated,
            "refined_rel_residuals": rel, "bf16_only_rel_residuals": rel16,
            "f32_plateau_abs": plateau, "r0": r0,
            "refined_over_plateau": rel[-1] * r0 / plateau,
            "refined_over_bf16_only": rel[-1] / rel16[-1],
            "bf16_vcycle_ms": ms16, "f32_vcycle_ms": ms32,
            "refinement_step_ms": ms_step, "bf16_over_f32_cycle": ms16 / ms32,
            "bf16_launches_per_vcycle": launches,
            "bf16_profile": {k: prof[k] for k in (
                "device_ms", "idle_share", "kernels", "device_kernels")}}


def mixed_precision(storage, device, card: str, f32_residuals: list) -> dict:
    """An f32 outer iterative_refinement (B2 f32 residual) around one bf16
    V(3,3) cycle of make_p1_gmg(dtype=bf16) per step (B2-bf16, B3-bf16 at
    set-up, bf16 transfers and Chebyshev) at P1 level 7 on the 48-cell
    cube; the same number of bf16-only outer steps; timings
    (refine_around_bf16's gates). The plateau: the mean of the main path's
    last three level-7 residuals, where they are flat."""
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.kernels import p1_stencil as b3
    from hyteg_tpu_torch.solvers.templates import make_p1_gmg

    kw = dict(min_level=MIN_LEVEL, max_level=MP_LEVEL, smoother="chebyshev",
              coarse_iters=COARSE_ITERS, device=device)
    t0 = time.perf_counter()
    s32 = make_p1_gmg(storage, **kw)
    s16 = make_p1_gmg(storage, dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    x0, b, _ = manufactured(s32)
    out = refine_around_bf16(
        s32, s16, x0, b, f32_residuals,
        {"b2_bf16": ("p1_const_apply_kernel",), "b3": ("p1_diag",)},
        {"b2_bf16": (b2.p1_const_apply, "launches_bf16")})
    launches = {"p1_const_apply_bf16": b2.p1_const_apply.launches_bf16,
                "p1_diagonal_local_bf16": b3.p1_diagonal_local.launches_bf16,
                "p1_const_apply": b2.p1_const_apply.launches
                - b2.p1_const_apply.launches_bf16,
                "p1_diagonal_local": b3.p1_diagonal_local.launches
                - b3.p1_diagonal_local.launches_bf16}
    prof32 = cycle_profile(lambda: s32.gmg.cycle(x0, b), out["f32_vcycle_ms"],
                           {"b2": ("p1_const_apply_kernel",)})
    return {**out, "setup_s_both_stacks": setup_s, "launches": launches,
            "b2_bf16_launches_per_vcycle":
            out["bf16_launches_per_vcycle"]["b2_bf16"],
            "f32_profile": {k: prof32[k] for k in (
                "device_ms", "idle_share", "kernels")}}, (s32, x0, b)


def mixed_precision_on(s32, x0, b, f32_residuals: list, f32_cycle_ms,
                       device, kind: str, gated: bool = True) -> dict:
    """A mixed-precision phase on an f32 stack an earlier phase built and
    solved (reused, not built again): the bf16 stack of the same kind
    (``kind`` "p2": make_p2_gmg(dtype=bf16), its eigenvalue bounds by its
    own bf16 power iteration; "p1": make_p1_gmg(dtype=bf16), on the f32
    stack's storage, 3D or 2D) and levels, then refine_around_bf16 from x0
    on b. Counts the bf16 launches of B5 / B5-2D or B2-2D and B3-2D over
    the phase (the caller sets them to 0 first); the f32 launches of the
    refinement's residual too. Reports set-up s and peak GB."""
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.kernels import p1_stencil as b3
    from hyteg_tpu_torch.kernels import p2_const_stencil as b5
    from hyteg_tpu_torch.solvers.templates import make_p1_gmg, make_p2_gmg

    lo, hi = min(s32.spaces), max(s32.spaces)
    dim = s32.space().dim
    sfx = "" if dim == 3 else "_2d"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if kind == "p2":
        s16 = make_p2_gmg(s32.storage, min_level=lo, max_level=hi,
                          coarse_iters=P2_COARSE_ITERS, device=device,
                          dtype=torch.bfloat16)
        per_cycle = {"p2_const_apply" + sfx + "_bf16": (
            b5.p2_const_apply, "launches" + sfx + "_bf16")}
        kernels = {"b5_bf16": ("p2_const_apply_bf16_kernel",
                               "p2_const_apply_2d_bf16_kernel")}
    else:
        s16 = make_p1_gmg(s32.storage, min_level=lo, max_level=hi,
                          smoother="chebyshev", coarse_iters=COARSE_ITERS,
                          device=device, dtype=torch.bfloat16)
        per_cycle = {"p1_const_apply" + sfx + "_bf16": (
            b2.p1_const_apply, "launches" + sfx + "_bf16")}
        kernels = {"b2_bf16": ("p1_const_apply_kernel",
                               "p1_const_apply_2d_bf16_kernel"),
                   "b3_bf16": ("p1_diag",)}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    out = refine_around_bf16(s32, s16, x0, b, f32_residuals, kernels,
                             per_cycle, f32_cycle_ms, gated)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["setup_s_bf16_stack"] = setup_s
    out["eigs_bf16"] = s16.eigs
    counts = {"p2_const_apply" + sfx + "_bf16":
              getattr(b5.p2_const_apply, "launches" + sfx + "_bf16"),
              "p1_const_apply" + sfx + "_bf16":
              getattr(b2.p1_const_apply, "launches" + sfx + "_bf16"),
              "p1_diagonal_local" + sfx + "_bf16":
              getattr(b3.p1_diagonal_local, "launches" + sfx + "_bf16")}
    f32 = {"p2_const_apply" + sfx: getattr(b5.p2_const_apply, "launches" + sfx)
           - counts["p2_const_apply" + sfx + "_bf16"],
           "p1_const_apply" + sfx: getattr(b2.p1_const_apply, "launches" + sfx)
           - counts["p1_const_apply" + sfx + "_bf16"],
           "p1_diagonal_local" + sfx:
           getattr(b3.p1_diagonal_local, "launches" + sfx)
           - counts["p1_diagonal_local" + sfx + "_bf16"]}
    out["launches"] = {k: v for k, v in counts.items() if v}
    out["f32_launches"] = {k: v for k, v in f32.items() if v}
    del s16
    torch.cuda.empty_cache()
    return out


def mixed_precision_2d_gate(rect, device, kind: str) -> dict:
    """The gated 2D mixed-precision run at MP_GATE_2D[kind], the largest
    level of the rect stack where the scheme reaches the f32 plateau in
    MP_OUTER steps: the f32 stack (2D P1: the manufactured problem from
    its Dirichlet start; 2D P2: a seeded consistent rhs from 0) solved by
    P2_CYCLES_2D V-cycles to its plateau, then mixed_precision_on."""
    level = MP_GATE_2D[kind]
    if kind == "p1":
        res, s32, (_, b) = solve(rect, level, device, gate_rate=False)
        x0 = manufactured(s32)[0]
    else:
        res, s32, (_, b) = p2_gmg(rect, device, level=level,
                                  cycles=P2_CYCLES_2D, floor_rel=1.0)
        x0 = torch.zeros_like(b)
    out = mixed_precision_on(s32, x0, b, res["residuals"], None, device, kind)
    del s32, x0, b
    torch.cuda.empty_cache()
    return out


def zero_counts(wrappers=None) -> None:
    """Every launch count (f32 and bf16, 3D and 2D) of ``wrappers`` to 0,
    before a mixed-precision path; by default those of the constant-
    coefficient kernels with a bf16 form (B2, B3, B5)."""
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.kernels import p1_stencil as b3
    from hyteg_tpu_torch.kernels import p2_const_stencil as b5

    for w in wrappers or (b2.p1_const_apply, b3.p1_diagonal_local,
                          b5.p2_const_apply):
        for a in ("launches", "launches_bf16", "launches_2d",
                  "launches_2d_bf16"):
            setattr(w, a, 0)


def colored_gs_smoother(stack, level: int, sweeps: int = 1):
    """A FlexibleMultigridSolver smoother: ``sweeps`` symmetric colored
    GS sweeps (2 x 8 masked residual updates each) on the stack's level."""
    from hyteg_tpu_torch.core.types import FLAG_INNER
    from hyteg_tpu_torch.solvers.colored_gs import symmetric_colored_gs_smooth

    sp, sd = stack.spaces[level], stack.sds[level]
    op, inv = stack.operators[level], stack.inv_diags[level]
    apply_fn = lambda v: op.apply_inner(v, sd, FLAG_INNER)

    def smooth(x, b):
        xn = symmetric_colored_gs_smooth(apply_fn, inv, b, x, level, sp.dim,
                                         num_sweeps=sweeps, pitch=sp.pitch)
        return sp._restore_rows_(xn, x, FLAG_INNER, sd)

    return smooth


def fas_solver(stack):
    """FASSolver over a P1 GMG stack's parts: its smoothers, restriction,
    injection, prolongation and coarse solve (the linear operator)."""
    from hyteg_tpu_torch.core.types import FLAG_INNER
    from hyteg_tpu_torch.solvers.fas import FASLevel, FASSolver

    g = stack.gmg
    levels = {}
    for l, L in g.levels.items():
        sp, sd = stack.spaces[l], stack.sds[l]
        tr = stack.transfers.get(l)
        levels[l] = FASLevel(
            apply=L.apply, smooth=L.smooth, restrict=L.restrict,
            restrict_inj=(lambda x, tr=tr, l=l: stack.spaces[l - 1].restore_rows(
                tr.restrict_injection(x), stack.spaces[l - 1].zeros(),
                FLAG_INNER, stack.sds[l - 1])) if tr is not None else None,
            prolongate=(lambda xc, tr=tr, sp=sp, sd=sd: sp._restore_rows_(
                tr.prolongate(xc), None, FLAG_INNER, sd))
            if tr is not None else None,
            zeros=L.zeros)
    return FASSolver(levels, g.coarse_solve, g.min_level, g.max_level,
                     g.pre, g.post)


def homogeneous_start(stack, device, seed: int):
    """A seeded random x0 (replicas consistent, 0 on Dirichlet rows) and
    b = 0, as homogeneous_rates starts."""
    sp = stack.space()
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(sp.block_shape, generator=gen, device=device)
    x = stack.residual(torch.zeros_like(x),
                       sp.exchange_rep(x * sp.vertex_mask_t))
    return x, torch.zeros_like(x)


def solvers_extra(stack, device, card: str) -> dict:
    """Colored GS as the finest level's smoother of a V-cycle under
    FlexibleMultigridSolver (XTRA_GS_SWEEPS symmetric sweeps before and
    after, the stack's Chebyshev below), and FAS on the linear problem, against the
    stack's V-cycle, on A x = 0 from a random start at P1 level 7. Gates:
    each cycle's rate <= RATE_MAX; FAS within FAS_REL of the linear
    V-cycle's residual after each cycle."""
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.solvers.gmg import FlexibleMultigridSolver

    L, g = stack.gmg.max_level, stack.gmg
    gs = colored_gs_smoother(stack, L, sweeps=XTRA_GS_SWEEPS)
    flex = FlexibleMultigridSolver(g.levels, g.coarse_solve, g.min_level, L,
                                   pre_lists={L: [gs]}, post_lists={L: [gs]})
    fas = fas_solver(stack)
    out = {"level": L}
    x0, b = homogeneous_start(stack, device, 171)
    hist = {}
    solvers = (("flexible_colored_gs", flex), ("fas", fas),
               ("linear_vcycle", g))
    for name, s in solvers:
        x, res = x0, [stack.residual_norm(x0, b).item()]
        for _ in range(XTRA_CYCLES):
            x = s.cycle(x, b)
            res.append(stack.residual_norm(x, b).item())
        rates = [res[i + 1] / res[i] for i in range(XTRA_CYCLES)]
        check(all(math.isfinite(r) for r in res), f"{name}: non-finite")
        check(max(rates) <= RATE_MAX,
              f"{name}: a cycle's rate {max(rates)} > {RATE_MAX}")
        hist[name] = res
        out[name] = {"residuals": res, "rates": rates}
    out["launches"] = {"p1_const_apply": b2.p1_const_apply.launches}
    for name, s in solvers:
        out[name]["cycle_ms"] = median_ms(lambda s=s: s.cycle(x0, b), 3,
                                          warmup=1)
    gaps = [abs(a - c) / c for a, c in zip(hist["fas"][1:],
                                           hist["linear_vcycle"][1:])]
    out["fas_vs_linear_rel"] = gaps
    check(max(gaps) <= FAS_REL,
          f"FAS vs the linear V-cycle: {max(gaps)} > {FAS_REL}")
    return out


def n1e1_hierarchy(storage, device, top: int):
    """N1E1 spaces, alpha curl curl + beta id operators, Hiptmair
    smoothers and Whitney transfers at element levels 0..top."""
    from hyteg_tpu_torch.functions.n1e1 import N1E1Space
    from hyteg_tpu_torch.operators.n1e1_ops import N1E1ElementwiseOperator
    from hyteg_tpu_torch.operators.n1e1_transfer import N1E1Transfer
    from hyteg_tpu_torch.solvers.hiptmair import HiptmairSmoother

    sp = {l: N1E1Space(storage, l, device=device) for l in range(top + 1)}
    ops = {l: N1E1ElementwiseOperator(sp[l], N1E1_ALPHA, N1E1_BETA)
           for l in sp}
    sm = {l: HiptmairSmoother(ops[l]) for l in sp}
    tr = {l: N1E1Transfer(sp[l - 1], sp[l]) for l in range(1, top + 1)}
    return sp, ops, sm, tr


def n1e1_cycle(h, x, b, l):
    """tests/test_n1e1_transfer.py's V(2,2) cycle: Hiptmair sweeps,
    N1E1_COARSE_SWEEPS of them on level 0, Whitney transfers, Dirichlet
    rows held at 0 in every correction."""
    from hyteg_tpu_torch.core.types import FLAG_INNER

    sp, ops, sm, tr = h
    inner = lambda k, y: sp[k].node_space._restore_rows_(
        y, None, FLAG_INNER, sp[k].resolve_sd(None))
    if l == 0:
        return sm[0].smooth(x, b, num_sweeps=N1E1_COARSE_SWEEPS)
    x = sm[l].smooth(x, b, num_sweeps=2)
    rc = inner(l - 1, tr[l].restrict(b - inner(l, ops[l].apply_raw(x))))
    ec = n1e1_cycle(h, torch.zeros_like(rc), rc, l - 1)
    x = x + inner(l, tr[l].prolongate(ec))
    return sm[l].smooth(x, b, num_sweeps=2)


def n1e1_phase(device, card: str) -> dict:
    """alpha curl curl + beta id (alpha 1, beta 0.1) on the 48-cell cube,
    element levels 0..6: Hiptmair V(2,2) cycles (the JAX test's, at full
    size) from x = 0 on a seeded consistent rhs at levels 4, 5, 6; curl o
    grad = 0 on a random potential at level 6; timings. Gates: the
    N1E1_CYCLES-cycle mean rate < N1E1_RATE_MAX at each level and rate(6)
    <= max(2.5 rate(4), N1E1_RATE_MAX)."""
    from hyteg_tpu_torch.core.types import FLAG_INNER
    from hyteg_tpu_torch.mesh.meshinfo import mesh_unit_cube
    from hyteg_tpu_torch.operators import n1e1_ops
    from hyteg_tpu_torch.primitives.storage import CellStorage

    storage = CellStorage(mesh_unit_cube(MESH_N))
    top = N1E1_LEVELS[-1]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    h = n1e1_hierarchy(storage, device, top)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    sp, ops, sm, tr = h
    out = {"levels": list(N1E1_LEVELS), "setup_s": setup_s,
           "edge_dofs": {l: sp[l].num_global_dofs() for l in N1E1_LEVELS},
           "node_block": list(sp[top].block_shape),
           "omega_edge": {l: sm[l].omega_e for l in N1E1_LEVELS},
           "omega_vertex": {l: sm[l].omega_v for l in N1E1_LEVELS}}
    rates = {}
    for l in N1E1_LEVELS:
        s = sp[l]
        gen = torch.Generator(device=device).manual_seed(300 + l)
        b = s.node_space.exchange_rep(torch.randn(
            s.block_shape, generator=gen, device=device) * s.edge_mask_t)
        b = s.node_space._restore_rows_(b, None, FLAG_INNER,
                                        s.resolve_sd(None))

        def rn(x):
            r = b - s.node_space._restore_rows_(ops[l].apply_raw(x), None,
                                                FLAG_INNER, s.resolve_sd(None))
            return torch.sqrt(s.dot(r, r)).item()

        x, res = torch.zeros_like(b), [rn(torch.zeros_like(b))]
        for _ in range(N1E1_CYCLES):
            x = n1e1_cycle(h, x, b, l)
            res.append(rn(x))
        rates[l] = (res[-1] / res[0]) ** (1.0 / N1E1_CYCLES)
        out[f"residuals_level{l}"] = res
        check(all(math.isfinite(r) for r in res), f"N1E1 level {l}: non-finite")
        check(rates[l] < N1E1_RATE_MAX,
              f"N1E1 level {l}: mean rate {rates[l]} >= {N1E1_RATE_MAX}")
        if l == top:
            out["cycle_ms"] = median_ms(lambda: n1e1_cycle(h, x, b, l), 3,
                                        warmup=1)
            out["apply_ms"] = median_ms(lambda: ops[l].apply_raw(x), 10)
            out["hiptmair_sweep_ms"] = median_ms(
                lambda: sm[l].smooth(x, b), 5)
            rc = tr[l].restrict(b)
            out["prolongate_ms"] = median_ms(lambda: tr[l].prolongate(rc), 5)
            out["restrict_ms"] = median_ms(lambda: tr[l].restrict(b), 5)
            out["gradient_ms"] = median_ms(lambda: s.gradient_apply(x), 5)
    out["rates"] = rates
    lo = N1E1_LEVELS[0]
    check(rates[top] <= max(2.5 * rates[lo], N1E1_RATE_MAX),
          f"N1E1 rate({top}) {rates[top]} > max(2.5 rate({lo}), "
          f"{N1E1_RATE_MAX})")
    # curl o grad = 0 at the top level, against the terms' own size
    s = sp[top]
    cc = n1e1_ops.N1E1ElementwiseOperator(s, 1.0, 0.0)
    gen = torch.Generator(device=device).manual_seed(310)
    p = s.node_space.exchange_rep(torch.randn(
        s.block_shape, generator=gen, device=device)) * s.vertexnode_mask_t
    gp = s.gradient_apply(p)
    y = cc.apply_raw(gp)
    terms = s.node_space.exchange_add(n1e1_ops.n1e1_apply_local(
        gp.abs(), cc.elmats.abs(), s.level, s.node_space.pitch))
    cg = (y.abs().max() / terms.max()).item()
    check(math.isfinite(cg) and cg <= CURL_GRAD_RTOL,
          f"curl grad = {cg} of the terms > {CURL_GRAD_RTOL}")
    out["curl_grad_rel"] = cg
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def dg_poisson(storage, level: int, device, dtype=torch.float32) -> dict:
    """DG1 SIP Poisson with u = prod x_i (1 - x_i) (tests/test_dg.py's
    cross-macro case) on ``storage`` in ``dtype``: CG to DG_CG_RTOL; the
    mass-weighted L2 error, CG steps and the apply's ms."""
    from hyteg_tpu_torch.functions.dg import DG1Space
    from hyteg_tpu_torch.operators.dg_ops import DG1SIPLaplaceOperator
    from hyteg_tpu_torch.solvers.krylov import cg_solve

    def U(p):
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        return x * (1 - x) * y * (1 - y) * z * (1 - z)

    def F(p):
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        return 2 * (y * (1 - y) * z * (1 - z) + x * (1 - x) * z * (1 - z)
                    + x * (1 - x) * y * (1 - y))

    t0 = time.perf_counter()
    sp = DG1Space(storage, level, device=device, dtype=dtype)
    op = DG1SIPLaplaceOperator(sp)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b = sp.mass_apply(sp.interpolate(F))
    t0 = time.perf_counter()
    res = cg_solve(op.apply, sp.dot, b, torch.zeros_like(b), DG_CG_ITERS,
                   rtol=DG_CG_RTOL)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    e = res.x - sp.interpolate(U)
    err = torch.sqrt(sp.dot(e, sp.mass_apply(e))).item()
    check(math.isfinite(err), f"DG level {level}: non-finite error")
    return {"level": level, "dtype": str(dtype), "dofs": sp.num_global_dofs(),
            "l2_error": err, "cg_steps": res.iterations, "setup_s": setup_s,
            "solve_s": solve_s,
            "cross_facets": int(op.cross_self.numel()),
            "apply_ms": median_ms(lambda: op.apply(b), 5)}, (sp, op)


def eg_poisson(level: int, device) -> dict:
    """EG vector Poisson with the tet bubble (tests/test_eg.py's case) on
    one macro-tet: CG on the interior rows to EG_CG_RTOL; the total L2
    error of u_CG + c psi (degree-2 element quadrature), CG steps, the
    apply's ms."""
    from hyteg_tpu_torch.core.types import (BoundaryCondition, DoFType,
                                            FLAG_INNER)
    from hyteg_tpu_torch.functions.eg import EGFunction, EGSpace
    from hyteg_tpu_torch.mesh.meshinfo import mesh_single_tet
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.eg_ops import EGLaplaceOperator
    from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
    from hyteg_tpu_torch.primitives.storage import CellStorage
    from hyteg_tpu_torch.solvers.krylov import cg_solve

    sp = EGSpace(CellStorage(mesh_single_tet()), level, device=device)
    op = EGLaplaceOperator(sp)
    sd = sp.p1.resolve_sd(BoundaryCondition.all_dirichlet())
    f = lambda p: 2.0 * (p[..., 0] * p[..., 1] + p[..., 1] * p[..., 2]
                         + p[..., 0] * p[..., 2])
    mass = P1ElementwiseOperator(sp.p1, forms.mass_form)
    fh = sp.p1.interpolate(f, sp.p1.zeros(), DoFType.ALL, sd)
    bv = sp.p1.restore_rows(mass.apply_raw(fh), sp.p1.zeros(), FLAG_INNER, sd)
    b = EGFunction((bv,) * 3, sp.p0.zeros(), sp)
    apply_fn = lambda x: op.apply_inner(x, FLAG_INNER)
    t0 = time.perf_counter()
    res = cg_solve(apply_fn, sp.dot, b, sp.zeros(), EG_CG_ITERS,
                   rtol=EG_CG_RTOL)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    err = eg_l2_error(sp, res.x)
    check(math.isfinite(err), f"EG level {level}: non-finite error")
    return {"level": level, "dofs": sp.num_global_dofs(), "l2_error": err,
            "cg_steps": res.iterations, "solve_s": solve_s,
            "apply_ms": median_ms(lambda: op.apply(b), 3, warmup=1)}, sp


def eg_l2_error(sp, x) -> float:
    """|| u_CG + c psi - bubble ||_L2 (all components equal the bubble) by
    the degree-2 simplex rule per element, batched over the elements of
    each class (tests/test_eg.py::_total_l2_error's sum)."""
    from hyteg_tpu_torch.indexing import micro
    from hyteg_tpu_torch.operators import quadrature as q

    dim, n, p1 = sp.dim, sp.p0.n, sp.p1
    pts, w = q.simplex_rule(dim, 2)
    pts, w = np.asarray(pts, dtype=np.float64), np.asarray(w, dtype=np.float64)
    lam = np.concatenate([1 - pts.sum(-1, keepdims=True), pts], -1)
    offs = micro.offsets(dim)
    cv = np.asarray(sp.storage.cell_vertices, dtype=np.float64)[..., :dim]
    grids = [v.double().cpu().reshape(v.shape[0], p1.N, p1.N, p1.pitch)
             .numpy()[..., :p1.N] for v in x.vel]
    enr = x.enr.double().cpu().numpy()
    bub = lambda p: (p[..., 0] * p[..., 1] * p[..., 2]
                     * (1.0 - p[..., 0] - p[..., 1] - p[..., 2]))
    err2 = 0.0
    for c in range(cv.shape[0]):
        v0, J = cv[c, 0], (cv[c, 1:] - cv[c, :1]).T
        vol_e = abs(np.linalg.det(J)) / 6.0 / n ** dim
        for t in range(sp.p0.T):
            B = np.argwhere(sp.p0.base_mask[t])
            verts = v0 + ((B[:, None, :] + offs[t][None]) / n) @ J.T  # (M,nv,3)
            m = verts.mean(axis=1)
            ce = enr[c, t][tuple(B.T)]
            nodal = np.stack([np.stack([grids[d][c][tuple((B + offs[t, a]).T)]
                                        for a in range(dim + 1)], -1)
                              for d in range(dim)], 1)  # (M, dim, nv)
            xq = np.einsum("qa,mad->mqd", lam, verts)
            ucg = np.einsum("qa,mda->mqd", lam, nodal)
            utot = ucg + ce[:, None, None] * (xq - m[:, None, :])
            diff = utot - bub(xq)[..., None]
            err2 += vol_e * float(np.einsum("q,mqd->", w, diff ** 2))
    return float(np.sqrt(err2))


def dg_eg_phase(device, card: str) -> dict:
    """DG1 SIP Poisson on the 48-cell cube and EG Poisson on one macro-tet
    (the EG operator takes one macro-cell in both packages), manufactured
    solves at two levels each; the SIP and EG-P0 Stokes operators'
    symmetry and the EG div adjoint at the finer level. DG runs in float64
    and in float32 (the packages' default): the order is gated on the
    float64 solves, because the float32 CG stops at an algebraic error of
    the size of the discretization error (at level 5, PERF.md section 7);
    each float32 error is gated within DG_F32_FACTOR of the float64 one at
    its level.
    Gates: the error drops >= DG_DROP_MIN / EG_DROP_MIN x; symmetry (SIP
    in both types) and adjoint within A10_SYM_RTOL."""
    from hyteg_tpu_torch.core.types import FLAG_INNER
    from hyteg_tpu_torch.functions.eg import EGFunction
    from hyteg_tpu_torch.mesh.meshinfo import mesh_unit_cube
    from hyteg_tpu_torch.operators.eg_stokes import (EGP0StokesFunction,
                                                     EGP0StokesOperator)
    from hyteg_tpu_torch.primitives.storage import CellStorage

    storage = CellStorage(mesh_unit_cube(MESH_N))
    gen = torch.Generator(device=device).manual_seed(320)
    out = {"dg": [], "dg_f32": [], "eg": []}
    for key, dtype in (("dg", torch.float64), ("dg_f32", torch.float32)):
        for lv in DG_LEVELS:
            r, (sp, op) = dg_poisson(storage, lv, device, dtype)
            out[key].append(r)
            emit("dg_poisson", card=card, **r)
        wv = sp.valid_weight_t[..., None]
        v, w = (torch.randn(sp.block_shape, generator=gen, device=device,
                            dtype=dtype) * wv for _ in range(2))
        s1, s2 = sp.dot(w, op.apply(v)).item(), sp.dot(v, op.apply(w)).item()
        out[f"{key}_symmetry_rel"] = abs(s1 - s2) / abs(s1)
        check(out[f"{key}_symmetry_rel"] <= A10_SYM_RTOL,
              f"SIP {dtype} symmetry {out[f'{key}_symmetry_rel']} > "
              f"{A10_SYM_RTOL}")
        del sp, op, v, w
        torch.cuda.empty_cache()
    drop = out["dg"][0]["l2_error"] / out["dg"][1]["l2_error"]
    out["dg_error_drop"] = drop
    check(drop >= DG_DROP_MIN, f"DG error drop {drop} < {DG_DROP_MIN}")
    out["dg_f32_error_drop"] = (out["dg_f32"][0]["l2_error"]
                                / out["dg_f32"][1]["l2_error"])
    out["dg_f32_over_f64"] = [r32["l2_error"] / r64["l2_error"]
                              for r32, r64 in zip(out["dg_f32"], out["dg"])]
    for lv, q in zip(DG_LEVELS, out["dg_f32_over_f64"]):
        check(q <= DG_F32_FACTOR, f"DG level {lv}: the float32 error is "
              f"{q} x the float64 one > {DG_F32_FACTOR}")
    for lv in EG_LEVELS:
        r, esp = eg_poisson(lv, device)
        out["eg"].append(r)
        emit("eg_poisson", card=card, **r)
    drop = out["eg"][0]["l2_error"] / out["eg"][1]["l2_error"]
    out["eg_error_drop"] = drop
    check(drop >= EG_DROP_MIN, f"EG error drop {drop} < {EG_DROP_MIN}")
    st = EGP0StokesOperator(esp, form="epsilon")

    def rand():
        vel = tuple(esp.p1._restore_rows_(esp.p1.exchange_rep(
            torch.randn(esp.p1.block_shape, generator=gen, device=device)
            * esp.p1.vertex_mask_t), None, FLAG_INNER,
            esp.p1.resolve_sd(None)) for _ in range(3))
        return EGFunction(vel, p0(), esp)

    def p0():
        return torch.randn(esp.p0.block_shape, generator=gen,
                           device=device) * esp.p0.valid_weight_t

    u, v, q = rand(), rand(), p0()
    a, c = EGP0StokesFunction(u, q), EGP0StokesFunction(v, p0())
    s1, s2 = st.dot(st.apply(a), c).item(), st.dot(a, st.apply(c)).item()
    out["eg_stokes_symmetry_rel"] = abs(s1 - s2) / abs(s1)
    lhs = torch.sum(st.apply_div(u) * q).item()
    rhs = esp.dot(u, st.apply_divT(q)).item()
    out["eg_div_adjoint_rel"] = abs(lhs - rhs) / abs(lhs)
    for k in ("eg_stokes_symmetry_rel", "eg_div_adjoint_rel"):
        check(out[k] <= A10_SYM_RTOL, f"{k} {out[k]} > {A10_SYM_RTOL}")
    out["eg_stokes_apply_ms"] = median_ms(lambda: st.apply(a), 3, warmup=1)
    return out


def run_bf16_gmg_kernels(storage, device, card: str) -> dict:
    """bf16_p2_kernels_vs_plain: B5-bf16 at every P2 level of the 3D P2
    stack (1-6, pitch 129) and B5-2D-bf16 at every P2 level 1-10 of the
    rect; bf16_2d_kernels_vs_plain: B2-2D-bf16 and B3-2D-bf16 (plain and,
    on the mass, lumped) at every P1 level 2-11 of the rect; Laplace and
    mass, each element within one bf16 ulp, each kernel timed at its
    path's level. Returns the kernels line's rows: ms, plain ms, bounds,
    library ms, errors, ulp excess."""
    from hyteg_tpu_torch.mesh.meshinfo import mesh_rectangle
    from hyteg_tpu_torch.primitives.storage import CellStorage

    t0 = time.perf_counter()
    rect = CellStorage(mesh_rectangle(**RECT_2D))
    p2 = {3: [], 2: []}
    for dim, st, top in ((3, storage, P2_LEVEL), (2, rect, P2_LEVEL_2D)):
        for lv in range(1, top + 1):
            p2[dim].append(bf16_p2_kernel_check(st, lv, device, 600 + lv,
                                                timed=lv == top))
            emit("bf16_p2_kernels_vs_plain", card=card, dim=dim, **p2[dim][-1])
    p1 = []
    for lv in range(MIN_LEVEL, LEVEL_2D + 1):
        p1.append(bf16_kernel_check(rect, lv, device, 640 + lv,
                                    timed=lv == LEVEL_2D))
        emit("bf16_2d_kernels_vs_plain", card=card, **p1[-1])
    rows = {}
    for name, checks, tag in (("p2_const_apply_bf16", p2[3], "b5"),
                              ("p2_const_apply_2d_bf16", p2[2], "b5"),
                              ("p1_const_apply_2d_bf16", p1, "b2"),
                              ("p1_diagonal_local_2d_bf16", p1, "b3")):
        top = checks[-1]
        rows[name] = {
            "ms": top[f"{tag}_bf16_ms"], "plain_ms": top[f"{tag}_bf16_plain_ms"],
            "bound": top[f"{tag}_bf16_bound"],
            "library_ms": top.get(f"{tag}_bf16_library_ms"),
            "level": top["level"],
            "max_abs_err": max(v for c in checks for k, v in c.items()
                               if k.startswith(f"{tag}_bf16_")
                               and k.endswith("_max_abs_err")),
            "ulp_excess": max(v for c in checks for k, v in c.items()
                              if k.startswith(f"{tag}_bf16_")
                              and k.endswith("_ulp_excess"))}
    emit("bf16_gmg_kernel_timings", card=card, phase_s=time.perf_counter() - t0,
         **{k: {kk: v[kk] for kk in ("level", "ms", "plain_ms", "library_ms",
                                      "ulp_excess")}
            | {"bound_ms": v["bound"][0],
               "share_of_bound": v["bound"][0] / v["ms"]}
            for k, v in rows.items()})
    return rows


# ---------------------------------------------------------------------------
# The bf16 variable-coefficient P1 path (B4 and B3 with a coefficient in
# bf16, 3D and 2D): an f32 refinement around one bf16 V(3,3) cycle of
# -div(k grad u) = f
# ---------------------------------------------------------------------------


def linear_coeff(p):
    """k = 1 + x + 0.5 y (the JAX package's tests/test_operator.py:189)."""
    return 1.0 + p[..., 0] + 0.5 * p[..., 1]


def coeff_stack(stack, k, eigs: dict | None = None,
                coarse_iters: int = COARSE_ITERS, cheb_order: int = 4):
    """A V-cycle for -div(k grad u) = f from a make_p1_gmg stack's public
    pieces: its spaces, operators, shard data and levels' transfers
    (restrict, prolongate_add), dots and zeros; each level's apply and
    residual take k_l, ``k`` (a callable of coordinates) interpolated at
    level l's nodes in f32 and, on a bf16 stack, rounded to bf16 once
    (kernel B4 in the stack's type); Chebyshev of ``cheb_order`` on the
    inverse diagonal with k_l (kernel B3 with a coefficient); the coarse
    solve CG (``coarse_iters`` steps) on the coefficient apply; the
    stack's pre / post counts. ``eigs`` (level -> lambda_max(D^-1 A_k)):
    None runs 25 power iterations a level on this stack (a generator
    seeded with the level), as an f32 stack does to give a bf16 one its
    bounds. Returns a copy of the stack with this gmg, inv_diags and eigs,
    its ``coeffs`` (level -> k_l), and ``residual`` taking k_l."""
    import dataclasses

    from hyteg_tpu_torch.core.types import DoFType
    from hyteg_tpu_torch.solvers.gmg import GeometricMultigridSolver
    from hyteg_tpu_torch.solvers.krylov import cg_solve_fixed
    from hyteg_tpu_torch.solvers.smoothers import (chebyshev_smooth,
                                                   estimate_spectral_radius)

    lo, hi, flag, g = min(stack.spaces), max(stack.spaces), stack.flag, \
        stack.gmg
    lrange = range(lo, hi + 1)
    sps, ops, sds = stack.spaces, stack.operators, stack.sds
    coeffs = {l: sps[l].interpolate(k, sps[l].zeros(), DoFType.ALL, sds[l])
              for l in lrange}
    inv = {l: ops[l].inverse_diagonal(coeff=coeffs[l], sd=sds[l])
           for l in lrange}
    applies = {l: (lambda x, l=l: ops[l].apply_inner(x, sds[l], flag,
                                                     coeff=coeffs[l]))
               for l in lrange}
    if eigs is None:
        gen = torch.Generator(device=sps[lo].device)
        eigs = {}
        for l in lrange:
            gen.manual_seed(l)
            eigs[l] = float(estimate_spectral_radius(
                applies[l], inv[l], g.levels[l].dot, sps[l].block_shape,
                num_iter=25, generator=gen, dtype=sps[l].dtype))

    def smooth(x, b, l):
        xn = chebyshev_smooth(applies[l], inv[l], b, x, eigs[l],
                              order=cheb_order)
        return sps[l]._restore_rows_(xn, x, flag, sds[l])

    def residual(x, b, level=None):
        l = hi if level is None else level
        r = ops[l].residual(x, b, coeff=coeffs[l], sd=sds[l])
        return sps[l]._restore_rows_(r, None, flag, sds[l])

    levels = {l: dataclasses.replace(
        g.levels[l], apply=applies[l],
        smooth=lambda x, b, l=l: smooth(x, b, l),
        residual=lambda x, b, l=l: residual(x, b, l)) for l in lrange}
    gmg = GeometricMultigridSolver(
        levels, lambda b, x0: cg_solve_fixed(applies[lo], g.levels[lo].dot,
                                             b, x0, coarse_iters),
        lo, hi, g.pre, g.post)
    out = dataclasses.replace(stack, gmg=gmg, inv_diags=inv, eigs=eigs)
    out.coeffs, out.residual = coeffs, residual
    return out


def bf16_coeff_kernel_check(storage, level: int, device, seed: int,
                            timed: bool = False) -> dict:
    """B4-bf16 and B3-bf16 with a coefficient (3D, pitch 129; or their 2D
    forms on 2D storage) against their plain versions at one level, on a
    bf16 Laplace operator's element matrices (and the mass's, for the
    lumped diagonal) and a seeded bf16 source: B4 without a coefficient and
    in the three means, B3 (plain and lumped) in the three means, each on
    the linear k and a seeded random k in [0.5, 1.5) rounded to bf16. Each
    element within one bf16 ulp of the plain version (bf16_ulp_excess <= 1,
    B1's rule), 0 outside the simplex and on padding lanes. ``timed``:
    each kernel's ms in each mode on the linear k beside its bound (2-byte
    entries), the plain version's ms (arithmetic)."""
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.kernels import p1_stencil as b34
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.averaging import MODES
    from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator

    bf16 = torch.bfloat16
    sp = P1Space(storage, level, device=device, dtype=bf16, pitch=PITCH)
    dim, pitch = sp.dim, sp.pitch
    gen = torch.Generator(device=device).manual_seed(seed)
    outside = ~sp.vertex_mask_t.bool()
    lap = P1ElementwiseOperator(sp, forms.laplace_form).elmats
    mass = P1ElementwiseOperator(sp, forms.mass_form).elmats
    x = (torch.randn(sp.block_shape, generator=gen, device=device)
         * sp.vertex_mask_t).to(bf16)
    ks = {kind: coeff_field(sp, device, gen, kind).to(bf16)
          for kind in ("linear", "random")}
    out = {"level": level, "block": list(sp.block_shape)}
    d = "-2D" if dim == 2 else ""

    def gate(y, plain, what):
        scale = plain.float().abs().max().item()
        ex = bf16_ulp_excess(y, plain, scale)
        check(y.dtype == bf16 and ex <= 1.0,
              f"{what} level {level}: {ex} ulp excess")
        check(not y[:, outside].any().item(),
              f"{what} level {level}: nonzero outside the simplex")
        return ex, max_abs_diff(y, plain)

    cases = [(None, "arithmetic")] + [(kind, m) for kind in ks for m in MODES]
    for kind, m in cases:
        k = None if kind is None else ks[kind]
        tag = "none" if k is None else f"{kind}_{m}"
        y = b34.p1_apply_local(x, lap, level, dim, pitch, k, m)
        plain = b34.p1_apply_local_torch(x, lap, level, dim, pitch, k, m)
        ex, err = gate(y, plain, f"B4{d}-bf16 {tag}")
        out[f"b4_bf16_{tag}_ulp_excess"] = ex
        out[f"b4_bf16_{tag}_max_abs_err"] = err
        del y, plain
    for name, elm, lumped in (("laplace", lap, False), ("mass_lumped", mass,
                                                       True)):
        for kind, m in cases[1:]:
            tag = f"{name}_{kind}_{m}"
            y = b34.p1_diagonal_local(elm, level, dim, pitch, lumped,
                                      ks[kind], m)
            plain = b34.p1_diagonal_local_torch(elm, level, dim, pitch,
                                                lumped, ks[kind], m)
            ex, err = gate(y, plain, f"B3{d}-bf16 {tag}")
            out[f"b3c_bf16_{tag}_ulp_excess"] = ex
            out[f"b3c_bf16_{tag}_max_abs_err"] = err
            del y, plain
    if timed:
        k = ks["linear"]
        out["b4_bf16_ms_by_mode"] = {"none": median_ms(
            lambda: b34.p1_apply_local(x, lap, level, dim, pitch), 10,
            batch=10)} | {m: median_ms(
                lambda m=m: b34.p1_apply_local(x, lap, level, dim, pitch, k,
                                               m), 10, batch=10)
                for m in MODES}
        out["b4_bf16_ms"] = out["b4_bf16_ms_by_mode"]["arithmetic"]
        out["b4_bf16_plain_ms"] = median_ms(
            lambda: b34.p1_apply_local_torch(x, lap, level, dim, pitch, k), 3,
            warmup=1)
        out["b4_bf16_bound"] = bound(*b4_work(sp, x, lap))
        out["b3c_bf16_ms_by_mode"] = {m: median_ms(
            lambda m=m: b34.p1_diagonal_local(lap, level, dim, pitch, False,
                                              k, m), 10, batch=10)
            for m in MODES}
        out["b3c_bf16_ms"] = out["b3c_bf16_ms_by_mode"]["arithmetic"]
        out["b3c_bf16_plain_ms"] = median_ms(
            lambda: b34.p1_diagonal_local_torch(lap, level, dim, pitch, False,
                                                k), 3, warmup=1)
        out["b3c_bf16_bound"] = bound(*b3_coeff_work(sp, lap, x))
    del x, ks, lap, mass
    torch.cuda.empty_cache()
    return out


def mixed_precision_coeff(storage, device, level: int,
                          gated: bool = True) -> dict:
    """The bf16 variable-coefficient path on ``storage`` (3D or 2D) at P1
    ``level``: make_p1_gmg's f32 and bf16 stacks (MIN_LEVEL up), made
    coefficient stacks by coeff_stack on k = 1 + x + 0.5 y (the bf16 one
    on the f32 one's eigenvalue bounds); the f32 coefficient V(3,3) solve
    of the manufactured problem (MP_COEFF_CYCLES cycles: its plateau, and
    its rate over cycles 1-4, gated at RATE_MAX when ``gated`` in 3D; in
    2D the rates on A x = 0, homogeneous_rates, are gated), then
    refine_around_bf16 (its gates when ``gated``). The counts of B3 and B4
    start at 0 after the two base stacks are built, so they count the
    coefficient set-up and the run. Reports set-up s, peak GB, the launches
    by kernel and the bf16 launches per cycle."""
    from hyteg_tpu_torch.kernels import p1_stencil as b34
    from hyteg_tpu_torch.solvers.templates import make_p1_gmg

    bf16 = torch.bfloat16
    kw = dict(min_level=MIN_LEVEL, max_level=level, smoother="chebyshev",
              coarse_iters=COARSE_ITERS, device=device)
    sfx = "" if storage.dim == 3 else "_2d"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base32 = make_p1_gmg(storage, **kw)
    base16 = make_p1_gmg(storage, dtype=bf16, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    zero_counts((b34.p1_apply_local, b34.p1_diagonal_local))
    s32 = coeff_stack(base32, linear_coeff)
    s16 = coeff_stack(base16, linear_coeff, eigs=s32.eigs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    x0, b, _ = manufactured(s32)
    res, x = [s32.residual_norm(x0, b).item()], x0
    for _ in range(MP_COEFF_CYCLES):
        x = s32.gmg.cycle(x, b)
        res.append(s32.residual_norm(x, b).item())
    del x
    rate = (res[4] / res[0]) ** 0.25
    check(all(math.isfinite(r) for r in res),
          f"coefficient level {level}: non-finite f32 residuals {res}")
    # the rate gated as the main path gates it: in 3D on the manufactured
    # problem, in 2D on A x = 0 (the 2D f32 floor sits near the manufactured
    # residual after a cycle or two)
    hom = (homogeneous_rates(s32, device, 760 + level, RATE_MAX)
           if gated and storage.dim == 2 else None)
    check(not gated or storage.dim == 2 or rate <= RATE_MAX,
          f"coefficient level {level}: f32 residual rate {rate} > {RATE_MAX}")
    out = refine_around_bf16(
        s32, s16, x0, b, res, {"b4_bf16": ("p1_apply_bf16_kernel",
                                           "p1_apply_2d_bf16_kernel")},
        {f"p1_apply_local{sfx}_bf16": (b34.p1_apply_local,
                                       f"launches{sfx}_bf16")}, None, gated,
        reps=3)
    counts = {f"p1_apply_local{sfx}_bf16":
              getattr(b34.p1_apply_local, f"launches{sfx}_bf16"),
              f"p1_diagonal_local{sfx}_coeff_bf16":
              getattr(b34.p1_diagonal_local, f"launches{sfx}_bf16")}
    f32 = {f"p1_apply_local{sfx}":
           getattr(b34.p1_apply_local, f"launches{sfx}")
           - counts[f"p1_apply_local{sfx}_bf16"],
           f"p1_diagonal_local{sfx}":
           getattr(b34.p1_diagonal_local, f"launches{sfx}")
           - counts[f"p1_diagonal_local{sfx}_coeff_bf16"]}
    out.update({"coefficient": "1 + x + 0.5 y", "mean": "arithmetic",
                "f32_residuals": res, "f32_rate_cycles_1_4": rate,
                "f32_homogeneous": hom,
                "eigs_f32_coeff": s32.eigs,
                "setup_s_base_stacks": t1 - t0,
                "setup_s_coefficient_stacks": t2 - t1,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": counts, "f32_launches": f32})
    del s32, s16, base32, base16, x0, b
    torch.cuda.empty_cache()
    return out


def run_bf16_coeff(storage, device, card: str) -> dict:
    """bf16_coeff_kernels: B4-bf16 and B3-bf16 with a coefficient at every
    P1 level 2-7 (pitch 129) and their 2D forms at every P1 level 2-11 of
    the rect, each timed at its top level; then the paths, each with the
    counts of B3 and B4 from 0: mixed_precision_coeff (3D, level 7),
    mixed_precision_coeff_2d (level 11: reported, not gated) and
    mixed_precision_coeff_2d_gated (MP_GATE_2D["p1"]). Returns the kernels
    line's rows of the four bf16 forms and the paths' f32 launches."""
    from hyteg_tpu_torch.mesh.meshinfo import mesh_rectangle
    from hyteg_tpu_torch.primitives.storage import CellStorage

    t0 = time.perf_counter()
    rect = CellStorage(mesh_rectangle(**RECT_2D))
    checks = {3: [], 2: []}
    for dim, st, top in ((3, storage, SLICE_LEVELS[-1]), (2, rect, LEVEL_2D)):
        for lv in range(MIN_LEVEL, top + 1):
            checks[dim].append(bf16_coeff_kernel_check(
                st, lv, device, 700 + 20 * dim + lv, timed=lv == top))
            emit("bf16_coeff_kernels", card=card, dim=dim, **checks[dim][-1])
    mixed = {}
    for path, st, level, gated in (
            ("mixed_precision_coeff", storage, MP_LEVEL, True),
            ("mixed_precision_coeff_2d", rect, LEVEL_2D, False),
            ("mixed_precision_coeff_2d_gated", rect, MP_GATE_2D["p1"], True)):
        t1 = time.perf_counter()
        mixed[path] = mixed_precision_coeff(st, device, level, gated)
        emit(path, card=card, phase_s=time.perf_counter() - t1,
             mesh=(f"mesh_unit_cube({MESH_N})" if st is storage
                   else "mesh_rectangle(nx=4, ny=4)"), **mixed[path])
        for name, n in mixed[path]["launches"].items():
            check(n > 0, f"{name} was not launched on the {path} path")
    rows = {}
    for name, dim, tag in (("p1_apply_local_bf16", 3, "b4"),
                           ("p1_apply_local_2d_bf16", 2, "b4"),
                           ("p1_diagonal_local_coeff_bf16", 3, "b3c"),
                           ("p1_diagonal_local_2d_coeff_bf16", 2, "b3c")):
        top = checks[dim][-1]
        by_path = {path: mp["launches"][name] for path, mp in mixed.items()
                   if name in mp["launches"]}
        rows[name] = {
            "ms": top[f"{tag}_bf16_ms"], "plain_ms": top[f"{tag}_bf16_plain_ms"],
            "bound": top[f"{tag}_bf16_bound"], "level": top["level"],
            "ms_by_mode": top[f"{tag}_bf16_ms_by_mode"],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(v for c in checks[dim] for k, v in c.items()
                               if k.startswith(f"{tag}_bf16_")
                               and k.endswith("_max_abs_err")),
            "ulp_excess": max(v for c in checks[dim] for k, v in c.items()
                              if k.startswith(f"{tag}_bf16_")
                              and k.endswith("_ulp_excess"))}
    f32 = {}
    for path, mp in mixed.items():
        for name, n in mp["f32_launches"].items():
            f32.setdefault(name, {})[path] = n
    emit("bf16_coeff_kernel_timings", card=card,
         phase_s=time.perf_counter() - t0,
         **{k: {kk: v[kk] for kk in ("level", "ms", "plain_ms", "ms_by_mode",
                                      "ulp_excess", "launches")}
            | {"bound_ms": v["bound"][0],
               "share_of_bound": v["bound"][0] / v["ms"]}
            for k, v in rows.items()})
    return {"rows": rows, "f32_launches": f32,
            "phase_s": time.perf_counter() - t0}


def run_a10(storage, device, card: str, f32_residuals: list) -> dict:
    """The A10 phases: bf16_kernels (B2-bf16, B3-bf16 vs plain at P1
    levels 2-7, the refusals), mixed_precision, solvers_extra, n1e1,
    dg_eg. The kernel counts are set to 0 just before the mixed-precision
    and solvers paths and read just after. Returns the launches for the
    kernels line, the bf16 kernels' timings, bounds and errors."""
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.kernels import p1_stencil as b3

    t0 = time.perf_counter()
    checks = []
    for i, lv in enumerate(BF16_CHECK_LEVELS):
        checks.append(bf16_kernel_check(storage, lv, device, seed=400 + i))
        emit("bf16_kernels_vs_plain", card=card, **checks[-1])
    emit("bf16_refusals", **bf16_refusals(storage, device))
    errs = {"p1_const_apply_bf16": max(v for c in checks for k, v in c.items()
                                       if k.startswith("b2_bf16_")
                                       and k.endswith("_max_abs_err")),
            "p1_diagonal_local_bf16": max(
                v for c in checks for k, v in c.items()
                if k.startswith("b3_bf16_") and k.endswith("_max_abs_err"))}
    ulp = {k: max(v for c in checks for kk, v in c.items()
                  if kk.startswith(tag) and kk.endswith("_ulp_excess"))
           for k, tag in (("p1_const_apply_bf16", "b2_bf16_"),
                          ("p1_diagonal_local_bf16", "b3_bf16_"))}
    torch.cuda.empty_cache()

    # the mixed-precision path: every count starts at 0 here
    for w in (b2.p1_const_apply, b3.p1_diagonal_local):
        w.launches, w.launches_bf16 = 0, 0
    t1 = time.perf_counter()
    mp, (s32, x0, b) = mixed_precision(storage, device, card, f32_residuals)
    launches = {k: mp["launches"][k] for k in ("p1_const_apply_bf16",
                                               "p1_diagonal_local_bf16")}
    f32 = {k: mp["launches"][k] for k in ("p1_const_apply",
                                          "p1_diagonal_local")}
    emit("mixed_precision", card=card, phase_s=time.perf_counter() - t1, **mp)
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the mixed-precision path")

    # B2-bf16 and B3-bf16 timed at level 7 on the bf16 stack's own tables
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator

    sp16 = P1Space(storage, MP_LEVEL, device=device, dtype=torch.bfloat16,
                   pitch=PITCH)
    op16 = P1ElementwiseOperator(sp16, forms.laplace_form)
    x16 = x0.to(torch.bfloat16)
    A, E, elm = op16.stencil, op16.stencil_face, op16.elmats
    ms = {"p1_const_apply_bf16": median_ms(
        lambda: b2.p1_const_apply(x16, A, E, MP_LEVEL, 3, PITCH), 10, batch=10),
        "p1_const_apply_bf16_plain": median_ms(
            lambda: b2.p1_const_apply_torch(x16, A, MP_LEVEL, 3, PITCH, E=E),
            5),
        "p1_diagonal_local_bf16": median_ms(
            lambda: b3.p1_diagonal_local(elm, MP_LEVEL, 3, PITCH), 10,
            batch=10),
        "p1_diagonal_local_bf16_plain": median_ms(
            lambda: b3.p1_diagonal_local_torch(elm, MP_LEVEL, 3, PITCH), 5)}
    y16 = b3.p1_diagonal_local(elm, MP_LEVEL, 3, PITCH)
    C = sp16.C_loc
    from hyteg_tpu_torch.indexing import micro

    bounds = {"p1_const_apply_bf16": bound(*b2_work(sp16, x16, A, E)),
              "p1_diagonal_local_bf16": bound(*b3_work(sp16, elm, y16))}
    xv = x16.view(1, C, sp16.N, sp16.N, sp16.pitch)
    kern = conv3d_stencil(A.float().sum(-1), micro.stencil_directions(3)).to(
        torch.bfloat16)
    lib = {"p1_const_apply_bf16": median_ms(
        lambda: F.conv3d(xv, kern, padding=1, groups=C), 10, batch=10)}
    emit("bf16_kernel_timings", card=card, level=MP_LEVEL, ms=ms,
         bound_ms={k: v[0] for k, v in bounds.items()},
         bytes={k: v[2] for k, v in bounds.items()},
         library_ms=lib, ulp_excess=ulp,
         share_of_bound={k: bounds[k][0] / ms[k] for k in bounds})
    del sp16, op16, x16, A, E, elm, y16, xv, kern
    torch.cuda.empty_cache()

    # colored GS and FAS on the f32 stack (B2, B3): counts from 0 again
    for w in (b2.p1_const_apply, b3.p1_diagonal_local):
        w.launches, w.launches_bf16 = 0, 0
    t1 = time.perf_counter()
    xtra = solvers_extra(s32, device, card)
    check(b2.p1_const_apply.launches > 0,
          "p1_const_apply was not launched on the solvers path")
    for k, n in xtra["launches"].items():
        f32[k] = f32.get(k, 0) + n
    emit("solvers_extra", card=card, phase_s=time.perf_counter() - t1, **xtra)
    del s32, x0, b
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    res = n1e1_phase(device, card)
    emit("n1e1", card=card, phase_s=time.perf_counter() - t1, **res)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    res = dg_eg_phase(device, card)
    emit("dg_eg", card=card, phase_s=time.perf_counter() - t1, **res)
    torch.cuda.empty_cache()
    return {"launches": launches, "f32_launches": f32, "ms": ms,
            "bounds": bounds, "library_ms": lib, "errs": errs,
            "ulp_excess": ulp, "phase_s": time.perf_counter() - t0}


def amr_bump(dim: int):
    """u = exp(-|x - 0.1|^2 / 0.005), the steep bump of tests/test_amr.py
    (:93-95), in dim coordinates."""
    return lambda p: torch.exp(-sum((p[..., d] - 0.1) ** 2
                                    for d in range(dim)) / 0.005)


def amr_linear(p):
    return 2 * p[..., 0] - p[..., 1] + 0.5 * p[..., 2]


def mesh_measures(mesh) -> dict:
    """Volume (area), boundary measure and conformity of a macro mesh, as
    tests/test_amr.py:21-47 computes them."""
    import itertools

    from hyteg_tpu_torch.mesh.meshinfo import boundary_facets

    dim = mesh.dim
    v = mesh.points[mesh.elements][..., :dim]
    vol = np.abs(np.linalg.det(v[:, 1:] - v[:, :1])).sum() / (
        2.0 if dim == 2 else 6.0)
    f = mesh.points[boundary_facets(mesh.elements, dim)][..., :dim]
    if dim == 2:
        bnd = np.linalg.norm(f[:, 1] - f[:, 0], axis=1).sum()
    else:
        bnd = 0.5 * np.linalg.norm(np.cross(f[:, 1] - f[:, 0],
                                            f[:, 2] - f[:, 0]), axis=1).sum()
    combos = itertools.combinations(range(dim + 1), dim)
    key = np.sort(np.concatenate([mesh.elements[:, c] for c in combos]), 1)
    facet_uses = np.unique(key, axis=0, return_counts=True)[1].max()
    return {"volume": float(vol), "boundary_measure": float(bnd),
            "conforming": bool(facet_uses <= 2)}


def amr_mark_refine(mesh, level: int, device) -> tuple[dict, object, object]:
    """Interpolate the bump at P1 ``level``, compute the indicator on the
    card (and on the CPU from the same field: the marked sets must be
    equal), mark (Dörfler AMR_FRAC) and refine red-green; the refined mesh
    must be conforming with the old volume and boundary measure."""
    from hyteg_tpu_torch.adaptivity import (macro_gradient_indicator,
                                            mark_dorfler, refine_rg)
    from hyteg_tpu_torch.core.types import BoundaryCondition, DoFType
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.primitives.storage import CellStorage

    st = CellStorage(mesh)
    sp = P1Space(st, level, device=device)
    u = sp.interpolate(amr_bump(mesh.dim), sp.zeros(), DoFType.ALL,
                       BoundaryCondition.all_dirichlet())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eta = macro_gradient_indicator(sp, u)
    indicator_ms = (time.perf_counter() - t0) * 1e3
    eta_cpu = macro_gradient_indicator(P1Space(st, level, device="cpu"),
                                       u.cpu())
    marked = mark_dorfler(eta, AMR_FRAC)
    marked_cpu = mark_dorfler(eta_cpu, AMR_FRAC)
    check(np.array_equal(marked, marked_cpu),
          f"AMR {mesh.dim}D: the card marks {marked}, the CPU {marked_cpu}")
    t0 = time.perf_counter()
    res = refine_rg(mesh, marked)
    refine_ms = (time.perf_counter() - t0) * 1e3
    old, new = mesh_measures(mesh), mesh_measures(res.mesh)
    check(new["conforming"], f"AMR {mesh.dim}D: the refined mesh has "
          "hanging facets")
    for k in ("volume", "boundary_measure"):
        check(abs(new[k] - old[k]) <= AMR_MEASURE_RTOL * old[k],
              f"AMR {mesh.dim}D: {k} {new[k]} != {old[k]}")
    out = {"level": level, "cells": mesh.num_elements,
           "marked": marked.tolist(), "refined_cells": res.mesh.num_elements,
           "green_cells": int(res.is_green.sum()),
           "eta_max": float(eta.max()),
           "eta_card_vs_cpu_max_rel": float(np.abs(eta - eta_cpu).max()
                                            / np.abs(eta_cpu).max()),
           "indicator_ms": indicator_ms, "refine_ms": refine_ms,
           "measures": new}
    return out, st, res


def amr_transfer(st, st2, level: int, device) -> tuple[dict, torch.Tensor]:
    """The linear field 2x - y + 0.5z moved from the old storage to the
    refined one at P1 ``level``, against its interpolant there (valid
    positions), timed (median of 3, each synchronised)."""
    from hyteg_tpu_torch.adaptivity import interpolate_between_storages
    from hyteg_tpu_torch.core.types import BoundaryCondition, DoFType
    from hyteg_tpu_torch.functions.p1 import P1Space

    bc = BoundaryCondition.all_dirichlet()
    sp, sp2 = P1Space(st, level, device=device), P1Space(st2, level, device=device)
    u = sp.interpolate(amr_linear, sp.zeros(), DoFType.ALL, bc)
    want = sp2.interpolate(amr_linear, sp2.zeros(), DoFType.ALL, bc)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u2 = interpolate_between_storages(st, level, 1, u, st2, device=device)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    sel = torch.as_tensor(sp2.vertex_mask[None] & st2.cell_valid[:, None, None],
                          device=device)
    err = (u2 - want).abs()[sel].max().item()
    check(err <= AMR_TRANSFER_ATOL,
          f"AMR transfer: max error {err} > {AMR_TRANSFER_ATOL}")
    ms = float(np.median(times))
    return {"level": level, "points": u2.numel(),
            "valid_points": int(sel.sum().item()), "max_abs_err": err,
            "ms": ms, "points_per_s": u2.numel() / (ms * 1e-3),
            "method": "wall clock, synchronised, median of 3 (space set-up, "
                      "point location and evaluation)"}, u2


def amr_gmg(st2, device, card: str) -> dict:
    """The refined cube's P1 GMG (make_p1_gmg from MIN_LEVEL, V(3,3),
    Chebyshev; the level-7 stack's pitch is 129) on the manufactured sine,
    AMR_CYCLES cycles at each of AMR_GMG_LEVELS: every residual finite and
    no cycle growing it > 2x (tests/test_gmg_regression.py's rules), the
    nodal error dropping >= ERR_DROP_MIN over AMR_ERR_LEVELS (the pair
    below the f32 floor). At the top level, where the manufactured
    residual nears its f32 floor by cycle 4, the rate is gated on A x = 0
    from a random start: each of cycles 1-4 and the means over 1-4 and 3-6
    <= AMR_RATE_MAX. The top level is timed and profiled. Each level's
    line (``amr_gmg_level``) is printed before its gates."""
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.kernels import p1_stencil as b3

    runs = {}
    top = AMR_GMG_LEVELS[-1]
    for lv in AMR_GMG_LEVELS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        b3.p1_diagonal_local.launches_by_level.clear()
        runs[lv], stack, (x, b) = solve(st2, lv, device, gate_rate=False,
                                        cycles=AMR_CYCLES)
        runs[lv]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res = runs[lv]["residuals"]
        runs[lv]["rates"] = [res[i + 1] / res[i] for i in range(len(res) - 1)]
        if lv == top:
            hom = homogeneous_rates(stack, device, seed=810, max_rate=1.0)
            r = hom["residuals"]
            hom["rates"] = [r[i + 1] / r[i] for i in range(len(r) - 1)]
            runs[lv]["homogeneous"] = hom
        emit("amr_gmg_level", card=card, **{
            k: v for k, v in runs[lv].items() if k != "eigs"})
        check(all(b <= AMR_GROWTH_MAX * a + AMR_GROWTH_SLACK * res[0]
                  for a, b in zip(res, res[1:])),
              f"AMR GMG level {lv}: a cycle grew the residual: {res}")
        if lv != top:
            del stack, x, b
    hom = runs[top]["homogeneous"]
    rates = hom["rates"][:4] + [hom["rate_cycles_1_4"], hom["rate_cycles_3_6"]]
    check(all(r <= AMR_RATE_MAX for r in rates),
          f"AMR GMG level {top} on A x = 0: the rates of cycles 1-4 and the "
          f"means over 1-4, 3-6 {rates} > {AMR_RATE_MAX}")
    lo, hi = AMR_ERR_LEVELS
    drop = runs[lo]["max_nodal_error"] / runs[hi]["max_nodal_error"]
    check(drop >= ERR_DROP_MIN, f"AMR GMG: the nodal error dropped {drop}x "
          f"from level {lo} to {hi}, < {ERR_DROP_MIN}x")
    cycle_ms = median_ms(lambda: stack.gmg.cycle(x, b), 10)
    prof = cycle_profile(lambda: stack.gmg.cycle(x, b), cycle_ms,
                         {"b2": ("p1_const_apply_kernel",),
                          "b3": ("p1_diag_kernel",)})
    b3_by_level = dict(sorted(b3.p1_diagonal_local.launches_by_level.items()))
    b2_by_level = launches_by_level(stack, x, b, b2.p1_const_apply)
    del stack, x, b
    torch.cuda.empty_cache()
    return {"levels": {lv: {k: r[k] for k in (
        "global_dofs", "rate_cycles_1_4", "max_nodal_error", "setup_s",
        "peak_gb")} for lv, r in runs.items()},
        "homogeneous_rates": hom["rates"], "error_drop": drop,
        "error_drop_levels": [lo, hi],
        "error_drop_above_f32_floor": (runs[hi]["max_nodal_error"]
                                       / runs[top]["max_nodal_error"]),
        "cycle_ms": cycle_ms, "profile": prof,
        "b2_launches_by_level_per_cycle": b2_by_level,
        "b3_launches_by_level_at_setup": b3_by_level}


def read_vtu_arrays(path) -> dict:
    """{name: array} of a VTU file's DataArrays (binary payloads decoded:
    a UInt32 byte count, then the raw data; ASCII ones parsed)."""
    import base64
    import struct
    import xml.etree.ElementTree as ET

    types = {"Float64": np.float64, "Float32": np.float32,
             "Int64": np.int64, "UInt8": np.uint8}
    arrays = {}
    for el in ET.parse(path).getroot().iter("DataArray"):
        dt = types[el.get("type")]
        name = el.get("Name") or "points"
        if el.get("format") == "binary":
            raw = base64.b64decode(el.text.strip())
            (nb,) = struct.unpack("<I", raw[:4])
            check(nb == len(raw) - 4, f"{path}: {name}'s byte count")
            arrays[name] = np.frombuffer(raw[4:], dtype=dt)
        else:
            arrays[name] = np.array(el.text.split(), dtype=np.float64).astype(dt)
    return arrays


def amr_io(st2, u2, level: int, numbers: dict) -> dict:
    """Write, time and read back, in a temporary directory: a VTU of the
    refined field ``u2`` at P1 ``level``, the domain-partitioning VTU, the
    refined mesh through write_msh2 and from_gmsh_file, and one
    FixedSizeSQLDB row of ``numbers``."""
    import sqlite3
    import tempfile

    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.io.gmsh import write_msh2
    from hyteg_tpu_torch.io.tables import FixedSizeSQLDB, plain_value
    from hyteg_tpu_torch.io.vtk import VTKOutput, write_domain_partitioning_vtk
    from hyteg_tpu_torch.mesh.meshinfo import from_gmsh_file

    out = {}
    mesh = st2.mesh
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        sp = P1Space(st2, level, device=u2.device)
        t0 = time.perf_counter()
        vtk = VTKOutput(tmp, "amr", st2)
        vtk.add("u", sp, u2)
        path = vtk.write(level)
        out["vtu_ms"] = (time.perf_counter() - t0) * 1e3
        out["vtu_bytes"] = os.path.getsize(path)
        arrays = read_vtu_arrays(path)
        N = sp.N
        grid = u2.reshape(sp.C_loc, N, N, sp.pitch)[..., :N].cpu().numpy()
        check(np.array_equal(arrays["u"], grid.reshape(-1)),
              "AMR VTU: the values read back differ")
        coords = sp.coords().cpu().numpy().astype(np.float64)
        coords = coords.reshape(sp.C_loc, N, N, sp.pitch, 3)[..., :N, :]
        check(np.array_equal(arrays["points"], coords.reshape(-1)),
              "AMR VTU: the points read back differ")
        n_el = mesh.num_elements * 8 ** level
        check(arrays["types"].shape == (n_el,) and (arrays["types"] == 10).all()
              and arrays["connectivity"].shape == (4 * n_el,),
              "AMR VTU: the cells read back differ")
        t0 = time.perf_counter()
        path = write_domain_partitioning_vtk(st2, tmp, "amr")
        out["partitioning_ms"] = (time.perf_counter() - t0) * 1e3
        arrays = read_vtu_arrays(path)
        check(np.array_equal(arrays["connectivity"].reshape(-1, 4),
                             st2.topo.elements)
              and np.array_equal(arrays["shard"],
                                 np.zeros(mesh.num_elements)),
              "AMR partitioning VTU: the cells or shards read back differ")
        t0 = time.perf_counter()
        write_msh2(mesh, os.path.join(tmp, "amr.msh"))
        back = from_gmsh_file(os.path.join(tmp, "amr.msh"))
        out["msh_round_trip_ms"] = (time.perf_counter() - t0) * 1e3
        check(back.dim == mesh.dim and np.array_equal(back.points, mesh.points)
              and np.array_equal(back.elements, mesh.elements)
              and np.array_equal(back.vertex_boundary_flag,
                                 mesh.with_computed_boundary_flags()
                                 .vertex_boundary_flag),
              "AMR msh: the mesh read back differs")
        t0 = time.perf_counter()
        db = FixedSizeSQLDB(os.path.join(tmp, "amr.db"))
        for k, v in numbers.items():
            db.set_variable_entry(k, v)
        db.write_row_on_root()
        with sqlite3.connect(os.path.join(tmp, "amr.db")) as con:
            row = con.execute(f"SELECT {', '.join(sorted(numbers))} "
                              "FROM runs").fetchall()
        out["sql_ms"] = (time.perf_counter() - t0) * 1e3
        want = tuple(plain_value(v) for _, v in sorted(numbers.items()))
        check(row == [want], f"AMR SQL row: {row} != {[want]}")
    return out


def run_amr(device, card: str) -> dict:
    """The AMR path (kernels B2, B3, B2-2D, B3-2D on red-green refined
    meshes): on mesh_unit_cube(2) the bump's indicator at P1 level 4 on the
    card, Dörfler marking, red-green refinement (106 cells), the transfer
    of a linear field to the refined storage, the refined-mesh GMG at P1
    levels 4-7 (2-7, pitch 129), IO of the result; the same AMR cycle
    on the rect (40 faces) with its GMG at level 11 on A x = 0. The counts
    of B2 / B3 (3D and 2D) are set to 0 before the path and read after
    it; then each kernel is held against its plain version at every level
    of the refined stacks (``amr_kernels``), which counts no launch."""
    from hyteg_tpu_torch import native
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.kernels import p1_stencil as b3
    from hyteg_tpu_torch.mesh.meshinfo import mesh_rectangle, mesh_unit_cube
    from hyteg_tpu_torch.primitives.storage import CellStorage
    from hyteg_tpu_torch.solvers.templates import make_p1_gmg

    t0 = time.perf_counter()
    check(native.available(), "the native setup core did not build")
    for w in (b2.p1_const_apply, b3.p1_diagonal_local):
        w.launches = w.launches_2d = 0
    # -- 3D: mark, refine, transfer, the refined-mesh GMG, IO ---------------
    mark, st, res = amr_mark_refine(mesh_unit_cube(MESH_N), AMR_LEVEL, device)
    st2 = CellStorage(res.mesh)
    transfer, u2 = amr_transfer(st, st2, AMR_LEVEL, device)
    gmg = amr_gmg(st2, device, card)
    top = gmg["levels"][AMR_GMG_LEVELS[-1]]
    io = amr_io(st2, u2, AMR_LEVEL, {
        "refined_cells": res.mesh.num_elements,
        "global_dofs": top["global_dofs"],
        "rate_cycle_2": gmg["homogeneous_rates"][1],
        "max_nodal_error": np.float64(top["max_nodal_error"]),
        "transfer_err": torch.tensor(transfer["max_abs_err"])})
    launches = {"p1_const_apply": b2.p1_const_apply.launches,
                "p1_diagonal_local": b3.p1_diagonal_local.launches}
    emit("amr", card=card, phase_s=time.perf_counter() - t0,
         mesh=f"mesh_unit_cube({MESH_N})", mark_refine=mark,
         transfer=transfer, gmg=gmg, io=io, launches=launches,
         native_available=True)
    del u2
    # -- 2D: the rect ---------------------------------------------------------
    t1 = time.perf_counter()
    mark2, rst, res2 = amr_mark_refine(mesh_rectangle(**RECT_2D),
                                       AMR_LEVEL_2D, device)
    rst2 = CellStorage(res2.mesh)
    transfer2, _ = amr_transfer(rst, rst2, AMR_LEVEL_2D, device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    s0 = time.perf_counter()
    stack = make_p1_gmg(rst2, min_level=MIN_LEVEL, max_level=AMR_GMG_LEVEL_2D,
                        smoother="chebyshev", coarse_iters=COARSE_ITERS,
                        device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - s0
    hom = homogeneous_rates(stack, device, seed=800, max_rate=AMR_RATE_MAX)
    r = hom["residuals"]
    hom["rates"] = [r[i + 1] / r[i] for i in range(len(r) - 1)]
    check(all(q <= AMR_RATE_MAX for q in hom["rates"][:4]),
          f"AMR 2D GMG on A x = 0: rates {hom['rates'][:4]} > {AMR_RATE_MAX}")
    x, b = manufactured(stack)[:2]
    cycle_ms = median_ms(lambda: stack.gmg.cycle(x, b), 10)
    prof = cycle_profile(lambda: stack.gmg.cycle(x, b), cycle_ms, {
        "b2_2d": ("p1_const_apply_2d_kernel",),
        "b3_2d": ("p1_diag_2d_kernel",)})
    by_level = launches_by_level(stack, x, b, b2.p1_const_apply, dim=2)
    peak = torch.cuda.max_memory_allocated() / 1e9
    dofs = stack.space().num_global_dofs()
    launches.update({"p1_const_apply_2d": b2.p1_const_apply.launches_2d,
                     "p1_diagonal_local_2d": b3.p1_diagonal_local.launches_2d})
    del stack, x, b
    torch.cuda.empty_cache()
    emit("amr_2d", card=card, phase_s=time.perf_counter() - t1,
         mesh="mesh_rectangle(nx=4, ny=4)", mark_refine=mark2,
         transfer=transfer2, level=AMR_GMG_LEVEL_2D, global_dofs=dofs,
         setup_s=setup_s, peak_gb=peak, homogeneous=hom, cycle_ms=cycle_ms,
         profile=prof, b2_2d_launches_by_level_per_cycle=by_level,
         launches={k: launches[k] for k in ("p1_const_apply_2d",
                                            "p1_diagonal_local_2d")})
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the AMR path")
    # -- the kernels on the refined meshes, against their plain versions ----
    checks = {3: [], 2: []}
    for dim, s, top_level in ((3, st2, AMR_GMG_LEVELS[-1]),
                              (2, rst2, AMR_GMG_LEVEL_2D)):
        for lv in range(MIN_LEVEL, top_level + 1):
            checks[dim].append(check_kernels(s, lv, device, seed=820 + lv))
        torch.cuda.empty_cache()
    emit("amr_kernels", card=card, rtol={"b2": B2_RTOL, "b3": B3_RTOL},
         **{f"{dim}d": [{k: v for k, v in c.items()
                         if k in ("level", "block", "global_dofs", "b2_ms",
                                  "b2_bound_ms") or k.endswith("max_abs_err")}
                        for c in cs] for dim, cs in checks.items()})
    errs = {}
    for name, dim, tag in (("p1_const_apply", 3, "b2_"),
                           ("p1_diagonal_local", 3, "b3_"),
                           ("p1_const_apply_2d", 2, "b2_"),
                           ("p1_diagonal_local_2d", 2, "b3_")):
        errs[name] = max(v for c in checks[dim] for k, v in c.items()
                         if k.startswith(tag) and k.endswith("_max_abs_err"))
    b2_top = checks[3][-1]
    phase_s = time.perf_counter() - t0
    emit("amr_checks", card=card, phase_s=phase_s, launches=launches,
         b2_level7_ms=b2_top["b2_ms"], b2_level7_bound_ms=b2_top["b2_bound_ms"],
         b2_level7_share_of_bound=b2_top["b2_bound_ms"] / b2_top["b2_ms"])
    return {"launches": launches, "errs": errs, "phase_s": phase_s}


def main() -> int:
    from hyteg_tpu_torch.kernels import build

    if not build.cuda_available():
        print("chip_smoke: torch sees no CUDA device; this test needs one "
              "GPU", file=sys.stderr)
        return 1
    from hyteg_tpu_torch.kernels import box_stencil as b1
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.kernels import p1_stencil as b3
    from hyteg_tpu_torch.kernels import p1_stencil as b4
    from hyteg_tpu_torch.kernels import stream as p1
    from hyteg_tpu_torch.kernels import tetpair as tk
    from hyteg_tpu_torch.mesh.meshinfo import mesh_unit_cube
    from hyteg_tpu_torch.primitives.storage import CellStorage
    from hyteg_tpu_torch.structured import gmg as box_gmg
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.indexing import micro
    from hyteg_tpu_torch.kernels import p2_const_stencil as b5
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.averaging import MODES
    from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
    from hyteg_tpu_torch.structured import kuhn

    device = torch.device("cuda", 0)
    # importing hyteg_tpu_torch switched TF32 off, so the library calls
    # timed beside the kernels run in full f32
    check(not (torch.backends.cudnn.allow_tf32
               or torch.backends.cuda.matmul.allow_tf32), "TF32 is on")
    kind = torch.cuda.get_device_name(0)
    card = smi_card()
    print(card, flush=True)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)

    so, build_s, log = build.build()
    build.library()
    emit("build", seconds=build_s, library=str(so.relative_to(build.PKG_DIR.parent)),
         ptxas=ptxas_by_function(log))

    # -- the macro-tet path (B2, B3) ------------------------------------------
    storage = CellStorage(mesh_unit_cube(MESH_N))
    checks = []
    for i, level in enumerate(CHECK_LEVELS):
        checks.append(check_kernels(storage, level, device, seed=i))
        emit("kernels_vs_plain", card=card, **checks[-1])
        torch.cuda.empty_cache()
    errs = {name: max(v for c in checks for k, v in c.items()
                      if k.startswith(tag) and k.endswith("_max_abs_err"))
            for name, tag in (("p1_const_apply", "b2_"),
                              ("p1_diagonal_local", "b3_"))}

    # the main path: every launch count starts at 0 here
    b2.p1_const_apply.launches = 0
    b3.p1_diagonal_local.launches = 0
    results = {}
    for level in SLICE_LEVELS:
        results[level], stack, (x, b) = solve(storage, level, device)
        emit("gmg_solve", card=card, **results[level])
        if level != SLICE_LEVELS[-1]:
            del stack, x, b
            torch.cuda.empty_cache()
    launches = {"p1_const_apply": b2.p1_const_apply.launches,
                "p1_diagonal_local": b3.p1_diagonal_local.launches}
    drop = (results[SLICE_LEVELS[0]]["max_nodal_error"]
            / results[SLICE_LEVELS[1]]["max_nodal_error"])
    emit("gmg_checks", error_drop=drop, launches=launches)
    check(drop >= ERR_DROP_MIN,
          f"nodal error dropped {drop}x from level {SLICE_LEVELS[0]} to "
          f"{SLICE_LEVELS[1]}, < {ERR_DROP_MIN}x")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    # timings at the finest level, on the stack's own operator and data
    level = SLICE_LEVELS[-1]
    sp, op = stack.space(), stack.operators[level]
    tet_dofs = sp.num_global_dofs()
    tet_block = list(sp.block_shape)
    A, E, elm = op.stencil, op.stencil_face, op.elmats
    t = {
        "p1_const_apply": median_ms(
            lambda: b2.p1_const_apply(x, A, E, level, 3, sp.pitch), 10,
            batch=10),
        "p1_const_apply_plain": median_ms(
            lambda: b2.p1_const_apply_torch(x, A, level, 3, sp.pitch, E=E), 20),
        "p1_diagonal_local": median_ms(
            lambda: b3.p1_diagonal_local(elm, level, 3, sp.pitch), 10,
            batch=10),
        "p1_diagonal_local_plain": median_ms(
            lambda: b3.p1_diagonal_local_torch(elm, level, 3, sp.pitch), 20),
        "apply_raw": median_ms(lambda: op.apply_raw(x), 10, batch=10),
        "vcycle": median_ms(lambda: stack.gmg.cycle(x, b), 20),
    }
    # B3 with a coefficient, in each mean (the coefficient refresh of a
    # variable-coefficient smoother)
    kc = coeff_field(sp, device, torch.Generator(device=device).manual_seed(62),
                     "random")
    b3_coeff_ms = {m: median_ms(
        lambda m=m: b3.p1_diagonal_local(elm, level, 3, sp.pitch, False, kc, m),
        10, batch=10) for m in MODES}
    # the block written once, the coefficient read on the tet's slots; per
    # (element, vertex) term 4 adds of the mean, its division and a
    # multiply-add
    b3_coeff_bound = bound(
        nbytes(elm) + nbytes(x) + simplex_read_bytes(sp, [(0, 0, 0)], sp.C_loc),
        7 * 4 * sp.C_loc * sum(tet_points(sp.n - int(m))
                               for m in micro.base_margin(3)))
    emit("b3_coeff", card=card, level=level, ms=b3_coeff_ms,
         bound_ms=b3_coeff_bound[0], bound_by=b3_coeff_bound[1])
    del kc
    emit("gmg_profile", card=card, level=level, **cycle_profile(
        lambda: stack.gmg.cycle(x, b), t["vcycle"],
        {"b2": ("p1_const_apply_kernel",), "b3": ("p1_diag_kernel",)}),
         b2_launches_by_level=launches_by_level(stack, x, b,
                                                b2.p1_const_apply))
    # bounds, and the nearest single library call: a grouped conv3d with the
    # interior stencil (equal to B2 on interior points only)
    C = sp.C_loc
    bounds = {
        "p1_const_apply": bound(*b2_work(sp, x, A, E)),
        "p1_diagonal_local": bound(*b3_work(sp, elm, x))}
    xv = x.view(1, C, sp.N, sp.N, sp.pitch)
    kern = conv3d_stencil(A.sum(-1), micro.stencil_directions(3))
    lib_ms = {"p1_const_apply": median_ms(
        lambda: F.conv3d(xv, kern, padding=1, groups=C), 10, batch=10)}
    del stack, sp, op, A, E, elm, x, b, xv, kern
    torch.cuda.empty_cache()

    # -- the variable-coefficient P1 operator (B4; B3 with a coefficient) ----
    b4_checks = []
    for i, lv in enumerate(B4_CHECKS):
        b4_checks.append(check_coeff_kernels(storage, lv, device, seed=50 + i))
        emit("coeff_kernels_vs_plain", card=card, **b4_checks[-1])
        torch.cuda.empty_cache()
    errs["p1_apply_local"] = max(v for c in b4_checks for k, v in c.items()
                                 if k.endswith("_max_abs_err"))
    lv = B4_CHECKS[-1]
    sp = P1Space(storage, lv, device=device, pitch=PITCH)
    op = P1ElementwiseOperator(sp, forms.laplace_form)
    k = coeff_field(sp, device, None, "linear")
    b3.p1_diagonal_local.launches = 0
    b4.p1_apply_local.launches = 0
    sym = symmetric_positive(sp, lambda v: op.apply_raw(v, coeff=k), 60,
                             f"P1 coefficient operator level {lv}")
    dinv = op.inverse_diagonal(coeff=k)[:, sp.vertex_mask_t.bool()]
    coeff_launches = {"p1_apply_local": b4.p1_apply_local.launches,
                      "p1_diagonal_local": b3.p1_diagonal_local.launches}
    emit("coeff_operator", card=card, level=lv, coefficient="1 + x + 0.5 y",
         **sym, inv_diag_min=dinv.min().item(), inv_diag_max=dinv.max().item(),
         launches=coeff_launches)
    check(bool(torch.isfinite(dinv).all()) and dinv.min().item() > 0,
          "the inverse diagonal with a coefficient is not finite and positive")
    for name, n in coeff_launches.items():
        check(n > 0, f"{name} was not launched on the coefficient path")
    launches["p1_apply_local"] = coeff_launches["p1_apply_local"]
    launches["p1_diagonal_local"] += coeff_launches["p1_diagonal_local"]
    x = sp.exchange_rep(torch.randn(
        sp.block_shape, device=device,
        generator=torch.Generator(device=device).manual_seed(61))
        * sp.vertex_mask_t)
    elm = op.elmats
    t["p1_apply_local"] = median_ms(
        lambda: b4.p1_apply_local(x, elm, lv, 3, PITCH, k), 10, batch=10)
    t["p1_apply_local_plain"] = median_ms(
        lambda: b4.p1_apply_local_torch(x, elm, lv, 3, PITCH, k), 3, warmup=1)
    t["p1_apply_local_no_coeff"] = median_ms(
        lambda: b4.p1_apply_local(x, elm, lv, 3, PITCH), 10, batch=10)
    t["apply_raw_coeff"] = median_ms(lambda: op.apply_raw(x, coeff=k), 10,
                                     batch=10)
    bounds["p1_apply_local"] = bound(*b4_work(sp, x, elm))
    # B4 at level 7 in each mean and without a coefficient (bound: no
    # coefficient read, 16 multiply-adds per element and vertex)
    b4_ms = {"none": t["p1_apply_local_no_coeff"],
             "arithmetic": t["p1_apply_local"]}
    for m in MODES[1:]:
        b4_ms[m] = median_ms(
            lambda m=m: b4.p1_apply_local(x, elm, lv, 3, PITCH, k, m), 10,
            batch=10)
    b4_bound_none = bound(
        nbytes(x) + simplex_read_bytes(sp, [(0, 0, 0)], sp.C_loc)
        + nbytes(elm), 32 * sp.C_loc * sum(
            tet_points(sp.n - int(m)) for m in micro.base_margin(3)))[0]
    b4_coeff = {"3d": b4_mode_line(lv, b4_ms, bounds["p1_apply_local"][0],
                                   b4_bound_none, t["apply_raw_coeff"])}
    del sp, op, k, dinv, x, elm
    torch.cuda.empty_cache()

    # -- the P2 path (B5): bench_vcycle's bench_p2 at level 6 ----------------
    p2_checks = []
    for i, lv in enumerate(P2_CHECKS):
        p2_checks.append(check_p2_kernels(storage, lv, device, seed=70 + i,
                                          vs_general=lv == P2_LEVEL))
        emit("p2_kernels_vs_plain", card=card, **p2_checks[-1])
    errs["p2_const_apply"] = max(v for c in p2_checks for k, v in c.items()
                                 if k.endswith("_max_abs_err"))
    b5.p2_const_apply.launches = 0
    p2res, stack, (x, b) = p2_gmg(storage, device)
    launches["p2_const_apply"] = b5.p2_const_apply.launches
    p2res["launches"] = {"p2_const_apply": launches["p2_const_apply"]}
    check(launches["p2_const_apply"] > 0,
          "p2_const_apply was not launched on the P2 path")
    p2res["ms_per_vcycle"] = median_ms(lambda: stack.gmg.cycle(x, b), 3,
                                       warmup=1)
    p2res["peak_bytes"] = torch.cuda.max_memory_allocated()
    p2res["peak_gb"] = p2res["peak_bytes"] / 1e9
    n0 = b5.p2_const_apply.launches
    stack.gmg.cycle(x, b)
    p2res["b5_launches_per_vcycle"] = b5.p2_const_apply.launches - n0
    emit("p2_gmg", card=card, **p2res)
    emit("p2_profile", card=card, level=P2_LEVEL,
         **p2_cycle_profile(stack, x, b, p2res["ms_per_vcycle"]),
         b5_launches_by_level=launches_by_level(stack, x, b,
                                                b5.p2_const_apply))
    sp, op = stack.space(), stack.operators[P2_LEVEL]
    W = op.stencil_folded
    t["p2_const_apply"] = median_ms(
        lambda: b5.p2_const_apply(x, W, P2_LEVEL, PITCH), 10, batch=10)
    t["p2_const_apply_plain"] = median_ms(
        lambda: b5.p2_const_apply_torch(x, W, P2_LEVEL, PITCH), 3, warmup=1)
    t["p2_apply_raw"] = median_ms(lambda: op.apply_raw(x), 10, batch=10)
    t["p2_vcycle"] = p2res["ms_per_vcycle"]
    bounds["p2_const_apply"] = bound(*b5_work(sp, x, W, P2_LEVEL))
    # the P2 coefficient apply (plain torch in both packages) at level 6
    ones = sp.vertex_mask_t.expand(sp.block_shape).contiguous()
    rel1 = rel_err(op.apply_raw(x), op.apply_raw(x, coeff=ones))
    check(math.isfinite(rel1) and rel1 <= B5_RTOL,
          f"P2 coefficient apply at k = 1 vs B5: rel {rel1} > {B5_RTOL}")
    k = coeff_field(sp, device, torch.Generator(device=device).manual_seed(80),
                    "random")
    sym = symmetric_positive(sp, lambda v: op.apply_raw(v, coeff=k), 81,
                             f"P2 coefficient operator level {P2_LEVEL}")
    t["p2_apply_raw_coeff"] = median_ms(lambda: op.apply_raw(x, coeff=k), 3,
                                        warmup=1)
    emit("p2_coeff", card=card, level=P2_LEVEL, unit_coeff_vs_b5_rel=rel1,
         **sym, apply_raw_coeff_ms=t["p2_apply_raw_coeff"])
    del op, W, ones, k
    torch.cuda.empty_cache()
    # -- mixed_precision_p2: the bf16 P2 stack (B5-bf16) under an f32
    # refinement, on this path's f32 stack and rhs ---------------------------
    zero_counts()
    t1 = time.perf_counter()
    mixed = {"mixed_precision_p2": mixed_precision_on(
        stack, torch.zeros_like(b), b, p2res["residuals"],
        p2res["ms_per_vcycle"], device, "p2")}
    emit("mixed_precision_p2", card=card, phase_s=time.perf_counter() - t1,
         mesh=f"mesh_unit_cube({MESH_N})", **mixed["mixed_precision_p2"])
    check(mixed["mixed_precision_p2"]["launches"].get(
        "p2_const_apply_bf16", 0) > 0,
          "p2_const_apply_bf16 was not launched on the P2 mixed-precision path")
    del stack, sp, x, b
    torch.cuda.empty_cache()
    man = {}
    for lv in P2_MANUFACTURED:
        man[lv] = p2_manufactured(storage, lv, device)
        emit("p2_manufactured", card=card, **man[lv])
        torch.cuda.empty_cache()
    lo, hi = P2_MANUFACTURED[:2]
    drop = man[lo]["max_nodal_error"] / man[hi]["max_nodal_error"]
    emit("p2_checks", error_drop=drop, error_drop_levels=[lo, hi])
    check(drop >= P2_ERR_DROP_MIN,
          f"P2 nodal error dropped {drop}x from level {lo} to {hi}, < "
          f"{P2_ERR_DROP_MIN}x")

    # -- the 2D arm (B2-2D, B3-2D, B4-2D, B5-2D) -----------------------------
    arm2d = run_2d(device, card)
    mixed.update(arm2d["mixed"])
    b4_coeff["2d"] = arm2d["b4_coeff"]
    emit("b4_coeff", card=card, **b4_coeff)

    # -- the Stokes path (B5, B3; B5-2D, B3-2D) --------------------------------
    stokes = run_stokes(storage, device, card)
    emit("stokes_checks", phase_s=stokes["phase_s"],
         launches=stokes["launches"])


    # -- the paired-tet engine (B6, B7, B8): bench_tet's path ----------------
    storages = {"cube": storage, "shell": tetpair_storage("shell")}
    tp_checks = []
    for i, (mesh, level, pitch) in enumerate(TETPAIR_CHECKS):
        tp_checks.append(check_tetpair_kernels(storages[mesh], level, pitch,
                                               device, seed=30 + i))
        emit("tetpair_kernels_vs_plain", card=card, mesh=mesh, **tp_checks[-1])
    for name, tag in (("pair_apply", "b6_"), ("pair_install", "b7_"),
                      ("pair_extract", "b8_")):
        errs[name] = max(v for c in tp_checks for k, v in c.items()
                         if k.startswith(tag) and k.endswith("_max_abs_err"))

    tk.pair_apply.launches = 0
    tk.pair_install.launches = 0
    tk.pair_extract.launches = 0
    tp_names = ("pair_apply", "pair_install", "pair_extract")
    b6_cases, b78_cases = [], []
    for i, (mesh, level) in enumerate(TETPAIR_CASES):
        res, objs = tetpair_apply(storages[mesh], level, device, seed=40 + i)
        emit("tetpair_apply", card=card, mesh=mesh, **res)
        # B6, B7 and B8 timed beside their bounds at this case; the
        # timings' launches are not the main path's
        counts = {name: getattr(tk, name).launches for name in tp_names}
        b6_cases.append({"mesh": mesh, "level": level,
                         **b6_timing(objs[2], objs[3])})
        b78_cases.append({"mesh": mesh, "level": level,
                          **b7_b8_timing(objs[2], objs[3])})
        for name, n in counts.items():
            getattr(tk, name).launches = n
        if (mesh, level) == ("cube", TETPAIR_TIME_LEVEL):
            tp_res, (sp, op, eng, x) = res, objs
        del objs
        torch.cuda.empty_cache()
    emit("b6_levels", card=card, cases=b6_cases)
    emit("b7_b8_levels", card=card, cases=b78_cases)
    b78 = next(c for c in b78_cases
               if (c["mesh"], c["level"]) == ("cube", TETPAIR_TIME_LEVEL))
    tp_launches = {name: getattr(tk, name).launches for name in tp_names}
    emit("tetpair_checks", launches=tp_launches)
    for name, n in tp_launches.items():
        check(n > 0, f"{name} was not launched on the paired-tet path")
    launches.update(tp_launches)

    # timings at level 7, on the engine's own state
    N, P = eng.N, eng.P
    st = eng.lift(x)
    faces = (st.xf, st.yf, st.zf, st.df)
    fo = tk.pair_apply(st.u, eng.W, *faces, N, P)[1:]
    t.update({
        "pair_apply": next(c["ms"] for c in b6_cases if (c["mesh"], c["level"])
                           == ("cube", TETPAIR_TIME_LEVEL)),
        "pair_apply_plain": median_ms(
            lambda: tk.pair_apply_torch(st.u, eng.W, *faces, N, P), 5),
        "pair_install": b78["b7_ms"],
        "pair_install_plain": b78["b7_plain_ms"],
        "pair_extract": b78["b8_ms"],
        "pair_extract_plain": b78["b8_plain_ms"],
        "tetpair_exchange_faces": median_ms(
            lambda: eng.exchange_faces(*fo), 10, batch=10),
        "tetpair_apply_ex": median_ms(lambda: eng.apply_ex(st), 10, batch=10),
        "tetpair_apply_full": median_ms(lambda: eng.apply_full(x), 10),
        "tetpair_classic_apply_raw": median_ms(lambda: op.apply_raw(x), 10,
                                               batch=10),
    })
    bounds["pair_apply"] = bound(*b6_work(eng, st, fo))
    # the earlier yardstick, printed beside it: the whole block read and
    # written once
    b6_whole_block_ms = bound(
        nbytes(st.u, eng.W, *faces) + nbytes(st.u, *fo),
        30 * 2 * eng.Cp * tet_points(N - 1))[0]
    # B7 reads the block where it keeps it and one face entry per
    # installed position, and writes the block; B8 reads its kept entries
    # and writes every face entry (b7_b8_timing)
    bounds["pair_install"] = bound(b78["b7_bytes"], 0)
    bounds["pair_extract"] = bound(b78["b8_bytes"], 0)
    lib_ms["pair_install"] = b78["b7_library_ms"]
    lib_ms["pair_extract"] = b78["b8_library_ms"]
    emit("tetpair_profile", card=card, level=TETPAIR_TIME_LEVEL,
         **tetpair_profile(eng, st))
    del sp, op, eng, x, st, faces, fo
    torch.cuda.empty_cache()

    # -- the structured box path (B1) -----------------------------------------
    box_errs = []
    for i, (m, level) in enumerate(BOX_CHECKS):
        box_errs.append(check_box_kernels(m, level, device, seed=10 + i))
        emit("box_kernels_vs_plain", card=card, **box_errs[-1])

    b1.box_apply.launches = 0
    box = {}
    for level in BOX_SLICE_LEVELS:
        box[level], levels, (u, b) = box_solve(level, device, BOX_CYCLES)
        emit("box_gmg_solve", card=card, **box[level])
    drop = (box[BOX_SLICE_LEVELS[0]]["max_nodal_error"]
            / box[BOX_SLICE_LEVELS[1]]["max_nodal_error"])
    launches["box_apply"] = b1.box_apply.launches
    emit("box_gmg_checks", error_drop=drop,
         launches={"box_apply": launches["box_apply"]})
    check(drop >= ERR_DROP_MIN,
          f"box nodal error dropped {drop}x from level {BOX_SLICE_LEVELS[0]} "
          f"to {BOX_SLICE_LEVELS[1]}, < {ERR_DROP_MIN}x")
    check(b1.box_apply.launches > 0, "box_apply was not launched on the box path")
    lvl = levels[0]
    ub = u.to(torch.bfloat16)
    box_t = {
        "box_apply_level7": median_ms(
            lambda: b1.box_apply(u, lvl.op.w_vecs, lvl.domain.dims), 10,
            batch=10),
        "box_apply_level7_plain": median_ms(
            lambda: b1.box_apply_torch(u, lvl.op.w_vecs, lvl.domain.dims), 10),
        "box_apply_bf16_level7": median_ms(
            lambda: b1.box_apply(ub, lvl.op.w_vecs, lvl.domain.dims), 10,
            batch=10),
        "box_apply_bf16_level7_plain": median_ms(
            lambda: b1.box_apply_torch(ub, lvl.op.w_vecs, lvl.domain.dims), 10),
        "box_apply_raw_level7": median_ms(lambda: lvl.op.apply_raw(u), 10,
                                          batch=10),
        "box_vcycle_level7": median_ms(
            lambda: box_gmg.vcycle(levels, u, b), 10),
    }
    box_dofs = {7: lvl.domain.num_dofs()}
    # the library call: conv3d with an interior lane's 15 weights (equal to
    # B1 on interior points only)
    X, Y, Z = lvl.domain.dims
    wv = lvl.op.w_vecs
    bounds["box_apply"] = bound(2 * nbytes(u) + nbytes(wv), 30 * u.numel())
    kern = conv3d_stencil(wv[0, :, Z + 1][None], kuhn.stencil_dirs())
    uv = u.view(1, 1, X, Y, Z)
    lib_ms["box_apply"] = median_ms(lambda: F.conv3d(uv, kern, padding=1), 10,
                                    batch=10)
    del levels, lvl, u, ub, b, wv, kern, uv
    torch.cuda.empty_cache()

    # 1e9 DoFs on one card: set-up, 6 cycles, then the time of a cycle
    torch.cuda.reset_peak_memory_stats()
    b1.box_apply.launches = 0
    big, levels, (u, b) = box_solve(BOX_BIG_LEVEL, device, BOX_BIG_CYCLES)
    big["launches"] = {"box_apply": b1.box_apply.launches}
    check(b1.box_apply.launches > 0, "box_apply was not launched at level 9")
    launches["box_apply"] += b1.box_apply.launches
    big["ms_per_vcycle"] = median_ms(
        lambda: box_gmg.vcycle(levels, u, b), 3, warmup=1)
    big["peak_bytes"] = torch.cuda.max_memory_allocated()
    big["peak_gb"] = big["peak_bytes"] / 1e9
    emit("box_gmg_1e9", card=card, **big)
    box_big_ref = {k: big[k] for k in ("residuals", "eig_max",
                                       "ms_per_vcycle")}
    box_t["box_vcycle_level9"] = big["ms_per_vcycle"]
    box_dofs[9] = big["dofs"]
    box_prof = cycle_profile(lambda: box_gmg.vcycle(levels, u, b),
                             big["ms_per_vcycle"], {"b1": ("box_apply_kernel",)})
    b1.box_apply.launches_by_rows.clear()
    box_gmg.vcycle(levels, u, b)
    level_of = {lvl.domain.dims[0]: lvl.domain.level for lvl in levels}
    b1_by_level = dict(sorted(
        (level_of[X], n) for X, n in b1.box_apply.launches_by_rows.items()))
    del levels, u, b
    torch.cuda.empty_cache()

    box_errs.append(check_box_kernels(BOX_M, BOX_BIG_LEVEL, device, seed=20))
    emit("box_kernels_vs_plain", card=card, **box_errs[-1])
    b1_bounds = {c["level"]: c["b1_bound_ms"] for c in box_errs
                 if c["m"] == list(BOX_M)}
    emit("box_profile_1e9", card=card, level=BOX_BIG_LEVEL, **box_prof,
         b1_launches_by_level=b1_by_level,
         b1_ms_lost_per_cycle=ms_lost(box_prof["kernels"]["b1"]["ms"],
                                      b1_by_level, b1_bounds))
    emit("b1_levels", card=card, level=sorted(b1_bounds),
         **{k: [c[k] for c in sorted(box_errs, key=lambda c: c["level"])
                if c["m"] == list(BOX_M)]
            for k in ("b1_ms", "b1_bound_ms", "b1_bf16_ms",
                      "b1_bf16_bound_ms")})
    from hyteg_tpu_torch.structured import BoxDomain, BoxStencilOperator
    dom = BoxDomain(BOX_M, BOX_BIG_LEVEL, device=device)
    w = BoxStencilOperator(dom).w_vecs
    u = torch.randn(dom.block_shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(3))
    box_t["box_apply_level9"] = median_ms(
        lambda: b1.box_apply(u, w, dom.dims), 5, batch=5)
    box_t["box_apply_level9_plain"] = median_ms(
        lambda: b1.box_apply_torch(u, w, dom.dims), 3, warmup=1)
    del dom, w, u
    torch.cuda.empty_cache()
    errs["box_apply"] = max(v for c in box_errs for k, v in c.items()
                            if k.startswith("b1_") and k.endswith("_max_abs_err"))
    errs_bf16 = max(v for c in box_errs for k, v in c.items()
                    if k.startswith("b1_bf16_") and k.endswith("_max_abs_err"))

    # -- the stream-copy probe (P1): the card's bandwidth ceiling -------------
    sizes = {"box_level7": box_dofs[7], "box_level9": box_dofs[9],
             "tet_level7_block": math.prod(tet_block),
             "tetpair_level7_block": tp_res["paired_slots"],
             "face_level11_block": arm2d["block_elements"]}
    p1_errs, p1_t = stream_probe(sizes, device)
    launches["stream_scale"] = p1.stream_scale.launches
    errs["stream_scale"] = max(p1_errs.values())
    gbps = {name: 8 * n / (p1_t[name][0] * 1e-3) / 1e9
            for name, n in sizes.items()}
    gbps_plain = {name: 8 * n / (p1_t[name][1] * 1e-3) / 1e9
                  for name, n in sizes.items()}
    emit("stream_probe", card=card, elements=sizes, max_abs_err=p1_errs,
         ms={k: v[0] for k, v in p1_t.items()},
         plain_ms={k: v[1] for k, v in p1_t.items()},
         gb_per_s=gbps, plain_gb_per_s=gbps_plain,
         launches=p1.stream_scale.launches,
         method="8 B per element, CUDA events, median of 10 runs of 10 "
                "back-to-back calls")
    check(p1.stream_scale.launches > 0, "stream_scale was not launched")

    # -- the dissection probes (P2): the B1 and B2 ladders ------------------
    from hyteg_tpu_torch import probes
    from hyteg_tpu_torch.kernels import probes as p2

    p2_checks = check_probe_kernels(storage, device, seed=90)
    emit("probe_kernels_vs_plain", card=card, rtol=PROBE_RTOL, **p2_checks)
    for name, part in (("box_variant", "box"), ("tet_stripped", "tet")):
        errs[name] = max(c["max_abs_err"] for c in p2_checks[part])
    p2.box_variant.launches = 0
    p2.tet_stripped.launches = 0
    ladder_rows = []
    for shape_set in probes.SHAPE_SETS:
        ladder_rows += probes.ladder(shape_set, device=device, card=card)
    for r in ladder_rows:
        emit("probe", **r)
    for line in probes.summary(ladder_rows):
        emit("probe_ladder", card=card, **line)
    p2_launches = {"box_variant": p2.box_variant.launches,
                   "tet_stripped": p2.tet_stripped.launches}
    emit("probe_checks", launches=p2_launches)
    for name, n in p2_launches.items():
        check(n > 0, f"{name} was not launched on the dissection path")
    launches.update(p2_launches)
    p2_ms, p2_work, p2_lib = probe_kernel_rows(device, ladder_rows)
    t.update(p2_ms)
    lib_ms.update(p2_lib)
    for name, (nb, fl) in p2_work.items():
        bounds[name] = bound(nb, fl)

    # -- the blended path (B2-2D, B2, B3) ------------------------------------
    blending = run_blending(device, card)
    emit("blend_checks", phase_s=blending["phase_s"],
         launches=blending["launches"])

    # -- the TerraNeo path (B5, B3, B2, B4; B5-2D, B3-2D) --------------------
    terraneo = run_terraneo(device, card)
    emit("terraneo_checks", phase_s=terraneo["phase_s"],
         launches=terraneo["launches"])

    # -- the sharded path (B2, B3, B5, B1), 4 shards on the one card -----------
    sharded = run_spmd(
        device, card,
        {"residuals": results[SLICE_LEVELS[-1]]["residuals"],
         "vcycle_ms": t["vcycle"]},
        stokes["ref3d"], box_big_ref)
    emit("spmd_checks", phase_s=sharded["phase_s"],
         launches=sharded["launches"])

    # -- A10: B2-bf16 / B3-bf16 and mixed precision, colored GS and FAS,
    # N1E1 with Hiptmair, DG1 and EG (B2, B3 in f32 and bf16) ---------------
    a10 = run_a10(storage, device, card,
                  results[SLICE_LEVELS[-1]]["residuals"])
    emit("a10_checks", phase_s=a10["phase_s"], launches=a10["launches"],
         f32_launches=a10["f32_launches"])

    # -- the bf16 P2 and 2D GMGs' kernels (B5, B5-2D, B2-2D, B3-2D in bf16)
    # against their plain versions at every level of their stacks; their
    # paths ran above (mixed_precision_p2, _2d, _p2_2d) --------------------
    bf16_rows = run_bf16_gmg_kernels(storage, device, card)
    torch.cuda.empty_cache()

    # -- the bf16 variable-coefficient path (B4, B4-2D, B3 and B3-2D with a
    # coefficient in bf16; B4 and B3 in f32 for the outer residual and the
    # f32 hierarchy) ---------------------------------------------------------
    coeff16 = run_bf16_coeff(storage, device, card)
    emit("bf16_coeff_checks", phase_s=coeff16["phase_s"],
         launches={k: v["launches"] for k, v in coeff16["rows"].items()},
         f32_launches=coeff16["f32_launches"])
    torch.cuda.empty_cache()

    # -- the AMR path: red-green refinement, transfer, the refined-mesh GMG
    # (B2, B3, B2-2D, B3-2D), IO, the native setup core ---------------------
    amr = run_amr(device, card)
    torch.cuda.empty_cache()

    t.update(box_t)
    t["stream_scale"], t["stream_scale_plain"] = p1_t["box_level9"]
    dofs = {"p1_const_apply": tet_dofs, "p1_diagonal_local": tet_dofs,
            "apply_raw": tet_dofs, "vcycle": tet_dofs}
    dofs.update({k: tp_res["global_dofs"] for k in t
                 if k.startswith(("pair_", "tetpair_"))})
    b6_gbps = 8 * tp_res["paired_slots"] / (t["pair_apply"] * 1e-3) / 1e9
    for k in t:
        for lv in (7, 9):
            if k.startswith("box_") and f"level{lv}" in k:
                dofs[k] = box_dofs[lv]
    emit("timings", card=card, tet_level=level, tet_global_dofs=tet_dofs,
         tet_block=tet_block, box_dofs=box_dofs, ms=t,
         gdofs_per_s={k: dofs[k] / (v * 1e-3) / 1e9 for k, v in t.items()
                      if k in dofs and "vcycle" not in k},
         stream_gb_per_s=gbps, tetpair_paired_block=tp_res["paired_block"],
         b6_gb_per_s_at_8_bytes_per_slot=b6_gbps,
         b6_share_of_p1=b6_gbps / gbps["tetpair_level7_block"],
         method="CUDA events after 1-3 warm-up calls; kernels and applies: "
                "median of 5-10 runs of 5-10 back-to-back calls; plain "
                "versions and V-cycles: median of 3-20 single calls")

    timed = {"p1_const_apply": "p1_const_apply",
             "p1_diagonal_local": "p1_diagonal_local",
             "box_apply": "box_apply_level7", "stream_scale": "stream_scale",
             "pair_apply": "pair_apply", "pair_install": "pair_install",
             "pair_extract": "pair_extract",
             "p1_apply_local": "p1_apply_local",
             "p2_const_apply": "p2_const_apply",
             "box_variant": "box_variant", "tet_stripped": "tet_stripped"}
    n = sizes["box_level9"]
    bounds["stream_scale"] = bound(8 * n, n)
    lib_ms["stream_scale"] = t["stream_scale_plain"]
    # the same bound against P1's rate measured on the kernel's block size
    p1_size = {"box_apply": "box_level7", "stream_scale": "box_level9",
               "pair_apply": "tetpair_level7_block",
               "pair_install": "tetpair_level7_block",
               "pair_extract": "tetpair_level7_block",
               "box_variant": "box_level7"}
    for name, (nb, fl) in arm2d["work"].items():
        bounds[name] = bound(nb, fl)
        p1_size[name] = "face_level11_block"
        timed[name] = name
    t.update(arm2d["ms"])
    errs.update(arm2d["errs"])
    launches.update(arm2d["launches"])
    lib_ms.update(arm2d["library_ms"])
    extra = {"box_apply": {
        "max_abs_err_bf16": errs_bf16, "ms_level9": t["box_apply_level9"],
        "plain_ms_level9": t["box_apply_level9_plain"],
        "bound_ms_level9": b1_bounds[BOX_BIG_LEVEL]},
        "p1_diagonal_local": {"ms_coeff": b3_coeff_ms,
                              "bound_ms_coeff": b3_coeff_bound[0]},
        "p1_apply_local": {"ms_by_mode": b4_coeff["3d"]["ms"],
                           "bound_ms_no_coeff": b4_coeff["3d"]["bound_ms_none"]},
        "p1_apply_local_2d": {
            "ms_by_mode": b4_coeff["2d"]["ms"],
            "bound_ms_no_coeff": b4_coeff["2d"]["bound_ms_none"]},
        "p1_diagonal_local_2d": {
            "ms_coeff": arm2d["b3_coeff"]["ms"],
            "bound_ms_coeff": arm2d["b3_coeff"]["bound_ms"]},
        "pair_apply": {
            "ms_by_case": b6_cases,
            "bound_ms_whole_block": b6_whole_block_ms},
        "pair_install": {
            "graph_ms": b78["b7_graph_ms"],
            "library_graph_ms": b78["b7_library_graph_ms"],
            "bound_ms_whole_arrays": b78["b7_bound_ms_whole_arrays"],
            "launches_per_apply_full": tp_res["launches_per_apply_full"][
                "pair_install"],
            "ms_by_case": [{k: c[k] for k in (
                "mesh", "level", "b7_ms", "b7_graph_ms", "b7_bound_ms",
                "b7_bound_ms_whole_arrays", "b7_library_ms",
                "b7_library_graph_ms")} for c in b78_cases]},
        "pair_extract": {
            "graph_ms": b78["b8_graph_ms"],
            "library_graph_ms": b78["b8_library_graph_ms"],
            "take_fill_graph_ms": b78["b8_take_fill_graph_ms"],
            "bound_ms_whole_arrays": b78["b8_bound_ms_whole_arrays"],
            "sector_floor_ms": b78["b8_sector_floor_ms"],
            "launches_per_apply_full": tp_res["launches_per_apply_full"][
                "pair_extract"],
            "ms_by_case": [{k: c[k] for k in (
                "mesh", "level", "b8_ms", "b8_graph_ms", "b8_bound_ms",
                "b8_bound_ms_whole_arrays", "b8_sector_floor_ms",
                "b8_library_ms", "b8_library_graph_ms",
                "b8_take_fill_graph_ms")} for c in b78_cases]}}
    # the Stokes path's launches of B5 / B3 (3D and 2D) join the counts of
    # the earlier paths that launch them
    for name, n in stokes["launches"].items():
        extra.setdefault(name, {})["launches_by_path"] = {
            "earlier_paths": launches[name], "stokes": n}
        launches[name] += n
    for name, e in stokes["errs"].items():
        errs[name] = max(errs[name], e)
    # and the blended path's launches of B2-2D, B2 and B3
    for name, n in blending["launches"].items():
        by_path = extra.setdefault(name, {}).setdefault(
            "launches_by_path", {"earlier_paths": launches[name]})
        by_path["blending"] = n
        launches[name] += n
    for name, e in blending["errs"].items():
        errs[name] = max(errs[name], e)
    # and the TerraNeo path's launches of B5, B3, B2, B4 (and 2D forms)
    for name, n in terraneo["launches"].items():
        by_path = extra.setdefault(name, {}).setdefault(
            "launches_by_path", {"earlier_paths": launches[name]})
        by_path["terraneo"] = n
        launches[name] += n
    for name, e in terraneo["errs"].items():
        errs[name] = max(errs[name], e)
    # and the sharded path's launches of B2, B3, B5 and B1
    for name, n in sharded["launches"].items():
        by_path = extra.setdefault(name, {}).setdefault(
            "launches_by_path", {"earlier_paths": launches[name]})
        by_path["spmd"] = n
        launches[name] += n
    # and the A10 path's: B2 / B3 in f32, and their bf16 forms' own rows
    for name, n in a10["f32_launches"].items():
        by_path = extra.setdefault(name, {}).setdefault(
            "launches_by_path", {"earlier_paths": launches[name]})
        by_path["a10"] = n
        launches[name] += n
    t.update(a10["ms"])
    bounds.update(a10["bounds"])
    lib_ms.update(a10["library_ms"])
    errs.update(a10["errs"])
    launches.update(a10["launches"])
    for name in a10["launches"]:
        timed[name] = name
        extra[name] = {"storage": "bf16", "level": MP_LEVEL,
                       "ulp_excess": a10["ulp_excess"][name]}
    # and the bf16 GMGs' paths: the bf16 kernels' own rows (launched on the
    # three mixed-precision paths), the f32 residual's launches by path
    for path, mp in mixed.items():
        for name, n in mp["f32_launches"].items():
            by_path = extra.setdefault(name, {}).setdefault(
                "launches_by_path", {"earlier_paths": launches[name]})
            by_path[path] = n
            launches[name] += n
    for name, row in bf16_rows.items():
        t[name], t[name + "_plain"] = row["ms"], row["plain_ms"]
        bounds[name], lib_ms[name] = row["bound"], row["library_ms"]
        errs[name], timed[name] = row["max_abs_err"], name
        launches[name] = sum(mp["launches"].get(name, 0)
                             for mp in mixed.values())
        if "_2d" in name:
            p1_size[name] = "face_level11_block"
        extra[name] = {"label": BF16_LABELS[name], "storage": "bf16",
                       "level": row["level"], "ulp_excess": row["ulp_excess"],
                       "launches_by_path": {
                           path: mp["launches"][name]
                           for path, mp in mixed.items()
                           if name in mp["launches"]}}
    # and the bf16 coefficient path's: its four bf16 rows, the f32 launches
    # of B4 and B3 (3D, 2D) by path
    for name, by in coeff16["f32_launches"].items():
        by_path = extra.setdefault(name, {}).setdefault(
            "launches_by_path", {"earlier_paths": launches[name]})
        by_path.update(by)
        launches[name] += sum(by.values())
    for name, row in coeff16["rows"].items():
        t[name], t[name + "_plain"] = row["ms"], row["plain_ms"]
        bounds[name], lib_ms[name] = row["bound"], None
        errs[name], timed[name] = row["max_abs_err"], name
        launches[name] = row["launches"]
        if "_2d" in name:
            p1_size[name] = "face_level11_block"
        extra[name] = {"label": BF16_LABELS[name], "storage": "bf16",
                       "level": row["level"], "ulp_excess": row["ulp_excess"],
                       "ms_by_mode": row["ms_by_mode"],
                       "launches_by_path": row["launches_by_path"]}
    # and the AMR path's launches of B2, B3, B2-2D and B3-2D
    for name, n in amr["launches"].items():
        by_path = extra.setdefault(name, {}).setdefault(
            "launches_by_path", {"earlier_paths": launches[name]})
        by_path["amr"] = n
        launches[name] += n
    for name, e in amr["errs"].items():
        errs[name] = max(errs[name], e)
    kernels = []
    for name, (src, rep) in REPLACES.items():
        ms, by, nb, fl = bounds[name]
        p1_rate = gbps[p1_size.get(name, "tet_level7_block")] * 1e9
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": t[timed[name]], "plain_ms": t[timed[name] + "_plain"],
            "bound_ms": ms, "bound_by": by, "bytes": nb, "operations": fl,
            "bound_ms_at_p1_rate": bound(nb, fl, p1_rate)[0],
            "library_ms": lib_ms.get(name),
            "library_call": LIBRARY_CALLS[name], **extra.get(name, {})})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
