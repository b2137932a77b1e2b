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
  level 5, B6 timed beside its bound at each (``b6_levels``), with a
  torch.profiler breakdown of chained applies at level 7;
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

import json
import math
import re
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from hyteg_tpu_torch.core.benchtime import card as smi_card
from hyteg_tpu_torch.core.benchtime import median_ms

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
}
# the one PyTorch call timed beside each kernel (library_ms), or why none
LIBRARY_CALLS = {
    "p1_const_apply": "F.conv3d grouped per cell, interior stencil (equal to "
                      "B2 on interior points only), cuDNN TF32 off",
    "p1_diagonal_local": None,  # no library call builds an FE diagonal
    "box_apply": "F.conv3d, an interior lane's 15 weights (equal to B1 on "
                 "interior points only), cuDNN TF32 off",
    "stream_scale": "torch.mul(src, 2.0, out=dst)",
    "pair_apply": None,    # a fused install + apply + extract: no such call
    "pair_install": None,  # a masked select chain over face planes
    "pair_extract": None,  # strided face-plane copies
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
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    from hyteg_tpu_torch.indexing import micro
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
            read = simplex_read_bytes(sp, micro.stencil_directions(dim),
                                      x.shape[0])
            # a multiply-add per direction at each simplex slot
            points = tet_points(sp.n) if dim == 3 else tri_points(sp.n)
            out["b2_bound_ms"] = bound(
                nbytes(x) + read + nbytes(A, E),
                2 * (15 if dim == 3 else 7) * x.shape[0] * points)[0]
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


def solve(storage, level: int, device,
          gate_rate: bool = True) -> tuple[dict, object, tuple]:
    """The main path: GMG stack set-up plus N_CYCLES V-cycles (the rate
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
    for _ in range(N_CYCLES):
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
    tol = ref.float().abs_().mul_(B1_BF16_ULP).add_(B1_RTOL * scale)
    d = yb.float().sub_(ref.float()).abs_()
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
        err = max_abs_diff(tk.pair_install(st.u, *faces, N, P),
                           tk.pair_install_torch(st.u, *faces, N, P))
        check(err == 0.0, f"B7 {name} level {level}: max|d| {err} != 0")
        out[f"b7_{name}_max_abs_err"] = err
        for blk, u in (("packed", eng.pack(x)), ("applied", st.u)):
            err = max(max_abs_diff(g, r) for g, r in zip(
                tk.pair_extract(u, N, P), tk.pair_extract_torch(u, N, P)))
            check(err == 0.0, f"B8 {name} level {level} {blk}: max|d| {err} != 0")
            out[f"b8_{name}_{blk}_max_abs_err"] = err
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
    mask = sp.vertex_mask_t
    full = rel_err(eng.apply_full(x) * mask, op.apply_raw(x) * mask)
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
           "setup_s": setup_s}
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
    n, L = N - 1, N * P
    plan = tp.PairPlan(N, P)
    M = torch.as_tensor(plan.in_a | plan.in_b)[None].float()
    need = torch.zeros(M.shape, dtype=torch.bool)
    for d in tp.dir_tables()[0]:
        need |= flat.shift_write(M, [int(v) for v in d], P, 3) != 0
    need = need[0].numpy().reshape(N, N, P)
    x, ly, lz = np.meshgrid(np.arange(N), np.arange(N), np.arange(P),
                            indexing="ij")
    s = x + ly + lz
    in_a, in_b = s <= n, (s >= 2 * n) & (lz <= n)
    l = ly * P + lz
    # pair_source's choice, lowest precedence first: the entry of the
    # face arrays (xf, yf, zf, df laid end to end), -1 for the block
    yf0, zf0 = 2 * L, 2 * L + 2 * N * P
    df0 = zf0 + 2 * N * N
    src = np.full(need.shape, -1, dtype=np.int64)
    for cond, entry in (
            ((s == 2 * n) & (lz <= n), df0 + L + l),
            (s == n, df0 + l),
            ((lz == n) & in_b, zf0 + (N + x) * N + ly),
            ((lz == 0) & in_a, zf0 + x * N + ly),
            ((ly == n) & in_b, yf0 + (N + x) * P + lz),
            ((ly == 0) & in_a, yf0 + x * P + lz),
            ((x == n) & (s >= 2 * n), L + l),
            ((x == 0) & in_a, l)):
        src = np.where(cond, entry, src)
    picked = src[need]
    face_entries = np.unique(picked[picked >= 0]).size
    return eng.Cp * (int((picked < 0).sum()) + face_entries) * 4


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


def simplex_read_bytes(sp, dirs, C: int) -> int:
    """Bytes of one f32 input block of ``sp`` (C cells) that a stencil over
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
    return C * int(read.sum()) * 4


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


def cycle_profile(cycle, cycle_ms: float, kernels: dict) -> dict:
    """torch.profiler over one V-cycle (``cycle()``) after two warm-up
    cycles: device
    time, the idle share of the cycle (1 - device kernel time /
    ``cycle_ms``, the cycle's CUDA-event time from the same run: the
    profiled window's host wall, reported beside it, carries the
    profiler's own overhead), the ms and launches of each group in
    ``kernels`` (name -> substrings, any of which in the lower-cased CUDA
    symbol puts a kernel in it), and the top 12 by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        cycle()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cycle()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(r[1] for r in rows)
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
    work["p1_const_apply_2d"] = (
        nbytes(x) + simplex_read_bytes(sp, micro.stencil_directions(2), C)
        + nbytes(A, E), 14 * C * tri_points(sp.n))
    work["p1_diagonal_local_2d"] = (nbytes(elm) + nbytes(x), 3 * C * sum(
        tri_points(sp.n - int(m)) for m in margins))
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
    del stack, sp, op, A, E, elm, x, b, xv, kern, prof
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
    # per element: 9 multiply-adds, the 3-term mean and 3 scalings
    work["p1_apply_local_2d"] = (
        nbytes(x) + 2 * simplex_read_bytes(sp, [(0, 0)], C) + nbytes(elm),
        24 * C * sum(
        tri_points(sp.n - int(m)) for m in margins))
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
    row, K0 = b5._row_index(P2_LEVEL_2D, 2, sp.pitch, torch.float32, device)
    hist = torch.bincount(row[K0 > 0], minlength=W.shape[1]).double()
    work["p2_const_apply_2d"] = (
        nbytes(x) + simplex_read_bytes(sp, b5._kernel_dirs(2), x.shape[0])
        + nbytes(W), 2 * (
        (W != 0).sum(-1).double() @ hist).sum().item())
    del stack, sp, op, W, x, b, row, K0, hist
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
            "b4_coeff": b4_coeff, "b3_coeff": b3_coeff}


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
        "p1_const_apply": bound(
            nbytes(x) + simplex_read_bytes(sp, micro.stencil_directions(3), C)
            + nbytes(A, E), 30 * C * tet_points(sp.n)),
        "p1_diagonal_local": bound(nbytes(elm) + nbytes(x), 4 * C * sum(
            tet_points(sp.n - int(m)) for m in micro.base_margin(3)))}
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
    # per element: 16 multiply-adds, the 4-term mean and 4 scalings
    # x and k are read on the tet's slots only
    bounds["p1_apply_local"] = bound(
        nbytes(x) + 2 * simplex_read_bytes(sp, [(0, 0, 0)], sp.C_loc)
        + nbytes(elm), 40 * sp.C_loc * sum(
            tet_points(sp.n - int(m)) for m in micro.base_margin(3)))
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
    row, K0 = b5._row_index(P2_LEVEL, 3, PITCH, torch.float32, device)
    hist = torch.bincount(row[K0 > 0], minlength=W.shape[1]).double()
    b5_flops = 2 * ((W != 0).sum(-1).double() @ hist).sum().item()
    bounds["p2_const_apply"] = bound(
        nbytes(x) + simplex_read_bytes(sp, b5._kernel_dirs(3), x.shape[0])
        + nbytes(W), b5_flops)
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
    del stack, sp, op, W, x, b, row, K0, hist, ones, k
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
    b4_coeff["2d"] = arm2d["b4_coeff"]
    emit("b4_coeff", card=card, **b4_coeff)

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
    b6_cases = []
    for i, (mesh, level) in enumerate(TETPAIR_CASES):
        res, objs = tetpair_apply(storages[mesh], level, device, seed=40 + i)
        emit("tetpair_apply", card=card, mesh=mesh, **res)
        # B6 timed beside its bound at this case; the timing's launches
        # are not the main path's
        counts = {name: getattr(tk, name).launches for name in tp_names}
        b6_cases.append({"mesh": mesh, "level": level,
                         **b6_timing(objs[2], objs[3])})
        for name, n in counts.items():
            getattr(tk, name).launches = n
        if (mesh, level) == ("cube", TETPAIR_TIME_LEVEL):
            tp_res, (sp, op, eng, x) = res, objs
        del objs
        torch.cuda.empty_cache()
    emit("b6_levels", card=card, cases=b6_cases)
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
        "pair_install": median_ms(
            lambda: tk.pair_install(st.u, *faces, N, P), 10, batch=10),
        "pair_install_plain": median_ms(
            lambda: tk.pair_install_torch(st.u, *faces, N, P), 10),
        "pair_extract": median_ms(
            lambda: tk.pair_extract(st.u, N, P), 10, batch=10),
        "pair_extract_plain": median_ms(
            lambda: tk.pair_extract_torch(st.u, N, P), 10),
        "tetpair_exchange_faces": median_ms(
            lambda: eng.exchange_faces(*fo), 10, batch=10),
        "tetpair_apply_ex": median_ms(lambda: eng.apply_ex(st), 10, batch=10),
        "tetpair_apply_full": median_ms(lambda: eng.apply_full(x), 10),
        "tetpair_classic_apply_raw": median_ms(lambda: op.apply_raw(x), 10,
                                               batch=10),
    })
    # B8 only copies face planes out of the block: its least bytes are
    # those planes, read once and written once
    bounds["pair_apply"] = bound(*b6_work(eng, st, fo))
    # the earlier yardstick, printed beside it: the whole block read and
    # written once
    b6_whole_block_ms = bound(
        nbytes(st.u, eng.W, *faces) + nbytes(st.u, *fo),
        30 * 2 * eng.Cp * tet_points(N - 1))[0]
    bounds["pair_install"] = bound(2 * nbytes(st.u) + nbytes(*faces), 0)
    bounds["pair_extract"] = bound(2 * nbytes(*tk.pair_extract(st.u, N, P)), 0)
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
            "bound_ms_whole_block": b6_whole_block_ms}}
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
