#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hyteg_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from hyteg_tpu_torch/csrc, checks each one
against its plain PyTorch version on the card, drives the main path —
a P1 Laplace GMG solve (Chebyshev smoothing, fixed-iteration CG coarse
solve) on the 48-cell unit-cube macro mesh at levels 6 and 7 — and times
the kernels, the operator apply and one V-cycle with CUDA events. Prints
one JSON line per phase; the last line is
{"ok": true, "device": {"platform": "gpu", ...}}. Any failed check raises,
so the exit code is non-zero and no result line is printed. Refuses to run
without CUDA. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

MESH_N = 2            # mesh_unit_cube(2): 48 macro-tets
CHECK_LEVELS = (4, 7)
SLICE_LEVELS = (6, 7)
PITCH = (1 << 7) + 1  # one lane pitch for every level, as a GMG stack uses
N_CYCLES = 8
MIN_LEVEL = 2
COARSE_ITERS = 30
B2_RTOL = 1e-5        # f32, 15-term sums taken in another order
B3_RTOL = 1e-6        # f32, <= 24-term sums taken in another order
RATE_MAX = 0.2        # geometric-mean residual reduction over cycles 1-4
ERR_DROP_MIN = 3.0    # O(h^2) predicts 4; f32 rounding eats into level 7
REPLACES = {
    "p1_const_apply": ("hyteg_tpu_torch/csrc/p1_const_stencil.cu",
                       "hyteg_tpu/kernels/p1_const_stencil.py:746"),
    "p1_diagonal_local": ("hyteg_tpu_torch/csrc/p1_diag.cu",
                          "hyteg_tpu/kernels/p1_stencil.py:303"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def median_ms(fn, runs: int, warmup: int = 3) -> float:
    """Median over ``runs`` of the device time of one call, from CUDA
    events around each call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sol(p):
    return (torch.sin(math.pi * p[..., 0]) * torch.sin(math.pi * p[..., 1])
            * torch.sin(math.pi * p[..., 2]))


def check_kernels(storage, level: int, device, seed: int) -> dict:
    """Kernels B2 and B3 against their plain versions at one level."""
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.kernels import p1_stencil as b3
    from hyteg_tpu_torch.operators import forms
    from hyteg_tpu_torch.operators.averaging import MODES
    from hyteg_tpu_torch.operators.p1_elementwise import compute_elmats

    sp = P1Space(storage, level, device=device, pitch=PITCH)
    gen = torch.Generator(device=device).manual_seed(seed)
    outside = ~sp.vertex_mask_t.bool()
    out = {"level": level, "block": list(sp.block_shape),
           "global_dofs": sp.num_global_dofs()}
    cv = sp.resolve_sd().cell_vertices
    for name, form in (("laplace", forms.laplace_form),
                       ("mass", forms.mass_form)):
        elm = compute_elmats(sp, form, cv).contiguous()
        A = b2.stencil_weights(elm, 3).contiguous()
        E = b2.face_weights_full(elm, 3).contiguous()
        x = torch.randn(sp.block_shape, generator=gen, device=device)
        x *= sp.vertex_mask_t
        y = b2.p1_const_apply(x, A, E, level, 3, PITCH)
        y_ref = b2.p1_const_apply_torch(x, A, level, 3, PITCH, E=E)
        err = (y - y_ref).abs().max().item()
        scale = y_ref.abs().max().item()
        check(math.isfinite(err) and err <= B2_RTOL * scale,
              f"B2 {name} level {level}: max|dy| {err} > {B2_RTOL} * {scale}")
        check(not y[:, outside].any().item(),
              f"B2 {name} level {level}: nonzero outside the tet / padding")
        out[f"b2_{name}_max_abs_err"] = err
        out[f"b2_{name}_max_abs"] = scale
        del x, y, y_ref
        # B3: diagonal (Laplace and mass), lumped (mass; Laplace row sums
        # vanish), and the coefficient modes at the small level only
        cases = [(False, None, "arithmetic"), (True, None, "arithmetic")]
        if level == CHECK_LEVELS[0]:
            co = torch.rand(sp.block_shape, generator=gen, device=device)
            co = (0.5 + 1.5 * co) * sp.vertex_mask_t
            cases += [(lumped, co, m) for lumped in (False, True)
                      for m in MODES]
        for lumped, co, mode in cases:
            if lumped and name == "laplace":
                continue
            d = b3.p1_diagonal_local(elm, level, 3, PITCH, lumped, co, mode)
            d_ref = b3.p1_diagonal_local_torch(elm, level, 3, PITCH, lumped,
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
    mass = P1ElementwiseOperator(sp, forms.mass_form)
    x0 = sp.interpolate(sol, sp.zeros(), DoFType.DIRICHLET, bc)
    f = sp.interpolate(lambda p: 3 * math.pi ** 2 * sol(p), sp.zeros(),
                       DoFType.ALL, bc)
    b = sp.restore_rows(mass.apply_raw(f), sp.zeros(), FLAG_INNER, bc)
    u = sp.interpolate(sol, sp.zeros(), DoFType.ALL, bc)
    return x0, b, u


def solve(storage, level: int, device) -> tuple[dict, object, tuple]:
    """The main path: GMG stack set-up plus N_CYCLES V-cycles."""
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
    check(rate <= RATE_MAX, f"level {level}: residual rate {rate} > {RATE_MAX}")
    out = {"level": level, "global_dofs": sp.num_global_dofs(),
           "residuals": res, "rate_cycles_1_4": rate, "max_nodal_error": err,
           "setup_s": setup_s, "solve_s_incl_residual_norms": solve_s,
           "eigs": stack.eigs}
    return out, stack, (x, b)


def main() -> int:
    from hyteg_tpu_torch.kernels import build

    if not build.cuda_available():
        print("chip_smoke: torch sees no CUDA device; this test needs one "
              "GPU", file=sys.stderr)
        return 1
    from hyteg_tpu_torch.kernels import p1_const_stencil as b2
    from hyteg_tpu_torch.kernels import p1_stencil as b3
    from hyteg_tpu_torch.mesh.meshinfo import mesh_unit_cube
    from hyteg_tpu_torch.primitives.storage import CellStorage

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)

    so, build_s, log = build.build()
    build.library()
    emit("build", seconds=build_s, library=str(so.relative_to(build.PKG_DIR.parent)),
         ptxas=[l.strip() for l in log.splitlines()
                if "registers" in l or "spill" in l])

    storage = CellStorage(mesh_unit_cube(MESH_N))
    for i, level in enumerate(CHECK_LEVELS):
        checked = check_kernels(storage, level, device, seed=i)
        emit("kernels_vs_plain", card=card, **checked)
        torch.cuda.empty_cache()
    errs = {name: max(v for k, v in checked.items()
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
    dofs = sp.num_global_dofs()
    A, E, elm = op.stencil, op.stencil_face, op.elmats
    t = {
        "p1_const_apply": median_ms(
            lambda: b2.p1_const_apply(x, A, E, level, 3, sp.pitch), 30),
        "p1_const_apply_plain": median_ms(
            lambda: b2.p1_const_apply_torch(x, A, level, 3, sp.pitch, E=E), 20),
        "p1_diagonal_local": median_ms(
            lambda: b3.p1_diagonal_local(elm, level, 3, sp.pitch), 30),
        "p1_diagonal_local_plain": median_ms(
            lambda: b3.p1_diagonal_local_torch(elm, level, 3, sp.pitch), 20),
        "apply_raw": median_ms(lambda: op.apply_raw(x), 30),
        "vcycle": median_ms(lambda: stack.gmg.cycle(x, b), 20),
    }
    emit("timings", card=card, level=level, global_dofs=dofs,
         block=list(sp.block_shape), ms=t,
         gdofs_per_s={k: dofs / (v * 1e-3) / 1e9 for k, v in t.items()
                      if k != "vcycle"},
         method="CUDA events, median of 20-30 runs after 3 warm-up runs")

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": errs[name], "ms": t[name],
                "plain_ms": t[name + "_plain"]}
               for name, (src, rep) in REPLACES.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
