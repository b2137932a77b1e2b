"""Mixed-precision iterative refinement; torch counterpart of
hyteg_tpu/solvers/refinement.py.

Reference: tests/hyteg/mixedPrecision/mixedPrecisionIterativeRefinement.cpp
(function spaces templated on ValueType, refined in higher precision).
The split: bfloat16 for the bandwidth-bound inner solver (half the bytes
of every stencil sweep: kernels B2 and B3 in their bf16 forms on the
card) and float32 for the outer residual and accumulation:

    r_k = b - A x_k            (f32 apply)
    d_k = solve_lo(r_k)        (bf16 inner solver, approximate)
    x_{k+1} = x_k + d_k        (f32 update)

which recovers f32-level accuracy as long as the inner solve reduces the
error by a fixed factor. The JAX package's ``lax.fori_loop`` is a plain
loop here.
"""

from __future__ import annotations

from typing import Callable

import torch


def iterative_refinement(
    apply_hi: Callable,
    inner_solve_lo: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    num_outer: int,
    lo_dtype=torch.bfloat16,
) -> torch.Tensor:
    """x <- x + up( inner_solve_lo( down(b - A x) ) ), ``num_outer`` times.

    ``inner_solve_lo`` maps a lo-precision residual block to a
    lo-precision correction (e.g. V-cycles or smoother sweeps built on a
    lo-dtype space)."""
    hi = b.dtype
    x = x0
    for _ in range(num_outer):
        r = b - apply_hi(x)
        d = inner_solve_lo(r.to(lo_dtype))
        x = x + d.to(hi)
    return x
