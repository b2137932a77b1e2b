"""The inexact-Uzawa smoother and the Stokes GMG stack of the PyTorch port
(hyteg_tpu_torch/solvers/uzawa.py) against the JAX package's
(hyteg_tpu/solvers/uzawa.py), on mesh_rectangle 2 x 2 (this file) and
mesh_unit_cube(1) (tests/test_torch_stokes_gmg_3d.py runs these tests
there, on another worker), P2 levels 1-2, V(3,3), omega_p 0.4
(tests/test_stokes.py:157), MINRES on level 1 with make_stokes_gmg's
default of at most 80 steps, as chip_smoke.py runs it.

Both stacks take the JAX package's eigenvalue estimate of level 2 (its
power iteration draws from jax.random, which the port cannot reproduce;
the port's own estimate, from a torch.Generator, is held to it within
5%); level 1 is the coarse level, whose smoother a V-cycle never runs.
The JAX stack runs as its own CPU tests run it, its smoother, apply,
transfers and coarse solve each jitted once. The right-hand side is b = A
x* for a seeded random consistent x*, so both packages solve the same
consistent system.

Tolerances (float32): one smoother sweep within 1e-5 * max|x|; the
residual norms of six V-cycles within 1e-3 relative, cycle by cycle.

Run as a script, the file prints both packages' V-cycle rates on A x = 0
at a size of one's choosing (the JAX cycle jitted whole; minutes):

    JAX_PLATFORMS=cpu python -m tests.test_torch_stokes_gmg rect4 1 6
    JAX_PLATFORMS=cpu python -m tests.test_torch_stokes_gmg cube2 1 3
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from hyteg_tpu.solvers import uzawa as juzawa
from hyteg_tpu_torch.core.types import FLAG_INNER
from hyteg_tpu_torch.solvers.uzawa import UzawaSmoother, make_stokes_gmg

from tests.test_torch_stokes import (MESHES, assert_vec_close, rand_vec,
                                     storages, to_jax)

torch.set_num_threads(1)

KW = dict(pre_smooth=3, post_smooth=3, omega_p=0.4)
CYCLES = 6


def _repeat_smooth(smooth, x, b, count):
    for _ in range(count):
        x = smooth(x, b)
    return x


def _jit_levels(gmg):
    """Jit each callable of a JAX GMG stack once (a jit of the whole
    V-cycle takes minutes to compile in 3D) and repeat the jitted smoother
    in a Python loop: called outside jit, the package's scan over the
    smoothing steps would trace and compile anew at every call."""
    gmg._repeat_smooth = _repeat_smooth
    for l, L in gmg.levels.items():
        gmg.levels[l] = dataclasses.replace(
            L, smooth=jax.jit(L.smooth), apply=jax.jit(L.apply),
            restrict=L.restrict and jax.jit(L.restrict),
            prolongate_add=L.prolongate_add and jax.jit(L.prolongate_add))
    gmg.coarse_solve = jax.jit(gmg.coarse_solve)
    return gmg


def make_stacks(name):
    """Yield (JAX stokes, JAX gmg, port stack, eigs) for one mesh, then
    drop the JAX programs compiled for it."""
    js, ts = storages(name)
    jstokes, _ = juzawa.make_stokes_gmg(js, 2, 2, eigs={2: 1.0}, **KW)
    eig = float(jax.jit(lambda: juzawa.UzawaSmoother(
        jstokes[2], omega_p=KW["omega_p"]).eig_max)())
    # the coarsest level's smoother never runs in a V-cycle (MINRES there)
    eigs = {1: eig, 2: eig}
    jstokes, jgmg = juzawa.make_stokes_gmg(js, 1, 2, eigs=eigs, **KW)
    stack = make_stokes_gmg(ts, 1, 2, eigs=eigs, device="cpu", **KW)
    yield jstokes, _jit_levels(jgmg), stack, eigs
    jax.clear_caches()


@pytest.fixture(scope="module")
def stacks():
    yield from make_stacks("rect")


def test_eigs_carried_and_estimated(stacks):
    """The port keeps the eigs it was given; its own power iteration (20
    steps from a seeded torch.Generator) lands within 5% of the JAX
    package's (jax.random start)."""
    jstokes, _, stack, eigs = stacks
    assert stack.eigs == eigs
    st = stack.stokes[2]
    gen = torch.Generator().manual_seed(2)
    own = UzawaSmoother(st, omega_p=KW["omega_p"], generator=gen).eig_max
    assert abs(own - eigs[2]) <= 0.05 * eigs[2], (own, eigs[2])


def test_uzawa_sweep(stacks):
    jstokes, jgmg, stack, _ = stacks
    st = stack.stokes[2]
    x, b = rand_vec(st, 20), st.apply_inner(rand_vec(st, 21))
    y = stack.smoothers[2](x, b)
    jy = jgmg.levels[2].smooth(to_jax(x), to_jax(b))
    assert_vec_close(y, jy, 1e-5, "Uzawa sweep")
    # velocity rows outside the flag keep x's values; pressure masked
    for d in range(st.dim):
        keep = st.vel_space.restore_rows(torch.zeros_like(y.vel[d]),
                                         y.vel[d], FLAG_INNER, st._vel_sd)
        want = st.vel_space.restore_rows(torch.zeros_like(x.vel[d]),
                                         x.vel[d], FLAG_INNER, st._vel_sd)
        assert torch.equal(keep, want)
    assert not y.pre[:, ~st.pre_space.vertex_mask_t.bool()].any()


def test_gmg_cycles_match(stacks):
    jstokes, jgmg, stack, _ = stacks
    st, jst = stack.stokes[2], jstokes[2]
    b = st.apply_inner(rand_vec(st, 22))
    jb = to_jax(b)
    x, jx = st.zeros(), jst.zeros()
    japply = jgmg.levels[2].apply  # jitted apply_inner
    norms = [float(st.norm(b - st.apply_inner(x)))]
    jnorms = [float(jst.norm(jb - japply(jx)))]
    for _ in range(CYCLES):
        x = stack.gmg.cycle(x, b)
        jx = jgmg.cycle(jx, jb)
        norms.append(float(st.norm(b - st.apply_inner(x))))
        jnorms.append(float(jst.norm(jb - japply(jx))))
    assert all(np.isfinite(norms)), norms
    for r, jr in zip(norms, jnorms):
        assert abs(r - jr) <= 1e-3 * jr, (norms, jnorms)


def homogeneous_start(st, seed: int):
    """chip_smoke.py's start for its rate check: random, consistent, 0 on
    Dirichlet rows, the pressure's mean projected out."""
    x = rand_vec(st, seed)
    return type(x)(x.vel, st.project_mean(x.pre))


def homogeneous_norms(stack, jstokes, jcycle, japply, level, cycles, seed):
    """Residual norms of both packages' V-cycles on A x = 0 from the same
    start."""
    st, jst = stack.stokes[level], jstokes[level]
    x = homogeneous_start(st, seed)
    jx, b, jb = to_jax(x), st.zeros(), jst.zeros()
    norms = [float(st.norm(b - st.apply_inner(x)))]
    jnorms = [float(jst.norm(jb - japply(jx)))]
    for _ in range(cycles):
        x, jx = stack.gmg.cycle(x, b), jcycle(jx, jb)
        norms.append(float(st.norm(b - st.apply_inner(x))))
        jnorms.append(float(jst.norm(jb - japply(jx))))
    return norms, jnorms


def test_homogeneous_cycles(stacks):
    """The V-cycle on A x = 0 (chip_smoke.py's Stokes rate check): both
    packages' residual norms agree cycle by cycle (1e-3), and the first
    cycle cuts the residual below 1e-2 of the start. The later cycles'
    rates are whatever the reference's are (ROADMAP C-ref8)."""
    jstokes, jgmg, stack, _ = stacks
    norms, jnorms = homogeneous_norms(stack, jstokes, jgmg.cycle,
                                      jgmg.levels[2].apply, 2, CYCLES, 23)
    for r, jr in zip(norms, jnorms):
        assert abs(r - jr) <= 1e-3 * jr, (norms, jnorms)
    rates = [norms[i + 1] / norms[i] for i in range(CYCLES)]
    assert rates[0] < 1e-2, rates


def test_coarse_operator_is_galerkin(stacks):
    """The level-1 block operator equals R A P, the level-2 operator
    between the stack's own restriction and prolongation (1e-5 * max,
    float32): the coarse correction is a Galerkin one, so the cycle's 3D
    divergence is not a coarse-grid inconsistency."""
    _, _, stack, _ = stacks
    sc, sf = stack.stokes[1], stack.stokes[2]
    L = stack.gmg.levels[2]
    xc = rand_vec(sc, 24)
    want = sc.apply_inner(xc)
    got = L.restrict(sf.apply_inner(L.prolongate_add(xc, sf.zeros())))
    for a, b in ((got.vel, want.vel), (got.pre, want.pre)):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    name, lo, hi = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    from hyteg_tpu.mesh import meshinfo as jmi
    from hyteg_tpu.primitives.storage import CellStorage as JStorage
    from hyteg_tpu_torch.mesh import meshinfo as tmi
    from hyteg_tpu_torch.primitives.storage import CellStorage

    mesh = {"rect4": lambda m: m.mesh_rectangle((0, 0), (1, 1), 4, 4),
            "cube2": lambda m: m.mesh_unit_cube(2), **MESHES}[name]
    jstokes, jgmg = juzawa.make_stokes_gmg(
        JStorage(mesh(jmi), num_shards=1), lo, hi, **KW)
    stack = make_stokes_gmg(CellStorage(mesh(tmi)), lo, hi, device="cpu",
                            **KW)
    norms, jnorms = homogeneous_norms(
        stack, jstokes, jax.jit(jgmg.cycle),
        jax.jit(lambda v: jstokes[hi].apply_inner(v)), hi, CYCLES, 23)
    for tag, n in (("jax", jnorms), ("port", norms)):
        print(tag, name, lo, hi, "residuals", n, "rates",
              [n[i + 1] / n[i] for i in range(CYCLES)], flush=True)
