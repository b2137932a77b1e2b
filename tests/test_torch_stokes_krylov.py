"""MINRES and the Stokes PCG of the PyTorch port against the JAX
package's (hyteg_tpu/solvers/krylov.py:65, solvers/stokes_pcg.py) on the
Taylor-Hood composite (mesh_rectangle 2 x 2 at P2 level 2,
mesh_unit_cube(1) at level 1) and on a dense float64 saddle-point system.

Tolerances: a fixed count of float32 steps, x within 1e-4 * max|x| and
phibar within 1e-3 relative; run to a tolerance, the same count of steps
(in float64 on the dense system; in float32 on the 2D composite, see
test_minres_to_rtol_on_the_composite); the dense system's x within 1e-8 *
max|x|.

Run as a script, the file solves chip_smoke.py's 3D manufactured Stokes
problem (u = curl(0, 0, psi), psi = sin^2 pi x sin^2 pi y sin^2 pi z, p =
cos pi x cos pi y cos pi z) on mesh_unit_cube(2) with the JAX package's
float32 MINRES (block-diagonal preconditioner, rtol 1e-6, chip_smoke.py's
settings) at the P2 levels given, and prints the steps, the true residual
/ |b| and the velocity L2 error (level 4: ~20 min on the CPU; rtol=
sets another MINRES tolerance):

    JAX_PLATFORMS=cpu python -m tests.test_torch_stokes_krylov 3 4
    JAX_PLATFORMS=cpu python -m tests.test_torch_stokes_krylov 2 3 rtol=1e-8
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.solvers.krylov import minres_solve as jminres
from hyteg_tpu.solvers.stokes_pcg import stokes_pcg_solve as jpcg
from hyteg_tpu_torch.solvers.krylov import minres_solve
from hyteg_tpu_torch.solvers.stokes_pcg import stokes_pcg_solve

from tests.test_torch_stokes import (assert_close, assert_vec_close,
                                     composites, rand_vec, to_jax)

torch.set_num_threads(1)


SOLVER_CASES = [("rect", 2), ("cube", 1)]
SOLVER_IDS = [f"{m}-{lv}" for m, lv in SOLVER_CASES]


@functools.lru_cache(maxsize=None)
def jax_minres(name, level, max_iter, rtol):
    js, _ = composites(name, level)
    prec = js.block_diag_preconditioner()
    return jax.jit(lambda b, x: jminres(
        lambda v: js.apply_inner(v), lambda u, v: js.dot(u, v), b, x,
        max_iter, rtol=rtol, prec_fn=prec))


@pytest.mark.parametrize("name,level", SOLVER_CASES, ids=SOLVER_IDS)
def test_minres_fixed_steps(name, level):
    """A consistent rhs b = A x*, 12 steps (rtol 0): x within 1e-4 *
    max|x| of the JAX package's."""
    js, ts = composites(name, level)
    b = ts.apply_inner(rand_vec(ts, 10))
    x, k, phibar = minres_solve(ts.apply_inner, ts.dot, b, ts.zeros(), 12,
                                0.0, ts.block_diag_preconditioner())
    jx, jk, jphibar = jax_minres(name, level, 12, 0.0)(to_jax(b), js.zeros())
    assert k == int(jk) == 12
    assert math.isclose(float(phibar), float(jphibar), rel_tol=1e-3)
    assert_vec_close(x, jx, 1e-4, "minres x")


def test_minres_to_rtol_on_the_composite():
    """Run to rtol 1e-4 on the 2D composite: the same count of steps as
    the JAX package, x within 1e-4 * max|x|. (In float32 the two phibar
    histories part by rounding once MINRES slows down: on the 3D composite
    they differ by 14% at step 30, enough to move the step that crosses a
    tolerance by one; test_minres_same_steps holds the count in float64.)"""
    js, ts = composites("rect", 2)
    b = ts.apply_inner(rand_vec(ts, 10))
    prec = ts.block_diag_preconditioner()
    x, k, phibar = minres_solve(ts.apply_inner, ts.dot, b, ts.zeros(), 400,
                                1e-4, prec)
    jx, jk, _ = jax_minres("rect", 2, 400, 1e-4)(to_jax(b), js.zeros())
    assert k == int(jk) and 0 < k < 400, (k, int(jk))
    assert float(phibar) <= 1e-4 * float(torch.sqrt(ts.dot(b, prec(b))))
    assert_vec_close(x, jx, 1e-4, "minres x")


@pytest.mark.parametrize("precondition", [False, True], ids=["plain", "jacobi"])
def test_minres_same_steps(precondition):
    """A dense saddle-point system [[K, B^T], [B, 0]] in float64 through
    both packages' minres_solve: the same count of steps to rtol 1e-10 and
    the same x (1e-8 * max|x|)."""
    rng = np.random.default_rng(16)
    n, m = 24, 6
    G = rng.standard_normal((n, n))
    K = G @ G.T + n * np.eye(n)
    B = rng.standard_normal((m, n))
    A = np.block([[K, B.T], [B, np.zeros((m, m))]])
    b = rng.standard_normal(n + m)
    dinv = 1.0 / np.concatenate([np.diag(K), np.ones(m)])
    At, bt, dt = (torch.tensor(a) for a in (A, b, dinv))
    x, k, _ = minres_solve(lambda v: At @ v, lambda u, v: u @ v, bt,
                           torch.zeros_like(bt), 200, 1e-10,
                           (lambda r: dt * r) if precondition else None)
    with jax.enable_x64(True):
        Aj, bj, dj = (jnp.asarray(a) for a in (A, b, dinv))
        jx, jk, _ = jminres(lambda v: Aj @ v, lambda u, v: u @ v, bj,
                            jnp.zeros_like(bj), 200, 1e-10,
                            (lambda r: dj * r) if precondition else None)
        jx, jk = np.asarray(jx), int(jk)
    assert k == jk and k < 200, (k, jk)
    assert_close(x, jx, 1e-8, "minres x")
    assert np.abs(A @ x.numpy() - b).max() <= 1e-8 * np.abs(b).max()


def test_minres_on_plain_tensors():
    """minres_solve on a tensor operand: an SPD diagonal system."""
    g = torch.Generator().manual_seed(11)
    d = 1.0 + torch.rand(50, generator=g, dtype=torch.float64)
    b = torch.randn(50, generator=g, dtype=torch.float64)
    x, k, _ = minres_solve(lambda v: d * v, lambda u, v: (u * v).sum(), b,
                           torch.zeros_like(b), 100, rtol=1e-10)
    assert k < 100
    assert torch.allclose(x, b / d, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("name,level", SOLVER_CASES, ids=SOLVER_IDS)
def test_stokes_pcg(name, level):
    js, ts = composites(name, level)
    b = ts.apply_inner(rand_vec(ts, 12))
    res = stokes_pcg_solve(ts, b, max_iter=15, rtol=0.0)
    jres = jpcg(js, to_jax(b), max_iter=15, rtol=0.0)
    assert res.iterations == int(jres.iterations) == 15
    assert_vec_close(res.x, jres.x, 1e-4, "pcg x")
    assert abs(float(ts.pre_space.dof_sum(res.x.pre))) <= 1e-4 * float(
        res.x.pre.abs().sum())




def jax_manufactured_3d(level: int, max_iter: int = 6000,
                        rtol: float = 1e-6) -> dict:
    """The JAX package's MINRES on chip_smoke.py's 3D manufactured Stokes
    problem at one P2 level of mesh_unit_cube(2) (the forcing by
    autodiff, as tests/test_stokes.py builds its 2D one)."""
    from hyteg_tpu.composites.stokes import (P2P1TaylorHoodStokes,
                                             TaylorHoodVec)
    from hyteg_tpu.core.types import DoFType, FLAG_INNER
    from hyteg_tpu.mesh import meshinfo as mi
    from hyteg_tpu.operators.p2_elementwise import P2ElementwiseOperator
    from hyteg_tpu.primitives.storage import CellStorage

    pi = jnp.pi
    psi = lambda x, y, z: (jnp.sin(pi * x) * jnp.sin(pi * y)
                           * jnp.sin(pi * z)) ** 2
    vel = [lambda p: jax.grad(psi, 1)(p[0], p[1], p[2]),
           lambda p: -jax.grad(psi, 0)(p[0], p[1], p[2]),
           lambda p: 0.0 * p[0]]
    pres = lambda p: jnp.cos(pi * p[0]) * jnp.cos(pi * p[1]) * jnp.cos(
        pi * p[2])

    def on_coords(fn):
        def wrapped(c):
            flat = c.reshape(-1, c.shape[-1])[:, :3]
            return jax.vmap(fn)(flat).reshape(c.shape[:-1])
        return wrapped

    def force(d):
        def f(p):
            lap = jnp.trace(jax.hessian(vel[d])(p))
            return -lap + jax.grad(pres)(p)[d]
        return on_coords(f)

    st = P2P1TaylorHoodStokes(CellStorage(mi.mesh_unit_cube(2),
                                          num_shards=1), level=level)
    vsp = st.vel_space
    mass = P2ElementwiseOperator(vsp, "mass")
    b = TaylorHoodVec(tuple(vsp.restore_rows(
        mass.apply_raw(vsp.interpolate(force(d), vsp.zeros(), DoFType.ALL,
                                       st._vel_sd)),
        vsp.zeros(), FLAG_INNER, st._vel_sd) for d in range(3)),
        st.pre_space.zeros())
    prec = st.block_diag_preconditioner()
    x, steps, _ = jax.jit(lambda b, x: jminres(
        st.apply_inner, st.dot, b, x, max_iter=max_iter, rtol=rtol,
        prec_fn=prec))(b, st.zeros())
    r = float(st.norm(b - st.apply_inner(x))) / float(st.norm(b))
    uex = st.interpolate_velocity([on_coords(u) for u in vel], st.zeros())
    err = math.sqrt(sum(float(vsp.dot(
        x.vel[d] - uex.vel[d], mass.apply_raw(x.vel[d] - uex.vel[d]),
        DoFType.ALL, st._vel_sd)) for d in range(3)))
    return {"level": level, "minres_steps": int(steps),
            "relative_residual": r, "velocity_l2_error": err}


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    args = sys.argv[1:]
    kw = {"rtol": float(a[5:]) for a in args if a.startswith("rtol=")}
    for lv in (int(a) for a in args if not a.startswith("rtol=")):
        print("jax", kw, jax_manufactured_3d(lv, **kw), flush=True)
