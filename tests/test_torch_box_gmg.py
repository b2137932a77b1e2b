"""Grid transfers and geometric multigrid of the port's box path against
the JAX package on identical inputs.

Levels carry the JAX package's spectral bounds where a single step is
compared, so both packages run the same Chebyshev interval. The solve is
tests/test_box_gmg.py::_solve: u = sin(pi x) sin(pi y) sin(pi z) on the
unit cube, b = M f with the mass stencil, V(2,2) cycles.

Tolerances, all f32: transfers 1e-6 of the largest entry; eigenvalue
bounds 1e-6 relative (Fourier bound) and 1e-4 (power iteration); one
Chebyshev step, the coarse CG and one V-cycle 1e-5 * max|x|; the
residual history 1e-3 relative, or 1e-6 * ||r0|| once the residual nears
f32 round-off, where the packages' different summation orders dominate.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.operators import forms as jforms
from hyteg_tpu.structured import BoxDomain as JDomain
from hyteg_tpu.structured import BoxStencilOperator as JOp
from hyteg_tpu.structured import gmg as jgmg
from hyteg_tpu.structured import transfer as jtr
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.operators import forms as tforms
from hyteg_tpu_torch.structured import BoxDomain, BoxStencilOperator
from hyteg_tpu_torch.structured import gmg, transfer

torch.set_num_threads(1)

T = functools.partial(interop.box_block_from_reference, device="cpu")
N_ = interop.block_to_numpy


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, ref, rtol, scale=None):
    got = N_(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max() if scale is None else scale
    assert np.abs(got - ref).max() <= rtol * scale


# ---------------------------------------------------------------------------
# transfers
# ---------------------------------------------------------------------------

TRANSFER_CASES = [((2, 1, 1), 2), ((1, 2, 1), 2), ((1, 1, 1), 1),
                  ((1, 1, 2), 3)]


@pytest.mark.parametrize("m,level", TRANSFER_CASES)
def test_transfers_match_jax(m, level):
    jc, jf = JDomain(m, level), JDomain(m, level + 1)
    tc, tf = BoxDomain(m, level, device="cpu"), BoxDomain(m, level + 1, device="cpu")
    uc, vf = _rand(jc.block_shape, level), _rand(jf.block_shape, 10 + level)
    ref = np.asarray(jtr.prolongate(jnp.asarray(uc), jc, jf))
    _close(transfer.prolongate(T(uc), tc, tf), ref, 1e-6)
    ref = np.asarray(jtr.restrict(jnp.asarray(vf), jf, jc))
    _close(transfer.restrict(T(vf), tf, tc), ref, 1e-6)


@pytest.mark.parametrize("m,level", TRANSFER_CASES)
def test_restriction_is_transpose(m, level):
    tc, tf = BoxDomain(m, level, device="cpu"), BoxDomain(m, level + 1, device="cpu")
    uc = T(_rand(tc.block_shape, 1))
    vf = T(_rand(tf.block_shape, 2))
    lhs = torch.sum(transfer.prolongate(uc, tc, tf) * vf).item()
    rhs = torch.sum(uc * transfer.restrict(vf, tf, tc)).item()
    assert abs(lhs - rhs) < 1e-4 * max(1.0, abs(lhs))


def test_prolongation_exact_on_linears():
    coarse = BoxDomain((1, 2, 1), 2, device="cpu")
    fine = BoxDomain((1, 2, 1), 3, device="cpu")
    lin = lambda x, y, z: 1.0 + 2.0 * x - 0.5 * y + 3.0 * z
    uf = transfer.prolongate(coarse.interpolate(lin), coarse, fine)
    np.testing.assert_allclose(N_(uf), N_(fine.interpolate(lin)),
                               rtol=1e-5, atol=1e-5)


def test_transfer_directions_are_the_box_diagonals():
    """The box transfer stencil runs over the 14 monotone diagonals, which
    are the Kuhn stencil directions without 0 (not the macro-tet stencil
    directions of indexing/micro.py)."""
    from hyteg_tpu_torch.indexing import micro
    from hyteg_tpu_torch.structured import kuhn

    dirs = [tuple(d) for d in kuhn.stencil_dirs().tolist() if any(d)]
    assert transfer._DIRS14 == dirs == jtr._DIRS14
    tet = {tuple(int(v) for v in d) for d in micro.stencil_directions(3)}
    assert tet != set(dirs) | {(0, 0, 0)}


# ---------------------------------------------------------------------------
# spectral bounds, smoother, coarse solve, V-cycle
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _hierarchies(m, level, min_level):
    """JAX levels, and port levels with the JAX package's bounds."""
    jl = jgmg.build_hierarchy(JDomain(m, level), min_level=min_level)
    tl = gmg.build_hierarchy(BoxDomain(m, level, device="cpu"), min_level=min_level)
    for j, t in zip(jl, tl):
        t.eig_max = j.eig_max
    return jl, tl


@pytest.mark.parametrize("form", ["laplace", "mass"])
@pytest.mark.parametrize("m,level", [((1, 1, 1), 3), ((2, 1, 1), 2)])
def test_eig_max_fourier_matches(m, level, form):
    jf, tf = {"laplace": (jforms.laplace_form, tforms.laplace_form),
              "mass": (jforms.mass_form, tforms.mass_form)}[form]
    ref = jgmg.eig_max_fourier(JOp(JDomain(m, level), jf))
    got = gmg.eig_max_fourier(
        BoxStencilOperator(BoxDomain(m, level, device="cpu"), tf))
    assert abs(got - ref) <= 1e-6 * abs(ref)


def test_estimate_eig_max_matches():
    ref = jgmg.estimate_eig_max(JOp(JDomain((1, 1, 1), 2)))
    got = gmg.estimate_eig_max(
        BoxStencilOperator(BoxDomain((1, 1, 1), 2, device="cpu")))
    assert abs(got - ref) <= 1e-4 * abs(ref)


def test_hierarchy_matches():
    jl = jgmg.build_hierarchy(JDomain((2, 1, 1), 3), min_level=1)
    tl = gmg.build_hierarchy(BoxDomain((2, 1, 1), 3, device="cpu"), min_level=1)
    assert [t.domain.level for t in tl] == [j.domain.level for j in jl]
    for j, t in zip(jl, tl):
        assert abs(t.eig_max - j.eig_max) <= 1e-6 * j.eig_max
        ones = torch.ones(t.domain.block_shape)
        np.testing.assert_array_equal(N_(t.domain.mask_interior(ones)),
                                      np.asarray(j.inner))


def _x0_b(dom, seed):
    inner = np.asarray(dom.interior_mask)
    return (_rand(dom.block_shape, seed) * inner,
            _rand(dom.block_shape, seed + 1) * inner)


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_cheby_matches(degree):
    jl, tl = _hierarchies((1, 1, 1), 3, 1)
    x0, b = _x0_b(jl[0].domain, degree)
    ref = np.asarray(jgmg._cheby(jl[0], jnp.asarray(x0), jnp.asarray(b),
                                 degree))
    x0t = T(x0)
    got = gmg._cheby(tl[0], x0t, T(b), degree)
    _close(got, ref, 1e-5)
    np.testing.assert_array_equal(N_(x0t), x0)  # the caller's x is kept


@pytest.mark.parametrize("m,level", [((1, 1, 1), 1), ((2, 1, 1), 1),
                                     ((1, 1, 1), 2)])
def test_coarse_cg_matches(m, level):
    jl, tl = _hierarchies(m, level, level)
    _, b = _x0_b(jl[0].domain, 5)
    ref = np.asarray(jgmg.coarse_cg(jl[0], jnp.asarray(b), 40))
    _close(gmg.coarse_cg(tl[0], T(b), 40), ref, 1e-5)


@pytest.mark.parametrize("pre,post", [(2, 2), (1, 3)])
def test_vcycle_matches(pre, post):
    jl, tl = _hierarchies((1, 1, 1), 3, 1)
    x0, b = _x0_b(jl[0].domain, 7)
    ref = np.asarray(jgmg.vcycle(jl, jnp.asarray(x0), jnp.asarray(b), pre,
                                 post))
    _close(gmg.vcycle(tl, T(x0), T(b), pre, post), ref, 1e-5)


# ---------------------------------------------------------------------------
# the manufactured solve
# ---------------------------------------------------------------------------


def _jsolve(level, cycles=8, g=None):
    dom = JDomain((1, 1, 1), level)
    levels = jgmg.build_hierarchy(dom)
    ex = lambda x, y, z: (np.sin(np.pi * x) * np.sin(np.pi * y)
                          * np.sin(np.pi * z))
    f = dom.interpolate(lambda x, y, z: 3 * np.pi**2 * ex(x, y, z))
    b = JOp(dom, jforms.mass_form).apply_raw(f)
    gg = None if g is None else dom.interpolate(g[0])
    u, rns = jgmg.solve_poisson(levels, b, gg, cycles=cycles)
    return np.asarray(u), np.asarray(rns), float(jnp.linalg.norm(b * levels[0].inner))


def _tsolve(level, cycles=8, g=None):
    dom = BoxDomain((1, 1, 1), level, device="cpu")
    levels = gmg.build_hierarchy(dom)
    ex = lambda x, y, z: (torch.sin(np.pi * x) * torch.sin(np.pi * y)
                          * torch.sin(np.pi * z))
    f = dom.interpolate(lambda x, y, z: 3 * np.pi**2 * ex(x, y, z))
    b = BoxStencilOperator(dom, tforms.mass_form).apply_raw(f)
    gg = None if g is None else dom.interpolate(g[1])
    u, rns = gmg.solve_poisson(levels, b, gg, cycles=cycles)
    err = (u - dom.interpolate(ex)).abs().max().item()
    return u, rns, err


@pytest.mark.parametrize("level", [3, 4])
def test_solve_poisson_history_matches(level):
    ju, jr, r0 = _jsolve(level)
    tu, tr, _ = _tsolve(level)
    assert tr.shape == jr.shape == (8,)
    tol = np.maximum(1e-3 * jr, 1e-6 * r0)
    assert (np.abs(N_(tr) - jr) <= tol).all(), (N_(tr), jr)
    _close(tu, ju, 1e-4)


def test_solve_poisson_with_boundary_values_matches():
    g = (lambda x, y, z: 1.0 + x - 2.0 * y + 0.5 * z,) * 2
    ju, jr, r0 = _jsolve(3, cycles=4, g=g)
    tu, tr, _ = _tsolve(3, cycles=4, g=g)
    assert (np.abs(N_(tr) - jr) <= np.maximum(1e-3 * jr, 1e-6 * r0)).all()
    _close(tu, ju, 1e-4)


def test_vcycle_converges_and_second_order():
    _, r3, e3 = _tsolve(3)
    _, r4, e4 = _tsolve(4, cycles=6)
    r4 = N_(r4)
    assert (r4[1:] < r4[:-1]).all(), r4
    factors = r4[1:] / r4[:-1]
    assert factors[1:5].max() < 0.30, factors
    assert e4 < e3 / 3.0, (e3, e4)  # O(h^2)
