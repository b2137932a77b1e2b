"""DG1 SIP Laplace and P0 upwind advection of the PyTorch port
(functions/dg.py, operators/dg_ops.py) against the JAX package on
identical inputs; mirrors tests/test_dg.py.

Tolerances: the applies to 1e-5 of max|y| (f32, sums of up to 5 facet
terms per element in the same order, einsum contractions in another);
the manufactured solves' L2 errors to 2% of each other (both CG solves
stop at their own rtol on f32 round-off), each with the JAX test's gates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.core.types import DoFType as JDoF
from hyteg_tpu.functions.dg import DG1Space as JDG1Space
from hyteg_tpu.functions.dg import p1_to_dg1 as j_p1_to_dg1
from hyteg_tpu.functions.p1 import P1Space as JP1Space
from hyteg_tpu.functions.volume import VolumeDoFSpace as JVolumeDoFSpace
from hyteg_tpu.operators import dg_ops as jdg
from hyteg_tpu.primitives.storage import CellStorage as JCellStorage
from hyteg_tpu.solvers.krylov import cg_solve as j_cg_solve
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core.types import DoFType
from hyteg_tpu_torch.functions.dg import DG1Function, DG1Space, p1_to_dg1
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.functions.volume import VolumeDoFSpace
from hyteg_tpu_torch.mesh import meshinfo as mi
from hyteg_tpu_torch.operators import dg_ops
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.solvers.krylov import cg_solve

torch.set_num_threads(1)

MESHES = {
    "tri": lambda m: m.mesh_single_triangle(),
    "tet": lambda m: m.mesh_single_tet(),
    "rect": lambda m: m.mesh_rectangle((0, 0), (1, 1), 2, 1),
    "cube1": lambda m: m.mesh_unit_cube(1),
}


def spaces(name, level, kind="dg"):
    js = JCellStorage(MESHES[name](jmi), num_shards=1)
    ts = CellStorage(MESHES[name](mi))
    if kind == "dg":
        return JDG1Space(js, level), DG1Space(ts, level, device="cpu")
    return JVolumeDoFSpace(js, level), VolumeDoFSpace(ts, level, device="cpu")


def _block(jsp, seed):
    rng = np.random.default_rng(seed)
    w = jsp._valid_weight
    if jsp.ndofs > 1:
        w = w[..., None]
    return (rng.standard_normal(jsp.block_shape) * w).astype(np.float32)


def _close(got, want, scale, rtol):
    d = np.abs(interop.block_to_numpy(got) - np.asarray(want)).max()
    assert d <= rtol * scale, (d, scale)


@pytest.mark.parametrize("dim", [2, 3])
def test_facet_tables_match(dim):
    for a, b in zip(dg_ops.facet_tables(dim), jdg.facet_tables(dim)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,level", [("tri", 2), ("tet", 2), ("rect", 2),
                                        ("cube1", 1), ("cube1", 2)])
def test_sip_apply_matches(name, level):
    jsp, tsp = spaces(name, level)
    jop, top = jdg.DG1SIPLaplaceOperator(jsp), dg_ops.DG1SIPLaplaceOperator(tsp)
    assert top.has_cross == (jop._cross is not None)
    for a, b in ((top.App, jop.App), (top.Apm, jop.Apm), (top.Abb, jop.Abb),
                 (top.Kvol, jop.Kvol)):
        _close(a, b, float(np.abs(np.asarray(b)).max()), 1e-6)
    x = _block(jsp, level)
    ref = np.asarray(jop.apply(jnp.asarray(x)))
    got = top.apply(interop.volume_block_from_reference(x, device="cpu"))
    _close(got, ref, np.abs(ref).max(), 1e-5)


def test_cross_macro_scatter_adds_repeated_elements():
    """On the Kuhn cube an element can own several macro-interface facets:
    its index repeats in the cross table, and every one of its
    corrections must be added (a plain indexed += keeps one)."""
    jsp, tsp = spaces("cube1", 1)
    top = dg_ops.DG1SIPLaplaceOperator(tsp)
    si = top.cross_self.numpy()
    _, counts = np.unique(si, return_counts=True)
    assert counts.max() >= 2
    jop = jdg.DG1SIPLaplaceOperator(jsp)
    x = _block(jsp, 5)
    ref = np.asarray(jop.apply(jnp.asarray(x)))
    xt = interop.volume_block_from_reference(x, device="cpu")
    _close(top.apply(xt), ref, np.abs(ref).max(), 1e-5)
    # the same apply with the repeats collapsed by plain indexing differs
    nv = xt.shape[-1]
    uf = xt.reshape(-1, nv)
    corr = (torch.einsum("bij,bj->bi", top.cross_self_mat, uf[top.cross_self])
            + torch.einsum("bij,bj->bi", top.cross_nbr_mat, uf[top.cross_nbr]))
    once = torch.zeros_like(uf)
    once[top.cross_self] += corr
    added = torch.zeros_like(uf).index_add_(0, top.cross_self, corr)
    assert (once - added).abs().max() > 1e-3 * added.abs().max()


@pytest.mark.parametrize("dim", [2, 3])
def test_sip_symmetric_positive(dim):
    _, tsp = spaces("tri" if dim == 2 else "tet", 2)
    op = dg_ops.DG1SIPLaplaceOperator(tsp)
    g = torch.Generator().manual_seed(0)
    w = tsp.valid_weight_t[..., None]
    x = torch.randn(tsp.block_shape, generator=g) * w
    y = torch.randn(tsp.block_shape, generator=g) * w
    xay, yax = float(tsp.dot(x, op.apply(y))), float(tsp.dot(y, op.apply(x)))
    assert np.isclose(xay, yax, rtol=1e-3)
    assert float(tsp.dot(x, op.apply(x))) > 0


def _problem(dim, multi):
    if not multi and dim == 2:
        return (lambda p: p[..., 0] * p[..., 1] * (1 - p[..., 0] - p[..., 1]),
                lambda p: 2 * (p[..., 0] + p[..., 1]))
    if not multi:
        return (lambda p: (p[..., 0] * p[..., 1] * p[..., 2]
                           * (1 - p[..., 0] - p[..., 1] - p[..., 2])),
                lambda p: 2 * (p[..., 0] * p[..., 1] + p[..., 1] * p[..., 2]
                               + p[..., 0] * p[..., 2]))
    if dim == 2:
        return (lambda p: (p[..., 0] * (1 - p[..., 0])
                           * p[..., 1] * (1 - p[..., 1])),
                lambda p: 2 * (p[..., 0] * (1 - p[..., 0])
                               + p[..., 1] * (1 - p[..., 1])))

    def F(p):
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        return 2 * (y * (1 - y) * z * (1 - z) + x * (1 - x) * z * (1 - z)
                    + x * (1 - x) * y * (1 - y))

    return (lambda p: (p[..., 0] * (1 - p[..., 0]) * p[..., 1]
                       * (1 - p[..., 1]) * p[..., 2] * (1 - p[..., 2])), F)


def _errors(name, level, dim, multi, rtol, iters):
    U, F = _problem(dim, multi)
    jsp, tsp = spaces(name, level)
    jop, top = jdg.DG1SIPLaplaceOperator(jsp), dg_ops.DG1SIPLaplaceOperator(tsp)
    jb = jsp.mass_apply(jsp.interpolate(F))
    je = j_cg_solve(jop.apply, jsp.dot, jb, jnp.zeros_like(jb), iters,
                    rtol=rtol).x - jsp.interpolate(U)
    tb = tsp.mass_apply(tsp.interpolate(F))
    res = cg_solve(top.apply, tsp.dot, tb, torch.zeros_like(tb), iters,
                   rtol=rtol)
    te = res.x - tsp.interpolate(U)
    return (float(jnp.sqrt(jsp.dot(je, jsp.mass_apply(je)))),
            float(torch.sqrt(tsp.dot(te, tsp.mass_apply(te)))))


@pytest.mark.parametrize("dim", [2, 3])
def test_sip_poisson_converges_in_both(dim):
    """DGPoisson2DConvergenceTest's pattern: L2 error ~O(h^2) from level 2
    to 3 on one macro-simplex (the JAX test's gates: drop > 2.8x, fine
    error < 2e-3), the two packages within 2%."""
    name = "tri" if dim == 2 else "tet"
    (jc, tc), (jf, tf) = (_errors(name, lv, dim, False, 1e-7, 2000)
                          for lv in (2, 3))
    for c, f in ((jc, jf), (tc, tf)):
        assert f < c / 2.8 and f < 2e-3
    assert abs(tc - jc) <= 0.02 * jc and abs(tf - jf) <= 0.02 * jf


@pytest.mark.parametrize("dim", [2, 3])
def test_sip_cross_macro_converges_in_both(dim):
    name, l0 = ("rect", 2) if dim == 2 else ("cube1", 1)
    (jc, tc), (jf, tf) = (_errors(name, lv, dim, True, 1e-8, 3000)
                          for lv in (l0, l0 + 1))
    drop = 3.0 if dim == 2 else 2.0
    for c, f in ((jc, jf), (tc, tf)):
        assert f < c / drop
    assert abs(tc - jc) <= 0.02 * jc and abs(tf - jf) <= 0.02 * jf


def test_p1_to_dg1_matches_and_embeds():
    js = JCellStorage(jmi.mesh_single_triangle(), num_shards=1)
    ts = CellStorage(mi.mesh_single_triangle())
    jp, tp = JP1Space(js, 3), P1Space(ts, 3, device="cpu")
    jd, td = JDG1Space(js, 3), DG1Space(ts, 3, device="cpu")
    expr = lambda p: 1.0 + 2.0 * p[..., 0] - 0.5 * p[..., 1]
    ju = jp.interpolate(expr, jp.zeros(), JDoF.ALL)
    tu = interop.block_from_reference(np.asarray(ju), device="cpu")
    got = p1_to_dg1(tp, tu, td)
    _close(got, j_p1_to_dg1(jp, ju, jd), 1.0, 1e-6)
    _close(got, np.asarray(td.interpolate(expr)), 1.0, 1e-5)
    f = DG1Function(td.interpolate(1.0), td)
    assert np.isclose(float(f.integral()), 0.5, rtol=1e-5)
    m = td.mass_apply(got)
    _close(m, jd.mass_apply(jnp.asarray(interop.block_to_numpy(got))),
           float(m.abs().max()), 1e-6)
    _close(td.inverse_mass_apply(m), got, 1.0, 1e-4)


def test_upwind_advection_matches_and_stays_bounded():
    """The upwind apply against the JAX package's, then the JAX test's
    gates on 20 forward-Euler steps: bounded, mass only leaves."""
    jsp, tsp = spaces("tri", 4, kind="p0")
    vel = (1.0, 0.25)
    jop = jdg.P0UpwindAdvectionOperator(jsp, vel)
    top = dg_ops.P0UpwindAdvectionOperator(tsp, vel)
    _close(top.an, jop.an, float(np.abs(np.asarray(jop.an)).max()), 1e-6)
    ju = jsp.interpolate(lambda c: jnp.exp(-80.0 * ((c[..., 0] - 0.25) ** 2
                                                    + (c[..., 1] - 0.25) ** 2)))
    u = tsp.interpolate(lambda c: torch.exp(-80.0 * ((c[..., 0] - 0.25) ** 2
                                                     + (c[..., 1] - 0.25) ** 2)))
    _close(u, ju, 1.0, 1e-6)
    ref = np.asarray(jop.apply(ju, inflow=0.3))
    _close(top.apply(u, inflow=0.3), ref, np.abs(ref).max(), 1e-5)
    an_abs = np.abs(top.an.numpy()).sum(axis=-1)
    h = tsp.elem_volumes.numpy()[:, :, 0, 0]
    dt = 0.5 * float(np.min(h[h > 0] / an_abs[h > 0]))
    ref = np.asarray(jop.step(ju, dt))
    _close(top.step(u, dt), ref, 1.0, 1e-5)
    m0, mx0 = float(tsp.integral(u)), float(tsp.dof_max(u))
    for _ in range(20):
        u = top.step(u, dt)
    assert float(tsp.dof_max(u)) <= mx0 * (1 + 1e-5)
    assert float(u.min()) >= -1e-6
    m1 = float(tsp.integral(u))
    assert 0.2 * m0 < m1 <= m0 + 1e-6


def precision_gap(level: int, name: str = "cube1", rtol: float = 1e-8,
                  iters: int = 6000) -> dict:
    """The cross-macro manufactured SIP solve at one level: the JAX
    package's float32 L2 error, the port's float32 and float64 errors and
    their CG steps (the solver and rtol of chip_smoke.py's dg_eg phase).
    Each float32 error over the port's float64 one is the share of the
    float32 CG's own algebraic error."""
    U, F = _problem(3, True)
    jsp = JDG1Space(JCellStorage(MESHES[name](jmi), num_shards=1), level)
    jop = jdg.DG1SIPLaplaceOperator(jsp)
    jb = jsp.mass_apply(jsp.interpolate(F))
    jr = j_cg_solve(jop.apply, jsp.dot, jb, jnp.zeros_like(jb), iters,
                    rtol=rtol)
    je = jr.x - jsp.interpolate(U)
    out = {"level": level, "mesh": name,
           "jax_f32": float(jnp.sqrt(jsp.dot(je, jsp.mass_apply(je)))),
           "jax_f32_steps": int(jr.iterations)}
    ts = CellStorage(MESHES[name](mi))
    for key, dtype in (("port_f32", torch.float32),
                       ("port_f64", torch.float64)):
        tsp = DG1Space(ts, level, device="cpu", dtype=dtype)
        top = dg_ops.DG1SIPLaplaceOperator(tsp)
        tb = tsp.mass_apply(tsp.interpolate(F))
        res = cg_solve(top.apply, tsp.dot, tb, torch.zeros_like(tb), iters,
                       rtol=rtol)
        te = res.x - tsp.interpolate(U)
        out[key] = float(torch.sqrt(tsp.dot(te, tsp.mass_apply(te))))
        out[key + "_steps"] = int(res.iterations)
    for key in ("jax_f32", "port_f32"):
        out[key + "_over_port_f64"] = out[key] / out["port_f64"]
    return out


if __name__ == "__main__":
    # python -m tests.test_torch_dg [levels]: both packages' float32 SIP
    # errors against the port's float64 one on mesh_unit_cube(1)
    import json
    import sys

    torch.set_num_threads(4)
    for lv in [int(a) for a in sys.argv[1:]] or [3, 4]:
        print(json.dumps(precision_gap(lv)), flush=True)
