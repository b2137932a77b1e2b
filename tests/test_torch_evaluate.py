"""Point evaluation (functions/evaluate.py) of the PyTorch port against the
JAX package on identical inputs: P1 and P2 fields in 2D and 3D at seeded
points, batched components, the P1 gradient, the bucket table, clamping
of points outside the domain, and chunked against unchunked evaluation.

Meshes: mesh_rectangle 2 x 2 (8 faces, no buckets), mesh_annulus(0.55, 1,
6, 1) (12 faces, buckets around a hole), mesh_unit_cube(1) (6 tets) and
mesh_spherical_shell(1, 1, 0.55, 1) (the coarsest icosahedral shell,
buckets). Fields are interpolated smooth functions, so replicas agree and
the field is continuous across cells: a point on a shared face gives the
same value whichever cell the locator picks.

Tolerances (float32, sums in another order): values 1e-5 of max|u|;
gradients 1e-4 of max|grad u|; barycentric coordinates 1e-5; the bucket
table exactly; chunked against unchunked exactly. Outside the domain the
closest cell can tie between neighbours (equal barycentric minima in
exact arithmetic, decided by rounding): only points whose two best
candidates differ by more than 1e-4 are compared there.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu.core.types import BoundaryCondition as JBC
from hyteg_tpu.core.types import DoFType as JDoF
from hyteg_tpu.functions.evaluate import FieldEvaluator as JEval
from hyteg_tpu.functions.p1 import P1Space as JP1
from hyteg_tpu.functions.p2 import P2Space as JP2
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.functions.evaluate import FieldEvaluator

torch.set_num_threads(1)

MESHES = {
    "rect": (2, lambda m: m.mesh_rectangle(nx=2, ny=2)),
    "annulus": (2, lambda m: m.mesh_annulus(0.55, 1.0, 6, 1)),
    "cube": (3, lambda m: m.mesh_unit_cube(1)),
    "cube2": (3, lambda m: m.mesh_unit_cube(2)),
    "shell": (3, lambda m: m.mesh_spherical_shell(1, 1, 0.55, 1.0)),
}
VAL_RTOL = 1e-5
GRAD_RTOL = 1e-4
TIE_MARGIN = 1e-4


@functools.lru_cache(maxsize=None)
def storage(name):
    from hyteg_tpu_torch.mesh import meshinfo as tmi
    from hyteg_tpu_torch.primitives.storage import CellStorage

    _, mk = MESHES[name]
    return JStorage(mk(jmi), num_shards=1), CellStorage(mk(tmi))


@functools.lru_cache(maxsize=None)
def evaluators(name, level, degree):
    js, ts = storage(name)
    return (JEval(js, level, degree),
            FieldEvaluator(ts, level, degree, device="cpu"))


def field(x):
    """A smooth field of the physical coordinates (2D meshes: z = 0)."""
    return (jnp.sin(2.0 * x[..., 0]) + x[..., 1] * x[..., 0]
            + 0.5 * jnp.cos(3.0 * x[..., 2]) + 0.25 * x[..., 1] ** 2)


@functools.lru_cache(maxsize=None)
def block(name, level, degree, k: int = 0):
    """The JAX package's interpolant of (k + 1) * field as numpy."""
    js, _ = storage(name)
    sp = (JP1 if degree == 1 else JP2)(js, level)
    u = sp.interpolate(lambda x: (k + 1) * field(x), sp.zeros(), JDoF.ALL,
                       JBC.all_dirichlet())
    return np.asarray(u)


def inside_points(name, q, seed):
    """Seeded points inside the domain (the annulus and the shell: radii
    in [0.6, 0.75], inside the straight-edged rims of these coarse
    meshes, whose outer chords come to 0.87 and 0.79)."""
    dim, _ = MESHES[name]
    rng = np.random.default_rng(seed)
    if name in ("rect", "cube", "cube2"):
        return rng.uniform(0.03, 0.97, size=(q, dim))
    d = rng.normal(size=(q, dim))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return d * rng.uniform(0.6, 0.75, size=(q, 1))


def assert_close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, (what, err, scale)


CASES = [(m, lv, deg) for m in MESHES if m != "cube2"
         for lv, deg in ((2, 1), (1, 2))]


@pytest.mark.parametrize("name,level,degree", CASES,
                         ids=[f"{m}-P{d}-L{lv}" for m, lv, d in CASES])
def test_evaluate_matches_reference(name, level, degree):
    jev, tev = evaluators(name, level, degree)
    u = block(name, level, degree)
    pts = inside_points(name, 200, seed=11 + level)
    want = np.asarray(jev.evaluate(jnp.asarray(u), jnp.asarray(pts)))
    got = tev.evaluate(interop.block_from_reference(u, device="cpu"),
                       torch.as_tensor(pts))
    assert_close(got, want, VAL_RTOL, f"{name} P{degree}")
    # and near the field itself (the coarse interpolant's error)
    exact = np.asarray(field(jnp.asarray(np.pad(
        pts, ((0, 0), (0, 3 - pts.shape[1]))))))
    assert np.abs(got.numpy() - exact).max() < 0.1


@pytest.mark.parametrize("name", ["rect", "shell"])
def test_batched_components(name):
    """(B, C, N, lanes) blocks evaluate component by component."""
    jev, tev = evaluators(name, 2, 1)
    u = np.stack([block(name, 2, 1, k) for k in range(3)])
    pts = inside_points(name, 64, seed=5)
    want = np.asarray(jev.evaluate(jnp.asarray(u), jnp.asarray(pts)))
    got = tev.evaluate(torch.as_tensor(u), torch.as_tensor(pts))
    assert got.shape == (3, 64)
    assert_close(got, want, VAL_RTOL, name)


@pytest.mark.parametrize("name", ["rect", "annulus", "cube", "shell"])
def test_gradient_matches_reference(name):
    jev, tev = evaluators(name, 2, 1)
    u = block(name, 2, 1)
    pts = inside_points(name, 100, seed=3)
    want = np.asarray(jev.evaluate_gradient(jnp.asarray(u), jnp.asarray(pts)))
    got = tev.evaluate_gradient(torch.as_tensor(u), torch.as_tensor(pts))
    assert_close(got, want, GRAD_RTOL, name)


def test_gradient_p2_refused():
    _, tev = evaluators("rect", 1, 2)
    with pytest.raises(NotImplementedError):
        tev.evaluate_gradient(torch.zeros(8, 5, 5), torch.zeros(1, 2))


@pytest.mark.parametrize("name", ["annulus", "cube2", "shell"])
def test_bucket_table_equals_reference(name):
    jev, tev = evaluators(name, 2, 1)
    jt, jlo, jscale, jG = jev._buckets
    tt, tlo, tscale, tG = tev._buckets
    assert tG == jG
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))


def outside_points(name, q, seed):
    dim, _ = MESHES[name]
    rng = np.random.default_rng(seed)
    if name in ("rect", "cube", "cube2"):
        p = rng.uniform(-0.4, 1.4, size=(q, dim))
        return p[(p < 0).any(1) | (p > 1).any(1)]
    d = rng.normal(size=(q, dim))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = np.where(rng.uniform(size=(q, 1)) < 0.5,
                 rng.uniform(0.0, 0.5, size=(q, 1)),    # the hole
                 rng.uniform(1.05, 1.4, size=(q, 1)))   # beyond the rim
    return d * r


def untied(jev, pts):
    """Points whose closest cell is not a near tie (see module doc)."""
    js = jev.storage
    verts = np.asarray(js.cell_vertices, np.float64)[..., : jev.dim]
    J = verts[:, 1:] - verts[:, :1]
    lam = np.einsum("cde,qce->qcd", np.linalg.inv(np.swapaxes(J, 1, 2)),
                    pts[:, None, :] - verts[None, :, 0])
    minl = np.minimum(lam.min(-1), 1.0 - lam.sum(-1))
    if jev._buckets is not None:
        table, lo, scale = (np.asarray(a) for a in jev._buckets[:3])
        G = jev._buckets[3]
        ib = np.clip(np.floor((pts - lo) * scale).astype(int), 0, G - 1)
        cand = table[tuple(ib.T)]
    else:
        cand = np.broadcast_to(np.arange(len(verts)), minl.shape)
    best, second = np.empty(len(pts)), np.empty(len(pts))
    for q in range(len(pts)):
        top = np.sort(minl[q, np.unique(cand[q])])
        best[q], second[q] = top[-1], top[-2] if len(top) > 1 else -np.inf
    return best - second > TIE_MARGIN


@pytest.mark.parametrize("name", ["rect", "annulus", "cube", "cube2",
                                  "shell"])
def test_outside_points_clamp_as_reference(name):
    """Departure points that leave the domain clamp to the barycentrically
    closest cell (empty buckets: the nearest non-empty bucket's list), in
    both packages alike."""
    jev, tev = evaluators(name, 2, 1)
    pts = outside_points(name, 400, seed=9)
    keep = untied(jev, pts)
    # beyond a cube's edges and corners several tets tie exactly
    assert keep.sum() > 0.4 * len(pts)
    pts = pts[keep]
    jc, jlam = (np.asarray(a) for a in jev.locate_cells(jnp.asarray(
        pts, jnp.float32)))
    tc, tlam = tev.locate_cells(torch.as_tensor(pts, dtype=torch.float32))
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_allclose(tlam.numpy(), jlam, rtol=0, atol=1e-5)
    u = block(name, 2, 1)
    want = np.asarray(jev.evaluate(jnp.asarray(u), jnp.asarray(pts)))
    got = tev.evaluate(torch.as_tensor(u), torch.as_tensor(pts))
    assert np.isfinite(got.numpy()).all()
    assert_close(got, want, VAL_RTOL, name)


@pytest.mark.parametrize("name,degree", [("annulus", 2), ("shell", 1),
                                         ("shell", 2)])
def test_chunked_equals_unchunked(name, degree):
    """Evaluation in chunks (the full-size path) gives the unchunked
    result, value for value, inside and outside the domain."""
    _, ts = storage(name)
    level = 2 if degree == 1 else 1
    whole = FieldEvaluator(ts, level, degree, device="cpu", chunk=None)
    chunked = FieldEvaluator(ts, level, degree, device="cpu", chunk=37)
    u = torch.as_tensor(np.stack([block(name, level, degree, k)
                                  for k in range(2)]))
    pts = torch.as_tensor(np.concatenate(
        [inside_points(name, 150, 2), outside_points(name, 100, 4)]))
    a, b = whole.evaluate(u, pts), chunked.evaluate(u, pts)
    assert a.shape == (2, len(pts))
    assert torch.equal(a, b)
    if degree == 1:
        assert torch.equal(whole.evaluate_gradient(u[0], pts),
                           chunked.evaluate_gradient(u[0], pts))


@pytest.mark.parametrize("name,degree", [("cube2", 1), ("shell", 2)])
def test_pitched_block_equals_standalone(name, degree):
    """A 3D block laid out with a wider lane pitch (as a GMG stack lays its
    levels out) evaluates to the standalone block's values, exactly: the
    evaluator reads the pitch off the block it is given."""
    from hyteg_tpu_torch.core.types import DoFType
    from hyteg_tpu_torch.functions.p1 import P1Space
    from hyteg_tpu_torch.functions.p2 import P2Space

    _, ts = storage(name)
    level = 2 if degree == 1 else 1
    ev = evaluators(name, level, degree)[1]
    space = P1Space if degree == 1 else P2Space

    def tfield(x):
        return (torch.sin(2.0 * x[..., 0]) + x[..., 1] * x[..., 0]
                + 0.5 * torch.cos(3.0 * x[..., 2]) + 0.25 * x[..., 1] ** 2)

    blocks = []
    for pitch in (None, ev.N + 3):
        sp = space(ts, level, device="cpu", pitch=pitch)
        blocks.append(sp.interpolate(tfield, sp.zeros(), DoFType.ALL))
    assert blocks[1].shape[-1] == ev.N * (ev.N + 3)
    pts = torch.as_tensor(np.concatenate(
        [inside_points(name, 150, 5), outside_points(name, 100, 6)]))
    a = ev.evaluate(torch.stack([blocks[0]] * 2), pts)
    b = ev.evaluate(torch.stack([blocks[1]] * 2), pts)
    assert torch.isfinite(a).all() and a.abs().max() > 0
    assert torch.equal(a, b)
    if degree == 1:
        assert torch.equal(ev.evaluate_gradient(blocks[0], pts),
                           ev.evaluate_gradient(blocks[1], pts))
