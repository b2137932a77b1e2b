"""Adaptive refinement of the PyTorch port against the JAX package on the
same inputs: red-green and uniform refinement (the same mesh: points bit
for bit, elements, flags, parents and green marks equal), the gradient
indicator (1e-12 relative) and Dörfler marking (equal sets), the transfer
between storages (1e-6 of the JAX block; a linear field within 5e-5 of its
interpolant), and the two forms (1e-6). The GMG on refined meshes is in
tests/test_torch_amr_gmg.py.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu import adaptivity as jad
from hyteg_tpu.core import types as jt
from hyteg_tpu.functions.p1 import P1Space as JSpace
from hyteg_tpu.functions.p2 import P2Space as JP2Space
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import forms as jforms
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu_torch import adaptivity as tad
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.core import types as tt
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.functions.p2 import P2Space
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.mesh.meshinfo import boundary_facets
from hyteg_tpu_torch.operators import forms as tforms
from hyteg_tpu_torch.primitives.storage import CellStorage

torch.set_num_threads(1)

T = lambda a: interop.block_from_reference(np.asarray(a), device="cpu")  # noqa: E731
N_ = interop.block_to_numpy


def _gen(mod, kind, *args):
    if kind == "mesh_rectangle":  # (nx, ny) on the unit square
        return mod.mesh_rectangle(nx=args[0], ny=args[1])
    return getattr(mod, kind)(*args)


def _meshes(name):
    """(JAX mesh, port mesh) of one generator call."""
    return _gen(jmi, *name), _gen(tmi, *name)


def _same_mesh(got, ref):
    assert got.dim == ref.dim
    assert got.points.dtype == ref.points.dtype == np.float64
    np.testing.assert_array_equal(got.points.view(np.uint64),
                                  ref.points.view(np.uint64))
    np.testing.assert_array_equal(got.elements, ref.elements)
    np.testing.assert_array_equal(got.vertex_boundary_flag,
                                  ref.vertex_boundary_flag)


def _measure(mesh):
    v = mesh.points[mesh.elements][..., : mesh.dim]
    det = np.abs(np.linalg.det(v[:, 1:] - v[:, :1]))
    return det.sum() / (2.0 if mesh.dim == 2 else 6.0)


def _conforming(mesh):
    combos = itertools.combinations(range(mesh.dim + 1), mesh.dim)
    key = np.sort(np.concatenate([mesh.elements[:, c] for c in combos]), 1)
    return np.unique(key, axis=0, return_counts=True)[1].max() <= 2


# ---------------------------------------------------------------------------
# refinement: every case of tests/test_amr.py, and more
# ---------------------------------------------------------------------------

UNIFORM = [(("mesh_rectangle", 1, 1), 1), (("mesh_unit_cube", 1), 1),
           (("mesh_rectangle", 2, 1), 2), (("mesh_annulus", 0.5, 1.0, 6, 1), 1)]


@pytest.mark.parametrize("name,times", UNIFORM)
def test_refine_uniform_matches_jax(name, times):
    jm, tm = _meshes(name)
    got, ref = tad.refine_uniform(tm, times), jad.refine_uniform(jm, times)
    _same_mesh(got, ref)
    assert got.num_elements == tm.num_elements * 2 ** (tm.dim * times)
    assert _conforming(got)


RG = [(("mesh_rectangle", 2, 2), [0]), (("mesh_unit_cube", 1), [0]),
      (("mesh_annulus", 0.5, 1.0, 6, 1), [0, 1]),
      (("mesh_rectangle", 2, 2), [0, 3]), (("mesh_unit_cube", 2), [5, 17, 30]),
      (("mesh_unit_cube", 1), [1, 4]), (("mesh_spherical_shell", 1, 1, 0.5, 1.0),
                                         [0, 7])]


@pytest.mark.parametrize("name,marks", RG)
def test_refine_rg_matches_jax(name, marks):
    jm, tm = _meshes(name)
    got, ref = tad.refine_rg(tm, marks), jad.refine_rg(jm, marks)
    _same_mesh(got.mesh, ref.mesh)
    np.testing.assert_array_equal(got.parent, ref.parent)
    np.testing.assert_array_equal(got.is_green, ref.is_green)
    assert got.is_green.dtype == bool and got.parent.dtype == np.int64
    assert _conforming(got.mesh)
    np.testing.assert_allclose(_measure(got.mesh), _measure(tm), rtol=1e-12)
    f = boundary_facets(got.mesh.elements, got.mesh.dim)
    assert f.shape == boundary_facets(ref.mesh.elements, ref.mesh.dim).shape


# ---------------------------------------------------------------------------
# indicator and marking
# ---------------------------------------------------------------------------


def _bump(mod, dim, c=0.1, w=0.005):
    ex = mod.exp

    def u(x):
        r2 = sum((x[..., d] - c) ** 2 for d in range(dim))
        return ex(-r2 / w)

    return u


INDICATOR = [("rect4", 3, 0.5), ("cube2", 3, 0.5), ("cube1_rg", 2, 0.4),
             ("rect2_rg", 4, 0.5)]


def _indicator_mesh(name):
    if name == "rect4":
        return _meshes(("mesh_rectangle", 4, 4))
    if name == "cube2":
        return _meshes(("mesh_unit_cube", 2))
    if name == "cube1_rg":
        return (jad.refine_rg(jmi.mesh_unit_cube(1), [0]).mesh,
                tad.refine_rg(tmi.mesh_unit_cube(1), [0]).mesh)
    return (jad.refine_rg(jmi.mesh_rectangle(nx=2, ny=2), [0, 3]).mesh,
            tad.refine_rg(tmi.mesh_rectangle(nx=2, ny=2), [0, 3]).mesh)


@pytest.mark.parametrize("name,level,frac", INDICATOR)
def test_indicator_and_marking_match_jax(name, level, frac):
    jm, tm = _indicator_mesh(name)
    jsp = JSpace(JStorage(jm), level)
    tsp = P1Space(CellStorage(tm), level, device="cpu")
    bc = jt.BoundaryCondition.all_dirichlet()
    u = jsp.interpolate(_bump(jnp, jm.dim), jsp.zeros(), jt.DoFType.ALL, bc)
    ref = jad.macro_gradient_indicator(jsp, u)
    got = tad.macro_gradient_indicator(tsp, T(u))
    assert got.dtype == np.float64 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(tad.mark_dorfler(got, frac),
                                  jad.mark_dorfler(ref, frac))
    # the port's own interpolant gives the same indicator to f32 rounding
    # of the field (exp in another library)
    ut = tsp.interpolate(_bump(torch, tm.dim), tsp.zeros(), tt.DoFType.ALL,
                         tt.BoundaryCondition.all_dirichlet())
    np.testing.assert_allclose(tad.macro_gradient_indicator(tsp, ut), ref,
                               rtol=1e-5, atol=1e-6 * ref.max())


def test_indicator_finds_the_bump_and_marking_edge_cases():
    """tests/test_amr.py::test_indicator_and_marking's checks on the port,
    and Dörfler marking of a zero indicator."""
    st = CellStorage(tmi.mesh_rectangle(nx=4, ny=4))
    sp = P1Space(st, 3, device="cpu")
    u = sp.interpolate(_bump(torch, 2), sp.zeros(), tt.DoFType.ALL,
                       tt.BoundaryCondition.all_dirichlet())
    eta = tad.macro_gradient_indicator(sp, u)
    assert eta.shape[0] == st.cells_per_shard
    cmax = int(np.argmax(eta))
    cent = np.asarray(st.cell_vertices)[cmax, :, :2].mean(0)
    assert np.linalg.norm(cent - [0.1, 0.1]) < 0.3
    marked = tad.mark_dorfler(eta, 0.5)
    assert 0 < len(marked) < st.cells_per_shard and cmax in marked
    assert tad.mark_dorfler(np.zeros(5)).size == 0


def test_indicator_skips_padding_cells():
    """A sharded storage's padding cell gets 0, the others their one-shard
    values (each shard's block holds its own cells)."""
    mesh = tmi.mesh_rectangle(nx=3, ny=1)  # 6 faces -> 4 shards pad 2 cells
    one = P1Space(CellStorage(mesh), 3, device="cpu")
    st = CellStorage(mesh, num_shards=4)
    assert not st.cell_valid.all()
    u1 = one.interpolate(_bump(torch, 2, 0.3, 0.05), one.zeros(),
                         tt.DoFType.ALL, tt.BoundaryCondition.all_dirichlet())
    want = tad.macro_gradient_indicator(one, u1)
    sp = P1Space(st, 3, device="cpu")
    for s in range(4):
        sd = sp.shard_data(s, tt.BoundaryCondition.all_dirichlet())
        u = sp.coords_from(sd.cell_vertices)
        u = _bump(torch, 2, 0.3, 0.05)(u) * sp.vertex_mask_t
        eta = tad.macro_gradient_indicator(sp, u, sd)
        for slot in range(sp.C_loc):
            gid = st.cell_global_index[s * sp.C_loc + slot]
            if gid < 0:
                assert eta[slot] == 0.0
            else:
                np.testing.assert_allclose(eta[slot], want[gid], rtol=1e-6)


# ---------------------------------------------------------------------------
# transfer between storages
# ---------------------------------------------------------------------------

TRANSFER = [("mesh_rectangle", 2, 2, 1), ("mesh_unit_cube", 2, 2, 1),
            ("mesh_rectangle", 1, 2, 2)]


def _lin(p):
    return 2 * p[..., 0] - p[..., 1] + 0.5 * p[..., 2]


def _smooth(mod):
    return lambda p: mod.sin(3 * p[..., 0]) * mod.cos(2 * p[..., 1]) + p[..., 2]


@pytest.mark.parametrize("kind,n,level,degree", TRANSFER)
def test_transfer_matches_jax(kind, n, level, degree):
    args = (n, n) if kind == "mesh_rectangle" else (n,)
    jm, tm = _meshes((kind,) + args)
    marks = [0, jm.num_elements - 1]
    jm2, tm2 = jad.refine_rg(jm, marks).mesh, tad.refine_rg(tm, marks).mesh
    js, js2, ts, ts2 = (JStorage(jm), JStorage(jm2), CellStorage(tm),
                        CellStorage(tm2))
    bc = jt.BoundaryCondition.all_dirichlet()
    for fn_j, fn_t, linear in ((_lin, _lin, True),
                               (_smooth(jnp), _smooth(torch), False)):
        if degree == 2:
            jsp, jsp2 = JP2Space(js, level), JP2Space(js2, level)
        else:
            jsp, jsp2 = JSpace(js, level), JSpace(js2, level)
        u = jsp.interpolate(fn_j, jsp.zeros(), jt.DoFType.ALL, bc)
        ref = np.asarray(jad.interpolate_between_storages(js, level, degree, u,
                                                          js2))
        got = tad.interpolate_between_storages(ts, level, degree, T(u), ts2,
                                               device="cpu")
        assert got.dtype == torch.float32 and got.shape == ref.shape
        scale = np.abs(ref).max()
        assert np.abs(N_(got) - ref).max() <= 1e-6 * scale
        if linear:
            sp2 = (P2Space(ts2, level, device="cpu") if degree == 2
                   else P1Space(ts2, level, device="cpu"))
            want = sp2.interpolate(fn_t, sp2.zeros(), tt.DoFType.ALL,
                                   tt.BoundaryCondition.all_dirichlet())
            node = sp2.node_space if degree == 2 else sp2
            sel = node.vertex_mask[None] & ts2.cell_valid[:, None, None]
            assert np.abs(N_(got)[sel] - N_(want)[sel]).max() <= 5e-5


def test_amr_cycle_with_transfer():
    """tests/test_amr.py::test_amr_cycle_with_transfer on the port."""
    mesh = tmi.mesh_rectangle(nx=2, ny=2)
    st = CellStorage(mesh)
    sp = P1Space(st, 2, device="cpu")
    bc = tt.BoundaryCondition.all_dirichlet()
    fn = lambda x: 2 * x[..., 0] - x[..., 1]  # noqa: E731
    u = sp.interpolate(fn, sp.zeros(), tt.DoFType.ALL, bc)
    res = tad.refine_rg(mesh, tad.mark_dorfler(
        tad.macro_gradient_indicator(sp, u), 0.4))
    st2 = CellStorage(res.mesh)
    u2 = tad.interpolate_between_storages(st, 2, 1, u, st2, device="cpu")
    sp2 = P1Space(st2, 2, device="cpu")
    want = sp2.interpolate(fn, sp2.zeros(), tt.DoFType.ALL, bc)
    sel = sp2.vertex_mask[None] & st2.cell_valid[:, None, None]
    assert np.abs(N_(u2)[sel] - N_(want)[sel]).max() <= 5e-5


# ---------------------------------------------------------------------------
# the two forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [2, 3])
def test_new_forms_match_jax(dim):
    rng = np.random.default_rng(dim)
    verts = (np.eye(dim + 1, dim) + 0.2 * rng.standard_normal(
        (5, dim + 1, dim))).astype(np.float32)
    cases = ((jforms.diffusion_plus_mass_form(2.0, 0.5),
              tforms.diffusion_plus_mass_form(2.0, 0.5)),
             (jforms.diffusion_plus_mass_form(), tforms.diffusion_plus_mass_form()),
             (jforms.div_k_grad_form_factory(), tforms.div_k_grad_form_factory()))
    for jf, tf in cases:
        ref = np.asarray(jf(jnp.asarray(verts)))
        got = tf(torch.as_tensor(verts)).numpy()
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    assert tforms.div_k_grad_form_factory() is tforms.laplace_form
