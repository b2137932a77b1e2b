"""The P1 GMG's rates on red-green refined meshes, the PyTorch port
against the JAX package on the same inputs, V(3,3) with Chebyshev
smoothing, both stacks on the JAX stack's element matrices and eigenvalue
bounds (tests/test_torch_amr_gmg.py's ``gmg_pair``); each cycle's rate
within 2% of the JAX one:

- the refined cube: red cell 0 of mesh_unit_cube(1) and its green closure
  (22 cells) at P1 levels 2-3, on the manufactured sine problem;
- the card's 2D AMR mesh (40 faces) at levels 2-4 on A x = 0 from a random
  start, each rate <= 0.35, the card's gate on that mesh.
"""

import jax.numpy as jnp
import numpy as np
import torch

from hyteg_tpu import adaptivity as jad
from hyteg_tpu.core import types as jt
from hyteg_tpu.functions.p1 import P1Space as JSpace
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu_torch import adaptivity as tad
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.primitives.storage import CellStorage
from tests.test_torch_amr_gmg import gmg_pair, u3

torch.set_num_threads(1)

T = lambda a: interop.block_from_reference(np.asarray(a), device="cpu")  # noqa: E731


def test_gmg_on_red_green_cube_rates_match_jax():
    """The 3D refined cube (red cell 0 of mesh_unit_cube(1) and its green
    closure) at level 3: cycle rates within 2% of the JAX ones."""
    ref, got, r0 = gmg_pair(
        jad.refine_rg(jmi.mesh_unit_cube(1), [0]).mesh,
        tad.refine_rg(tmi.mesh_unit_cube(1), [0]).mesh, 4, 3, u3(jnp),
        u3(torch), min_level=2, max_level=3, coarse_iters=30)
    rates_ref = [b / a for a, b in zip([r0] + ref, ref)]
    rates = [b / a for a, b in zip([r0] + got, got)]
    np.testing.assert_allclose(rates, rates_ref, rtol=0.02)
    assert all(np.isfinite(got)) and max(rates) < 0.35


def _bump2(p):
    return jnp.exp(-((p[..., 0] - 0.1) ** 2 + (p[..., 1] - 0.1) ** 2) / 0.005)


def test_refined_rect_rates_match_jax():
    """The rect's refined mesh of the card's 2D AMR phase: mesh_rectangle(
    nx=4, ny=4), the bump's indicator at P1 level 6, Dörfler 0.5 -> 40
    faces (both packages mark the same faces). Both packages' V(3,3) on
    A x = 0 at levels 2-4: each cycle's rate within 2% of the JAX one, and
    <= 0.35 (the card's gate on this mesh)."""
    jm = jmi.mesh_rectangle(nx=4, ny=4)
    jsp = JSpace(JStorage(jm), 6)
    u = jsp.interpolate(_bump2, jsp.zeros(), jt.DoFType.ALL,
                        jt.BoundaryCondition.all_dirichlet())
    marks = jad.mark_dorfler(jad.macro_gradient_indicator(jsp, u), 0.5)
    tm = tmi.mesh_rectangle(nx=4, ny=4)
    tsp = P1Space(CellStorage(tm), 6, device="cpu")
    np.testing.assert_array_equal(
        tad.mark_dorfler(tad.macro_gradient_indicator(tsp, T(u)), 0.5), marks)
    jm2, tm2 = jad.refine_rg(jm, marks).mesh, tad.refine_rg(tm, marks).mesh
    assert tm2.num_elements == 40
    ref, got, r0 = gmg_pair(jm2, tm2, 6, 2, None, None, seed=11, min_level=2,
                            max_level=4, coarse_iters=30)
    rates_ref = [b / a for a, b in zip([r0] + ref, ref)]
    rates = [b / a for a, b in zip([r0] + got, got)]
    np.testing.assert_allclose(rates, rates_ref, rtol=0.02)
    assert all(np.isfinite(got)) and max(rates) <= 0.35
