"""The P1 GMG on red-green refined meshes, the PyTorch port against the
JAX package on the same inputs: the four cases of
tests/test_gmg_regression.py side by side (each cycle's residual within 2%
of the JAX one while it is above 1e-6 of the first; below that, f32
round-off, within 1e-6 of the first; and the JAX test's gates). Both
stacks run on the JAX stack's element matrices and eigenvalue bounds
(``gmg_pair``); the refined meshes of the card's AMR phase are in
tests/test_torch_amr_rates.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu import adaptivity as jad
from hyteg_tpu.core import types as jt
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import forms as jforms
from hyteg_tpu.operators.p1_elementwise import P1ElementwiseOperator as JOp
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu.solvers.smoothers import p1_stencil_eig_fourier
from hyteg_tpu.solvers.templates import make_p1_gmg as j_make_p1_gmg
from hyteg_tpu_torch import adaptivity as tad
from hyteg_tpu_torch import interop
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.solvers.templates import make_p1_gmg

torch.set_num_threads(1)

T = lambda a: interop.block_from_reference(np.asarray(a), device="cpu")  # noqa: E731




def gmg_pair(jmesh, tmesh, ncyc, dim, jsol, tsol, seed=None, **kw):
    """Both packages' P1 GMG: the JAX stack's element matrices and
    eigenvalue bounds carried over, x0 and b built on the JAX side, on the
    manufactured sine problem or, with ``seed``, on A x = 0 from a random
    consistent start (0 on the Dirichlet rows). (JAX residuals, the port's,
    the first residual) over ``ncyc`` cycles."""
    jstack = j_make_p1_gmg(JStorage(jmesh), **kw)
    eigs = None
    if kw.get("smoother", "chebyshev") == "chebyshev":
        eigs = {l: p1_stencil_eig_fourier(np.asarray(op.stencil), dim)
                for l, op in jstack.operators.items()}
    tstack = make_p1_gmg(
        CellStorage(tmesh), eigs=eigs, device="cpu",
        elmats={l: interop.elmats_from_reference(np.asarray(op.elmats),
                                                 device="cpu")
                for l, op in jstack.operators.items()}, **kw)
    sp, bc = jstack.space(), jt.BoundaryCondition.all_dirichlet()
    if seed is None:
        mass = JOp(sp, jforms.mass_form)
        x = sp.interpolate(jsol, sp.zeros(), jt.DoFType.DIRICHLET, bc)
        f = sp.interpolate(lambda p: dim * jnp.pi ** 2 * jsol(p), sp.zeros(),
                           jt.DoFType.ALL, bc)
        b = sp.restore_rows(mass.apply_raw(f), sp.zeros(), jt.FLAG_INNER, bc)
    else:
        x = np.random.default_rng(seed).standard_normal(sp.block_shape)
        x = sp.exchange_rep(jnp.asarray(x * sp.vertex_mask[None], jnp.float32))
        x = sp.restore_rows(x, jnp.zeros_like(x), jt.FLAG_INNER, bc)
        b = jnp.zeros_like(x)
    r0 = float(jstack.residual_norm(x, b))
    xt, bt = T(x), T(b)
    cyc = jax.jit(jstack.gmg.cycle)
    ref, got = [], []
    for _ in range(ncyc):
        x = cyc(x, b)
        xt = tstack.gmg.cycle(xt, bt)
        ref.append(float(jstack.residual_norm(x, b)))
        got.append(float(tstack.residual_norm(xt, bt)))
    return ref, got, r0


def u2(mod):
    return lambda p: mod.sin(mod.pi * p[..., 0]) * mod.sin(mod.pi * p[..., 1])


def u3(mod):
    return lambda p: (mod.sin(mod.pi * p[..., 0]) * mod.sin(mod.pi * p[..., 1])
                      * mod.sin(mod.pi * p[..., 2]))


def _histories_agree(ref, got, r0, rel=0.02, floor=1e-6):
    """Each cycle within ``rel`` of the JAX residual while that residual
    is above ``floor`` of the first; below it (f32 round-off, where the
    packages' summation orders decide) within ``floor`` of it."""
    for a, b in zip(got, ref):
        assert abs(a - b) <= max(rel * b, floor * r0), (got, ref)


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_gmg_min_level_above_zero_matches_jax(smoother):
    ref, got, r0 = gmg_pair(jmi.mesh_rectangle(nx=2, ny=2),
                             tmi.mesh_rectangle(nx=2, ny=2), 6, 2, u2(jnp),
                             u2(torch), min_level=2, max_level=3,
                             smoother=smoother)
    _histories_agree(ref, got, r0)
    assert all(np.isfinite(got)) and got[-1] < 1e-4 and got[-1] <= got[0]


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_gmg_on_red_green_mesh_matches_jax(smoother):
    ref, got, r0 = gmg_pair(
        jad.refine_rg(jmi.mesh_rectangle(nx=2, ny=2), [0, 3]).mesh,
        tad.refine_rg(tmi.mesh_rectangle(nx=2, ny=2), [0, 3]).mesh, 8, 2,
        u2(jnp), u2(torch), min_level=0, max_level=3, smoother=smoother)
    _histories_agree(ref, got, r0)
    assert all(np.isfinite(got)) and got[-1] < 5e-4
    for a, b in zip(got, got[1:]):
        assert b < 2 * a + 1e-5

