"""The blended Taylor-Hood Stokes composite of the PyTorch port
(``P2P1TaylorHoodStokes(..., gmap=...)``, hyteg_tpu_torch/composites/
stokes.py) and its pieces of the GMG stack (one inexact-Uzawa sweep, the
restriction and the prolongation of ``make_stokes_gmg(..., gmap=...)``)
against the JAX package's, piece by piece, on the blended shell
mesh_spherical_shell(0, 1, 0.55, 1) (60 tets) at P2 levels 0-1, one lane
pitch. tests/test_torch_blended_stokes_gmg.py holds the V-cycles, on the
blended annulus (the JAX package's blended shell cycle takes minutes to
compile).

The JAX side runs as its own CPU tests run it, eagerly (plain XLA: the
blended operators reach no Pallas kernel); the transfers are the JAX
stack's restriction and prolongation (hyteg_tpu/solvers/uzawa.py:138-167)
written out on its transfer operators. Inputs are seeded Taylor-Hood
vectors, consistent across interface replicas, 0 on Dirichlet rows.

Tolerances (float32, sums in another order): applies, preconditioner,
sweep and transfers 1e-5 * max|y|.
"""

import functools

import jax.numpy as jnp
import torch

from hyteg_tpu.composites.stokes import P2P1TaylorHoodStokes as JStokes
from hyteg_tpu.composites.stokes import TaylorHoodVec as JVec
from hyteg_tpu.core.types import FLAG_INNER as J_FLAG_INNER
from hyteg_tpu.geometry import maps as jmaps
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators.p2_transfer import P2Transfer as JP2Transfer
from hyteg_tpu.operators.transfer import P1Transfer as JP1Transfer
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu.solvers import uzawa as juzawa
from hyteg_tpu_torch.composites.stokes import P2P1TaylorHoodStokes
from hyteg_tpu_torch.geometry import maps as tmaps
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.operators.p1_elementwise import P1ElementwiseOperator
from hyteg_tpu_torch.operators.p2_blended_stokes import (
    P2BlendedEpsilonOperator, P2P1BlendedDivOperator)
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.solvers.uzawa import UzawaSmoother, make_stokes_gmg

from tests.test_torch_stokes import assert_vec_close, rand_vec, to_jax

torch.set_num_threads(1)

PITCH = (1 << 2) + 1  # max P2 level 1
EIG = 3.0             # tests/test_p2_blended.py's fixed eigs
OMEGA_P = 0.3         # make_stokes_gmg's default


@functools.lru_cache(maxsize=None)
def composites():
    """{level: (JAX composite, port composite)} at P2 levels 0 and 1."""
    mesh = lambda m: m.mesh_spherical_shell(0, 1, 0.55, 1.0)
    js = JStorage(mesh(jmi), num_shards=1)
    ts = CellStorage(mesh(tmi))
    return {l: (JStokes(js, l, pitch=PITCH, gmap=jmaps.RadialMap()),
                P2P1TaylorHoodStokes(ts, l, pitch=PITCH, device="cpu",
                                     gmap=tmaps.RadialMap()))
            for l in (0, 1)}


def test_composite_operators():
    """gmap switches K to the blended epsilon operator and B to the
    blended div / grad on one shared blended field; the pressure mass stays
    the affine lumped P1 mass."""
    _, st = composites()[1]
    assert st.use_epsilon and st.K is None
    assert isinstance(st.K_eps, P2BlendedEpsilonOperator)
    assert isinstance(st.B, P2P1BlendedDivOperator)
    assert st.K_eps.comps is st.B.comps
    assert isinstance(st.pmass, P1ElementwiseOperator)


def test_apply_inner():
    jst, st = composites()[1]
    x = rand_vec(st, 1)
    assert_vec_close(st.apply_inner(x), jst.apply_inner(to_jax(x)), 1e-5,
                     "apply_inner")


def test_preconditioner():
    jst, st = composites()[1]
    r = st.apply_inner(rand_vec(st, 2))
    assert_vec_close(st.block_diag_preconditioner()(r),
                     jst.block_diag_preconditioner()(to_jax(r)), 1e-5,
                     "block-diagonal preconditioner")


def test_uzawa_sweep():
    jst, st = composites()[1]
    x, b = rand_vec(st, 3), st.apply_inner(rand_vec(st, 4))
    y = UzawaSmoother(st, omega_p=OMEGA_P, eig_max=EIG)(x, b)
    jy = juzawa.UzawaSmoother(jst, omega_p=OMEGA_P, eig_max=EIG)(to_jax(x),
                                                                 to_jax(b))
    assert_vec_close(y, jy, 1e-5, "Uzawa sweep")


def _jax_restrict(jf, jc, r):
    vt = JP2Transfer(jc.vel_space, jf.vel_space)
    pt = JP1Transfer(jc.pre_space, jf.pre_space)
    vel = []
    for rv in r.vel:
        rvc = vt.restrict(rv, jf._vel_sd, jc._vel_sd)
        vel.append(jc.vel_space.restore_rows(rvc, jnp.zeros_like(rvc),
                                             J_FLAG_INNER, jc._vel_sd))
    pre = pt.restrict(r.pre, jf._pre_sd, jc._pre_sd)
    return JVec(tuple(vel), pre * jnp.asarray(jc.pre_space.vertex_mask[None],
                                              pre.dtype))


def _jax_prolongate_add(jf, jc, xc, xf):
    vt = JP2Transfer(jc.vel_space, jf.vel_space)
    pt = JP1Transfer(jc.pre_space, jf.pre_space)
    vel = [jf.vel_space.restore_rows(vt.prolongate_and_add(xc.vel[d],
                                                           xf.vel[d]),
                                     xf.vel[d], J_FLAG_INNER, jf._vel_sd)
           for d in range(jf.dim)]
    p = xf.pre + pt.prolongate(xc.pre)
    return JVec(tuple(vel), p * jnp.asarray(jf.pre_space.vertex_mask[None],
                                            p.dtype))


def test_restrict_and_prolongate():
    """make_stokes_gmg(..., gmap=...)'s level-1 restriction and
    prolongation; every level of the stack is blended."""
    (jc, tc), (jf, tf) = composites()[0], composites()[1]
    stack = make_stokes_gmg(tf.storage, 0, 1, epsilon=True,
                            gmap=tmaps.RadialMap(), coarse_iters=40,
                            eigs={0: EIG, 1: EIG}, device="cpu")
    assert all(isinstance(s.K_eps, P2BlendedEpsilonOperator)
               for s in stack.stokes.values())
    lv = stack.gmg.levels[1]
    r = tf.apply_inner(rand_vec(tf, 5))
    rc = lv.restrict(r)
    assert_vec_close(rc, _jax_restrict(jf, jc, to_jax(r)), 1e-5, "restrict")
    xc, xf = rand_vec(tc, 6), rand_vec(tf, 7)
    assert_vec_close(lv.prolongate_add(xc, xf),
                     _jax_prolongate_add(jf, jc, to_jax(xc), to_jax(xf)),
                     1e-5, "prolongate_add")
