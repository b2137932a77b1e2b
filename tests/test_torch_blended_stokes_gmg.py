"""V-cycles of the blended Stokes GMG stack of the PyTorch port
(``make_stokes_gmg(..., gmap=...)``, hyteg_tpu_torch/solvers/uzawa.py)
against the JAX package's, on the blended annulus mesh_annulus(0.5, 1, 8,
1) (16 faces) at P2 levels 1-2: epsilon viscous block, RadialMap, V(2,2),
omega_p 0.3, 40 MINRES steps at most on level 1 and the fixed eigenvalue
bound 3.0 of tests/test_p2_blended.py's blended shell solve. The JAX stack
runs as tests/test_torch_stokes_gmg.py runs it, each piece jitted once;
its blended shell cycle takes minutes to compile on the CPU, so the shell's
pieces are compared one by one in tests/test_torch_blended_stokes.py.

Tolerances (float32): the residual norms of four V-cycles within 1e-3
relative, cycle by cycle.
"""

import jax
import numpy as np
import pytest
import torch

from hyteg_tpu.geometry import maps as jmaps
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu.solvers import uzawa as juzawa
from hyteg_tpu_torch.geometry import maps as tmaps
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.primitives.storage import CellStorage
from hyteg_tpu_torch.solvers.uzawa import make_stokes_gmg

from tests.test_torch_stokes import rand_vec, to_jax
from tests.test_torch_stokes_gmg import _jit_levels, homogeneous_norms

torch.set_num_threads(1)

KW = dict(epsilon=True, coarse_iters=40, eigs={1: 3.0, 2: 3.0})
CYCLES = 4


@pytest.fixture(scope="module")
def stacks():
    mesh = lambda m: m.mesh_annulus(0.5, 1.0, 8, 1)
    jstokes, jgmg = juzawa.make_stokes_gmg(
        JStorage(mesh(jmi), num_shards=1), 1, 2, gmap=jmaps.RadialMap(), **KW)
    stack = make_stokes_gmg(CellStorage(mesh(tmi)), 1, 2,
                            gmap=tmaps.RadialMap(), device="cpu", **KW)
    yield jstokes, _jit_levels(jgmg), stack
    jax.clear_caches()


def test_gmg_cycles_match(stacks):
    jstokes, jgmg, stack = stacks
    st, jst = stack.stokes[2], jstokes[2]
    b = st.apply_inner(rand_vec(st, 30))
    jb = to_jax(b)
    x, jx = st.zeros(), jst.zeros()
    japply = jgmg.levels[2].apply
    norms = [float(st.norm(b - st.apply_inner(x)))]
    jnorms = [float(jst.norm(jb - japply(jx)))]
    for _ in range(CYCLES):
        x, jx = stack.gmg.cycle(x, b), jgmg.cycle(jx, jb)
        norms.append(float(st.norm(b - st.apply_inner(x))))
        jnorms.append(float(jst.norm(jb - japply(jx))))
    assert all(np.isfinite(norms)), norms
    for r, jr in zip(norms, jnorms):
        assert abs(r - jr) <= 1e-3 * jr, (norms, jnorms)
    assert norms[-1] < norms[0], norms


def test_homogeneous_cycles(stacks):
    """chip_smoke.py's blend_stokes start (A x = 0 from a random
    consistent start): both packages agree cycle by cycle, and the first
    cycle cuts the residual."""
    jstokes, jgmg, stack = stacks
    norms, jnorms = homogeneous_norms(stack, jstokes, jgmg.cycle,
                                      jgmg.levels[2].apply, 2, CYCLES, 31)
    for r, jr in zip(norms, jnorms):
        assert abs(r - jr) <= 1e-3 * jr, (norms, jnorms)
    assert norms[1] < norms[0], norms


def test_power_iteration_eigs():
    """Without eigs, each level's eig_max comes from the port's power
    iteration on the blended K: finite, positive, and the V-cycle on a
    random rhs cuts the residual."""
    mesh = CellStorage(tmi.mesh_annulus(0.5, 1.0, 8, 1))
    stack = make_stokes_gmg(mesh, 1, 2, epsilon=True, coarse_iters=40,
                            gmap=tmaps.RadialMap(), device="cpu")
    assert all(np.isfinite(e) and e > 0 for e in stack.eigs.values())
    st = stack.stokes[2]
    b = st.apply_inner(rand_vec(st, 32))
    x = stack.gmg.cycle(st.zeros(), b)
    assert float(st.norm(b - st.apply_inner(x))) < float(st.norm(b))
