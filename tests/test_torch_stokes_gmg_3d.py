"""The Uzawa smoother and Stokes GMG tests of
tests/test_torch_stokes_gmg.py on mesh_unit_cube(1), P2 levels 1-2: a file
of its own, so that the 3D JAX stack's compiles run beside the 2D ones."""

import pytest

from tests.test_torch_stokes_gmg import (  # noqa: F401
    make_stacks, test_coarse_operator_is_galerkin,
    test_eigs_carried_and_estimated, test_gmg_cycles_match,
    test_homogeneous_cycles, test_uzawa_sweep)


@pytest.fixture(scope="module")
def stacks():
    yield from make_stacks("cube")
