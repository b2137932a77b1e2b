"""The PyTorch/CUDA port (hyteg_tpu_torch) stands alone: it imports
neither jax nor the JAX package, so it runs on a machine without JAX.

The import check runs in a subprocess because this test session has
already imported jax (tests/conftest.py)."""

import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "hyteg_tpu_torch"
SOURCES = sorted(p for p in PKG.rglob("*.py") if "_build" not in p.parts)
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in SOURCES)


def test_package_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'hyteg_tpu' or m.startswith('hyteg_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    # -I: ignore PYTHONPATH and the user site, so nothing outside the
    # repo and the installed packages can import jax first
    proc = subprocess.run([sys.executable, "-I", "-c", code],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_module_list_covers_the_slice():
    for m in ("hyteg_tpu_torch.functions.p1",
              "hyteg_tpu_torch.kernels.p1_const_stencil",
              "hyteg_tpu_torch.kernels.p1_stencil",
              "hyteg_tpu_torch.kernels.build",
              "hyteg_tpu_torch.solvers.templates",
              "hyteg_tpu_torch.structured.gmg",
              "hyteg_tpu_torch.kernels.box_stencil",
              "hyteg_tpu_torch.kernels.stream",
              "hyteg_tpu_torch.interop",
              "hyteg_tpu_torch.tetpair",
              "hyteg_tpu_torch.tetpair.plan",
              "hyteg_tpu_torch.tetpair.ifc",
              "hyteg_tpu_torch.tetpair.small",
              "hyteg_tpu_torch.tetpair.engine",
              "hyteg_tpu_torch.kernels.tetpair",
              "hyteg_tpu_torch.operators.quadrature",
              "hyteg_tpu_torch.functions.p2",
              "hyteg_tpu_torch.operators.p2_elementwise",
              "hyteg_tpu_torch.operators.p2_transfer",
              "hyteg_tpu_torch.kernels.p2_const_stencil",
              "hyteg_tpu_torch.core.benchtime",
              "hyteg_tpu_torch.kernels.probes",
              "hyteg_tpu_torch.probes",
              "hyteg_tpu_torch.probes.prof_r5",
              "hyteg_tpu_torch.probes.prof_r5b",
              "hyteg_tpu_torch.probes.kernel_probe",
              "hyteg_tpu_torch.probes.prof_apply",
              "hyteg_tpu_torch.probes.__main__",
              "hyteg_tpu_torch.operators.mixed",
              "hyteg_tpu_torch.operators.p2_epsilon",
              "hyteg_tpu_torch.composites",
              "hyteg_tpu_torch.composites.stokes",
              "hyteg_tpu_torch.solvers.krylov",
              "hyteg_tpu_torch.solvers.uzawa",
              "hyteg_tpu_torch.solvers.stokes_pcg",
              "hyteg_tpu_torch.solvers.gmres",
              "hyteg_tpu_torch.io",
              "hyteg_tpu_torch.io.sparse",
              "hyteg_tpu_torch.geometry",
              "hyteg_tpu_torch.geometry.maps",
              "hyteg_tpu_torch.operators.p1_blended",
              "hyteg_tpu_torch.operators.p2_blended_stokes",
              "hyteg_tpu_torch.operators.freeslip",
              "hyteg_tpu_torch.core.timing",
              "hyteg_tpu_torch.core.config",
              "hyteg_tpu_torch.io.checkpoint",
              "hyteg_tpu_torch.numerictools",
              "hyteg_tpu_torch.numerictools.time_discr",
              "hyteg_tpu_torch.numerictools.spectrum",
              "hyteg_tpu_torch.numerictools.manufactured",
              "hyteg_tpu_torch.functions.evaluate",
              "hyteg_tpu_torch.transport",
              "hyteg_tpu_torch.transport.mmoc",
              "hyteg_tpu_torch.transport.particles",
              "hyteg_tpu_torch.terraneo",
              "hyteg_tpu_torch.terraneo.params",
              "hyteg_tpu_torch.terraneo.profiles",
              "hyteg_tpu_torch.terraneo.sphericalharmonics",
              "hyteg_tpu_torch.terraneo.plates",
              "hyteg_tpu_torch.terraneo.transport_std",
              "hyteg_tpu_torch.terraneo.simulation",
              "hyteg_tpu_torch.apps",
              "hyteg_tpu_torch.apps.terraneo_convection",
              "hyteg_tpu_torch.indexing.flat",
              "hyteg_tpu_torch.solvers.gmg",
              "hyteg_tpu_torch.solvers.colored_gs",
              "hyteg_tpu_torch.solvers.fas",
              "hyteg_tpu_torch.solvers.refinement",
              "hyteg_tpu_torch.solvers.hiptmair",
              "hyteg_tpu_torch.functions.volume",
              "hyteg_tpu_torch.functions.dg",
              "hyteg_tpu_torch.functions.eg",
              "hyteg_tpu_torch.functions.n1e1",
              "hyteg_tpu_torch.functions.edgedof",
              "hyteg_tpu_torch.operators.dg_ops",
              "hyteg_tpu_torch.operators.eg_ops",
              "hyteg_tpu_torch.operators.eg_stokes",
              "hyteg_tpu_torch.operators.n1e1_ops",
              "hyteg_tpu_torch.operators.n1e1_transfer",
              "hyteg_tpu_torch.adaptivity",
              "hyteg_tpu_torch.adaptivity.refine",
              "hyteg_tpu_torch.adaptivity.estimator",
              "hyteg_tpu_torch.adaptivity.transfer",
              "hyteg_tpu_torch.functions.registry",
              "hyteg_tpu_torch.io.vtk",
              "hyteg_tpu_torch.io.gmsh",
              "hyteg_tpu_torch.io.tables",
              "hyteg_tpu_torch.native"):
        assert m in MODULES


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(PKG)) for p in SOURCES])
def test_source_names_no_jax(path):
    text = path.read_text()
    assert "import jax" not in text
    assert "from jax" not in text
    assert "hyteg_tpu." not in text
