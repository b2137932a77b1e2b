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
              "hyteg_tpu_torch.interop"):
        assert m in MODULES


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(PKG)) for p in SOURCES])
def test_source_names_no_jax(path):
    text = path.read_text()
    assert "import jax" not in text
    assert "from jax" not in text
    assert "hyteg_tpu." not in text
