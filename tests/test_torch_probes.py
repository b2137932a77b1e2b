"""The stripped-stencil probes (kernels P2) of the PyTorch port against the
JAX package's own probe kernels, and the port's dissection path.

The JAX side is the profiling scripts' own Pallas kernels, run as they
are in interpret mode: each script is loaded from ``scripts/`` with
``pl.pallas_call`` patched to ``interpret=True`` and its timer
(``auto_time``) and printer (``report``) replaced by a recorder that keeps
each timed ``(run, x)``. The same numpy-seeded block then goes through the
recorded ``run`` and through the port's plain version. ``prof_r5b.py``
sizes its block from module globals, patched here to a level-2 block;
``kernel_probe.py`` runs its benchmark when imported, so its
``make_stripped`` is taken out with ``ast``, with the module's imports,
and run on a level-2 space of the JAX package. Nothing in ``scripts/`` or
``hyteg_tpu/`` changes.

The probes' per-point math (csrc/stripped_stencil.cuh) is also compiled
with the host C++ compiler and held against the plain versions.

Tolerance: 1e-6 * max|y|. Both sides sum at most 15 f32 terms in the same
order; they differ only where one side fuses a multiply-add that the
other rounds twice (exact when the weights are ones).
"""

import ast
import ctypes
import functools
import importlib.util
import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hyteg_tpu.functions.p1 import P1Space as JSpace
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.operators import forms as jforms
from hyteg_tpu.operators.p1_elementwise import P1ElementwiseOperator as JOp
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu_torch.kernels import probes as tk

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
RTOL = 1e-6


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _assert_close(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(got - ref).max() <= RTOL * scale


class Recorder:
    """Stands in for a script's auto_time and report: keeps each timed
    (run, x) and times nothing."""

    def __init__(self):
        self.runs = []

    def auto_time(self, run, x, *args, **kwargs):
        self.runs.append((run, x))
        return 1.0

    def report(self, *args, **kwargs):
        pass


def _load_script(name, monkeypatch):
    """scripts/<name>.py as a module, its Pallas calls in interpret mode
    and its timing recorded (undone after the test)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rec = Recorder()
    monkeypatch.setattr(mod, "auto_time", rec.auto_time)
    monkeypatch.setattr(mod, "report", rec.report)
    return mod, rec


# ---------------------------------------------------------------------------
# box_variant against prof_r5.py's bench_box_variants
# ---------------------------------------------------------------------------

# the four variants bench_box_variants times, in its order (prof_r5.py:131)
BOX_VARIANTS = [(True, 15), (False, 15), (True, 6), (False, 1)]


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("k,shift,n_taps",
                         [(i, s, t) for i, (s, t) in enumerate(BOX_VARIANTS)])
def test_box_variant_matches_prof_r5(monkeypatch, level, k, shift, n_taps):
    mod, rec = _load_script("prof_r5", monkeypatch)
    mod.bench_box_variants(level=level)
    assert len(rec.runs) == 1 + len(BOX_VARIANTS)  # B1, then the variants
    run, u0 = rec.runs[1 + k]
    X, L = u0.shape
    Z = int(round(L ** 0.5))
    u = _rand((X, L), 100 + 10 * level + k)
    ref = np.asarray(run(jnp.asarray(u)))
    w = torch.ones((tk.N_DIRS, L))
    _assert_close(tk.box_variant_torch(torch.tensor(u), w, Z, shift, n_taps),
                  ref)
    # a CPU tensor takes the plain version through the wrapper too
    _assert_close(tk.box_variant(torch.tensor(u), w, Z, shift, n_taps), ref)


def test_box_tap_order_is_the_scripts():
    """Lane classes ascending, then the direction index (prof_r5.py:84-99)
    — for a Z where the classes are distinct."""
    order = tk.box_tap_order(9)
    assert [s for s, _ in order] == [0, 4, 1, 5, 2, 6, 3, 7, 11, 8, 12, 9,
                                     13, 10, 14]
    assert [ls for _, ls in order] == sorted(ls for _, ls in order)


# ---------------------------------------------------------------------------
# tet_stripped against prof_r5b.py's bench_fma and kernel_probe.py's
# make_stripped
# ---------------------------------------------------------------------------

# bench_fma's three timed settings (prof_r5b.py:142-144) and their masks
FMA_SETTINGS = [(False, 15, "none"), (False, 6, "none"),
                (True, 15, "k0_shells")]


@pytest.mark.parametrize("pitch", [5, 7])
@pytest.mark.parametrize("with_masks,n_dirs,mask", FMA_SETTINGS)
def test_tet_stripped_matches_bench_fma(monkeypatch, pitch, with_masks,
                                        n_dirs, mask):
    mod, rec = _load_script("prof_r5b", monkeypatch)
    C, level = 2, 2
    N = (1 << level) + 1
    for name, v in dict(C=C, LEVEL=level, N=N, P=pitch, L=N * pitch,
                        NB=C * N * N * pitch * 4).items():
        monkeypatch.setattr(mod, name, v)
    mod.bench_fma(with_masks, n_dirs)
    (run, u0), = rec.runs
    assert u0.shape == (C, N, N * pitch)
    u = _rand(u0.shape, 200 + n_dirs + pitch)
    ref = np.asarray(run(jnp.asarray(u)))
    w = torch.ones((C, tk.N_DIRS))
    got = tk.tet_stripped_torch(torch.tensor(u), w, tk.tet_dirs(), n_dirs,
                                pitch, mask)
    _assert_close(got, ref)
    _assert_close(tk.tet_stripped(torch.tensor(u), w, tk.tet_dirs(), n_dirs,
                                  pitch, mask), ref)


def _make_stripped_source():
    """kernel_probe.py's imports and its make_stripped, compiled without
    the module's benchmark code."""
    tree = ast.parse((SCRIPTS / "kernel_probe.py").read_text())
    keep = [node for node in tree.body
            if isinstance(node, (ast.Import, ast.ImportFrom))
            or (isinstance(node, ast.FunctionDef)
                and node.name == "make_stripped")]
    assert any(isinstance(n, ast.FunctionDef) for n in keep)
    return compile(ast.Module(body=keep, type_ignores=[]),
                   str(SCRIPTS / "kernel_probe.py"), "exec")


@pytest.mark.parametrize("pitch", [None, 7])
def test_tet_stripped_matches_make_stripped(monkeypatch, pitch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    storage = JStorage(jmi.mesh_unit_cube(1), num_shards=1)
    space = JSpace(storage, 2, pitch=pitch)
    op = JOp(space, jforms.laplace_form)
    C, N, L = space.block_shape
    x = _rand(space.block_shape, 300) * np.asarray(space.vertex_mask)[None]
    ns = {"C": C, "N": N, "L": L, "pitch": space.pitch, "n": N - 1,
          "A": op.stencil, "x": jnp.asarray(x)}
    exec(_make_stripped_source(), ns)
    ref = np.asarray(ns["make_stripped"]()(jnp.asarray(x)))
    assert ref.shape == (6, 5, 5 * space.pitch)
    W = torch.tensor(np.asarray(jnp.sum(op.stencil, -1)))
    got = tk.tet_stripped_torch(torch.tensor(x), W, tk.tet_dirs(), 15,
                                space.pitch, "k0")
    _assert_close(got, ref)


def test_tet_dirs_are_the_reference_stencil():
    from hyteg_tpu.kernels.p1_const_stencil import stencil_tables
    np.testing.assert_array_equal(tk.tet_dirs(), stencil_tables(3)[0])


def test_tet_masks():
    N, pitch = 5, 7
    y, z = np.arange(N * pitch) // pitch, np.arange(N * pitch) % pitch
    s = np.arange(N)[:, None] + (y + z)[None, :]
    k0 = tk.tet_mask(N, pitch, "k0", torch.device("cpu")).numpy()
    np.testing.assert_array_equal(k0, ((s <= N - 1) & (z < N)[None]))
    sh = tk.tet_mask(N, pitch, "k0_shells", torch.device("cpu")).numpy()
    np.testing.assert_array_equal(sh, ((s < N - 1) & (z < N)[None]))
    assert tk.tet_mask(N, pitch, "none", torch.device("cpu")) is None


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def test_wrappers_reject_bad_settings_and_devices():
    u, w = torch.zeros((3, 9)), torch.ones((15, 9))
    with pytest.raises(ValueError, match="n_taps"):
        tk.box_variant(u, w, 3, True, 16)
    with pytest.raises(ValueError, match="n_taps"):
        tk.tet_stripped(torch.zeros((1, 3, 9)), torch.ones((1, 15)),
                        tk.tet_dirs(), 0, 3, "none")
    with pytest.raises(ValueError, match="mask"):
        tk.tet_stripped(torch.zeros((1, 3, 9)), torch.ones((1, 15)),
                        tk.tet_dirs(), 15, 3, "shells")
    with pytest.raises(ValueError, match="CUDA"):
        tk.box_variant(u.to("meta"), w.to("meta"), 3, True, 15)
    with pytest.raises(ValueError, match="CUDA"):
        tk.tet_stripped(torch.zeros((1, 3, 9), device="meta"),
                        torch.ones((1, 15), device="meta"), tk.tet_dirs(),
                        15, 3, "k0")
    # a tap count the plain version takes but no kernel was built for
    with pytest.raises(ValueError, match="kernel"):
        tk.box_variant(u.to("meta"), w.to("meta"), 3, True, 7)
    assert tk.box_variant.launches == 0 and tk.tet_stripped.launches == 0


# ---------------------------------------------------------------------------
# the probes' per-point math, compiled for the host
# ---------------------------------------------------------------------------

CSRC = pathlib.Path(tk.__file__).resolve().parent.parent / "csrc"
HOST_HARNESS = r"""
#include <cmath>
#define HYTEG_DEVICE inline
#include "stripped_stencil.cuh"
using namespace hyteg;
struct Load {
  const float* p;
  float operator()(long long i) const { return p[i]; }
};
// The kernels' per-point functions, one lane (box) or slot (tet) after
// another, with the kernels' own dispatch over the template settings.
extern "C" int box_variant_host(const float* u, const float* w, float* y,
                                int X, int L, int Z, int shift, int n_taps) {
  auto all = [&](auto sh, auto taps) {
    constexpr bool kShift = decltype(sh)::value != 0;
    float wk[decltype(taps)::value];
    for (int l = 0; l < L; ++l) {
      box_probe_weights(Load{w}, wk, l, L);
      for (int x = 0; x < X; ++x)
        y[(long long)x * L + l] = box_probe_point<kShift>(
            Load{u}, wk, (long long)x * L, l, L, Z);
    }
  };
  return probe_with_taps(n_taps, [&](auto taps) {
    if (shift) all(ProbeInt<1>{}, taps); else all(ProbeInt<0>{}, taps);
  }) ? 0 : -1;
}
extern "C" int tet_stripped_host(const float* u, const float* w, float* y,
                                 int C, int N, int pitch, const int* dirs,
                                 int n_taps, int mask) {
  const ProbeTables t = probe_tables(dirs, pitch);
  const int L = N * pitch;
  const long long cell = (long long)N * L;
  bool ok = false;
  probe_with_mask(mask, [&](auto m) {
    ok = probe_with_taps(n_taps, [&](auto taps) {
      for (int c = 0; c < C; ++c)
        for (int x = 0; x < N; ++x)
          for (int l = 0; l < L; ++l)
            y[c * cell + (long long)x * L + l] =
                tet_probe_point<decltype(m)::value, decltype(taps)::value>(
                    u + c * cell, x, l, N, pitch, t, w + c * kProbeDirs);
    });
  });
  return ok ? 0 : -1;
}
extern "C" void box_probe_dirs(int* out) {
  for (int k = 0; k < kProbeDirs; ++k) out[k] = box_probe_dir(k);
}
"""


@pytest.fixture(scope="module")
def host_probes(tmp_path_factory):
    """The probes' per-point functions (csrc/stripped_stencil.cuh) built
    with the host C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_probes")
    (d / "harness.cpp").write_text(HOST_HARNESS)
    so = d / "libhost_probes.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.box_variant_host.argtypes = [P, P, P, I, I, I, I, I]
    lib.tet_stripped_host.argtypes = [P, P, P, I, I, I, P, I, I]
    lib.box_probe_dirs.argtypes = [P]
    return lib


@pytest.mark.parametrize("Z", [2, 3, 9])
def test_host_box_tap_order(host_probes, Z):
    out = np.zeros(15, dtype=np.int32)
    host_probes.box_probe_dirs(out.ctypes.data)
    assert out.tolist() == [s for s, _ in tk.box_tap_order(Z)]


@pytest.mark.parametrize("dims", [(9, 5, 5), (5, 3, 9), (3, 2, 2)])
@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("n_taps", tk.KERNEL_TAPS)
def test_host_box_variant_matches_plain(host_probes, dims, shift, n_taps):
    X, Y, Z = dims
    L = Y * Z
    u = torch.tensor(_rand((X, L), 400 + n_taps))
    w = torch.tensor(_rand((15, L), 401))  # per-lane weights, not ones
    out = torch.full_like(u, float("nan"))
    rc = host_probes.box_variant_host(u.data_ptr(), w.data_ptr(),
                                      out.data_ptr(), X, L, Z, int(shift),
                                      n_taps)
    assert rc == 0
    _assert_close(out, tk.box_variant_torch(u, w, Z, shift, n_taps))


@pytest.mark.parametrize("N,pitch", [(5, 5), (5, 7), (9, 12), (17, 17)])
@pytest.mark.parametrize("mask", tk.MASKS)
@pytest.mark.parametrize("n_taps", tk.KERNEL_TAPS)
def test_host_tet_stripped_matches_plain(host_probes, N, pitch, mask, n_taps):
    C = 3
    u = torch.tensor(_rand((C, N, N * pitch), 500 + N + pitch))
    w = torch.tensor(_rand((C, 15), 501))  # per-cell weights, not ones
    dirs = np.ascontiguousarray(tk.tet_dirs(), dtype=np.int32)
    out = torch.full_like(u, float("nan"))
    rc = host_probes.tet_stripped_host(u.data_ptr(), w.data_ptr(),
                                       out.data_ptr(), C, N, pitch,
                                       dirs.ctypes.data, n_taps,
                                       tk.MASKS.index(mask))
    assert rc == 0
    _assert_close(out, tk.tet_stripped_torch(u, w, dirs, n_taps, pitch,
                                             mask))


def test_host_dispatch_refuses_unbuilt_settings(host_probes):
    u = torch.zeros((1, 3, 9))
    w = torch.ones((1, 15))
    dirs = np.ascontiguousarray(tk.tet_dirs(), dtype=np.int32)
    args = (u.data_ptr(), w.data_ptr(), u.data_ptr(), 1, 3, 3,
            dirs.ctypes.data)
    assert host_probes.tet_stripped_host(*args, 7, 0) == -1
    assert host_probes.tet_stripped_host(*args, 15, 3) == -1
    assert host_probes.box_variant_host(u.data_ptr(), w.data_ptr(),
                                        u.data_ptr(), 3, 9, 3, 1, 2) == -1


# ---------------------------------------------------------------------------
# the dissection path (hyteg_tpu_torch.probes), built and called on the CPU
# ---------------------------------------------------------------------------


def _rungs(kind):
    from hyteg_tpu_torch import probes
    build = probes.box_rungs if kind == "box" else probes.tet_rungs
    return build(2, device="cpu")


@pytest.mark.parametrize("kind,count", [("box", 6), ("tet", 14)])
def test_every_rung_builds_and_runs_on_cpu(kind, count):
    from hyteg_tpu_torch import probes
    rungs = _rungs(kind)
    assert len(rungs) == count
    assert len({r.name for r in rungs}) == count
    assert sum(r.ladder == "real" for r in rungs) == 1
    assert {r.block for r in rungs} == {rungs[0].block}
    assert {r.ladder for r in rungs} <= set(probes.LADDER) | {None}
    for r in rungs:
        assert (REPO / r.script).is_file()
        out = r.fn()
        assert isinstance(out, torch.Tensor) and tuple(out.shape) == r.block
        assert torch.isfinite(out).all()


def test_rungs_compute_what_they_name():
    from hyteg_tpu_torch import probes
    box = {r.name: r for r in _rungs("box")}
    u = box["copy (9,81)"].fn() / 2  # the block the box rungs share
    assert box["box apply (current)"].block == (9, 81)
    w = torch.ones((15, 81))
    for shift, n_taps, tag, _ in probes.prof_r5.BOX_VARIANTS:
        assert torch.equal(box[f"box variant {tag}"].fn(),
                           tk.box_variant_torch(u, w, 9, shift, n_taps))
    tet = {r.name: r for r in _rungs("tet")}
    assert tet["tet kernel only"].block == (48, 5, 25)
    assert tet["tet kernel only"].ladder == "real"
    real = tet["tet kernel only"].fn()
    assert torch.equal(tet["B  plain const path"].fn(), real)
    x = tet["copy tet-blocks"].fn() / 2
    assert torch.equal(tet["axpy (copy cal)"].fn(), 2 * x + 1)
    # the stripped kernel agrees with B2 away from the faces and shells
    stripped = tet["C  stripped whole-cell 15pt"].fn()
    ones = torch.ones((48, 15))
    for n_taps, mask, tag, _ in (probes.prof_r5b.FMA_SETTINGS
                                 + probes.prof_r5b.MAPPING_SETTINGS):
        assert torch.equal(tet[tag].fn(), tk.tet_stripped_torch(
            x, ones, tk.tet_dirs(), n_taps, 5, mask))
    inner = tk.tet_mask(5, 5, "k0_shells", torch.device("cpu")).bool()
    inner[0] = False
    lane = np.arange(25)
    inner &= torch.tensor((lane // 5 > 0) & (lane % 5 > 0))
    assert inner.any()
    assert (stripped - real)[:, inner].abs().max() <= 1e-5 * real.abs().max()


def test_ladder_refuses_the_cpu():
    from hyteg_tpu_torch import probes
    with pytest.raises(RuntimeError, match="CUDA"):
        probes.ladder("jax", device="cpu", card="none")


def test_summary_orders_the_ladder():
    from hyteg_tpu_torch import probes
    rows = [{"shape_set": "jax", "kind": "box", "block": [3, 9],
             "ladder": lad, "probe": lad or "apply", "ms": ms,
             "share_of_real": ms / 4.0}
            for lad, ms in (("real", 4.0), (None, 5.0), ("copy", 1.0),
                            ("shifted 15", 3.0), ("no-shift 1", 2.0))]
    (line,) = probes.summary(rows)
    assert [s[0] for s in line["ladder"]] == ["copy", "no-shift 1",
                                              "shifted 15", "real"]
    assert line["ladder"][-1][3] == 1.0


@pytest.mark.parametrize("N,pitch", [(5, 5), (5, 7), (9, 9)])
@pytest.mark.parametrize("mask", tk.MASKS)
def test_active_warps_counts_the_masked_groups(N, pitch, mask):
    """A brute-force count of the 32-slot groups of one cell that hold a
    slot of the mask, with a warp of 8 so that small cells have several."""
    from hyteg_tpu_torch.probes.prof_r5b import active_warps
    n = N - 1
    slots = [x * N * pitch + y * pitch + z for x in range(N)
             for y in range(N) for z in range(pitch)
             if mask == "none" or (z < N and x + y + z <= n
                                   and (mask == "k0" or x + y + z < n))]
    assert active_warps(N, pitch, mask, warp=8) == len({q // 8 for q in slots})


def test_summary_counts_warps_of_a_tet_block():
    from hyteg_tpu_torch import probes
    rows = [{"shape_set": "main", "kind": "tet", "block": [48, 129, 16641],
             "ladder": "real", "probe": "tet kernel only", "ms": 1.0,
             "share_of_real": 1.0}]
    (line,) = probes.summary(rows)
    assert line["active_warps_per_cell"] == {"none": 67085, "k0": 23409,
                                             "k0_shells": 15520}


def test_cli_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI times it instead")
    proc = subprocess.run([sys.executable, "-m", "hyteg_tpu_torch.probes",
                           "--shape", "jax"], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and proc.stdout == ""
