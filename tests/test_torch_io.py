"""IO, the function registry and the native setup core of the PyTorch port
against the JAX package on the same inputs:

- VTK: P1 and P2 fields in 2D and 3D (a red-green refined mesh too), binary
  and ASCII: the XML equal outside the base64 payloads, the decoded
  connectivity, offsets and types equal, the points within 1e-12 and the
  values exactly; the partitioning VTU byte for byte;
- ``write_msh2`` byte for byte, and read back by ``from_gmsh_file``;
- the tables: the SQLite contents, the LaTeX and text tables equal; numpy
  scalars stored as numbers where the JAX package stores text (C-ref19);
- the registry and block function (tests/test_registry.py's cases; an
  unknown name in ``remove`` raises, unlike the JAX package: C-ref3);
- the native setup core against the JAX package's and the numpy
  fallbacks (tests/test_native.py's cases), and ``morton_codes`` through
  ``loadbalancing``;
- the convection app with ``--vtk-every 1`` on the CPU, which writes T on
  its P2 node grid (the JAX app's call does not fit it: C-ref20).
"""

import base64
import json
import sqlite3
import struct
import xml.etree.ElementTree as ET

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyteg_tpu import native as jnative
from hyteg_tpu import adaptivity as jad
from hyteg_tpu.core import types as jt
from hyteg_tpu.functions.p1 import P1Space as JSpace
from hyteg_tpu.functions.p2 import P2Space as JP2Space
from hyteg_tpu.functions.registry import BlockFunction as JBlock
from hyteg_tpu.functions.registry import FEFunctionRegistry as JRegistry
from hyteg_tpu.io import gmsh as jgmsh
from hyteg_tpu.io import tables as jtables
from hyteg_tpu.io import vtk as jvtk
from hyteg_tpu.mesh import meshinfo as jmi
from hyteg_tpu.primitives import loadbalancing as jlb
from hyteg_tpu.primitives.storage import CellStorage as JStorage
from hyteg_tpu_torch import adaptivity as tad
from hyteg_tpu_torch import interop
from hyteg_tpu_torch import native
from hyteg_tpu_torch.composites.stokes import TaylorHoodVec
from hyteg_tpu_torch.functions.p1 import P1Space
from hyteg_tpu_torch.functions.p2 import P2Space
from hyteg_tpu_torch.functions.registry import BlockFunction, FEFunctionRegistry
from hyteg_tpu_torch.io import gmsh, tables, vtk
from hyteg_tpu_torch.mesh import meshinfo as tmi
from hyteg_tpu_torch.primitives import loadbalancing
from hyteg_tpu_torch.primitives.storage import CellStorage

torch.set_num_threads(1)

T = lambda a: interop.block_from_reference(np.asarray(a), device="cpu")  # noqa: E731

_TYPES = {"Float64": np.float64, "Float32": np.float32, "Int64": np.int64,
          "UInt8": np.uint8}


def read_vtu(path):
    """(XML with every DataArray's text blanked, {name: array}) of a VTU
    file: binary payloads decoded (UInt32 byte count + raw data), ASCII
    ones parsed."""
    root = ET.parse(path).getroot()
    arrays = {}
    for el in root.iter("DataArray"):
        dt = _TYPES[el.get("type")]
        name = el.get("Name") or "points"
        if el.get("format") == "binary":
            raw = base64.b64decode(el.text.strip())
            (nb,) = struct.unpack("<I", raw[:4])
            assert nb == len(raw) - 4
            arrays[name] = np.frombuffer(raw[4:], dtype=dt)
        else:
            arrays[name] = np.array(el.text.split(), dtype=np.float64).astype(dt)
        el.text = ""
    return ET.tostring(root), arrays


def _same_vtu(got_path, ref_path):
    gx, ga = read_vtu(got_path)
    rx, ra = read_vtu(ref_path)
    assert gx == rx
    assert ga.keys() == ra.keys()
    for name in ("connectivity", "offsets", "types"):
        np.testing.assert_array_equal(ga[name], ra[name])
    assert np.abs(ga["points"] - ra["points"]).max() <= 1e-12
    for name in ga.keys() - {"connectivity", "offsets", "types", "points"}:
        assert ga[name].dtype == ra[name].dtype
        np.testing.assert_array_equal(ga[name], ra[name])
    return ga


def _mesh(name):
    if name == "cube":
        return jmi.mesh_unit_cube(1), tmi.mesh_unit_cube(1)
    if name == "rect":
        return jmi.mesh_rectangle(nx=2, ny=2), tmi.mesh_rectangle(nx=2, ny=2)
    if name == "cube_rg":
        return (jad.refine_rg(jmi.mesh_unit_cube(1), [0]).mesh,
                tad.refine_rg(tmi.mesh_unit_cube(1), [0]).mesh)
    return (jmi.mesh_annulus(0.5, 1.0, 6, 1), tmi.mesh_annulus(0.5, 1.0, 6, 1))


def _field(p):
    return jnp.sin(3 * p[..., 0]) + p[..., 1] * p[..., 2] - 0.5 * p[..., 1]


VTK_CASES = [("cube", 1, 2), ("cube_rg", 1, 2), ("rect", 1, 3),
             ("annulus", 1, 2), ("cube", 2, 1), ("rect", 2, 2)]


@pytest.mark.parametrize("name,degree,level", VTK_CASES)
def test_vtk_matches_jax(tmp_path, name, degree, level):
    jm, tm = _mesh(name)
    js, ts = JStorage(jm), CellStorage(tm)
    if degree == 2:
        jsp, tsp = JP2Space(js, level), P2Space(ts, level, device="cpu")
    else:
        jsp, tsp = JSpace(js, level), P1Space(ts, level, device="cpu")
    bc = jt.BoundaryCondition.all_dirichlet()
    u = jsp.interpolate(_field, jsp.zeros(), jt.DoFType.ALL, bc)
    node_level = level + 1 if degree == 2 else level
    for ascii_ in (False, True):
        ref = jvtk.VTKOutput(str(tmp_path / "jax"), "sol", js)
        ref.add("u", jsp, u)
        ref.add("v", jsp, 2 * u)
        got = vtk.VTKOutput(str(tmp_path / "port"), "sol", ts)
        got.add("u", tsp, T(u))
        got.add("v", tsp, T(2 * u))
        arrays = _same_vtu(got.write(node_level, 3, ascii=ascii_),
                           ref.write(node_level, 3, ascii=ascii_))
        nc = {2: 4 ** node_level, 3: 8 ** node_level}[tm.dim]
        assert arrays["types"].shape == (tm.num_elements * nc,)
    if degree == 2:
        # the JAX app's call (the P2 level) does not fit the node grid
        with pytest.raises(ValueError):
            ref.write(level)
        with pytest.raises(ValueError, match="node grid"):
            got.write(level)


def test_vtk_takes_a_bf16_block(tmp_path):
    """A bf16 block is written as its f32 values."""
    ts = CellStorage(tmi.mesh_unit_cube(1))
    sp = P1Space(ts, 2, device="cpu", dtype=torch.bfloat16)
    u = sp.interpolate(lambda p: p[..., 0] + 0.3, sp.zeros(),
                       jt.DoFType.ALL, jt.BoundaryCondition.all_dirichlet())
    out = vtk.VTKOutput(str(tmp_path), "b", ts)
    out.add("u", sp, u)
    _, arrays = read_vtu(out.write(2))
    grid = u.float().reshape(6, 5, 5, 5)[..., :5].reshape(-1).numpy()
    np.testing.assert_array_equal(arrays["u"], grid)


@pytest.mark.parametrize("name,shards", [("cube", 1), ("cube", 4),
                                         ("rect", 3), ("cube_rg", 5)])
def test_partitioning_vtu_and_msh_identical_bytes(tmp_path, name, shards):
    jm, tm = _mesh(name)
    ref = jvtk.write_domain_partitioning_vtk(
        JStorage(jm, num_shards=shards), str(tmp_path / "jax"), "dom")
    got = vtk.write_domain_partitioning_vtk(
        CellStorage(tm, num_shards=shards), str(tmp_path / "port"), "dom")
    assert open(got, "rb").read() == open(ref, "rb").read()
    jgmsh.write_msh2(jm, str(tmp_path / "jax.msh"))
    gmsh.write_msh2(tm, str(tmp_path / "port.msh"))
    assert (tmp_path / "port.msh").read_bytes() == (tmp_path / "jax.msh").read_bytes()
    back = tmi.from_gmsh_file(str(tmp_path / "port.msh"))
    assert back.dim == tm.dim
    np.testing.assert_array_equal(back.points, tm.points)
    np.testing.assert_array_equal(back.elements, tm.elements)
    np.testing.assert_array_equal(
        back.vertex_boundary_flag,
        tm.with_computed_boundary_flags().vertex_boundary_flag)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


def _db_rows(path):
    with sqlite3.connect(str(path)) as con:
        schema = con.execute("SELECT sql FROM sqlite_master").fetchall()
        rows = con.execute("SELECT * FROM runs").fetchall()
        kinds = con.execute(
            "SELECT typeof(iteration), typeof(residual), typeof(solver), "
            "typeof(level) FROM runs").fetchall()
    return schema, rows, kinds


def _fill(mod, path, values):
    db = mod.FixedSizeSQLDB(str(path))
    db.set_constant_entry("solver", "gmg")
    db.set_constant_entry("level", 5)
    for it, res in enumerate(values):
        db.set_variable_entry("iteration", it)
        db.set_variable_entry("residual", res)
        db.write_row_on_root()


def test_sql_db_matches_jax(tmp_path):
    _fill(jtables, tmp_path / "jax.db", [1.0, 0.1, 0.01])
    _fill(tables, tmp_path / "port.db", [1.0, 0.1, 0.01])
    assert _db_rows(tmp_path / "port.db") == _db_rows(tmp_path / "jax.db")
    _, rows, _ = _db_rows(tmp_path / "port.db")
    assert rows == [(0, 5, 1.0, "gmg"), (1, 5, 0.1, "gmg"), (2, 5, 0.01, "gmg")]
    for mod in (jtables, tables):
        db = mod.FixedSizeSQLDB(str(tmp_path / f"{mod.__name__}.x.db"))
        db.set_variable_entry("a", 1)
        db.write_row_on_root()
        db.set_variable_entry("b", 2)
        with pytest.raises(ValueError):
            db.write_row_on_root()


def test_sql_db_numbers_stay_numbers(tmp_path):
    """C-ref19: the JAX package stores an np.float32 or np.int64 (not a
    Python int, float or bool) as text; the port stores it, and a 0-d
    tensor, as a number."""
    vals = [np.float32(0.5), np.float32(0.125)]
    _fill(jtables, tmp_path / "jax.db", vals)
    _fill(tables, tmp_path / "port.db", vals)
    _, ref_rows, ref_kinds = _db_rows(tmp_path / "jax.db")
    assert ref_kinds[0] == ("integer", "text", "text", "integer")
    assert ref_rows[0][2] == "0.5"
    _, rows, kinds = _db_rows(tmp_path / "port.db")
    assert kinds == [("integer", "real", "text", "integer")] * 2
    assert [r[2] for r in rows] == [0.5, 0.125]
    _fill(tables, tmp_path / "t.db", [torch.tensor(0.25), np.int64(3)])
    _, rows, kinds = _db_rows(tmp_path / "t.db")
    assert [r[2] for r in rows] == [0.25, 3.0]
    assert kinds[0][1] == "real"


def test_keyvalue_and_tables_match_jax(tmp_path):
    outs = {}
    for tag, mod in (("jax", jtables), ("port", tables)):
        kv = mod.KeyValueStore()
        kv.store("dofs", 12345)
        kv.store("time", 1.5)
        kv.store("solver", "gmg")
        assert kv["dofs"] == 12345
        kv.write_latex(str(tmp_path / f"{tag}.kv.tex"), prefix="run/")
        t = mod.Table(["level", "error", "rate"])
        t.add_row(3, 1e-2, "-")
        t.add_row(4, 2.5e-3, 4.0)
        t.add_element(1, "rate", 4.0)
        t.add_element(3, "error", 7e-4)
        with pytest.raises(ValueError):
            t.add_row(1, 2)
        t.write_latex(str(tmp_path / f"{tag}.t.tex"))
        t.write_text(str(tmp_path / f"{tag}.t.txt"))
        outs[tag] = (str(kv), str(t))
    assert outs["port"] == outs["jax"]
    for ext in ("kv.tex", "t.tex", "t.txt"):
        assert ((tmp_path / f"port.{ext}").read_text()
                == (tmp_path / f"jax.{ext}").read_text())
    assert "run/dofs/.initial = {12345}" in (tmp_path / "port.kv.tex").read_text()
    kv = tables.KeyValueStore()
    kv.store("r", torch.tensor(0.5))
    assert str(kv) == "r  0.5"


# ---------------------------------------------------------------------------
# registry and block function
# ---------------------------------------------------------------------------


def test_registry_matches_jax():
    for mod, arr in ((JRegistry, jnp.ones), (FEFunctionRegistry, torch.ones)):
        reg = mod()
        reg.add("u", "P1", arr(3))
        reg.add("T", "P1", arr(3))
        reg.add("p", "P0", arr(2))
        assert set(reg.names("P1")) == {"u", "T"}
        assert reg.names("P0") == ["p"] and reg.names() == ["u", "T", "p"]
        assert reg.kind("p") == "P0" and reg.get("p").shape == (2,)
        assert "u" in reg and len(reg) == 3
        with pytest.raises(ValueError):
            reg.add("u", "P2", arr(1))
        reg.remove("u")
        assert "u" not in reg
        assert [n for n, _ in reg.items("P1")] == ["T"]
    # C-ref3: the JAX registry ignores an unknown name; the port raises
    JRegistry().remove("nothing")
    with pytest.raises(KeyError):
        FEFunctionRegistry().remove("nothing")


def test_block_function_matches_jax():
    a_np = (np.array([1.0, 2.0], np.float32), np.array([[3.0]], np.float32))
    b_np = (np.array([0.5, 0.5], np.float32), np.array([[2.0]], np.float32))
    ja = JBlock(tuple(map(jnp.asarray, a_np)))
    jb = JBlock(tuple(map(jnp.asarray, b_np)))
    ta = BlockFunction(tuple(map(torch.as_tensor, a_np)))
    tb = BlockFunction(tuple(map(torch.as_tensor, b_np)))
    jc, tc = 2.0 * (ja + jb) - ja, 2.0 * (ta + tb) - ta
    for k in range(2):
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
    np.testing.assert_array_equal((ta * 3.0)[1].numpy(), np.asarray((ja * 3.0)[1]))
    assert float(ta.dot(tb)) == float(ja.dot(jb)) == pytest.approx(7.5)
    assert float(ta.norm()) == pytest.approx(float(ja.norm()), rel=1e-7)
    z = ta.zeros_like()
    assert float(z.norm()) == 0.0 and z[1].shape == (1, 1) and len(z) == 2
    # per-component dots
    jw = JBlock((jnp.ones(2), jnp.ones(3)),
                dots=(lambda x, y: 2.0 * jnp.sum(x * y),
                      lambda x, y: jnp.sum(x * y)))
    tw = BlockFunction((torch.ones(2), torch.ones(3)),
                       dots=(lambda x, y: 2.0 * torch.sum(x * y),
                             lambda x, y: torch.sum(x * y)))
    assert float(tw.dot(tw)) == float(jw.dot(jw)) == 7.0
    assert tw.zeros_like().dots == tw.dots
    with pytest.raises(ValueError):
        BlockFunction((torch.ones(2),), dots=(None, None))


def test_block_function_nested_leaves():
    """The flat dot sums over every tensor leaf (nested blocks, dataclass
    vectors such as TaylorHoodVec, Python numbers), as jax.tree.leaves
    walks them."""
    rng = np.random.default_rng(3)
    v, p, w = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 4), (3,), (5,)))
    t = BlockFunction((TaylorHoodVec(torch.as_tensor(v), torch.as_tensor(p)),
                       BlockFunction((torch.as_tensor(w), 2.0))))
    j = JBlock(((jnp.asarray(v), jnp.asarray(p)),
                JBlock((jnp.asarray(w), 2.0))))
    np.testing.assert_allclose(float(t.dot(t)), float(j.dot(j)), rtol=1e-6)
    s = t + t
    np.testing.assert_array_equal(s[0].vel.numpy(), 2 * v)
    z = t.zeros_like()
    assert float(z.dot(z)) == 0.0 and isinstance(z[0], TaylorHoodVec)


# ---------------------------------------------------------------------------
# native setup core
# ---------------------------------------------------------------------------


def _numpy_morton(pts, bits=16):
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    q = ((pts - lo) / np.where(hi - lo == 0, 1.0, hi - lo)
         * ((1 << bits) - 1)).astype(np.uint64)
    ref = np.zeros(len(pts), dtype=np.uint64)
    for b in range(bits):
        for d in range(pts.shape[1]):
            ref |= (((q[:, d] >> np.uint64(b)) & np.uint64(1))
                    << np.uint64(b * pts.shape[1] + d))
    return ref


@pytest.fixture
def fallback(monkeypatch):
    """The port's native module with its library switched off."""
    monkeypatch.setattr(native, "_lib", False)
    return native


def test_native_builds_into_the_build_dir():
    assert native.available(), "g++ is on the host: the build must succeed"
    assert native._LIB.endswith("hyteg_tpu_torch/_build/_setup_core.so")
    assert jnative.available()


def test_native_morton_matches_jax_and_numpy(fallback):
    rng = np.random.default_rng(0)
    cases = [rng.uniform(-2, 5, size=(257, dim)) for dim in (2, 3)]
    cases.append(np.zeros((4, 3)))  # a degenerate box
    native._lib = None
    got = [native.morton_codes(p, bits=16) for p in cases]
    got8 = native.morton_codes(cases[1], bits=8)
    for p, g in zip(cases, got):
        np.testing.assert_array_equal(g, jnative.morton_codes(p, bits=16))
        np.testing.assert_array_equal(g, _numpy_morton(p))
        np.testing.assert_array_equal(loadbalancing.morton_codes(p),
                                      jlb.morton_codes(p))
    np.testing.assert_array_equal(got8, _numpy_morton(cases[1], 8))
    native._lib = False
    for p, g in zip(cases, got):
        np.testing.assert_array_equal(fallback.morton_codes(p, bits=16), g)
        np.testing.assert_array_equal(loadbalancing.morton_codes(p), g)


def test_native_sorts_and_partition_match_jax_and_numpy(fallback):
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 2 ** 63, size=500).astype(np.uint64)
    keys[::7] = keys[0]  # ties: the sort is stable
    rows = rng.integers(0, 1000, size=(100, 4)).astype(np.int64)
    w = rng.uniform(0.1, 3.0, size=97)
    native._lib = None
    got = (native.argsort_u64(keys), native.sort_rows_i64(rows),
           native.greedy_partition(w, 5), native.greedy_partition(w[:6], 5))
    np.testing.assert_array_equal(got[0], np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(got[0], jnative.argsort_u64(keys))
    np.testing.assert_array_equal(got[1], np.sort(rows, axis=1))
    np.testing.assert_array_equal(got[1], jnative.sort_rows_i64(rows))
    np.testing.assert_array_equal(got[2], jnative.greedy_partition(w, 5))
    np.testing.assert_array_equal(got[2], loadbalancing.partition_greedy(5, w))
    np.testing.assert_array_equal(got[3], jnative.greedy_partition(w[:6], 5))
    assert set(got[3]) == set(range(5))
    native._lib = False
    np.testing.assert_array_equal(fallback.argsort_u64(keys), got[0])
    np.testing.assert_array_equal(fallback.sort_rows_i64(rows), got[1])
    np.testing.assert_array_equal(fallback.greedy_partition(w, 5), got[2])
    np.testing.assert_array_equal(fallback.greedy_partition(w[:6], 5), got[3])


# ---------------------------------------------------------------------------
# the convection app's snapshots
# ---------------------------------------------------------------------------


def test_convection_app_writes_a_readable_vtu(tmp_path):
    from hyteg_tpu_torch.apps import terraneo_convection as app

    params = dict(dim=2, ntan=6, nrad=1, level=2, rayleigh=1e4,
                  stokes_iters=20, stokes_rtol=1e-6, energy_cg_iters=120,
                  max_dt=5e-4, profile_bins=6)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(params))
    out = tmp_path / "out"
    assert app.main([str(cfg), "--steps", "2", "--device", "cpu", "--out",
                     str(out), "--vtk-every", "2"]) == 0
    assert not (out / "convection_ts1.vtu").exists()
    _, arrays = read_vtu(out / "convection_ts2.vtu")
    C, M = 12, (1 << (params["level"] + 1)) + 1  # the annulus, P2 node grid
    assert arrays["points"].shape == (C * M * M * 3,)
    assert arrays["T"].shape == (C * M * M,) and arrays["T"].dtype == np.float32
    assert arrays["types"].shape == (C * 4 ** (params["level"] + 1),)
    assert np.isfinite(arrays["points"]).all()
    assert np.isfinite(arrays["T"]).all()
    assert -0.05 <= arrays["T"].min() and arrays["T"].max() <= 1.05
