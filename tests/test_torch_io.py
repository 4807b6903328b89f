"""Port parity: the ``io`` package and ``plotting`` against the JAX
package's, on the CPU.

The exporters write the same bytes as JAX's from the same lattice (VTU,
PVD, Grasshopper JSON, cylinder and rough-wire STL, the homogenization
surface .msh); a checkpoint holds the same arrays and loads across the
two packages; a reference-style pickle the test writes itself (the
reference's classes stood in by modules of its own) loads into the same
arrays in both; the reference density loaders read a dataset made from
the repo's ``data/outputs/relative_densities/reference_density_comparison.json``
(never a download) and, where joblib and scikit-learn are installed, a
kriging dump the test writes; plotting runs under the Agg backend.  The
checks of ``tests/test_aux.py`` and ``tests/test_reference_pickle.py``
run on the port's modules as well."""

import json
import pickle
import struct
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from pylatticedso_tpu import build_lattice as jax_build
from pylatticedso_tpu.io import checkpoint as jck
from pylatticedso_tpu.io import export as jex
from pylatticedso_tpu.io import reference_density as jrd
from pylatticedso_tpu.io import reference_pickle as jrp

from pylatticedso_tpu_torch.design import build_lattice
from pylatticedso_tpu_torch.io import checkpoint as tck
from pylatticedso_tpu_torch.io import export as tex
from pylatticedso_tpu_torch.io import reference_density as trd
from pylatticedso_tpu_torch.io import reference_pickle as trp

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TABLE = ROOT / "data/outputs/relative_densities/reference_density_comparison.json"
ARRAYS = ("nodes", "node_tag", "edges", "radius", "edge_type", "edge_mat",
          "cell_pos", "cell_origin", "cell_size", "cell_radii",
          "cell_edge_ptr", "cell_edge_idx", "cell_node_ptr", "cell_node_idx",
          "edge_cell")


def _cfg(n=(2, 2, 2), geoms=("BCC",), radii=(0.05,)):
    return {"geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                         "number_of_cells": dict(zip("xyz", n)),
                         "radii": list(radii), "geom_types": list(geoms)}}


def _pair(cfg):
    jl, tl = jax_build(cfg), build_lattice(cfg)
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f))
    return jl, tl


def _same_files(tmp_path, write, name):
    """``write(module, path)`` with each package's module: the same bytes."""
    pj, pt = tmp_path / f"jax_{name}", tmp_path / f"port_{name}"
    write(jex, pj)
    write(tex, pt)
    assert pt.read_bytes() == pj.read_bytes(), name
    return pt


def test_exports_write_jax_bytes(tmp_path):
    jl, tl = _pair(_cfg())
    lat = lambda m: jl if m is jex else tl
    p = _same_files(tmp_path, lambda m, p: m.export_simulation_vtu(
        p, lat(m)), "lat.vtu")
    text = p.read_text()
    assert "UnstructuredGrid" in text and "connectivity" in text
    assert f'NumberOfCells="{tl.num_edges}"' in text
    _same_files(tmp_path, lambda m, p: m.write_pvd(
        p, ["a.vtu", "b.vtu"], [0.0, 1.0]), "c.pvd")
    for parts in (1, 2):
        outs = {}
        for m in (jex, tex):
            d = tmp_path / ("jax" if m is jex else "port") / str(parts)
            outs[m] = m.save_json_to_grasshopper(lat(m), d / "gh.json",
                                                 multiple_parts=parts)
        assert len(outs[tex]) == parts
        for a, b in zip(outs[jex], outs[tex]):
            assert Path(b).read_bytes() == Path(a).read_bytes()
    data = json.loads(Path(outs[tex][0]).read_text())
    assert len(data["nodesX"]) == 2 * len(data["radii"])


def test_stl_and_msh_exports_write_jax_bytes(tmp_path):
    jl, tl = _pair(_cfg((1, 1, 1)))
    lat = lambda m: jl if m is jex else tl
    p = _same_files(tmp_path, lambda m, p: m.write_stl_cylinders(
        p, lat(m), n_sides=6), "cyl.stl")
    raw = p.read_bytes()
    assert struct.unpack("<I", raw[80:84])[0] == tl.num_edges * 6 * 4
    p = _same_files(tmp_path, lambda m, p: m.write_stl_rough_wires(
        p, lat(m), n_sides=12, n_axial=10, rms=0.08), "rough.stl")
    ntri = struct.unpack("<I", p.read_bytes()[80:84])[0]
    assert ntri == tl.num_edges * (12 * 10 * 2 + 2 * 12)
    C = np.diag([100.0, 120.0, 140.0, 40.0, 45.0, 50.0])
    C[0, 1] = C[1, 0] = 30.0
    C[0, 2] = C[2, 0] = 25.0
    C[1, 2] = C[2, 1] = 28.0
    p = _same_files(tmp_path, lambda m, p: m.export_homogenization_surface_msh(
        p, C, n_theta=12, n_phi=16, fit_box=(2.0, 2.0, 2.0)), "surface.msh")
    text = p.read_text()
    assert "$MeshFormat" in text
    assert int(text.split("$Nodes\n")[1].split("\n")[0]) == 12 * 16


def test_checkpoint_roundtrip_and_cross_load(tmp_path):
    """A checkpoint holds the same arrays in both packages (an ``.npz``
    carries its members' write times, so its bytes differ between any two
    saves) and each package loads the other's."""
    jl, tl = _pair(_cfg())
    pj, pt = tmp_path / "jax.npz", tmp_path / "port.npz"
    jck.save_lattice(jl, pj)
    tck.save_lattice(tl, pt)
    dj, dt = np.load(pj), np.load(pt)
    assert sorted(dj.files) == sorted(dt.files)
    for k in dj.files:
        np.testing.assert_array_equal(dt[k], dj[k])
    for path in (pj, pt):
        lat2 = tck.load_lattice(path)
        for f in ARRAYS:
            np.testing.assert_array_equal(getattr(lat2, f), getattr(tl, f))
        assert lat2.config.geom_types == ["BCC"]
        assert lat2.get_relative_density() == tl.get_relative_density()
    tck.atomic_savez(tmp_path / "sub" / "x.npz", a=np.arange(3))
    np.testing.assert_array_equal(np.load(tmp_path / "sub" / "x.npz")["a"],
                                  np.arange(3))


# ------------------------------------------------------ reference pickles
def _reference_classes():
    """Classes standing in for the reference's, in modules named as its
    (``pyLatticeDesign.*``), registered only while the pickle is written."""
    names = {"pyLatticeDesign.lattice": "Lattice",
             "pyLatticeDesign.cell": "Cell", "pyLatticeDesign.beam": "Beam",
             "pyLatticeDesign.point": "Point"}
    mods, classes = {}, {}
    for mod, cls in names.items():
        m = types.ModuleType(mod)
        c = type(cls, (), {"__module__": mod})
        setattr(m, cls, c)
        mods[mod], classes[cls] = m, c
    mods["pyLatticeDesign"] = types.ModuleType("pyLatticeDesign")
    return mods, classes


def _write_reference_pickle(lat, path, shuffle_seed=0):
    """The reference's object graph of ``lat``: shared Point objects with
    global indices, Beams of each cell, cells with position, origin, size
    and radii, the lattice's scalars; beams listed in a shuffled order so
    the loader's index sort is exercised."""
    mods, K = _reference_classes()
    pts = []
    for i, (x, y, z) in enumerate(lat.nodes):
        p = K["Point"]()
        p.x, p.y, p.z, p.index, p.tag = float(x), float(y), float(z), i, \
            int(lat.node_tag[i])
        pts.append(p)
    beams = []
    for i, (a, b) in enumerate(lat.edges):
        bm = K["Beam"]()
        bm.point1, bm.point2 = pts[a], pts[b]
        bm.radius, bm.index = float(lat.radius[i]), i
        bm.type_beam, bm.material = int(lat.edge_type[i]), \
            int(lat.edge_mat[i])
        beams.append(bm)
    rng = np.random.default_rng(shuffle_seed)
    cells = []
    for c in range(lat.num_cells):
        ce = K["Cell"]()
        eids = lat.cell_edge_idx[lat.cell_edge_ptr[c]:lat.cell_edge_ptr[c + 1]]
        nids = lat.cell_node_idx[lat.cell_node_ptr[c]:lat.cell_node_ptr[c + 1]]
        ce.beams_cell = [beams[i] for i in rng.permutation(eids)]
        ce.points_cell = [pts[i] for i in nids]
        ce.pos = [int(v) for v in lat.cell_pos[c]]
        ce.coordinate = [float(v) for v in lat.cell_origin[c]]
        ce.size = [float(v) for v in lat.cell_size[c]]
        ce.radii = [float(v) for v in lat.cell_radii[c]]
        cells.append(ce)
    ref = K["Lattice"]()
    ref.cells, ref.nodes = cells, pts
    ref.geom_types = list(lat.config.geom_types)
    (ref.cell_size_x, ref.cell_size_y,
     ref.cell_size_z) = [float(v) for v in lat.config.cell_size]
    (ref.num_cells_x, ref.num_cells_y,
     ref.num_cells_z) = [int(v) for v in lat.config.num_cells]
    ref.radii = [float(r) for r in lat.config.radii]
    ref.name_lattice = "written_by_test"
    pts[0].applied_force = [0.0, 0.0, -1.0, 0.0, 0.0, 0.0]
    saved = {k: sys.modules.get(k) for k in mods}
    sys.modules.update(mods)
    try:
        with open(path, "wb") as fh:
            pickle.dump(ref, fh)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def test_reference_pickle_loads_like_jax(tmp_path):
    cfg = _cfg((2, 2, 1), radii=(0.08,))
    ours = build_lattice(cfg)
    pkl = tmp_path / "ref_lattice.pkl"
    _write_reference_pickle(ours, pkl)
    assert "pyLatticeDesign.lattice" not in sys.modules
    lt, lj = trp.load_reference_pickle(pkl), jrp.load_reference_pickle(pkl)
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(lt, f), getattr(lj, f))
        np.testing.assert_array_equal(getattr(lt, f), getattr(ours, f))
    assert lt.name == lj.name == "written_by_test"
    assert lt.config.geom_types == ["BCC"]
    assert lt.config.num_cells == (2, 2, 1)
    np.testing.assert_array_equal(lt._extras["f_applied"],
                                  lj._extras["f_applied"])
    assert lt._extras["f_applied"][0, 2] == -1.0
    np.testing.assert_allclose(lt.get_relative_density(),
                               ours.get_relative_density(), rtol=1e-9)
    junk = tmp_path / "junk.pkl"
    with open(junk, "wb") as fh:
        pickle.dump({"not": "a lattice"}, fh)
    with pytest.raises((ValueError, AttributeError)):
        trp.load_reference_pickle(junk)


# ------------------------------------------------------- reference density
def _bcc_dataset(tmp_path):
    """A ``RelativeDensities_BCC.pkl``-shaped dataset from the committed
    comparison table's rows of the reference's BCC densities."""
    rows = json.loads(TABLE.read_text())["bcc_single_radius"]
    path = tmp_path / "RelativeDensities_BCC.pkl"
    with open(path, "wb") as fh:
        pickle.dump({(np.float64(r["r"]),): r["reference_dataset"]
                     for r in rows}, fh)
    return path, rows


def test_reference_density_dataset(tmp_path):
    path, rows = _bcc_dataset(tmp_path)
    dt = trd.load_reference_density_dataset(path)
    assert dt == jrd.load_reference_density_dataset(path)
    assert len(dt) == len(rows)
    assert all(isinstance(k, tuple) and len(k) == 1
               and type(k[0]) is float for k in dt)
    assert all(0.0 < v < 1.0 for v in dt.values())


def test_reference_kriging(tmp_path):
    """A kriging dump shaped as the reference's (``{"model": pipeline}``)
    fitted on the committed densities: the port's closed form is the
    sklearn pipeline's predict and JAX's closed form."""
    joblib = pytest.importorskip("joblib")
    pytest.importorskip("sklearn")
    from sklearn.gaussian_process import GaussianProcessRegressor
    from sklearn.gaussian_process.kernels import RBF, ConstantKernel
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import StandardScaler

    path, _rows = _bcc_dataset(tmp_path)
    ds = trd.load_reference_density_dataset(path)
    X = np.array([list(k) for k in ds])
    y = np.array(list(ds.values()))
    pipe = Pipeline([("x_scaler", StandardScaler()),
                     ("gpr", GaussianProcessRegressor(
                         kernel=ConstantKernel() * RBF(length_scale=[1.0]),
                         alpha=1e-8, normalize_y=True, random_state=0))])
    pipe.fit(X, y)
    dump = tmp_path / "kriging_model_BCC"
    joblib.dump({"model": pipe, "meta": {"geom": "BCC"}}, dump)
    kt = trd.load_reference_kriging(dump)
    kj = jrd.load_reference_kriging(dump)
    xs = np.linspace(0.01, 0.11, 7).reshape(-1, 1)
    got = kt.mean(torch.tensor(xs)).numpy()
    np.testing.assert_allclose(got, pipe.predict(xs), rtol=1e-6, atol=1e-9)
    # an interpolating GPR's alpha is large and its terms cancel: the two
    # closed forms sum them in their own orders
    want = np.array([float(kj.mean(x)) for x in xs])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


# ---------------------------------------------------------------- plotting
def test_plotting_under_agg(tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    from pylatticedso_tpu_torch import plotting
    from pylatticedso_tpu_torch.fem.bc import apply_boundary_conditions

    lat = build_lattice({**_cfg((1, 1, 1)), "boundary_conditions": {
        "Displacement": {"Fixed": {"Surface": ["Zmin"],
                                   "DOF": ["X", "Y", "Z", "RX", "RY", "RZ"],
                                   "Value": [0, 0, 0, 0, 0, 0]}}}})
    bc = apply_boundary_conditions(lat)
    plotting.visualize_lattice(lat, enable_boundary_conditions=True, bc=bc,
                               voxel=True, save_path=tmp_path / "lat.png")
    plotting.plot_radius_distribution(lat, save_path=tmp_path / "hist.png")
    plotting.plot_convergence(
        [{"iteration": 0, "objective": 1.0, "relative_density": 0.1},
         {"iteration": 1, "objective": 0.5, "relative_density": 0.12}],
        save_path=tmp_path / "conv.png")
    plotting.plot_radius_field(lat, save_path=tmp_path / "field.png")
    plotting.plot_parity([0.1, 0.2, 0.3], [0.11, 0.19, 0.3],
                         save_path=tmp_path / "parity.png")
    C = np.diag([100.0, 120.0, 140.0, 40.0, 45.0, 50.0])
    plotting.visualize_homogenization_surface(C, n_theta=12, n_phi=16,
                                              save_path=tmp_path / "E.png")
    hyb = build_lattice(_cfg((2, 1, 1), ("BCC", "Hybrid1"), (0.08, 0.05)))
    plotting.subplot_lattice_hybrid_geometries(hyb,
                                               save_path=tmp_path / "hyb.png")
    pl = plotting.OptimizationPlotter()
    for o, d in [(1.0, 0.5), (0.7, 0.4), (0.55, 0.35)]:
        pl.on_iteration({"objective": o, "relative_density": d})
    assert len(pl.obj_hist) == 3
    pl.finalize(save_path=tmp_path / "opt.png")
    for name in ("lat", "hist", "conv", "field", "parity", "E", "hyb",
                 "opt"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0, name
