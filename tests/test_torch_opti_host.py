"""The port's host front end against the JAX package's: the lattice builder
(``design``), boundary conditions (``fem.bc``), config, materials and
gradient tables, and ``native`` (its g++ build and its numpy path), on the
presets and goldens of ``tests/test_lattice.py`` / ``tests/test_presets.py``
and a hybrid BCC+Hybrid1 case; then ``optimize_lattice``'s routing, the
density model's file handling and the state carried across by
``convert``.  Host numpy on both sides: equal arrays, no tolerance.  No JAX
program is compiled here.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pylatticedso_tpu import build_lattice as jax_build
from pylatticedso_tpu.config import load_config as jax_load_config
from pylatticedso_tpu.fem.bc import apply_boundary_conditions as jax_bc
from pylatticedso_tpu.gradients import gradient_factor_table as jax_gft
from pylatticedso_tpu.gradients import material_field as jax_mf
from pylatticedso_tpu.opti.density import KrigingDensity as JaxKriging
from pylatticedso_tpu.opti.parameterization import \
    make_parameterization as jax_make_param

from pylatticedso_tpu_torch import convert, native
from pylatticedso_tpu_torch.config import load_config
from pylatticedso_tpu_torch.design import build_lattice
from pylatticedso_tpu_torch.fem.bc import apply_boundary_conditions
from pylatticedso_tpu_torch.gradients import (gradient_factor_table,
                                              material_field)
from pylatticedso_tpu_torch.materials import MatProperties
from pylatticedso_tpu_torch.opti import optimize_lattice
from pylatticedso_tpu_torch.opti.density import KrigingDensity, filter_outliers
from pylatticedso_tpu_torch.opti.optimizer import OptimizationProblem
from pylatticedso_tpu_torch.opti.parameterization import make_parameterization
from pylatticedso_tpu_torch.opti.structured_optimizer import \
    StructuredOptimizationProblem

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PRESETS = sorted((ROOT / "data/inputs/preset_lattice").rglob("*.json"))
OCTET_FIT = ROOT / "data/outputs/density_datasets/Octet_0.01_0.1_10.gpr.npz"
ARRAYS = ("nodes", "node_tag", "edges", "radius", "edge_type", "edge_mat",
          "cell_pos", "cell_origin", "cell_size", "cell_radii",
          "cell_edge_ptr", "cell_edge_idx", "cell_node_ptr", "cell_node_idx",
          "edge_cell")
CLAMP_LOAD = {
    "Displacement": {"Fixed": {"Surface": ["Xmin"],
                               "DOF": ["X", "Y", "Z", "RX", "RY", "RZ"],
                               "Value": [0, 0, 0, 0, 0, 0]}},
    "Force": {"Load": {"Surface": ["Xmax"], "DOF": ["Z"], "Value": [-0.1]}}}


def _geometry(n, geoms, radii, cell=(1, 1, 1)):
    return {"cell_size": dict(zip("xyz", cell)),
            "number_of_cells": dict(zip("xyz", n)),
            "radii": radii, "geom_types": geoms}


GOLDENS = {
    "bcc_single": {"geometry": _geometry((1, 1, 1), ["BCC"], [0.1])},
    "bcc_222": {"geometry": _geometry((2, 2, 2), ["BCC"], [0.1])},
    "octet_graded": {"geometry": _geometry((3, 2, 2), ["Octet"], [0.08],
                                           (1.5, 1, 2))},
    "hybrid_split": {"geometry": _geometry((2, 2, 1), ["BCC", "Hybrid1"],
                                           [0.05, 0.06])},
    "kelvin_gradients_erased": {
        "geometry": _geometry((3, 3, 3), ["Kelvin"], [0.05]),
        "gradient": {"radii": {"rule": "linear", "direction_x": True,
                               "parameter_x": 0.2},
                     "cell_dimension": {"rule": "linear", "direction_z": True,
                                        "parameter_z": 0.1}},
        "supplementary": {"erased_blocks": {"b1": {
            "start_point": {"x": 0.0, "y": 0.0, "z": 0.0},
            "dimensions_block": {"x": 0.5, "y": 0.5, "z": 0.5}}}}},
    "bcc_random": {"geometry": dict(_geometry((2, 2, 2), ["BCC"], [0.05]),
                                    enable_randomness=True,
                                    range_radius=[0.02, 0.08])},
    "cubic_shared": {"geometry": _geometry((2, 1, 1), ["Cubic"], [0.05])},
    # the hybrid case of the optimizer tests, with its load
    "bcc_hybrid1_bc": {"geometry": _geometry((2, 2, 2), ["BCC", "Hybrid1"],
                                             [0.05, 0.04]),
                       "boundary_conditions": CLAMP_LOAD},
    "octet_cantilever_bc": {"geometry": _geometry((3, 2, 2), ["Octet"],
                                                  [0.05]),
                            "boundary_conditions": CLAMP_LOAD},
}


def _lattice_cases():
    cases = [pytest.param(cfg, id=name) for name, cfg in GOLDENS.items()]
    for p in PRESETS:
        cfg = json.loads(p.read_text())
        if "geometry" not in cfg:
            continue                 # a Pyrough parameter file, no lattice
        n = cfg["geometry"]["number_of_cells"]
        if n["x"] * n["y"] * n["z"] > 600:
            continue                 # large presets: parse-only in CI
        cases.append(pytest.param(cfg, id=f"{p.parent.name}/{p.stem}"))
    return cases


def _assert_same_lattice(a, b):
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.name == b.name
    assert a.get_relative_density() == b.get_relative_density()


@pytest.mark.parametrize("cfg", _lattice_cases())
def test_lattice_and_bc_arrays_equal_the_jax_package(cfg):
    a, b = jax_build(cfg), build_lattice(cfg)
    _assert_same_lattice(a, b)
    if cfg.get("boundary_conditions"):
        ja, tb = jax_bc(a), apply_boundary_conditions(b)
        for name in ("fixed", "u_imposed", "f_applied"):
            np.testing.assert_array_equal(getattr(ja, name),
                                          getattr(tb, name), err_msg=name)


@pytest.mark.parametrize("path", [p for p in PRESETS if "geometry" in
                                  json.loads(p.read_text())],
                         ids=lambda p: f"{p.parent.name}/{p.stem}")
def test_configs_parse_the_same(path):
    data = json.loads(path.read_text())
    ja, tb = jax_load_config(data), load_config(data)
    assert dataclasses.asdict(ja) == dataclasses.asdict(tb)


def test_numpy_path_without_a_compiler(monkeypatch):
    """Without g++ the builder's dedup and sorts run in numpy, with the
    same first-occurrence semantics: the same lattice."""
    cfg = GOLDENS["hybrid_split"]
    want = build_lattice(cfg)
    assert native.available()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert not native.available()
    _assert_same_lattice(want, build_lattice(cfg))


def test_gradient_tables_and_materials():
    for rule in ("constant", "linear", "parabolic", "sinusoide",
                 "exponential"):
        np.testing.assert_array_equal(
            jax_gft((4, 3, 2), rule, (True, True, False), (0.1, 0.2, 0.3)),
            gradient_factor_table((4, 3, 2), rule, (True, True, False),
                                  (0.1, 0.2, 0.3)))
    for mm, d in ((0, 0), (1, 0), (1, 2)):
        np.testing.assert_array_equal(jax_mf((3, 2, 4), mm, d),
                                      material_field((3, 2, 4), mm, d))
    assert MatProperties("VeroClear").shear_modulus == \
        1013.0 / (2.0 * 1.3)
    with pytest.raises(FileNotFoundError):
        MatProperties("Unobtainium")


def _opti_lattice(n, sim_type, geom="BCC"):
    return build_lattice({
        "geometry": _geometry(n, [geom], [0.05]),
        "boundary_conditions": CLAMP_LOAD,
        "optimization_informations": {
            "simulation_type": sim_type, "objective_type": "compliance",
            "objective_function": "min",
            "optimization_parameters": {"type": "unit_cell"},
            "constraints": {"relative_density": {"value": 0.10,
                                                 "mode": "upper"}},
            "max_iterations": 1}})


def test_fem_auto_routes_to_the_structured_problem():
    lat = _opti_lattice((2, 1, 1), "FEM_AUTO")
    problem, res = optimize_lattice(
        lat, density_model=KrigingDensity.load(OCTET_FIT), device="cpu")
    assert isinstance(problem, StructuredOptimizationProblem)
    assert res.iterations >= 1 and np.isfinite(res.objective)


def test_non_uniform_lattice_falls_back_on_fem_auto():
    """FEM_AUTO catches only the structured problem's ValueError (here:
    cells of different radii) and runs the unstructured problem."""
    lat = build_lattice({
        "geometry": dict(_geometry((2, 1, 1), ["BCC"], [0.05]),
                         enable_randomness=True, range_radius=[0.02, 0.08]),
        "boundary_conditions": CLAMP_LOAD,
        "optimization_informations": {"simulation_type": "FEM_AUTO",
                                      "optimization_parameters":
                                          {"type": "constant"}}})
    problem, res = optimize_lattice(lat, max_iterations=1, device="cpu")
    assert type(problem) is OptimizationProblem
    with pytest.raises(ValueError, match="uniform"):
        StructuredOptimizationProblem(lat, device="cpu")


@pytest.mark.parametrize("sim_type", ["FEM_AUTO", "FEM_STRUCTURED"])
def test_warped_lattice_raises_instead_of_rerouting(sim_type):
    """A warped lattice runs structured, as in the JAX package: both
    routes build the structured problem on the warped stencil operator
    (the recorded maps composed into its node_transform); a seam-merged
    lattice (node_transforms None) still falls back on FEM_AUTO."""
    from pylatticedso_tpu_torch.design.transforms import curve_lattice
    lat = _opti_lattice((2, 1, 1), sim_type)
    curve_lattice(lat, center=(1.0, 0.5, 5.0), curvature_strength=0.02)
    problem, res = optimize_lattice(
        lat, density_model=KrigingDensity.load(OCTET_FIT), device="cpu")
    assert isinstance(problem, StructuredOptimizationProblem)
    assert problem._slat.node_transform is not None
    assert res.iterations >= 1 and np.isfinite(res.objective)
    if sim_type == "FEM_AUTO":
        from pylatticedso_tpu_torch.design.transforms import \
            cylindrical_transform
        lat = build_lattice({
            "geometry": _geometry((2, 2, 1), ["BCC"], [0.05]),
            "boundary_conditions": {
                "Displacement": {"Fixed": dict(
                    CLAMP_LOAD["Displacement"]["Fixed"], Surface=["Zmin"])},
                "Force": {"Load": dict(CLAMP_LOAD["Force"]["Load"],
                                       Surface=["Zmax"])}},
            "optimization_informations": {
                "simulation_type": sim_type,
                "optimization_parameters": {"type": "unit_cell"},
                "constraints": {"relative_density": {"value": 0.10,
                                                     "mode": "upper"}},
                "max_iterations": 1}})
        cylindrical_transform(lat, radius=2.0 / np.pi)
        assert lat.node_transforms is None      # the seam merged
        with pytest.raises(ValueError):
            StructuredOptimizationProblem(lat, device="cpu")
        problem, _res = optimize_lattice(
            lat, density_model=KrigingDensity.load(OCTET_FIT), device="cpu")
        assert type(problem) is OptimizationProblem


def test_ddm_routes(tmp_path, monkeypatch):
    """``"DDM"`` builds the surrogate-DDM problem and trains its surrogate
    with penalization on (the JAX package's default for the route), under
    the working directory (here a temporary one)."""
    from pylatticedso_tpu_torch.opti import ddm_optimizer
    monkeypatch.chdir(tmp_path)
    trained = []
    real = ddm_optimizer.build_schur_surrogate

    def spy(*args, **kwargs):
        trained.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(ddm_optimizer, "build_schur_surrogate", spy)
    lat = _opti_lattice((2, 1, 1), "DDM")
    problem, res = optimize_lattice(
        lat, density_model=KrigingDensity.load(OCTET_FIT), device="cpu")
    assert isinstance(problem, ddm_optimizer.DDMOptimizationProblem)
    assert len(trained) == 1 and trained[0]["penalization"] is True
    assert not problem.refined               # the CPU: plain float64 CG
    assert res.iterations >= 1 and np.isfinite(res.objective)


def test_unknown_driver_raises():
    lat = _opti_lattice((2, 1, 1), "FEM_AUTO")
    with pytest.raises(ValueError, match="driver"):
        optimize_lattice(lat, driver="newton",
                         density_model=KrigingDensity.load(OCTET_FIT),
                         device="cpu")


def test_fit_needs_scikit_learn(monkeypatch):
    """The density model's fit imports scikit-learn when it is called:
    without it, it raises ImportError (the card's machine has none)."""
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(ImportError):
        KrigingDensity.fit({(0.01,): 0.01, (0.05,): 0.11, (0.1,): 0.38})


def test_density_model_save_load_and_cache_rule(tmp_path, monkeypatch):
    """``save``/``load`` round-trip the fields; the problem loads the cached
    fit from data/outputs/density_datasets only when it is not older than
    its dataset (the JAX package's rule), else refits from the dataset."""
    model = KrigingDensity.load(OCTET_FIT)
    model.save(tmp_path / "m.npz")
    again = KrigingDensity.load(tmp_path / "m.npz")
    for f in ("X_train_scaled", "alpha", "length_scale", "scaler_mean",
              "scaler_scale"):
        np.testing.assert_array_equal(getattr(model, f), getattr(again, f))
    assert (model.const, model.y_mean, model.y_std) == \
        (again.const, again.y_mean, again.y_std)
    cache = tmp_path / "data/outputs/density_datasets"
    cache.mkdir(parents=True)
    pkl = cache / "BCC_0.01_0.1_10.pkl"
    pkl.write_bytes((ROOT / "data/outputs/density_datasets"
                     / "BCC_0.01_0.1_10.pkl").read_bytes())
    model.save(cache / "BCC_0.01_0.1_10.gpr.npz")
    monkeypatch.chdir(tmp_path)
    lat = _opti_lattice((1, 1, 1), "FEM")
    problem = OptimizationProblem(lat, device="cpu")
    np.testing.assert_array_equal(problem._density_model.alpha, model.alpha)
    fits = []
    monkeypatch.setattr(KrigingDensity, "fit",
                        classmethod(lambda cls, ds: fits.append(ds) or model))
    import os
    t = os.stat(pkl).st_mtime
    os.utime(cache / "BCC_0.01_0.1_10.gpr.npz", (t - 10, t - 10))
    OptimizationProblem(lat, device="cpu")
    assert len(fits) == 1 and len(fits[0]) == 10      # the cached dataset


def test_port_density_fit_is_the_jax_package_cache():
    """The chip run loads the Octet fit from the port's own tree
    (``smoke.OCTET_DENSITY_FIT``): the same bytes as the JAX package's
    cached fit, and the same model."""
    from pylatticedso_tpu_torch import smoke
    port = smoke.OCTET_DENSITY_FIT
    assert port.parent == ROOT / "pylatticedso_tpu_torch" / "fits"
    assert port.read_bytes() == OCTET_FIT.read_bytes()
    a, b = KrigingDensity.load(port), KrigingDensity.load(OCTET_FIT)
    r = torch.linspace(0.01, 0.1, 7, dtype=torch.float64)[:, None]
    assert torch.equal(a.mean(r), b.mean(r))


def test_port_hybrid_density_fit_is_the_jax_package_cache():
    """The DDM phase of the chip run loads the BCC+Hybrid1+Hybrid4 fit
    from the port's own tree (``smoke_ddm.HYBRID_DENSITY_FIT``): the same
    bytes as the JAX package's cached fit, and the same model."""
    from pylatticedso_tpu_torch import smoke_ddm
    port = smoke_ddm.HYBRID_DENSITY_FIT
    jax_fit = (ROOT / "data/outputs/density_datasets"
               / "BCC_Hybrid1_Hybrid4_0.01_0.1_10.gpr.npz")
    assert port.parent == ROOT / "pylatticedso_tpu_torch" / "fits"
    assert port.read_bytes() == jax_fit.read_bytes()
    a, b = KrigingDensity.load(port), KrigingDensity.load(jax_fit)
    r = torch.linspace(0.01, 0.1, 7, dtype=torch.float64)[:, None].repeat(1, 3)
    assert torch.equal(a.mean(r), b.mean(r))


def test_outlier_filter():
    ds = {(0.01 * k,): 0.01 * k * k for k in range(1, 11)}
    ds[(0.05,)] = 50.0
    kept = filter_outliers(ds)
    assert (0.05,) not in kept and len(kept) == 9


def test_convert_carries_the_jax_state_across():
    """The JAX package's density model and parameterization, as their
    numpy fields, become the port's with the same values."""
    jm = JaxKriging.load(OCTET_FIT)
    fields = {f.name: np.asarray(getattr(jm, f.name))
              for f in dataclasses.fields(jm)}
    tm = convert.kriging_from_jax(fields)
    assert isinstance(tm, KrigingDensity)
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(tm, f)), fields[f])
    lat_j = jax_build({"geometry": _geometry((3, 2, 2), ["Octet"], [0.05])})
    for opt in ({"type": "unit_cell"}, {"type": "constant"},
                {"type": "poly2", "terms": ["x", "y2", "xz"]}):
        jp = jax_make_param(lat_j, opt)
        tp = convert.parameterization_from_jax(
            {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})
        want = make_parameterization(build_lattice(
            {"geometry": _geometry((3, 2, 2), ["Octet"], [0.05])}), opt)
        for f in dataclasses.fields(want):
            x, y = getattr(tp, f.name), getattr(want, f.name)
            if isinstance(y, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y, f.name
