"""The port's per-cell Schur condensation (``ddm.schur``) against the JAX
package's, in float64 on the CPU:

* the dense condensation against the tracked BCC artifact
  (``data/outputs/schur_complement/Schur_complement_BCC.npz``, computed by
  ``examples/simulation/reduce_basis_greedy.py`` on the periodic cell
  without penalization) at ``test_ddm_schur.py``'s 1e-10, and against
  JAX's ``schur_complement`` within 1e-12, penalized and not;
* the chained condensation against the subdivided one, and the penalized
  chained radius-grid path against the penalized subdivided one (1e-12),
  its numpy path the same bits as JAX's;
* ``schur_batch`` and ``schur_batch_chained`` against JAX's ``vmap``
  (1e-12), and against their single-sample forms;
* ``schur_fe2`` against the exact condensation (1e-9);
* the junction assembly: an ordered sum, the same bits on repeat; a
  failed factor raises with the cell and its radii.

Every case builds its lattice in both packages from one config and first
asserts that the arrays are equal.  Tracked artifacts are opened
read-only, by explicit path.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pylatticedso_tpu import build_lattice as jax_build
from pylatticedso_tpu.ddm import schur as js
from pylatticedso_tpu.materials import MatProperties as JaxMat

from pylatticedso_tpu_torch.ddm import schur as ts
from pylatticedso_tpu_torch.design import build_lattice
from pylatticedso_tpu_torch.materials import MatProperties

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ARTIFACT = ROOT / "data/outputs/schur_complement/Schur_complement_BCC.npz"
E_MOD, NU = 1013.0, 0.3
HYBRID = ["BCC", "Hybrid1", "Hybrid4"]
ARRAYS = ("nodes", "edges", "radius", "edge_type", "cell_edge_idx",
          "cell_node_idx", "cell_radii")


def cell_config(geoms, radii, periodicity=True):
    return {"geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                         "number_of_cells": {"x": 1, "y": 1, "z": 1},
                         "radii": list(radii), "geom_types": list(geoms)},
            "simulation_parameters": {"enable": True, "material": "VeroClear",
                                      "periodicity": periodicity}}


def both(cfg):
    jl, tl = jax_build(cfg), build_lattice(cfg)
    for name in ARRAYS:
        assert np.array_equal(getattr(jl, name), getattr(tl, name)), name
    return jl, tl


def rel(a, b) -> float:
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def same_disc(dt, dj, names):
    for name in names:
        assert np.array_equal(getattr(dt, name), getattr(dj, name)), name


DISC = ("nodes", "edges", "parent_edge", "penalized", "edge_type",
        "boundary_dofs", "interior_dofs", "boundary_nodes", "weight")
CHAINED = ("nodes", "edges", "edge_type", "weight", "n_seg", "boundary_dofs",
           "interior_dofs", "boundary_nodes")


@pytest.mark.parametrize("i", [0, 4, 8])
def test_schur_matches_the_tracked_artifact(i):
    with np.load(ARTIFACT) as d:
        r = float(d["radius_values"][i][0])
        want = d["schur_matrices"][i]
    jl, tl = both(cell_config(["BCC"], [r]))
    disc = ts.discretize_cell(tl, penalization=False, periodicity=True)
    S = ts.schur_complement(disc, np.array([r]), E_MOD, NU, device="cpu")
    assert S.shape == want.shape == (48, 48) and S.dtype == torch.float64
    assert rel(S, want) < 1e-10
    jdisc = js.discretize_cell(jl, penalization=False, periodicity=True)
    same_disc(disc, jdisc, DISC)
    assert rel(S, np.asarray(js.schur_complement(jdisc, np.array([r]), E_MOD,
                                                 NU))) < 1e-12


@pytest.mark.parametrize("pen", [True, False], ids=["penalized", "plain"])
def test_schur_matches_jax(pen):
    jl, tl = both(cell_config(["BCC"], [0.05]))
    disc = ts.discretize_cell(tl, penalization=pen)
    jdisc = js.discretize_cell(jl, penalization=pen)
    same_disc(disc, jdisc, DISC)
    S = ts.schur_complement(disc, np.array([0.05]), E_MOD, NU, device="cpu")
    Sj = np.asarray(js.schur_complement(jdisc, np.array([0.05]), E_MOD, NU))
    assert rel(S, Sj) < 1e-12
    # symmetric, and a rigid translation of the boundary has no reaction
    S = S.numpy()
    np.testing.assert_allclose(S, S.T, atol=1e-8 * np.abs(S).max())
    u = np.zeros((disc.n_boundary_nodes, 6))
    u[:, 0] = 1.0
    assert np.abs(S @ u.reshape(-1)).max() <= 1e-7 * np.abs(S).max()


def test_chained_matches_subdivided_and_jax():
    jl, tl = both(cell_config(HYBRID, [0.1] * 3))
    r = np.array([0.053, 0.047, 0.031])
    d_sub = ts.discretize_cell(tl, 0, penalization=False, share_weights=True)
    d_ch = ts.discretize_cell_chained(tl, 0, share_weights=True)
    jd_ch = js.discretize_cell_chained(jl, 0, share_weights=True)
    same_disc(d_ch, jd_ch, CHAINED)
    assert len(d_sub.interior_dofs) > 3000      # subdivision really happened
    assert len(d_ch.interior_dofs) == 54
    S1 = ts.schur_complement(d_sub, r, E_MOD, NU, device="cpu").numpy()
    S2 = ts.schur_complement_chained(d_ch, r, E_MOD, NU, device="cpu")
    assert np.linalg.norm(S1 - S2.numpy()) / np.linalg.norm(S1) < 1e-12
    Sj = np.asarray(js.schur_complement_chained(jd_ch, r, E_MOD, NU))
    assert rel(S2, Sj) < 1e-12


def test_penalized_chained_matches_subdivided():
    """Per-sample penalized condensation (zone|core|zone chains) == the
    dense subdivided path with penalize_edges, on the 3-geometry cell; the
    numpy path gives JAX's bits."""
    mat = MatProperties("VeroClear")
    mus = np.array([[0.1, 0.07, 0.03], [0.02, 0.09, 0.04]])
    jl, tl = both(cell_config(HYBRID, [0.05] * 3))
    S_fast = ts.schur_penalized_batch(tl, mus, mat.young_modulus,
                                      mat.poisson_ratio, share_weights=True)
    jmat = JaxMat("VeroClear")
    assert np.array_equal(S_fast, js.schur_penalized_batch(
        jl, mus, jmat.young_modulus, jmat.poisson_ratio, share_weights=True))
    for i, mu in enumerate(mus):
        # rebuilt per sample: the zone lengths scale with the sample's radii
        _, lat = both(cell_config(HYBRID, [float(m) for m in mu]))
        d = ts.discretize_cell(lat, 0, penalization=True, share_weights=True)
        S_ref = ts.schur_complement(d, mu, mat.young_modulus,
                                    mat.poisson_ratio, device="cpu").numpy()
        assert np.linalg.norm(S_fast[i] - S_ref) / np.linalg.norm(S_ref) \
            < 1e-12, i


MUS = np.array([[0.1, 0.07, 0.03], [0.02, 0.09, 0.04], [0.05, 0.05, 0.05]])


def test_schur_batch_matches_vmap():
    jl, tl = both(cell_config(HYBRID, [0.05] * 3))
    d = ts.discretize_cell(tl, 0, target_h=0.3, penalization=False,
                           share_weights=True)
    jd = js.discretize_cell(jl, 0, target_h=0.3, penalization=False,
                            share_weights=True)
    same_disc(d, jd, DISC)
    S = ts.schur_batch(d, MUS, E_MOD, NU, device="cpu")
    assert S.shape == (3, 156, 156)
    assert rel(S, np.asarray(js.schur_batch(jd, MUS, E_MOD, NU))) < 1e-12
    for i, mu in enumerate(MUS):
        assert rel(S[i], ts.schur_complement(d, mu, E_MOD, NU,
                                             device="cpu")) < 1e-12


def test_schur_batch_chained_matches_vmap():
    jl, tl = both(cell_config(HYBRID, [0.05] * 3))
    d = ts.discretize_cell_chained(tl, 0, share_weights=True)
    jd = js.discretize_cell_chained(jl, 0, share_weights=True)
    S = ts.schur_batch_chained(d, MUS, E_MOD, NU, device="cpu")
    assert S.shape == (3, 156, 156) and S.dtype == torch.float64
    assert rel(S, np.asarray(js.schur_batch_chained(jd, MUS, E_MOD, NU))) \
        < 1e-12
    for i, mu in enumerate(MUS):
        assert torch.equal(S[i], ts.schur_complement_chained(
            d, mu, E_MOD, NU, device="cpu"))


def test_fe2_schur_matches_exact_condensation():
    """FE2 (column-wise inner FEM solves, lattice_sim.py:113,1238) equals
    the algebraic condensation of the same non-penalized discretization."""
    cfg = cell_config(["BCC"], [0.08], periodicity=False)
    cfg["boundary_conditions"] = {}
    jl, tl = both(cfg)
    mat = MatProperties("VeroClear")
    disc = ts.discretize_cell(tl, 0, target_h=0.3, penalization=False)
    S_exact = ts.schur_complement(disc, tl.cell_radii[0], mat.young_modulus,
                                  mat.poisson_ratio, device="cpu").numpy()
    S_fe2 = ts.schur_fe2(tl, 0, mat, target_h=0.3, device="cpu")
    assert np.linalg.norm(S_fe2 - S_exact) / np.linalg.norm(S_exact) < 1e-9


def test_junction_assembly_is_an_ordered_sum():
    """The junction stiffness sums each flat entry's contributions in
    ascending order (``EntrySum``, a ``SegmentSum`` over the distinct
    entries; no atomics): equal to numpy's sequential ``add.at`` bit for
    bit, and a condensation gives the same bits on repeat."""
    _, tl = both(cell_config(HYBRID, [0.05] * 3))
    d = ts.discretize_cell_chained(tl, 0, share_weights=True)
    P = len(d.edges)
    vals = np.random.default_rng(0).normal(size=(2, P, 12, 12))
    n6 = 6 * len(d.nodes)
    got = ts.element_entries(d.edges, len(d.nodes), "cpu")(
        torch.as_tensor(vals.reshape(2, -1)))
    assert got.shape == (2, n6, n6)
    dof = np.concatenate([d.edges[:, :1] * 6 + np.arange(6),
                          d.edges[:, 1:] * 6 + np.arange(6)], axis=1)
    rows = np.repeat(dof, 12, axis=1).reshape(-1)
    cols = np.tile(dof, (1, 12)).reshape(-1)
    for b in range(2):
        want = np.zeros((n6, n6))
        np.add.at(want, (rows, cols), vals[b].reshape(-1))
        assert np.array_equal(got[b].numpy(), want)
    S1 = ts.schur_batch_chained(d, MUS, E_MOD, NU, device="cpu")
    S2 = ts.schur_batch_chained(d, MUS, E_MOD, NU, device="cpu")
    assert torch.equal(S1, S2)


def test_failed_factor_raises_with_the_cell_and_radii():
    _, tl = both(cell_config(["BCC"], [0.05]))
    d = ts.discretize_cell_chained(tl, 0)
    with pytest.raises(ValueError, match=r"cell 0 .*radii \[\[0\.0\]\]"):
        ts.schur_complement_chained(d, np.array([0.0]), E_MOD, NU,
                                    device="cpu")
    ds = ts.discretize_cell(tl, 0, target_h=0.3, penalization=False)
    with pytest.raises(ValueError, match="not positive definite"):
        ts.schur_complement(ds, np.array([0.0]), E_MOD, NU, device="cpu")


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, tl = both(cell_config(["BCC"], [0.05]))
    d = ts.discretize_cell_chained(tl, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        ts.schur_complement_chained(d, np.array([0.05]), E_MOD, NU)
