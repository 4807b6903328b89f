"""The port's reduced-basis Schur surrogate (``ddm.surrogate``) against the
JAX package's, in float64 on the CPU:

* ``reduce_basis_greedy``: the same bytes as JAX's on the same Schur dict;
* the tracked reduced-basis artifact
  (``data/outputs/schur_complement/reduced_basis_BCC_tol_0.001.npz``)
  reconstructs the tracked Schur dataset for all three kinds, as JAX's
  does;
* the Fortran-order unravel on a non-symmetric basis vector;
* the RBF's value and gradient (closed form and autograd) against JAX's
  value, closed form and ``jax.grad``, away from and at a training point;
* the 1-D ``linear`` kind against ``jnp.interp`` inside and outside the
  samples;
* the save/load round trip, and a basis saved by JAX loaded by the port.

Tracked artifacts are opened read-only, by explicit path.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylatticedso_tpu.ddm import surrogate as jsu

from pylatticedso_tpu_torch.ddm import surrogate as tsu

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SC = ROOT / "data/outputs/schur_complement/Schur_complement_BCC.npz"
RB = ROOT / "data/outputs/schur_complement/reduced_basis_BCC_tol_0.001.npz"


def dataset():
    with np.load(SC) as d:
        return d["radius_values"].copy(), d["schur_matrices"].copy()


def test_greedy_is_the_same_bytes():
    rv, sm = dataset()
    schur_dict = {tuple(rv[i]): sm[i] for i in range(len(rv))}
    for tol in (1e-3, 1e-6):
        got = tsu.reduce_basis_greedy(schur_dict, tol)
        want = jsu.reduce_basis_greedy(schur_dict, tol)
        for a, b in zip(got, want):
            assert a.tobytes() == b.tobytes() and a.shape == b.shape
    B, A, _ = got
    np.testing.assert_allclose(B.T @ B, np.eye(B.shape[1]), atol=1e-10)


@pytest.mark.parametrize("kind", ["RBF", "nearest_neighbor", "linear"])
def test_tracked_basis_reconstructs_the_dataset(kind):
    """The tracked 3-vector basis (greedy tol 1e-3) over the tracked
    dataset: each sample within the basis' own error, and the same S as
    JAX's reconstruction (1e-12 of the largest entry)."""
    rv, sm = dataset()
    sur = tsu.SchurSurrogate.from_npz(RB, kind=kind, device="cpu")
    jsur = jsu.SchurSurrogate.from_npz(RB, kind=kind)
    assert sur.n_boundary == 48
    for i in (0, 4, 8):
        S = sur.reconstruct(rv[i])
        assert S.shape == (48, 48) and S.dtype == torch.float64
        err = np.abs(S.numpy() - sm[i]).max() / np.abs(sm[i]).max()
        assert err < 1e-2, f"{kind} i={i}: {err:.2e}"
        Sj = np.asarray(jsur.reconstruct(jnp.asarray(rv[i])))
        assert np.abs(S.numpy() - Sj).max() <= 1e-12 * np.abs(Sj).max()
    Sb = sur.reconstruct_batch(rv[[0, 4, 8]])
    Sbj = np.asarray(jsur.reconstruct_batch(jnp.asarray(rv[[0, 4, 8]])))
    assert Sb.shape == (3, 48, 48)
    assert np.abs(Sb.numpy() - Sbj).max() <= 1e-12 * np.abs(Sbj).max()


def test_fortran_order_unravel_of_a_nonsymmetric_vector():
    """basis @ alpha is unraveled column-major: S[i, j] = vec[i + j n]
    (a row-major reshape would give S^T, which a symmetric S hides)."""
    n = 3
    vec = np.arange(n * n, dtype=float) + 1.0           # not symmetric
    basis = vec[:, None]
    alpha = np.array([[1.0, 2.0]])
    samples = np.array([[0.01], [0.1]])
    sur = tsu.SchurSurrogate(basis, alpha, samples, kind="nearest_neighbor",
                             device="cpu")
    S = sur.reconstruct(np.array([0.01])).numpy()
    assert np.array_equal(S, vec.reshape(n, n, order="F"))
    assert not np.array_equal(S, S.T)
    jsur = jsu.SchurSurrogate(basis, alpha, samples, kind="nearest_neighbor")
    assert np.array_equal(S, np.asarray(jsur.reconstruct(jnp.array([0.01]))))
    Sb = sur.reconstruct_batch(np.array([[0.01], [0.1]])).numpy()
    assert np.array_equal(Sb[1], 2.0 * S)
    # the RBF kind's dS/dmu unravels the same way
    rbf = tsu.SchurSurrogate(np.stack([vec, vec[::-1]], 1),
                             np.array([[1.0, 2.0, 4.0], [0.5, 0.0, 1.0]]),
                             np.array([[0.01], [0.05], [0.1]]), device="cpu")
    jrbf = jsu.SchurSurrogate(np.stack([vec, vec[::-1]], 1),
                              np.array([[1.0, 2.0, 4.0], [0.5, 0.0, 1.0]]),
                              np.array([[0.01], [0.05], [0.1]]))
    np.testing.assert_allclose(rbf.gradient(np.array([0.03])).numpy(),
                               np.asarray(jrbf.gradient(jnp.array([0.03]))),
                               rtol=1e-12, atol=1e-12)


def _rbf_pair():
    rng = np.random.default_rng(0)
    X = rng.uniform(0.01, 0.1, size=(12, 2))
    Y = np.stack([np.sin(20 * X[:, 0]) + X[:, 1]**2, X[:, 0] * X[:, 1]],
                 axis=1)
    return X, tsu.ThinPlateSplineRBF(X, Y), jsu.ThinPlateSplineRBF(X, Y)


@pytest.mark.parametrize("at_sample", [False, True],
                         ids=["between", "at_a_training_point"])
def test_rbf_value_and_gradient_match_jax(at_sample):
    X, rbf, jrbf = _rbf_pair()
    x = X[3].copy() if at_sample else np.array([0.05, 0.06])
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    v = rbf.evaluate(xt)
    want = np.asarray(jrbf.evaluate(jnp.asarray(x)))
    np.testing.assert_allclose(v.detach().numpy(), want, rtol=1e-12,
                               atol=1e-14)
    G = rbf.gradient(xt.detach()).numpy()
    np.testing.assert_allclose(G, np.asarray(jrbf.gradient(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    # autograd of the value (finite at r = 0) equals jax.grad
    for k in range(2):
        (g,) = torch.autograd.grad(v[k], xt, retain_graph=True)
        jg = np.asarray(jax.grad(lambda z: jrbf.evaluate(z)[k])(
            jnp.asarray(x)))
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(g.numpy(), G[:, k], rtol=1e-10,
                                   atol=1e-12)
    # the batched form is the same expression
    vb = rbf.evaluate_batch(torch.tensor(np.stack([x, X[0]])))
    assert torch.equal(vb[0], v.detach())


def test_rbf_interpolates_the_training_points():
    rng = np.random.default_rng(1)
    X = rng.uniform(0, 1, size=(8, 1))
    Y = rng.normal(size=(8, 3))
    rbf = tsu.ThinPlateSplineRBF(X, Y)
    got = rbf.evaluate_batch(torch.tensor(X)).numpy()
    np.testing.assert_allclose(got, Y, atol=1e-9)


@pytest.mark.parametrize("x", [0.013, 0.02, 0.047, 0.1, 0.005, 0.2],
                         ids=["inside", "at_first_sample", "between",
                              "at_last_sample", "left_of_range",
                              "right_of_range"])
def test_linear_1d_matches_jnp_interp(x):
    rng = np.random.default_rng(2)
    samples = rng.permutation(np.round(np.arange(0.02, 0.101, 0.01), 3))
    alpha = rng.normal(size=(4, len(samples)))
    sur = tsu.SchurSurrogate(np.eye(4), alpha, samples[:, None],
                             kind="linear", device="cpu")
    jsur = jsu.SchurSurrogate(np.eye(4), alpha, samples[:, None],
                              kind="linear")
    got = sur.alpha_of(np.array([x])).numpy()
    want = np.asarray(jsur.alpha_of(jnp.array([x])))
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-15)
    order = np.argsort(samples)
    np.testing.assert_allclose(got, [np.interp(x, samples[order], a[order])
                                     for a in alpha], rtol=1e-12)


def test_linear_nd_outside_the_hull_raises():
    pts = np.array([[0.02, 0.02], [0.1, 0.02], [0.02, 0.1], [0.1, 0.1]])
    sur = tsu.SchurSurrogate(np.eye(4), np.eye(4), pts, kind="linear",
                             device="cpu")
    np.testing.assert_allclose(sur.alpha_of(np.array([0.06, 0.06])).numpy(),
                               jsu.SchurSurrogate(np.eye(4), np.eye(4), pts,
                                                  kind="linear").alpha_of(
                                   jnp.array([0.06, 0.06])), rtol=1e-14)
    with pytest.raises(ValueError, match="outside interpolation hull"):
        sur.alpha_of(np.array([0.2, 0.06]))
    with pytest.raises(ValueError, match="unknown surrogate kind"):
        tsu.SchurSurrogate(np.eye(4), np.eye(4), pts, kind="cubic",
                           device="cpu").alpha_of(np.array([0.05, 0.05]))


def test_save_load_roundtrip_and_jax_files(tmp_path):
    B = np.eye(4)[:, :2]
    A = np.arange(6, dtype=float).reshape(2, 3)
    L = np.array([[0.01], [0.05], [0.1]])
    p = tmp_path / "rb.npz"
    tsu.save_reduced_basis(p, B, A, L)
    d = tsu.load_reduced_basis(p)
    np.testing.assert_array_equal(d["basis_reduced_ortho"], B)
    np.testing.assert_array_equal(d["alpha_ortho"], A)
    np.testing.assert_array_equal(d["list_elements"], L)
    # a basis JAX saved is loaded by the port, and the other way round
    rv, sm = dataset()
    B, A, L = jsu.reduce_basis_greedy(
        {tuple(rv[i]): sm[i] for i in range(len(rv))}, 1e-6)
    jsu.save_reduced_basis(tmp_path / "jax.npz", B, A, L)
    sur = tsu.SchurSurrogate.from_npz(tmp_path / "jax.npz", device="cpu")
    assert np.array_equal(sur.basis, B) and np.array_equal(sur.alpha, A)
    tsu.save_reduced_basis(tmp_path / "port.npz", B, A, L)
    jd = jsu.load_reduced_basis(tmp_path / "port.npz")
    assert np.array_equal(jd["list_elements"], L)
    # an RBF surrogate of the full basis reproduces its samples
    for i in (0, 5):
        S = sur.reconstruct(rv[i]).numpy()
        assert np.abs(S - sm[i]).max() / np.abs(sm[i]).max() < 1e-5


def test_cuda_query_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sur = tsu.SchurSurrogate.from_npz(RB, kind="RBF")      # device "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        sur.reconstruct(np.array([0.05]))
