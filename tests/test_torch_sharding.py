"""The port's edge-sharded compliance step (``parallel.sharding``) against
the JAX package's, in float64 on the CPU, on ``tests/test_sharding.py``'s
3x2x2 Octet cantilever.  The JAX side runs on a one-device mesh.

* ``pad_edges`` arrays equal; the frames, ``matvec``, ``diagonal`` and
  ``node_blocks`` within 1e-12 (relative to the largest entry);
* ``step``, ``step.batch`` and ``step.descent_loop`` (3 steps): c and g
  within 1e-10;
* ``step.chunked``: c, g and u within 1e-10, the same ``iters``, a warm
  restart in one chunk; the Jacobi route under
  ``PLDSO_UNSTRUCTURED_PRECOND=jacobi``;
* the same bits on repeat, and the mesh's and the step's refusals.

Each JAX form compiles once per module (a few seconds each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylatticedso_tpu import build_lattice as jax_build
from pylatticedso_tpu.fem.bc import apply_boundary_conditions as jax_bc
from pylatticedso_tpu.parallel import sharding as js

from pylatticedso_tpu_torch.design import build_lattice
from pylatticedso_tpu_torch.fem.bc import apply_boundary_conditions
from pylatticedso_tpu_torch.parallel import sharding as ts

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

OP_TOL = 1e-12
SOLVE_TOL = 1e-10
E_MOD, NU = 1013.0, 0.3
CONFIG = {
    "geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                 "number_of_cells": {"x": 3, "y": 2, "z": 2},
                 "radii": [0.05], "geom_types": ["Octet"]},
    "boundary_conditions": {
        "Displacement": {"Fixed": {"Surface": ["Xmin"],
                                   "DOF": ["X", "Y", "Z", "RX", "RY", "RZ"],
                                   "Value": [0, 0, 0, 0, 0, 0]}},
        "Force": {"Load": {"Surface": ["Xmax"], "DOF": ["Z"],
                           "Value": [-0.5]}}}}


def rel(got, want):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-300))


class Pair:
    """The same lattice, BCs and operator in both packages."""

    def __init__(self):
        self.jlat, self.lat = jax_build(CONFIG), build_lattice(CONFIG)
        assert np.array_equal(self.jlat.nodes, self.lat.nodes)
        assert np.array_equal(self.jlat.edges, self.lat.edges)
        self.jbc, self.bc = jax_bc(self.jlat), apply_boundary_conditions(self.lat)
        assert np.array_equal(self.jbc.fixed, self.bc.fixed)
        assert np.array_equal(self.jbc.f_applied, self.bc.f_applied)
        mesh = js.make_mesh(n_shard=1, n_dp=1, devices=jax.devices()[:1])
        self.jshl = js.ShardedLattice(mesh, self.jlat.nodes, self.jlat.edges,
                                      E_MOD, NU, dtype=jnp.float64)
        self.shl = ts.ShardedLattice(ts.make_mesh(devices=["cpu"]),
                                     self.lat.nodes, self.lat.edges, E_MOD,
                                     NU, dtype=torch.float64)
        self.jr = self.jshl.radius_padded(self.jlat.radius)
        self.r = self.shl.radius_padded(self.lat.radius)

    def steps(self):
        return (js.make_compliance_step(self.jshl, ~self.jbc.fixed,
                                        self.jbc.f_applied, tol=1e-10,
                                        maxiter=2000),
                ts.make_compliance_step(self.shl, ~self.bc.fixed,
                                        self.bc.f_applied, tol=1e-10,
                                        maxiter=2000))


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def block(pair):
    """Block-Jacobi results of both packages, each form computed once."""
    jstep, step = pair.steps()
    jr2 = pair.jshl.radius_padded(pair.jlat.radius * 1.2)
    r2 = pair.shl.radius_padded(pair.lat.radius * 1.2)
    out = {"step": (jstep(pair.jr), step(pair.r)),
           "step2": (jstep(jr2), step(r2)),
           "batch": (jstep.batch(jnp.stack([pair.jr, jr2])),
                     step.batch(torch.stack([pair.r, r2]))),
           "descent": (jstep.descent_loop(pair.jr, 3),
                       step.descent_loop(pair.r, 3)),
           "chunked": (jstep.chunked(pair.jr, chunk=64),
                       step.chunked(pair.r, chunk=64))}
    out["warm"] = (jstep.chunked(pair.jr, out["chunked"][0][2], chunk=64),
                   step.chunked(pair.r, out["chunked"][1][2], chunk=64))
    out["step_fn"] = step
    return out


@pytest.mark.parametrize("n, n_shard", [(5, 4), (8, 4), (5, 1), (7, 3)])
def test_pad_edges_equal(n, n_shard):
    edges = np.arange(2 * n).reshape(n, 2).astype(np.int32)
    per = [np.ones(n), np.arange(3.0 * n).reshape(n, 3)]
    je, jp, jn = js.pad_edges(edges, per, n_shard)
    te, tp, tn = ts.pad_edges(edges, per, n_shard)
    assert jn == tn and np.array_equal(je, te) and je.dtype == te.dtype
    for a, b in zip(jp, tp):
        assert np.array_equal(a, b)


def test_mesh_is_one_device():
    """The mesh record: a one-device mesh, a virtual 2 x 4 mesh of
    repeated devices in row-major order (``n_shard`` by JAX's rule), and
    the refusal of a mesh larger than the devices given."""
    mesh = ts.make_mesh(n_shard=1, n_dp=1, devices=["cpu"])
    assert mesh.shape == {"dp": 1, "shard": 1}
    assert mesh.device == torch.device("cpu")
    cpu = torch.device("cpu")
    for kw in ({"n_shard": 4, "n_dp": 2}, {"n_dp": 2}):
        mesh = ts.make_mesh(devices=["cpu"] * 8, **kw)
        assert mesh.shape == {"dp": 2, "shard": 4}
        assert mesh.devices == ((cpu,) * 4,) * 2 and mesh.device == cpu
    for kw in ({"n_shard": 2}, {"n_dp": 2, "n_shard": 1},
               {"n_shard": 4, "n_dp": 2, "devices": ["cpu"] * 7}):
        with pytest.raises(ValueError, match="devices"):
            ts.make_mesh(**{"devices": ["cpu"], **kw})


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs none")
    with pytest.raises(RuntimeError, match="cuda"):
        ts.make_mesh()


def test_frames_match(pair):
    for name in ("t", "a1", "a2", "L"):
        assert rel(getattr(pair.shl, name),
                   getattr(pair.jshl, name)) <= OP_TOL, name
    assert np.array_equal(pair.shl.edges.numpy(), np.asarray(pair.jshl.edges))
    assert pair.shl.n_real == pair.jshl.n_real == pair.lat.num_edges


@pytest.mark.parametrize("form", ["matvec", "diagonal", "node_blocks",
                                  "section_D"])
def test_operator_forms_match(pair, form):
    jD, D = pair.jshl.section_D(pair.jr), pair.shl.section_D(pair.r)
    if form == "section_D":
        got, want = D, jD
    elif form == "matvec":
        u = np.random.default_rng(0).normal(size=(pair.lat.num_nodes, 6))
        got = pair.shl.matvec(torch.as_tensor(u), D)
        want = pair.jshl.matvec(jnp.asarray(u), jD)
    else:
        got, want = getattr(pair.shl, form)(D), getattr(pair.jshl, form)(jD)
    assert got.shape == want.shape
    assert rel(got, want) <= OP_TOL


def test_step_matches(block):
    for key in ("step", "step2"):
        (jc, jg), (c, g) = block[key]
        assert rel(c, jc) <= SOLVE_TOL and rel(g, jg) <= SOLVE_TOL, key
    # thicker struts -> lower compliance
    assert float(block["step2"][1][0]) < float(block["step"][1][0])


def test_batch_matches(block):
    (jcb, jgb), (cb, gb) = block["batch"]
    assert cb.shape == (2,) and gb.shape == tuple(jgb.shape)
    assert rel(cb, jcb) <= SOLVE_TOL and rel(gb, jgb) <= SOLVE_TOL
    # each candidate is its single step, bit for bit
    for k, key in enumerate(("step", "step2")):
        c, g = block[key][1]
        assert torch.equal(cb[k], c) and torch.equal(gb[k], g)


def test_descent_loop_matches(block, pair):
    (jr3, jc3), (r3, c3) = block["descent"]
    assert rel(r3, jr3) <= SOLVE_TOL and rel(c3, jc3) <= SOLVE_TOL
    # the same bits as three steps driven by hand
    step, r = block["step_fn"], pair.r
    keep = (r > 0).to(r.dtype)
    for _ in range(3):
        c, g = step(r)
        r = torch.clamp(r - 1e-4 * g, 0.01, 0.1) * keep
    assert torch.equal(r, r3) and torch.equal(c, c3)


def test_chunked_matches(block, pair):
    (jc, jg, ju, jit), (c, g, u, it) = block["chunked"]
    assert it == jit
    assert tuple(u.shape) == tuple(ju.shape) == (6, pair.lat.num_nodes)
    assert rel(c, jc) <= SOLVE_TOL and rel(g, jg) <= SOLVE_TOL
    assert rel(u, ju) <= SOLVE_TOL
    # the self-adjoint gradient agrees with the adjoint-solve gradient
    assert rel(g, block["step"][1][1]) <= 1e-8


def test_chunked_warm_restart_one_chunk(block):
    (jc, _, _, jit), (c, _, _, it) = block["warm"]
    assert it == jit == 64
    assert rel(c, jc) <= SOLVE_TOL
    assert rel(c, block["chunked"][1][0]) <= 1e-8


def test_chunked_same_bits_on_repeat(block, pair):
    step = block["step_fn"]
    c, g, u, it = step.chunked(pair.r, chunk=64)
    c0, g0, u0, it0 = block["chunked"][1]
    assert it == it0 and torch.equal(c, c0) and torch.equal(g, g0) \
        and torch.equal(u, u0)
    c1, g1 = step(pair.r)
    assert torch.equal(c1, block["step"][1][0]) \
        and torch.equal(g1, block["step"][1][1])


def test_chunked_refuses_unconverged(block, pair):
    step = block["step_fn"]
    with pytest.raises(RuntimeError, match="did not converge"):
        step.chunked(pair.r, chunk=2, max_chunks=1)
    with pytest.warns(RuntimeWarning, match="unconverged"):
        c, g, u, it = step.chunked(pair.r, chunk=2, max_chunks=1,
                                   on_fail="warn")
    assert it == 2 and step.chunked.last_converged is False
    assert step.chunked.last_residual > 0 and torch.isfinite(g).all()


def test_jacobi_route_matches(pair, monkeypatch):
    monkeypatch.setenv("PLDSO_UNSTRUCTURED_PRECOND", "jacobi")
    jstep, step = pair.steps()
    (jc, jg), (c, g) = jstep(pair.jr), step(pair.r)
    assert rel(c, jc) <= SOLVE_TOL and rel(g, jg) <= SOLVE_TOL
    jc2, jg2, ju, jit = jstep.chunked(pair.jr, chunk=64)
    c2, g2, u, it = step.chunked(pair.r, chunk=64)
    assert it == jit
    assert rel(c2, jc2) <= SOLVE_TOL and rel(g2, jg2) <= SOLVE_TOL
    assert rel(u, ju) <= SOLVE_TOL
    jacobi_iters = step.chunked.last_iterations
    monkeypatch.delenv("PLDSO_UNSTRUCTURED_PRECOND")
    _, block_step = pair.steps()
    block_step.chunked(pair.r, chunk=64)
    assert block_step.chunked.last_iterations <= jacobi_iters
