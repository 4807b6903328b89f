"""The port's edge-sharded step on a 2 x 4 mesh of CPU devices against the
JAX package's on its 8-device virtual CPU mesh (``tests/conftest.py``),
in float64, on ``tests/test_sharding.py``'s 3x2x2 Octet cantilever:

* ``radius_padded`` with JAX's padding (the edges padded to a multiple of
  4 with zero-stiffness self-loops), the frames;
* ``matvec``, ``diagonal`` and ``node_blocks`` (each shard's partial,
  added in rank order) within 1e-12;
* ``step``, ``step.batch`` (two candidates, one a ``dp`` row),
  ``step.descent_loop`` (3 steps) and ``step.chunked`` within 1e-10;
* the same bits on repeat, on every mesh shape, and the batch each
  candidate's single step bit for bit; the 2 x 4 step against the 1 x 1
  step within 1e-12.
"""

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

from test_torch_sharding import CONFIG, E_MOD, NU, rel

torch.set_num_threads(1)

OP_TOL = 1e-12
SOLVE_TOL = 1e-10


class MeshPair:
    """The same lattice and BCs on JAX's 2 x 4 mesh and the port's."""

    def __init__(self):
        self.jlat, self.lat = jax_build(CONFIG), build_lattice(CONFIG)
        self.jbc, self.bc = jax_bc(self.jlat), apply_boundary_conditions(
            self.lat)
        jmesh = js.make_mesh(n_shard=4, n_dp=2)
        assert len(jmesh.devices.reshape(-1)) == 8
        self.jshl = js.ShardedLattice(jmesh, self.jlat.nodes, self.jlat.edges,
                                      E_MOD, NU, dtype=jnp.float64)
        self.mesh = ts.make_mesh(n_shard=4, n_dp=2, devices=["cpu"] * 8)
        self.shl = ts.ShardedLattice(self.mesh, self.lat.nodes,
                                     self.lat.edges, E_MOD, NU,
                                     dtype=torch.float64)
        self.jr = self.jshl.radius_padded(self.jlat.radius)
        self.r = self.shl.radius_padded(self.lat.radius)

    def steps(self):
        kw = dict(tol=1e-10, maxiter=2000)
        return (js.make_compliance_step(self.jshl, ~self.jbc.fixed,
                                        self.jbc.f_applied, **kw),
                ts.make_compliance_step(self.shl, ~self.bc.fixed,
                                        self.bc.f_applied, **kw))


@pytest.fixture(scope="module")
def pair():
    return MeshPair()


@pytest.fixture(scope="module")
def forms(pair):
    jstep, step = pair.steps()
    jr2 = pair.jshl.radius_padded(pair.jlat.radius * 1.2)
    r2 = pair.shl.radius_padded(pair.lat.radius * 1.2)
    return {"step": (jstep(pair.jr), step(pair.r)),
            "step2": (jstep(jr2), step(r2)),
            "batch": (jstep.batch(jnp.stack([pair.jr, jr2])),
                      step.batch(torch.stack([pair.r, r2]))),
            "descent": (jstep.descent_loop(pair.jr, 3),
                        step.descent_loop(pair.r, 3)),
            "chunked": (jstep.chunked(pair.jr, chunk=64),
                        step.chunked(pair.r, chunk=64)),
            "step_fn": step}


def test_radius_padded_and_frames(pair):
    E = pair.lat.num_edges
    assert pair.shl.n_real == pair.jshl.n_real == E
    assert pair.shl.edges.shape[1] == pair.jshl.edges.shape[1] \
        == -(-E // 4) * 4
    assert np.array_equal(pair.shl.edges.numpy(), np.asarray(pair.jshl.edges))
    assert np.array_equal(pair.r.numpy(), np.asarray(pair.jr))
    for name in ("t", "a1", "a2", "L"):
        assert rel(getattr(pair.shl, name),
                   getattr(pair.jshl, name)) <= OP_TOL, name
    assert [c.edges.shape[1] for c in pair.shl.chunks(1)] \
        == [pair.shl.chunk] * 4


@pytest.mark.parametrize("form", ["matvec", "diagonal", "node_blocks"])
def test_operator_forms(pair, form):
    jD, D = pair.jshl.section_D(pair.jr), pair.shl.section_D(pair.r)
    if form == "matvec":
        u = np.random.default_rng(0).normal(size=(pair.lat.num_nodes, 6))
        got = pair.shl.matvec(torch.as_tensor(u), D)
        want = pair.jshl.matvec(jnp.asarray(u), jD)
    else:
        got, want = getattr(pair.shl, form)(D), getattr(pair.jshl, form)(jD)
    assert rel(got, want) <= OP_TOL


@pytest.mark.parametrize("key", ["step", "step2", "batch", "descent"])
def test_step_forms(forms, key):
    (jc, jg), (c, g) = forms[key]
    assert rel(c, jc) <= SOLVE_TOL and rel(g, jg) <= SOLVE_TOL


def test_batch_is_each_single_step(forms):
    (cb, gb) = forms["batch"][1]
    for k, key in enumerate(("step", "step2")):
        c, g = forms[key][1]
        assert torch.equal(cb[k], c) and torch.equal(gb[k], g)


def test_chunked(forms):
    (jc, jg, ju, jit), (c, g, u, it) = forms["chunked"]
    assert it == jit
    for a, b in ((c, jc), (g, jg), (u, ju)):
        assert rel(a, b) <= SOLVE_TOL


def test_same_bits_on_repeat(pair, forms):
    step = forms["step_fn"]
    c, g = step(pair.r)
    assert torch.equal(c, forms["step"][1][0]) \
        and torch.equal(g, forms["step"][1][1])
    c2, g2, u2, _ = step.chunked(pair.r, chunk=64)
    c1, g1, u1, _ = forms["chunked"][1]
    assert torch.equal(c1, c2) and torch.equal(g1, g2) \
        and torch.equal(u1, u2)


@pytest.mark.parametrize("shape", [(1, 1), (1, 3), (2, 2)])
def test_other_mesh_shapes(pair, forms, shape):
    """1 x 1, 1 x 3 (padded edges) and 2 x 2 against the 2 x 4 step."""
    n_dp, n_shard = shape
    mesh = ts.make_mesh(n_shard=n_shard, n_dp=n_dp,
                        devices=["cpu"] * (n_dp * n_shard))
    shl = ts.ShardedLattice(mesh, pair.lat.nodes, pair.lat.edges, E_MOD, NU,
                            dtype=torch.float64)
    step = ts.make_compliance_step(shl, ~pair.bc.fixed, pair.bc.f_applied,
                                   tol=1e-10, maxiter=2000)
    r = shl.radius_padded(pair.lat.radius)
    c, g = step(r)
    c2, g2 = step(r)
    assert torch.equal(c, c2) and torch.equal(g, g2)
    cw, gw = forms["step"][1]
    E = pair.lat.num_edges
    assert rel(c, cw) <= 1e-12 and rel(g[:E], gw[:E]) <= 1e-12
    assert bool((g[E:] == 0).all())
