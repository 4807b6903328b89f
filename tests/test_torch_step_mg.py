"""Port parity: the whole compliance step with the multigrid
preconditioner against the JAX step in float64 (Octet n=4, bench MG
options): cold with the port's own state, and cold and warm-started with a
frozen (stale) JAX state carried over by convert.precond_state_from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_step_jacobi import assert_close, radius, steps
from pylatticedso_tpu_torch import convert

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    js, ts = steps("mg")
    r_stale = radius(2)
    state = js.precond_state(jnp.asarray(r_stale))
    tree = jax.tree_util.tree_map(np.asarray, state)
    return js, ts, r_stale, state, convert.precond_state_from_jax(
        tree, device="cpu")


def test_port_state_matches_frozen_jax_state(pair):
    js, ts, r_stale, state, st = pair
    own = ts.precond_state(torch.tensor(r_stale))
    for key in ("radii", "auxs", "Ds", "lmaxs"):
        for a, b in zip(st[key], own[key]):
            err = float((a - b).abs().max() / a.abs().max())
            assert err <= 1e-12, key


def test_step_operands_match_jax(pair):
    js, ts, r_stale, _state, _st = pair
    r_t, free_t, f_t = convert.step_inputs_from_jax(
        r_stale, *(np.asarray(x) for x in js._operands), device="cpu")
    assert torch.equal(r_t, torch.tensor(r_stale))
    assert torch.equal(free_t, ts.operands[0])
    assert torch.equal(f_t, ts.operands[1])


def test_cold_own_state_matches_jax(pair):
    """The port's cold step builds its own state; JAX's cold step builds
    the same state inside its jit (here passed in, computed at r)."""
    js, ts, r_stale, state, _st = pair
    out_j = js(jnp.asarray(r_stale), None, state)
    out_t = ts(torch.tensor(r_stale))
    assert_close(out_j, out_t)


def test_frozen_state_cold_and_warm_match_jax(pair):
    js, ts, _r_stale, state, st = pair
    r = radius(3)
    out_j = js(jnp.asarray(r), None, state)
    out_t = ts(torch.tensor(r), None, st)
    assert_close(out_j, out_t)
    cold_iters = ts.last_solve["iterations"]
    r2 = r * 1.01
    out_j2 = js(jnp.asarray(r2), out_j[2], state)
    out_t2 = ts(torch.tensor(r2), out_t[2], st)
    assert_close(out_j2, out_t2)
    assert ts.last_solve["iterations"] < cold_iters
