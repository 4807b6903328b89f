"""convert.precond_state_from_jax on a Pallas-layout JAX state
(``PLDSO_MATVEC=pallas``, ``PLDSO_MG_FUSED=1``, kernels in interpret
mode): the [n_e, Fp] r^2 flats, their bf16 copies and the fused smoother's
align8 flats land in the port's ghost-padded layout and agree with the
port's own state built from the same radii (BCC n=4, float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylatticedso_tpu.parallel import multigrid as jmg
from pylatticedso_tpu.parallel.structured import StructuredLattice as JSL
from pylatticedso_tpu_torch import convert
from pylatticedso_tpu_torch.parallel import multigrid as tmg
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice as TSL

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

N = 4


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def _np(t):
    return t.to(torch.float64).numpy()


@pytest.mark.parametrize("storage", ["bf16", "f32"])
def test_pallas_fused_state_converts(storage, monkeypatch):
    monkeypatch.setenv("PLDSO_MATVEC", "pallas")
    monkeypatch.setenv("PLDSO_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PLDSO_MG_FUSED", "1")
    monkeypatch.setenv("PLDSO_MG_FUSED_DTYPE", storage)
    js = JSL("BCC", (N,) * 3, (1.0,) * 3, 1013.0, 0.3)
    fixed = js.select_nodes(lambda x, y, z: z == 0.0)
    free = np.broadcast_to((js.node_valid & ~fixed)[:, None],
                           (js.nc, 6) + js.grid)
    r = 0.04 + 0.03 * np.random.default_rng(3).random((N,) * 3)
    hj = jmg.build_mg_hierarchy(js, free)
    sj = jmg.mg_precond_state(hj, jnp.asarray(r, jnp.float32),
                              power_iters=3)
    assert all(fo is not None for fo in sj["fused"])
    assert np.ndim(sj["auxs"][0]) == 2          # Pallas [n_e, Fp] flats
    st = convert.precond_state_from_jax(
        jax.tree_util.tree_map(np.asarray, sj), dtype=torch.float32,
        device="cpu")

    ts = TSL("BCC", (N,) * 3, (1.0,) * 3, 1013.0, 0.3,
             dtype=torch.float32, device="cpu")
    ht = tmg.build_mg_hierarchy(ts, free)
    own = tmg.mg_precond_state(ht, torch.tensor(r, dtype=torch.float32),
                               power_iters=3, fused=True)
    io = torch.bfloat16 if storage == "bf16" else torch.float32
    for key in ("radii", "auxs", "Ds"):
        for a, b in zip(st[key], own[key]):
            assert a.shape == b.shape and a.dtype == torch.float32, key
            assert _rel(_np(b), _np(a)) <= 1e-6, key
    for a, b in zip(st["lmaxs"], own["lmaxs"]):
        assert _rel(_np(b), _np(a)) <= 1e-5
    for a, b in zip(st["auxs_lo"], own["auxs_lo"]):
        assert a.dtype == b.dtype == torch.bfloat16
        assert a.shape == b.shape
        assert _rel(_np(b), _np(a)) <= 1e-2
    tol = 1e-2 if storage == "bf16" else 1e-6
    for lvl, (a, b) in enumerate(zip(st["fused"], own["fused"])):
        for key in ("fdinv", "fm", "r2"):
            assert a[key].dtype == b[key].dtype == io, key
            assert a[key].shape == b[key].shape, key
            assert _rel(_np(b[key]), _np(a[key])) <= tol, (lvl, key)
        assert torch.equal(a["fm"], b["fm"])
        # ghosts are zero, and the align8 rows are gone
        for key in ("fdinv", "fm"):
            v = a[key]
            assert float(v[..., 0, :, :].abs().max()) == 0.0
            assert float(v[..., -1].abs().max()) == 0.0


def test_gather_state_still_converts():
    """The gather-layout state (the unfused default) converts as before,
    with no bf16 or fused operands."""
    js = JSL("BCC", (N,) * 3, (1.0,) * 3, 1013.0, 0.3, dtype=jnp.float64)
    fixed = js.select_nodes(lambda x, y, z: z == 0.0)
    hj = jmg.build_mg_hierarchy(js, js.node_valid & ~fixed)
    r = 0.04 + 0.03 * np.random.default_rng(4).random((N,) * 3)
    with jax.disable_jit():
        sj = jmg.mg_precond_state(hj, jnp.asarray(r), power_iters=2)
    st = convert.precond_state_from_jax(
        jax.tree_util.tree_map(np.asarray, sj), device="cpu")
    assert st["auxs_lo"] == [None] * len(st["Ds"])
    assert st["fused"] == [None] * len(st["Ds"])
    for a, b in zip(sj["auxs"], st["auxs"]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
