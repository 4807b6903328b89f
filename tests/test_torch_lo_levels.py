"""Which multigrid levels run the bf16-I/O smoother matvec (B2), and the
process-wide matmul flags around the transfers.

* B2 runs on a level only where the JAX package builds its Pallas matvec
  and so a bf16 operand (``multigrid.py:496-499``, ``prepare_lo``
  :183-189): per level of the 50^3 Octet and ``BCC+Hybrid1+Hybrid4``
  hierarchies, the port's choice equals ``hasattr(level.matvec.apply,
  "lo")`` of the JAX hierarchy built with ``PLDSO_MATVEC=pallas``
  (construction only: no kernel runs).  At float64 no level has one, and
  the port's lo V-cycle equals JAX's.
* ``build_mg_hierarchy`` leaves ``torch.backends.cuda.matmul.allow_tf32``
  and ``allow_bf16_reduced_precision_reduction`` as it found them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylatticedso_tpu.parallel import multigrid as jmg
from pylatticedso_tpu.parallel.structured import StructuredLattice as JSL
from pylatticedso_tpu_torch.parallel import multigrid as tmg
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice as TSL

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

HYBRID = ["BCC", "Hybrid1", "Hybrid4"]


def _free(sl):
    fixed = sl.select_nodes(lambda x, y, z: z == 0.0)
    return sl.node_valid & ~fixed


@pytest.mark.parametrize("geom", ["Octet", "hybrid"])
def test_b2_levels_follow_the_jax_rule(geom, monkeypatch):
    monkeypatch.setenv("PLDSO_MATVEC", "pallas")
    monkeypatch.setenv("PLDSO_PALLAS_INTERPRET", "1")
    g = HYBRID if geom == "hybrid" else geom
    n = 50
    js = JSL(g, (n,) * 3, (1.0,) * 3, 1013.0, 0.3)
    want = [hasattr(lvl.matvec.apply, "lo")
            for lvl in jmg.build_mg_hierarchy(js, _free(js))["levels"]]
    ts = TSL(g, (n,) * 3, (1.0,) * 3, 1013.0, 0.3, device="cpu")
    ht = tmg.build_mg_hierarchy(ts, _free(ts))
    probe = torch.zeros(1)
    got = [lvl.prepare_lo(probe) is not None for lvl in ht["levels"]]
    assert got == want
    # Octet fits the rule at every level; the hybrid's two finest do not
    assert want == ([True] * 6 if geom == "Octet"
                    else [False, False, True, True, True, True])


def test_lo_vcycle_at_float64_matches_jax():
    """Octet n=4 in float64: JAX has no bf16 operands, so its lo request
    smooths every level in full precision, and so does the port's."""
    n = 4
    js = JSL("Octet", (n,) * 3, (1.0,) * 3, 1013.0, 0.3, dtype=jnp.float64)
    ts = TSL("Octet", (n,) * 3, (1.0,) * 3, 1013.0, 0.3,
             dtype=torch.float64, device="cpu")
    free = _free(js)
    hj, ht = jmg.build_mg_hierarchy(js, free), tmg.build_mg_hierarchy(ts, free)
    rng = np.random.default_rng(7)
    r = rng.uniform(0.03, 0.08, (n,) * 3)
    v = rng.standard_normal((js.nc, 6) + js.grid) \
        * np.asarray(hj["levels"][0].free)
    opts = dict(nu=(1, 2), coarse_degree=2, smooth_frac=0.35)
    with jax.disable_jit():
        sj = jmg.mg_precond_state(hj, jnp.asarray(r), power_iters=2)
        assert all(a is None for a in sj["auxs_lo"])
        mj = np.asarray(jmg.mg_apply(hj, sj, lo_smoother=True,
                                     **opts)(jnp.asarray(v)))
    st = tmg.mg_precond_state(ht, torch.tensor(r), power_iters=2)
    mt = tmg.mg_apply(ht, st, lo_smoother=True, fused=False,
                      **opts)(torch.tensor(v)).numpy()
    assert np.abs(mj).max() > 0
    assert np.abs(mj - mt).max() / np.abs(mj).max() <= 1e-12


def test_hierarchy_leaves_the_matmul_flags_alone():
    m = torch.backends.cuda.matmul
    old = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction)
    try:
        for flags in ((True, True), (False, True), (True, False)):
            m.allow_tf32, m.allow_bf16_reduced_precision_reduction = flags
            ts = TSL("BCC", (4,) * 3, (1.0,) * 3, 1013.0, 0.3,
                     dtype=torch.float64, device="cpu")
            h = tmg.build_mg_hierarchy(ts, _free(ts))
            c = torch.ones((ts.nc, 6) + h["levels"][1].slat.grid,
                           dtype=torch.float64)
            h["prolong"][0](c)
            h["restrict"][0](h["prolong"][0](c))
            assert (m.allow_tf32,
                    m.allow_bf16_reduced_precision_reduction) == flags
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = old
