"""The fused V-cycle of ``shard_structured_step`` on meshes of CPU
devices, in float32 with f32 smoother storage, against the port's
one-device step at 1e-5 / 1e-4: on ``tests/test_sharding.py``'s BCC N=7
(a B5 fine level: the V-cycle runs gathered), and on a 31 x 12 x 12 BCC
lattice (the
smallest near which the routing gives the fine level B3 + B4, not B5) the
fine level runs on slabs through B3's and B4's plain versions with a halo
exchange before each, and the coarser levels run gathered, the coarsest
through B5's.
"""

import torch

from pylatticedso_tpu_torch.parallel.structured import (
    make_structured_compliance_step, shard_structured_step)

from test_torch_structured_mesh import _case, _check, _mesh

torch.set_num_threads(1)


def test_fused_bcc_n7_runs_gathered(monkeypatch):
    """tests/test_sharding.py's fused case, BCC N=7 in f32 storage: its
    fine level is a B5 level, so no level runs on slabs (B5 cannot
    exchange halos inside its one launch) and the whole V-cycle runs
    gathered around the slab-sharded CG."""
    monkeypatch.setenv("PLDSO_MG_FUSED_DTYPE", "f32")
    sl, free, f = _case("BCC", (7, 2, 2), along="x", dtype=torch.float32)
    step = make_structured_compliance_step(
        sl, free, f, tol=1e-8, maxiter=500, precond="mg",
        mg_opts={"nu": (1, 1), "coarse_degree": 8, "power_iters": 3,
                 "fused": True})
    sstep = shard_structured_step(step, _mesh(4, 2))
    assert step.hierarchy["levels"][0].fused.single_ok
    assert sstep.n_sharded_levels == 0
    r = torch.full((7, 2, 2), 0.05, dtype=torch.float32)
    _check(step, sstep, r, step.precond_state(r), c_tol=1e-5, g_tol=1e-4)


def test_fused_route(monkeypatch):
    monkeypatch.setenv("PLDSO_MG_FUSED_DTYPE", "f32")
    cells = (31, 12, 12)
    sl, free, f = _case("BCC", cells, along="x", dtype=torch.float32)
    step = make_structured_compliance_step(
        sl, free, f, tol=1e-4, maxiter=500, precond="mg",
        mg_opts={"nu": (1, 1), "coarse_degree": 4, "power_iters": 2,
                 "fused": True})
    sstep = shard_structured_step(step, _mesh(4))
    assert sstep.n_sharded_levels == 1
    assert not sstep.runner.slab_levels[0].fused.single_ok
    assert step.hierarchy["levels"][-1].fused.single_ok
    r = torch.full(cells, 0.05, dtype=torch.float32)
    _check(step, sstep, r, step.precond_state(r), c_tol=1e-5, g_tol=1e-4)
    assert sstep.last_solve["iterations"] > 1
