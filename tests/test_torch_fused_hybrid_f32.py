"""Port parity of the fused V-cycle where a level runs B3 + B4: the
``BCC+Hybrid1+Hybrid4`` lattice at n=6, the smallest grid of the routing
tests with a multi-program level (the fine level runs B3 and a chain of
B4, the coarse one B5), against the JAX package in interpret mode from one
JAX state, with f32 storage (tolerances in ``test_torch_fused.py``).  The
two storages sit in two files so that test workers run them side by
side."""

import torch

from test_torch_fused import HYBRID, check_vcycle, jax_state

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)


def test_fused_vcycle_multi_program_matches_jax_f32(monkeypatch):
    hj, sj, ht, v = jax_state(HYBRID, 6, monkeypatch)
    assert [lvl.fused.single_ok for lvl in ht["levels"]] == [False, True]
    check_vcycle(hj, sj, ht, v, jax_storages=("f32",))
