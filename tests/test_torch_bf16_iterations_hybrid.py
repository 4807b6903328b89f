"""CG iterations of a cold solve, port against the JAX package, where a
level runs B3 and a chain of B4: the ``BCC+Hybrid1+Hybrid4`` lattice at
n=6 (the fine level is multi-program, the coarse one runs B5), with the
setup of ``test_torch_bf16_iterations.py``.  The B4 chain rounds x, r and
d to bf16 after every step; a rounding point the port placed otherwise
would move its count away from the reference's.

Tol 1e-6 (the bench's): at 1e-8 this lattice's f32 CG runs below its
rounding floor, where the two packages' f32 V-cycles, which sum in
another order, part by several iterations.  The lo route is held at
Octet n=4 only (B2 has no multi-program form).  Run with ``-s`` to print
the counts."""

import pytest
import torch

from test_torch_bf16_iterations import cold_counts

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

HYBRID = ["BCC", "Hybrid1", "Hybrid4"]
ROUTES = ("f32", "fused")


@pytest.fixture(scope="module")
def counts():
    return cold_counts(HYBRID, 6, tol=1e-6, routes=ROUTES)


def test_fine_level_is_multi_program(counts):
    assert counts["single_ok (port)"] == [False, True]


@pytest.mark.parametrize("route", ROUTES)
def test_port_takes_the_references_iterations(counts, route):
    jax_its, port_its = counts[route]
    assert abs(jax_its - port_its) <= 1


def test_fused_f32_storage_converges_like_unfused(counts):
    f32 = counts["f32"][1]
    assert abs(counts["fused f32 storage (port)"][1] - f32) <= 1
