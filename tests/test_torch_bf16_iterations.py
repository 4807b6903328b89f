"""CG iterations of a cold solve with each V-cycle route, port against
the JAX package (kernels in interpret mode), Octet n=4, nu=(1, 1), coarse
degree 6, tol 1e-8, from one JAX state carried over by the converter.
At Octet n=4 every level runs its whole smoother in one B5 launch;
``test_torch_bf16_iterations_hybrid.py`` holds the same counts where the
fine level runs B3 and a chain of B4.

bf16 smoother storage (the lo and fused routes) makes the preconditioner
a slightly perturbed operator, and the reference's own CG then needs more
iterations than with the f32 V-cycle; the port must reproduce that count
(within one iteration: dot products sum in another order), and its fused
V-cycle with f32 storage must converge like the unfused one.  The
``fused-bf16c`` route is the fused one in bf16 arithmetic
(``PLDSO_MG_FUSED_COMPUTE=bf16``: B5c on both levels, B3c mid-cycle),
held to the reference's count the same way.  Run with ``-s`` to print
the counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylatticedso_tpu.fem.solve import pcg as jpcg
from pylatticedso_tpu.parallel import multigrid as jmg
from pylatticedso_tpu.parallel.structured import StructuredLattice as JSL
from pylatticedso_tpu_torch import convert
from pylatticedso_tpu_torch.fem.solve import pcg as tpcg
from pylatticedso_tpu_torch.parallel import multigrid as tmg
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice as TSL

# one torch thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

N = 4
OPTS = dict(nu=(1, 1), coarse_degree=6, smooth_frac=0.25)
ROUTES = {"f32": dict(fused=False, lo_smoother=False),
          "lo": dict(fused=False, lo_smoother=True),
          "fused": dict(fused=True),
          "fused-bf16c": dict(fused=True)}
# the fused kernels' arithmetic of a route (PLDSO_MG_FUSED_COMPUTE, read
# as each kernel is built or called; unset for every other route): the
# bf16-compute instances B3c-B5c
COMPUTE = {"fused-bf16c": "bf16"}


def cold_counts(geom, n, tol=1e-8, routes=tuple(ROUTES)):
    """{route: (JAX iterations, port iterations)} of a cold solve to
    ``tol`` on ``geom`` at n cells, clamped at z=0 with a unit load on the
    top face, for each of ``routes``, plus the port's fused V-cycle with
    f32 storage and the port's per-level ``single_ok``."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PLDSO_MATVEC", "pallas")
    mp.setenv("PLDSO_PALLAS_INTERPRET", "1")
    mp.setenv("PLDSO_MG_FUSED_DTYPE", "bf16")
    try:
        js = JSL(geom, (n,) * 3, (1.0,) * 3, 1013.0, 0.3)
        fixed = js.select_nodes(lambda x, y, z: z == 0.0)
        top = js.select_nodes(lambda x, y, z: z == float(n))
        free = np.broadcast_to((js.node_valid & ~fixed)[:, None],
                               (js.nc, 6) + js.grid)
        f = np.zeros((js.nc, 6) + js.grid, np.float32)
        for c in range(js.nc):
            f[c, 2][top[c]] = -1.0 / int(top.sum())
        rshape = (n,) * 3 if js.n_geom == 1 else (js.n_geom,) + (n,) * 3
        r0 = np.full(rshape, 0.05, np.float32)
        hj = jmg.build_mg_hierarchy(js, free)
        sj = jmg.mg_precond_state(hj, jnp.asarray(r0), power_iters=5,
                                  fused=True)
        ts = TSL(geom, (n,) * 3, (1.0,) * 3, 1013.0, 0.3,
                 dtype=torch.float32, device="cpu")
        ht = tmg.build_mg_hierarchy(ts, free)
        st = convert.precond_state_from_jax(
            jax.tree_util.tree_map(np.asarray, sj), dtype=torch.float32,
            device="cpu")
        mj = hj["levels"][0].matvec
        aux_j = mj.prepare(jnp.asarray(r0))
        fr_j = jnp.asarray(free, jnp.float32)
        A_j = lambda u: fr_j * mj.apply(fr_j * u, aux_j) + (1 - fr_j) * u
        mt = ts.make_matvec()[0]
        aux_t = mt.prepare(torch.tensor(r0))
        fr_t = torch.tensor(free, dtype=torch.float32)
        A_t = lambda u: fr_t * mt.apply(fr_t * u, aux_t) + (1 - fr_t) * u
        b = free * f
        out = {}
        for route in routes:
            if route in COMPUTE:
                mp.setenv("PLDSO_MG_FUSED_COMPUTE", COMPUTE[route])
            else:
                mp.delenv("PLDSO_MG_FUSED_COMPUTE", raising=False)
            M_j = jmg.mg_apply(hj, sj, **OPTS, **ROUTES[route])
            res = jax.jit(lambda b_: jpcg(A_j, b_, M=M_j, tol=tol,
                                          maxiter=200))(jnp.asarray(b))
            M_t = tmg.mg_apply(ht, st, **OPTS, **ROUTES[route])
            out[route] = (int(res.iterations), tpcg(
                A_t, torch.tensor(b), M=M_t, tol=tol,
                maxiter=200).iterations)
        # the port's fused V-cycle in f32 storage, from the same state
        mp.delenv("PLDSO_MG_FUSED_COMPUTE", raising=False)
        st32 = dict(st, fused=[{k: v.float() for k, v in fo.items()}
                               for fo in st["fused"]])
        out["fused f32 storage (port)"] = (None, tpcg(
            A_t, torch.tensor(b), M=tmg.mg_apply(ht, st32, fused=True,
                                                 **OPTS),
            tol=tol, maxiter=200).iterations)
    finally:
        mp.undo()
    out["single_ok (port)"] = [lvl.fused.single_ok for lvl in ht["levels"]]
    print(f"\ncold CG iterations to {tol:g} (JAX, port), {geom} n={n}:",
          out)
    return out


@pytest.fixture(scope="module")
def counts():
    return cold_counts("Octet", N)


@pytest.mark.parametrize("route", list(ROUTES))
def test_port_takes_the_references_iterations(counts, route):
    jax_its, port_its = counts[route]
    assert abs(jax_its - port_its) <= 1


def test_bf16_storage_costs_iterations_f32_storage_does_not(counts):
    f32 = counts["f32"][1]
    assert counts["lo"][1] > f32 and counts["fused"][1] > f32
    assert abs(counts["fused f32 storage (port)"][1] - f32) <= 1
