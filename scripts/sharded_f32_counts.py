"""CG iterations of the edge-sharded step's cold solve, JAX package against
the port, on the CPU, in float32 and float64.

    PYTHONPATH=. python3 scripts/sharded_f32_counts.py [--n 6]
        [--tols 1e-4,1e-5,1e-6]

Builds the n^3 Octet lattice of bench.py's second mode in both packages
and, for each tolerance and dtype, counts the CG iterations of one
unrestarted block-Jacobi solve: the port's from ``step.chunked`` (one
chunk, ``last_iterations``); JAX's as the smallest chunk with which
``step.chunked(..., max_chunks=1)`` converges (a bisection: JAX counts
whole chunks).  Each JAX chunk size compiles once (a few seconds).
"""

import argparse
import warnings

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from pylatticedso_tpu import build_lattice as jax_build  # noqa: E402
from pylatticedso_tpu.fem.bc import apply_boundary_conditions as jax_bc  # noqa: E402
from pylatticedso_tpu.parallel import sharding as js  # noqa: E402

from pylatticedso_tpu_torch.design import build_lattice  # noqa: E402
from pylatticedso_tpu_torch.fem.bc import apply_boundary_conditions  # noqa: E402
from pylatticedso_tpu_torch.parallel import sharding as ts  # noqa: E402
from pylatticedso_tpu_torch.smoke_statics import bench2_config  # noqa: E402


def counts(n: int, tol: float, f64: bool):
    cfg = bench2_config(n)
    jl, tl = jax_build(cfg), build_lattice(cfg)
    jb, tb = jax_bc(jl), apply_boundary_conditions(tl)
    jshl = js.ShardedLattice(
        js.make_mesh(n_shard=1, devices=jax.devices()[:1]), jl.nodes,
        jl.edges, 1013.0, 0.3, dtype=jnp.float64 if f64 else jnp.float32)
    tshl = ts.ShardedLattice(
        ts.make_mesh(devices=["cpu"]), tl.nodes, tl.edges, 1013.0, 0.3,
        dtype=torch.float64 if f64 else torch.float32)
    jstep = js.make_compliance_step(jshl, ~jb.fixed, jb.f_applied, tol=tol)
    tstep = ts.make_compliance_step(tshl, ~tb.fixed, tb.f_applied, tol=tol)
    jr = jshl.radius_padded(jl.radius)
    tstep.chunked(tshl.radius_padded(tl.radius), chunk=1_000_000)
    port = tstep.chunked.last_iterations

    def converges(chunk):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            jstep.chunked(jr, chunk=chunk, max_chunks=1, on_fail="warn")
        return jstep.chunked.last_converged

    lo, hi = 1, 4 * port + 64
    while lo < hi:
        mid = (lo + hi) // 2
        if converges(mid):
            hi = mid
        else:
            lo = mid + 1
    return lo, port


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=6)
    ap.add_argument("--tols", default="1e-4,1e-5,1e-6")
    args = ap.parse_args()
    torch.set_num_threads(4)
    for tol in (float(t) for t in args.tols.split(",")):
        for f64 in (False, True):
            j, p = counts(args.n, tol, f64)
            print(f"{args.n}^3 Octet tol {tol:g} "
                  f"{'float64' if f64 else 'float32'}: JAX {j}, port {p}",
                  flush=True)


if __name__ == "__main__":
    main()
