"""The cold solve of bench.py's second mode (the edge-sharded step) by
chunk size: how many CG iterations each restart of ``step.chunked`` costs.

    PYTHONPATH=. python3 scripts/sharded_chunks.py [--n 50]
        [--chunks 256,512,100000] [--out FILE]

Needs one CUDA card.  Builds the n^3 Octet lattice of
``smoke_statics.bench2_config``, then in float32 and in float64 (tol 1e-6
both, block Jacobi) runs one cold ``step.chunked(r, chunk=k)`` for each
chunk size k (each pcg call restarts CG from the last u), and prints the
CG iterations taken, the chunked count (k a call), the seconds and the
compliance.  A chunk larger than the solve needs is one unrestarted CG.
"""

import argparse
import json
import subprocess

import torch

from pylatticedso_tpu_torch import smoke_statics as ss
from pylatticedso_tpu_torch.design import build_lattice
from pylatticedso_tpu_torch.fem.bc import apply_boundary_conditions


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--chunks", default="256,512,100000")
    ap.add_argument("--out", help="write the results (JSON) here")
    args = ap.parse_args()
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    lat = build_lattice(ss.bench2_config(args.n))
    bc = apply_boundary_conditions(lat)
    out = {}
    for dtype in (torch.float32, torch.float64):
        shl, step, _ = ss._bench2_step(lat, bc, dev, dtype, ss.TOL)
        r = shl.radius_padded(lat.radius)
        for chunk in (int(k) for k in args.chunks.split(",")):
            (c, _, _, it), s = ss._timed(lambda: step.chunked(r, chunk=chunk),
                                         dev)
            key = f"{str(dtype).split('.')[-1]} chunk {chunk}"
            out[key] = {"iterations": step.chunked.last_iterations,
                        "chunked_iters": it, "s": s, "compliance": float(c),
                        "residual": step.chunked.last_residual}
            print(key, json.dumps(out[key]), flush=True)
        del shl, step
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
