"""Time the port's 50^3 main path (bench.py's protocol) on two checkouts
in turns, one process per run.

    python3 scripts/step_pairs.py CHECKOUT_A CHECKOUT_B [--pairs 4]
        [--routes fused,lo] [--out FILE]

Needs one CUDA card.  Runs ``smoke.main_path_phase`` of each checkout's
``pylatticedso_tpu_torch`` (its own kernels, built in that checkout) in a
fresh process, in the order A B B A A B B A ... (``--pairs`` pairs), and
prints each run's s/step per route (the minimum over 3 windows of 8
warm-started steps) and the medians per checkout.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from pylatticedso_tpu_torch import smoke
out = {{}}
for route in {routes!r}:
    rep = smoke.main_path_phase(torch.device("cuda"), 50, route=route)
    out[route] = rep["s_per_step"]
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--routes", default="fused,lo")
    ap.add_argument("--out", help="also write the runs here (JSON)")
    args = ap.parse_args()
    routes = args.routes.split(",")
    order = []
    for k in range(args.pairs):
        order += [args.a, args.b] if k % 2 == 0 else [args.b, args.a]
    runs = []
    for root in order:
        root = str(Path(root).resolve())
        res = subprocess.run([sys.executable, "-c",
                              CHILD.format(root=root, routes=routes)],
                             capture_output=True, text=True, check=True)
        got = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"checkout": root, "s_per_step": got})
        print(root, got, flush=True)
    for root in (args.a, args.b):
        root = str(Path(root).resolve())
        for route in routes:
            v = [r["s_per_step"][route] for r in runs if r["checkout"] == root]
            print(f"{root} {route}: median {statistics.median(v):.4f} s/step "
                  f"over {[round(x, 4) for x in v]}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
