"""The control of the check: the plain reference put in the program's
place and computed in bfloat16, the precision below the configurations'
float32, at the cell's own size (``--dtype f32`` runs the same reference in
float32 instead: a witness of what the configurations' own precision
reads).

For each seed the program runs the cell's stream through its warm-up and
one more step, as a run's window would.  At the same design the control
then solves K(r) u = f by conjugate gradients with the reference's operator
in bfloat16 (the CG vectors in float32, the program's preconditioner, which
moves convergence only, never the fixed point), from zero, for at most
``--maxiter`` iterations; its c is f.u summed in bfloat16 and its g the
reference's gradient in bfloat16.  Both answers, the program's step and the
control's (c, g, u) put into the program's layout, are judged by the
harness's own ``check.judge`` against the cell's limits: the program's has
to come out ``ok`` and the control's not.

    python3 portbench/control.py --workload <cell> --seeds <n> ... \
        [--maxiter <k>] [--dtype bf16|f32]

prints one JSON line per seed.  The tests run ``control_readings`` at 3^3
on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _pcg(A, b, M, tol: float, maxiter: int):
    """Plain preconditioned CG: (x, iterations, converged)."""
    x = torch.zeros_like(b)
    r = b.clone()
    z = M(r)
    p = z.clone()
    rz = (r * z).sum()
    nb = torch.linalg.vector_norm(b)
    for it in range(1, maxiter + 1):
        Ap = A(p)
        alpha = rz / (p * Ap).sum()
        x = x + alpha * p
        r = r - alpha * Ap
        if float(torch.linalg.vector_norm(r)) <= tol * float(nb):
            return x, it, True
        z = M(r)
        rz_new = (r * z).sum()
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, maxiter, False


def control_readings(cell, system, ref, seed: int, device, maxiter: int,
                     dtype: torch.dtype = torch.bfloat16) -> dict:
    """The program's and the control's numbers at the stream's first
    window step of ``seed``, on a built ``system`` and reference."""
    from portbench.harness import check, core
    from portbench.harness.traffic import Stream

    cfg = cell.config
    stream = Stream(cell.traffic, system.points(), cfg["lattice"]["cells"],
                    seed)
    loop = core._Loop(system, stream, device)
    for _ in range(cell.traffic["warmup_steps"] + 1):
        rec = loop.step()
    view = system.view()
    sample = core._copy(rec)
    limits = cell.params["limits"]
    program = check.judge(ref, view, [sample], limits)

    bf = dtype
    _, r_beam, _, layout = view.to_reference(ref, sample)
    M_prog = system.preconditioner(sample["r"], loop.state)
    free = (~ref.fixed)[:, None].to(torch.float32)
    b = (ref.f * free).to(torch.float32)

    def A(v):
        return free * ref.apply(free * v, r_beam, bf).to(torch.float32) \
            + (1.0 - free) * v

    def M(v):
        w = M_prog(view.u_from_ref(ref, v, torch.float32))
        return view.u_to_ref(ref, w).to(torch.float32)

    t = time.perf_counter()
    u, iters, conv = _pcg(A, b, M, cfg["solver"]["tol"], maxiter)
    solve_s = time.perf_counter() - t
    c_ctrl = float((ref.f.to(bf) * u.to(bf)).sum())
    g_ctrl = layout(ref.dc_dr(u, r_beam, bf).to(torch.float32)
                    ).to(torch.float64)
    # the control's answer in the program's layout, judged as a step is
    answer = {"k": rec["k"], "c": c_ctrl, "r": sample["r"],
              "g": g_ctrl.to(sample["g"].dtype),
              "u": view.u_from_ref(ref, u, sample["u"].dtype)}
    control = check.judge(ref, view, [answer], limits)
    values = lambda v: {k: c["value"] for k, c in v["checks"].items()}
    return {"cell": cell.name, "seed": seed, "step": rec["k"],
            "program": values(program), "program_ok": program["ok"],
            "control": values(control), "control_ok": control["ok"],
            "limits": limits,
            "control_iterations": iters, "control_converged": conv,
            "control_solve_s": solve_s,
            "program_iterations": rec["iterations"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--maxiter", type=int, default=1000)
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16",
                    help="bf16: the control; f32: the reference at the "
                         "configurations' own precision, as a witness")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.harness import check, kcache, spec

    cell = spec.resolve(args.workload, ROOT)
    device = torch.device("cuda", 0)
    kcache.prime(ROOT, cell.system().KERNEL_SOURCES)
    system = cell.system().System(cell.config, device)
    ref = check.reference(cell, device)
    for seed in args.seeds:
        got = control_readings(cell, system, ref, seed, device, args.maxiter,
                               DTYPES[args.dtype])
        print(json.dumps(dict(got, dtype=args.dtype)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
