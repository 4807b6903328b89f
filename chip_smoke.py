"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out report.json] [--profile profile.json]

Builds every CUDA kernel of the port with nvcc, holds each against its
plain torch version on the card (B1 in float32 and float64 and its VJP,
the r^2-cotangent kernel at every grid, B2-B5 and their bf16-compute
instances B3c-B5c, the probes P1 and P2), then drives the port's main
path once at full width on each of its routes: the 50^3 Octet compliance
step with the multigrid preconditioner, bench.py's protocol, with the
fused bf16 V-cycle (bench.py's default), the unfused bf16-I/O smoother
(BENCH_MG_FUSED=0), the unfused f32 V-cycle and the fused V-cycle in bf16
arithmetic (PLDSO_MG_FUSED_COMPUTE=bf16); then the design-gradient step (the implicit
adjoint through B1's VJP) on its three paths: float64 implicit against
analytic, a float64 displacement objective with an imposed displacement
against a central difference, and the same problem in float32 on the
fused bf16 route; then the design optimizer through optimize_lattice: the
50^3 Octet with one radius per cell (125,000) under a density bound, in
float64 on the multigrid route, three projected-gradient iterations, its
gradient against a central difference, and SLSQP, the routing and the
unstructured problem on an 8^3 grid (pylatticedso_tpu_torch/smoke.py);
then the full-lattice statics (pylatticedso_tpu_torch/smoke_statics.py):
bench.py's second mode, the edge-sharded float32 compliance step with
block Jacobi on the 50^3 Octet lattice (3,030,000 beams), cold and 8
warm chunked steps against a float64 reference, the step's other forms
at 8^3 in float64, and the statics, penalized statics and unit-cell
homogenization on the card against the CPU; then the domain-decomposition
route (pylatticedso_tpu_torch/smoke_ddm.py): the three-point-bending
surrogate chain at full width (10x5x5 cells of BCC+Hybrid1+Hybrid4, a
1,000-sample reduced basis trained on the card, value-and-gradient
evaluations on the refined matrix-free route and on plain float64 CG),
the penalized L-beam through optimize_lattice's DDM route, and the exact
DDM solver against the FEM, the CPU and FE2; then warped lattices
(pylatticedso_tpu_torch/smoke_warped.py): the 50^3 Octet under a taper
and twist on the unfused f32 multigrid route through the warped stencil
kernel B1w against a float64 step, B1w (float32, float64) and its
r^2-cotangent against their plain versions at every multigrid grid, the
warped cantilever through optimize_lattice's FEM_AUTO route against the
unstructured problem, and the solid mesh's signed distance on the card
against the CPU; then the mesh (pylatticedso_tpu_torch/smoke_mesh.py):
a virtual mesh of the one card, every case against the one-device port:
bench.py's second mode at 50^3 edge-sharded on 1 x 4 (and step.batch of
two candidates on 2 x 4), the main path on a 51 x 50 x 50 Octet slab-sharded
on 1 x 4 (unfused f32 and fused bf16 V-cycles: B1, B3 and B4 on every
slab, halo exchanges between), dryrun_multichip on 2 x 4, the BCC N=7
multigrid case in float64, the lo route (B2 per slab) and a warped lattice
(B1w per slab), and every per-slab kernel against its plain version; last,
each of the compliance and design-gradient steps, the edge-sharded step,
the DDM evaluation and the mesh's (m1) and fused (m2) steps (beside the
same step on one device) take two more warm steps under torch.profiler,
the unfused routes lo and f32 and the mesh's one (device busy time and
idle share).
Prints the card's
name and power limit, one JSON line listing the kernels, and as the last
line {"ok": true, "device": {...}}.  Exits non-zero, with no result, when
there is no card (exit 1) or the port cannot be imported (exit 2: the
script alone, without the package beside it).
"""

import argparse
import json
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the full report (JSON) here")
    ap.add_argument("--profile", help="write the profile tables (warm "
                    "steps of each route, of the design-gradient path (c), "
                    "of the edge-sharded step and of the DDM evaluation "
                    "under torch.profiler) here")
    args = ap.parse_args()
    try:
        import torch
        from pylatticedso_tpu_torch import smoke, smoke_mesh, smoke_warped
    except ImportError as e:
        print(f"chip_smoke: cannot import the port: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    report = smoke.run(device="cuda", n=50,
                       log=lambda s: print(s, flush=True),
                       warped_size=smoke_warped.FULL,
                       mesh_size=smoke_mesh.FULL)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1, default=str)
    if args.profile:
        profs = {route: m["profile"] for route, m in report["mains"].items()}
        profs["design"] = report["design"]["c"]["profile"]
        profs["statics"] = report["statics"]["s1"]["profile"]
        profs["ddm"] = report["ddm"]["d1"]["profile"]
        profs["mesh-m1"] = report["mesh"]["m1"]["profile"]
        r = report["mesh"]["m2"]["routes"][smoke_mesh.PROFILED]
        profs[f"mesh-m2-{smoke_mesh.PROFILED}"] = r["profile"]
        profs[f"mesh-m2-{smoke_mesh.PROFILED}-one"] = \
            r["one_device"]["profile"]
        with open(args.profile, "w") as fh:
            json.dump(profs, fh, indent=1)
    print(f"wall: {report['wall_s']:.1f} s "
          f"[{report['device']['nvidia_smi']}]")
    print(report["device"]["nvidia_smi"])
    print(json.dumps({"kernels": report["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
