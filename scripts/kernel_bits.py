"""Hold the port's kernels of two checkouts against each other on one card:
the same bits where the arithmetic is meant to be the same, and times of
the redesigned kernels in turns.

    python3 scripts/kernel_bits.py CHECKOUT_A CHECKOUT_B [--out FILE]
        [--same B1,B1f64,B2,B3,B4,B5,B3c,B4c,B5c,P1] [--timed B3,r2]

Needs one CUDA card.  Runs, in a fresh process per checkout and in the
order A B B A, each checkout's own ``pylatticedso_tpu_torch`` (its kernels
built in that checkout) on the same inputs, made on the card from fixed
seeds: at every grid of ``smoke._grids(50)`` (each MG level of the 50^3
Octet hierarchy and the hybrid check case) B1 float32 and float64, B2, B3,
B4 (a step and the final emit) and B5 (every variant the smoke runs) in
float32 and bfloat16 storage, their bf16-compute instances B3c, B4c and
B5c on the levels that have them (the dense ones; B5c also at degree 1,
one phase), the r^2-cotangent kernel in float32 and float64, and P1 in
both kinds, at REPS and in one launch of REPS x 20 repeats.  Each run
reports a hash of every output and, for the kernels of ``--timed``,
CUDA-event and CUDA-graph times, and each checkout's registers and spills
of B5, B5c and P1 as nvcc's ``-Xptxas -v`` printed them.  Prints, per kernel, whether
A's and B's outputs are the same bits on every grid (required for the
kernels of ``--same``; each checkout's two runs must agree too), the
largest difference of the others relative to their largest value, and
the median times of each checkout's two runs.  Exits 1 when a kernel of
``--same`` differs.
"""

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

CHILD = r"""
import hashlib, inspect, json, sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
import torch.nn.functional as F
from pylatticedso_tpu_torch import probes, smoke
from pylatticedso_tpu_torch.kernels import build, launch
from pylatticedso_tpu_torch.kernels.fused import cheb_static
from pylatticedso_tpu_torch.parallel.multigrid import _estimate_lmax
from pylatticedso_tpu_torch.parallel.structured import StructuredLattice

dev = torch.device("cuda")
PAD = (1,) * 6
TIMED = {timed!r}
hashes, times, keep = {{}}, {{}}, {{}}


def digest(t):
    ts = t if isinstance(t, tuple) else (t,)
    h = hashlib.sha256()
    for x in ts:
        h.update(x.contiguous().reshape(-1).view(torch.uint8).cpu().numpy())
    return h.hexdigest()[:20]


def put(kernel, case, run, keep_out=False):
    out = run()
    torch.cuda.synchronize()
    key = f"{{kernel}} | {{case}}"
    hashes[key] = digest(out)
    if keep_out:
        keep[key] = out.detach().cpu()
    if kernel.split()[0] in TIMED:
        times[key] = {{"ms": smoke._median_ms(run, dev, reps=7, batch=20),
                      "graph_ms": smoke._graph_ms(run, dev)}}


for seed, (geom, cells, h, label, lvl) in enumerate(smoke._grids(50)):
    gen = torch.Generator(device=dev).manual_seed(100 + seed)
    sl = StructuredLattice(geom, (cells,) * 3, (h, h, h), smoke.E_MOD,
                           smoke.NU, dtype=torch.float32, device=dev)
    with smoke._env(PLDSO_MG_FUSED_DTYPE=smoke.FUSED_STORAGE):
        mv, diag = sl.make_matvec()
    B, fz = mv.apply, mv.apply.fused
    shape = (sl.nc, 6) + sl.grid
    fixed = sl.select_nodes(lambda x, y, z: z == 0.0)
    fm = torch.as_tensor(np.ascontiguousarray(np.broadcast_to(
        (sl.node_valid & ~fixed)[:, None], shape), np.float32), device=dev)
    u = torch.randn(shape, generator=gen, device=dev)
    g = torch.randn(shape, generator=gen, device=dev)
    b = torch.randn(shape, generator=gen, device=dev) * fm
    r = 0.04 + 0.05 * torch.rand((sl.n_geom,) + (cells,) * 3, generator=gen,
                                 device=dev)
    r2 = mv.prepare(r)
    hashes[f"inputs | {{label}}"] = digest((u, g, b, r2))
    up, gp = F.pad(u, PAD), F.pad(g, PAD)
    put("B1", label, lambda: B.launch(up, r2))
    put("r2 f32", label, lambda: B.launch_vjp(up, gp, r2), keep_out=True)
    u16, r16 = u.to(torch.bfloat16), r2.to(torch.bfloat16)
    u16p = F.pad(u16, PAD)
    put("B2", label, lambda: B.launch(u16p, r16))
    D = fm * diag(r) + (1.0 - fm)
    D = torch.where(D == 0, torch.ones_like(D), D)
    lmax = _estimate_lmax(lambda v: fm * B(fm * v, r2) + (1.0 - fm) * v, D,
                          shape, torch.float32,
                          iters=smoke.MG_OPTS["power_iters"])
    frac = smoke.MG_OPTS["smooth_frac"]
    nu = smoke.MG_OPTS["nu"]
    deg = nu[min(lvl, len(nu) - 1)] if lvl is not None else nu[-1]
    for storage, io in smoke.STORAGE.items():
        P = lambda a: F.pad(a, PAD).to(io)
        x, bp, fmp, fdp = P(u * fm), P(b), P(fm), P(fm / D)
        d, rr, r2s = P(u * fm / D), P(b - u * fm), r2.to(io)
        sc = fz.sc(lmax, frac)
        put(f"B3 {{storage}}", label, lambda: fz.residual(bp, x, fmp, r2s))
        steps = cheb_static(frac, 2)
        for final, (c1, c2) in ((False, steps[0]), (True, steps[1])):
            put(f"B4 {{storage}} {{'final' if final else 'step'}}", label,
                lambda: fz.cheb_run(x, rr, d, fdp, sc, r2s, c1, c2, final))
        computes = ("f32", "bf16") if fz.dense else ("f32",)
        if fz.dense:
            put(f"B3c {{storage}}", label,
                lambda: fz.residual(bp, x, fmp, r2s, "bf16"))
            for final, (c1, c2) in ((False, steps[0]), (True, steps[1])):
                put(f"B4c {{storage}} {{'final' if final else 'step'}}", label,
                    lambda: fz.cheb_run(x, rr, d, fdp, sc, r2s, c1, c2, final,
                                        "bf16"))
        if not fz.single_ok:
            continue
        variants = [(deg, frac, None), (deg, frac, x)]
        if lvl == len(smoke.level_cells(50)) - 1:
            variants.append((smoke.MG_OPTS["coarse_degree"], 1.0 / 64.0,
                             None))
        runs = [(v, ct) for ct in computes for v in variants]
        if fz.dense:
            runs.append(((1, frac, None), "bf16"))
        for (dg, fr, x0), ct in runs:
            scv = fz.sc(lmax, fr)
            tag = "B5" if ct == "f32" else "B5c"
            name = f"{{tag}} {{storage}} degree {{dg}}{{', x0' if x0 is not None else ''}}"
            put(name, label,
                lambda: fz.cheb_full(bp, x0, fdp, scv, r2s, fr, dg,
                                     compute=ct))
    if lvl is None:
        continue
    sl = StructuredLattice(geom, (cells,) * 3, (h, h, h), smoke.E_MOD,
                           smoke.NU, dtype=torch.float64, device=dev)
    mv, _ = sl.make_matvec()
    B = mv.apply
    u, g = u.double(), g.double()
    r2 = mv.prepare(r.double())
    up, gp = F.pad(u, PAD), F.pad(g, PAD)
    put("B1f64", label, lambda: B.launch(up, r2))
    put("r2 f64", label, lambda: B.launch_vjp(up, gp, r2), keep_out=True)

# P1 at REPS, and in one launch of REPS x LONG repeats (the parent's
# wrapper takes no repeat count: its launcher then, which takes one)
LONG = 20
xs = probes.inputs(dev)["chain"]
for kind in ("1d", "2d"):
    put(f"P1 {{kind}}", "REPS", lambda: probes.chain(xs, kind))
    if "reps" in inspect.signature(probes.chain).parameters:
        long = lambda: probes.chain(xs, kind, reps=probes.REPS * LONG)
    else:
        o = torch.empty_like(xs)
        fns = launch.functions("probes")
        long = lambda: (fns["probe_chain"](
            xs.data_ptr(), o.data_ptr(), probes.ROWS, probes.T,
            int(kind == "2d"), probes.REPS * LONG, launch.stream(0)), o)[1]
    put(f"P1 {{kind}}", f"REPS x {{LONG}}", long)

torch.save(keep, {keep_path!r})
print(json.dumps({{"hashes": hashes, "times": times,
                  "ptxas": dict(build.build_log)}}))
"""


def _registers(log):
    """(function, registers/spill line) of B5, B5c and P1 in a build log."""
    out, func = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1] if "'" in line else None
        elif func and ("cheb_full" in func or "probe_chain" in func) \
                and ("registers" in line or "spill" in line):
            out.append((func, line.strip()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--same", default="B1,B1f64,B2,B3,B4,B5,B3c,B4c,B5c,P1",
                    help="kernels whose outputs must be the same bits")
    ap.add_argument("--timed", default="B3,r2")
    ap.add_argument("--out", help="also write the runs here (JSON)")
    args = ap.parse_args()
    same = set(args.same.split(","))
    timed = args.timed.split(",")
    tmp = Path(tempfile.mkdtemp())
    roots = [str(Path(x).resolve()) for x in (args.a, args.b)]
    runs = []
    for k, root in enumerate([roots[0], roots[1], roots[1], roots[0]]):
        keep = str(tmp / f"run{k}.pt")
        res = subprocess.run(
            [sys.executable, "-c",
             CHILD.format(root=root, timed=timed, keep_path=keep)],
            capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"the run of {root} failed")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"checkout": root, "keep": keep, **got})
        print(f"run {k}: {root}", flush=True)

    import torch
    a, b = runs[0], runs[1]
    for tag, run in (("A", a), ("B", b)):
        for name, log in sorted(run["ptxas"].items()):
            for func, line in _registers(log):
                print(f"ptxas {tag} {name} {func}: {line}")
    bad = []
    for label in ("inputs",):
        ins = {k: v for k, v in a["hashes"].items() if k.startswith(label)}
        if any(b["hashes"][k] != v for k, v in ins.items()):
            raise SystemExit("the two checkouts got different inputs")
    report = {}
    for key in a["hashes"]:
        if key.startswith("inputs"):
            continue
        kernel = key.split(" | ")[0].split()[0]
        repeat = a["hashes"][key] == runs[3]["hashes"][key] \
            and b["hashes"][key] == runs[2]["hashes"][key]
        equal = a["hashes"][key] == b["hashes"][key]
        rec = {"same_bits": equal, "repeat_same_bits": repeat}
        if not equal and kernel == "r2":
            x = torch.load(a["keep"])[key].double()
            y = torch.load(b["keep"])[key].double()
            rec["max_rel_diff"] = float((x - y).abs().max()
                                        / y.abs().max())
        if key in a["times"]:
            for tag, idx in (("a", (0, 3)), ("b", (1, 2))):
                for m in ("ms", "graph_ms"):
                    rec[f"{tag}_{m}"] = statistics.median(
                        runs[i]["times"][key][m] for i in idx)
        report[key] = rec
        if not repeat or (kernel in same and not equal):
            bad.append(key)
        line = f"{key}: {'same bits' if equal else 'differs'}"
        if "max_rel_diff" in rec:
            line += f" (max rel diff {rec['max_rel_diff']:.2e})"
        if not repeat:
            line += "; a checkout's two runs differ"
        if "a_ms" in rec:
            line += (f"; A {rec['a_ms']:.4f} ms (graph "
                     f"{rec['a_graph_ms']:.4f}), B {rec['b_ms']:.4f} ms "
                     f"(graph {rec['b_graph_ms']:.4f})")
        print(line, flush=True)
    for kernel in sorted({k.split(" | ")[0].split()[0] for k in report}):
        keys = [k for k in report if k.split()[0] == kernel]
        n_same = sum(report[k]["same_bits"] for k in keys)
        print(f"{kernel}: {n_same} of {len(keys)} outputs the same bits")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"a": roots[0], "b": roots[1], "kernels": report}, fh,
                      indent=1)
    if bad:
        print(f"FAILED: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
