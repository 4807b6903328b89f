"""``dryrun_multichip``: the sharded paths on an ``n``-device mesh, one
real execution of each on tiny shapes (the port of
``__graft_entry__.py:57-260``).

Mesh axes ``dp`` (design candidates) x ``shard`` (edges, or grid slabs):
``n_dp = 2`` where ``n_devices`` is even, as in JAX.  Four phases, each
with JAX's shapes, options and gate (the sharded compliance within rel.
diff. 1e-4 of the one-device step; every value finite):

- ``unstructured``: the edge-sharded operator (``parallel.sharding``) on
  a 2x2x2 Octet lattice, a batch of two candidates over ``dp``;
- ``structured``: the slab-sharded structured step
  (``shard_structured_step``) on a BCC lattice whose grid X divides by
  ``n_shard``, Jacobi;
- ``hybrid``: the same on a Cubic+BCC lattice;
- ``mg``: the multigrid-preconditioned step with a frozen state, on a BCC
  lattice of ``2 n_shard - 1`` cells (the grid divides, the hierarchy
  coarsens at least once).

The phases run in this process: JAX ran each in a subprocess only to keep
the TPU plugin out of the parent.  ``devices`` defaults to every CUDA
device; on one card pass ``["cuda:0"] * n`` for a virtual mesh, on the CPU
``["cpu"] * n``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import torch

__all__ = ["dryrun_multichip", "PHASES", "REL_GATE"]

PHASES = ("unstructured", "structured", "hybrid", "mg")
REL_GATE = 1e-4          # f32 and different reduction orders
E_MOD, NU = 1013.0, 0.3


def _small_problem(device, nx=2, ny=2, nz=2, geom="Octet"):
    from .design import build_lattice
    from .fem.bc import apply_boundary_conditions

    lat = build_lattice({
        "geometry": {"cell_size": {"x": 1, "y": 1, "z": 1},
                     "number_of_cells": {"x": nx, "y": ny, "z": nz},
                     "radii": [0.05], "geom_types": [geom]},
        "boundary_conditions": {
            "Displacement": {"Fixed": {"Surface": ["Zmin"],
                                       "DOF": ["X", "Y", "Z", "RX", "RY",
                                               "RZ"],
                                       "Value": [0, 0, 0, 0, 0, 0]}},
            "Force": {"Load": {"Surface": ["Zmax"], "DOF": ["Z"],
                               "Value": [-0.5]}}}})
    return lat, apply_boundary_conditions(lat)


def _structured_case(geoms, n_shard: int, device, ncell: Optional[int] = None):
    """Tiny structured lattice whose grid X axis divides by n_shard."""
    from .parallel.structured import StructuredLattice

    if ncell is None:
        ncell = max(n_shard - 1, 3)     # grid X = ncell + 1
    lat = StructuredLattice(geoms, (ncell, 2, 2), (1.0, 1.0, 1.0), E_MOD, NU,
                            dtype=torch.float32, device=device)
    free = lat.select_nodes(lambda x, y, z: x > 1e-9)
    f = lat.node_field()
    tip = lat.select_nodes(lambda x, y, z: x > ncell - 1e-9)
    f[:, 2][tip] = -0.1
    return lat, free, f, ncell


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def _phase(phase: str, mesh, one) -> Dict:
    """One phase on ``mesh`` against the one-device mesh ``one``."""
    from .parallel.sharding import ShardedLattice, make_compliance_step
    from .parallel.structured import (make_structured_compliance_step,
                                      shard_structured_step)

    dev = mesh.device
    if phase == "unstructured":
        lat, bc = _small_problem(dev)
        steps = []
        for m in (mesh, one):
            shl = ShardedLattice(m, lat.nodes, lat.edges, E_MOD, NU,
                                 dtype=torch.float32)
            step = make_compliance_step(shl, ~bc.fixed, bc.f_applied,
                                        tol=1e-5, maxiter=300)
            r = shl.radius_padded(lat.radius)
            steps.append((shl, step, r))
        (shl, step, r), (shl1, step1, r1) = steps
        c, g = step.batch(torch.stack([r, r * 1.2]))
        ref = [step1(r1), step1(r1 * 1.2)]
        rel = max(_rel(float(c[k]), float(ref[k][0])) for k in range(2))
        finite = bool(torch.isfinite(c).all() and torch.isfinite(g).all())
        return {"compliances": [float(x) for x in c],
                "one_device": [float(x[0]) for x in ref], "rel": rel,
                "finite": finite, "edges": int(shl.n_real),
                "padded_edges": int(shl.edges.shape[1])}
    n_shard = mesh.shape["shard"]
    if phase == "mg":
        lat, free, f, ncell = _structured_case("BCC", n_shard, dev,
                                               ncell=2 * n_shard - 1)
        base = make_structured_compliance_step(
            lat, free, f, tol=1e-5, maxiter=200, precond="mg",
            mg_opts={"nu": 2, "coarse_degree": 8, "smooth_frac": 0.25,
                     "power_iters": 3})
    else:
        geoms = ["Cubic", "BCC"] if phase == "hybrid" else "BCC"
        lat, free, f, ncell = _structured_case(geoms, n_shard, dev)
        base = make_structured_compliance_step(
            lat, free, f, tol=1e-5, maxiter=200, precond="jacobi")
    shape = (2, ncell, 2, 2) if phase == "hybrid" else (ncell, 2, 2)
    rfield = torch.full(shape, 0.05, dtype=torch.float32, device=dev)
    pstate = base.precond_state(rfield) if phase == "mg" else None
    c0, g0, _u = base(rfield, None, pstate)
    step = shard_structured_step(base, mesh)
    c1, g1, u1 = step(rfield, None, pstate)
    return {"compliance": float(c1), "one_device": float(c0),
            "rel": _rel(float(c1), float(c0)),
            "finite": bool(torch.isfinite(g1).all()),
            "grid": list(lat.grid), "grid_axis": step.grid_axis,
            "slabs": len(u1.parts),
            "sharded_levels": step.n_sharded_levels,
            "iterations": step.last_solve["iterations"]}


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None,
                     log: Callable[[str], None] = print) -> Dict:
    """The four phases on an ``n_devices`` mesh (``dp`` = 2 where
    ``n_devices`` is even); raises on the first phase whose sharded
    compliance is off the one-device step's by ``REL_GATE`` or more, or
    not finite.  Returns each phase's record."""
    from .parallel.mesh import make_mesh

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no devices given and no "
                               "CUDA device; pass devices=['cpu'] * n")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}): "
                           f"{len(devices)} devices given")
    n_dp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_shard=n_devices // n_dp, n_dp=n_dp,
                     devices=devices[:n_devices])
    one = make_mesh(devices=devices[:1])
    out = {"mesh": dict(mesh.shape)}
    for phase in PHASES:
        t = time.perf_counter()
        rec = _phase(phase, mesh, one)
        rec["s"] = time.perf_counter() - t
        out[phase] = rec
        log(f"dryrun_multichip({n_devices}): phase {phase} mesh "
            f"{dict(mesh.shape)}: rel diff vs one device {rec['rel']:.2e} "
            f"({rec['s']:.1f} s)")
        if not (rec["finite"] and rec["rel"] < REL_GATE):
            raise AssertionError(f"dryrun_multichip({n_devices}): phase "
                                 f"{phase} diverges from the one-device "
                                 f"step: {rec}")
    log(f"dryrun_multichip({n_devices}): all {len(PHASES)} phases ok")
    return out
