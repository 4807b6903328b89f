"""Wrappers of the stencil matvec kernels B1 and B2
(``csrc/stencil_matvec.cu``).

B1 replaces the TPU kernel ``make_pallas_matvec -> make_call(jnp.float32)``
of ``pylatticedso_tpu/parallel/stencil_pallas.py``: the structured
Timoshenko stencil K.u in float32 over ghost-padded class fields.  B2
replaces ``make_call(jnp.bfloat16)`` (``apply.lo``): the same K.u with
bfloat16 loads and stores and float32 arithmetic, the matvec of the
multigrid's bf16-I/O smoother.

``StencilMatvec(slat, plain)`` is the ``apply(u, r2p)`` of one lattice's
operator, and ``apply.lo(u_lo, r2_lo)`` its bf16-I/O form.  On a CPU tensor
each returns its plain version, the gather form of ``parallel/structured.py``
(for ``lo``: on the bf16 inputs widened, the result rounded to bf16).  On a
CUDA tensor each launches its kernel or raises — there is no fallback.
``launches`` counts B1 launches and ``launches_lo`` B2 launches.

The kernel reads the edge sides from a device table built here from
``edge_sides`` (the counterpart of ``stencil_pallas._edge_sides``), sorted
by self class so that each class's sides keep the gather form's order.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build

__all__ = ["StencilMatvec", "edge_sides", "side_table", "SIDE_DTYPE",
           "FLOPS_PER_SIDE"]

# must match ``struct Side`` in csrc/stencil_body.cuh (64 bytes)
SIDE_DTYPE = np.dtype([
    ("co", "<i4"), ("du", "<i4"), ("dr", "<i4"), ("ei", "<i4"),
    ("side", "<i4"), ("t", "<f4", (3,)), ("a1", "<f4", (3,)),
    ("a2", "<f4", (3,)), ("invL", "<f4"), ("halfL", "<f4")])
assert SIDE_DTYPE.itemsize == 64

# operations per edge side per output point (strains, forces, accumulate);
# the JAX cost estimate uses the same figure (stencil_pallas.py:540)
FLOPS_PER_SIDE = 110


def edge_sides(slat, Yp: int, Zp: int) -> List[dict]:
    """Static per-edge-side records: self/other class, flat shifts in the
    padded grid, frame — the same records, in the same order, as
    ``stencil_pallas._edge_sides``."""
    recs = []
    flat = lambda v: int(v[0]) * (Yp * Zp) + int(v[1]) * Zp + int(v[2])
    for ei, e in enumerate(slat.edges):
        d = (e["ob"][0] - e["oa"][0], e["ob"][1] - e["oa"][1],
             e["ob"][2] - e["oa"][2])
        # side A: output class ca at p; other endpoint at p + d; r^2 at p - oa
        recs.append(dict(ei=ei, side=0, cs=e["ca"], co=e["cb"],
                         du=flat(d), dr=flat([-o for o in e["oa"]]),
                         t=e["t"], a1=e["a1"], a2=e["a2"], L=e["L"]))
        # side B: output class cb at p; other endpoint at p - d; r^2 at p - ob
        recs.append(dict(ei=ei, side=1, cs=e["cb"], co=e["ca"],
                         du=flat([-x for x in d]),
                         dr=flat([-o for o in e["ob"]]),
                         t=e["t"], a1=e["a1"], a2=e["a2"], L=e["L"]))
    return recs


def side_table(slat) -> Tuple[np.ndarray, np.ndarray]:
    """(sides [n_sides] SIDE_DTYPE, class_start [nc + 1] int32): the
    records of ``edge_sides`` stably sorted by self class."""
    Yp, Zp = slat.grid[1] + 2, slat.grid[2] + 2
    recs = edge_sides(slat, Yp, Zp)
    order = sorted(range(len(recs)), key=lambda i: recs[i]["cs"])
    table = np.zeros(len(recs), SIDE_DTYPE)
    for j, i in enumerate(order):
        r = recs[i]
        table[j] = (r["co"], r["du"], r["dr"], r["ei"], r["side"],
                    r["t"], r["a1"], r["a2"], 1.0 / r["L"], 0.5 * r["L"])
    counts = np.bincount([r["cs"] for r in recs], minlength=slat.nc)
    class_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return table, class_start


def _bind(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, cf, cf, cf, vp]
        fn.restype = ctypes.c_int
    return fn


class StencilMatvec:
    """apply(u [nc, 6, X, Y, Z], r2p [n_e, Xp, Yp, Zp]) -> K.u."""

    name = "stencil_matvec_f32"
    source = "pylatticedso_tpu_torch/csrc/stencil_matvec.cu"
    replaces = "pylatticedso_tpu/parallel/stencil_pallas.py:530"
    name_lo = "stencil_matvec_bf16"
    replaces_lo = "pylatticedso_tpu/parallel/stencil_pallas.py:546"

    def __init__(self, slat, plain: Callable):
        self.plain = plain
        self.dtype = slat.dtype
        self.launches = 0
        self.launches_lo = 0
        self.grid = tuple(slat.grid)
        self.nc = slat.nc
        self.n_e = len(slat.edges)
        G_mod = slat.E_mod / (2.0 * (1.0 + slat.nu))
        self.consts = (float(slat.E_mod), float(slat.kappa * G_mod),
                       float(2.0 * G_mod))
        self._table, self._class_start = side_table(slat)
        self._dev: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def n_sides(self) -> int:
        return len(self._table)

    def work(self, itemsize: int = 4) -> Tuple[int, int]:
        """(bytes, operations) one application needs: padded u and r^2
        read once, the output written once, ``itemsize`` bytes each (4 for
        B1, 2 for B2)."""
        X, Y, Z = self.grid
        Fp = (X + 2) * (Y + 2) * (Z + 2)
        N = X * Y * Z
        nbytes = itemsize * (self.nc * 6 * Fp + self.n_e * Fp
                             + self.nc * 6 * N)
        return nbytes, FLOPS_PER_SIDE * self.n_sides * N

    def __call__(self, u: torch.Tensor, r2p: torch.Tensor) -> torch.Tensor:
        if u.device.type == "cpu":
            return self.plain(u, r2p)
        return self.launch(F.pad(u, (1, 1, 1, 1, 1, 1)).contiguous(), r2p)

    def prepare_lo(self, r2p: torch.Tensor) -> torch.Tensor:
        """bf16 copy of the padded r^2 fields, B2's second operand."""
        return r2p.to(torch.bfloat16)

    def lo(self, u_lo: torch.Tensor, r2_lo: torch.Tensor) -> torch.Tensor:
        """bf16-I/O K.u: bf16 u [nc, 6, X, Y, Z] and r^2 in, bf16 out, with
        the arithmetic in float32."""
        if u_lo.dtype != torch.bfloat16 or r2_lo.dtype != torch.bfloat16:
            raise ValueError(f"B2 takes bfloat16 u and r^2 (got {u_lo.dtype},"
                             f" {r2_lo.dtype})")
        if u_lo.device.type == "cpu":
            return self.plain_lo(u_lo, r2_lo)
        return self.launch(F.pad(u_lo, (1, 1, 1, 1, 1, 1)), r2_lo)

    def plain_lo(self, u_lo: torch.Tensor, r2_lo: torch.Tensor):
        """B2's plain version: the gather form on the widened bf16 inputs,
        the result rounded to bf16."""
        return self.plain(u_lo.to(self.dtype),
                          r2_lo.to(self.dtype)).to(torch.bfloat16)

    def tables(self, device):
        """(sides, class_start) on ``device``, uploaded once per device."""
        if device not in self._dev:
            sides = torch.from_numpy(self._table.view(np.uint8).copy())
            self._dev[device] = (sides.to(device),
                                 torch.from_numpy(self._class_start).to(device))
        return self._dev[device]

    def launch(self, up: torch.Tensor, r2p: torch.Tensor) -> torch.Tensor:
        """Run B1 (float32 u and r^2) or B2 (bfloat16 u and r^2) on an
        already ghost-padded u [nc, 6, Xp, Yp, Zp]."""
        X, Y, Z = self.grid
        padded = (X + 2, Y + 2, Z + 2)
        if up.device.type != "cuda" or r2p.device != up.device:
            raise ValueError(f"B1/B2 need u and r^2 on one CUDA device, got "
                             f"{up.device} and {r2p.device}")
        lo = up.dtype == torch.bfloat16
        io = torch.bfloat16 if lo else torch.float32
        if up.dtype != io or r2p.dtype != io:
            raise NotImplementedError(
                f"B1/B2 on CUDA take float32 or bfloat16 u and r^2 of one "
                f"type (got {up.dtype}, {r2p.dtype}); float64 on the card: "
                "ROADMAP.md queue A, deferred feature 'f64 on card'")
        if torch.is_grad_enabled() and (up.requires_grad or r2p.requires_grad):
            raise NotImplementedError(
                "B1 has no autograd.Function VJP yet: ROADMAP.md queue A, "
                "deferred feature 'implicit gradient'")
        if tuple(up.shape) != (self.nc, 6) + padded \
                or tuple(r2p.shape) != (self.n_e,) + padded:
            raise ValueError(f"B1/B2 shapes: u {tuple(up.shape)}, r^2 "
                             f"{tuple(r2p.shape)} for grid {self.grid}")
        if not (up.is_contiguous() and r2p.is_contiguous()):
            raise ValueError("B1/B2 need contiguous u and r^2")
        name = self.name_lo if lo else self.name
        fn = _bind(build.load("stencil_matvec"), name)
        sides, class_start = self.tables(up.device)
        out = torch.empty((self.nc, 6, X, Y, Z), dtype=io, device=up.device)
        E, kG, G2 = self.consts
        rc = fn(up.data_ptr(), r2p.data_ptr(), out.data_ptr(),
                sides.data_ptr(), class_start.data_ptr(), self.nc, X, Y, Z,
                E, kG, G2, torch.cuda.current_stream(up.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")
        if lo:
            self.launches_lo += 1
        else:
            self.launches += 1
        return out
