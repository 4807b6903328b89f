"""The port's structured compliance step on the fused V-cycle: the same
step, lattice, loads and outputs as ``systems/structured.py`` (whose
``System`` and ``View`` this file reuses), with the configuration's
``solver.mg`` asking for the fused smoother, kernels B3 (the mid-cycle
residual), B4 (one Chebyshev step, or the final emit) and B5 (a level's
whole smoother in one launch).

The configuration states the smoother's storage (``solver.fused_storage``)
and, by its float32 dtype, the kernels' float32 compute; set-up raises
unless the program's storage is that one, every multigrid level routes
fused and computes in float32, and each state built is checked again: a
run never falls back to the unfused V-cycle.  No environment variable is
set or read here.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from pylatticedso_tpu_torch.kernels.fused import storage_dtype
from portbench.systems.structured import KERNEL_SOURCES, System as _Base
from portbench.systems.structured import View

__all__ = ["System", "View", "KERNEL_SOURCES"]

# the fused smoother's launch counters (f32 compute) by the tag the
# benchmark reads: B3's, and B4's, whose final emits a program that counts
# them apart keeps in ``final_launches``
B3, B4 = "residual", "cheb_run"


class System(_Base):
    def __init__(self, cfg: Dict, device: torch.device):
        sol = cfg["solver"]
        want = getattr(torch, sol["fused_storage"])
        if not sol["mg"].get("fused"):
            raise ValueError("structured_fused: solver.mg.fused must be true")
        if storage_dtype() != want:
            raise RuntimeError(
                f"the program's fused storage is {storage_dtype()}, the "
                f"configuration states {want}")
        super().__init__(cfg, device)
        self.storage = want
        levels = self.step.hierarchy["levels"]
        self._fused = [lvl.fused for lvl in levels]
        off = [k for k, fz in enumerate(self._fused) if not fz.ok]
        if off:
            raise RuntimeError(
                f"levels {off} of grids {[self.grids[k] for k in off]} do "
                f"not route to the fused smoother in {want} storage")
        other = [k for k, fz in enumerate(self._fused)
                 if fz.compute_type() != "f32"]
        if other:
            raise RuntimeError(
                f"levels {other} would compute the fused smoother in bf16; "
                f"the configuration states float32")

    def prepare(self, r: torch.Tensor):
        state = super().prepare(r)
        ops = state.get("fused") or []
        if len(ops) != len(self._fused) or any(
                op is None or op["fdinv"].dtype != self.storage
                for op in ops):
            raise RuntimeError("the MG state lacks a level's fused operands "
                               f"in {self.storage}")
        return state

    def reset_counters(self) -> None:
        super().reset_counters()
        for fz in self._fused:
            for counts in (fz.launches, getattr(fz, "final_launches", {})):
                for k in counts:
                    counts[k] = 0
            fz.b5_launches.clear()
            fz.b5_shapes.clear()

    def launches(self) -> Dict[str, List]:
        """B1's launches per level and grids (``systems/structured.py``);
        where the program counts B4's final emits apart, also B3's, B4's
        middle steps' and final emits' launches per level, and B5's as
        records of the level, its grid, the degree and whether it started
        from x0 (f32 compute)."""
        out = super().launches()
        if not all(hasattr(fz, "final_launches") for fz in self._fused):
            return out
        out["B3"] = [fz.launches[B3] for fz in self._fused]
        out["B4_final"] = [fz.final_launches[B4] for fz in self._fused]
        out["B4"] = [fz.launches[B4] - fz.final_launches[B4]
                     for fz in self._fused]
        out["B5"] = [{"level": k, "grid": list(self.grids[k]),
                      "degree": degree, "with_x0": x0, "launches": n}
                     for k, fz in enumerate(self._fused)
                     for (ct, degree, x0), n in sorted(fz.b5_shapes.items())
                     if ct == "f32" and n]
        return out
