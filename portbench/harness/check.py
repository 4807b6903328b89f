"""Whether the answers of the timed path are correct.

After the window, a sample of the window's steps (drawn from the seed,
the last step always in it) is judged against the plain reference, which
builds its own lattice, loads and operator from the configuration.  For
each sampled step, from the design the step was given and the program's
(c, g, u):

* ``res``: the relative residual of u under the reference's float64
  operator (the solve and the operator);
* ``c_gap``: |c - f.u| / |f.u| with f.u in float64 (the compliance
  reported is that of the u returned);
* ``g_gap``: max |g - g_ref| / max |g_ref|, with g_ref the reference's
  float64 compliance gradient at the program's u (the gradient stage).

The reference follows the gradient from the program's u; ``res`` checks
that u by itself.  Each number is the largest over the sample and is held
to its limit in ``cells/<cell>.json``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

__all__ = ["Reservoir", "reference", "numbers", "judge", "NAMES"]

NAMES = ("res", "c_gap", "g_gap")


class Reservoir:
    """A seeded uniform sample of ``size`` steps of the window (Algorithm
    R), besides the last step, which ``close`` adds."""

    def __init__(self, size: int, seed: int):
        self.size = max(int(size) - 1, 0)
        self.rng = np.random.default_rng([int(seed), 7])
        self.kept: List = []
        self.seen = 0

    def offer(self, make) -> None:
        """Offer the next step; ``make()`` copies it when it is kept."""
        k = self.seen
        self.seen += 1
        if k < self.size:
            self.kept.append(make())
            return
        j = int(self.rng.integers(0, k + 1))
        if j < self.size:
            self.kept[j] = make()

    def close(self, last) -> List:
        """The sample with the window's last step (once)."""
        return [s for s in self.kept if s["k"] != last["k"]] + [last]


def reference(cell, device):
    """The cell's plain reference, built from its configuration."""
    lat, mat = cell.config["lattice"], cell.config["material"]
    return cell.reference().OctetLattice(lat["cells"], mat["E"], mat["nu"],
                                         mat["kappa"], lat["load"],
                                         device=device)


def _share(gap: float, scale: float) -> float:
    """gap / scale; a zero scale (a u or g that is all zero) cannot be
    judged and reads infinite."""
    return gap / scale if scale > 0 else float("inf")


def numbers(ref, view, sample) -> Dict[str, float]:
    """The three numbers of one sampled step."""
    u, r_beam, g_prog, g_layout = view.to_reference(ref, sample)
    res = ref.residual(u, r_beam)
    fu = ref.compliance(u)
    c = float(sample["c"])
    g_ref = g_layout(ref.dc_dr(u, r_beam))
    g_gap = float((g_prog.to(torch.float64) - g_ref).abs().max())
    return {"res": res, "c_gap": _share(abs(c - fu), abs(fu)),
            "g_gap": _share(g_gap, float(g_ref.abs().max()))}


def judge(ref, view, samples: List, limits: Dict) -> Dict:
    """The largest of each number over the sample, against its limit."""
    got = [numbers(ref, view, s) for s in samples]
    # np.max keeps a NaN, which fails its limit
    worst = {k: float(np.max([g[k] for g in got])) if got else float("nan")
             for k in NAMES}
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in NAMES}
    ok = bool(samples) and all(np.isfinite(worst[k]) and
                               worst[k] <= limits[k] for k in NAMES)
    return {"ok": ok, "checks": checks}
