"""Carry the JAX step's inputs and frozen multigrid state into the port.

Both functions take numpy arrays (``np.asarray`` of the JAX values), never
JAX objects, so this module imports no JAX: a test converts the JAX tree to
numpy and hands it over, and both packages then run from the same frozen
preconditioner.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["precond_state_from_jax", "step_inputs_from_jax"]


def _t(a, dtype, device):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def precond_state_from_jax(tree_of_numpy: dict, dtype=torch.float64,
                           device="cuda") -> dict:
    """A JAX ``mg_precond_state`` (leaves as numpy) -> the port's state.

    Keeps ``radii``, ``auxs`` (gather-layout padded r^2 fields, [n_e, Xp,
    Yp, Zp] per level), ``Ds`` and ``lmaxs``.  The JAX state's bf16 and
    fused entries must be empty: the port has no such smoother yet.
    """
    st = tree_of_numpy
    for key in ("auxs_lo", "fused"):
        if any(x is not None for x in st.get(key) or []):
            raise NotImplementedError(
                f"JAX state carries '{key}' operands; the bf16 and fused "
                "smoothers are ROADMAP.md queue B")
    for aux in st["auxs"]:
        if np.ndim(aux) != 4:
            raise ValueError("auxs must be gather-layout [n_e, Xp, Yp, Zp] "
                             f"fields (got ndim {np.ndim(aux)}); build the "
                             "JAX state with PLDSO_MATVEC=gather")
    return {k: [_t(x, dtype, device) for x in st[k]]
            for k in ("radii", "auxs", "Ds", "lmaxs")}


def step_inputs_from_jax(radius, free, f, dtype=torch.float64,
                         device="cuda"):
    """(radius, free, f) as numpy -> tensors of the port's dtype/device."""
    return tuple(_t(a, dtype, device) for a in (radius, free, f))
