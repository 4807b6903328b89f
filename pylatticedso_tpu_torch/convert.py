"""Carry the JAX step's inputs and frozen multigrid state, and the
optimizer's density model and parameterization, into the port.

Every function takes numpy arrays (``np.asarray`` of the JAX values), never
JAX objects, so this module imports no JAX: a test converts the JAX tree to
numpy and hands it over, and both packages then run from the same frozen
preconditioner, the same imposed displacements and the same objective.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["precond_state_from_jax", "step_inputs_from_jax",
           "objective_from_jax", "kriging_from_jax",
           "parameterization_from_jax"]


def _t(a, dtype, device):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _storage(a, device):
    """A float32 or bfloat16 numpy array (ml_dtypes' bfloat16 for a JAX
    bf16 value) -> a tensor of the same dtype; bf16 goes through float32,
    which holds every bf16 value exactly."""
    a = np.asarray(a)
    dt = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
    return torch.tensor(a.astype(np.float32), device=device).to(dt)


def _field(a, lead: int, padded) -> np.ndarray:
    """A padded field in the port's layout [lead, Xp, Yp, Zp] from a JAX
    gather-layout field (the same shape) or a Pallas flat [lead, Fp]."""
    a = np.asarray(a)
    if a.ndim == 4:
        return a
    F = int(np.prod(padded))
    return a[:, :F].reshape((lead,) + tuple(padded))


def _vector(a, nc: int, padded) -> np.ndarray:
    """A fused-smoother flat [nc * rows, Fp_f] (rows 8 with align8, else
    6) -> the port's ghost-padded [nc, 6, Xp, Yp, Zp]: take [:, :F], split
    the rows per class, drop the align8 rows."""
    a = np.asarray(a)
    F = int(np.prod(padded))
    rows = a.shape[0] // nc
    return a[:, :F].reshape((nc, rows) + tuple(padded))[:, :6]


def precond_state_from_jax(tree_of_numpy: dict, dtype=torch.float64,
                           device="cuda") -> dict:
    """A JAX ``mg_precond_state`` (leaves as numpy) -> the port's state.

    Takes the gather-layout state (``PLDSO_MATVEC=gather``: ``auxs`` are
    [n_e, Xp, Yp, Zp] fields) and the Pallas-layout one
    (``PLDSO_MATVEC=pallas``: ``auxs`` and ``auxs_lo`` are [n_e, Fp] flats,
    the ``fused`` operands [rows, Fp_f] flats with align8 rows).  ``radii``,
    ``auxs``, ``Ds`` and ``lmaxs`` come in ``dtype``; ``auxs_lo`` (bf16)
    and the per-level ``fused`` operands ``fdinv``, ``fm`` and ``r2`` keep
    their storage dtype and move to the port's ghost-padded layout.  A
    level's grid is read off its ``Ds`` entry [nc, 6, X, Y, Z].
    """
    st = tree_of_numpy
    n_lev = len(st["Ds"])
    shapes = [np.shape(D) for D in st["Ds"]]
    pads = [tuple(g + 2 for g in s[2:]) for s in shapes]
    n_e = [np.shape(a)[0] for a in st["auxs"]]
    out = {k: [_t(x, dtype, device) for x in st[k]]
           for k in ("radii", "Ds", "lmaxs")}
    out["auxs"] = [_t(_field(a, n_e[i], pads[i]), dtype, device)
                   for i, a in enumerate(st["auxs"])]
    lo = st.get("auxs_lo") or [None] * n_lev
    out["auxs_lo"] = [None if a is None else _storage(
        _field(a, n_e[i], pads[i]), device) for i, a in enumerate(lo)]
    fused = st.get("fused") or [None] * n_lev
    out["fused"] = []
    for i, fo in enumerate(fused):
        if fo is None:
            out["fused"].append(None)
            continue
        nc = shapes[i][0]
        out["fused"].append({
            "fdinv": _storage(_vector(fo["fdinv"], nc, pads[i]), device),
            "fm": _storage(_vector(fo["fm"], nc, pads[i]), device),
            "r2": _storage(_field(fo["r2"], n_e[i], pads[i]), device),
        })
    return out


def step_inputs_from_jax(radius, free, f, u_imposed=None,
                         dtype=torch.float64, device="cuda"):
    """(radius, free, f) as numpy -> tensors of the port's dtype/device;
    with ``u_imposed`` (the [nc, 6, X, Y, Z] imposed-displacement field
    the JAX step was built with), (radius, free, f, u_imposed)."""
    arrays = (radius, free, f) if u_imposed is None \
        else (radius, free, f, u_imposed)
    return tuple(_t(a, dtype, device) for a in arrays)


def objective_from_jax(objective_type: str, selectors=(),
                       objective_function: str = "min",
                       dtype=torch.float64, device="cuda"):
    """The port's ``objective(u, f)`` for the JAX optimizer's objective
    (``opti/structured_optimizer.py:95-111``), from its selector fields
    as numpy [nc, 6, X, Y, Z] arrays: None for ``compliance`` (the step's
    default); ``displacement``: s * sum(sel * u), s = -1 for ``max``;
    ``displacement_ratio``: -(sum(so * u) * sum(si * u))."""
    if objective_type == "compliance":
        return None
    sels = [_t(a, dtype, device) for a in selectors]
    if objective_type == "displacement":
        sign = -1.0 if objective_function == "max" else 1.0
        sel = sels[0]
        return lambda u, f_: sign * torch.sum(sel * u)
    if objective_type == "displacement_ratio":
        so, si = sels[0], sels[1]
        return lambda u, f_: -(torch.sum(so * u) * torch.sum(si * u))
    raise ValueError(f"unknown objective type {objective_type!r}")


def kriging_from_jax(fields: dict):
    """A JAX ``opti.density.KrigingDensity`` as its numpy fields
    (``{f.name: getattr(model, f.name)}`` over its dataclass fields) -> the
    port's ``KrigingDensity`` with the same values."""
    from .opti.density import _FIELDS, KrigingDensity
    return KrigingDensity(**{
        k: float(fields[k]) if np.ndim(fields[k]) == 0
        else np.array(fields[k], dtype=float) for k in _FIELDS})


def parameterization_from_jax(fields: dict):
    """A JAX ``opti.parameterization.Parameterization`` as its fields (the
    bounds, start point and cell centers as numpy) -> the port's, with the
    same kind, sizes, bounds and start point."""
    import dataclasses

    from .opti.parameterization import Parameterization
    kw = {}
    for f in dataclasses.fields(Parameterization):
        v = fields[f.name]
        if isinstance(v, np.ndarray):
            v = np.array(v, dtype=float)
        elif f.name == "_terms" and v is not None:
            v = list(v)
        kw[f.name] = v
    return Parameterization(**kw)
