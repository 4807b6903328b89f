"""Per-axis gradient fields for radius / cell-size / material.

Vectorized re-implementation of the reference's gradient tables
(`pyLatticeDesign/gradient_properties.py:44-183`):
per-axis scaling factor tables of shape ``[max(n_x, n_y, n_z), 3]`` with rules
constant / linear / parabolic / sinusoide / exponential, and a 3-D integer
material field (random / uniform / graded).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["gradient_factor_table", "material_field", "GRADIENT_RULES"]

GRADIENT_RULES = ("constant", "linear", "parabolic", "sinusoide", "exponential")


def _factor(i: np.ndarray, n: int, param: float, rule: str) -> np.ndarray:
    """Gradient multiplier per cell index along one axis."""
    i = i.astype(np.float64)
    if rule == "constant":
        return np.ones_like(i)
    if rule == "linear":
        return 1.0 + i * param
    if rule == "parabolic":
        mid = n / 2.0
        up = 1.0 + (i / mid) * param
        down = 1.0 + ((n - i - 1) / mid) * param
        return np.where(i < mid, up, down)
    if rule == "sinusoide":
        return 1.0 + param * np.sin((i / n) * np.pi)
    if rule == "exponential":
        return 1.0 + np.exp(i * param)
    raise ValueError(f"Unknown gradient rule: {rule!r}. Valid: {GRADIENT_RULES}")


def gradient_factor_table(num_cells: Sequence[int],
                          rule: str = "constant",
                          direction: Sequence[bool] = (False, False, False),
                          parameters: Sequence[float] = (0.0, 0.0, 0.0)) -> np.ndarray:
    """Per-axis factor table ``table[i, axis]``.

    Matches get_grad_settings (gradient_properties.py:44-137): rows advance
    the per-axis index only while it is below that axis's cell count, so an
    axis saturates at its last factor; axes with ``direction`` False stay 1.0.
    """
    if any(n <= 0 for n in num_cells):
        raise ValueError("number of cells must be positive on every axis")
    rows = max(num_cells)
    table = np.ones((rows, 3), dtype=np.float64)
    for ax in range(3):
        if not direction[ax]:
            continue
        idx = np.minimum(np.arange(rows), num_cells[ax] - 1)
        table[:, ax] = _factor(idx, num_cells[ax], float(parameters[ax]), rule)
    return table


def material_field(num_cells: Sequence[int], multimat: int = 0, direction: int = 0,
                   rng: Optional[np.random.Generator] = None,
                   n_materials: int = 3) -> np.ndarray:
    """Integer material id per cell, shape ``[nz, ny, nx]``.

    multimat -1: random in [1, n_materials]; 0: all 1; 1: graded along
    ``direction`` (0=x, 1=y, 2=z).  Mirrors grad_material_setting
    (gradient_properties.py:142-183), including the [z][y][x] layout.
    """
    nx, ny, nz = num_cells
    if multimat == -1:
        rng = rng or np.random.default_rng()
        return rng.integers(1, n_materials + 1, size=(nz, ny, nx))
    if multimat == 0:
        return np.ones((nz, ny, nx), dtype=np.int64)
    if multimat == 1:
        x = np.arange(nx) + 1
        y = np.arange(ny) + 1
        z = np.arange(nz) + 1
        grids = np.meshgrid(z, y, x, indexing="ij")
        return grids[[2, 1, 0][direction] if direction in (0, 1, 2) else 0]
    return np.zeros((0, 0, 0), dtype=np.int64)
