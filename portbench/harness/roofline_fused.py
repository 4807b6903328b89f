"""The yardstick's counts of the bytes and operations of one launch of the
fused V-cycle's kernels B3 (the residual fm (b - K x)), B4 (one Chebyshev
step, or its final emit x + d) and B5 (a level's whole smoother), in
float32 arithmetic, with the peaks of ``harness/roofline.py``.

Vectors are ghost-padded [nc, 6, X + 2, Y + 2, Z + 2] fields and r^2 one
ghost-padded field per strut type, each ``itemsize`` bytes an element (2
for bf16 storage); inputs count as read once and outputs as written once.
A stencil application is ``roofline.FLOPS_PER_SIDE`` operations per strut
side (two per strut type) per interior point; the pointwise update adds
its operations per interior DOF.

``events`` finds a kernel's operations in the trace by name and template
arguments (the storage type first: ``__nv_bfloat16``), and ``share`` is
the readers' roofline: the least time of the launches the program counted,
over the kernel's device time, or None where the counts and the trace's
events disagree.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from . import roofline
from .roofline import FLOPS_PER_SIDE

__all__ = ["residual_work", "cheb_run_work", "cheb_full_work", "events",
           "share", "BF16"]

BF16 = "__nv_bfloat16"          # the storage type's name in a kernel's name


def _sizes(grid: Tuple[int, int, int], classes: int, strut_types: int):
    X, Y, Z = grid
    padded = (X + 2) * (Y + 2) * (Z + 2)
    points = X * Y * Z
    stencil = FLOPS_PER_SIDE * 2 * strut_types * points
    return padded, points, 6 * classes, stencil


def residual_work(grid, classes: int, strut_types: int,
                  itemsize: int = 2) -> Tuple[int, int]:
    """B3: x, b, fm and r^2 read, the residual written."""
    padded, points, rows, stencil = _sizes(grid, classes, strut_types)
    return (itemsize * (4 * rows * padded + strut_types * padded),
            stencil + 2 * rows * points)


def cheb_run_work(grid, classes: int, strut_types: int, final: bool,
                  itemsize: int = 2) -> Tuple[int, int]:
    """B4: x, r, d, fd and r^2 read; x1, r1 and d1 written, or x1 + d1
    alone by the final emit."""
    padded, points, rows, stencil = _sizes(grid, classes, strut_types)
    n_out = 1 if final else 3
    return (itemsize * ((4 + n_out) * rows * padded + strut_types * padded),
            stencil + (6 + int(final)) * rows * points)


def cheb_full_work(grid, classes: int, strut_types: int, degree: int,
                   with_x0: bool, itemsize: int = 2) -> Tuple[int, int]:
    """B5: b, fd, r^2 (and x0) read, x + d written; ``degree`` stencil
    applications, one more for x0's residual."""
    padded, points, rows, stencil = _sizes(grid, classes, strut_types)
    n_in = 3 if with_x0 else 2
    return (itemsize * ((n_in + 1) * rows * padded + strut_types * padded),
            (degree + int(with_x0)) * stencil
            + (6 * degree + 3) * rows * points)


def _template_args(name: str, kernel: str) -> Optional[List[str]]:
    """The template arguments of a trace name of ``kernel``, or None for
    another kernel's."""
    if not name.startswith(kernel + "<") or ">" not in name:
        return None
    return name[len(kernel) + 1:name.index(">")].split(", ")


def events(by_name: Dict, kernel: str,
           args: Sequence[Optional[str]] = ()) -> Tuple[float, int]:
    """(seconds, count) of the trace's operations (``by_name``: name ->
    [seconds, count]) of ``kernel`` whose leading template arguments are
    ``args`` (None: any)."""
    secs, count = 0.0, 0
    for name, (s, c) in by_name.items():
        got = _template_args(name, kernel)
        if got is None or len(got) < len(args) or any(
                a is not None and a != g for a, g in zip(args, got)):
            continue
        secs += s
        count += c
    return secs, count


def share(readings, parts) -> Optional[float]:
    """100 x the least time of the counted launches over their device
    time, in %; ``parts`` holds, per instance of the kernel, its trace
    (kernel, template arguments) and its counted launches as (count,
    (bytes, operations)) pairs.  None without a trace, a card in the peaks'
    table, launches, or where an instance's events differ from its count."""
    tr = readings.get("trace")
    peak = roofline.peaks(readings.get("kind") or "")
    if not tr or peak is None:
        return None
    secs = bound = 0.0
    for (kernel, args), launched in parts:
        s, count = events(tr["by_name"], kernel, args)
        if count != sum(n for n, _ in launched):
            return None
        secs += s
        bound += sum(n * roofline.bound_s(w, peak) for n, w in launched)
    return 100.0 * bound / secs if secs > 0 else None
