"""The yardstick's table of peaks and its counts of a kernel's bytes and
operations.

Peaks: NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit:
3.35 TB/s of HBM3 and 67 TFLOP/s in float32 outside the tensor cores.  A
roofline share is the least time the card could take, the larger of
bytes over bandwidth and operations over peak, over the kernel's measured
time.  Inputs count as read once and outputs as written once.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

__all__ = ["PEAKS", "peaks", "stencil_work", "bound_s", "FLOPS_PER_SIDE"]

PEAKS = {"H100": {"bytes_per_s": 3.35e12, "f32_per_s": 67e12}}

# operations of one strut side at one point of the stencil: the six
# strains from the two ends (with the frame's dot products), the section
# forces and the force and moment row added to the point's sum
FLOPS_PER_SIDE = 110


def peaks(kind: str) -> Optional[Dict]:
    """The peaks of the card named ``kind`` (None for a card not in the
    table)."""
    for key, row in PEAKS.items():
        if key in kind:
            return row
    return None


def stencil_work(grid: Tuple[int, int, int], classes: int, strut_types: int,
                 itemsize: int = 4) -> Tuple[int, int]:
    """(bytes, operations) of one application of the class-grid stencil
    K.u on ``grid`` points per axis: the ghost-padded u of every node
    class's 6 DOFs and the ghost-padded r^2 of every strut type read once,
    K.u written once; two sides per strut type at every point."""
    X, Y, Z = grid
    padded = (X + 2) * (Y + 2) * (Z + 2)
    points = X * Y * Z
    nbytes = itemsize * ((6 * classes + strut_types) * padded
                         + 6 * classes * points)
    return nbytes, FLOPS_PER_SIDE * 2 * strut_types * points


def bound_s(work: Tuple[int, int], peak: Dict) -> float:
    nbytes, ops = work
    return max(nbytes / peak["bytes_per_s"], ops / peak["f32_per_s"])
