"""Kernel B4 (one Chebyshev step of the fused V-cycle in bf16 storage, f32
compute: ``csrc/mg_fused.cu`` ``mg_cheb_run_kernel<__nv_bfloat16, FINAL,
false>``) against its roofline over the traced steps: the least time of
its launches at each level's grid, a middle step (three outputs) and the
final emit (one) each at its own bytes (``harness/roofline_fused.py``),
over the kernel's device time.  Each instance's launches per level come
from the program's counters and must equal its events in the trace; None
on a program that does not count the final emits apart."""

from portbench.harness import roofline_fused as rf


def read(readings):
    tr = readings.get("trace")
    got = (tr or {}).get("launches") or {}
    if "B4" not in got or "B4_final" not in got:
        return None
    ref = readings["reference"]
    classes, types = len(ref.node_classes()), ref.strut_types()
    parts = []
    for key, final in (("B4", False), ("B4_final", True)):
        launched = [(n, rf.cheb_run_work(g, classes, types, final))
                    for n, g in zip(got[key], got["grids"])]
        parts.append((("mg_cheb_run_kernel",
                       (rf.BF16, "true" if final else "false", "false")),
                      launched))
    return rf.share(readings, parts)
