"""Kernel B3 (the fused V-cycle's residual fm (b - K x) in bf16 storage,
f32 compute: ``csrc/mg_fused.cu`` ``mg_residual_kernel<__nv_bfloat16,
false>``) against its roofline over the traced steps: the least time of
its launches at each level's grid (``harness/roofline_fused.py``, node
classes and strut types counted from the reference's template) over the
kernel's device time.  The launches per level come from the program's
counters and must equal the kernel's events in the trace; None on a
program that does not count B4's final emits apart (whose system reports
no fused launches)."""

from portbench.harness import roofline_fused as rf


def read(readings):
    tr = readings.get("trace")
    got = (tr or {}).get("launches") or {}
    if "B3" not in got:
        return None
    ref = readings["reference"]
    classes, types = len(ref.node_classes()), ref.strut_types()
    launched = [(n, rf.residual_work(g, classes, types))
                for n, g in zip(got["B3"], got["grids"])]
    return rf.share(readings, [(("mg_residual_kernel", (rf.BF16, "false")),
                                launched)])
