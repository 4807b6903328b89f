"""Kernel B5 (a level's whole smoother in one launch, bf16 storage, f32
compute: ``csrc/mg_fused.cu`` ``mg_cheb_full_kernel<__nv_bfloat16,
WITH_X0, LAYOUT>``) against its roofline over the traced steps: the least
time of its launches at each one's level grid, degree and start (from x0
or from zero; ``harness/roofline_fused.py``) over the kernel's device time.
The launches come from the program's counters by shape and must equal the
kernel's events in the trace, with and without x0 apart; None on a
program that does not count B4's final emits apart.  On the coarse levels
(7^3 and below) the kernel is bound by latency, not by the roofline, so the
share reads a few %."""

from portbench.harness import roofline_fused as rf


def read(readings):
    tr = readings.get("trace")
    got = (tr or {}).get("launches") or {}
    if "B5" not in got:
        return None
    ref = readings["reference"]
    classes, types = len(ref.node_classes()), ref.strut_types()
    parts = []
    for x0 in (False, True):
        launched = [(s["launches"], rf.cheb_full_work(
            s["grid"], classes, types, s["degree"], x0))
            for s in got["B5"] if s["with_x0"] == x0]
        parts.append((("mg_cheb_full_kernel",
                       (rf.BF16, "true" if x0 else "false")), launched))
    return rf.share(readings, parts)
