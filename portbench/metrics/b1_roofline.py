"""Kernel B1 (the float32 class-grid stencil K.u, ``csrc/stencil_matvec.cu``
``stencil_matvec_kernel<float, float, ...>``) against its roofline over
the traced steps: the sum, over its launches, of the least time the card
could take at the launch's grid (``harness/roofline.py``, with the node
classes and strut types counted from the reference's template), over the
kernel's summed device time.  The launches per multigrid level come from
the program's wrappers' counters and must equal the kernel's events in the
trace."""

from portbench.harness import roofline

KERNEL = "stencil_matvec_kernel<float, float"


def read(readings):
    tr = readings.get("trace")
    peak = roofline.peaks(readings["kind"])
    if not tr or not tr.get("launches") or peak is None:
        return None
    secs = count = 0
    for name, (s, c) in tr["by_name"].items():
        if name.startswith(KERNEL):
            secs += s
            count += c
    launches = tr["launches"]["B1"]
    if count == 0 or count != sum(launches):
        return None
    ref = readings["reference"]
    classes, types = len(ref.node_classes()), ref.strut_types()
    bound = sum(k * roofline.bound_s(roofline.stencil_work(g, classes, types),
                                     peak)
                for k, g in zip(launches, tr["launches"]["grids"]))
    return 100.0 * bound / secs
