"""Host milliseconds of the fused V-cycle's kernel launches a CG iteration
in the traced steps: the program's ``mg.fused.b3``, ``mg.fused.b4`` and
``mg.fused.b5`` spans (each one launch's path, from the wrapper's checks to
the launch's return) over the traced steps' CG iterations.  Beside
``vcycle_dispatch_ms_per_cg_iter`` it splits the fused cycle's host time
into the kernels' launch path and the torch work around them.  Where the
cycle replays a CUDA graph (``mg.graph.replay``) the launches leave no
span, and it reads only the eager and capturing applications': 0 when the
traced steps have none.  None on a program with neither span."""

from portbench.harness import spans

SPANS = ("mg.fused.b3", "mg.fused.b4", "mg.fused.b5")


def read(readings, registry=None):
    t = spans.registry(registry)
    if not any(t.count(s) for s in SPANS + ("mg.graph.replay",)):
        return None
    return spans.per_traced(readings, "iterations",
                            1e3 * sum(t.total(s) for s in SPANS))
