"""Milliseconds a CG iteration in which the host was blocked on the device
in the traced steps: the program's ``sync`` spans (``pcg``'s convergence
reads) and ``sync.step`` spans (``step.chunked``'s read of the residual,
outside ``pcg``) over the traced steps' CG iterations."""

from portbench.harness import spans


def read(readings, registry=None):
    t = spans.registry(registry)
    if not t.count("sync"):
        return None
    return spans.per_traced(readings, "iterations",
                            1e3 * (t.total("sync") + t.total("sync.step")))
