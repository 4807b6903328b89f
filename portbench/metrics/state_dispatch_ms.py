"""Host milliseconds of one build of the preconditioner's per-design
state in the traced steps: the program's ``mg.state`` spans over their
count.  Beside ``refresh_ms`` (the same build timed from outside, the
device synchronised on both sides) it splits the build into the host's
time and the device's."""

from portbench.harness import spans


def read(readings, registry=None):
    t = spans.registry(registry)
    n = t.count("mg.state")
    if not n or not readings.get("trace"):
        return None
    return 1e3 * t.total("mg.state") / n
