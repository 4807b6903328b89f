"""Percent of the traced steps' wall time in which no operation ran on
the device (CUDA activity only in the trace)."""


def read(readings):
    tr = readings.get("trace")
    if not tr or tr["busy_s"] <= 0 or tr["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["wall_s"])
