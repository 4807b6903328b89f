"""Milliseconds in which an operation ran on the device, over the traced
steps' CG iterations."""


def read(readings):
    tr = readings.get("trace")
    if not tr or not tr["iterations"] or tr["busy_s"] <= 0:
        return None
    return 1e3 * tr["busy_s"] / tr["iterations"]
