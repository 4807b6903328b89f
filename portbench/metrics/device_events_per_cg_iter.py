"""Device operations (kernels, copies, fills) in the traced steps over
their CG iterations: the launches the host dispatches per iteration."""


def read(readings):
    tr = readings.get("trace")
    if not tr or not tr["iterations"] or not tr["events"]:
        return None
    return tr["events"] / tr["iterations"]
