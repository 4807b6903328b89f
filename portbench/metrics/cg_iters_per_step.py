"""CG iterations per design step over the window: the solver's count
(``step.last_solve["iterations"]``, ``step.chunked.last_iterations``)."""


def read(readings):
    steps = readings["steps"]
    if not steps:
        return None
    return sum(s["iterations"] for s in steps) / len(steps)
