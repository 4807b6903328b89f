"""Milliseconds of one build of the preconditioner's per-design state
(``step.precond_state``), timed by the benchmark around the call with the
device synchronised on both sides; the mean over the window's builds."""


def read(readings):
    spans = readings["refresh_ms"]
    if not spans:
        return None
    return sum(spans) / len(spans)
