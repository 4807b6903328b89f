"""Seconds per design step: the window's wall time over the steps it
completed (each counted once its c and g were on the host side of a
synchronise)."""


def read(readings):
    return readings["window_s"] / len(readings["steps"])
