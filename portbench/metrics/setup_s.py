"""Seconds from the process's start to the end of the warm-up: imports,
the kernels' libraries, the lattice and the step, the cell's first design
steps."""


def read(readings):
    return readings["setup_s"]
