"""Linear solvers, boundary conditions and the unstructured beam operator."""
