"""Simulation layer: joint penalization, boundary-node order and the
simulation entry points (full-lattice, per-cell and unit-cell solves)."""
