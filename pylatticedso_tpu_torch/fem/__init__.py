"""Linear solvers, boundary conditions, the unstructured beam operator,
beam subdivision, full-lattice statics and unit-cell homogenization."""

from .elements import (EdgeGeometry, SectionStiffness, edge_geometry,
                       element_stiffness_dense, section_stiffness, KAPPA)
from .operator import BeamOperator, assemble_dense, build_operator, masked_operator
from .solve import linear_solve, pcg, PCGResult
from .bc import BCArrays, apply_boundary_conditions
from .subdivide import subdivide_edges, segment_counts
from .statics import FEMResult, StaticProblem, make_problem, solve_fem

__all__ = [
    "EdgeGeometry", "SectionStiffness", "edge_geometry",
    "element_stiffness_dense", "section_stiffness", "KAPPA",
    "BeamOperator", "assemble_dense", "build_operator", "masked_operator",
    "linear_solve", "pcg", "PCGResult",
    "BCArrays", "apply_boundary_conditions",
    "subdivide_edges", "segment_counts",
    "FEMResult", "StaticProblem", "make_problem", "solve_fem",
]
