from .lattice import Lattice, build_lattice
from .tags import tag_points

__all__ = ["Lattice", "build_lattice", "tag_points"]
