from .checkpoint import atomic_savez, load_lattice, save_lattice
from .reference_pickle import load_reference_pickle

__all__ = ["atomic_savez", "load_lattice", "save_lattice",
           "load_reference_pickle"]
