"""Host helpers: constants, ansatz blocks, pair gradients, compression,
synthetic targets, Hamiltonians, cost tomography, fixed ansatzes and the
reference's utility functions."""
from . import (ansatzes, constants, entanglement_measures, fixed_ansatz_circuits,
               gate_tomography, hamiltonians)
