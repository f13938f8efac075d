"""Constants and coupling-map generators.

Mirrors adapt-aqc's adaptaqc/utils/constants.py.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# Qiskit-format MPS type alias: ([(G0, G1)] per site, [lambda] per bond)
QiskitMPS = Tuple[List[Tuple[np.ndarray, np.ndarray]], List[np.ndarray]]

ALG_ROTOSOLVE = "rotosolve"
ALG_ROTOSELECT = "rotoselect"
ALG_NLOPT = "nlopt"
ALG_SCIPY = "scipy"
ALG_PYBOBYQA = "pybobyqa"

FIXED_GATE_LABEL = "fixed_gate"

CMAP_FULL = "CMAP_FULL"
CMAP_LINEAR = "CMAP_LINEAR"
CMAP_LADDER = "CMAP_LADDER"

DEFAULT_SUFFICIENT_COST = 1e-2


def generate_coupling_map(num_qubits, map_kind, both_dir=False, loop=False):
    if map_kind == CMAP_FULL:
        return coupling_map_fully_entangled(num_qubits, both_dir)
    elif map_kind == CMAP_LINEAR:
        return coupling_map_linear(num_qubits, both_dir, loop)
    elif map_kind == CMAP_LADDER:
        return coupling_map_ladder(num_qubits, both_dir, loop)
    raise ValueError(f"Invalid coupling map type {map_kind}")


def coupling_map_fully_entangled(num_qubits, both_dir=False):
    """All-to-all pairs, ordered by distance (constants.py:45-60)."""
    c_map = []
    for i in range(1, num_qubits):
        for j in range(num_qubits - i):
            c_map.append((j, j + i))
    if both_dir:
        c_map += [(t, s) for (s, t) in c_map]
    return c_map


def coupling_map_linear(num_qubits, both_dir=False, loop=False):
    c_map = [(j, j + 1) for j in range(num_qubits - 1)]
    if loop:
        c_map.append((num_qubits - 1, 0))
    if both_dir:
        c_map += [(t, s) for (s, t) in c_map]
    return c_map


def coupling_map_ladder(num_qubits, both_dir=False, loop=False):
    c_map = []
    j = 0
    while j + 1 <= num_qubits - 1:
        c_map.append((j, j + 1))
        j += 2
    j = 1
    if loop and num_qubits % 2 == 1:
        c_map.append((num_qubits - 1, 0))
    while j + 1 <= num_qubits - 1:
        c_map.append((j, j + 1))
        j += 2
    if loop and num_qubits % 2 == 0:
        c_map.append((num_qubits - 1, 0))
    if both_dir:
        c_map += [(t, s) for (s, t) in c_map]
    return c_map


def get_initial_layout(circuit):
    """{logical_qubit: physical_qubit} layout of a circuit (reference
    constants.py:122-131). Our IR addresses qubits by integer index, so the
    layout is the identity mapping."""
    return {q: q for q in range(circuit.num_qubits)}


def convert_cmap_to_qiskit_format(c_map):
    return [list(pair) for pair in c_map]
