"""Whole-circuit surgery on the gate-list IR.

Re-implements the reference's circuit_operations_full_circuit /
_variational / _basic module surface (adapt-aqc's adaptaqc/utils/
circuit_operations/) for our IR: splicing circuits at arbitrary data
indices with qubit remapping, extracting/replacing inner ranges, inversion,
angle I/O, gate counting, classical-op strip/restore, random generators.
"""

from __future__ import annotations

import random as _random
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .circuit import (Circuit, Instruction, create_1q_gate, create_2q_gate,
                      FIXED_GATE_LABEL, SUPPORTED_1Q_GATES, SUPPORTED_2Q_GATES,
                      unroll_to_basis_gates)
from ..optim.sinusoidal import normalized_angles


def add_to_circuit(original: Circuit, to_add: Circuit, location: Optional[int] = None,
                   qubit_subset=None, clbit_subset=None) -> None:
    """Splice `to_add` into `original` at data index `location`
    (full_circuit.py:175-234). qubit_subset maps to_add's qubit i ->
    original's qubit subset[i] (list) or mapping dict."""
    if location is None:
        location = len(original.data)
    if qubit_subset is None:
        qmap = {i: i for i in range(to_add.num_qubits)}
    elif isinstance(qubit_subset, dict):
        qmap = qubit_subset
    else:
        qmap = {i: q for i, q in enumerate(qubit_subset)}
    if clbit_subset is None:
        cmap = {i: i for i in range(to_add.num_clbits)}
    else:
        cmap = {i: c for i, c in enumerate(clbit_subset)}
    for instr in to_add.data:
        new = instr.copy()
        new.qubits = tuple(qmap[q] for q in instr.qubits)
        new.clbits = tuple(cmap[c] for c in instr.clbits)
        original.data.insert(location, new)
        location += 1


def remove_inner_circuit(circuit: Circuit, gate_range: Tuple[int, int]) -> None:
    for index in list(range(*gate_range))[::-1]:
        del circuit.data[index]


def extract_inner_circuit(circuit: Circuit, gate_range: Tuple[int, int]) -> Circuit:
    inner = Circuit(circuit.num_qubits, circuit.num_clbits)
    for i in range(*gate_range):
        inner.data.append(circuit.data[i].copy())
    return inner


def replace_inner_circuit(circuit: Circuit, replacement: Optional[Circuit],
                          gate_range: Tuple[int, int]) -> None:
    remove_inner_circuit(circuit, gate_range)
    if replacement is not None and len(replacement.data) > 0:
        add_to_circuit(circuit, replacement, gate_range[0])


def find_num_gates(circuit: Optional[Circuit], gate_range=None) -> Tuple[int, int]:
    """(num_2q_gates, num_1q_gates) — full_circuit.py:273-308."""
    if circuit is None:
        return 0, 0
    if gate_range is None:
        gate_range = (0, len(circuit.data))
    n2 = n1 = 0
    for i in range(*gate_range):
        instr = circuit.data[i]
        if instr.name in ("barrier", "set_statevector", "set_mps"):
            continue
        if len(instr.qubits) == 1 and not instr.clbits:
            n1 += 1
        elif len(instr.qubits) == 2 and not instr.clbits:
            n2 += 1
    return n2, n1


def circuit_by_inverting_circuit(circuit: Circuit) -> Circuit:
    return circuit.inverse()


def remove_classical_operations(circuit: Circuit):
    """Strip measure ops, returning [(index, instr)] for restoration
    (full_circuit.py:338-349)."""
    out = []
    for index, instr in list(enumerate(circuit.data))[::-1]:
        if instr.clbits:
            out.append((index, instr))
            del circuit.data[index]
    return out[::-1]


def add_classical_operations(circuit: Circuit, gates_and_locations) -> None:
    for index, instr in gates_and_locations:
        circuit.data.insert(index, instr)


def make_quantum_only_circuit(circuit: Circuit) -> Circuit:
    qc = circuit.copy()
    remove_classical_operations(qc)
    return qc


def find_angles_in_circuit(circuit: Circuit, gate_range=None) -> List[float]:
    """Angles of trainable rotations, in data order (variational.py:22-41)."""
    if gate_range is None:
        gate_range = (0, len(circuit.data))
    angles = []
    for i in range(*gate_range):
        instr = circuit.data[i]
        if instr.is_supported_1q_gate():
            angles.append(normalized_angles(instr.params[0]))
    return angles


def update_angles_in_circuit(circuit: Circuit, angles, gate_range=None) -> None:
    if gate_range is None:
        gate_range = (0, len(circuit.data))
    ai = 0
    for i in range(*gate_range):
        instr = circuit.data[i]
        if instr.is_supported_1q_gate():
            instr.params = (float(angles[ai]),)
            ai += 1
    reevaluate_dependent_parameterised_gates(
        circuit, calculate_independent_variable_values(circuit))


def replace_1q_gate(circuit: Circuit, gate_index: int, gate_name: str,
                    angle: float) -> None:
    """basic.py:70-99, including the '#var' parameterised-gate path."""
    if gate_name is None:
        return
    instr = circuit.data[gate_index]
    if "#" in gate_name:
        base, var = gate_name.split("#")
        new = create_1q_gate(base, angle, instr.qubits[0])
        new.label = f"{base}#{var}"
        circuit.data[gate_index] = new
        reevaluate_dependent_parameterised_gates(
            circuit, calculate_independent_variable_values(circuit))
    elif "@" in gate_name:
        raise ValueError("Cant replace dependent parameterised gate")
    else:
        circuit.data[gate_index] = create_1q_gate(gate_name, angle, instr.qubits[0])


def replace_2q_gate(circuit: Circuit, gate_index: int, control: int, target: int,
                    gate_name: str = "cx") -> None:
    instr = circuit.data[gate_index]
    new = create_2q_gate(gate_name, control, target)
    new.clbits = instr.clbits
    circuit.data[gate_index] = new


def is_supported_1q_gate(instr: Instruction) -> bool:
    return isinstance(instr, Instruction) and instr.is_supported_1q_gate()


def add_gate(circuit: Circuit, gate: Instruction, gate_index=None,
             qubit_indexes=None, clbit_indexes=None) -> None:
    new = gate.copy()
    if qubit_indexes is not None:
        new.qubits = tuple(qubit_indexes)
    if clbit_indexes is not None:
        new.clbits = tuple(clbit_indexes)
    if gate_index is None:
        gate_index = len(circuit.data)
    circuit.data.insert(gate_index, new)


# ------------------------------------------------------- dressed CNOT builder

def _add_appropriate_gates(circuit: Circuit, qubit: int, thinly_dressed: bool,
                           loc: int) -> int:
    circuit.data.insert(loc, create_1q_gate("rz", 0, qubit))
    loc += 1
    if not thinly_dressed:
        circuit.data.insert(loc, create_1q_gate("ry", 0, qubit))
        loc += 1
        circuit.data.insert(loc, create_1q_gate("rz", 0, qubit))
        loc += 1
    return loc


def add_dressed_cnot(circuit: Circuit, control: int, target: int,
                     thinly_dressed: bool = False, gate_index: Optional[int] = None,
                     v1=True, v2=True, v3=True, v4=True) -> None:
    """cx surrounded by rotation blocks (basic.py:148-189)."""
    if gate_index is None:
        gate_index = len(circuit.data)
    if v1:
        gate_index = _add_appropriate_gates(circuit, control, thinly_dressed, gate_index)
    if v2:
        gate_index = _add_appropriate_gates(circuit, target, thinly_dressed, gate_index)
    circuit.data.insert(gate_index, create_2q_gate("cx", control, target))
    gate_index += 1
    if v3:
        gate_index = _add_appropriate_gates(circuit, control, thinly_dressed, gate_index)
    if v4:
        _add_appropriate_gates(circuit, target, thinly_dressed, gate_index)


# -------------------------------------------------- parameterised-gate system

def create_independent_parameterised_gate(gate_type: str, variable_name: str,
                                          angle: float = 0) -> Instruction:
    g = create_1q_gate(gate_type, angle)
    g.label = f"{gate_type}#{variable_name}"
    return g


def create_dependent_parameterised_gate(gate_type: str, equation_string: str,
                                        angle: float = 0) -> Instruction:
    g = create_1q_gate(gate_type, angle)
    g.label = f"{gate_type}@{equation_string}"
    return g


def calculate_independent_variable_values(circuit: Circuit) -> Dict[str, float]:
    values = {}
    for instr in circuit.data:
        if instr.label is not None and "#" in instr.label:
            values[instr.label.split("#")[1]] = instr.params[0]
    return values


def reevaluate_dependent_parameterised_gates(circuit: Circuit, values) -> None:
    if not values:
        has_dep = any(i.label is not None and "@" in i.label for i in circuit.data)
        if not has_dep:
            return
    import sympy
    for i, instr in enumerate(circuit.data):
        if instr.label is not None and "@" in instr.label:
            equation = instr.label.split("@")[1]
            result = sympy.parse_expr(equation, local_dict=dict(values))
            instr.params = (float(result),)


def add_subscript_to_all_variables(circuit: Circuit, subscript_value) -> None:
    """basic.py:244-262."""
    substitution = {}
    for instr in circuit.data:
        if instr.label is not None and "#" in instr.label:
            gate_type, var = instr.label.split("#")
            instr.label = f"{gate_type}#{var}_{subscript_value}"
            substitution[var] = f"{var}_{subscript_value}"
    for instr in circuit.data:
        if instr.label is not None and "@" in instr.label:
            gate_type, equation = instr.label.split("@")
            for old, new in substitution.items():
                equation = equation.replace(old, new)
            instr.label = f"{gate_type}@{equation}"


# ------------------------------------------------------------------ randoms

def random_1q_gate() -> Instruction:
    return create_1q_gate(_random.choice(SUPPORTED_1Q_GATES),
                          _random.uniform(-np.pi, np.pi))


def create_random_circuit(num_qubits: int, depth: int = 5,
                          one_qubit_gates=None, two_qubit_gates=None,
                          seed=None) -> Circuit:
    """full_circuit.py:48-69."""
    qc = Circuit(num_qubits)
    one_qubit_gates = one_qubit_gates or SUPPORTED_1Q_GATES
    two_qubit_gates = two_qubit_gates or SUPPORTED_2Q_GATES
    rs = np.random.RandomState(seed)
    while qc.depth() < depth:
        g = rs.choice(list(one_qubit_gates) + list(two_qubit_gates))
        if g in one_qubit_gates:
            q = int(rs.choice(num_qubits))
            qc.data.append(create_1q_gate(g, rs.uniform(-np.pi, np.pi), q))
        else:
            a, b = (int(x) for x in rs.choice(num_qubits, 2, replace=False))
            qc.data.append(create_2q_gate(g, a, b))
    return qc


def create_random_initial_state_circuit(num_qubits: int,
                                        return_statevector: bool = False,
                                        seed=None):
    """Random Haar state as a target (full_circuit.py:441-459). Our engines
    accept state injection directly, so this produces a set_statevector
    circuit rather than a synthesised gate sequence."""
    rs = np.random.default_rng(seed)
    vec = rs.normal(size=2 ** num_qubits) + 1j * rs.normal(size=2 ** num_qubits)
    vec /= np.linalg.norm(vec)
    qc = Circuit(num_qubits)
    qc.set_statevector(vec)
    if return_statevector:
        return qc, vec
    return qc


def are_circuits_identical(qc1: Circuit, qc2: Circuit, match_labels=False) -> bool:
    if len(qc1.data) != len(qc2.data):
        return False
    for a, b in zip(qc1.data, qc2.data):
        name_a = a.label if a.label is not None else a.name
        name_b = b.label if b.label is not None else b.name
        if name_a != name_b or a.params != b.params or a.qubits != b.qubits \
                or a.clbits != b.clbits:
            return False
        if match_labels and a.label != b.label:
            return False
    return True


def initial_state_to_circuit(initial_state) -> Optional[Circuit]:
    """full_circuit.py:385-410: circuit | vector | None -> Circuit | None."""
    if initial_state is None:
        return None
    if isinstance(initial_state, Circuit):
        return initial_state.copy()
    if isinstance(initial_state, (list, np.ndarray)):
        vec = np.asarray(initial_state)
        num_qubits = int(np.log2(len(vec)))
        qc = Circuit(num_qubits)
        qc.initialize(vec)
        return qc
    raise TypeError("Invalid type of initial_state provided")


def multi_qubit_gate_depth(qc: Circuit) -> int:
    return qc.multi_qubit_gate_depth()


def remove_permutations_from_coupling_map(coupling_map):
    seen = set()
    unique = []
    for pair in coupling_map:
        key = tuple(sorted(pair))
        if key not in seen:
            seen.add(key)
            unique.append(tuple(pair))
    return unique


def find_rotation_indices(qc: Circuit, indices) -> List[int]:
    return [i for i in indices if qc.data[i].name in SUPPORTED_1Q_GATES
            and qc.data[i].is_supported_1q_gate()]
