"""Fixed (non-adaptive) ansatz factories.

The port's copy of the JAX package's `utils/fixed_ansatz_circuits.py`,
after the reference's fixed_ansatz_circuits.py (`Circuit` code only).
"""

from __future__ import annotations

from ..circuits import operations as co
from ..circuits.circuit import Circuit, create_1q_gate, create_2q_gate
from . import constants as vconstants


def hardware_efficient_circuit(num_qubits, ansatz_kind, ansatz_depth,
                               entangling_gate="cx", coupling_map=None,
                               gates_to_fix=None, gates_to_remove=None) -> Circuit:
    """Rotation layers + entangling layers (fixed_ansatz_circuits.py:18-84).
    gates_to_fix = {rotation_index: angle} freezes gates with
    FIXED_GATE_LABEL; gates_to_remove drops them. Indices follow the order
    rotation gates are added."""
    qc = Circuit(num_qubits)
    if coupling_map is None:
        coupling_map = vconstants.coupling_map_linear(num_qubits)
    gates_to_remove = gates_to_remove or []
    gates_to_fix = gates_to_fix or {}

    index = 0
    rotation_names = [ansatz_kind[i:i + 2] for i in range(0, len(ansatz_kind), 2)]
    for _ in range(ansatz_depth):
        for qubit in range(num_qubits):
            for gate_name in rotation_names:
                gate = create_1q_gate(gate_name, 0, qubit)
                if index in gates_to_fix:
                    gate.label = vconstants.FIXED_GATE_LABEL
                    gate.params = (float(gates_to_fix[index]),)
                if index not in gates_to_remove:
                    qc.data.append(gate)
                index += 1
        for control, target in coupling_map:
            qc.data.append(create_2q_gate(entangling_gate, control, target))
    return qc


def number_preserving_ansatz(num_qubits, ansatz_depth) -> Circuit:
    """Particle-number-preserving blocks using dependent parameterised gates
    (fixed_ansatz_circuits.py:87-113)."""
    coupling_map = vconstants.coupling_map_ladder(num_qubits)
    qc = Circuit(num_qubits)
    index = 0
    for _ in range(ansatz_depth):
        for control, target in coupling_map:
            rz_gate = co.create_independent_parameterised_gate("rz", f"theta_{index}")
            minus_rz = co.create_dependent_parameterised_gate("rz", f"-theta_{index}")
            ry_gate = co.create_independent_parameterised_gate("ry", f"phi_{index}")
            minus_ry = co.create_dependent_parameterised_gate("ry", f"-phi_{index}")
            qc.cx(control, target)
            co.add_gate(qc, minus_rz, qubit_indexes=[control])
            co.add_gate(qc, minus_ry, qubit_indexes=[control])
            qc.cx(target, control)
            co.add_gate(qc, ry_gate, qubit_indexes=[control])
            co.add_gate(qc, rz_gate, qubit_indexes=[control])
            qc.cx(control, target)
            index += 1
    return qc


def custom_ansatz(num_qubits, two_qubit_circuit: Circuit, ansatz_depth,
                  coupling_map=None) -> Circuit:
    """fixed_ansatz_circuits.py:116-126."""
    if coupling_map is None:
        coupling_map = vconstants.coupling_map_ladder(num_qubits)
    qc = Circuit(num_qubits)
    for _ in range(ansatz_depth):
        for control, target in coupling_map:
            co.add_to_circuit(qc, two_qubit_circuit.copy(),
                              qubit_subset=[control, target])
    return qc
