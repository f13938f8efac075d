"""Pauli-observable expectation machinery.

Mirror of adapt-aqc's adaptaqc/utils/circuit_operations/
circuit_operations_pauli_ops.py: append basis-change gates for a Pauli
string, evaluate <H> as a weighted sum over Pauli terms. Operators are plain
dicts {pauli_label: coeff} with qiskit label convention (leftmost character =
highest qubit index), as produced by convert_qubit_op_to_pauli_dict.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .circuit import Circuit, Instruction
from . import operations as co


def add_pauli_operators_to_circuit(circuit: Circuit, pauli_label: str,
                                   location=None) -> Tuple[int, int]:
    """Append measurement-basis rotations for the Pauli string
    (pauli_ops.py:32-68). Label convention: pauli_label[-1-q] is qubit q's
    axis. Returns the inserted gate range."""
    if location is None:
        location = len(circuit.data)
    n = circuit.num_qubits
    pauli_circuit = Circuit(n)
    for q in range(n):
        axis = pauli_label[n - 1 - q]
        if axis in ("I", "Z"):
            continue
        if axis == "X":
            pauli_circuit.h(q)
        elif axis == "Y":
            pauli_circuit.data.append(Instruction("sdg", (q,)))
            pauli_circuit.h(q)
        else:
            raise ValueError(f"Unexpected pauli axis {axis}")
    co.add_to_circuit(circuit, pauli_circuit, location)
    length = len(pauli_circuit.data)
    return (location, location + length)


def expectation_value_of_pauli_observable(counts: Dict[str, int],
                                          pauli_label: str) -> float:
    """<P> from counts after basis rotation (utilityfunctions.py:236-259)."""
    observable = 0.0
    num_shots = sum(counts.values())
    n = len(pauli_label)
    relevant = [pauli_label[n - 1 - q] != "I" for q in range(n)]
    for key, value in counts.items():
        bits = [key[n - 1 - q] == "1" for q in range(n)]
        parity = sum(b for b, r in zip(bits, relevant) if r) % 2
        observable += (-1.0 if parity else 1.0) * value
    return observable / num_shots


def expectation_value_of_pauli_operator(circuit: Circuit, operator: dict,
                                        backend, backend_options=None,
                                        execute_kwargs=None) -> float:
    """<H> = sum_P c_P <P> over the state prepared by `circuit`
    (pauli_ops.py:71-103). Exact when the backend supports statevectors."""
    from .running import run_circuit_without_transpilation
    expectation_value = 0.0
    cl_ops = co.remove_classical_operations(circuit)
    for pauli_lbl, coeff in operator.items():
        if pauli_lbl == "I" * len(pauli_lbl):
            expectation_value += coeff
            continue
        gate_range = add_pauli_operators_to_circuit(circuit, pauli_lbl)
        counts = run_circuit_without_transpilation(
            circuit, backend, backend_options, execute_kwargs)
        eval_po = expectation_value_of_pauli_observable(counts, pauli_lbl)
        expectation_value += coeff * eval_po
        co.remove_inner_circuit(circuit, gate_range)
    co.add_classical_operations(circuit, cl_ops)
    return expectation_value


def convert_qubit_op_to_pauli_dict(qubit_op) -> Dict[str, float]:
    """Our QubitOperator dict ({"X0 X1": c}) -> qiskit-label dict
    ({"IXX": c}), mirror of pauli_ops.py:106-127 (the reference converts
    openfermion QubitOperator objects; ours are hamiltonians.py dicts)."""
    n = 0
    for term in qubit_op:
        for part in (term.split() if term else []):
            n = max(n, int(part[1:]) + 1)
    n = max(n, 1)
    out = {}
    for term, coeff in qubit_op.items():
        if not np.isreal(coeff):
            raise ValueError("Complex coefficients unsupported")
        label = ["I"] * n
        for part in (term.split() if term else []):
            label[int(part[1:])] = part[0]
        out["".join(label[::-1])] = float(np.real(coeff))
    return out
