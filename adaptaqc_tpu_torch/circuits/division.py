"""Depth-sliced vertical circuit division (for compile_in_parts).

Mirrors adapt-aqc's adaptaqc/utils/circuit_operations/
circuit_operations_circuit_division.py:61-144. Behavioral note verified by
hand-executing the reference's loop (:117-139): although it keeps scanning
past the first depth-overflowing gate, its per-bit level table is updated
UNCONDITIONALLY (even for skipped gates) while the append test is
``max(next_gate_indexes) <= cap`` over ALL bits — so the first overflow
inflates the global max past the cap and no later gate is ever appended to
that block. Block boundaries are therefore exactly "leading gates until the
first overflow", which is what the single-pass depth counter below computes.
Clbit dependencies participate in the depth levels exactly as in the
reference (:76-90 indexes clbits after qubits in one level table).
"""

from __future__ import annotations

from typing import List

from .circuit import Circuit


def calculate_next_gate_indexes(circuit: Circuit, start_index: int,
                                max_depth: int) -> int:
    """Number of leading gates (from start_index) whose depth stays within
    max_depth; depth levels are tracked per qubit AND per clbit."""
    nc = max([circuit.num_clbits]
             + [c + 1 for i in circuit.data for c in i.clbits])
    levels = [0] * (circuit.num_qubits + nc)
    count = 0
    for instr in circuit.data[start_index:]:
        if instr.name == "barrier":
            count += 1
            continue
        bits = (list(instr.qubits)
                + [circuit.num_qubits + c for c in instr.clbits])
        level = max((levels[b] for b in bits), default=0) + 1
        if level > max_depth:
            break
        for b in bits:
            levels[b] = level
        count += 1
    return count


def vertically_divide_circuit(circuit: Circuit, max_depth_per_block: int = 10
                              ) -> List[Circuit]:
    """Split into subcircuits each of depth <= max_depth_per_block
    (circuit_division.py:92-144)."""
    parts: List[Circuit] = []
    index = 0
    total = len(circuit.data)
    while index < total:
        take = calculate_next_gate_indexes(circuit, index, max_depth_per_block)
        if take == 0:
            raise ValueError("gate exceeds max_depth_per_block on its own")
        part = Circuit(circuit.num_qubits, circuit.num_clbits)
        part.data = [circuit.data[i].copy() for i in range(index, index + take)]
        parts.append(part)
        index += take
    return parts
