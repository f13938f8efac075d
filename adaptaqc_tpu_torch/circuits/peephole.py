"""Peephole circuit simplification.

Mirrors adapt-aqc's adaptaqc/utils/circuit_operations/
circuit_operations_optimisation.py: merge >=3 consecutive 1q rotations on a
qubit into an RzRyRz Euler decomposition, drop zero/small-angle rotations,
cancel adjacent identical CX/CZ pairs, iterate to fixpoint.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from . import gates as G
from .circuit import Circuit, Instruction
from .operations import replace_1q_gate

MINIMUM_ROTATION_ANGLE = 1e-3


def find_previous_gate_on_qubit(circuit: Circuit, gate_index: int):
    """(instr, index) of the previous gate sharing a qubit with the gate at
    gate_index (circuit_division.py:19-42)."""
    instr = circuit.data[gate_index]
    qubits = set(instr.qubits)
    for i in range(gate_index - 1, -1, -1):
        if set(circuit.data[i].qubits) & qubits:
            return circuit.data[i], i
    return None, None


def _euler_angles(matrix: np.ndarray) -> Tuple[float, float, float]:
    """ZYZ decomposition: U ~ e^{i phase} Rz(phi) Ry(theta) Rz(lam).
    Returns (theta, phi, lam)."""
    # strip global phase via determinant
    det = np.linalg.det(matrix)
    u = matrix / np.sqrt(det)
    theta = 2 * np.arctan2(abs(u[1, 0]), abs(u[0, 0]))
    phi_plus_lam = 2 * np.angle(u[1, 1])
    phi_minus_lam = 2 * np.angle(u[1, 0])
    phi = (phi_plus_lam + phi_minus_lam) / 2
    lam = (phi_plus_lam - phi_minus_lam) / 2
    return theta, phi, lam


def _instr_matrix(instr: Instruction) -> np.ndarray:
    return G.u1q_np(instr.name, instr.params[0] if instr.params else 0.0)


def remove_unnecessary_gates_from_circuit(circuit: Circuit,
                                          remove_zero_gates=True,
                                          remove_small_gates=False,
                                          gate_range=None) -> None:
    """Iterate 1q merge + 2q cancellation to fixpoint (optimisation.py:31-73).

    Dispatches to the native C++ kernel (native/circkit.cpp) when available
    and the range contains only flat gates; falls back to the Python pass."""
    from ..ops import native
    if native.peephole(circuit, remove_zero_gates, remove_small_gates,
                       gate_range, MINIMUM_ROTATION_ANGLE):
        return
    if gate_range is None:
        gate_range = [0, len(circuit.data)]
    else:
        gate_range = list(gate_range)
    last_len = len(circuit.data)
    i = 0
    while True:
        if i == 0:
            remove_unnecessary_1q_gates_from_circuit(
                circuit, remove_zero_gates, remove_small_gates, tuple(gate_range))
            i = 1
        else:
            remove_unnecessary_2q_gates_from_circuit(circuit, tuple(gate_range))
            i = 0
        new_len = len(circuit.data)
        if new_len != last_len:
            gate_range[1] -= last_len - new_len
            last_len = new_len
        elif i == 0:
            return


def remove_unnecessary_1q_gates_from_circuit(circuit: Circuit,
                                             remove_zero_gates=True,
                                             remove_small_gates=False,
                                             gate_range=None,
                                             min_rotation_angle=MINIMUM_ROTATION_ANGLE
                                             ) -> None:
    """optimisation.py:76-164."""
    if gate_range is None:
        gate_range = (0, len(circuit.data))
    to_remove = []
    dealt_with = []
    for gate_index in range(gate_range[1] - 1, gate_range[0] - 1, -1):
        instr = circuit.data[gate_index]
        if (gate_index in to_remove or gate_index in dealt_with
                or not instr.is_supported_1q_gate()):
            continue
        angle = instr.params[0]
        if (remove_zero_gates and angle == 0) or \
                (remove_small_gates and abs(angle) < min_rotation_angle):
            to_remove.append(gate_index)
            continue
        matrix = _instr_matrix(instr)
        prev_indexes = [gate_index]
        prev, prev_i = find_previous_gate_on_qubit(circuit, gate_index)
        while (prev is not None and prev.is_supported_1q_gate()
               and prev_i >= gate_range[0]):
            p_angle = prev.params[0]
            if (remove_zero_gates and p_angle == 0) or \
                    (remove_small_gates and abs(p_angle) < min_rotation_angle):
                to_remove.append(prev_i)
            else:
                prev_indexes.append(prev_i)
                matrix = matrix @ _instr_matrix(prev)
            prev, prev_i = find_previous_gate_on_qubit(circuit, prev_i)
        if len(prev_indexes) > 3:
            theta, phi, lam = _euler_angles(matrix)
            replace_1q_gate(circuit, prev_indexes[0], "rz", phi)
            replace_1q_gate(circuit, prev_indexes[1], "ry", theta)
            replace_1q_gate(circuit, prev_indexes[2], "rz", lam)
            dealt_with += [prev_indexes[1], prev_indexes[2]]
            to_remove += prev_indexes[3:]
        else:
            dealt_with += prev_indexes
    for index in sorted(to_remove, reverse=True):
        del circuit.data[index]


_CONSOLIDATABLE_2Q = ("cx", "cz", "swap")


def _supported_for_consolidation(instr: Instruction) -> bool:
    if len(instr.qubits) == 1:
        try:
            G.u1q_np(instr.name, instr.params[0] if instr.params else 0.0)
            return True
        except (ValueError, TypeError):
            return False
    return len(instr.qubits) == 2 and instr.name in _CONSOLIDATABLE_2Q


def consolidate_2q_blocks(circuit: Circuit, gate_range=None) -> None:
    """Collect maximal contiguous runs of gates confined to one qubit pair,
    compute each run's 4x4 unitary and resynthesise it via the KAK
    decomposition into at most 3 CX (circuits/kak.py), keeping the rewrite
    only when it reduces the 2q-gate count. The consolidation half of the
    reference's advanced_circuit_transpilation O2 transpile
    (optimisation.py:207-231)."""
    from .kak import circuit_to_matrix_2q, decompose_2q_unitary
    from .circuit import create_1q_gate, create_2q_gate

    if gate_range is None:
        gate_range = (0, len(circuit.data))
    start, end = gate_range

    runs = []  # (start_index, end_index_exclusive, (lo, hi))
    run_start, span = None, set()
    for i in range(start, end):
        instr = circuit.data[i]
        qs = set(instr.qubits)
        if not _supported_for_consolidation(instr):
            if run_start is not None:
                runs.append((run_start, i, span))
            run_start, span = None, set()
            continue
        if run_start is None:
            run_start, span = i, set(qs)
        elif len(span | qs) <= 2:
            span = span | qs
        else:
            runs.append((run_start, i, span))
            run_start, span = i, set(qs)
    if run_start is not None:
        runs.append((run_start, end, span))

    for run_s, run_e, qubits in reversed(runs):
        if len(qubits) != 2:
            continue
        segment = circuit.data[run_s:run_e]
        old_2q = sum(1 for g in segment if len(g.qubits) == 2)
        if old_2q < 2:
            continue  # a rewrite can never beat 0 or 1 CX
        lo, hi = sorted(qubits)
        local = Circuit(2)
        for g in segment:
            mapped = tuple(0 if q == lo else 1 for q in g.qubits)
            local.data.append(Instruction(g.name, mapped, g.params))
        replacement = decompose_2q_unitary(circuit_to_matrix_2q(local))
        new_2q = sum(1 for g in replacement.data if len(g.qubits) == 2)
        if new_2q >= old_2q and not (new_2q == old_2q
                                     and len(replacement.data) < len(segment)):
            continue
        new_instrs = []
        for g in replacement.data:
            qs = tuple(lo if q == 0 else hi for q in g.qubits)
            if len(qs) == 1:
                new_instrs.append(create_1q_gate(g.name, g.params[0], qs[0]))
            else:
                new_instrs.append(create_2q_gate(g.name, *qs))
        circuit.data[run_s:run_e] = new_instrs


def advanced_circuit_transpilation(circuit: Circuit, coupling_map=None,
                                   gate_range=None) -> None:
    """O2-transpile analogue (optimisation.py:207-231): KAK block
    consolidation + peephole to fixpoint. Synthesis only emits CX on pairs
    the input already coupled, so any coupling-map restriction of the input
    is preserved by construction."""
    before = len(circuit.data)
    consolidate_2q_blocks(circuit, gate_range)
    if gate_range is not None:
        # consolidation rewrites in place within the range; shift its end by
        # the net length change
        gate_range = (gate_range[0],
                      gate_range[1] - (before - len(circuit.data)))
    remove_unnecessary_gates_from_circuit(circuit, True, False,
                                          gate_range=gate_range)


def remove_unnecessary_2q_gates_from_circuit(circuit: Circuit,
                                             gate_range=None) -> None:
    """Cancel adjacent identical cx/cy/cz pairs (optimisation.py:167-204)."""
    if gate_range is None:
        gate_range = (0, len(circuit.data))
    to_remove = []
    dealt_with = []
    for gate_index in range(gate_range[1] - 1, gate_range[0] - 1, -1):
        instr = circuit.data[gate_index]
        if instr.name not in ("cx", "cy", "cz"):
            continue
        if gate_index in to_remove or gate_index in dealt_with:
            continue
        prev, prev_i = find_previous_gate_on_qubit(circuit, gate_index)
        if prev is None or prev.name != instr.name:
            continue
        if prev_i < gate_range[0]:
            continue
        if prev_i in to_remove or prev_i in dealt_with:
            continue
        if prev.qubits == instr.qubits:
            to_remove += [gate_index, prev_i]
    for index in sorted(to_remove, reverse=True):
        del circuit.data[index]
