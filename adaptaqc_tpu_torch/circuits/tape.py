"""Compile a circuit range into flat host arrays (a "tape").

Instead of mutating a gate object list and re-simulating it from scratch
per cost query (adapt-aqc's adaptaqc/compilers/approximate_compiler.py:
514-527), gates become data — int/float arrays — that the engines walk.
Tape lengths are padded to fixed buckets (BUCKETS), so a later capture of
a sweep as a CUDA graph can key on the bucket.

Tape invariants:
 - q0 < q1 for 2-qubit gates (MPS engine relies on it). A cx with control >
   target is encoded as kind CXR.
 - 1-qubit gates use q0; q1 is a distinct dummy partner.
 - NOP entries pad to the bucket length.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

from . import gates as G
from .circuit import Circuit, FIXED_GATE_LABEL, Instruction, lower_instruction

# CX with control q1 / target q0 (q0 < q1). Extends the kind table.
CXR = G.N_KINDS  # 15
_CXR_MAT = np.eye(4, dtype=complex)
_CXR_MAT[[2, 3]] = _CXR_MAT[[3, 2]]  # flips b(q0) when b(q1)=1

U4_TABLE = np.concatenate([G.FIXED_U4_TABLE, _CXR_MAT[None]], axis=0)
N_KINDS = CXR + 1

BUCKETS = [8, 16, 32, 64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048,
           3072, 4096, 6144, 8192, 12288, 16384, 24576, 32768]


def bucket_length(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"tape too long: {n}")


class Tape(NamedTuple):
    """Flat arrays describing a gate sequence. Padded length = len(kinds)."""
    kinds: np.ndarray      # int32[G]
    q0: np.ndarray         # int32[G]
    q1: np.ndarray         # int32[G]
    angles: np.ndarray     # float64[G]
    trainable: np.ndarray  # bool[G]
    length: int            # actual number of entries before padding
    # data_index_map[i] = (offset, count): tape entries produced by circuit
    # data index i (relative to the compiled range)
    data_index_map: Tuple[Tuple[int, int], ...]

    @property
    def padded_length(self):
        return len(self.kinds)


def _instr_to_entries(instr: Instruction, num_qubits: int):
    """Yield (kind, q0, q1, angle, trainable) tuples for one instruction."""
    out = []
    for low in lower_instruction(instr):
        name = low.name
        if name in ("set_statevector", "set_mps"):
            raise ValueError("state-injection instructions cannot appear in a tape")
        if name == "measure":
            continue  # cost engines are statevector/MPS; sampling handles shots
        kind = G.NAME_TO_KIND[name]
        if len(low.qubits) == 2:
            a, b = low.qubits
            if a == b:
                raise ValueError("2q gate with identical qubits")
            if kind == G.CX and a > b:
                kind, a, b = CXR, b, a
            elif a > b:
                a, b = b, a  # cz / swap are symmetric
            out.append((kind, a, b, 0.0, False))
        else:
            q = low.qubits[0]
            dummy = (q + 1) % num_qubits if num_qubits > 1 else 0
            angle = low.params[0] if low.params else 0.0
            trainable = low.is_supported_1q_gate() and low.base_label != FIXED_GATE_LABEL
            out.append((kind, q, dummy, angle, trainable))
    return out


def compile_tape(circuit: Circuit, gate_range: Optional[Tuple[int, int]] = None,
                 pad: bool = True) -> Tape:
    """Compile circuit.data[gate_range] into a Tape."""
    if gate_range is None:
        gate_range = (0, len(circuit.data))
    entries = []
    index_map = []
    for i in range(*gate_range):
        instr = circuit.data[i]
        es = _instr_to_entries(instr, circuit.num_qubits)
        index_map.append((len(entries), len(es)))
        entries.extend(es)
    length = len(entries)
    padded = bucket_length(max(length, 1)) if pad else max(length, 1)
    while len(entries) < padded:
        entries.append((G.NOP, 0, 1 % max(circuit.num_qubits, 1), 0.0, False))
    arr = np.array([(k, a, b) for (k, a, b, _, _) in entries], dtype=np.int32)
    kinds, q0, q1 = arr[:, 0], arr[:, 1], arr[:, 2]
    angles = np.array([e[3] for e in entries], dtype=np.float64)
    trainable = np.array([e[4] for e in entries], dtype=bool)
    return Tape(kinds, q0, q1, angles, trainable, length, tuple(index_map))


def select_mask(tape: Tape, data_indices: Sequence[int]) -> np.ndarray:
    """Boolean mask over tape entries for the given circuit-data indices
    (relative to the compiled range)."""
    mask = np.zeros(tape.padded_length, dtype=bool)
    for i in data_indices:
        off, cnt = tape.data_index_map[i]
        mask[off:off + cnt] = True
    return mask & tape.trainable


def writeback_angles(circuit: Circuit, gate_range: Tuple[int, int], tape: Tape,
                     new_kinds: np.ndarray, new_angles: np.ndarray) -> None:
    """Write optimised kinds/angles back into the host circuit.

    Only 1:1 instruction↔entry mappings can change (rotations); lowered
    multi-entry gates (u3) are never trainable so are never written back.
    """
    for local_i, (off, cnt) in enumerate(tape.data_index_map):
        if cnt != 1 or not tape.trainable[off]:
            continue
        instr = circuit.data[gate_range[0] + local_i]
        k = int(new_kinds[off])
        if k not in G.KIND_TO_AXIS:
            continue
        new_name = G.KIND_TO_AXIS[k]
        old_label = instr.label
        if old_label is not None and "#" in old_label:
            # preserve parameterisation tag with possibly new axis
            tag = old_label.split("#", 1)[1]
            label = f"{new_name}#{tag}"
        else:
            label = new_name
        circuit.data[gate_range[0] + local_i] = Instruction(
            new_name, instr.qubits, (float(new_angles[off]),), label=label,
            clbits=instr.clbits)
