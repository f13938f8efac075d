"""Lightweight gate-list circuit IR.

Replaces qiskit's QuantumCircuit for the needs of ADAPT-AQC: a flat `data`
list of instructions supporting index surgery (insert/delete/replace by
index), rotation labels that mark trainability, inversion that preserves
labels, and compilation to flat device tapes.

Reference semantics being mirrored (file:line in upstream adapt-aqc):
 - `circuit.data` index surgery: adaptaqc/utils/circuit_operations/
   circuit_operations_basic.py:51-120
 - trainability via labels ("rx"/"ry"/"rz"; FIXED_GATE_LABEL excluded;
   "#var" independent / "@expr" dependent parameterised gates):
   circuit_operations_basic.py:123-132, 208-262
 - inversion preserving rotation labels: circuit_operations_full_circuit.py:364-382
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import gates as G

FIXED_GATE_LABEL = "fixed_gate"
SUPPORTED_1Q_GATES = ["rx", "ry", "rz"]
SUPPORTED_2Q_GATES = ["cx", "cz"]
# Gates every engine executes natively (everything else must be lowered).
ENGINE_GATES = set(G.NAME_TO_KIND) - {"nop"}
BASIS_GATES = ["u3", "cx", "cz", "rx", "ry", "rz", "x", "y", "z", "h"]


class Instruction:
    """One circuit operation.

    name:   gate name ('rx', 'cx', 'u3', 'measure', 'barrier',
            'set_statevector', 'set_mps', ...)
    qubits: tuple of qubit indices
    params: tuple of floats (rotation angle(s))
    label:  optimiser metadata; for rotations defaults to the name, which
            marks the gate trainable. FIXED_GATE_LABEL freezes it.
    clbits: classical bits (measure)
    payload: raw state for set_statevector / set_mps instructions
    """

    __slots__ = ("name", "qubits", "params", "label", "clbits", "payload")

    def __init__(self, name, qubits=(), params=(), label=None, clbits=(),
                 payload=None):
        self.name = name
        self.qubits = tuple(int(q) for q in qubits)
        self.params = tuple(float(p) for p in params)
        self.label = label
        self.clbits = tuple(int(c) for c in clbits)
        self.payload = payload

    # -- trainability ----------------------------------------------------
    @property
    def base_label(self) -> Optional[str]:
        """Label with any '#var'/'@expr' parameterisation tag stripped."""
        lbl = self.label if self.label is not None else self.name
        if "#" in lbl:
            return lbl.split("#")[0]
        return lbl

    def is_supported_1q_gate(self) -> bool:
        lbl = self.label if self.label is not None else self.name
        if "@" in lbl:
            return False
        return self.base_label in SUPPORTED_1Q_GATES

    def copy(self) -> "Instruction":
        return Instruction(self.name, self.qubits, self.params, self.label,
                           self.clbits, self.payload)

    def __eq__(self, other):
        if not isinstance(other, Instruction):
            return NotImplemented
        return (self.name == other.name and self.qubits == other.qubits
                and self.params == other.params and self.label == other.label
                and self.clbits == other.clbits)

    def __repr__(self):
        bits = ",".join(map(str, self.qubits))
        ps = ",".join(f"{p:.4g}" for p in self.params)
        lbl = f" label={self.label!r}" if self.label not in (None, self.name) else ""
        return f"{self.name}({ps})[{bits}]{lbl}"


def create_1q_gate(gate_name: str, angle: float, qubit: int = 0) -> Instruction:
    """Labelled trainable rotation (basic.py:20-34)."""
    if gate_name not in SUPPORTED_1Q_GATES:
        raise ValueError(f"Unsupported gate {gate_name}")
    return Instruction(gate_name, (qubit,), (angle,), label=gate_name)


def create_2q_gate(gate_name: str, q0: int = 0, q1: int = 1) -> Instruction:
    if gate_name not in SUPPORTED_2Q_GATES:
        raise ValueError("Unsupported gate")
    return Instruction(gate_name, (q0, q1))


class Circuit:
    """Flat gate-list circuit over `num_qubits` qubits."""

    def __init__(self, num_qubits: int, num_clbits: int = 0, name: str = "circuit"):
        self.num_qubits = int(num_qubits)
        self.num_clbits = int(num_clbits)
        self.name = name
        self.data: List[Instruction] = []

    # ------------------------------------------------------------- builders
    def _append(self, instr: Instruction) -> "Circuit":
        for q in instr.qubits:
            if not (0 <= q < self.num_qubits):
                raise ValueError(f"qubit {q} out of range (n={self.num_qubits})")
        self.data.append(instr)
        return self

    def append(self, instr: Instruction, index: Optional[int] = None):
        if index is None:
            return self._append(instr)
        for q in instr.qubits:
            if not (0 <= q < self.num_qubits):
                raise ValueError(f"qubit {q} out of range (n={self.num_qubits})")
        self.data.insert(index, instr)
        return self

    def _qubits_arg(self, qubits):
        if qubits is None:
            return range(self.num_qubits)
        if isinstance(qubits, (int, np.integer)):
            return [int(qubits)]
        return qubits

    def rx(self, angle, qubits):
        for q in self._qubits_arg(qubits):
            self._append(create_1q_gate("rx", angle, q))
        return self

    def ry(self, angle, qubits):
        for q in self._qubits_arg(qubits):
            self._append(create_1q_gate("ry", angle, q))
        return self

    def rz(self, angle, qubits):
        for q in self._qubits_arg(qubits):
            self._append(create_1q_gate("rz", angle, q))
        return self

    def u3(self, theta, phi, lam, qubit):
        return self._append(Instruction("u3", (qubit,), (theta, phi, lam)))

    def h(self, qubits):
        for q in self._qubits_arg(qubits):
            self._append(Instruction("h", (q,)))
        return self

    def x(self, qubits):
        for q in self._qubits_arg(qubits):
            self._append(Instruction("x", (q,)))
        return self

    def y(self, qubits):
        for q in self._qubits_arg(qubits):
            self._append(Instruction("y", (q,)))
        return self

    def z(self, qubits):
        for q in self._qubits_arg(qubits):
            self._append(Instruction("z", (q,)))
        return self

    def s(self, qubits):
        for q in self._qubits_arg(qubits):
            self._append(Instruction("s", (q,)))
        return self

    def t(self, qubits):
        for q in self._qubits_arg(qubits):
            self._append(Instruction("t", (q,)))
        return self

    def cx(self, control, target):
        return self._append(Instruction("cx", (control, target)))

    def cz(self, q0, q1):
        return self._append(Instruction("cz", (q0, q1)))

    def swap(self, q0, q1):
        return self._append(Instruction("swap", (q0, q1)))

    def ccx(self, c0, c1, target):
        """Toffoli, lowered immediately to the standard basis decomposition."""
        for instr in _ccx_decomposition(c0, c1, target):
            self._append(instr)
        return self

    def measure(self, qubit, clbit):
        self.num_clbits = max(self.num_clbits, int(clbit) + 1)
        return self._append(Instruction("measure", (qubit,), clbits=(clbit,)))

    def barrier(self, *qubits):
        return self._append(Instruction("barrier", qubits or tuple(range(self.num_qubits))))

    def set_statevector(self, statevector):
        sv = np.asarray(statevector)
        if sv.size != 2 ** self.num_qubits:
            raise ValueError("statevector size mismatch")
        return self._append(Instruction("set_statevector", tuple(range(self.num_qubits)),
                                        payload=sv))

    def set_mps(self, mps):
        """mps: an MPS object or a Qiskit-format (gamma, lambda) tuple."""
        return self._append(Instruction("set_mps", tuple(range(self.num_qubits)),
                                        payload=mps))

    def initialize(self, statevector):
        return self.set_statevector(np.asarray(statevector) /
                                    np.linalg.norm(statevector))

    # ------------------------------------------------------------ utilities
    def copy(self) -> "Circuit":
        qc = Circuit(self.num_qubits, self.num_clbits, self.name)
        qc.data = [instr.copy() for instr in self.data]
        return qc

    def __len__(self):
        return len(self.data)

    def __iter__(self):
        return iter(self.data)

    def inverse(self) -> "Circuit":
        """Reference-style inverse preserving rotation labels
        (circuit_operations_full_circuit.py:364-382)."""
        qc = Circuit(self.num_qubits, self.num_clbits, self.name + "_inv")
        for instr in reversed(self.data):
            qc.data.append(invert_instruction(instr))
        return qc

    def count_ops(self):
        counts = {}
        for instr in self.data:
            counts[instr.name] = counts.get(instr.name, 0) + 1
        return counts

    def depth(self, filter_function=None) -> int:
        """Circuit depth over qubits (and clbits), optionally filtered."""
        # clbit count can exceed num_clbits when instructions were spliced in
        # directly (classical strip/restore paths), so size the level table
        # from the data itself
        nc = max([self.num_clbits]
                 + [c + 1 for i in self.data for c in i.clbits])
        levels = [0] * (self.num_qubits + nc)
        depth = 0
        for instr in self.data:
            if instr.name == "barrier":
                continue
            if instr.name in ("set_statevector", "set_mps"):
                continue
            bits = list(instr.qubits) + [self.num_qubits + c for c in instr.clbits]
            level = max(levels[b] for b in bits) if bits else 0
            if filter_function is None or filter_function(instr):
                level += 1
            for b in bits:
                levels[b] = level
            depth = max(depth, level)
        return depth

    def multi_qubit_gate_depth(self) -> int:
        """CNOT depth (utilityfunctions.py:281-288)."""
        return self.depth(filter_function=lambda i: len(i.qubits) > 1)

    def num_2q_gates(self) -> int:
        return sum(1 for i in self.data
                   if len(i.qubits) == 2 and not i.clbits and i.name != "barrier")

    def __repr__(self):
        return (f"Circuit(n={self.num_qubits}, gates={len(self.data)}): "
                + " ".join(repr(i) for i in self.data[:12])
                + (" ..." if len(self.data) > 12 else ""))


def invert_instruction(instr: Instruction) -> Instruction:
    name = instr.name
    if name in ("measure", "barrier"):
        return instr.copy()
    if name in ("set_statevector", "set_mps"):
        raise ValueError(f"Cannot invert {name} instruction")
    if instr.label is not None and instr.base_label in SUPPORTED_1Q_GATES:
        out = instr.copy()
        out.params = tuple(-p for p in out.params)
        return out
    if name in ("rx", "ry", "rz"):
        out = instr.copy()
        out.params = (-instr.params[0],)
        return out
    if name == "u3":
        t, p, l = instr.params
        return Instruction("u3", instr.qubits, (-t, -l, -p), label=instr.label)
    if name in ("cx", "cz", "swap", "h", "x", "y", "z"):
        return instr.copy()
    if name == "s":
        return Instruction("sdg", instr.qubits, label=instr.label)
    if name == "sdg":
        return Instruction("s", instr.qubits, label=instr.label)
    if name == "t":
        return Instruction("tdg", instr.qubits, label=instr.label)
    if name == "tdg":
        return Instruction("t", instr.qubits, label=instr.label)
    raise ValueError(f"Don't know how to invert {name}")


def _ccx_decomposition(c0, c1, t) -> List[Instruction]:
    seq = [
        Instruction("h", (t,)),
        Instruction("cx", (c1, t)),
        Instruction("tdg", (t,)),
        Instruction("cx", (c0, t)),
        Instruction("t", (t,)),
        Instruction("cx", (c1, t)),
        Instruction("tdg", (t,)),
        Instruction("cx", (c0, t)),
        Instruction("t", (c1,)),
        Instruction("t", (t,)),
        Instruction("h", (t,)),
        Instruction("cx", (c0, c1)),
        Instruction("t", (c0,)),
        Instruction("tdg", (c1,)),
        Instruction("cx", (c0, c1)),
    ]
    return seq


# --------------------------------------------------------------------- lowering

def lower_instruction(instr: Instruction) -> List[Instruction]:
    """Lower an instruction to engine-native gates.

    u3(theta,phi,lam) = e^{i(phi+lam)/2} RZ(phi) RY(theta) RZ(lam) — the global
    phase is dropped (all costs are |overlap|^2). Lowered rotations carry
    label=None so they are NOT trainable, matching the reference where
    transpiler-produced u3 gates have no rotation label
    (circuit_operations_basic.py:123-132).
    """
    name = instr.name
    if name in ENGINE_GATES:
        return [instr]
    if name == "u3":
        t, p, l = instr.params
        q = instr.qubits[0]
        out = []
        if l != 0.0:
            out.append(Instruction("rz", (q,), (l,), label="__lowered__"))
        out.append(Instruction("ry", (q,), (t,), label="__lowered__"))
        if p != 0.0:
            out.append(Instruction("rz", (q,), (p,), label="__lowered__"))
        return out
    if name in ("barrier",):
        return []
    raise ValueError(f"Cannot lower instruction {name} for engine execution")


def unroll_to_basis_gates(circuit: Circuit) -> Circuit:
    """Analogue of the reference's transpile-to-BASIS_GATES unroll
    (circuit_operations_full_circuit.py:318-326). Our IR is already flat, so
    this only lowers non-engine gates (u3 -> rz/ry/rz) and strips barriers."""
    qc = Circuit(circuit.num_qubits, circuit.num_clbits, circuit.name)
    for instr in circuit.data:
        if instr.name in ("measure",):
            qc.data.append(instr.copy())
        elif instr.name in ("set_statevector", "set_mps"):
            qc.data.append(instr.copy())
        else:
            qc.data.extend(i.copy() for i in lower_instruction(instr))
    # lowered gates keep label "__lowered__" => not trainable, but base_label
    # must not collide with rx/ry/rz trainability check
    return qc
