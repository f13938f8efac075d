"""Self-contained OpenQASM 2.0 export/import for the gate-list IR.

Replaces the reference's qiskit.qasm2 dependency (adapt_compiler.py:361-365,
473) so AdaptResult.circuit_qasm and circuit history snapshots keep working
without qiskit at runtime.
"""

from __future__ import annotations

import re

from .circuit import Circuit, Instruction, create_1q_gate

_QASM_GATES = {"rx", "ry", "rz", "cx", "cz", "h", "x", "y", "z", "s", "sdg",
               "t", "tdg", "swap", "u3"}


def dumps(circuit: Circuit) -> str:
    lines = ['OPENQASM 2.0;', 'include "qelib1.inc";',
             f'qreg q[{circuit.num_qubits}];']
    if circuit.num_clbits:
        lines.append(f'creg c[{circuit.num_clbits}];')
    for instr in circuit.data:
        name = instr.name
        if name == "barrier":
            qs = ",".join(f"q[{q}]" for q in instr.qubits)
            lines.append(f"barrier {qs};")
            continue
        if name == "measure":
            lines.append(f"measure q[{instr.qubits[0]}] -> c[{instr.clbits[0]}];")
            continue
        if name in ("set_statevector", "set_mps"):
            lines.append(f"// <{name} instruction omitted>")
            continue
        if name not in _QASM_GATES:
            raise ValueError(f"cannot serialise {name} to QASM2")
        params = ""
        if instr.params:
            params = "(" + ",".join(repr(float(p)) for p in instr.params) + ")"
        qs = ",".join(f"q[{q}]" for q in instr.qubits)
        lines.append(f"{name}{params} {qs};")
    return "\n".join(lines) + "\n"


_LINE_RE = re.compile(
    r"^\s*(?P<name>[a-z][a-z0-9_]*)\s*(\((?P<params>[^)]*)\))?\s+(?P<args>[^;]+);")

_PI = 3.141592653589793


def _emit(qc: Circuit, name: str, params, qubits):
    """Append one parsed gate, lowering foreign qelib1 gates onto the IR.

    Covers the gate set reference-exported circuits actually use
    (qiskit.qasm2 dumps over qelib1: u/u1/u2/u3/p, named 1q gates, cx/cz/
    swap, rzz/cp/cu1/crz/cy/ch, ccx) so circuits produced by the reference
    can be ingested as compilation targets (adapt_compiler.py:361-365).
    Decompositions follow qelib1.inc; engines drop global phase (as the u3
    lowering in circuit.py:341-351 already does), which cannot affect any
    cost/overlap/probability this framework computes on a flat gate list.
    """
    if name == "barrier":
        qc.barrier(*qubits)
    elif name in ("rx", "ry", "rz"):
        qc.data.append(create_1q_gate(name, params[0], qubits[0]))
    elif name in ("u", "u3"):
        qc.data.append(Instruction("u3", qubits, params))
    elif name == "u2":
        qc.data.append(Instruction("u3", qubits, (_PI / 2, params[0], params[1])))
    elif name in ("u1", "p"):
        qc.data.append(Instruction("u3", qubits, (0.0, 0.0, params[0])))
    elif name == "id":
        pass
    elif name == "sx":  # = e^{i pi/4} RX(pi/2)
        qc.data.append(Instruction("u3", qubits, (_PI / 2, -_PI / 2, _PI / 2)))
    elif name == "sxdg":
        qc.data.append(Instruction("u3", qubits, (-_PI / 2, -_PI / 2, _PI / 2)))
    elif name == "rzz":  # qelib1: cx; u1(theta) b; cx
        a, b = qubits
        qc.cx(a, b)
        _emit(qc, "u1", params, (b,))
        qc.cx(a, b)
    elif name in ("cp", "cu1"):  # qelib1: u1(l/2) a; cx; u1(-l/2) b; cx; u1(l/2) b
        a, b = qubits
        lam = params[0]
        _emit(qc, "u1", (lam / 2,), (a,))
        qc.cx(a, b)
        _emit(qc, "u1", (-lam / 2,), (b,))
        qc.cx(a, b)
        _emit(qc, "u1", (lam / 2,), (b,))
    elif name == "crz":  # qelib1: u1(l/2) b; cx; u1(-l/2) b; cx
        a, b = qubits
        lam = params[0]
        _emit(qc, "u1", (lam / 2,), (b,))
        qc.cx(a, b)
        _emit(qc, "u1", (-lam / 2,), (b,))
        qc.cx(a, b)
    elif name == "cy":  # qelib1: sdg b; cx; s b  (Y = S X Sdg)
        a, b = qubits
        qc.data.append(Instruction("sdg", (b,)))
        qc.cx(a, b)
        qc.s(b)
    elif name == "ch":  # H = RY(pi/4) Z RY(-pi/4) exactly, so (circuit order,
        a, b = qubits    # leftmost applied first) CH = RY(-pi/4); CZ; RY(pi/4)
        qc.ry(-_PI / 4, b)
        qc.cz(a, b)
        qc.ry(_PI / 4, b)
    elif name == "ccx":
        qc.ccx(*qubits)
    elif name in _QASM_GATES:
        qc.data.append(Instruction(name, qubits, params))
    else:
        raise ValueError(f"unsupported QASM gate {name!r}")


def loads(text: str) -> Circuit:
    """QASM2 parser covering dumps() output plus the reference's exported
    qelib1 gate set (see _emit). Supports multiple qreg/creg declarations
    (bits are concatenated in declaration order, as qiskit.qasm2 does)."""
    qregs: dict = {}
    cregs: dict = {}
    num_qubits = num_clbits = 0
    body = []
    for raw in text.splitlines():
        line = raw.split("//")[0].strip()
        if not line or line.startswith(("OPENQASM", "include")):
            continue
        m = re.match(r"qreg\s+(\w+)\[(\d+)\]", line)
        if m:
            qregs[m.group(1)] = num_qubits
            num_qubits += int(m.group(2))
            continue
        m = re.match(r"creg\s+(\w+)\[(\d+)\]", line)
        if m:
            cregs[m.group(1)] = num_clbits
            num_clbits += int(m.group(2))
            continue
        if line.startswith("gate "):
            raise ValueError("custom gate definitions are not supported")
        body.append(line)
    qc = Circuit(num_qubits, num_clbits)

    def _bit(reg: str, idx: str, table, kind: str) -> int:
        if reg not in table:
            raise ValueError(f"unknown {kind} register {reg!r}")
        return table[reg] + int(idx)

    for line in body:
        m = re.match(r"measure\s+(\w+)\[(\d+)\]\s*->\s*(\w+)\[(\d+)\]\s*;", line)
        if m:
            qc.measure(_bit(m.group(1), m.group(2), qregs, "quantum"),
                       _bit(m.group(3), m.group(4), cregs, "classical"))
            continue
        m = _LINE_RE.match(line)
        if not m:
            raise ValueError(f"cannot parse QASM line: {line}")
        name = m.group("name")
        params = tuple(float(eval(p, {"pi": _PI}))  # noqa: S307
                       for p in (m.group("params") or "").split(",") if p.strip())
        qubits = tuple(_bit(r, i, qregs, "quantum")
                       for r, i in re.findall(r"(\w+)\[(\d+)\]", m.group("args")))
        _emit(qc, name, params, qubits)
    return qc
