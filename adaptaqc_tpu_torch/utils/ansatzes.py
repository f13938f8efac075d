"""Two-qubit ansatz block library.

Mirrors adapt-aqc's adaptaqc/utils/ansatzes.py (u4, thinly/fully dressed
CNOT, identity_resolvable — the arXiv:2503.09683 ansatz — and heisenberg).
"""

from ..circuits.circuit import Circuit


def u4() -> Circuit:
    """Full U(4) ansatz, Vatan & Williams PRA 69, 032315 (ansatzes.py:14-39)."""
    qc = Circuit(2)
    qc.rz(0, 0).ry(0, 0).rz(0, 0)
    qc.rz(0, 1).ry(0, 1).rz(0, 1)
    qc.cx(1, 0)
    qc.rz(0, 0)
    qc.ry(0, 1)
    qc.cx(0, 1)
    qc.ry(0, 1)
    qc.cx(1, 0)
    qc.rz(0, 0).ry(0, 0).rz(0, 0)
    qc.rz(0, 1).ry(0, 1).rz(0, 1)
    return qc


def thinly_dressed_cnot() -> Circuit:
    qc = Circuit(2)
    qc.rx(0, 0).rx(0, 1)
    qc.cx(0, 1)
    qc.rx(0, 0).rx(0, 1)
    return qc


def fully_dressed_cnot() -> Circuit:
    qc = Circuit(2)
    qc.rz(0, 0).ry(0, 0).rz(0, 0)
    qc.rz(0, 1).ry(0, 1).rz(0, 1)
    qc.cx(0, 1)
    qc.rz(0, 0).ry(0, 0).rz(0, 0)
    qc.rz(0, 1).ry(0, 1).rz(0, 1)
    return qc


def identity_resolvable() -> Circuit:
    """The paper ansatz (arXiv:2503.09683; ansatzes.py:70-80)."""
    qc = Circuit(2)
    qc.rx(0, 0).rx(0, 1)
    qc.cx(0, 1)
    qc.rx(0, 0).rx(0, 1)
    qc.cx(0, 1)
    qc.rx(0, 0).rx(0, 1)
    return qc


def heisenberg() -> Circuit:
    """Two-site XYZ evolution block, arXiv:2301.08609 fig 2 (ansatzes.py:83-100)."""
    qc = Circuit(2)
    qc.rz(0.0, 1)
    qc.cx(1, 0)
    qc.rz(0.0, 0)
    qc.ry(0.0, 1)
    qc.cx(0, 1)
    qc.ry(0.0, 1)
    qc.cx(1, 0)
    qc.rz(0.0, 0)
    return qc
