"""Model Hamiltonians as Pauli-term dictionaries + exact ground states.

The port's copy of the JAX package's `utils/hamiltonians.py` (NumPy only),
which follows the reference's hamiltonians.py without its openfermion
dependency: a qubit Hamiltonian is a dict
{pauli_string: coeff} with pauli_string like "X0 X1" ("" = identity), and the
Jordan-Wigner transform for the Anderson model is implemented directly.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

PAULIS = {
    "I": np.eye(2, dtype=complex),
    "X": np.array([[0, 1], [1, 0]], dtype=complex),
    "Y": np.array([[0, -1j], [1j, 0]]),
    "Z": np.array([[1, 0], [0, -1]], dtype=complex),
}

QubitOperator = Dict[str, complex]


def _add(ham: QubitOperator, term: str, coeff) -> None:
    if abs(coeff) == 0:
        return
    key = _normalise_term(term)
    ham[key] = ham.get(key, 0) + coeff
    if abs(ham[key]) < 1e-14:
        del ham[key]


def _normalise_term(term: str) -> str:
    if not term.strip():
        return ""
    parts = sorted(term.split(), key=lambda p: int(p[1:]))
    return " ".join(parts)


def heisenberg_hamiltonian(n=4, jx=1.0, jy=0.0, jz=0.0, hx=0.0, hy=0.0,
                           hz=0.0, periodic_bc=False) -> QubitOperator:
    """H = -sum_nn(jx XX + jy YY + jz ZZ) - sum(hx X + hy Y + hz Z)
    (hamiltonians.py:21-39)."""
    ham: QubitOperator = {}
    max_index = n if periodic_bc else n - 1
    for i in range(max_index):
        j = 0 if (i == n - 1 and periodic_bc) else i + 1
        _add(ham, f"X{i} X{j}", -jx)
        _add(ham, f"Y{i} Y{j}", -jy)
        _add(ham, f"Z{i} Z{j}", -jz)
    for i in range(n):
        _add(ham, f"X{i}", -hx)
        _add(ham, f"Y{i}", -hy)
        _add(ham, f"Z{i}", -hz)
    return ham


def _jw_ladder(i: int, dagger: bool, n: int) -> Dict[str, complex]:
    """Jordan-Wigner a_i^(dagger) as a Pauli-term dict over n qubits."""
    z_string = " ".join(f"Z{k}" for k in range(i))
    sign = -1j if dagger else 1j
    terms: Dict[str, complex] = {}
    for op, coeff in (("X", 0.5), ("Y", sign * 0.5)):
        term = (z_string + f" {op}{i}").strip()
        terms[_normalise_term(term)] = coeff
    return terms


def _pauli_mul(t1: str, c1, t2: str, c2) -> Tuple[str, complex]:
    """Multiply two Pauli strings."""
    rules = {
        ("X", "Y"): ("Z", 1j), ("Y", "X"): ("Z", -1j),
        ("Y", "Z"): ("X", 1j), ("Z", "Y"): ("X", -1j),
        ("Z", "X"): ("Y", 1j), ("X", "Z"): ("Y", -1j),
    }
    ops: Dict[int, str] = {}
    coeff = c1 * c2
    for part in (t1.split() if t1 else []):
        ops[int(part[1:])] = part[0]
    for part in (t2.split() if t2 else []):
        q = int(part[1:])
        p2 = part[0]
        if q not in ops:
            ops[q] = p2
            continue
        p1 = ops.pop(q)
        if p1 == p2:
            continue  # identity
        p3, phase = rules[(p1, p2)]
        ops[q] = p3
        coeff *= phase
    term = " ".join(f"{p}{q}" for q, p in sorted(ops.items()))
    return term, coeff


def _op_mul(a: Dict[str, complex], b: Dict[str, complex]) -> Dict[str, complex]:
    out: Dict[str, complex] = {}
    for t1, c1 in a.items():
        for t2, c2 in b.items():
            t, c = _pauli_mul(t1, c1, t2, c2)
            _add(out, t, c)
    return out


def anderson_model_qubit_hamiltonian(v_i=np.array([0, 1]),
                                     epsilon_i=np.array([2, 2]), u=4, mu=0
                                     ) -> QubitOperator:
    """Jordan-Wigner of the single-impurity Anderson model
    (hamiltonians.py:42-77)."""
    if len(v_i) != len(epsilon_i):
        raise ValueError(
            f"Number of elements in v_i ({len(v_i)}) must equal number of "
            f"elements in epsilon_i({len(epsilon_i)})")
    num_bath = len(v_i) - 1
    ham: QubitOperator = {}
    n_modes = 2 * (1 + num_bath)

    def number_op(i):
        return _op_mul(_jw_ladder(i, True, n_modes), _jw_ladder(i, False, n_modes))

    # Coulomb repulsion n_0 n_{L+1}
    for t, c in _op_mul(number_op(0), number_op(num_bath + 1)).items():
        _add(ham, t, float(u) * c)
    # Site energies
    for site in range(1 + num_bath):
        for spin in range(2):
            i = site + spin * (1 + num_bath)
            for t, c in number_op(i).items():
                _add(ham, t, float(epsilon_i[site] - mu) * c)
    # Hybridisation
    for site in range(1, 1 + num_bath):
        for spin in range(2):
            i = site + spin * (1 + num_bath)
            imp = spin * (1 + num_bath)
            for t, c in _op_mul(_jw_ladder(imp, True, n_modes),
                                _jw_ladder(i, False, n_modes)).items():
                _add(ham, t, float(v_i[site]) * c)
            for t, c in _op_mul(_jw_ladder(i, True, n_modes),
                                _jw_ladder(imp, False, n_modes)).items():
                _add(ham, t, float(v_i[site]) * c)
    # drop residual imaginary parts from hermitian combinations
    return {t: c for t, c in ham.items() if abs(c) > 1e-12}


def hamiltonian_matrix(ham: QubitOperator, n: int) -> np.ndarray:
    """Dense 2^n matrix (little-endian: qubit 0 = LSB)."""
    dim = 2 ** n
    out = np.zeros((dim, dim), dtype=complex)
    for term, coeff in ham.items():
        ops = ["I"] * n
        for part in (term.split() if term else []):
            ops[int(part[1:])] = part[0]
        m = np.array([[1]], dtype=complex)
        for q in range(n):  # little-endian: qubit 0 is the innermost factor
            m = np.kron(PAULIS[ops[q]], m)
        out += coeff * m
    return out


def calculate_ground_state(ham: QubitOperator, n=None):
    """(energy, wavefunction) of the dense Hamiltonian
    (hamiltonians.py:80-85)."""
    if n is None:
        n = 1 + max((int(p[1:]) for t in ham if t for p in t.split()), default=0)
    m = hamiltonian_matrix(ham, n)
    w, v = np.linalg.eigh(m)
    return w[0], v[:, 0]
