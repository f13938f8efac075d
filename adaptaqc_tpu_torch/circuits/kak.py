"""KAK (Cartan) decomposition and 3-CX resynthesis of two-qubit blocks.

The reference's `advanced_circuit_transpilation` delegates to qiskit's O2
transpiler, whose main power is Collect2qBlocks + ConsolidateBlocks +
2q-unitary resynthesis (adapt-aqc's adaptaqc/utils/circuit_operations/
circuit_operations_optimisation.py:207-231). This module provides the
self-contained equivalent: any 4x4 unitary decomposes as

    U = phase * (l1 (x) l0) * N(a, b, c) * (r1 (x) r0),
    N(a, b, c) = exp(i (a XX + b YY + c ZZ)),

via the magic-basis construction (Kraus & Cirac, PhysRevA.63.062309), and
the canonical interaction N synthesises into EXACTLY 3 CX + 3 rotations:

    N(a,b,c) = (G1 (x) G0) CX10 [Ry(2b+pi/2) (x) Rz(2a+pi/2)] CX01
               [Ry(2c+pi/2) (x) I] CX10 (H1 (x) H0)

(Vatan & Williams, PhysRevA.69.032315 — template with fixed Clifford-like
corner locals; the constants below were derived exactly by conjugating the
template's tangent generators onto (XX, YY, ZZ) in the magic basis and are
verified to machine precision in tests/test_kak.py). Matrices use the
little-endian convention r = 2*b(q1) + b(q0), i.e. kron(U_q1, U_q0).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .circuit import Circuit

# magic basis: columns are the Bell-like states in which SU(2)x(SU(2) acts
# as SO(4) and N(a,b,c) is diagonal
_B = (1 / np.sqrt(2)) * np.array([
    [1, 0, 0, 1j],
    [0, 1j, 1, 0],
    [0, 1j, -1, 0],
    [1, 0, 0, -1j]])

# theta_j = _THETA_MAP @ (a, b, c): diagonal phases of N in the magic basis
_THETA_MAP = np.array([[1, -1, 1],
                       [1, 1, -1],
                       [-1, -1, -1],
                       [-1, 1, 1]], dtype=float)

_X = np.array([[0, 1], [1, 0]], dtype=complex)
_Y = np.array([[0, -1j], [1j, 0]])
_Z = np.diag([1.0, -1.0]).astype(complex)

# fixed corner locals of the 3-CX canonical template (exact closed forms)
_G1 = 0.5 * np.array([[-1 - 1j, 1 - 1j],
                      [-1 - 1j, -1 + 1j]])
_G0 = (1 / np.sqrt(2)) * np.array([[-1, -1], [1, -1]], dtype=complex)
_H1 = (1j / np.sqrt(2)) * np.array([[1, -1], [1, 1]], dtype=complex)
_H0 = (1 / np.sqrt(2)) * np.array([[-1, -1], [1j, -1j]])


def _rz(t):
    return np.diag([np.exp(-0.5j * t), np.exp(0.5j * t)])


def _ry(t):
    c, s = np.cos(t / 2), np.sin(t / 2)
    return np.array([[c, -s], [s, c]], dtype=complex)


def canonical_gate(a, b, c) -> np.ndarray:
    """N(a, b, c) = exp(i (a XX + b YY + c ZZ)) as a dense 4x4."""
    xx, yy, zz = (np.kron(p, p) for p in (_X, _Y, _Z))
    h = a * xx + b * yy + c * zz
    w, v = np.linalg.eigh(h)
    return (v * np.exp(1j * w)[None, :]) @ v.conj().T


def _split_local(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """w == kron(w1, w0) -> (w1, w0) (operator-Schmidt rank-1 split)."""
    t = w.reshape(2, 2, 2, 2).transpose(0, 2, 1, 3).reshape(4, 4)
    u, s, vh = np.linalg.svd(t)
    if s[1] > 1e-8:
        raise ValueError("matrix is not a tensor product of single-qubit ops")
    return (u[:, 0].reshape(2, 2) * np.sqrt(s[0]),
            vh[0].reshape(2, 2) * np.sqrt(s[0]))


def kak_decompose(u: np.ndarray):
    """4x4 unitary -> (phase, l1, l0, (a, b, c), r1, r0) with
    u = phase * kron(l1, l0) @ canonical_gate(a, b, c) @ kron(r1, r0).

    Magic-basis algorithm: V = B^H (u/det^{1/4}) B is SU(4); M = V^T V is
    unitary symmetric, so its real and imaginary parts commute and share a
    real orthogonal eigenbasis P with eigenvalues e^{2 i theta_j}. Then
    K1 = V P e^{-i Theta} is real orthogonal too, and real orthogonal
    matrices in the magic basis are exactly the local unitaries."""
    u = np.asarray(u, dtype=complex)
    phase0 = np.linalg.det(u) ** 0.25
    v = _B.conj().T @ (u / phase0) @ _B
    m = v.T @ v

    # simultaneous diagonalisation of (Re m, Im m): a generic real mix is
    # symmetric with the same eigenvectors; retry mixes if degeneracies of
    # the mix (not of m) produce a non-diagonalising basis
    rng = np.random.default_rng(41)
    p = None
    for _ in range(32):
        t = rng.uniform(0, 2 * np.pi)
        h = m.real * np.cos(t) + m.imag * np.sin(t)
        _, cand = np.linalg.eigh(h)
        d = cand.T @ m @ cand
        if np.abs(d - np.diag(np.diag(d))).max() < 1e-11:
            p = cand
            break
    if p is None:
        raise np.linalg.LinAlgError("simultaneous diagonalisation failed")
    if np.linalg.det(p) < 0:
        p[:, 0] = -p[:, 0]
    theta = np.angle(np.diag(p.T @ m @ p)) / 2.0

    # sqrt-branch per eigenvalue: columns of V P e^{-i theta} are real up to
    # a +-1/i ambiguity resolved by the pi shift
    k1 = v @ p @ np.diag(np.exp(-1j * theta))
    for j in range(4):
        col = k1[:, j]
        if np.abs(col.imag).max() > np.abs(col.real).max():
            theta[j] += np.pi
            k1[:, j] = col * np.exp(-1j * np.pi)
    # K1 must land in SO(4), not O(4)-: det K1 = e^{-i sum theta}
    if np.linalg.det(k1).real < 0:
        theta[0] += np.pi
        k1[:, 0] = -k1[:, 0]

    # theta = THETA_MAP (a,b,c) + mean * ones; the mean is a global phase
    mean = theta.mean()
    abc, *_ = np.linalg.lstsq(_THETA_MAP, theta - mean, rcond=None)
    if np.abs(theta - mean - _THETA_MAP @ abc).max() > 1e-9:
        raise np.linalg.LinAlgError("canonical phases outside interaction span")
    phase = phase0 * np.exp(1j * mean)

    l1, l0 = _split_local(_B @ k1 @ _B.conj().T)
    r1, r0 = _split_local(_B @ p.T @ _B.conj().T)

    # fold each interaction strength into [-pi/4, pi/4]: a shift of pi/2
    # peels off a local Clifford, exp(i pi/2 P(x)P) = i P(x)P
    pauli_power = np.eye(2, dtype=complex)
    for idx, pauli in enumerate((_X, _Y, _Z)):
        k = int(np.round(abc[idx] / (np.pi / 2)))
        if k:
            abc[idx] -= k * np.pi / 2
            phase *= 1j ** (k % 4)
            pauli_power = pauli_power @ np.linalg.matrix_power(pauli, k % 4)
    if not np.allclose(pauli_power, np.eye(2)):
        r1 = pauli_power @ r1
        r0 = pauli_power @ r0
    return phase, l1, l0, tuple(float(x) for x in abc), r1, r0


def _zyz_angles(u: np.ndarray) -> Tuple[float, float, float]:
    """u = e^{i alpha} Rz(beta) Ry(gamma) Rz(delta); returns (beta, gamma,
    delta) (the global phase is irrelevant for overlap costs)."""
    det = np.linalg.det(u)
    su = u / np.sqrt(det)
    gamma = 2 * np.arctan2(abs(su[1, 0]), abs(su[0, 0]))
    if abs(su[0, 0]) > 1e-10 and abs(su[1, 0]) > 1e-10:
        beta = np.angle(su[1, 1]) + np.angle(su[1, 0])
        delta = np.angle(su[1, 1]) - np.angle(su[1, 0])
    elif abs(su[0, 0]) > 1e-10:    # diagonal
        beta = 2 * np.angle(su[1, 1])
        delta = 0.0
    else:                          # antidiagonal
        beta = 2 * np.angle(su[1, 0])
        delta = 0.0
    return float(beta), float(gamma), float(delta)


def _emit_1q(qc: Circuit, u: np.ndarray, q: int, tol: float = 1e-9):
    beta, gamma, delta = _zyz_angles(u)
    if abs(delta) > tol:
        qc.rz(delta, q)
    if abs(gamma) > tol:
        qc.ry(gamma, q)
    if abs(beta) > tol:
        qc.rz(beta, q)


def decompose_2q_unitary(u: np.ndarray, tol: float = 1e-9) -> Circuit:
    """4x4 unitary -> Circuit(2) with at most 3 CX (exact up to global
    phase). Near-local unitaries emit 0 CX."""
    phase, l1, l0, (a, b, c), r1, r0 = kak_decompose(u)
    qc = Circuit(2)
    if max(abs(a), abs(b), abs(c)) < tol:
        _emit_1q(qc, l0 @ r0, 0, tol)
        _emit_1q(qc, l1 @ r1, 1, tol)
        return qc
    # merge the template's fixed corner locals into the outer KAK locals
    left1, left0 = l1 @ _G1, l0 @ _G0
    right1, right0 = _H1 @ r1, _H0 @ r0
    _emit_1q(qc, right0, 0, tol)
    _emit_1q(qc, right1, 1, tol)
    qc.cx(1, 0)
    qc.rz(2 * a + np.pi / 2, 0)
    qc.ry(2 * b + np.pi / 2, 1)
    qc.cx(0, 1)
    qc.ry(2 * c + np.pi / 2, 1)
    qc.cx(1, 0)
    _emit_1q(qc, left0, 0, tol)
    _emit_1q(qc, left1, 1, tol)
    return qc


def circuit_to_matrix_2q(circuit: Circuit) -> np.ndarray:
    """Dense 4x4 of a 2-qubit circuit (basis r = 2*b(q1) + b(q0))."""
    from ..utils.gradients import circuit_to_matrix_2q as impl
    return impl(circuit)
