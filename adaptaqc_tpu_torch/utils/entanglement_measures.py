"""Pairwise quantum-correlation measures for the ISL pair-selection heuristic.

Feature parity with adapt-aqc's adaptaqc/utils/entanglement_measures.py
(cited per function), re-derived in repo idiom:

 - Tomography-based measures (concurrence / EoF / negativity / log-negativity)
   act on a 2-qubit reduced density matrix. RDMs come from the engines
   (statevector partial trace or cached-environment MPS contraction, both
   batched on device), or — for the sampling backend — from genuine
   shot-based Pauli tomography (`perform_quantum_tomography`).
 - The observable concurrence lower bound is the two-copy protocol of
   PhysRevLett.98.140505: Bell-basis measurements on copy pairs estimate
   antisymmetric-projector expectations, giving
   V1 = 8<P-.P-> - 4<I.P->,  V2 = 8<P-.P-> - 4<P-.I>,  bound = max(V1, V2).
   For product two-copy states these reduce to the closed purity forms
   V1 = 2(tr rho^2 - tr rho_A^2), V2 = 2(tr rho^2 - tr rho_B^2), which is
   what `measure_from_rdm` evaluates on exact RDMs; the sampling backend runs
   the actual doubled-circuit measurement (`measure_concurrence_lower_bound`).

All 4x4 measure math runs host-side in float64; the statevector work runs
on the backends of this package.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

EM_OBSERVABLE_CONCURRENCE_LOWER_BOUND = "EM_OBSERVABLE_CONCURRENCE_LOWER_BOUND"
EM_TOMOGRAPHY_EOF = "EM_TOMOGRAPHY_EOF"
EM_TOMOGRAPHY_CONCURRENCE = "EM_TOMOGRAPHY_CONCURRENCE"
EM_TOMOGRAPHY_NEGATIVITY = "EM_TOMOGRAPHY_NEGATIVITY"
EM_TOMOGRAPHY_LOG_NEGATIVITY = "EM_TOMOGRAPHY_LOG_NEGATIVITY"

# (sigma_y (x) sigma_y) is real: antidiagonal [-1, 1, 1, -1]
_FLIP = np.fliplr(np.diag([-1.0, 1.0, 1.0, -1.0]))

_PAULIS = {
    "I": np.eye(2, dtype=complex),
    "X": np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex),
    "Y": np.array([[0.0, -1.0j], [1.0j, 0.0]], dtype=complex),
    "Z": np.diag([1.0, -1.0]).astype(complex),
}


def measure_from_rdm(method: str, rho: np.ndarray) -> float:
    """Evaluate an entanglement measure on an exact (or tomographically
    estimated) 2-qubit RDM. The compiler's batched pair sweep calls this
    once per coupling-map pair (adapt_compiler.py:955-976)."""
    if method == EM_TOMOGRAPHY_EOF:
        return eof(rho)
    if method == EM_TOMOGRAPHY_CONCURRENCE:
        return concurrence(rho)
    if method == EM_TOMOGRAPHY_NEGATIVITY:
        return negativity(rho)
    if method == EM_TOMOGRAPHY_LOG_NEGATIVITY:
        return log_negativity(rho)
    if method == EM_OBSERVABLE_CONCURRENCE_LOWER_BOUND:
        return concurrence_lower_bound_from_rdm(rho)
    raise ValueError("Invalid entanglement measure method")


# ------------------------------------------------------------ 4x4 measures

def spin_flip(rho: np.ndarray) -> np.ndarray:
    """Wootters' spin-flipped state (sy(x)sy) rho* (sy(x)sy)."""
    return _FLIP @ rho.conj() @ _FLIP


def concurrence(rho) -> float:
    """Wootters mixed-state concurrence, PhysRevLett.80.2245
    (ref entanglement_measures.py:278-296): with l_1 >= ... >= l_4 the
    square-rooted spectrum of rho @ spin_flip(rho),
    C = max(0, l_1 - l_2 - l_3 - l_4)."""
    rho = np.asarray(rho, dtype=complex)
    spectrum = np.linalg.eigvals(rho @ spin_flip(rho))
    if not np.allclose(spectrum.imag, 0.0):
        logger.warning(
            "concurrence: spectrum of rho*rho_tilde is not real — "
            "input is not a valid density matrix; reporting 0")
        return 0.0
    lam = np.sqrt(np.clip(np.sort(spectrum.real)[::-1], 0.0, None))
    return float(max(0.0, 2.0 * lam[0] - lam.sum()))


def eof(rho) -> float:
    """Entanglement of formation via the concurrence closed form,
    PhysRevLett.80.2245 (ref :262-275)."""
    c = concurrence(rho)
    if c == 0:
        return 0
    x = 0.5 * (1.0 + np.sqrt(1.0 - c * c))
    return float(-x * np.log2(x) - (1.0 - x) * np.log2(1.0 - x))


def partial_transpose(density_matrix, wrt: int = 1) -> np.ndarray:
    """Partial transpose of a 2-qubit density matrix over subsystem `wrt`
    (1 = the high bit of the 4-dim index, 2 = the low bit; ref :343-356),
    vectorised as an axis swap on the (2, 2, 2, 2) tensor."""
    r = np.asarray(density_matrix).reshape(2, 2, 2, 2)
    # axes: (row_hi, row_lo, col_hi, col_lo)
    axes = (2, 1, 0, 3) if wrt == 1 else (0, 3, 2, 1)
    return np.ascontiguousarray(r.transpose(axes).reshape(4, 4))


def trace_norm(m) -> float:
    """Nuclear norm sum_i s_i(m) == tr sqrt(m m^dag) (ref :359-370)."""
    return float(np.linalg.svd(np.asarray(m), compute_uv=False).sum())


def negativity(rho) -> float:
    """(||rho^T_A||_1 - 1) / 2 (ref :299-302)."""
    return (trace_norm(partial_transpose(rho)) - 1.0) / 2.0


def log_negativity(rho) -> float:
    """log2 ||rho^T_A||_1 (ref :305-308)."""
    return float(np.log2(trace_norm(partial_transpose(rho))))


def concurrence_lower_bound_from_rdm(rho) -> float:
    """Closed form of the two-copy observable lower bound on C^2
    (PhysRevLett.98.140505) for exact RDMs: since the doubled state is
    rho (x) rho, <P-> on a copy pair equals (1 - purity)/2, so
    V1 = 2(tr rho^2 - tr rho_A^2) and V2 = 2(tr rho^2 - tr rho_B^2).
    The reference estimates exactly these via the measurement circuits
    (ref :138-256); the sampling path here does too
    (measure_concurrence_lower_bound)."""
    rho = np.asarray(rho, dtype=complex)
    r4 = rho.reshape(2, 2, 2, 2)
    rho_hi = np.trace(r4, axis1=1, axis2=3)   # trace out the low bit
    rho_lo = np.trace(r4, axis1=0, axis2=2)   # trace out the high bit
    purity = np.real(np.vdot(rho.T, rho))     # tr rho^2 for Hermitian rho
    p_hi = np.real(np.vdot(rho_hi.T, rho_hi))
    p_lo = np.real(np.vdot(rho_lo.T, rho_lo))
    return float(2.0 * (purity - min(p_hi, p_lo)))


# ---------------------------------------------------- statevector utilities

def partial_trace(statevector, a, b) -> np.ndarray:
    """SV partial trace onto qubits (a, b); a is the LSB of the 4-dim space
    (ref :325-340)."""
    statevector = np.asarray(statevector)
    num_qubits = int(np.log2(len(statevector)))
    if num_qubits == 2:
        return np.outer(statevector, statevector.conj())
    lo, hi = min(a, b), max(a, b)
    psi = statevector.reshape([2] * num_qubits)
    # little-endian: qubit q is axis (n-1-q)
    keep = [num_qubits - 1 - hi, num_qubits - 1 - lo]
    rest = [ax for ax in range(num_qubits) if ax not in keep]
    psi = np.transpose(psi, keep + rest).reshape(4, -1)
    return psi @ psi.conj().T


# ------------------------------------------------- shot-based 2q tomography

_TOMO_SETTINGS = [(p, q) for p in "XYZ" for q in "XYZ"]


def _measurement_probs(rho: np.ndarray, basis_hi: str, basis_lo: str):
    """Outcome distribution p(s_hi, s_lo) of measuring the RDM's high bit in
    `basis_hi` and low bit in `basis_lo`; outcome index = 2*s_hi + s_lo."""
    probs = np.empty(4)
    for s_hi in (0, 1):
        proj_hi = _pauli_projector(basis_hi, s_hi)
        for s_lo in (0, 1):
            proj = np.kron(proj_hi, _pauli_projector(basis_lo, s_lo))
            probs[2 * s_hi + s_lo] = max(np.real(np.trace(rho @ proj)), 0.0)
    return probs / probs.sum()


def _pauli_projector(basis: str, outcome: int) -> np.ndarray:
    return 0.5 * (np.eye(2) + (1 - 2 * outcome) * _PAULIS[basis])


def _project_to_density_matrix(rho: np.ndarray) -> np.ndarray:
    """Nearest (2-norm) density matrix to a Hermitian unit-trace estimate:
    the eigenvalue water-filling of Smolin-Gambetta-Smith
    (PhysRevLett.108.070502) — the same post-processing family
    qiskit_experiments' StateTomography applies."""
    herm = 0.5 * (rho + rho.conj().T)
    evals, evecs = np.linalg.eigh(herm)
    evals = evals[::-1].copy()  # descending
    d = len(evals)
    shift = 0.0
    for i in range(d - 1, -1, -1):
        if evals[i] + shift / (i + 1) >= 0:
            evals[: i + 1] += shift / (i + 1)
            evals[i + 1:] = 0.0
            break
        shift += evals[i]
        evals[i] = 0.0
    evals = evals[::-1]
    return (evecs * evals[None, :]) @ evecs.conj().T


def sample_tomography_rdm(rho: np.ndarray, shots: int,
                          rng: np.random.Generator) -> np.ndarray:
    """Simulate full shot-based state tomography of a known 2q RDM: draw
    `shots` multinomial samples per Pauli setting (9 settings), reconstruct
    by linear inversion over the Pauli basis, and project back onto the
    density-matrix cone.

    The per-setting outcome distribution of the simulated tomography circuits
    is exactly determined by the RDM, so sampling from it is statistically
    identical to running the measurement circuits the reference's
    StateTomography executes (ref :101-135) — without 9 device round trips
    per pair."""
    corr = {}        # (P, Q) -> estimated <P (x) Q>
    singles_hi = {p: [] for p in "XYZ"}
    singles_lo = {p: [] for p in "XYZ"}
    for basis_hi, basis_lo in _TOMO_SETTINGS:
        counts = rng.multinomial(shots, _measurement_probs(rho, basis_hi,
                                                           basis_lo))
        freqs = counts / shots
        sign_hi = np.array([1, 1, -1, -1])
        sign_lo = np.array([1, -1, 1, -1])
        corr[(basis_hi, basis_lo)] = float(np.dot(sign_hi * sign_lo, freqs))
        singles_hi[basis_hi].append(float(np.dot(sign_hi, freqs)))
        singles_lo[basis_lo].append(float(np.dot(sign_lo, freqs)))

    est = np.eye(4, dtype=complex)
    for p in "XYZ":
        est += np.mean(singles_hi[p]) * np.kron(_PAULIS[p], _PAULIS["I"])
        est += np.mean(singles_lo[p]) * np.kron(_PAULIS["I"], _PAULIS[p])
    for (p, q), value in corr.items():
        est += value * np.kron(_PAULIS[p], _PAULIS[q])
    return _project_to_density_matrix(est / 4.0)


def _rotated_measurement_circuit(circuit, qubit: int, basis: str):
    """Append the basis-change so a Z measurement of `qubit` reads out
    `basis`: H for X; S^dagger then H for Y (rz(-pi/2) == S^dagger up to a
    global phase, which sampling cannot see); nothing for Z. Mirrors the
    measurement circuits qiskit_experiments' StateTomography schedules for
    the reference (ref entanglement_measures.py:101-135)."""
    if basis == "X":
        circuit.h(qubit)
    elif basis == "Y":
        circuit.rz(-np.pi / 2, qubit)
        circuit.h(qubit)
    return circuit


def circuit_tomography_rdm(circuit, qubit_1, qubit_2, backend,
                           shots: int, noise_model=None) -> np.ndarray:
    """Genuine shot tomography: EXECUTE the 9 rotated measurement circuits
    through the sampling backend's on-device sampler, marginalise each
    bitstring histogram onto (qubit_1, qubit_2), linear-invert over the
    Pauli basis and project to the density-matrix cone — the same pipeline
    the reference runs via qiskit_experiments' StateTomography
    (ref :101-135), minus its least-squares fitter (linear inversion + cone
    projection is the same estimator family StateTomography defaults to for
    2 qubits).

    With a `noise_model` the measurement circuits run under it, as the
    reference's StateTomography.run(backend, **execute_kwargs) runs them
    under backend noise. Deviation: the JAX package ignores the noise model
    here and always measures the noiseless state."""
    from ..circuits.tape import compile_tape
    lo, hi = min(qubit_1, qubit_2), max(qubit_1, qubit_2)
    n = circuit.num_qubits
    corr = {}
    singles_hi = {p: [] for p in "XYZ"}
    singles_lo = {p: [] for p in "XYZ"}
    for basis_hi, basis_lo in _TOMO_SETTINGS:
        meas = circuit.copy()
        _rotated_measurement_circuit(meas, hi, basis_hi)
        _rotated_measurement_circuit(meas, lo, basis_lo)
        if noise_model is not None:
            counts = backend.noisy_counts(meas, noise_model, shots)
        else:
            state = backend._sv.initial_state(meas, n)
            start = 1 if (meas.data and meas.data[0].name in
                          ("set_mps", "set_statevector")) else 0
            state = backend._sv.run_tape(
                state, compile_tape(meas, (start, len(meas.data))))
            counts = backend.sample_state(state, shots, n)
        freqs = np.zeros(4)
        for key, c in counts.items():
            v = int(key, 2)
            s_hi = (v >> hi) & 1
            s_lo = (v >> lo) & 1
            freqs[2 * s_hi + s_lo] += c
        freqs /= shots
        sign_hi = np.array([1, 1, -1, -1])
        sign_lo = np.array([1, -1, 1, -1])
        corr[(basis_hi, basis_lo)] = float(np.dot(sign_hi * sign_lo, freqs))
        singles_hi[basis_hi].append(float(np.dot(sign_hi, freqs)))
        singles_lo[basis_lo].append(float(np.dot(sign_lo, freqs)))
    est = np.eye(4, dtype=complex)
    for p in "XYZ":
        est += np.mean(singles_hi[p]) * np.kron(_PAULIS[p], _PAULIS["I"])
        est += np.mean(singles_lo[p]) * np.kron(_PAULIS["I"], _PAULIS[p])
    for (p, q), value in corr.items():
        est += value * np.kron(_PAULIS[p], _PAULIS[q])
    return _project_to_density_matrix(est / 4.0)


def perform_quantum_tomography(circuit, qubit_1, qubit_2, backend,
                               backend_options=None, execute_kwargs=None,
                               shots: Optional[int] = None,
                               rng: Optional[np.random.Generator] = None
                               ) -> np.ndarray:
    """Shot-based tomography of the reduced state of (qubit_1, qubit_2)
    after running `circuit` (ref :101-135). Returns the estimated RDM with
    min(qubit_1, qubit_2) as the low bit.

    A SamplingBackend executes the 9 rotated measurement circuits for real
    (circuit_tomography_rdm); statevector-class backends use the
    statistically identical fast path (multinomial draws from the exact
    per-setting outcome distributions, sample_tomography_rdm)."""
    from ..backends.backend import SamplingBackend
    from ..circuits.running import run_circuit_without_transpilation
    execute_kwargs = execute_kwargs or {}
    shots = shots or execute_kwargs.get("shots",
                                        getattr(backend, "shots", 8192))
    if isinstance(backend, SamplingBackend):
        return circuit_tomography_rdm(circuit, qubit_1, qubit_2, backend,
                                      shots, execute_kwargs.get("noise_model"))
    sv = run_circuit_without_transpilation(circuit, backend,
                                           return_statevector=True)
    exact = partial_trace(sv, min(qubit_1, qubit_2), max(qubit_1, qubit_2))
    rng = rng or getattr(backend, "rng", None) or np.random.default_rng()
    return sample_tomography_rdm(exact, shots, rng)


# --------------------------------------- two-copy observable lower bound

def antisymmetric_subspace_projector_measurement_circuit():
    """Bell-basis rotation on a copy pair: CX then H sends the singlet
    (the antisymmetric subspace of 2 qubits) to |11>, so the projector
    expectation is the probability of reading 11 (ref :314-322)."""
    from ..circuits.circuit import Circuit
    qc = Circuit(2)
    qc.cx(0, 1)
    qc.h(0)
    return qc


def measure_concurrence_lower_bound(circuit, qubit_1, qubit_2, backend=None,
                                    backend_options=None, execute_kwargs=None):
    """Two-copy observable lower bound on C^2 (PhysRevLett.98.140505;
    ref :138-256). Prepares two copies of `circuit` side by side, rotates the
    (q, q+n) copy pairs of qubit_1 and/or qubit_2 into the Bell basis, and
    estimates the antisymmetric-projector expectations from sampled counts:

        V1 = 8 <P-(q1) P-(q2)> - 4 <I P-(q2)>
        V2 = 8 <P-(q1) P-(q2)> - 4 <P-(q1) I>
        bound = max(V1, V2)

    With a sampling backend the three estimates carry real shot noise; exact
    backends use the exact doubled-state probabilities."""
    from ..backends.backend import SamplingBackend, QASM_SIM
    from ..backends import sv_core
    from ..circuits import operations as co
    from ..circuits.circuit import Circuit
    from ..circuits.tape import compile_tape

    backend = backend if backend is not None else QASM_SIM
    # the doubled state runs on the backend's statevector engine
    kw = dict(dtype=getattr(backend, "dtype", None),
              device=getattr(backend, "device", "cpu"))
    execute_kwargs = execute_kwargs or {}
    n = circuit.num_qubits

    work = circuit.copy()
    classical_ops = co.remove_classical_operations(work)

    # a leading state-injection instruction cannot be spliced twice as gates;
    # the doubled initial state is the Kronecker square of its payload
    # (copy 2 occupies the high qubits, so little-endian kron(payload, payload))
    init_payload = None
    if work.data and work.data[0].name == "set_statevector":
        init_payload = np.asarray(work.data[0].payload)
        del work.data[0]

    doubled = Circuit(2 * n)
    co.add_to_circuit(doubled, work, qubit_subset=list(range(n)))
    co.add_to_circuit(doubled, work, qubit_subset=list(range(n, 2 * n)))

    def singlet_probs(rotate_q1: bool, rotate_q2: bool):
        """(P(pair-1 reads 11), P(pair-2 reads 11), P(both read 11)) for the
        doubled circuit with the selected Bell rotations appended."""
        qc = doubled.copy()
        bell = antisymmetric_subspace_projector_measurement_circuit()
        if rotate_q1:
            co.add_to_circuit(qc, bell.copy(),
                              qubit_subset=[qubit_1, n + qubit_1])
        if rotate_q2:
            co.add_to_circuit(qc, bell.copy(),
                              qubit_subset=[qubit_2, n + qubit_2])
        tape = compile_tape(qc, (0, len(qc.data)))
        if init_payload is None:
            init = sv_core.zero_state(2 * n, **kw)
        else:
            init = sv_core.state_from_vector(np.kron(init_payload,
                                                     init_payload), **kw)
        state = sv_core.apply_tape(init, tape.kinds, tape.q0, tape.q1,
                                   tape.angles)
        probs = np.maximum(sv_core.probabilities(state).cpu().numpy()
                           .astype(np.float64), 0.0)
        probs /= probs.sum()
        idx = np.arange(probs.size)
        ones_1 = (((idx >> qubit_1) & 1) & ((idx >> (n + qubit_1)) & 1)) == 1
        ones_2 = (((idx >> qubit_2) & 1) & ((idx >> (n + qubit_2)) & 1)) == 1
        if isinstance(backend, SamplingBackend):
            shots = execute_kwargs.get("shots", backend.shots)
            draws = backend.host_rng.choice(probs.size, size=shots, p=probs)
            ones_1 = ones_1[draws]
            ones_2 = ones_2[draws]
            return (float(ones_1.mean()), float(ones_2.mean()),
                    float((ones_1 & ones_2).mean()))
        return (float(probs[ones_1].sum()), float(probs[ones_2].sum()),
                float(probs[ones_1 & ones_2].sum()))

    p1_singlet, _, _ = singlet_probs(True, False)
    _, p2_singlet, _ = singlet_probs(False, True)
    _, _, both_singlet = singlet_probs(True, True)

    co.add_classical_operations(circuit, classical_ops)
    v1 = 8.0 * both_singlet - 4.0 * p2_singlet
    v2 = 8.0 * both_singlet - 4.0 * p1_singlet
    return max(v1, v2)


# ------------------------------------------------------------- dispatcher

def calculate_entanglement_measure(method, circuit, qubit_1, qubit_2, backend,
                                   backend_options=None, execute_kwargs=None,
                                   mps=None):
    """Reference-compatible per-pair dispatcher (ref :39-98): observable
    method runs the two-copy protocol; tomography methods obtain the RDM
    from the engine (exact) or from shot tomography (sampling backend) and
    evaluate the measure. The compiler fast-path batches all pairs on device
    instead."""
    from ..backends.backend import SamplingBackend
    if method == EM_OBSERVABLE_CONCURRENCE_LOWER_BOUND:
        return measure_concurrence_lower_bound(
            circuit, qubit_1, qubit_2, backend, backend_options,
            execute_kwargs)
    if isinstance(backend, SamplingBackend) and mps is None:
        rho = perform_quantum_tomography(circuit, qubit_1, qubit_2, backend,
                                         backend_options, execute_kwargs)
    else:
        rho = backend.two_qubit_rdm(circuit, qubit_1, qubit_2, state=mps)
    return measure_from_rdm(method, rho)
