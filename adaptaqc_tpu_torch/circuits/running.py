"""Circuit-running helpers, noise model, zero-noise extrapolation.

Mirror of adapt-aqc's adaptaqc/utils/circuit_operations/
circuit_operations_running.py. The noise model is a lightweight
thermal-relaxation description; the sampling backend applies it by
Monte-Carlo Kraus unravelling (amplitude damping + dephasing per gate),
which is the trajectory-sampling equivalent of Aer's density-matrix noise.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
from scipy.optimize import curve_fit

from .circuit import Circuit
from .tape import compile_tape

logger = logging.getLogger(__name__)

# Instruction times in nanoseconds (running.py:74-80)
GATE_TIMES_NS = {
    "1q": 50.0,       # single X90 pulse (u2)
    "2q": 300.0,      # cx
    "reset": 1000.0,
    "measure": 1000.0,
}


@dataclass
class NoiseModel:
    """Thermal-relaxation noise description (running.py:72-109).

    t1, t2 in microseconds (converted like the reference's *1e6 ns scale).
    For a gate of duration t: p_amp = 1 - exp(-t/T1) amplitude damping and
    p_phi = 1 - exp(-t/T_phi) pure dephasing with 1/T_phi = 1/T2 - 1/(2 T1).
    """
    t1: float
    t2: float
    gate_times_ns: Dict[str, float] = field(default_factory=lambda: dict(GATE_TIMES_NS))

    def error_probs(self, kind: str):
        t = self.gate_times_ns.get(kind, 0.0)
        t1_ns = self.t1 * 1e6
        t2_ns = self.t2 * 1e6
        p_amp = 1.0 - np.exp(-t / t1_ns) if t1_ns > 0 else 0.0
        inv_tphi = max(1.0 / t2_ns - 0.5 / t1_ns, 0.0) if t2_ns > 0 else 0.0
        p_phi = 1.0 - np.exp(-t * inv_tphi)
        return p_amp, p_phi


def create_noisemodel(t1, t2, log_fidelities=True) -> NoiseModel:
    nm = NoiseModel(t1, t2)
    if log_fidelities:
        logger.info("Noise model fidelities:")
        for kind in ("1q", "2q", "measure", "reset"):
            pa, pp = nm.error_probs(kind)
            logger.info(f"{kind}: p_amp={pa:.3e} p_phi={pp:.3e}")
    return nm


def run_circuit_without_transpilation(circuit: Circuit, backend=None,
                                      backend_options=None, execute_kwargs=None,
                                      return_statevector=False):
    """Run a standalone circuit on a backend (running.py:44-69): a
    statevector backend returns the state (or counts derived from it); a
    sampling backend returns sampled counts, drawn with its own generator.
    Deviation: the JAX package seeds these draws from Python's per-process
    string hash, so they never repeat across processes."""
    from ..backends.backend import QASM_SIM, SamplingBackend, SVBackend
    if backend is None:
        backend = QASM_SIM
    execute_kwargs = execute_kwargs or {}
    if isinstance(backend, SamplingBackend):
        shots = execute_kwargs.get("shots", backend.shots)
        runner = backend._sv
    elif isinstance(backend, SVBackend):
        runner = backend
    else:
        raise ValueError("run_circuit_without_transpilation takes a "
                         "statevector or a sampling backend")
    n = circuit.num_qubits
    state = runner.initial_state(circuit, n)
    start = 1 if (circuit.data and circuit.data[0].name in
                  ("set_mps", "set_statevector")) else 0
    state = runner.run_tape(state, compile_tape(circuit,
                                                (start, len(circuit.data))))
    if isinstance(backend, SamplingBackend):
        return backend.sample_state(state, shots, n)
    sv = state.cpu().numpy()
    if return_statevector:
        return sv
    return counts_data_from_statevector(sv)


def run_circuit_with_transpilation(circuit: Circuit, backend=None,
                                   backend_options=None, execute_kwargs=None,
                                   return_statevector=False):
    """running.py:31-41 — our IR needs no device transpilation; identical to
    the untranspiled path."""
    return run_circuit_without_transpilation(circuit, backend, backend_options,
                                             execute_kwargs, return_statevector)


def counts_data_from_statevector(statevector, num_shots=2 ** 40):
    """utilityfunctions.py:133-151."""
    statevector = np.asarray(statevector)
    num_qubits = int(np.log2(len(statevector)))
    probs = np.absolute(statevector) ** 2
    bit_strs = [bin(i)[2:].zfill(num_qubits) for i in range(2 ** num_qubits)]
    return dict(zip(bit_strs, np.asarray(probs * num_shots, int)))


def statevector_from_counts_data(counts):
    """utilityfunctions.py:154-167 (real positive states only)."""
    num_qubits = len(list(counts.keys())[0])
    sv = np.zeros(2 ** num_qubits)
    for i in range(2 ** num_qubits):
        bitstr = bin(i)[2:].zfill(num_qubits)
        if bitstr in counts:
            sv[i] = counts[bitstr] ** 0.5
    return sv / np.linalg.norm(sv)


def _apply_1q_host(psi: np.ndarray, n: int, q: int, mat: np.ndarray):
    """Apply a (possibly non-unitary) 2x2 matrix to qubit q of a host
    statevector reshaped to (2,)*n (little-endian: qubit 0 = LSB, so qubit
    q lives on axis n-1-q)."""
    a = n - 1 - q
    psi = np.moveaxis(psi, a, 0)
    psi = (mat @ psi.reshape(2, -1)).reshape((2,) * n)
    return np.moveaxis(psi, 0, a)


def _thermal_relax_step(psi: np.ndarray, n: int, q: int, gamma: float,
                        p_z: float, u_amp: float, u_z: float) -> np.ndarray:
    """One Kraus-trajectory step of the single-qubit thermal-relaxation
    channel on qubit q (excited-state population 0, T2 <= 2*T1):

      amplitude damping  K0 = diag(1, sqrt(1-gamma)), K1 = sqrt(gamma)|0><1|
      pure dephasing     Z with probability p_z = (1 - exp(-t/T_phi))/2

    The amplitude-damping jump is STATE-DEPENDENT: it fires with
    probability gamma * P(q=1); otherwise the normalised no-jump evolution
    K0|psi>/||.|| is applied (which damps the |1> amplitude — this is what
    the old X-insertion proxy got wrong). Averaging |psi><psi| over
    trajectories reproduces the channel exactly:
    rho_11 -> e^{-t/T1} rho_11, rho_01 -> e^{-t/T2} rho_01
    (sqrt(1-gamma)*(1-2 p_z) = e^{-t/2T1} e^{-t/T_phi} = e^{-t/T2}).
    Mirrors Aer's thermal_relaxation_error semantics (reference
    circuit_operations_running.py:72-109) as a statevector unravelling.
    u_amp/u_z are uniform(0,1) draws, injected so tests can force and
    weight branches exactly."""
    a = n - 1 - q
    pm = np.moveaxis(psi, a, 0)
    p1 = float(np.sum(np.abs(pm[1]) ** 2))
    if u_amp < gamma * p1:
        # jump: |1> component relabelled to |0>, renormalised
        new = np.zeros_like(pm)
        new[0] = pm[1]
        pm = new / np.sqrt(p1)
    else:
        # no-jump: damp |1| amplitude, renormalise
        pm = pm.copy()
        pm[1] = pm[1] * np.sqrt(max(1.0 - gamma, 0.0))
        nrm = np.sqrt(np.sum(np.abs(pm) ** 2))
        if nrm > 0:
            pm = pm / nrm
    if u_z < p_z:
        pm = pm.copy()
        pm[1] = -pm[1]
    return np.moveaxis(pm, 0, a)


def _mps_to_statevector(payload, device="cpu") -> np.ndarray:
    """Dense little-endian complex128 statevector of an engine MPS or a
    Qiskit-format MPS (utilityfunctions.mps_to_statevector's contract); a
    Qiskit-format MPS is loaded on `device` first."""
    import torch
    from ..backends import mps_core
    if not isinstance(payload, mps_core.MPS):
        gams, lams = payload
        chi = max([1] + [np.asarray(v).size for v in lams])
        chi = int(2 ** np.ceil(np.log2(max(chi, 2))))
        payload = mps_core.from_qiskit_mps(payload, chi,
                                           dtype=torch.complex128,
                                           device=device)
    return np.asarray(mps_core.to_dense(payload), dtype=np.complex128)


def _initial_host_state(circuit: Circuit) -> Tuple[np.ndarray, int]:
    """(statevector reshaped (2,)*n, first gate index) for a host run."""
    n = circuit.num_qubits
    start = 0
    if circuit.data and circuit.data[0].name in ("set_statevector", "set_mps"):
        instr = circuit.data[0]
        start = 1
        if instr.name == "set_statevector":
            sv = np.asarray(instr.payload, dtype=np.complex128)
        else:
            sv = _mps_to_statevector(instr.payload)
    else:
        sv = np.zeros(2 ** n, dtype=np.complex128)
        sv[0] = 1.0
    return sv.reshape((2,) * n), start


def simulate_noise_trajectory(circuit: Circuit, noise_model: NoiseModel,
                              rng: np.random.Generator) -> np.ndarray:
    """Exact f64 host simulation of ONE Kraus trajectory of the circuit
    under the thermal-relaxation noise model: after every gate, each
    touched qubit passes through `_thermal_relax_step` with that gate
    kind's (gamma, p_z). Returns the flat statevector. Trajectory-averaged
    |psi><psi| converges to Aer's density-matrix channel (the reference
    threads the same model into Aer execution, running.py:31-41,72-109)."""
    from . import gates as G
    n = circuit.num_qubits
    psi, start = _initial_host_state(circuit)
    for instr in circuit.data[start:]:
        name = instr.name
        if name in ("barrier", "set_statevector", "set_mps", "measure"):
            continue
        qs = instr.qubits
        if len(qs) == 1:
            mat = G.u1q_np(name, instr.params[0] if instr.params else 0.0)
            psi = _apply_1q_host(psi, n, qs[0], mat)
        elif name == "cx":
            c, t = qs
            pm = np.moveaxis(psi, (n - 1 - c, n - 1 - t), (0, 1))
            pm = np.stack([pm[0], pm[1, ::-1]])
            psi = np.moveaxis(pm, (0, 1), (n - 1 - c, n - 1 - t))
        elif name == "cz":
            c, t = qs
            pm = np.moveaxis(psi, (n - 1 - c, n - 1 - t), (0, 1)).copy()
            pm[1, 1] = -pm[1, 1]
            psi = np.moveaxis(pm, (0, 1), (n - 1 - c, n - 1 - t))
        elif name == "swap":
            a, b = qs
            psi = np.swapaxes(psi, n - 1 - a, n - 1 - b)
        else:
            raise ValueError(f"unsupported gate in noise trajectory: {name}")
        kind = "2q" if len(qs) == 2 else "1q"
        p_amp, p_phi = noise_model.error_probs(kind)
        p_z = 0.5 * p_phi  # phase flip prob: (1-2p_z) = e^{-t/T_phi}
        for q in qs:
            psi = _thermal_relax_step(psi, n, q, p_amp, p_z,
                                      rng.random(), rng.random())
    return psi.reshape(-1)


def zero_noise_extrapolate(circuit: Circuit, measurement_function: Callable,
                           num_points: int = 10):
    """ZNE by stochastic CX-pair insertion + exponential fit
    (running.py:112-139). Mutates the circuit per point and restores it."""
    calculated_values = []
    probabilities = np.linspace(0, 1, num_points)
    for prob in probabilities:
        data_copy = list(circuit.data)
        for i, instr in list(enumerate(circuit.data))[::-1]:
            if instr.name == "cx":
                if np.random.random() < prob:
                    circuit.data.insert(i, instr.copy())
                    circuit.data.insert(i, instr.copy())
        calculated_values.append(measurement_function())
        circuit.data = data_copy

    def exp_decay(x, intercept, amp, decay_rate):
        return intercept + amp * np.exp(-1 * x / decay_rate)

    try:
        popt, _ = curve_fit(exp_decay, probabilities, calculated_values,
                            [0, calculated_values[0], 1])
        return exp_decay(-0.5, *popt)
    except RuntimeError as e:
        logger.warning(f"Failed to zero-noise-extrapolate. Error was {e}")
        return measurement_function()
