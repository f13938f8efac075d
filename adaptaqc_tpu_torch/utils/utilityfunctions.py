"""Utility surface under the reference's `utilityfunctions` names.

Counterpart of the JAX package's `utils/utilityfunctions.py`. Many
functions live in more specific modules (optim.sinusoidal,
circuits.running, backends.mps_core); this module re-exports them under the
reference names so that downstream code ports 1:1. TenPy interop is gated
on the optional tenpy import. A function that builds an engine state takes
a `device`, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

import numpy as np

# --- trigonometric closed forms (utilityfunctions.py:31-116) ---------------
from ..optim.sinusoidal import (amplitude_of_sinusoidal,       # noqa: F401
                                derivative_of_sinusoidal,
                                has_stopped_improving,
                                minimum_of_sinusoidal, normalized_angles)

# --- counts/statevector helpers (:133-167) ----------------------------------
from ..circuits.running import (counts_data_from_statevector,  # noqa: F401
                                statevector_from_counts_data)

from ..circuits.pauli_ops import expectation_value_of_pauli_observable  # noqa: F401
from ..circuits.operations import (find_rotation_indices,      # noqa: F401
                                   remove_permutations_from_coupling_map)


def is_statevector_backend(backend) -> bool:
    from ..backends.backend import SVBackend
    return isinstance(backend, SVBackend)


def expectation_value_of_qubits(data: Union[Dict, np.ndarray]) -> List[float]:
    """<Z_i> per qubit from counts dict or statevector
    (utilityfunctions.py:170-185)."""
    if isinstance(data, dict):
        num_qubits = len(list(data)[0])
        return [_ev_from_counts(i, data, num_qubits) for i in range(num_qubits)]
    sv = np.asarray(data)
    num_qubits = int(np.log2(len(sv)))
    probs = np.abs(sv) ** 2
    idx = np.arange(len(sv))
    out = []
    for q in range(num_qubits):
        signs = 1.0 - 2.0 * ((idx >> q) & 1)
        out.append(float(np.sum(signs * probs)))
    return out


def _ev_from_counts(qubit_index, counts, num_qubits):
    if qubit_index >= num_qubits:
        raise ValueError("qubit_index outside of register range")
    reverse_index = num_qubits - (qubit_index + 1)
    ev = 0
    total = 0
    for bitstring, c in counts.items():
        ev += (1 if bitstring[reverse_index] == "0" else -1) * c
        total += c
    return ev / total


def expectation_value_of_qubits_mps(circuit, backend=None,
                                    device="cuda") -> List[float]:
    """<Z_i> via the MPS engine (utilityfunctions.py:188-205), on
    `backend`, or on a default MPSBackend on `device`."""
    from ..backends import mps_core
    from ..backends.backend import MPSBackend
    backend = backend or MPSBackend(device=device)
    state = backend.mps_from_compiler_target(circuit)
    return mps_core.z_expectations(state).cpu().tolist()


def multi_qubit_gate_depth(qc) -> int:
    return qc.multi_qubit_gate_depth()


def get_distinct_items_and_degeneracies(items: List) -> Tuple[List, List[int]]:
    """utilityfunctions.py:401-426."""
    distinct, degeneracies = [], []
    for item in items:
        for j, d in enumerate(distinct):
            if item == d:
                degeneracies[j] += 1
                break
        else:
            distinct.append(item)
            degeneracies.append(1)
    return distinct, degeneracies


# ----------------------------------------------------------- MPS conversions

def mps_to_statevector(mps_or_qiskit_mps, device="cuda") -> np.ndarray:
    """Dense little-endian complex128 statevector of an engine MPS, or of a
    Qiskit-format MPS loaded on `device` (the reference's
    tenpy_mps_to_statevector analogue, utilityfunctions.py:454-481)."""
    from ..circuits.running import _mps_to_statevector
    return _mps_to_statevector(mps_or_qiskit_mps, device)


def chi_1_mps_to_circuit(mps_or_qiskit_mps):
    """chi=1 MPS -> per-qubit Rz/Ry/Rz preparation circuit
    (tenpy_chi_1_mps_to_circuit analogue, utilityfunctions.py:329-353)."""
    from ..backends import mps_core
    from .compression import product_state_to_circuit
    if isinstance(mps_or_qiskit_mps, mps_core.MPS):
        state = mps_or_qiskit_mps
        lam = state.lam.detach().cpu().numpy()
        if np.any(np.sum(lam > 0, axis=1) > 1):
            raise Exception("MPS must have bond dimension 1 for all bonds.")
        # chi=1: the B tensors are the per-site amplitudes (all lam = 1)
        amps = state.b[:, :, 0, 0].detach().cpu().numpy()
    else:
        gams, lams = mps_or_qiskit_mps
        for v in lams:
            if np.asarray(v).size > 1:
                raise Exception("MPS must have bond dimension 1 for all bonds.")
        amps = np.stack([np.array([np.asarray(g[0]).ravel()[0],
                                   np.asarray(g[1]).ravel()[0]])
                         for g in gams])
    return product_state_to_circuit(amps)


# TenPy interop (utilityfunctions.py:291-385, 428-481). The TenPy->Qiskit
# direction is pure layout code over the TenPy MPS protocol; only
# qiskit_to_tenpy_mps needs the tenpy package installed.
from .tenpy_interop import (check_flipped_basis_states,  # noqa: F401, E402
                            qiskit_to_tenpy_mps,
                            tenpy_chi_1_mps_to_circuit,
                            tenpy_mps_to_statevector, tenpy_to_qiskit_mps)
