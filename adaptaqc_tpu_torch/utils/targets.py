"""Synthetic targets of the paper's two 50-qubit workloads.

`trotter_circuit`, `neel_circuit` and `staggered_magnetisation` are the
port's copies of the spin-chain workload of the JAX package's
`benchmarks/spin_chain.py` (the paper's fig. 5: XXZ Trotter dynamics from
the Neel state). `random_target` is the counterpart of `random_target` in
`benchmarks/random_mps.py`: the paper's 50-site random MPS targets
(arXiv:2503.09683) are not shipped with the repository, so the workload
builds a random low-chi MPS canonically, by evolving |0> through a random
brickwall of two-qubit gates at bond cap `chi`, and exports it in the Qiskit
MPS format. The circuit comes from numpy's default_rng(seed), so the JAX
package and the port build the same circuit for the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backends import mps_core
from ..circuits import operations as co
from ..circuits.circuit import Circuit
from ..circuits.kak import canonical_gate, decompose_2q_unitary
from ..circuits.tape import compile_tape
from ..ops import cplx


def trotter_circuit(n: int, steps: int, dt: float, delta: float = 1.5,
                    h: float = 1.0) -> Circuit:
    """First-order Trotter circuit of the XXZ chain H = sum_i (XX + YY +
    delta ZZ) + h Z: `steps` steps of even bonds, odd bonds and the field,
    each bond term exp(-i dt h_bond) = N(-dt, -dt, -delta dt) synthesised by
    the KAK decomposition (circuits/kak.py)."""
    bond = decompose_2q_unitary(canonical_gate(-dt, -dt, -delta * dt))
    qc = Circuit(n)
    for _ in range(steps):
        for parity in (0, 1):
            for q in range(parity, n - 1, 2):
                co.add_to_circuit(qc, bond.copy(), qubit_subset=[q, q + 1])
        for q in range(n):
            qc.rz(2 * h * dt, q)
    return qc


def neel_circuit(n: int) -> Circuit:
    """|0101...>: an X on every odd qubit."""
    qc = Circuit(n)
    for q in range(1, n, 2):
        qc.x(q)
    return qc


def staggered_magnetisation(circuit: Circuit, chi: int = 64,
                            dtype: torch.dtype = None,
                            device="cuda") -> float:
    """(1/n) sum_i (-1)^i <Z_i> of circuit|0>, simulated on `device` at bond
    dimension chi on the native eigensolver (a one-shot deep re-simulation:
    a verification, not the sweep's path)."""
    qc = co.make_quantum_only_circuit(circuit)
    tape = compile_tape(qc)
    with cplx.verification_eigh():
        state = mps_core.apply_tape(
            mps_core.zero_mps(qc.num_qubits, chi, dtype, device), tape.kinds,
            tape.q0, tape.q1, tape.angles, 1e-16)
        z = mps_core.z_expectations(state).cpu().numpy()
    signs = (-1.0) ** np.arange(qc.num_qubits)
    return float(np.mean(signs * z))


def random_target_circuit(seed: int, n: int = 50) -> Circuit:
    rng = np.random.default_rng(seed)
    qc = Circuit(n)
    for q in range(n):
        qc.ry(float(rng.uniform(-3, 3)), q)
    for layer in range(2):
        for q in range(layer % 2, n - 1, 2):
            qc.cx(q, q + 1)
        for q in range(n):
            qc.rz(float(rng.uniform(-3, 3)), q)
    return qc


def random_target(seed: int, n: int = 50, chi: int = 2,
                  dtype: torch.dtype = None, device="cuda"):
    """Qiskit-format random MPS (list of (G0, G1), list of lambdas), built
    on `device` (the card unless the caller asks for the CPU)."""
    tape = compile_tape(random_target_circuit(seed, n))
    state = mps_core.apply_tape(mps_core.zero_mps(n, chi, dtype, device),
                                tape.kinds, tape.q0, tape.q1, tape.angles,
                                1e-16)
    return mps_core.to_qiskit_mps(state)
