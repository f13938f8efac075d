"""Synthetic targets of the paper's random-MPS workload.

Counterpart of `random_target` in the JAX package's
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
from ..circuits.circuit import Circuit
from ..circuits.tape import compile_tape


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
