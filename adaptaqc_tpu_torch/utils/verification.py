"""Cross-engine verification of compiled solutions.

Counterpart of the JAX package's `utils/verification.py`. The reference keeps
ITensorBackend so that a result from one tensor-network engine can be checked
by an algorithmically independent one (itensor_backend.py:17-62). This is
that check as one call: re-simulate a solution circuit and its target in the
center-gauge engine (`backends/center_mps.py`: another gauge, another update
algebra, a truncation that does not renormalise) and return the normalised
overlap. Two independent engines agreeing is stronger evidence than one
engine run at doubled chi.
"""

from __future__ import annotations

from .. import config
from ..backends import center_mps, mps_core
from ..circuits.operations import make_quantum_only_circuit
from ..circuits.tape import compile_tape
from ..ops import cplx

__all__ = ["cross_engine_overlap"]


def _simulate(circuit, chi: int, cutoff: float, dtype, device):
    tape = compile_tape(make_quantum_only_circuit(circuit))
    return center_mps.apply_tape(
        center_mps.zero_cmps(circuit.num_qubits, chi, dtype, device),
        tape.kinds, tape.q0, tape.q1, tape.angles, cutoff)


def cross_engine_overlap(target, circuit, chi: int = 64,
                         cutoff: float = 1e-14, device="cuda",
                         dtype=None) -> float:
    """|<target|circuit|0>|^2, both sides re-simulated in the center-gauge
    engine at bond dimension `chi` on `device` (the card unless the caller
    asks for the CPU; an engine-MPS target brings its own device and dtype),
    normalised by both norms.

    `target` may be a gate circuit, an engine MPS (`mps_core.MPS`) or a
    Qiskit-format MPS tuple; `circuit` is the solution gate circuit.

    The verifier runs under `cplx.verification_eigh()`, the native
    eigensolver: the eigensolver kernels are the main engine's path, and a
    check on another eigensolver than the engine under test is the more
    independent one."""
    if isinstance(target, mps_core.MPS):
        device, dtype = target.device, target.dtype
    dtype = dtype or config.DEFAULT_DTYPE
    with cplx.verification_eigh():
        if isinstance(target, mps_core.MPS):
            tgt = center_mps.from_bform(mps_core.regauge(target, chi))
        elif mps_core.check_mps(target):
            tgt = center_mps.from_bform(
                mps_core.from_qiskit_mps(target, chi, dtype, device))
        else:
            tgt = _simulate(target, chi, cutoff, dtype, device)
        sol = _simulate(circuit, chi, cutoff, dtype, device)
        nrm2 = float(center_mps.norm_sq(sol))
        tnrm2 = float(center_mps.norm_sq(tgt))
        ov = center_mps.cmps_dot(tgt, sol)
        return float(ov.real ** 2 + ov.imag ** 2) / max(nrm2 * tnrm2, 1e-30)
