"""Backend layer: the AQCBackend contract and the MPS engine adapter.

Counterpart of the JAX package's `backends/backend.py` (AQCBackend,
MPSBackend, mps_backend_with_args). A backend holds no simulator of its own
to call out to: it evaluates tapes against a cached engine prefix state, so
a cost query after the prefix is one engine call. The statevector and
sampling backends are not ported yet (ROADMAP).

Every engine state lives on the backend's explicit `device`, in its `dtype`
(complex64 by default; complex128 for float64 parity work on the CPU).
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from typing import Optional

import numpy as np
import torch

from .. import config
from ..circuits.circuit import Circuit
from ..circuits.tape import Tape, compile_tape
from . import mps_core

logger = logging.getLogger(__name__)

DEFAULT_MAX_CHI = 64
DEFAULT_TRUNCATION_THRESHOLD = 1e-16


class AQCBackend(ABC):
    """Backend contract (aqc_backend.py:14-29)."""

    @abstractmethod
    def evaluate_global_cost(self, compiler):
        ...

    @abstractmethod
    def evaluate_local_cost(self, compiler):
        ...

    @abstractmethod
    def evaluate_circuit(self, compiler):
        ...

    @abstractmethod
    def measure_qubit_expectation_values(self, compiler):
        ...


class MPSBackend(AQCBackend):
    """MPS cost engine (AerMPSBackend analogue).

    :param truncation_threshold: singular values at or below this are
        discarded (matrix_product_state_truncation_threshold).
    :param max_chi: padded bond dimension the engine truncates to (the Aer
        default is unbounded; a fixed cap keeps tensor shapes fixed;
        DEFAULT_MAX_CHI when unset). The discarded weight is tracked in
        MPS.trunc, so a binding cap is never silent.
    :param mps_log_data: log the accumulated discarded weight after every
        tape execution (one device sync each).
    :param device: torch device of every engine state ("cpu", "cuda", ...).
    :param dtype: complex dtype of the engine (complex64 by default).
    """

    engine_name = "mps"

    def __init__(self, truncation_threshold: float = DEFAULT_TRUNCATION_THRESHOLD,
                 max_chi: Optional[int] = None, mps_log_data: bool = False,
                 device="cpu", dtype: torch.dtype = None):
        self.truncation_threshold = float(truncation_threshold)
        self.max_chi = max_chi
        self.mps_log_data = mps_log_data
        self.device = torch.device(device)
        self.dtype = dtype or config.DEFAULT_DTYPE

    @staticmethod
    def truncated_weight(state) -> float:
        """Total relative Schmidt weight discarded by the 2q applies that
        produced `state` (one device sync)."""
        return float(state.trunc)

    def chi_for(self, n: int) -> int:
        cap = self.max_chi or DEFAULT_MAX_CHI
        return int(min(cap, max(2, 2 ** ((n + 1) // 2))))

    def initial_state(self, circuit: Circuit, n: int):
        chi = self.chi_for(n)
        kw = dict(dtype=self.dtype, device=self.device)
        if circuit.data and circuit.data[0].name == "set_mps":
            payload = circuit.data[0].payload
            if isinstance(payload, mps_core.MPS):
                if payload.chi != chi:
                    raise ValueError("cached MPS chi mismatch")
                return payload
            return mps_core.from_qiskit_mps(payload, chi, **kw)
        if circuit.data and circuit.data[0].name == "set_statevector":
            return mps_core.from_dense(circuit.data[0].payload, chi, **kw)
        return mps_core.zero_mps(n, chi, **kw)

    def run_tape(self, state, tape: Tape):
        out = mps_core.apply_tape(state, tape.kinds, tape.q0, tape.q1,
                                  tape.angles, self.truncation_threshold)
        if self.mps_log_data:
            logger.info("mps_log_data: accumulated discarded Schmidt weight "
                        f"= {float(out.trunc):.3e} (chi={out.chi})")
        return out

    def run_tape_adjoint(self, state, tape: Tape):
        return mps_core.apply_tape_adjoint(state, tape.kinds, tape.q0,
                                           tape.q1, tape.angles,
                                           self.truncation_threshold)

    def state_of(self, compiler):
        return compiler._current_state()

    def sweep_engine(self):
        return mps_core.sweep_engine(self.truncation_threshold)

    def zero_ref(self, compiler):
        n = compiler.full_circuit.num_qubits
        return mps_core.zero_mps(n, self.chi_for(n), self.dtype, self.device)

    # ----------------------------------------------------------- cost layer
    def evaluate_global_cost(self, compiler):
        """1 - |<0|psi>|^2 / <psi|psi> (aer_mps_backend.py:49-57 on the
        normalised state: long float32 chains drift in scale, not
        direction)."""
        if compiler.soften_global_cost:
            raise NotImplementedError(
                "soften_global_cost is not ported yet (ROADMAP.md)")
        return float(mps_core.global_cost_normalized(self.state_of(compiler)))

    def evaluate_local_cost(self, compiler):
        evals = self.measure_qubit_expectation_values(compiler)
        return float(0.5 * (1 - np.mean(evals)))

    def evaluate_circuit(self, compiler):
        return self.state_of(compiler)

    def measure_qubit_expectation_values(self, compiler):
        state = self.state_of(compiler)
        return mps_core.z_expectations(state).cpu().numpy().tolist()

    def mps_from_compiler_target(self, circuit: Circuit, start_state=None):
        """Simulate a target circuit into an engine MPS (the reference's
        mps_from_circuit precompute)."""
        n = circuit.num_qubits
        state = (start_state if start_state is not None
                 else self.initial_state(circuit, n))
        start = 1 if (circuit.data and circuit.data[0].name in
                      ("set_mps", "set_statevector")) else 0
        tape = compile_tape(circuit, (start, len(circuit.data)))
        return self.run_tape(state, tape)


def mps_backend_with_args(mps_truncation_threshold=DEFAULT_TRUNCATION_THRESHOLD,
                          max_chi=None, mps_log_data=False, device="cpu",
                          dtype=None, **_ignored) -> MPSBackend:
    """mps_sim_with_args analogue (aer_mps_backend.py:27-42)."""
    return MPSBackend(mps_truncation_threshold, max_chi, mps_log_data,
                      device=device, dtype=dtype)
