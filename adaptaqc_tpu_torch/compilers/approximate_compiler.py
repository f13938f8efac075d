"""ApproximateCompiler: full-circuit construction, state caches, cost layer
and solution extraction.

Port of the JAX package's `compilers/approximate_compiler.py`, MPS path
only. The full circuit is the reference's (:435-512):
|0> -> [target U] -> (variational V^dag grows here) -> [starting_circuit^-1];
the cost is the probability of returning to |0...0>. The target is simulated
once into an engine MPS; every cost query applies the variational tape to
that cached prefix. compile_in_parts and the statevector / sampling
backends are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import logging
import os
import time
from abc import ABC, abstractmethod

from ..backends import mps_core
from ..backends.backend import AQCBackend, MPSBackend
from ..circuits import operations as co
from ..circuits.circuit import Circuit, unroll_to_basis_gates
from ..circuits.tape import compile_tape
from ..optim.minimiser import CostMinimiser

logger = logging.getLogger(__name__)


def _wall_deadline_passed() -> bool:
    """Optional wall-clock stop for time-boxed runs:
    ADAPTAQC_WALL_DEADLINE=<unix epoch seconds>. Once passed, layer loops
    stop with the best-so-far ansatz so cleanup and result building still
    run. A value that does not parse as a number is ignored with a
    warning."""
    ddl = os.environ.get("ADAPTAQC_WALL_DEADLINE")
    if not ddl:
        return False
    try:
        deadline = float(ddl)
    except ValueError:
        logger.warning(f"ignoring ADAPTAQC_WALL_DEADLINE={ddl!r}: not a "
                       "number of epoch seconds")
        return False
    return time.time() >= deadline


class ApproximateCompiler(ABC):
    """Variational compiler base (approximate_compiler.py:64)."""

    def __init__(self, target, backend: AQCBackend, execute_kwargs=None,
                 starting_circuit=None, optimise_local_cost=False,
                 soften_global_cost=False, rotosolve_fraction=1.0,
                 start_variant=0):
        if not isinstance(backend, MPSBackend):
            raise NotImplementedError(
                "only MPSBackend is ported yet (ROADMAP.md)")
        self.target = target
        self.start_variant = int(start_variant)
        self.original_circuit_classical_ops = None
        self.gate_circuit_to_compile = None
        self.backend = backend
        self.is_statevector_backend = False
        self.is_mps_backend = True
        self.circuit_to_compile = self.prepare_circuit()
        self.execute_kwargs = dict(execute_kwargs or {})
        self.total_num_qubits = self.circuit_to_compile.num_qubits
        self.qubit_subset_to_compile = list(range(self.total_num_qubits))
        self.general_initial_state = False
        self.starting_circuit = self.prepare_starting_circuit(starting_circuit)
        self.optimise_local_cost = optimise_local_cost
        self.soften_global_cost = soften_global_cost

        (self.full_circuit, self.lhs_gate_count,
         self.rhs_gate_count) = self._prepare_full_circuit()

        if not 0 < rotosolve_fraction <= 1:
            raise ValueError("rotosolve_fraction must be in the range (0,1]")
        self.minimizer = CostMinimiser(self.evaluate_cost,
                                       self.variational_circuit_range, self,
                                       rotosolve_fraction)
        self.cost_evaluation_counter = 0
        self.compiling_finished = False
        self._prefix_cache = None   # (lhs_count, engine state)
        self._current_cache = None

    # --------------------------------------------------------- construction
    def prepare_circuit(self) -> Circuit:
        """Target -> a set_mps circuit holding the target's engine MPS."""
        if mps_core.check_mps(self.target):
            n = (self.target.n if isinstance(self.target, mps_core.MPS)
                 else len(self.target[0]))
            qc = Circuit(n)
            qc.set_mps(self.target)
            return qc
        target_copy = self.target.copy()
        self.original_circuit_classical_ops = co.remove_classical_operations(
            target_copy)
        prepared = unroll_to_basis_gates(target_copy)
        self.gate_circuit_to_compile = prepared
        logger.info("Pre-computing target circuit as MPS")
        qc = Circuit(prepared.num_qubits)
        qc.set_mps(self.backend.mps_from_compiler_target(prepared))
        return qc

    def prepare_starting_circuit(self, starting_circuit):
        if starting_circuit is None or isinstance(starting_circuit, Circuit):
            return starting_circuit
        if starting_circuit in ("tenpy_product_state", "product_state"):
            from ..utils.compression import best_product_state_circuit
            return best_product_state_circuit(self)
        raise ValueError("starting_circuit must be a Circuit, None, or the "
                         "string 'tenpy_product_state'")

    def _prepare_full_circuit(self):
        qc = Circuit(self.total_num_qubits)
        co.add_to_circuit(qc, self.circuit_to_compile,
                          qubit_subset=self.qubit_subset_to_compile)
        lhs_gate_count = len(qc.data)
        if self.starting_circuit is not None:
            co.add_to_circuit(qc, self.starting_circuit.inverse())
        rhs_gate_count = len(qc.data) - lhs_gate_count
        return qc, lhs_gate_count, rhs_gate_count

    # ------------------------------------------------------- state plumbing
    def _prefix_state(self):
        """Engine state after full_circuit.data[:lhs_gate_count], cached."""
        if (self._prefix_cache is not None
                and self._prefix_cache[0] == self.lhs_gate_count):
            return self._prefix_cache[1]
        qc = self.full_circuit
        state = self.backend.initial_state(qc, qc.num_qubits)
        start = 1 if (qc.data and qc.data[0].name in
                      ("set_mps", "set_statevector")) else 0
        if self.lhs_gate_count > start:
            state = self.backend.run_tape(
                state, compile_tape(qc, (start, self.lhs_gate_count)))
        self._prefix_cache = (self.lhs_gate_count, state)
        return state

    def _invalidate_prefix(self):
        self._prefix_cache = None
        self._current_cache = None

    def _invalidate_current(self):
        self._current_cache = None

    def _current_state(self):
        """Engine state of the whole full_circuit, cached until mutation."""
        if self._current_cache is not None:
            return self._current_cache
        state = self._prefix_state()
        rng = (self.lhs_gate_count, len(self.full_circuit.data))
        if rng[1] > rng[0]:
            state = self.backend.run_tape(
                state, compile_tape(self.full_circuit, rng))
        self._current_cache = state
        return state

    # ------------------------------------------------------------ cost layer
    def variational_circuit_range(self, circuit=None):
        if circuit is None:
            circuit = self.full_circuit
        return self.lhs_gate_count, len(circuit.data) - self.rhs_gate_count

    def evaluate_cost(self):
        self.cost_evaluation_counter += 1
        if self.optimise_local_cost:
            return self.backend.evaluate_local_cost(self)
        return self.backend.evaluate_global_cost(self)

    @abstractmethod
    def compile(self):
        raise NotImplementedError

    # --------------------------------------------------------------- results
    def get_compiled_circuit(self) -> Circuit:
        """Invert the optimised ansatz, prepend starting_circuit, restore
        classical ops (approximate_compiler.py:385-433)."""
        compiled = co.circuit_by_inverting_circuit(
            co.extract_inner_circuit(self.full_circuit,
                                     self.variational_circuit_range()))
        if self.starting_circuit is not None:
            co.add_to_circuit(compiled, self.starting_circuit, 0)
        final = Circuit(self.circuit_to_compile.num_qubits,
                        self.circuit_to_compile.num_clbits)
        qubit_map = {full: sub for sub, full in
                     enumerate(self.qubit_subset_to_compile)}
        co.add_to_circuit(final, compiled, qubit_subset=qubit_map)
        if self.original_circuit_classical_ops is not None:
            co.add_classical_operations(final,
                                        self.original_circuit_classical_ops)
        return final
