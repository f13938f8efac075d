"""ApproximateCompiler: full-circuit construction, state caches, cost layer
and solution extraction.

Port of the JAX package's `compilers/approximate_compiler.py`. The full
circuit is the reference's (:435-512):
|0> -> [initial_state] -> [target U] -> (variational V^dag grows here)
-> [initial_state^-1] -> [starting_circuit^-1]; the cost is the probability
of returning to |0...0>. The target prefix is simulated once into an engine
state (statevector or MPS) on the backend's device and cached; every cost
query applies the variational tape to that cached prefix. compile_in_parts
compiles the target's depth blocks as a ladder, each part warm-started from
the one before.
"""

from __future__ import annotations

import logging
import os
import time
import timeit
from abc import ABC, abstractmethod

from ..backends import mps_core, sv_core
from ..backends.backend import (QASM_SIM, AQCBackend, MPSBackend,
                                SamplingBackend, SVBackend)
from ..circuits import operations as co
from ..circuits.circuit import Circuit, unroll_to_basis_gates
from ..circuits.division import vertically_divide_circuit
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


class CompileInPartsResult:
    def __init__(self, circuit, overlap, individual_results, time_taken):
        """
        :param circuit: Resulting circuit.
        :param overlap: 1 - final_global_cost.
        :param individual_results: Result objects of each sub-compilation.
        :param time_taken: Total time taken.
        """
        self.circuit = circuit
        self.overlap = overlap
        self.individual_results = individual_results
        self.time_taken = time_taken


def is_statevector_backend(backend) -> bool:
    return isinstance(backend, SVBackend)


class ApproximateCompiler(ABC):
    """Variational compiler base (approximate_compiler.py:64)."""

    def __init__(self, target, backend: AQCBackend = None,
                 execute_kwargs=None, initial_state=None, qubit_subset=None,
                 general_initial_state=False, starting_circuit=None,
                 optimise_local_cost=False, soften_global_cost=False,
                 rotosolve_fraction=1.0, zigzag=None, start_variant=0,
                 **_compat):
        # _compat: keywords of the reference's other versions, accepted and
        # ignored as the JAX package does
        self.target = target
        self.start_variant = int(start_variant)
        self.original_circuit_classical_ops = None
        self.gate_circuit_to_compile = None
        self.backend = backend if backend is not None else QASM_SIM
        self.is_statevector_backend = is_statevector_backend(self.backend)
        self.is_mps_backend = isinstance(self.backend, MPSBackend)
        if mps_core.check_mps(self.target) and not self.is_mps_backend:
            raise ValueError("MPS backend must be used when target is an MPS")
        self.circuit_to_compile = self.prepare_circuit()
        self.execute_kwargs = self.parse_default_execute_kwargs(
            execute_kwargs)
        self.initial_state_circuit = co.initial_state_to_circuit(
            initial_state)
        self.total_num_qubits = self.calculate_total_num_qubits()
        self.qubit_subset_to_compile = (
            qubit_subset if qubit_subset
            else list(range(self.total_num_qubits)))
        self.general_initial_state = general_initial_state
        self.starting_circuit = self.prepare_starting_circuit(starting_circuit)
        self.optimise_local_cost = optimise_local_cost
        self.soften_global_cost = soften_global_cost

        if initial_state is not None and general_initial_state:
            raise ValueError("Can't compile for general initial state when "
                             "specific initial state is provided")

        (self.full_circuit, self.lhs_gate_count,
         self.rhs_gate_count) = self._prepare_full_circuit()

        if not 0 < rotosolve_fraction <= 1:
            raise ValueError("rotosolve_fraction must be in the range (0,1]")
        self.minimizer = CostMinimiser(self.evaluate_cost,
                                       self.variational_circuit_range, self,
                                       rotosolve_fraction, zigzag=zigzag)
        self.cost_evaluation_counter = 0
        self.compiling_finished = False
        self._prefix_cache = None   # (lhs_count, engine state)
        self._current_cache = None

    # --------------------------------------------------------- construction
    def prepare_circuit(self) -> Circuit:
        """Target -> circuit to compile (approximate_compiler.py:165-217):
        an MPS target, or on an MPS backend the target simulated into an
        engine MPS, becomes one set_mps instruction; otherwise the target's
        gates, unrolled."""
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
        if not self.is_mps_backend:
            return prepared
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

    def parse_default_execute_kwargs(self, execute_kwargs):
        """Shots default to 8192 on a sampling backend (which takes the
        value) and to 1 elsewhere."""
        kwargs = {} if execute_kwargs is None else dict(execute_kwargs)
        sampling = isinstance(self.backend, SamplingBackend)
        if "shots" not in kwargs:
            kwargs["shots"] = 8192 if sampling else 1
        if "optimization_level" not in kwargs:
            kwargs["optimization_level"] = 0
        if sampling:
            self.backend.shots = kwargs["shots"]
        return kwargs

    def calculate_total_num_qubits(self):
        if self.initial_state_circuit is None:
            return self.circuit_to_compile.num_qubits
        return self.initial_state_circuit.num_qubits

    def _prepare_full_circuit(self):
        """approximate_compiler.py:435-512."""
        total_qubits = (2 * self.total_num_qubits if self.general_initial_state
                        else self.total_num_qubits)
        qc = Circuit(total_qubits)
        if self.initial_state_circuit is not None:
            co.add_to_circuit(qc,
                              unroll_to_basis_gates(self.initial_state_circuit))
        elif self.general_initial_state:
            for qubit in range(self.total_num_qubits):
                qc.h(qubit)
                qc.cx(qubit, qubit + self.total_num_qubits)

        co.add_to_circuit(qc, self.circuit_to_compile,
                          qubit_subset=self.qubit_subset_to_compile)
        lhs_gate_count = len(qc.data)

        if self.initial_state_circuit is not None:
            isc = unroll_to_basis_gates(self.initial_state_circuit)
            co.add_to_circuit(qc, isc.inverse())
        if self.starting_circuit is not None:
            co.add_to_circuit(qc, self.starting_circuit.inverse())
        elif self.general_initial_state:
            for qubit in range(self.total_num_qubits - 1, -1, -1):
                qc.cx(qubit, qubit + self.total_num_qubits)
                qc.h(qubit)

        if isinstance(self.backend, SamplingBackend):
            # measures are implicit: the sampling backend samples the final
            # state directly (the reference appends measure gates, :502-508)
            qc.num_clbits = 1 if self.optimise_local_cost else total_qubits

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

    def ansatz_range(self):
        return self.lhs_gate_count, len(self.full_circuit.data)

    def _starting_circuit_range(self):
        end = len(self.full_circuit.data)
        return end - self.rhs_gate_count, end

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

    def compile_in_parts(self, max_depth_per_block=10, initial_ansatz=None,
                         start_part=0, part_callback=None,
                         reoptimise_carried="auto") -> CompileInPartsResult:
        """Ladder compilation (approximate_compiler.py:321-331): part k
        approximately compiles the first k depth blocks of the target,
        warm-started from part k-1's solution. The cumulative block prefix
        is simulated incrementally into the engine target state, and each
        part is a fresh compile of that prefix (on this compiler's backend,
        so on its device and in its dtype) with the carried solution passed
        as initial_ansatz.

        start_part=k resumes a ladder: blocks 0..k-1 are not compiled (their
        gates still extend the target prefix) and part k starts from
        initial_ansatz, the saved solution of an earlier run's part k-1.
        part_callback(i, result, circuit) fires after each part, so that a
        caller can save the carried solution.

        reoptimise_carried: both engines freeze the carried ansatz right
        after it is added, so only its one whole-range Rotosolve can move
        carried angles, and at large n that pass chases a chi-capped
        estimate and can destroy the fidelity part k-1 had.
          "never"   carried angles stay; the new layers learn the new block.
          "always"  the whole-range re-optimisation.
          "auto"    (default) freeze first; if the part's verified overlap
                    misses the sufficient threshold, compile that part once
                    more with the whole-range re-optimisation and keep the
                    better result."""
        logger.info("Started partial recompilation")
        start_time = timeit.default_timer()
        # the gate-level target is divided: on an MPS backend
        # circuit_to_compile is the set_mps wrapper, which has no depth
        gate_target = self.gate_circuit_to_compile
        if gate_target is None:
            raise ValueError(
                "compile_in_parts needs a gate-level target circuit; an MPS "
                "target has no depth structure to divide into blocks")
        all_subcircuits = vertically_divide_circuit(
            gate_target.copy(), max_depth_per_block)
        logger.info(f"Circuit was split into {len(all_subcircuits)} parts to "
                    "compile sequentially")
        if not 0 <= start_part < len(all_subcircuits):
            raise ValueError(
                f"start_part {start_part} out of range for "
                f"{len(all_subcircuits)}-part division")
        if start_part > 0 and initial_ansatz is None:
            raise ValueError("resuming at start_part > 0 requires the "
                             "previous run's carried solution as "
                             "initial_ansatz")

        prefix = Circuit(gate_target.num_qubits)  # cumulative gate prefix
        prefix_state = None  # the target MPS, extended block by block
        last_compiled = None
        individual_results = []
        for i, subcircuit in enumerate(all_subcircuits):
            co.add_to_circuit(prefix, subcircuit.copy())
            if self.is_mps_backend:
                prefix_state = self.backend.mps_from_compiler_target(
                    subcircuit, start_state=prefix_state)
                part_target = prefix_state
            else:
                part_target = prefix.copy()
            if i < start_part:
                continue  # resumed: an earlier run compiled this block
            warm_start = last_compiled
            if warm_start is None:
                warm_start = (initial_ansatz if initial_ansatz is not None
                              else self.starting_circuit)
            carried = warm_start is not None and i > 0
            freeze_first = carried and reoptimise_carried in ("auto", "never")
            result = self._clone_with_target(part_target).compile(
                initial_ansatz=warm_start,
                optimise_initial_ansatz=not freeze_first)
            if (freeze_first and reoptimise_carried == "auto"
                    and result.overlap < self._part_overlap_target()
                    and not _wall_deadline_passed()):
                logger.info(
                    f"part {i}: frozen-carried attempt ended at verified "
                    f"overlap {result.overlap:.4f} < target; widening to a "
                    f"whole-range re-optimisation of the carried ansatz")
                retry = self._clone_with_target(part_target).compile(
                    initial_ansatz=warm_start, optimise_initial_ansatz=True)
                if retry.overlap > result.overlap:
                    result = retry
            last_compiled = result.circuit
            result.circuit = None
            individual_results.append(result)
            logger.info(f"Completed {100 * (i + 1) / len(all_subcircuits)}% "
                        "of recompilation")
            if part_callback is not None:
                part_callback(i, result, last_compiled)

        return CompileInPartsResult(
            circuit=last_compiled,
            overlap=calculate_overlap_between_circuits(
                last_compiled, gate_target, self.initial_state_circuit,
                self.qubit_subset_to_compile, device=self.backend.device,
                dtype=self.backend.dtype),
            individual_results=individual_results,
            time_taken=timeit.default_timer() - start_time)

    def _clone_with_target(self, target):
        """A fresh compiler of the same configuration for one ladder part;
        a subclass keeps its construction arguments to implement this."""
        raise NotImplementedError(
            "compile_in_parts requires the compiler to implement "
            "_clone_with_target")

    def _part_overlap_target(self) -> float:
        """The verified overlap a ladder part must reach before "auto"
        skips the carried ansatz's re-optimisation (1 - sufficient_cost for
        ADAPT compilers, 0.99 otherwise)."""
        cfg = getattr(self, "adapt_config", None)
        return 1.0 - (cfg.sufficient_cost if cfg is not None else 1e-2)


# Above this, a dense 2^n statevector no longer fits and overlaps switch to
# the MPS engine (the reference's dense-only helper, full_circuit.py:413-438,
# cannot evaluate 50-qubit results).
DENSE_OVERLAP_MAX_QUBITS = 26


def calculate_overlap_between_circuits(circuit1: Circuit, circuit2: Circuit,
                                       initial_state=None, qubit_subset=None,
                                       mps_chi: int = 64, device="cuda",
                                       dtype=None):
    """|<psi1|psi2>|^2 (full_circuit.py:413-438), on `device` in `dtype`:
    dense statevectors up to DENSE_OVERLAP_MAX_QUBITS, MPS contraction at
    bond cap `mps_chi` beyond (normalised by both norms: chi well above the
    true rank drifts float32 chains in scale). One device sync."""
    initial_state_circuit = co.initial_state_to_circuit(initial_state)
    if initial_state_circuit is None:
        total = circuit1.num_qubits
    else:
        total = initial_state_circuit.num_qubits
    subset = qubit_subset if qubit_subset else list(range(total))
    kw = dict(dtype=dtype, device=device)

    def build(circ):
        qc = Circuit(total)
        if initial_state_circuit is not None:
            co.add_to_circuit(qc, initial_state_circuit)
        co.add_to_circuit(qc, co.make_quantum_only_circuit(circ),
                          qubit_subset=subset)
        return qc

    def run_dense(qc):
        start = 0
        if qc.data and qc.data[0].name == "set_statevector":
            state = sv_core.state_from_vector(qc.data[0].payload, **kw)
            start = 1
        else:
            state = sv_core.zero_state(total, **kw)
        tape = compile_tape(qc, (start, len(qc.data)))
        return sv_core.apply_tape(state, tape.kinds, tape.q0, tape.q1,
                                  tape.angles)

    def run_mps(qc):
        start = 0
        if qc.data and qc.data[0].name == "set_mps":
            state = mps_core.from_qiskit_mps(qc.data[0].payload, mps_chi, **kw)
            start = 1
        else:
            state = mps_core.zero_mps(total, mps_chi, **kw)
        tape = compile_tape(qc, (start, len(qc.data)))
        return mps_core.apply_tape(state, tape.kinds, tape.q0, tape.q1,
                                   tape.angles, 1e-16)

    if total <= DENSE_OVERLAP_MAX_QUBITS:
        ov = sv_core.overlap(run_dense(build(circuit1)),
                             run_dense(build(circuit2)))
        return float(ov.real ** 2 + ov.imag ** 2)
    m1 = run_mps(build(circuit1))
    m2 = run_mps(build(circuit2))
    n1 = mps_core.mps_dot(m1, m1).real
    n2 = mps_core.mps_dot(m2, m2).real
    ov = mps_core.mps_dot(m1, m2)
    return float((ov.real ** 2 + ov.imag ** 2)
                 / (n1 * n2).clamp(min=1e-30))
