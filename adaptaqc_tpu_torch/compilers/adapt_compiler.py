"""AdaptCompiler: the ADAPT-AQC adaptive structure-learning loop.

Port of the JAX package's `compilers/adapt_compiler.py` for the MPS compile
path: grow the ansatz one two-qubit block at a time on the pair the
general_gradient heuristic picks, optimise the new block with Rotoselect,
re-optimise a trailing window with Rotosolve, absorb frozen layers into the
cached MPS prefix, and stop on the reference's termination criteria, the
sufficient-cost stop verified by an exact re-simulation.

Not ported yet (ROADMAP.md): the ISL, expectation, basic, random and
brickwall heuristics, checkpoints, profiling, compile_with_chi_schedule,
the initial single-qubit layer and the final BOBYQA minimisation.
"""

from __future__ import annotations

import logging
import timeit

import numpy as np

from ..backends import mps_core, sv_core
from ..backends.backend import AQCBackend
from ..circuits import operations as co
from ..circuits import qasm
from ..circuits.circuit import Circuit
from ..circuits.peephole import remove_unnecessary_gates_from_circuit
from ..circuits.tape import compile_tape
from ..ops import cplx
from ..optim.sinusoidal import has_stopped_improving
from ..utils import ansatzes as ans
from ..utils import constants as vconstants
from ..utils import gradients as gr
from ..utils.constants import CMAP_FULL, generate_coupling_map
from .adapt_config import AdaptConfig
from .adapt_result import AdaptResult
from .approximate_compiler import ApproximateCompiler, _wall_deadline_passed

logger = logging.getLogger(__name__)


class AdaptCompiler(ApproximateCompiler):
    """Structure-learning compiler: incrementally builds a circuit with the
    same action on |0> as the target (adapt_compiler.py:48-53)."""

    def __init__(self, target, backend: AQCBackend, execute_kwargs=None,
                 coupling_map=None, adapt_config: AdaptConfig = None,
                 custom_layer_2q_gate=None, save_circuit_history=False,
                 starting_circuit=None, use_roto_algos=True,
                 use_rotoselect=True, rotosolve_fraction=1.0,
                 optimise_local_cost=False, soften_global_cost=False,
                 start_variant=0):
        super().__init__(target=target, backend=backend,
                         execute_kwargs=execute_kwargs,
                         starting_circuit=starting_circuit,
                         optimise_local_cost=optimise_local_cost,
                         soften_global_cost=soften_global_cost,
                         rotosolve_fraction=rotosolve_fraction,
                         start_variant=start_variant)
        self.save_circuit_history = save_circuit_history
        self.adapt_config = (adapt_config if adapt_config is not None
                             else AdaptConfig())
        if self.adapt_config.method != "general_gradient":
            raise NotImplementedError(
                f"pair heuristic {self.adapt_config.method!r} is not ported "
                "yet; use method='general_gradient' (ROADMAP.md)")
        if not use_roto_algos:
            raise NotImplementedError(
                "only the Rotoselect/Rotosolve optimisers are ported")
        if coupling_map is None:
            coupling_map = generate_coupling_map(self.total_num_qubits,
                                                 CMAP_FULL, False, False)
        self.use_roto_algos = use_roto_algos
        self.use_rotoselect = use_rotoselect
        if not self.use_rotoselect and (
                custom_layer_2q_gate is None
                or co.are_circuits_identical(custom_layer_2q_gate,
                                             ans.thinly_dressed_cnot())
                or co.are_circuits_identical(custom_layer_2q_gate,
                                             ans.identity_resolvable())):
            logger.warning("Rotoselect is necessary for convergence of "
                           "chosen ansatz")
        self.layer_2q_gate = self.construct_layer_2q_gate(custom_layer_2q_gate)
        self.coupling_map = co.remove_permutations_from_coupling_map(
            coupling_map)
        self.qubit_pair_history = []
        self.pair_selection_method_history = []
        self.general_gradient_history = []
        self.time_taken = None
        self.phase_timings = {"pair_selection": 0.0,
                              "layer_optimisation": 0.0,
                              "window_rotosolve": 0.0, "absorption": 0.0,
                              "verification": 0.0}
        # gates absorbed into the MPS prefix still belong to the solution
        self.layers_saved_to_mps = Circuit(self.full_circuit.num_qubits)
        self.layers_as_gates = []
        self._advance_hint = None
        self._absorption_bias = 0.0
        self._layers_since_verify = 0
        self.generators, self.degeneracies = \
            gr.get_generators_and_degeneracies(self.layer_2q_gate,
                                               use_rotoselect, inverse=True)
        self.inverse_zero_ansatz = gr.zero_ansatz_inverse(self.layer_2q_gate)
        self._gradient_ops = gr.prepare_gradient_ops(self.inverse_zero_ansatz,
                                                     self.generators)

    # ------------------------------------------------------------ layer gate
    def construct_layer_2q_gate(self, custom_layer_2q_gate) -> Circuit:
        """Default: thinly-dressed CNOT (adapt_compiler.py:224-239)."""
        if custom_layer_2q_gate is None:
            qc = Circuit(2)
            co.add_dressed_cnot(qc, 0, 1, True)
            return qc
        qc = custom_layer_2q_gate.copy()
        for instr in qc.data:
            if instr.label is None and instr.name in co.SUPPORTED_1Q_GATES:
                instr.label = instr.name
        return qc

    def get_layer_2q_gate(self, layer_index) -> Circuit:
        qc = self.layer_2q_gate.copy()
        co.add_subscript_to_all_variables(qc, layer_index)
        return qc

    # -------------------------------------------------------------- compile
    def compile(self, initial_ansatz: Circuit = None,
                optimise_initial_ansatz=True) -> AdaptResult:
        """Main adaptive loop (adapt_compiler.py:246-482)."""
        start_time = timeit.default_timer()
        logger.info("ADAPT-AQC started")
        self.time_taken = 0
        self.cost_evaluation_counter = 0
        self.global_cost = None
        self.global_cost_history = []
        self.circuit_history = []
        self.cnot_depth_history = []
        self.g_range = self.variational_circuit_range
        self.layer_times = []
        self.initial_ansatz_already_successful = False
        if initial_ansatz is not None:
            self._add_initial_ansatz(initial_ansatz, optimise_initial_ansatz)

        for layer_count in range(self.adapt_config.max_layers):
            if self.initial_ansatz_already_successful:
                break
            logger.info(f"global cost entering layer: {self.global_cost}")
            t_layer = timeit.default_timer()
            self.global_cost = self._add_layer(layer_count)
            self.layer_times.append(timeit.default_timer() - t_layer)
            self.global_cost_history.append(self.global_cost)
            self.record_cnot_depth()
            num_2q_gates, _ = co.find_num_gates(
                circuit=self.ref_circuit_as_gates,
                gate_range=self.g_range(self.ref_circuit_as_gates))
            if self.save_circuit_history:
                snapshot = co.make_quantum_only_circuit(
                    self.ref_circuit_as_gates)
                snapshot = co.extract_inner_circuit(snapshot,
                                                    (1, len(snapshot.data)))
                self.circuit_history.append(qasm.dumps(snapshot))

            cinl = self.adapt_config.cost_improvement_num_layers
            cit = self.adapt_config.cost_improvement_tol
            if len(self.global_cost_history) >= cinl and has_stopped_improving(
                    self.global_cost_history[-int(cinl):], cit):
                logger.warning("cost plateaued across the improvement "
                               "window; stopping")
                self.compiling_finished = True
                break
            if self._should_verify_threshold():
                t0 = timeit.default_timer()
                verified = self._sufficient_cost_verified()
                self.phase_timings["verification"] += \
                    timeit.default_timer() - t0
                if verified:
                    logger.info("sufficient-cost threshold reached; "
                                "ansatz accepted")
                    self.compiling_finished = True
                    break
            elif num_2q_gates >= self.adapt_config.max_2q_gates:
                logger.warning("2q-gate budget exhausted; one final "
                               "Rotosolve pass")
                self.minimizer.minimize_cost(
                    algorithm_kind=vconstants.ALG_ROTOSOLVE, max_cycles=10,
                    tol=1e-5, stop_val=self.adapt_config.sufficient_cost)
                self.compiling_finished = True
                break
            if _wall_deadline_passed():
                logger.warning("ADAPTAQC_WALL_DEADLINE reached; stopping "
                               "with the best-so-far ansatz")
                self.compiling_finished = True
                break

        # swap in the pure-gate representation for the final cleanup
        self.full_circuit = self.ref_circuit_as_gates
        self.lhs_gate_count = 1  # the set_mps target instruction
        self._invalidate_prefix()
        remove_unnecessary_gates_from_circuit(self.full_circuit, True, True,
                                              gate_range=self.g_range())
        self._invalidate_current()

        if self._verification_applies():
            # the true cost: the working-chi re-simulation both over-reads
            # (absorbed prefix) and under-reads (states it cannot hold)
            final_global_cost = self._true_cost_of_gate_circuit(
                self.full_circuit)
        else:
            final_global_cost = self.backend.evaluate_global_cost(self)
        logger.info(f"Final global cost: {final_global_cost}")
        self.global_cost_history.append(final_global_cost)
        state = self.backend.state_of(self)
        mps_truncated_weight = self.backend.truncated_weight(state)
        noise_floor = 1e4 * float(np.finfo(
            state.lam.cpu().numpy().dtype).eps)
        if mps_truncated_weight > noise_floor:
            logger.warning(
                "MPS truncation discarded relative Schmidt weight "
                f"{mps_truncated_weight:.3e} during this compile: "
                f"max_chi={self.backend.max_chi} or the truncation "
                "threshold is binding; overlaps may be inaccurate.")
        compiled_circuit = self.get_compiled_circuit()
        num_2q_gates, num_1q_gates = co.find_num_gates(compiled_circuit)
        self.cnot_depth_history.append(
            compiled_circuit.multi_qubit_gate_depth())

        result = AdaptResult(
            circuit=compiled_circuit,
            overlap=1 - final_global_cost,
            exact_overlap="Not computable without SV backend",
            num_1q_gates=num_1q_gates,
            num_2q_gates=num_2q_gates,
            cnot_depth_history=self.cnot_depth_history,
            global_cost_history=self.global_cost_history,
            local_cost_history=None,
            circuit_history=self.circuit_history,
            entanglement_measures_history=[],
            e_val_history=[],
            qubit_pair_history=self.qubit_pair_history,
            method_history=self.pair_selection_method_history,
            time_taken=timeit.default_timer() - start_time,
            cost_evaluations=self.cost_evaluation_counter,
            coupling_map=self.coupling_map,
            circuit_qasm=qasm.dumps(co.make_quantum_only_circuit(
                compiled_circuit)),
        )
        result.mps_truncated_weight = mps_truncated_weight
        result.phase_timings = dict(self.phase_timings)
        result.layer_times = list(self.layer_times)  # wall s per layer
        logger.info("ADAPT-AQC completed")
        return result

    # --------------------------------------------------------- MPS reference
    @property
    def ref_circuit_as_gates(self) -> Circuit:
        """Pure-gate view of the full circuit: absorbed layers re-expanded
        after the set_mps target instruction (adapt_compiler.py:708-715)."""
        qc = Circuit(self.full_circuit.num_qubits,
                     self.full_circuit.num_clbits)
        qc.data.append(self._target_instruction.copy())
        co.add_to_circuit(qc, self.layers_saved_to_mps)
        rest = co.extract_inner_circuit(self.full_circuit,
                                        (1, len(self.full_circuit.data)))
        co.add_to_circuit(qc, rest)
        return qc

    @property
    def _target_instruction(self):
        if not hasattr(self, "_orig_target_instr"):
            self._orig_target_instr = self.circuit_to_compile.data[0].copy()
        return self._orig_target_instr

    # -------------------------------------------------------- initial ansatz
    def _add_initial_ansatz(self, initial_ansatz, optimise_initial_ansatz):
        """adapt_compiler.py:536-583."""
        initial_ansatz = initial_ansatz.copy()
        for instr in initial_ansatz.data:
            if instr.label is None and instr.name in co.SUPPORTED_1Q_GATES:
                instr.label = instr.name
        co.add_to_circuit(self.full_circuit,
                          co.circuit_by_inverting_circuit(initial_ansatz),
                          self.variational_circuit_range()[1])
        self._invalidate_current()
        if optimise_initial_ansatz:
            cost = self.minimizer.minimize_cost(
                algorithm_kind=vconstants.ALG_ROTOSOLVE, tol=1e-3,
                stop_val=self.adapt_config.sufficient_cost,
                indexes_to_modify=self.variational_circuit_range())
        else:
            cost = self.evaluate_cost()
        self.global_cost = cost
        if self.global_cost < self.adapt_config.sufficient_cost:
            self.initial_ansatz_already_successful = True
        gates_absorbed = self._absorb_n_gates_into_mps(len(initial_ansatz.data))
        co.add_to_circuit(self.layers_saved_to_mps, gates_absorbed)

    # ------------------------------------------------------------- add layer
    def _add_layer(self, index):
        """adapt_compiler.py:585-689."""
        ansatz_start_index = self.variational_circuit_range()[0]
        layer_indexes = self._add_entangling_layer(index)
        stop_val = self.adapt_config.sufficient_cost
        alg = (vconstants.ALG_ROTOSELECT if self.use_rotoselect
               else vconstants.ALG_ROTOSOLVE)
        t0 = timeit.default_timer()
        cost = self.minimizer.minimize_cost(
            algorithm_kind=alg, tol=self.adapt_config.rotoselect_tol,
            stop_val=stop_val, indexes_to_modify=layer_indexes)
        self.phase_timings["layer_optimisation"] += timeit.default_timer() - t0
        freq = self.adapt_config.rotosolve_frequency
        if freq != 0 and index > 0 and index % freq == 0:
            multi_indexes = self._calculate_multi_layer_optimisation_indices(
                ansatz_start_index)
            t0 = timeit.default_timer()
            cost = self.minimizer.minimize_cost(
                algorithm_kind=vconstants.ALG_ROTOSOLVE,
                tol=self.adapt_config.rotosolve_tol, stop_val=stop_val,
                indexes_to_modify=multi_indexes)
            self.phase_timings["window_rotosolve"] += \
                timeit.default_timer() - t0

        t0 = timeit.default_timer()
        self.layers_as_gates.append(index)
        num_to_absorb = self._calculate_num_layers_to_absorb(index)
        if num_to_absorb > 0:
            num_gates = len(self.layer_2q_gate.data) * num_to_absorb
            gates_absorbed = self._absorb_n_gates_into_mps(num_gates)
            co.add_to_circuit(self.layers_saved_to_mps, gates_absorbed)
            del self.layers_as_gates[:num_to_absorb]
        self.phase_timings["absorption"] += timeit.default_timer() - t0
        return cost

    def _calculate_num_layers_to_absorb(self, index):
        """adapt_compiler.py:691-706."""
        freq = self.adapt_config.rotosolve_frequency
        if freq == 0:
            lowest_index = index
        else:
            next_rotosolve_layer = index + freq - index % freq
            lowest_index = (next_rotosolve_layer
                            - self.adapt_config.max_layers_to_modify + 1)
        return len([i for i in self.layers_as_gates if i < lowest_index])

    def _calculate_multi_layer_optimisation_indices(self, ansatz_start_index):
        """adapt_compiler.py:717-741."""
        start = max(ansatz_start_index,
                    self.variational_circuit_range()[1]
                    - len(self.layer_2q_gate.data)
                    * self.adapt_config.max_layers_to_modify)
        return (start, self.variational_circuit_range()[1])

    def _add_entangling_layer(self, index):
        """adapt_compiler.py:743-759."""
        t0 = timeit.default_timer()
        control, target = self._find_appropriate_qubit_pair()
        self.phase_timings["pair_selection"] += timeit.default_timer() - t0
        logger.debug(f"selected pair {(control, target)}")
        insert_at = self.variational_circuit_range()[1]
        self._stash_advance_hint(insert_at)
        co.add_to_circuit(self.full_circuit, self.get_layer_2q_gate(index),
                          insert_at, qubit_subset=[control, target])
        self._invalidate_current()
        self.qubit_pair_history.append((control, target))
        end = self.variational_circuit_range()[1]
        return (end - len(self.layer_2q_gate.data), end)

    # ---------------------------------------------------- verified stopping
    # how close (in units of sufficient_cost) the in-loop estimate must be
    # before periodic verification starts, and layers between checks
    _VERIFY_BAND = 3.0
    _VERIFY_EVERY = 20

    def _verification_applies(self) -> bool:
        return not self.optimise_local_cost and not self.soften_global_cost

    def _should_verify_threshold(self) -> bool:
        """The chi-capped in-loop cost is a biased estimate of the true
        cost, of either sign: verify when it clears threshold + the last
        measured bias, or periodically while within _VERIFY_BAND x the
        threshold; at most every 5 layers."""
        if not self._verification_applies():
            return self.global_cost < self.adapt_config.sufficient_cost
        sufficient = self.adapt_config.sufficient_cost
        self._layers_since_verify += 1
        if self._layers_since_verify < 5:
            return False
        if self.global_cost < sufficient - self._absorption_bias:
            return True
        return (self.global_cost < self._VERIFY_BAND * sufficient
                and self._layers_since_verify >= self._VERIFY_EVERY)

    def _sufficient_cost_verified(self) -> bool:
        """Accept the sufficient-cost stop only if the true cost of the
        cleaned ansatz, re-simulated from the original target at twice the
        working chi, clears the threshold; otherwise remember the estimate's
        bias."""
        exact = self._true_cost_of_cleaned_circuit()
        self.cost_evaluation_counter += 1
        self._layers_since_verify = 0
        if exact < self.adapt_config.sufficient_cost:
            self.global_cost = exact
            return True
        self._absorption_bias = exact - self.global_cost
        logger.info(
            f"in-loop cost estimate {self.global_cost:.3e} vs true "
            f"(chi-doubled, cleaned) cost {exact:.3e}; continuing")
        return False

    def _true_cost_of_cleaned_circuit(self) -> float:
        qc = self.ref_circuit_as_gates.copy()
        remove_unnecessary_gates_from_circuit(
            qc, True, True, gate_range=(1, len(qc.data) - self.rhs_gate_count))
        return self._true_cost_of_gate_circuit(qc)

    def _true_cost_of_gate_circuit(self, qc) -> float:
        """1 - |<target|(gates)^dag|0>|^2 at twice the working bond
        dimension, normalised by both norms, on the native eigh
        (verification must not share the sweep path's eigensolver)."""
        n = qc.num_qubits
        verify_chi = min(2 * self.backend.chi_for(n), 2 ** ((n + 1) // 2))
        kw = dict(dtype=self.backend.dtype, device=self.backend.device)
        with cplx.verification_eigh():
            payload = qc.data[0].payload
            if qc.data[0].name == "set_statevector":
                target = mps_core.from_dense(payload, verify_chi, **kw)
            elif isinstance(payload, mps_core.MPS):
                target = mps_core.pad_chi(payload, verify_chi)
            else:
                target = mps_core.from_qiskit_mps(payload, verify_chi, **kw)
            state = mps_core.zero_mps(n, verify_chi, **kw)
            if len(qc.data) > 1:
                tape = compile_tape(qc, (1, len(qc.data)))
                state = mps_core.apply_tape_adjoint(
                    state, tape.kinds, tape.q0, tape.q1, tape.angles,
                    self.backend.truncation_threshold)
            nrm2 = float(mps_core.mps_dot(state, state).real)
            tnrm2 = float(mps_core.mps_dot(target, target).real)
            ov = mps_core.mps_dot(state, target)
            ov2 = float(ov.real ** 2 + ov.imag ** 2)
            return 1.0 - ov2 / max(nrm2 * tnrm2, 1e-30)

    def _stash_advance_hint(self, insert_at):
        """Hand the optimiser the engine state of full_circuit.data[:insert_at]
        by peeling the trailing 1q starting-circuit gates off the cached full
        state (exact: 1q adjoints truncate nothing)."""
        self._advance_hint = None
        if self._current_cache is None:
            return
        if self.rhs_gate_count == 0:
            self._advance_hint = (insert_at, self._current_cache)
            return
        rhs_rng = (len(self.full_circuit.data) - self.rhs_gate_count,
                   len(self.full_circuit.data))
        if insert_at != rhs_rng[0]:
            return
        rhs_tape = compile_tape(self.full_circuit, rhs_rng)
        if np.any(sv_core.two_qubit_mask(rhs_tape.kinds)):
            return
        self._advance_hint = (insert_at, self.backend.run_tape_adjoint(
            self._current_cache, rhs_tape))

    # --------------------------------------------------------- pair selection
    def _find_appropriate_qubit_pair(self):
        gradients = self._get_all_qubit_pair_gradients()
        self.general_gradient_history.append(gradients)
        self.pair_selection_method_history.append("general_gradient")
        priorities = self._get_all_qubit_pair_reuse_priorities(
            self.adapt_config.reuse_exponent)
        combined = np.multiply(gradients, priorities)
        return self.coupling_map[int(np.argmax(combined))]

    def _get_all_qubit_pair_gradients(self):
        """Batched pair-gradient scoring (adapt_compiler.py:839-856 +
        gradients.py:23-124)."""
        psi = self._state_without_starting_circuit()
        return gr.general_grad_of_pairs_device(
            psi, self.starting_circuit, self._gradient_ops,
            self.degeneracies, self.coupling_map, self.backend,
            self.full_circuit.num_qubits)

    def _state_without_starting_circuit(self):
        """Engine state of full_circuit minus the trailing starting-circuit
        inverse (gradients want |psi> = V(theta)^dag U |0>)."""
        if self.rhs_gate_count == 0:
            return self._current_state()
        rhs_rng = (len(self.full_circuit.data) - self.rhs_gate_count,
                   len(self.full_circuit.data))
        rhs_tape = compile_tape(self.full_circuit, rhs_rng)
        if self._current_cache is not None and not np.any(
                sv_core.two_qubit_mask(rhs_tape.kinds)):
            return self.backend.run_tape_adjoint(self._current_cache,
                                                 rhs_tape)
        state = self._prefix_state()
        rng = (self.lhs_gate_count,
               len(self.full_circuit.data) - self.rhs_gate_count)
        if rng[1] > rng[0]:
            state = self.backend.run_tape(
                state, compile_tape(self.full_circuit, rng))
        return state

    def _get_all_qubit_pair_reuse_priorities(self, k):
        """adapt_compiler.py:984-998."""
        if not len(self.qubit_pair_history):
            return [1 for _ in range(len(self.coupling_map))]
        mode = self.adapt_config.reuse_priority_mode
        if mode not in ("pair", "qubit"):
            raise ValueError("Reuse priority mode must be one of: "
                             "['pair', 'qubit']")
        fn = (self._get_pair_reuse_priority if mode == "pair"
              else self._get_qubit_reuse_priority)
        return [fn(qp, k) for qp in self.coupling_map]

    @staticmethod
    def _find_last_use_of_qubit(qubit_pairs, qubit):
        for index, tup in enumerate(qubit_pairs):
            if qubit in tup:
                return index
        return np.inf

    def _get_qubit_reuse_priority(self, qubit_pair, k):
        """adapt_compiler.py:1006-1035."""
        if self.qubit_pair_history and qubit_pair == self.qubit_pair_history[-1]:
            return -1
        if k == 0:
            return 1
        reversed_pairs = self.qubit_pair_history[::-1]
        locs = [self._find_last_use_of_qubit(reversed_pairs, q)
                for q in qubit_pair]
        return np.min([1 - np.exp2(-(loc + 1) / k) for loc in locs])

    def _get_pair_reuse_priority(self, qubit_pair, k):
        """adapt_compiler.py:1037-1065."""
        if self.qubit_pair_history and qubit_pair == self.qubit_pair_history[-1]:
            return -1
        if k == 0:
            return 1
        reversed_pairs = self.qubit_pair_history[::-1]
        try:
            return 1 - np.exp2(-reversed_pairs.index(qubit_pair) / k)
        except ValueError:
            return 1

    # ------------------------------------------------------------ absorption
    def _absorb_n_gates_into_mps(self, n) -> Circuit:
        """Advance the cached MPS prefix past the first n variational gates
        and replace them by one set_mps instruction
        (adapt_compiler.py:1097-1145)."""
        if n <= 0:
            return Circuit(self.full_circuit.num_qubits)
        rng = (self.lhs_gate_count, self.lhs_gate_count + n)
        gates_absorbed = co.extract_inner_circuit(self.full_circuit, rng)
        new_prefix = self.backend.run_tape(
            self._prefix_state(), compile_tape(self.full_circuit, rng))
        co.remove_inner_circuit(self.full_circuit, (0, rng[1]))
        marker = Circuit(self.full_circuit.num_qubits)
        marker.set_mps(new_prefix)
        self.full_circuit.data.insert(0, marker.data[0])
        self.lhs_gate_count = 1
        # the state of the whole circuit is unchanged: keep its cache
        current = self._current_cache
        self._invalidate_prefix()
        self._prefix_cache = (self.lhs_gate_count, new_prefix)
        self._current_cache = current
        return gates_absorbed

    def record_cnot_depth(self):
        """adapt_compiler.py:1147-1163."""
        ref = self.ref_circuit_as_gates
        ansatz = co.extract_inner_circuit(ref, (1, len(ref.data)))
        self.cnot_depth_history.append(ansatz.multi_qubit_gate_depth())
