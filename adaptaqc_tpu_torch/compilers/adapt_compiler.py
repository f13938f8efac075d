"""AdaptCompiler: the ADAPT-AQC adaptive structure-learning loop.

Port of the JAX package's `compilers/adapt_compiler.py`: grow the ansatz one
two-qubit block at a time on the pair one of six heuristics picks (ISL
entanglement, expectation, basic, random, general_gradient, brickwall),
optimise the new block with Rotoselect, re-optimise a trailing window with
Rotosolve, and stop on the reference's termination criteria. On an MPS
backend, frozen layers are absorbed into the cached MPS prefix and the
sufficient-cost stop is verified by an exact re-simulation; on a
statevector backend the result carries the exact dense overlap.

With no backend argument, as in the JAX package, the compile runs on
SVBackend() (on the CUDA card) with the ISL heuristic. Under
optimise_local_cost the layers are trained on the local cost by the
full-cost sweep over a capped window, with a periodic global-cost polish by
the O(G) sweep (the hybrid schedule); soften_global_cost trains on the
softened global cost the same way. compile_with_chi_schedule escalates the
working bond dimension over warm-started stages; compile() can write
checkpoints and a loaded checkpoint resumes. With use_roto_algos=False each
layer is optimised by BOBYQA over all variational angles instead of the
Rotoselect/Rotosolve sweeps, and perform_final_minimisation runs one more
BOBYQA over the whole solution before the final cleanup (optim/minimiser.py).
"""

from __future__ import annotations

import contextlib
import logging
import os
import pickle
import time
import timeit
from pathlib import Path

import numpy as np
import torch

from ..backends import mps_core, sv_core
from ..backends.backend import (AQCBackend, MPSBackend, SamplingBackend,
                                SVBackend)
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
from ..utils.entanglement_measures import (
    EM_OBSERVABLE_CONCURRENCE_LOWER_BOUND, EM_TOMOGRAPHY_CONCURRENCE,
    measure_concurrence_lower_bound, measure_from_rdm)
from .adapt_config import AdaptConfig
from .adapt_result import AdaptResult
from .approximate_compiler import (ApproximateCompiler, _wall_deadline_passed,
                                   calculate_overlap_between_circuits)

logger = logging.getLogger(__name__)


class AdaptCompiler(ApproximateCompiler):
    """Structure-learning compiler: incrementally builds a circuit with the
    same action on |0> as the target (adapt_compiler.py:48-53)."""

    def __init__(self, target, entanglement_measure=EM_TOMOGRAPHY_CONCURRENCE,
                 backend: AQCBackend = None, execute_kwargs=None,
                 coupling_map=None, adapt_config: AdaptConfig = None,
                 general_initial_state=False, custom_layer_2q_gate=None,
                 save_circuit_history=False, starting_circuit=None,
                 use_roto_algos=True, use_rotoselect=True,
                 use_advanced_transpilation=False, rotosolve_fraction=1.0,
                 perform_final_minimisation=False, optimise_local_cost=False,
                 soften_global_cost=False, debug_log_full_ansatz=False,
                 initial_single_qubit_layer=False, profile_dir=None,
                 zigzag=None, start_variant=0, **_compat):
        backend = backend if backend is not None else SVBackend()
        super().__init__(target=target, backend=backend,
                         execute_kwargs=execute_kwargs,
                         general_initial_state=general_initial_state,
                         starting_circuit=starting_circuit,
                         optimise_local_cost=optimise_local_cost,
                         soften_global_cost=soften_global_cost,
                         rotosolve_fraction=rotosolve_fraction,
                         zigzag=zigzag, start_variant=start_variant)
        self.save_circuit_history = save_circuit_history
        self.entanglement_measure_method = entanglement_measure
        self.adapt_config = (adapt_config if adapt_config is not None
                             else AdaptConfig())
        if coupling_map is None:
            coupling_map = generate_coupling_map(self.total_num_qubits,
                                                 CMAP_FULL, False, False)
        # custom layer gates may have interdependent gates: no cleanup
        self.remove_unnecessary_gates_during_adapt = custom_layer_2q_gate is None
        self.use_roto_algos = use_roto_algos
        self.perform_final_minimisation = perform_final_minimisation
        self.use_rotoselect = use_rotoselect
        self.use_advanced_transpilation = use_advanced_transpilation
        if not self.use_rotoselect and (
                custom_layer_2q_gate is None
                or co.are_circuits_identical(custom_layer_2q_gate,
                                             ans.thinly_dressed_cnot())
                or co.are_circuits_identical(custom_layer_2q_gate,
                                             ans.identity_resolvable())):
            logger.warning("Rotoselect is necessary for convergence of "
                           "chosen ansatz")
        self.layer_2q_gate = self.construct_layer_2q_gate(custom_layer_2q_gate)
        # avoid re-picking the same (unordered) pair repeatedly
        self.coupling_map = [
            (q1, q2) for (q1, q2) in
            co.remove_permutations_from_coupling_map(coupling_map)
            if q1 in self.qubit_subset_to_compile
            and q2 in self.qubit_subset_to_compile]
        self.qubit_pair_history = []
        self.bad_qubit_pairs = []
        self.pair_selection_method_history = []
        self.entanglement_measures_history = []
        self.e_val_history = []
        self.general_gradient_history = []
        self.time_taken = None
        self.debug_log_full_ansatz = debug_log_full_ansatz
        self.initial_single_qubit_layer = initial_single_qubit_layer
        # a torch.profiler trace of the whole compile goes into profile_dir
        self.profile_dir = profile_dir
        self.phase_timings = {"pair_selection": 0.0,
                              "layer_optimisation": 0.0,
                              "window_rotosolve": 0.0, "absorption": 0.0,
                              "global_polish": 0.0, "verification": 0.0}
        if self.is_mps_backend:
            # gates absorbed into the MPS prefix still belong to the solution
            self.layers_saved_to_mps = Circuit(self.full_circuit.num_qubits)
        self.layers_as_gates = []
        self.resume_from_layer = None
        self.prev_checkpoint_time_taken = None
        self._advance_hint = None
        self._absorption_bias = 0.0
        self._layers_since_verify = 0

        if self.adapt_config.method == "general_gradient":
            if not self.is_mps_backend:
                raise ValueError("general_gradient method is only implemented "
                                 "for the MPS backend")
            self.generators, self.degeneracies = \
                gr.get_generators_and_degeneracies(self.layer_2q_gate,
                                                   use_rotoselect,
                                                   inverse=True)
            self.inverse_zero_ansatz = gr.zero_ansatz_inverse(
                self.layer_2q_gate)
            self._gradient_ops = gr.prepare_gradient_ops(
                self.inverse_zero_ansatz, self.generators)

        if self.soften_global_cost and self.optimise_local_cost:
            raise ValueError("soften_global_cost must be False when "
                             "optimising local cost")

        # construction arguments kept for the clones of compile_in_parts
        # and compile_with_chi_schedule. starting_circuit is left out (the
        # carried solution rides through compile(initial_ansatz=...)), so
        # is profile_dir (no nested traces), and so is the backend (the
        # checkpoint codec stores it by its constructor arguments)
        self._ctor_kwargs = dict(
            entanglement_measure=entanglement_measure,
            execute_kwargs=execute_kwargs, coupling_map=coupling_map,
            adapt_config=adapt_config,
            general_initial_state=general_initial_state,
            custom_layer_2q_gate=custom_layer_2q_gate,
            save_circuit_history=save_circuit_history,
            use_roto_algos=use_roto_algos, use_rotoselect=use_rotoselect,
            use_advanced_transpilation=use_advanced_transpilation,
            rotosolve_fraction=rotosolve_fraction,
            perform_final_minimisation=perform_final_minimisation,
            optimise_local_cost=optimise_local_cost,
            soften_global_cost=soften_global_cost,
            debug_log_full_ansatz=debug_log_full_ansatz,
            initial_single_qubit_layer=initial_single_qubit_layer,
            zigzag=zigzag, start_variant=start_variant)

    def _clone_with_target(self, target, backend=None, starting_circuit=None):
        """A fresh AdaptCompiler with the same construction arguments and a
        new target (a gate circuit or an engine MPS), on this compiler's
        backend unless another is given."""
        return AdaptCompiler(target, backend=backend or self.backend,
                             starting_circuit=starting_circuit,
                             profile_dir=None, **self._ctor_kwargs)

    # --------------------------------------------------------- chi schedule
    def _check_schedule_fits_kernels(self, chis):
        """On a CUDA device the eigensolver and env-chain kernels take a
        bounded bond dimension (ops/dispatch.py REACH: chi <= 8192, the
        env chain's streamed kernel and the eigensolver at m = 2 chi <=
        16384, in complex64 and complex128; their plain versions on the
        CPU have no cap), and a call above it raises: refuse a schedule whose
        stages exceed it before its first stage, not hours into it."""
        if self.backend.device.type != "cuda":
            return
        from ..ops import dispatch
        dt = self.backend.dtype
        env_hi = dispatch.REACH["env"][dt][1]
        eigh_hi = dispatch.REACH["eigh"][dt][1]
        cap = min(env_hi, eigh_hi // 2)
        n = self.full_circuit.num_qubits
        for chi in chis:
            working = min(int(chi), max(2, 2 ** ((n + 1) // 2)))
            if working > cap:
                raise ValueError(
                    f"compile_with_chi_schedule: stage chi={chi} works at "
                    f"bond dimension {working}, above what the CUDA kernels "
                    f"take in {dt} (chi <= {cap}: env_chain chi <= "
                    f"{env_hi}, eigensolver m = 2 chi <= {eigh_hi}), and "
                    f"no other route runs on the card; on device "
                    f"{self.backend.device} the schedule must stay at or "
                    f"below chi={cap}")

    def compile_with_chi_schedule(self, chis=(32, 64, 128),
                                  initial_ansatz=None):
        """Escalating working-precision compile.

        A fixed bond-dimension cap makes the in-loop cost inexact while the
        partially built ansatz entangles above it. This compiles at
        chis[0] and, while the verified sufficient-cost stop has not fired,
        compiles again at each higher chi, warm-started from the previous
        stage's solution: the cheap stages build most of the layers, the
        last only descends the remaining error of the estimate. Stage
        backends are MPSBackends of this backend's threshold, device and
        dtype.

        Returns the last stage's AdaptResult with `cost_evaluations` and
        `time_taken` summed over the stages (the between-stage
        `_overlap_at_chi` walls included), an `independent_overlap` of the
        returned solution against the original target at the schedule's
        last chi, and `chi_schedule`, the stages' (chi, overlap) pairs."""
        if not isinstance(self.backend, MPSBackend):
            raise ValueError("compile_with_chi_schedule requires an "
                             "MPSBackend (chi is its working precision)")
        if not chis:
            raise ValueError("chis must be a non-empty ascending sequence")
        self._check_schedule_fits_kernels(chis)
        sufficient = self.adapt_config.sufficient_cost
        carried = initial_ansatz
        stages, total_evals, total_time, result = [], 0, 0.0, None
        independent = None
        for i, chi in enumerate(chis):
            if i == 0 and chi == self.backend.max_chi:
                stage_compiler = self
            else:
                backend = MPSBackend(
                    self.backend.truncation_threshold, int(chi),
                    self.backend.mps_log_data, device=self.backend.device,
                    dtype=self.backend.dtype, mesh=self.backend.mesh)
                # an engine-MPS target is pinned to its padded chi by
                # MPSBackend.initial_state: bring it to this stage's
                stage_target = self.target
                if isinstance(stage_target, mps_core.MPS):
                    stage_target = mps_core.regauge(
                        stage_target, backend.chi_for(stage_target.n))
                # the user's starting circuit only matters while there is
                # no carried ansatz (stage 1 without a warm start)
                stage_compiler = self._clone_with_target(
                    stage_target, backend=backend,
                    starting_circuit=(self.starting_circuit
                                      if carried is None else None))
            result = stage_compiler.compile(initial_ansatz=carried)
            total_evals += result.cost_evaluations
            total_time += result.time_taken
            stages.append((int(chi), result.overlap))
            logger.info("chi-schedule stage %d/%d (chi=%d): overlap %.6f",
                        i + 1, len(chis), chi, result.overlap)
            carried = result.circuit
            independent = None
            if _wall_deadline_passed() and i < len(chis) - 1:
                logger.warning("ADAPTAQC_WALL_DEADLINE reached; not "
                               "escalating past chi=%d", chi)
                break
            if 1.0 - result.overlap <= sufficient and i < len(chis) - 1:
                # a gate-circuit target is itself simulated at the stage's
                # chi, so a stage at a binding cap can converge against a
                # truncated target: stop escalating only once the solution
                # clears the threshold against the original target at the
                # schedule's last chi
                t0 = time.perf_counter()
                independent = self._overlap_at_chi(result.circuit, chis[-1])
                total_time += time.perf_counter() - t0
                result.independent_overlap = independent
                if 1.0 - independent <= sufficient:
                    logger.info("chi-schedule: stage %d solution clears the "
                                "threshold at chi=%d (overlap %.6f); "
                                "stopping early", i + 1, chis[-1],
                                independent)
                    break
        if independent is None:
            t0 = time.perf_counter()
            independent = self._overlap_at_chi(result.circuit, chis[-1])
            total_time += time.perf_counter() - t0
            result.independent_overlap = independent
        result.cost_evaluations = total_evals
        result.time_taken = total_time
        result.chi_schedule = stages
        return result

    def _overlap_at_chi(self, qc, chi: int) -> float:
        """|<target|qc|0>|^2 with both sides re-simulated from the original
        target at bond dimension chi on the native eigensolver, normalised
        by both norms: independent of what the working chi did to the
        in-loop target."""
        n = qc.num_qubits
        chi = int(min(chi, 2 ** ((n + 1) // 2)))
        thr = self.backend.truncation_threshold
        kw = dict(dtype=self.backend.dtype, device=self.backend.device)

        def simulate(circuit):
            tape = compile_tape(co.make_quantum_only_circuit(circuit))
            return mps_core.apply_tape(
                mps_core.zero_mps(n, chi, **kw), tape.kinds, tape.q0,
                tape.q1, tape.angles, thr)

        with cplx.verification_eigh():
            if isinstance(self.target, mps_core.MPS):
                target = (mps_core.pad_chi(self.target, chi)
                          if chi > self.target.chi else self.target)
            elif mps_core.check_mps(self.target):
                target = mps_core.from_qiskit_mps(self.target, chi, **kw)
            else:
                target = simulate(self.target)
            state = simulate(qc)
            nrm2 = float(mps_core.mps_dot(state, state).real)
            tnrm2 = float(mps_core.mps_dot(target, target).real)
            ov = mps_core.mps_dot(target, state)
            return (float(ov.real ** 2 + ov.imag ** 2)
                    / max(nrm2 * tnrm2, 1e-30))

    # ------------------------------------------------------------ layer gate
    def construct_layer_2q_gate(self, custom_layer_2q_gate) -> Circuit:
        """Default: thinly-dressed CNOT, two of them for a general initial
        state (adapt_compiler.py:224-239)."""
        if custom_layer_2q_gate is None:
            qc = Circuit(2)
            co.add_dressed_cnot(qc, 0, 1, True)
            if self.general_initial_state:
                co.add_dressed_cnot(qc, 0, 1, True, v1=False, v2=False)
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
                optimise_initial_ansatz=True, checkpoint_every=0,
                checkpoint_dir="checkpoint/", delete_prev_chkpt=False,
                freeze_prev_layers=False) -> AdaptResult:
        """Main adaptive loop (adapt_compiler.py:246-482). With
        checkpoint_every > 0 the compiler is pickled into checkpoint_dir
        every that many layers and at the end; a loaded checkpoint resumes
        at its next layer (freeze_prev_layers then freezes what it had).
        With profile_dir set, a torch.profiler trace of the whole compile
        is written there (the JAX package writes a jax.profiler trace)."""
        if self.profile_dir:
            return self._profiled_compile(
                initial_ansatz, optimise_initial_ansatz, checkpoint_every,
                checkpoint_dir, delete_prev_chkpt, freeze_prev_layers)
        return self._compile_impl(initial_ansatz, optimise_initial_ansatz,
                                  checkpoint_every, checkpoint_dir,
                                  delete_prev_chkpt, freeze_prev_layers)

    def _profiled_compile(self, *args) -> AdaptResult:
        """_compile_impl under torch.profiler (the card's activity too when
        the backend is on one); the trace goes into profile_dir as
        compile_<epoch seconds>.pt.trace.json."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.backend.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.profile_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            result = self._compile_impl(*args)
        prof.export_chrome_trace(os.path.join(
            self.profile_dir, f"compile_{int(time.time())}.pt.trace.json"))
        return result

    def _compile_impl(self, initial_ansatz, optimise_initial_ansatz,
                      checkpoint_every, checkpoint_dir, delete_prev_chkpt,
                      freeze_prev_layers) -> AdaptResult:
        start_time = timeit.default_timer()
        if self.resume_from_layer is None:
            start_point = 0
            logger.info("ADAPT-AQC started")
            self.time_taken = 0
            self.cost_evaluation_counter = 0
            self.global_cost, self.local_cost = None, None
            self.global_cost_history = []
            if self.optimise_local_cost:
                self.local_cost_history = []
            self.circuit_history = []
            self.cnot_depth_history = []
            self.g_range = self.variational_circuit_range
            self.original_lhs_gate_count = self.lhs_gate_count
            self.layer_times = []
            if freeze_prev_layers:
                logger.warning("freeze_prev_layers only applies when "
                               "resuming from a checkpoint")
            self.initial_ansatz_already_successful = False
            if initial_ansatz is not None:
                self._add_initial_ansatz(initial_ansatz,
                                         optimise_initial_ansatz)
        else:
            start_point = self.resume_from_layer
            self.time_taken = self.prev_checkpoint_time_taken
            logger.info(f"ADAPT-AQC resuming from layer: {start_point}")
            if initial_ansatz is not None:
                logger.warning("An initial ansatz will be ignored when "
                               "resuming recompilation from a checkpoint")
            if freeze_prev_layers:
                if self.is_mps_backend:
                    num_gates = (len(self.full_circuit.data)
                                 - self.rhs_gate_count - self.lhs_gate_count)
                    gates_absorbed = self._absorb_n_gates_into_mps(num_gates)
                    co.add_to_circuit(self.layers_saved_to_mps,
                                      gates_absorbed)
                else:
                    self.lhs_gate_count = self.variational_circuit_range()[1]
        if checkpoint_every > 0:
            Path(checkpoint_dir).mkdir(parents=True, exist_ok=True)

        # why the layer loop ended: "max_layers" unless a stop below says
        self.stop_reason = "max_layers"
        for layer_count in range(start_point, self.adapt_config.max_layers):
            if self.initial_ansatz_already_successful:
                self.stop_reason = "sufficient_cost"
                break
            logger.info(f"global cost entering layer: {self.global_cost}")
            t_layer = timeit.default_timer()
            if self.optimise_local_cost:
                self.local_cost = self._add_layer(layer_count)
                self.global_cost = self.backend.evaluate_global_cost(self)
                self.local_cost_history.append(self.local_cost)
            else:
                self.global_cost = self._add_layer(layer_count)
            self.layer_times.append(timeit.default_timer() - t_layer)
            self.global_cost_history.append(self.global_cost)
            self.record_cnot_depth()
            self._log_full_ansatz()

            # the MPS path keeps the gate count constant for its caches
            if (self.remove_unnecessary_gates_during_adapt
                    and not self.is_mps_backend):
                remove_unnecessary_gates_from_circuit(
                    self.full_circuit, False, False, gate_range=self.g_range())
                self._invalidate_current()

            gates = self.ref_circuit_as_gates
            num_2q_gates, _ = co.find_num_gates(
                circuit=gates, gate_range=self.g_range(gates))
            if self.save_circuit_history:
                snapshot = co.make_quantum_only_circuit(gates)
                if snapshot.data and snapshot.data[0].name in (
                        "set_mps", "set_statevector"):
                    snapshot = co.extract_inner_circuit(
                        snapshot, (1, len(snapshot.data)))
                self.circuit_history.append(qasm.dumps(snapshot))

            # cinl may be float (callers pass math.inf to disable the check)
            cinl = self.adapt_config.cost_improvement_num_layers
            cit = self.adapt_config.cost_improvement_tol
            if len(self.global_cost_history) >= cinl and has_stopped_improving(
                    self.global_cost_history[-int(cinl):], cit):
                logger.warning("cost plateaued across the improvement "
                               "window; stopping")
                self.stop_reason = "plateau"
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
                    self.stop_reason = "sufficient_cost"
                    self.compiling_finished = True
                    break
            elif num_2q_gates >= self.adapt_config.max_2q_gates:
                logger.warning("2q-gate budget exhausted; one final "
                               "Rotosolve pass")
                self.minimizer.minimize_cost(
                    algorithm_kind=vconstants.ALG_ROTOSOLVE, max_cycles=10,
                    tol=1e-5, stop_val=self.adapt_config.sufficient_cost)
                self.stop_reason = "max_2q_gates"
                self.compiling_finished = True
                break
            if _wall_deadline_passed():
                logger.warning("ADAPTAQC_WALL_DEADLINE reached; stopping "
                               "with the best-so-far ansatz")
                self.stop_reason = "deadline"
                if checkpoint_every > 0:
                    # the checkpoint a later process resumes from: written
                    # before the final cleanup below rewrites the circuit
                    self.checkpoint(checkpoint_every, checkpoint_dir,
                                    delete_prev_chkpt, layer_count,
                                    start_time)
                self.compiling_finished = True
                break
            if checkpoint_every > 0 and layer_count % checkpoint_every == 0:
                self.checkpoint(checkpoint_every, checkpoint_dir,
                                delete_prev_chkpt, layer_count, start_time)

        if self.perform_final_minimisation:
            self.minimizer.minimize_cost(
                algorithm_kind=vconstants.ALG_PYBOBYQA,
                alg_kwargs={"seek_global_minimum": False})

        if self.is_mps_backend:
            # swap in the pure-gate representation for the final cleanup
            self.full_circuit = self.ref_circuit_as_gates
            self.lhs_gate_count = 1  # the set_mps target instruction
            self._invalidate_prefix()
        else:
            self.lhs_gate_count = self.original_lhs_gate_count
        remove_unnecessary_gates_from_circuit(self.full_circuit, True, True,
                                              gate_range=self.g_range())
        self._invalidate_current()

        # the final cost is 1 - |<solution|target>|^2, never softened
        if self.soften_global_cost:
            self.soften_global_cost = False
            final_global_cost = self.backend.evaluate_global_cost(self)
            self.soften_global_cost = True
        elif self._verification_applies():
            # the true cost: the working-chi re-simulation both over-reads
            # (absorbed prefix) and under-reads (states it cannot hold)
            final_global_cost = self._true_cost_of_gate_circuit(
                self.full_circuit)
        else:
            final_global_cost = self.backend.evaluate_global_cost(self)
        logger.info(f"Final global cost: {final_global_cost}")
        self.global_cost_history.append(final_global_cost)
        mps_truncated_weight = None
        if self.is_mps_backend:
            state = self.backend.state_of(self)
            mps_truncated_weight = self.backend.truncated_weight(state)
            noise_floor = 1e4 * torch.finfo(state.lam.dtype).eps
            if mps_truncated_weight > noise_floor:
                logger.warning(
                    "MPS truncation discarded relative Schmidt weight "
                    f"{mps_truncated_weight:.3e} during this compile: "
                    f"max_chi={self.backend.max_chi} or the truncation "
                    "threshold is binding; overlaps may be inaccurate.")
        if checkpoint_every > 0 and self.stop_reason != "deadline":
            self.checkpoint(checkpoint_every, checkpoint_dir,
                            delete_prev_chkpt,
                            len(self.qubit_pair_history) - 1, start_time)
        compiled_circuit = self.get_compiled_circuit()
        num_2q_gates, num_1q_gates = co.find_num_gates(compiled_circuit)
        self.cnot_depth_history.append(
            compiled_circuit.multi_qubit_gate_depth())

        exact_overlap = "Not computable without SV backend"
        if self.is_statevector_backend:
            exact_overlap = calculate_overlap_between_circuits(
                self.circuit_to_compile,
                co.make_quantum_only_circuit(compiled_circuit),
                device=self.backend.device, dtype=self.backend.dtype)

        result = AdaptResult(
            circuit=compiled_circuit,
            overlap=1 - final_global_cost,
            exact_overlap=exact_overlap,
            num_1q_gates=num_1q_gates,
            num_2q_gates=num_2q_gates,
            cnot_depth_history=self.cnot_depth_history,
            global_cost_history=self.global_cost_history,
            local_cost_history=(self.local_cost_history
                                if self.optimise_local_cost else None),
            circuit_history=self.circuit_history,
            entanglement_measures_history=self.entanglement_measures_history,
            e_val_history=self.e_val_history,
            qubit_pair_history=self.qubit_pair_history,
            method_history=self.pair_selection_method_history,
            time_taken=self.time_taken + (timeit.default_timer()
                                          - start_time),
            cost_evaluations=self.cost_evaluation_counter,
            coupling_map=self.coupling_map,
            circuit_qasm=qasm.dumps(co.make_quantum_only_circuit(
                compiled_circuit)),
        )
        # how much Schmidt weight the MPS engine dropped (None off MPS)
        result.mps_truncated_weight = mps_truncated_weight
        result.phase_timings = dict(self.phase_timings)
        result.stop_reason = self.stop_reason
        result.layer_times = list(self.layer_times)  # wall s per layer
        logger.info("ADAPT-AQC completed")
        return result

    # --------------------------------------------------------- MPS reference
    @property
    def ref_circuit_as_gates(self) -> Circuit:
        """Pure-gate view of the full circuit: on the MPS backend, absorbed
        layers re-expanded after the set_mps target instruction
        (adapt_compiler.py:708-715); elsewhere the full circuit itself."""
        if not self.is_mps_backend:
            return self.full_circuit
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

    # ------------------------------------------------------------ checkpoint
    def checkpoint(self, checkpoint_every, checkpoint_dir, delete_prev_chkpt,
                   layer_count, start_time):
        """Pickle the whole compiler as <layer_count>.pkl
        (adapt_compiler.py:484-506); io/checkpoint.py makes it picklable."""
        self.resume_from_layer = layer_count + 1
        current = timeit.default_timer() - start_time
        self.prev_checkpoint_time_taken = self.time_taken + current
        # under a mesh every rank encodes (a sharded payload is gathered
        # collectively) and rank 0 alone writes
        data = pickle.dumps(self)
        if getattr(self.backend, "mesh", None) is not None:
            import torch.distributed as dist
            if dist.get_rank() != 0:
                return
        with open(os.path.join(checkpoint_dir, f"{layer_count}.pkl"),
                  "wb") as f:
            f.write(data)
        if delete_prev_chkpt:
            try:
                os.remove(os.path.join(
                    checkpoint_dir, f"{layer_count - checkpoint_every}.pkl"))
            except FileNotFoundError:
                pass

    def __getstate__(self):
        from ..io.checkpoint import encode_compiler_state
        return encode_compiler_state(self)

    def __setstate__(self, state):
        from ..io.checkpoint import decode_compiler_state
        decode_compiler_state(self, state)

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
        if optimise_initial_ansatz and self.use_roto_algos:
            cost = self.minimizer.minimize_cost(
                algorithm_kind=vconstants.ALG_ROTOSOLVE, tol=1e-3,
                stop_val=0 if self.optimise_local_cost
                else self.adapt_config.sufficient_cost,
                indexes_to_modify=self.variational_circuit_range())
        elif optimise_initial_ansatz:
            cost = self.minimizer.minimize_cost(
                algorithm_kind=vconstants.ALG_PYBOBYQA,
                alg_kwargs={"seek_global_minimum": True})
        else:
            cost = self.evaluate_cost()
        self.global_cost = (self.backend.evaluate_global_cost(self)
                            if self.optimise_local_cost else cost)
        if self.global_cost < self.adapt_config.sufficient_cost:
            self.initial_ansatz_already_successful = True
        if self.is_mps_backend:
            gates_absorbed = self._absorb_n_gates_into_mps(
                len(initial_ansatz.data))
            co.add_to_circuit(self.layers_saved_to_mps, gates_absorbed)
        else:
            self.lhs_gate_count = self.variational_circuit_range()[1]

    # ------------------------------------------------------------- add layer
    def _add_layer(self, index):
        """adapt_compiler.py:585-689."""
        ansatz_start_index = self.variational_circuit_range()[0]
        isql_layer = self.initial_single_qubit_layer and index == 0
        if isql_layer:
            layer_indexes = self._add_rotation_to_all_qubits()
        else:
            layer_indexes = self._add_entangling_layer(index)
        if self.use_roto_algos:
            cost = self._roto_layer(index, isql_layer, layer_indexes,
                                    ansatz_start_index)
        else:
            t0 = timeit.default_timer()
            cost = self.minimizer.minimize_cost(
                algorithm_kind=vconstants.ALG_PYBOBYQA,
                alg_kwargs={"seek_global_minimum": True})
            self.phase_timings["layer_optimisation"] += \
                timeit.default_timer() - t0

        if self.is_mps_backend:
            t0 = timeit.default_timer()
            self.layers_as_gates.append(index)
            num_to_absorb = self._calculate_num_layers_to_absorb(index)
            if num_to_absorb > 0:
                includes_isql = (self.layers_as_gates[0] == 0
                                 and self.initial_single_qubit_layer)
                num_gates = self._get_num_gates_to_cache(
                    n=num_to_absorb, includes_isql=includes_isql)
                gates_absorbed = self._absorb_n_gates_into_mps(num_gates)
                co.add_to_circuit(self.layers_saved_to_mps, gates_absorbed)
                del self.layers_as_gates[:num_to_absorb]
            self.phase_timings["absorption"] += timeit.default_timer() - t0
        return cost

    def _roto_layer(self, index, isql_layer, layer_indexes,
                    ansatz_start_index):
        """The new layer's Rotoselect (Rotosolve where asked), the periodic
        Rotosolve over the trailing window and, under the local cost, the
        periodic global polish (adapt_compiler.py:668-729). Returns the
        cost."""
        stop_val = (0 if self.optimise_local_cost
                    else self.adapt_config.sufficient_cost)
        alg = (vconstants.ALG_ROTOSELECT
               if self.use_rotoselect or isql_layer
               else vconstants.ALG_ROTOSOLVE)
        t0 = timeit.default_timer()
        cost = self.minimizer.minimize_cost(
            algorithm_kind=alg, tol=self.adapt_config.rotoselect_tol,
            stop_val=stop_val, indexes_to_modify=layer_indexes)
        self.phase_timings["layer_optimisation"] += timeit.default_timer() - t0
        freq = self.adapt_config.rotosolve_frequency
        if freq != 0 and index > 0 and index % freq == 0:
            window_cap = (self.adapt_config.local_window_layers
                          if self.optimise_local_cost else None)
            multi_indexes = self._calculate_multi_layer_optimisation_indices(
                ansatz_start_index, max_layers=window_cap)
            if self.use_advanced_transpilation:
                from ..circuits.peephole import advanced_circuit_transpilation
                variational = co.extract_inner_circuit(
                    self.full_circuit, self.variational_circuit_range())
                advanced_circuit_transpilation(variational, self.coupling_map)
                co.replace_inner_circuit(self.full_circuit, variational,
                                         self.variational_circuit_range())
                self._invalidate_current()
            t0 = timeit.default_timer()
            cost = self.minimizer.minimize_cost(
                algorithm_kind=vconstants.ALG_ROTOSOLVE,
                tol=self.adapt_config.rotosolve_tol, stop_val=stop_val,
                indexes_to_modify=multi_indexes)
            self.phase_timings["window_rotosolve"] += \
                timeit.default_timer() - t0
        gpf = self.adapt_config.global_polish_frequency
        if (self.optimise_local_cost and gpf and index > 0
                and index % gpf == 0
                # only the device overlap sweep optimises the global cost
                # under force_global; without it minimize_cost would fall
                # through to the local probe loop and polish the wrong cost
                and self.minimizer._can_fast_sweep(force_global=True)):
            # the hybrid schedule: the local cost gives a trainable signal
            # layer by layer at large n, and a periodic global-cost
            # Rotosolve over the full max_layers_to_modify window (the O(G)
            # sweep) consolidates toward the overlap itself
            full_indexes = self._calculate_multi_layer_optimisation_indices(
                ansatz_start_index)
            t0 = timeit.default_timer()
            self.minimizer.minimize_cost(
                algorithm_kind=vconstants.ALG_ROTOSOLVE,
                tol=self.adapt_config.rotosolve_tol,
                stop_val=self.adapt_config.sufficient_cost,
                indexes_to_modify=full_indexes, force_global=True)
            self.phase_timings["global_polish"] += \
                timeit.default_timer() - t0
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

    def _calculate_multi_layer_optimisation_indices(self, ansatz_start_index,
                                                    max_layers=None):
        """adapt_compiler.py:717-741; `max_layers` overrides
        max_layers_to_modify (the local-cost window)."""
        if max_layers is None:
            max_layers = self.adapt_config.max_layers_to_modify
        isql = int(self.initial_single_qubit_layer)
        num_isql_gates = self.full_circuit.num_qubits * isql
        start = max(ansatz_start_index,
                    self.variational_circuit_range()[1]
                    - len(self.layer_2q_gate.data) * (max_layers - isql)
                    - num_isql_gates)
        first_layer_end = ansatz_start_index + num_isql_gates
        if ansatz_start_index < start < first_layer_end:
            start = first_layer_end
        return (start, self.variational_circuit_range()[1])

    def _get_num_gates_to_cache(self, n, includes_isql=False):
        return (len(self.layer_2q_gate.data) * (n - int(includes_isql))
                + self.full_circuit.num_qubits * int(includes_isql))

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

    def _add_rotation_to_all_qubits(self):
        """initial_single_qubit_layer: an ry on every qubit as layer 0
        (adapt_compiler.py:761-773)."""
        n = self.full_circuit.num_qubits
        first_layer = Circuit(n)
        first_layer.ry(0, range(n))
        insert_at = self.variational_circuit_range()[1]
        self._stash_advance_hint(insert_at)
        co.add_to_circuit(self.full_circuit, first_layer, insert_at)
        self._invalidate_current()
        self.entanglement_measures_history.append([None])
        self.e_val_history.append(None)
        self.general_gradient_history.append(None)
        self.qubit_pair_history.append((None, None))
        self.pair_selection_method_history.append(None)
        end = self.variational_circuit_range()[1]
        return (end - n, end)

    # ---------------------------------------------------- verified stopping
    # how close (in units of sufficient_cost) the in-loop estimate must be
    # before periodic verification starts, and layers between checks
    _VERIFY_BAND = 3.0
    _VERIFY_EVERY = 20

    def _verification_applies(self) -> bool:
        """The chi-capped MPS cost is an estimate; elsewhere the in-loop
        cost is the true cost."""
        return (self.is_mps_backend and not self.optimise_local_cost
                and not self.soften_global_cost)

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
        if not self._verification_applies():
            return True
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
        mesh = getattr(self.backend, "mesh", None)
        engine, cap = mps_core, contextlib.nullcontext()
        if mesh is not None:
            # on the shards: the target padded and resharded a site at a
            # time, no collective past one site at verify_chi
            from ..parallel import mesh as pmesh
            from ..parallel import mps_sharded
            engine = pmesh.OnMesh(mps_sharded, mesh)
            cap = pmesh.payload_cap(2 * verify_chi * verify_chi)
        with cplx.verification_eigh(), cap:
            payload = qc.data[0].payload
            if qc.data[0].name == "set_statevector":
                # a dense vector, which the caller holds whole already
                target = mps_core.from_dense(payload, verify_chi, **kw)
            elif isinstance(payload, mps_core.MPS):
                target = payload
            else:
                target = mps_core.from_qiskit_mps(payload, verify_chi, **kw)
            if mesh is None:
                target = mps_core.pad_chi(target, verify_chi)
                state = mps_core.zero_mps(n, verify_chi, **kw)
            else:
                target = mps_sharded.pad_chi(
                    mesh, pmesh.shard_mps(mesh, target), verify_chi)
                state = mps_sharded.zero_mps(mesh, n, verify_chi, **kw)
            if len(qc.data) > 1:
                tape = compile_tape(qc, (1, len(qc.data)))
                state = engine.apply_tape_adjoint(
                    state, tape.kinds, tape.q0, tape.q1, tape.angles,
                    self.backend.truncation_threshold)
            nrm2 = float(engine.mps_dot(state, state).real)
            tnrm2 = float(engine.mps_dot(target, target).real)
            ov = engine.mps_dot(state, target)
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
        """Heuristic dispatch (adapt_compiler.py:775-830)."""
        method = self.adapt_config.method
        if method == "random":
            self.pair_selection_method_history.append("random")
            return self.coupling_map[np.random.randint(len(self.coupling_map))]
        if method == "basic":
            self.pair_selection_method_history.append("basic")
            priorities = self._get_all_qubit_pair_reuse_priorities(1)
            return self.coupling_map[int(np.argmax(priorities))]
        if method == "expectation":
            return self._find_best_expectation_qubit_pair()
        if method == "ISL":
            ems = self._get_all_qubit_pair_entanglement_measures()
            self.entanglement_measures_history.append(ems)
            return self._find_best_entanglement_qubit_pair(ems)
        if method == "general_gradient":
            gradients = self._get_all_qubit_pair_gradients()
            self.general_gradient_history.append(gradients)
            self.pair_selection_method_history.append("general_gradient")
            priorities = self._get_all_qubit_pair_reuse_priorities(
                self.adapt_config.reuse_exponent)
            combined = np.multiply(gradients, priorities)
            return self.coupling_map[int(np.argmax(combined))]
        if method == "brickwall":
            return self._next_brickwall_pair()
        raise ValueError(
            f"Invalid compiling method {method}. Method must be one of ISL, "
            "expectation, random, basic, general_gradient, brickwall")

    def _next_brickwall_pair(self):
        """adapt_compiler.py:803-825."""
        n = self.full_circuit.num_qubits
        if n < 2:
            raise ValueError("Cannot pick a pair if there are fewer than two "
                             "qubits")
        if (len(self.qubit_pair_history) == 0 or n == 2
                or self.qubit_pair_history[-1][0] is None):
            return (0, 1)
        prev = self.qubit_pair_history[-1]
        nxt = (prev[0] + 2, prev[1] + 2)
        n_odd = n % 2
        if nxt == (n, n + 1):
            return (1 - n_odd, 2 - n_odd)
        if nxt == (n - 1, n):
            return (0 + n_odd, 1 + n_odd)
        return nxt

    def _find_best_entanglement_qubit_pair(self, entanglement_measures):
        """ISL: the most entangled pair not marked bad, or the expectation
        heuristic when every pair is below the threshold
        (adapt_compiler.py:858-921). A pair whose entanglement did not drop
        after its layer is marked bad for bad_qubit_pair_memory layers."""
        priorities = self._get_all_qubit_pair_reuse_priorities(
            self.adapt_config.reuse_exponent)
        memory = self.adapt_config.bad_qubit_pair_memory
        if len(self.entanglement_measures_history) >= 2 + int(
                self.initial_single_qubit_layer):
            prev_index = self.coupling_map.index(self.qubit_pair_history[-1])
            pre_em = self.entanglement_measures_history[-2][prev_index]
            post_em = self.entanglement_measures_history[-1][prev_index]
            if post_em >= pre_em:
                self.bad_qubit_pairs.append(self.coupling_map[prev_index])
            if len(self.bad_qubit_pairs) > memory:
                del self.bad_qubit_pairs[0]
        filtered = [em * pr for em, pr in zip(entanglement_measures,
                                              priorities)]
        for qp in set(self.bad_qubit_pairs):
            if qp in self.qubit_pair_history[-memory:]:
                filtered[self.coupling_map.index(qp)] = -1
        if max(filtered) <= self.adapt_config.entanglement_threshold:
            logger.info("every non-bad pair is below the entanglement "
                        "threshold; falling back to the expectation "
                        "heuristic")
            return self._find_best_expectation_qubit_pair()
        self.pair_selection_method_history.append("ISL")
        self.e_val_history.append(None)
        return self.coupling_map[int(np.argmax(filtered))]

    def _find_best_expectation_qubit_pair(self):
        """The pair whose qubits are nearest |1> by <Z>, times the reuse
        priority (adapt_compiler.py:923-953)."""
        priorities = self._get_all_qubit_pair_reuse_priorities(
            self.adapt_config.reuse_exponent)
        e_vals = self.backend.measure_qubit_expectation_values(self)
        self.e_val_history.append(e_vals)
        # map <Z> + <Z> in [-2, 2] to a priority favouring qubits near |1>
        combined = [(2 - (e_vals[c] + e_vals[t])) * p
                    for (c, t), p in zip(self.coupling_map, priorities)]
        self.pair_selection_method_history.append("expectation")
        return self.coupling_map[int(np.argmax(combined))]

    def _get_all_qubit_pair_entanglement_measures(self):
        """One RDM per coupling-map pair, computed together on the device
        (adapt_compiler.py:955-976). For the sampling backend with the
        observable method, the two-copy Bell-measurement protocol runs per
        pair instead (entanglement_measures.py:138-256)."""
        if (self.entanglement_measure_method
                == EM_OBSERVABLE_CONCURRENCE_LOWER_BOUND
                and isinstance(self.backend, SamplingBackend)):
            qc = co.make_quantum_only_circuit(self.full_circuit)
            return [measure_concurrence_lower_bound(
                        qc, a, b, self.backend,
                        execute_kwargs=self.execute_kwargs)
                    for a, b in self.coupling_map]
        state = self.backend.state_of(self)
        rhos = self.backend.all_pair_rdms(state, self.coupling_map)
        return [measure_from_rdm(self.entanglement_measure_method, rho)
                for rho in rhos]

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

    # -------------------------------------------------------- reuse priority
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

    def _is_last_pair(self, qubit_pair) -> bool:
        return (len(self.qubit_pair_history)
                > int(self.initial_single_qubit_layer)
                and qubit_pair == self.qubit_pair_history[-1])

    def _get_qubit_reuse_priority(self, qubit_pair, k):
        """adapt_compiler.py:1006-1035."""
        if self._is_last_pair(qubit_pair):
            return -1
        if k == 0:
            return 1
        reversed_pairs = self.qubit_pair_history[::-1]
        locs = [self._find_last_use_of_qubit(reversed_pairs, q)
                for q in qubit_pair]
        return np.min([1 - np.exp2(-(loc + 1) / k) for loc in locs])

    def _get_pair_reuse_priority(self, qubit_pair, k):
        """adapt_compiler.py:1037-1065."""
        if self._is_last_pair(qubit_pair):
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

    def _log_full_ansatz(self):
        """debug_log_full_ansatz: the current ansatz as QASM at debug level
        after every layer (adapt_compiler.py:508-534)."""
        if not self.debug_log_full_ansatz:
            return
        if self.is_mps_backend:
            src = self.ref_circuit_as_gates
            rng = (1, len(src.data))
        else:
            src = self.full_circuit
            rng = self.g_range()
        ansatz = co.extract_inner_circuit(src, rng)
        logger.debug("current full ansatz:\n%s",
                     qasm.dumps(co.make_quantum_only_circuit(ansatz)))

    def record_cnot_depth(self):
        """adapt_compiler.py:1147-1163."""
        if self.is_mps_backend:
            ref = self.ref_circuit_as_gates
            ansatz = co.extract_inner_circuit(ref, (1, len(ref.data)))
        else:
            ansatz = co.extract_inner_circuit(
                self.full_circuit, (self.original_lhs_gate_count,
                                    self.variational_circuit_range()[1]))
        self.cnot_depth_history.append(ansatz.multi_qubit_gate_depth())
