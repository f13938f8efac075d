"""CostMinimiser: angle optimisation over the variational range.

Counterpart of the JAX package's `optim/minimiser.py`. Rotosolve /
Rotoselect dispatch in the JAX package's order (minimiser.py:89-99):

 - the O(G) device sweep (optim/sweeps.py) over the backend's engine, for
   the global cost on a backend with a sweep engine (also under a local or
   softened cost when the caller passes force_global: the hybrid
   schedule's global polish);
 - the full-cost device sweep (sweeps.sweep_full_chunked_until_converged)
   for the local and the softened cost on an engine with cost_terms;
 - otherwise the host probe loop, which reproduces the reference's
   per-gate 3-point probing against `evaluate_cost` (each probe one full
   cost evaluation): backends with no sweep engine (sampling) and
   parameterised ('#'/'@' labelled) circuits.

With zigzag (CostMinimiser(zigzag=True), or ADAPTAQC_ZIGZAG=1 when the
argument is None; off by default) the O(G) device sweep alternates its
direction where the JAX package does: Rotoselect or a whole Rotosolve, one
block of right states, and an engine without incremental environments.

Under Rotosolve with rotosolve_fraction < 1 the O(G) device sweep runs one
cycle at a time, each over a fresh random subsample of the window's
rotation gates (the stdlib `random` module, as in the JAX package).

The generic optimisers run on the host over all variational angles, each
evaluation a full cost: scipy.optimize.minimize; nlopt, where installed;
and BOBYQA, pybobyqa where installed, else the package's own optim/bobyqa.py
(neither nlopt nor pybobyqa is a dependency: without nlopt an "LN_BOBYQA"
or None identifier runs the own BOBYQA too, logged, and any other raises as
the JAX package does).
"""

from __future__ import annotations

import logging
import os
import random
from typing import Optional, Tuple

import numpy as np
from scipy.optimize import minimize

from ..backends.backend import softening_alpha
from ..circuits import operations as co
from ..circuits.tape import compile_tape, select_mask, writeback_angles
from ..utils import constants as vconstants
from .sinusoidal import (derivative_of_sinusoidal, has_stopped_improving,
                         minimum_of_sinusoidal)
from . import sweeps

logger = logging.getLogger(__name__)

# gate applies per chunk of sweep cycles: between chunks the host checks
# the stop criteria and keeps the best chunk endpoint
_CALL_BUDGET = 32768


def _sweep_went_backwards(cost: float, cost0: float) -> bool:
    """Coordinate-descent sweeps are monotone per probe in exact arithmetic,
    so a final cost meaningfully above the input-angle cost can only be a
    numerical or device fault. The tolerance absorbs float32 and
    truncation-order jitter near convergence. Written as not-(accept) so a
    NaN cost is rejected."""
    return not (cost <= cost0 + max(2e-3, 0.10 * cost0))


class CostMinimiser:
    """Minimizer of the compiler's cost (cost_minimiser.py:32)."""

    def __init__(self, cost_finder, variational_circuit_range, compiler,
                 rotosolve_fraction=1.0, zigzag=None):
        self.cost_finder = cost_finder
        self.variational_circuit_range = variational_circuit_range
        self.compiler = compiler
        self.rotosolve_fraction = rotosolve_fraction
        # alternating-direction cycles (sweeps.sweep_zigzag_until_converged,
        # G applies a cycle instead of 2G): exact coordinate descent in
        # another gate order than the reference's, so opt-in, as in the
        # JAX package (minimiser.py:62-73)
        if zigzag is None:
            zigzag = bool(int(os.environ.get("ADAPTAQC_ZIGZAG", "0")))
        self.zigzag = zigzag

    @property
    def full_circuit(self):
        return self.compiler.full_circuit

    def minimize_cost(self, algorithm_kind=vconstants.ALG_ROTOSOLVE,
                      algorithm_identifier=None, max_cycles=1000,
                      stop_val=-np.inf, tol=1e-10, indexes_to_modify=None,
                      alg_kwargs=None, force_global=False):
        """force_global=True optimises the plain global overlap cost even
        when the compiler is in local or softened mode: the hybrid
        schedule's periodic consolidation pass (the compiler's global
        polish)."""
        if alg_kwargs is None:
            alg_kwargs = {}
        if algorithm_kind in (vconstants.ALG_ROTOSOLVE,
                              vconstants.ALG_ROTOSELECT):
            rotoselect = algorithm_kind == vconstants.ALG_ROTOSELECT
            if self._can_fast_sweep(force_global=force_global):
                if self.rotosolve_fraction < 1.0 and not rotoselect:
                    return self._roto_device_sampled(
                        max_cycles, stop_val, tol, indexes_to_modify)
                return self._roto_device(rotoselect, max_cycles, stop_val,
                                         tol, indexes_to_modify)
            if self._can_full_sweep(rotoselect):
                return self._roto_device_full(rotoselect, max_cycles,
                                              stop_val, tol,
                                              indexes_to_modify)
            return self._roto_host(rotoselect, max_cycles, stop_val, tol,
                                   indexes_to_modify)
        if algorithm_kind == vconstants.ALG_SCIPY:
            return self._scipy_minimize(algorithm_identifier, tol, alg_kwargs)
        if algorithm_kind == vconstants.ALG_NLOPT:
            return self._nlopt_minimize(algorithm_identifier, stop_val, tol)
        if algorithm_kind == vconstants.ALG_PYBOBYQA:
            return self._pybobyqa_minimize(alg_kwargs)
        raise ValueError(f"Invalid algorithm kind {algorithm_kind}")

    def _reject_sweep(self, alg_name: str, cost: float, cost0: float) -> float:
        """Restore-on-fail: discard the sweep (no angle write-back, so the
        circuit and its state caches still describe the input angles) and
        report the input-angle cost."""
        logger.warning(
            f"{alg_name} sweep ended at cost {cost:.6f}, worse than its "
            f"starting cost {cost0:.6f}; discarding the sweep result "
            f"(device/numeric fault guard)")
        return float(cost0)

    def _has_parameterised_labels(self) -> bool:
        rng = self.variational_circuit_range()
        for i in range(rng[0], len(self.full_circuit.data)):
            lbl = self.full_circuit.data[i].label
            if lbl is not None and ("#" in lbl or "@" in lbl):
                return True
        return False

    def _can_fast_sweep(self, force_global=False) -> bool:
        comp = self.compiler
        if ((comp.optimise_local_cost or comp.soften_global_cost)
                and not force_global):
            return False
        if comp.backend.sweep_engine() is None:
            return False
        return not self._has_parameterised_labels()

    def _can_full_sweep(self, rotoselect) -> bool:
        """The device path of the local and the softened cost: their probe
        cost is not one overlap, so the O(G) environment sweep does not
        apply, but the reference's full-simulation probes
        (cost_minimiser.py:267-368) run as batches on the engine
        (sweeps.sweep_full_chunk). Subsampled Rotosolve cycles stay on the
        host path."""
        comp = self.compiler
        if not (comp.optimise_local_cost or comp.soften_global_cost):
            return False
        if not (self.rotosolve_fraction >= 1.0 or rotoselect):
            return False
        engine = comp.backend.sweep_engine()
        if engine is None or engine.cost_terms is None:
            return False
        return not self._has_parameterised_labels()

    def _cost_weights(self):
        """(w_global, w_local, alpha) of the full-cost sweep, as the
        backend's cost layer has them: the local cost under
        optimise_local_cost (aer_mps_backend.py:72-74), else the global
        cost with the softening penalty alpha = |previous cost - sufficient
        cost| (:49-70; constant within one minimize_cost call, since the
        cost history only grows between layers)."""
        comp = self.compiler
        if comp.optimise_local_cost:
            return (0.0, 1.0, 0.0)
        alpha = 0.0
        if comp.soften_global_cost:
            alpha = softening_alpha(comp)
        return (1.0, 0.0, float(alpha))

    def _sweep_tape(self, indexes_to_modify):
        """What the device sweeps start from: (prefix state, tape, its
        range in full_circuit, select mask, the window's tape-relative
        instruction indices). Gates left of the modify
        window are fixed for the whole call: the prefix is advanced past
        them once (or taken from the compiler's advance hint, the state up
        to the window peeled from its full-state cache); the tape covers
        the window and the fixed gates behind it."""
        comp = self.compiler
        var_range = self.variational_circuit_range()
        if indexes_to_modify is None:
            indexes_to_modify = var_range
        else:
            indexes_to_modify = (max(indexes_to_modify[0], var_range[0]),
                                 min(indexes_to_modify[1], var_range[1]))
        prefix = comp._prefix_state()
        tape_start = var_range[0]
        hint = getattr(comp, "_advance_hint", None)
        comp._advance_hint = None
        if indexes_to_modify[0] > tape_start:
            if hint is not None and hint[0] == indexes_to_modify[0]:
                prefix = hint[1]
            else:
                pre_tape = compile_tape(self.full_circuit,
                                        (tape_start, indexes_to_modify[0]))
                prefix = comp.backend.run_tape(prefix, pre_tape)
            tape_start = indexes_to_modify[0]
        tape_range = (tape_start, len(self.full_circuit.data))
        tape = compile_tape(self.full_circuit, tape_range)
        base_indices = [i - tape_range[0] for i in range(*indexes_to_modify)]
        return (prefix, tape, tape_range, select_mask(tape, base_indices),
                base_indices)

    def _roto_device_full(self, rotoselect, max_cycles, stop_val, tol,
                          indexes_to_modify):
        comp = self.compiler
        alg_name = "ROTOSELECT" if rotoselect else "ROTOSOLVE"
        prefix, tape, tape_range, mask, _ = self._sweep_tape(
            indexes_to_modify)
        logger.info(f"Starting {alg_name} (full-cost device path)")
        # the full-state cache, when valid, is prefix + tape at the input
        # angles: it spares the probe-free pass that gives the initial cost
        (kinds, angles, cost, cycles, evals, final_state,
         cost0) = sweeps.sweep_full_chunked_until_converged(
            comp.backend.sweep_engine(), rotoselect, int(max_cycles), prefix,
            comp.backend.zero_ref(comp), tape.kinds, tape.q0, tape.q1,
            tape.angles, mask, stop_val, tol, self._cost_weights(),
            init_state=comp._current_cache)
        comp.cost_evaluation_counter += int(evals)
        logger.info(f"{alg_name} ran {cycles} full-cost cycles on device")
        if _sweep_went_backwards(cost, cost0):
            return self._reject_sweep(alg_name, cost, cost0)
        writeback_angles(self.full_circuit, tape_range, tape, kinds, angles)
        comp._invalidate_current()
        comp._current_cache = final_state
        logger.info(f"{alg_name} finished with cost {cost}")
        return float(cost)

    def _roto_device(self, rotoselect, max_cycles, stop_val, tol,
                     indexes_to_modify):
        comp = self.compiler
        alg_name = "ROTOSELECT" if rotoselect else "ROTOSOLVE"
        prefix, tape, tape_range, mask, _ = self._sweep_tape(
            indexes_to_modify)
        ref = comp.backend.zero_ref(comp)
        engine = comp.backend.sweep_engine()
        bl = sweeps.default_block_len(tape.padded_length,
                                      sweeps.state_nbytes(prefix))
        logger.info(f"Starting {alg_name}")
        kinds, angles = tape.kinds, tape.angles
        if (self.zigzag and bl >= tape.padded_length
                and engine.env_ops is None):
            # zigzag runs where the JAX package runs it: one block, no
            # incremental environments
            return self._roto_device_zigzag(
                rotoselect, max_cycles, stop_val, tol, prefix, ref, engine,
                tape, tape_range, mask)
        # the full-state cache, when valid, is prefix + tape at the input
        # angles: it spares the initial-cost pass over the tape
        init_state = comp._current_cache
        chunk = max(1, min(int(max_cycles),
                           _CALL_BUDGET // max(2 * tape.padded_length, 1)))
        cycles, evals, hist = 0, 0, []
        cost0 = None
        best = None  # (cost, kinds, angles, state) of the best chunk end
        while cycles < int(max_cycles):
            (kinds, angles, cost, ccyc, cevals, final_state,
             c0) = sweeps.sweep_until_converged(
                engine, bl, rotoselect, chunk, prefix, ref, kinds, tape.q0,
                tape.q1, angles, mask, stop_val, tol, init_state)
            if cost0 is None:
                cost0 = c0
            init_state = final_state
            cycles += ccyc
            evals += cevals
            hist.append(cost)
            # NaN-safe: a NaN endpoint never becomes the best
            if cost == cost and (best is None or cost < best[0]):
                best = (cost, kinds, angles, final_state)
            if ccyc < chunk or cost <= stop_val:
                break
            if len(hist) > 3 and has_stopped_improving(hist[-3:], tol):
                break
        if best is not None:
            cost, kinds, angles, final_state = best
        comp.cost_evaluation_counter += int(evals)
        logger.info(f"{alg_name} ran {cycles} cycles on device")
        if _sweep_went_backwards(cost, cost0):
            return self._reject_sweep(alg_name, cost, cost0)
        writeback_angles(self.full_circuit, tape_range, tape, kinds, angles)
        comp._invalidate_current()
        # the sweep's final state is the state of the whole full_circuit at
        # the written-back angles: seed the cache with it
        comp._current_cache = final_state
        logger.info(f"{alg_name} finished with cost {cost}")
        return float(cost)

    def _roto_device_zigzag(self, rotoselect, max_cycles, stop_val, tol,
                            prefix, ref, engine, tape, tape_range, mask):
        """_roto_device's zigzag branch: all cycles in one call, whose
        initial backward pass gives the input angles' cost (the full-state
        cache is not needed), under the same backwards guard."""
        comp = self.compiler
        alg_name = "ROTOSELECT" if rotoselect else "ROTOSOLVE"
        (kinds, angles, cost, cycles, evals, final_state,
         cost0) = sweeps.sweep_zigzag_until_converged(
            engine, rotoselect, int(max_cycles), prefix, ref, tape.kinds,
            tape.q0, tape.q1, tape.angles, mask, stop_val, tol)
        comp.cost_evaluation_counter += int(evals)
        logger.info(f"{alg_name} ran {cycles} zigzag cycles on device")
        if _sweep_went_backwards(cost, cost0):
            return self._reject_sweep(alg_name, cost, cost0)
        writeback_angles(self.full_circuit, tape_range, tape, kinds, angles)
        comp._invalidate_current()
        comp._current_cache = final_state
        logger.info(f"{alg_name} finished with cost {cost}")
        return float(cost)

    def _roto_device_sampled(self, max_cycles, stop_val, tol,
                             indexes_to_modify):
        """Rotosolve under rotosolve_fraction < 1: one O(G) device sweep a
        cycle, each over its own random subsample of the window's rotation
        gates (_cycle_mask), stopped by the host loop's rule. As in the JAX
        package there is no backwards guard on this path."""
        comp = self.compiler
        prefix, tape, tape_range, full_mask, base_indices = \
            self._sweep_tape(indexes_to_modify)
        ref = comp.backend.zero_ref(comp)
        engine = comp.backend.sweep_engine()
        bl = sweeps.default_block_len(tape.padded_length,
                                      sweeps.state_nbytes(prefix))
        logger.info("Starting ROTOSOLVE (subsampled, on device)")
        kinds, angles = tape.kinds, tape.angles
        final_state = None
        cost = self.cost_finder()
        cycles = 0
        cost_history = []
        while cost > stop_val and cycles < max_cycles:
            mask = self._cycle_mask(tape, full_mask, base_indices, False)
            kinds, angles, cost, final_state, evals, _ = sweeps.sweep(
                engine, bl, False, prefix, ref, kinds, tape.q0, tape.q1,
                angles, mask)
            comp.cost_evaluation_counter += int(evals)
            cycles += 1
            logger.info(f"ROTOSOLVE cycle: {cycles}")
            cost_history.append(cost)
            if len(cost_history) > 3 and has_stopped_improving(
                    cost_history[-3:], tol):
                break
        writeback_angles(self.full_circuit, tape_range, tape, kinds, angles)
        comp._invalidate_current()
        if final_state is not None:
            comp._current_cache = final_state
        logger.info(f"ROTOSOLVE finished with cost {cost}")
        return float(cost)

    def _cycle_mask(self, tape, full_mask, base_indices, rotoselect):
        """One cycle's subsample under rotosolve_fraction (the JAX
        package's minimiser.py:398-407, cost_minimiser.py:293-302): the
        window's rotation gates, ceil(fraction x count) of them drawn by
        random.sample."""
        if self.rotosolve_fraction >= 1.0 or rotoselect:
            return full_mask
        rotation_local = [i for i in base_indices
                          if tape.data_index_map[i][1] == 1
                          and tape.trainable[tape.data_index_map[i][0]]]
        num = int(np.ceil(self.rotosolve_fraction * len(rotation_local)))
        sample = random.sample(rotation_local, num)
        return select_mask(tape, sorted(sample))

    # ------------------------------------------------------- host probe loop
    def _roto_host(self, rotoselect, max_cycles, stop_val, tol,
                   indexes_to_modify):
        """Cycles of per-gate coordinate descent on full cost evaluations
        (cost_minimiser.py:90-105)."""
        alg_name = "ROTOSELECT" if rotoselect else "ROTOSOLVE"
        cost_history = []
        cost = self.cost_finder()
        cycles = 0
        logger.info(f"Starting {alg_name} (host loop)")
        while cost > stop_val and cycles < max_cycles:
            cost = self._reduce_cost(rotoselect, indexes_to_modify)
            cycles += 1
            cost_history.append(cost)
            if len(cost_history) > 3 and has_stopped_improving(
                    cost_history[-3:], tol):
                break
        logger.info(f"{alg_name} finished with cost {cost}")
        return cost

    def _reduce_cost(self, change_1q_gate_kind=False,
                     indexes_to_modify: Optional[Tuple[int, int]] = None):
        """One cycle over the gates (cost_minimiser.py:267-316)."""
        cost = 1
        var_range = self.variational_circuit_range()
        if indexes_to_modify is None:
            indexes_to_modify = var_range
        else:
            indexes_to_modify = (max(indexes_to_modify[0], var_range[0]),
                                 min(indexes_to_modify[1], var_range[1]))

        if self.rotosolve_fraction < 1.0 and not change_1q_gate_kind:
            idx_list = co.find_rotation_indices(
                self.full_circuit, list(range(*indexes_to_modify)))
            num = int(np.ceil(self.rotosolve_fraction * len(idx_list)))
            sample = sorted(random.sample(idx_list, num))
        else:
            sample = list(range(*indexes_to_modify))

        for index in sample:
            instr = self.full_circuit.data[index]
            if change_1q_gate_kind and instr.is_supported_1q_gate():
                cost = self.replace_with_best_1q_gate(index)
            elif instr.is_supported_1q_gate():
                angle, cost = self.find_best_angle(
                    index, instr.base_label if instr.label is None
                    or "#" not in instr.label else instr.label)
                co.replace_1q_gate(self.full_circuit, index,
                                   instr.label or instr.name, angle)
                self.compiler._invalidate_current()
        return cost

    def replace_with_best_1q_gate(self, gate_index):
        """Rotoselect on one gate: the best of rx, ry and rz at its best
        angle (cost_minimiser.py:318-342)."""
        co.replace_1q_gate(self.full_circuit, gate_index, "rx", 0)
        self.compiler._invalidate_current()
        cost_identity = self.cost_finder()
        best_name, best_angle, best_cost = None, None, 1
        for gate_name in ("rx", "ry", "rz"):
            angle, cost = self.find_best_angle(gate_index, gate_name,
                                               cost_identity)
            if cost < best_cost:
                best_name, best_angle, best_cost = gate_name, angle, cost
        co.replace_1q_gate(self.full_circuit, gate_index, best_name,
                           best_angle)
        self.compiler._invalidate_current()
        return best_cost

    def find_best_angle(self, gate_index, gate_name, cost_for_identity=None):
        """Rotosolve on one gate: the cost at 0 and +-pi/2 fixes the
        sinusoid, whose minimum is closed-form (cost_minimiser.py:344-368).
        The gate is restored before returning."""
        original = self.full_circuit.data[gate_index]
        costs = []
        angles_to_run = [0, np.pi / 2, -np.pi / 2]
        if cost_for_identity is not None:
            costs.append(cost_for_identity)
            angles_to_run.remove(0)
        for theta in angles_to_run:
            co.replace_1q_gate(self.full_circuit, gate_index, gate_name, theta)
            self.compiler._invalidate_current()
            costs.append(self.cost_finder())
        theta_min, cost_min = minimum_of_sinusoidal(*costs)
        self.full_circuit.data[gate_index] = original
        self.compiler._invalidate_current()
        return theta_min, cost_min

    # ----------------------------------------------------- generic optimisers
    def _find_cost_with_angles(self, angles, grad=None):
        co.update_angles_in_circuit(self.full_circuit, angles,
                                    self.variational_circuit_range())
        self.compiler._invalidate_current()
        if grad is not None and np.size(grad) > 0:
            self._update_gradient_of_circuit(grad)
        return self.cost_finder()

    def _scipy_minimize(self, method, tol, alg_kwargs):
        initial = co.find_angles_in_circuit(self.full_circuit,
                                            self.variational_circuit_range())
        if len(initial) == 0:
            return self.cost_finder()
        result = minimize(fun=self._find_cost_with_angles, method=method,
                          x0=initial, tol=tol, **alg_kwargs)
        co.update_angles_in_circuit(self.full_circuit, result["x"],
                                    self.variational_circuit_range())
        self.compiler._invalidate_current()
        return result["fun"]

    def _nlopt_minimize(self, algorithm_identifier, stop_val, tol):
        """cost_minimiser.py:108-142. Without the nlopt package an
        identifier naming BOBYQA ("LN_BOBYQA", "bobyqa" or None) runs the
        package's own BOBYQA, logged; any other raises, as the JAX package
        does."""
        try:
            import nlopt
        except ModuleNotFoundError:
            if algorithm_identifier in (None, "LN_BOBYQA", "bobyqa"):
                logger.info("nlopt not installed: running the native BOBYQA "
                            "implementation (optim.bobyqa) for "
                            f"identifier={algorithm_identifier!r}")
                kw = {"rhoend": max(tol, 1e-10)}
                if np.isfinite(stop_val):
                    kw["stopval"] = stop_val
                return self._pybobyqa_minimize(kw)
            logger.error("NLOPT not installed and identifier "
                         f"{algorithm_identifier!r} has no native equivalent")
            raise
        initial = co.find_angles_in_circuit(self.full_circuit,
                                            self.variational_circuit_range())
        if len(initial) == 0:
            return self.cost_finder()
        opt = nlopt.opt(algorithm_identifier, len(initial))
        opt.set_upper_bounds([np.pi] * len(initial))
        opt.set_lower_bounds([-np.pi] * len(initial))
        opt.set_stopval(stop_val)
        opt.set_ftol_rel(tol)
        opt.set_xtol_abs(1e-10)
        opt.set_min_objective(self._find_cost_with_angles)
        final = opt.optimize(initial)
        co.update_angles_in_circuit(self.full_circuit, final,
                                    self.variational_circuit_range())
        self.compiler._invalidate_current()
        return opt.last_optimum_value()

    def _pybobyqa_minimize(self, alg_kwargs):
        """cost_minimiser.py:160-193: BOBYQA over all variational angles
        with [-pi, pi] bounds and objfun_has_noise; on an exception the
        angles are restored and their cost returned. pybobyqa where
        installed, else optim/bobyqa.py (the same algorithm), logged."""
        initial = co.find_angles_in_circuit(self.full_circuit,
                                            self.variational_circuit_range())
        if len(initial) == 0:
            return self.cost_finder()
        alg_kwargs = dict(alg_kwargs)
        try:
            import pybobyqa
            solve = pybobyqa.solve
            alg_kwargs.pop("stopval", None)  # the own BOBYQA's option only
        except ModuleNotFoundError:
            logger.info("pybobyqa not installed: using the native BOBYQA "
                        "implementation (optim.bobyqa)")
            from . import bobyqa
            solve = bobyqa.solve
        bounds = ([-np.pi] * len(initial), [np.pi] * len(initial))
        try:
            result = solve(self._find_cost_with_angles, initial,
                           bounds=bounds, objfun_has_noise=True,
                           print_progress=False, do_logging=False,
                           **alg_kwargs)
            co.update_angles_in_circuit(self.full_circuit, result.x,
                                        self.variational_circuit_range())
            self.compiler._invalidate_current()
            return result.f
        except Exception as e:  # restore and report (cost_minimiser.py:188)
            logger.error(f"BOBYQA failed with exception: {e}")
            co.update_angles_in_circuit(self.full_circuit, initial,
                                        self.variational_circuit_range())
            self.compiler._invalidate_current()
            return self.cost_finder()

    # --------------------------------------------------- local-minimum escape
    def try_escaping_periodic_local_minimum(self, gap_between_minima,
                                            first_minima_loc, penalty_amp=0.1):
        """Sinusoidal-penalty escape (cost_minimiser.py:197-248): up to five
        Nelder-Mead runs on the cost plus a periodic penalty, the first at
        the penalty's own period, then at random multiples of it (numpy's
        global generator), until the cost falls below where it started."""
        initial_cost = self.cost_finder()
        initial_angles = co.find_angles_in_circuit(
            self.full_circuit, self.variational_circuit_range())
        num_attempts = 5
        stochastic_param = 1

        def cost_with_penalty(angles, grad=None):
            cost = self._find_cost_with_angles(angles, grad)
            penalty = penalty_amp * np.cos(
                np.pi + ((cost - first_minima_loc) * 2 * np.pi
                         * (1 / gap_between_minima) * stochastic_param))
            return cost + penalty

        actual_cost = initial_cost
        for i in range(num_attempts):
            res = minimize(cost_with_penalty, initial_angles,
                           method="Nelder-Mead")
            co.update_angles_in_circuit(self.full_circuit, res.x,
                                        self.variational_circuit_range())
            self.compiler._invalidate_current()
            actual_cost = self.cost_finder()
            logger.debug(f"{i}th attempt to escape minima: initial cost = "
                         f"{initial_cost}, final cost with penalty = "
                         f"{res.fun}, actual final cost = {actual_cost}")
            stochastic_param = np.random.random() * 10
            if actual_cost < initial_cost:
                break
        return actual_cost

    def _update_gradient_of_circuit(self, grad, method="parameter_shift"):
        """The gradient of the cost in every variational angle, written into
        grad (cost_minimiser.py:370-418): by the parameter shift (two cost
        evaluations an angle) or, for any other method, from the sinusoid
        through 0 and +-pi/2."""
        angles = co.find_angles_in_circuit(self.full_circuit)
        angle_index = 0
        for gate_index in range(*self.variational_circuit_range()):
            instr = self.full_circuit.data[gate_index]
            if not instr.is_supported_1q_gate():
                continue
            label = instr.label or instr.name
            current = angles[angle_index]
            if method == "parameter_shift":
                r = 0.5
                shift = np.pi / (4 * r)
                co.replace_1q_gate(self.full_circuit, gate_index, label,
                                   current + shift)
                self.compiler._invalidate_current()
                vp = self.cost_finder()
                co.replace_1q_gate(self.full_circuit, gate_index, label,
                                   current - shift)
                self.compiler._invalidate_current()
                vm = self.cost_finder()
                grad[angle_index] = r * (vp - vm)
            else:
                vals = []
                for theta in (0, np.pi / 2, -np.pi / 2):
                    co.replace_1q_gate(self.full_circuit, gate_index, label,
                                       theta)
                    self.compiler._invalidate_current()
                    vals.append(self.cost_finder())
                grad[angle_index] = derivative_of_sinusoidal(current, *vals)
            co.replace_1q_gate(self.full_circuit, gate_index, label, current)
            self.compiler._invalidate_current()
            angle_index += 1
