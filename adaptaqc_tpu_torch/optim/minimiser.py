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

The generic optimisers (scipy, nlopt, BOBYQA) and the subsampled device
sweep (rotosolve_fraction < 1 with Rotosolve) are not ported yet and raise
NotImplementedError.
"""

from __future__ import annotations

import logging
import random
from typing import Optional, Tuple

import numpy as np

from ..backends.backend import softening_alpha
from ..circuits import operations as co
from ..circuits.tape import compile_tape, select_mask, writeback_angles
from ..utils import constants as vconstants
from .sinusoidal import has_stopped_improving, minimum_of_sinusoidal
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
                 rotosolve_fraction=1.0):
        self.cost_finder = cost_finder
        self.variational_circuit_range = variational_circuit_range
        self.compiler = compiler
        self.rotosolve_fraction = rotosolve_fraction

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
        if algorithm_kind in (vconstants.ALG_ROTOSOLVE,
                              vconstants.ALG_ROTOSELECT):
            rotoselect = algorithm_kind == vconstants.ALG_ROTOSELECT
            if self._can_fast_sweep(force_global=force_global):
                if self.rotosolve_fraction < 1.0 and not rotoselect:
                    raise NotImplementedError(
                        "the subsampled device sweep (rotosolve_fraction "
                        "< 1) is not ported yet (ROADMAP.md)")
                return self._roto_device(rotoselect, max_cycles, stop_val,
                                         tol, indexes_to_modify)
            if self._can_full_sweep(rotoselect):
                return self._roto_device_full(rotoselect, max_cycles,
                                              stop_val, tol,
                                              indexes_to_modify)
            return self._roto_host(rotoselect, max_cycles, stop_val, tol,
                                   indexes_to_modify)
        raise NotImplementedError(
            f"optimiser {algorithm_kind!r} is not ported yet (ROADMAP.md)")

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
        """What both device sweeps start from: (prefix state, tape, its
        range in full_circuit, select mask). Gates left of the modify
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
        return prefix, tape, tape_range, select_mask(tape, base_indices)

    def _roto_device_full(self, rotoselect, max_cycles, stop_val, tol,
                          indexes_to_modify):
        comp = self.compiler
        alg_name = "ROTOSELECT" if rotoselect else "ROTOSOLVE"
        prefix, tape, tape_range, mask = self._sweep_tape(indexes_to_modify)
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
        prefix, tape, tape_range, mask = self._sweep_tape(indexes_to_modify)
        ref = comp.backend.zero_ref(comp)
        engine = comp.backend.sweep_engine()
        bl = sweeps.default_block_len(tape.padded_length,
                                      sweeps.state_nbytes(prefix))
        logger.info(f"Starting {alg_name}")
        kinds, angles = tape.kinds, tape.angles
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
