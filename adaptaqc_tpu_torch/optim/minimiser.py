"""CostMinimiser: angle optimisation over the variational range.

Counterpart of the JAX package's `optim/minimiser.py`, device-sweep branch
only: Rotosolve / Rotoselect run as O(G) sweeps (optim/sweeps.py) over the
backend's engine. The host probe loop, the full-cost (local / softened)
sweep and the generic optimisers (scipy, BOBYQA) are not ported yet; asking
for them raises NotImplementedError (ROADMAP.md).
"""

from __future__ import annotations

import logging

import numpy as np

from ..circuits.tape import compile_tape, select_mask, writeback_angles
from ..utils import constants as vconstants
from .sinusoidal import has_stopped_improving
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
                      alg_kwargs=None):
        if algorithm_kind in (vconstants.ALG_ROTOSOLVE,
                              vconstants.ALG_ROTOSELECT):
            rotoselect = algorithm_kind == vconstants.ALG_ROTOSELECT
            if self._can_fast_sweep() and (self.rotosolve_fraction >= 1.0
                                           or rotoselect):
                return self._roto_device(rotoselect, max_cycles, stop_val,
                                         tol, indexes_to_modify)
            raise NotImplementedError(
                "only the device sweep of the global cost is ported "
                "(no local/softened cost, parameterised labels or "
                "rotosolve_fraction < 1 yet; see ROADMAP.md)")
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

    def _can_fast_sweep(self) -> bool:
        comp = self.compiler
        if comp.optimise_local_cost or comp.soften_global_cost:
            return False
        if comp.backend.sweep_engine() is None:
            return False
        rng = self.variational_circuit_range()
        for i in range(rng[0], len(self.full_circuit.data)):
            lbl = self.full_circuit.data[i].label
            if lbl is not None and ("#" in lbl or "@" in lbl):
                return False
        return True

    def _roto_device(self, rotoselect, max_cycles, stop_val, tol,
                     indexes_to_modify):
        comp = self.compiler
        alg_name = "ROTOSELECT" if rotoselect else "ROTOSOLVE"
        var_range = self.variational_circuit_range()
        if indexes_to_modify is None:
            indexes_to_modify = var_range
        else:
            indexes_to_modify = (max(indexes_to_modify[0], var_range[0]),
                                 min(indexes_to_modify[1], var_range[1]))

        # gates left of the modify window are fixed for the whole call:
        # advance the prefix past them once (or take the compiler's advance
        # hint, the state up to the window peeled from its full-state cache)
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

        # the tape covers the modify window and the fixed gates after it
        tape_range = (tape_start, len(self.full_circuit.data))
        tape = compile_tape(self.full_circuit, tape_range)
        base_indices = [i - tape_range[0] for i in range(*indexes_to_modify)]
        mask = select_mask(tape, base_indices)

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
