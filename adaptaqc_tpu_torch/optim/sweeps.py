"""Rotosolve / Rotoselect sweeps over an engine.

Counterpart of the JAX package's `optim/sweeps.py`: the O(G) overlap sweep
(sweep, sweep_until_converged, sweep_n_cycles) and, below it, the full-cost
sweep of the local and softened costs (sweep_full_chunk and its loops). The
overlap sweep over a tape of G gates costs
O(G) gate applies instead of the O(G^2) of re-simulating the circuit per
probe:

 - left states L_k (gates < k applied to the prefix) advance gate by gate;
 - right states R_k = (U_{k+1} ... U_G)^dagger |ref> come from a
   block-checkpointed backward pass (one block when the whole buffer fits
   the memory budget, which skips the checkpoint pass);
 - every probe of a rotation on qubit q reads the 2x2 local overlap matrix
   C[i, j] = <R_k| |i><j|_q |L_{k-1}>, from which the best angle (and, for
   Rotoselect, axis) follows in closed form.

Gate updates are sequential coordinate descent: gate k's probe sees gates
< k already updated and gates > k at their old values.

Two opt-in modes, off by default as in the JAX package: an engine with
`env_ops` (the MPS engine under ADAPTAQC_ENVCACHE) advances its probes'
transfer environments incrementally, O(distance between consecutive probed
sites) site steps a probe instead of one O(n) chain; and zigzag cycles
(`sweep_zigzag_until_converged`, ADAPTAQC_ZIGZAG) alternate direction and
reuse the states the previous cycle emitted, G gate applies a cycle
instead of 2G.

The tape is host data: gate kinds and sites steer plain Python control flow.
The angles and the (possibly re-chosen) rotation kinds live on the device
for the whole sweep, and the probe's choice is applied from there, so a
sweep synchronises with the device once, at its end, to read the final
overlap; the kinds and angles are read back once per `sweep` call.
"""

from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .. import config
from ..backends import sv_core
from ..circuits import gates as G
from .sinusoidal import has_stopped_improving, minimum_of_sinusoidal_dev

# cost evaluations one probe stands for (cost_minimiser.py:318-342)
ROTOSELECT_EVALS = 7  # 1 identity + 2 per axis
ROTOSOLVE_EVALS = 3


class EnvOps(NamedTuple):
    """Incremental probe environments (the JAX package's EnvOps). An engine
    that caches transfer environments between the sweep's R and L states
    exposes:

      init(state) -> env                 a fresh cache for one sweep
      touch(env, t0, t1) -> env          a gate moved sites t0..t1 of the
                                         R or the L state
      probe(env, r_state, l_state, q) -> (C (2, 2), env)
                                         advance to site q and contract
    """
    init: Callable[..., Any]
    touch: Callable[..., Any]
    probe: Callable[..., Any]


class SweepEngine(NamedTuple):
    """What the sweep needs from a simulation engine."""
    name: str
    # (state, kind: int, q0: int, q1: int, u4 (4, 4)) -> state
    apply: Callable[..., Any]
    # (r_state, l_state, q) -> complex (2, 2), C[i,j] = <R| |i><j|_q |L>
    local_overlap: Callable[..., Any]
    # (a, b) -> complex 0-dim tensor <a|b>
    overlap: Callable[..., Any]
    # optional (state, ref) -> (global cost, local cost, Hamming-1 sum), each
    # real 0-dim, or (P,) for a batch of probe states: the probe costs of
    # the full-cost sweep. An engine with cost_terms also takes a batch of
    # states in `apply`, and a batch of one-qubit matrices (P, 4, 4) there.
    cost_terms: Any = None
    # optional (state, u2s (n, 2, 2)) -> state: u2s[i] applied at site i,
    # every site in one call. With it the full-cost sweep applies a run of
    # one-qubit gates as one operation (identities elsewhere).
    apply_1q_layer: Any = None
    # optional EnvOps: incremental probe environments for the overlap sweep
    env_ops: Any = None


def _abs2(z):
    return z.real * z.real + z.imag * z.imag


def _best_from_overlap_matrix(Cm, kind, rotoselect: bool):
    """Closed-form best (kind, angle, |z|^2) from the 2x2 local overlap
    matrix; all three are tensors on Cm's device.

    For U(theta) = cos(theta/2) I - i sin(theta/2) P:
    z(theta) = cos(theta/2) tr(C) - i sin(theta/2) tr(P C). The probe
    maximises |z(theta)|^2 rather than minimising 1 - |z|^2, which pins at
    exactly 1 in float32 once the overlap is tiny."""
    t_i = Cm[0, 0] + Cm[1, 1]
    t_x = Cm[0, 1] + Cm[1, 0]
    t_y = 1j * (Cm[1, 0] - Cm[0, 1])
    t_z = Cm[0, 0] - Cm[1, 1]
    ip = 1j * torch.stack([t_x, t_y, t_z])
    ov2_0 = _abs2(t_i)
    ov2_p = _abs2(t_i - ip) * 0.5
    ov2_m = _abs2(t_i + ip) * 0.5
    thetas, neg_max = minimum_of_sinusoidal_dev(-ov2_0, -ov2_p, -ov2_m)
    ov2s = -neg_max
    # pick with gather: indexing by a 0-dim device tensor reads it back to
    # the host (one sync per index)
    if rotoselect:
        axis = torch.argmax(ov2s).reshape(1)
        kind = G.RX + axis[0]
    else:
        axis = torch.clamp(kind - G.RX, 0, 2).reshape(1)
    return kind, thetas.gather(0, axis)[0], ov2s.gather(0, axis)[0]


def _take_best(cm, kinds, angles, i, rotoselect, dtype):
    """Write the best kind and angle of tape entry i, from its probe's 2x2
    local overlap matrix, into the device tensors kinds and angles; return
    the entry's new 4x4 matrix."""
    kinds[i], angles[i], _ = _best_from_overlap_matrix(cm, kinds[i],
                                                       rotoselect)
    return sv_core.build_u4(kinds[i:i + 1], angles[i:i + 1], dtype)[0]


def _sweep(engine, block_len, rotoselect, prefix_state, ref_state, struct,
           q0s, q1s, kinds, angles, select):
    """One cycle on device tensors. `struct` (host) holds the tape's kinds
    as compiled (a Rotoselect change keeps a rotation a rotation, so it
    decides 1q/2q/NOP); `kinds`/`angles` are the current device values.
    Returns (kinds, angles, final_state, final_ov2 tensor, n_evals)."""
    gp = len(struct)
    bl = min(block_len, gp)
    if gp % bl:
        raise ValueError(f"padded tape length {gp} not a multiple of {bl}")
    nb = gp // bl
    dtype = prefix_state.dtype
    u_old = sv_core.build_u4(kinds, angles, dtype)
    u_old_h = u_old.mH
    kinds = kinds.clone()
    angles = angles.clone()
    per_probe = ROTOSELECT_EVALS if rotoselect else ROTOSOLVE_EVALS

    # phase A: ckpts[b] = ref with the adjoints of all blocks > b applied;
    # a single block needs none beyond ref itself
    ckpts = [None] * nb
    state = ref_state
    ckpts[nb - 1] = state
    for b in range(nb - 1, 0, -1):
        for i in range((b + 1) * bl - 1, b * bl - 1, -1):
            state = engine.apply(state, struct[i], q0s[i], q1s[i], u_old_h[i])
        ckpts[b - 1] = state

    # phase B: forward sweep, regenerating each block's right states. With
    # env_ops the probe's environments advance incrementally; gate i moves
    # both states at its sites (R_{i-1} -> R_i before its probe, L gains it
    # after), so the cache is told before and after the probe. An
    # unselected gate is skipped: the JAX package probes it with a mask
    # inside lax.cond, which leaves the same cache.
    env_ops = engine.env_ops
    env = None if env_ops is None else env_ops.init(prefix_state)
    l_state = prefix_state
    evals = 0
    for b in range(nb):
        r_buf = [None] * bl
        r_state = ckpts[b]
        for j in range(bl - 1, -1, -1):
            r_buf[j] = r_state
            i = b * bl + j
            if j > 0:
                r_state = engine.apply(r_state, struct[i], q0s[i], q1s[i],
                                       u_old_h[i])
        for j in range(bl):
            i = b * bl + j
            k = struct[i]
            if k == G.NOP:
                continue
            u = u_old[i]
            if env is not None:
                t1 = q1s[i] if sv_core.is_two_qubit(k) else q0s[i]
                env = env_ops.touch(env, q0s[i], t1)
            if select[i]:
                if env is None:
                    cm = engine.local_overlap(r_buf[j], l_state, q0s[i])
                else:
                    cm, env = env_ops.probe(env, r_buf[j], l_state, q0s[i])
                    env = env_ops.touch(env, q0s[i], t1)
                u = _take_best(cm, kinds, angles, i, rotoselect, dtype)
                evals += per_probe
            l_state = engine.apply(l_state, k, q0s[i], q1s[i], u)
    final_ov2 = _abs2(engine.overlap(ref_state, l_state))
    return kinds, angles, l_state, final_ov2, evals


def _device_tape(state, kinds, angles):
    dev = state.device
    return (torch.as_tensor(np.asarray(kinds), dtype=torch.long, device=dev),
            torch.as_tensor(np.asarray(angles),
                            dtype=config.real_dtype(state.dtype), device=dev))


def _host_structure(kinds, q0s, q1s, select):
    return (np.asarray(kinds).tolist(), np.asarray(q0s).tolist(),
            np.asarray(q1s).tolist(), np.asarray(select, dtype=bool).tolist())


def sweep(engine: SweepEngine, block_len: int, rotoselect: bool,
          prefix_state, ref_state, kinds, q0s, q1s, angles, select):
    """One Rotosolve/Rotoselect cycle over the tape (host arrays in).
    Returns (new_kinds, new_angles, final_cost, final_state, n_evals,
    final_ov2), where final_ov2 = |<ref|final>|^2 and final_cost is
    1 - final_ov2 (floats; kinds and angles as numpy arrays)."""
    struct, q0l, q1l, sel = _host_structure(kinds, q0s, q1s, select)
    kd, ad = _device_tape(prefix_state, kinds, angles)
    kd, ad, state, ov2, evals = _sweep(engine, block_len, rotoselect,
                                       prefix_state, ref_state, struct, q0l,
                                       q1l, kd, ad, sel)
    ov2 = float(ov2)
    return (kd.cpu().numpy().astype(np.int32), ad.cpu().numpy(), 1.0 - ov2,
            state, evals, ov2)


def default_block_len(padded_len: int, state_bytes: int = None,
                      memory_budget: int = None) -> int:
    """Block size of the right-state checkpointing: one block when the
    whole tape's right-state buffer fits `memory_budget` bytes (default
    4e9, or the environment's ADAPTAQC_SWEEP_MEMORY_BUDGET; the checkpoint
    pass is then skipped: 2G applies per sweep instead of 3G), else a
    sqrt-style block size."""
    if state_bytes:
        budget = memory_budget or int(float(os.environ.get(
            "ADAPTAQC_SWEEP_MEMORY_BUDGET", 4e9)))
        if padded_len * state_bytes <= budget:
            return padded_len
    for bl in (32, 16, 8, 4, 2, 1):
        if padded_len % bl == 0 and bl * bl <= 4 * padded_len:
            return bl
    return 1


def state_nbytes(state) -> int:
    """Total bytes this process holds of one engine state: a statevector
    tensor, or the tensors of a tuple (an MPS; a center-gauge state also
    carries its center, an int); of a state sharded over a device mesh,
    the rank's shard (the memory budgets are a rank's). Iterating a tensor
    would walk its elements one by one."""
    def held(t):
        t = t.to_local() if hasattr(t, "to_local") else t
        return t.numel() * t.element_size()
    if isinstance(state, torch.Tensor):
        return held(state)
    return sum(held(t) for t in state if isinstance(t, torch.Tensor))


def _stopped_improving(hist3, rel_tol) -> bool:
    """Linear-fit slope over |mean| of a 3-value window
    (utilityfunctions.py:272-278)."""
    slope = (hist3[2] - hist3[0]) / 2.0
    mean = abs(hist3[0] + hist3[1] + hist3[2]) / 3.0
    return slope / max(mean, 1e-30) > -rel_tol


def _cycles_stopped(cycles, hist, ov2_hist, tol) -> bool:
    """The overlap sweeps' improvement test: after 3 cycles, stop when
    neither the cost history nor the overlap^2 history (which grows while
    improving, and still moves where a float32 cost pins at 1) moves by
    `tol` over its 3-value window."""
    if cycles <= 3:
        return False
    ov2_slope = (ov2_hist[2] - ov2_hist[0]) / 2.0
    ov2_mean = abs(sum(ov2_hist)) / 3.0
    ov2_stopped = ov2_slope / max(ov2_mean, 1e-30) < tol
    return _stopped_improving(hist, tol) and ov2_stopped


def apply_all(engine: SweepEngine, state, kinds, q0s, q1s, angles):
    """State after every gate of the tape (host arrays)."""
    struct, q0l, q1l, _ = _host_structure(kinds, q0s, q1s, kinds)
    kd, ad = _device_tape(state, kinds, angles)
    u4s = sv_core.build_u4(kd, ad, state.dtype)
    for i, k in enumerate(struct):
        state = engine.apply(state, k, q0l[i], q1l[i], u4s[i])
    return state


def sweep_until_converged(engine: SweepEngine, block_len: int,
                          rotoselect: bool, max_cycles: int, prefix_state,
                          ref_state, kinds, q0s, q1s, angles, select,
                          stop_val, tol, init_state=None):
    """Rotosolve/Rotoselect cycles until converged (cost_minimiser.py:90-105):
    sweep while cost > stop_val, cycles < max_cycles, and either the cost or
    the overlap^2 history still moves by `tol` (after 3 cycles).

    `init_state`: the engine state of prefix + tape at the input angles when
    the caller already holds it; None has it computed here.

    Returns (kinds, angles, final_cost, cycles, evals, final_state, cost0);
    cost0 is the cost at the input angles (the minimiser's backwards
    guard)."""
    if init_state is None:
        init_state = apply_all(engine, prefix_state, kinds, q0s, q1s, angles)
    ov2_0 = float(_abs2(engine.overlap(ref_state, init_state)))
    cost0 = 1.0 - ov2_0
    struct, q0l, q1l, sel = _host_structure(kinds, q0s, q1s, select)
    kd, ad = _device_tape(prefix_state, kinds, angles)
    cost = cost0
    hist = [1e30, 1e30, 1e30]
    ov2_hist = [0.0, 0.0, 0.0]
    cycles = 0
    evals = 1
    state = init_state
    while cost > stop_val and cycles < max_cycles:
        if _cycles_stopped(cycles, hist, ov2_hist, tol):
            break
        kd, ad, state, ov2_t, ev = _sweep(engine, block_len, rotoselect,
                                          prefix_state, ref_state, struct,
                                          q0l, q1l, kd, ad, sel)
        ov2 = float(ov2_t)
        cost = 1.0 - ov2
        hist = [hist[1], hist[2], cost]
        ov2_hist = [ov2_hist[1], ov2_hist[2], ov2]
        cycles += 1
        evals += ev
    return (kd.cpu().numpy().astype(np.int32), ad.cpu().numpy(), cost,
            cycles, evals, state, cost0)


def sweep_n_cycles(engine: SweepEngine, block_len: int, rotoselect: bool,
                   cycles: int, prefix_state, ref_state, kinds, q0s, q1s,
                   angles, select):
    """Exactly `cycles` sweeps, no convergence test (the fixed-budget and
    benchmarking variant). Returns (kinds, angles, final_cost, evals)."""
    struct, q0l, q1l, sel = _host_structure(kinds, q0s, q1s, select)
    kd, ad = _device_tape(prefix_state, kinds, angles)
    evals = 0
    ov2_t = None
    for _ in range(cycles):
        kd, ad, _, ov2_t, ev = _sweep(engine, block_len, rotoselect,
                                      prefix_state, ref_state, struct, q0l,
                                      q1l, kd, ad, sel)
        evals += ev
    cost = float("nan") if ov2_t is None else 1.0 - float(ov2_t)
    return kd.cpu().numpy().astype(np.int32), ad.cpu().numpy(), cost, evals


# ------------------------------------------------------------ zigzag mode
# Alternating-direction coordinate descent (the JAX package's zigzag mode,
# opt-in through CostMinimiser(zigzag=True) or ADAPTAQC_ZIGZAG=1). A
# standard cycle pays 2G gate applies: the right states, then the probe
# pass. Zigzag cycles alternate direction and reuse the states the previous
# cycle emitted:
#
#   forward cycle, k = 0 .. G-1: the probe of gate k reads R_k from the
#       buffer the previous backward cycle wrote; the carried L advances
#       through each updated gate; the states L_{k-1} in front of each gate
#       are emitted;
#   backward cycle, k = G-1 .. 0: the probe reads L_{k-1} from that buffer;
#       the carried R advances through each updated gate's adjoint
#       (u4^H); the states R_k are emitted.
#
# Every probe sees every other gate at its latest value, so this is exact
# coordinate descent in another visiting order, at G applies a cycle. The
# buffers hold references to states the engine returned (an apply makes a
# new state), so a buffer costs no copy.


def _zz_forward(engine, rotoselect, prefix_state, ref_state, struct, q0s,
                q1s, kinds, angles, select, r_buf):
    """One forward probe cycle on device tensors. Returns (kinds, angles,
    ov2 tensor, l_final, n_evals, l_buf); l_buf[k] is the state in front
    of gate k, which a backward cycle probes gate k with."""
    dtype = prefix_state.dtype
    u_old = sv_core.build_u4(kinds, angles, dtype)
    kinds, angles = kinds.clone(), angles.clone()
    per_probe = ROTOSELECT_EVALS if rotoselect else ROTOSOLVE_EVALS
    l_state, evals = prefix_state, 0
    l_buf = [None] * len(struct)
    for i, k in enumerate(struct):
        l_buf[i] = l_state
        if k == G.NOP:
            continue
        u = u_old[i]
        if select[i]:
            cm = engine.local_overlap(r_buf[i], l_state, q0s[i])
            u = _take_best(cm, kinds, angles, i, rotoselect, dtype)
            evals += per_probe
        l_state = engine.apply(l_state, k, q0s[i], q1s[i], u)
    ov2 = _abs2(engine.overlap(ref_state, l_state))
    return kinds, angles, ov2, l_state, evals, l_buf


def _zz_backward(engine, rotoselect, prefix_state, ref_state, struct, q0s,
                 q1s, kinds, angles, select, l_buf):
    """One backward probe cycle (gates G-1 .. 0). Returns (kinds, angles,
    ov2 tensor, n_evals, r_buf) with r_buf[k] = R_k for the next forward
    cycle. ov2 = |<(U tape)^H ref|prefix>|^2 = |<ref|U tape|prefix>|^2."""
    dtype = prefix_state.dtype
    u_old = sv_core.build_u4(kinds, angles, dtype)
    kinds, angles = kinds.clone(), angles.clone()
    per_probe = ROTOSELECT_EVALS if rotoselect else ROTOSOLVE_EVALS
    r_state, evals = ref_state, 0
    r_buf = [None] * len(struct)
    for i in range(len(struct) - 1, -1, -1):
        r_buf[i] = r_state
        k = struct[i]
        if k == G.NOP:
            continue
        u = u_old[i]
        if select[i]:
            cm = engine.local_overlap(r_state, l_buf[i], q0s[i])
            u = _take_best(cm, kinds, angles, i, rotoselect, dtype)
            evals += per_probe
        r_state = engine.apply(r_state, k, q0s[i], q1s[i], u.mH)
    ov2 = _abs2(engine.overlap(r_state, prefix_state))
    return kinds, angles, ov2, evals, r_buf


def _zz_right_states(engine, ref_state, struct, q0s, q1s, kinds, angles):
    """The R states at the input angles (r_buf[k] = R_k) and the state of
    every adjoint applied to ref, whose overlap with the prefix gives the
    input angles' cost."""
    u_h = sv_core.build_u4(kinds, angles, ref_state.dtype).mH
    r_state = ref_state
    r_buf = [None] * len(struct)
    for i in range(len(struct) - 1, -1, -1):
        r_buf[i] = r_state
        if struct[i] != G.NOP:
            r_state = engine.apply(r_state, struct[i], q0s[i], q1s[i],
                                   u_h[i])
    return r_buf, r_state


def sweep_zigzag_until_converged(engine: SweepEngine, rotoselect: bool,
                                 max_cycles: int, prefix_state, ref_state,
                                 kinds, q0s, q1s, angles, select, stop_val,
                                 tol):
    """Zigzag cycles until converged (single block), under
    sweep_until_converged's stop test: (forward, backward) pairs while
    cost > stop_val, cycles < max_cycles and the cost or the overlap^2
    history still moves by `tol` (after 3 cycles), then one forward cycle,
    so that the returned state is prefix + tape at the returned angles.
    The initial backward build of the R states also gives the input
    angles' cost, so the tape is not re-simulated for it.

    Returns (kinds, angles, final_cost, cycles, evals, final_state, cost0),
    as sweep_until_converged."""
    struct, q0l, q1l, sel = _host_structure(kinds, q0s, q1s, select)
    kd, ad = _device_tape(prefix_state, kinds, angles)
    r_buf, r_final = _zz_right_states(engine, ref_state, struct, q0l, q1l,
                                      kd, ad)
    cost0 = 1.0 - float(_abs2(engine.overlap(r_final, prefix_state)))
    cost = cost0
    hist = [1e30, 1e30, 1e30]
    ov2_hist = [0.0, 0.0, 0.0]
    cycles, evals = 0, 1
    while cost > stop_val and cycles < max_cycles:
        if _cycles_stopped(cycles, hist, ov2_hist, tol):
            break
        kd, ad, _, _, ev_f, l_buf = _zz_forward(
            engine, rotoselect, prefix_state, ref_state, struct, q0l, q1l,
            kd, ad, sel, r_buf)
        kd, ad, ov2_t, ev_b, r_buf = _zz_backward(
            engine, rotoselect, prefix_state, ref_state, struct, q0l, q1l,
            kd, ad, sel, l_buf)
        ov2 = float(ov2_t)
        cost = 1.0 - ov2
        hist = [hist[1], hist[2], cost]
        ov2_hist = [ov2_hist[1], ov2_hist[2], ov2]
        cycles += 2
        evals += ev_f + ev_b
    kd, ad, ov2_t, l_final, ev_f, _ = _zz_forward(
        engine, rotoselect, prefix_state, ref_state, struct, q0l, q1l, kd,
        ad, sel, r_buf)
    return (kd.cpu().numpy().astype(np.int32), ad.cpu().numpy(),
            1.0 - float(ov2_t), cycles + 1, evals + ev_f, l_final, cost0)


def sweep_zigzag_n_cycles(engine: SweepEngine, rotoselect: bool, pairs: int,
                          prefix_state, ref_state, kinds, q0s, q1s, angles,
                          select):
    """Exactly `pairs` (forward, backward) zigzag pairs, no convergence
    test (the fixed-budget and benchmarking variant): 2 pairs update
    cycles for (2 pairs + 1) G gate applies, against 4 pairs G for the
    standard sweep. Returns (kinds, angles, final_cost, evals)."""
    struct, q0l, q1l, sel = _host_structure(kinds, q0s, q1s, select)
    kd, ad = _device_tape(prefix_state, kinds, angles)
    r_buf, _ = _zz_right_states(engine, ref_state, struct, q0l, q1l, kd, ad)
    evals, ov2_t = 0, None
    for _ in range(pairs):
        kd, ad, _, _, ev_f, l_buf = _zz_forward(
            engine, rotoselect, prefix_state, ref_state, struct, q0l, q1l,
            kd, ad, sel, r_buf)
        kd, ad, ov2_t, ev_b, r_buf = _zz_backward(
            engine, rotoselect, prefix_state, ref_state, struct, q0l, q1l,
            kd, ad, sel, l_buf)
        evals += ev_f + ev_b
    cost = float("nan") if ov2_t is None else 1.0 - float(ov2_t)
    return kd.cpu().numpy().astype(np.int32), ad.cpu().numpy(), cost, evals


# ------------------------------------------------------- full-cost sweep
# The local cost and the softened global cost are not one overlap, so no
# 2x2 local matrix gives their probes: every probe is a re-simulation of
# the rest of the circuit. For trainable gate k the 3 (Rotosolve) or 7
# (Rotoselect) probe states start as one batch from the left state, every
# gate behind k is applied to the whole batch at once (a run of one-qubit
# gates as one operation, where the engine can), and the costs of the batch
# come from engine.cost_terms. A cycle is O(G^2 / 2) batched applies.
# cost = w_global * global + w_local * local - alpha * hamming1
# (w_local = 1 for optimise_local_cost; alpha = |previous cost -
# sufficient cost| for soften_global_cost).

_SELECT_KINDS = (G.RX, G.RX, G.RX, G.RY, G.RY, G.RZ, G.RZ)
_SELECT_ANGLES = (0.0, np.pi / 2, -np.pi / 2, np.pi / 2, -np.pi / 2,
                  np.pi / 2, -np.pi / 2)
_SOLVE_ANGLES = (0.0, np.pi / 2, -np.pi / 2)

# bytes the probe batch of one gate may take: above it the probes go
# through the suffix in blocks (a 26-qubit statevector is 512 MiB a probe;
# an MPS batch is a few megabytes and never splits)
PROBE_MEMORY_BUDGET = int(4e9)

# what the full-cost sweep did since these were last set to 0 (plain host
# counts; a batched apply is one engine.apply on a batch of probe states)
full_sweep_counts = {"calls": 0, "cycles": 0, "probed_gates": 0,
                     "batched_applies": 0, "batched_2q_applies": 0}


_PROBE_CONSTANTS = {}  # (device, dtype) -> the probes' kinds and angles


def _probe_specs(rotoselect: bool, kind, angles):
    """(probe kinds, probe angles) of one gate, on the device of `angles`:
    Rotosolve probes the gate's own axis at {0, +pi/2, -pi/2}; Rotoselect
    the identity (rx 0) and +-pi/2 on each axis, the reference's 7
    evaluations (cost_minimiser.py:318-342). The constants are uploaded
    once per device (an upload synchronises)."""
    dev, dt = angles.device, angles.dtype
    consts = _PROBE_CONSTANTS.get((str(dev), dt))
    if consts is None:
        consts = (torch.tensor(_SELECT_KINDS, dtype=torch.long, device=dev),
                  torch.tensor(_SELECT_ANGLES, dtype=dt, device=dev),
                  torch.tensor(_SOLVE_ANGLES, dtype=dt, device=dev))
        _PROBE_CONSTANTS[(str(dev), dt)] = consts
    if rotoselect:
        return consts[0], consts[1]
    return kind.reshape(1).expand(3), consts[2]


def full_cost_of(engine: SweepEngine, ref_state, weights, state):
    """The weighted probe cost of a state (a real 0-dim tensor), or of
    every state of a batch ((P,))."""
    g, loc, h1 = engine.cost_terms(state, ref_state)
    return weights[0] * g + weights[1] * loc - weights[2] * h1


def _suffix_plans(engine, struct, q0s, u_all, lo, n_sites):
    """plans[j], for lo < j <= G: the operations that apply tape entries
    j .. G-1 at their current values, as a linked list (op, rest) ending in
    None. An op is ("gate", index), or, on an engine with apply_1q_layer,
    ("run", u2s): a run of consecutive one-qubit entries as one (n, 2, 2)
    stack (gates on different sites commute; gates on one site are
    multiplied; the identity elsewhere). The entries behind a probed gate
    keep their start-of-cycle values until the cycle reaches them, so the
    plans are built once a call, back to front, each sharing its tail with
    the next. Sites are indexed by host ints only: an index tensor made
    from a list would be an upload, and a synchronisation, per operation."""
    gp = len(struct)
    plans = [None] * (gp + 1)
    eye = None
    for j in range(gp - 1, lo, -1):
        k, rest = struct[j], plans[j + 1]
        if k == G.NOP:
            plans[j] = rest
        elif sv_core.is_two_qubit(k) or engine.apply_1q_layer is None:
            plans[j] = (("gate", j), rest)
        else:
            if rest is not None and rest[0][0] == "run":  # extend that run
                stack, rest = rest[0][1].clone(), rest[1]
            else:
                if eye is None:
                    eye = torch.eye(2, dtype=u_all.dtype,
                                    device=u_all.device).repeat(n_sites, 1, 1)
                stack = eye.clone()
            q = q0s[j]
            stack[q] = stack[q] @ u_all[j][:2, :2]  # entry j acts first
            plans[j] = (("run", stack), rest)
    return plans


def _probe_costs(engine, l_state, ref_state, struct, q0s, q1s, u_all, i,
                 probe_u4, weights, plan):
    """Costs (P,) of the P probe gates at tape entry i: each applied to
    l_state, then every entry behind i at its current value (`plan`)."""
    per_state = max(state_nbytes(l_state), 1)
    block = max(1, PROBE_MEMORY_BUDGET // (3 * per_state))
    costs = []
    for lo in range(0, probe_u4.shape[0], block):
        probes = engine.apply(l_state, struct[i], q0s[i], q1s[i],
                              probe_u4[lo:lo + block])
        node = plan
        while node is not None:
            op, node = node
            full_sweep_counts["batched_applies"] += 1
            if op[0] == "run":
                probes = engine.apply_1q_layer(probes, op[1])
                continue
            j = op[1]
            probes = engine.apply(probes, struct[j], q0s[j], q1s[j],
                                  u_all[j])
            if sv_core.is_two_qubit(struct[j]):
                full_sweep_counts["batched_2q_applies"] += 1
        costs.append(full_cost_of(engine, ref_state, weights, probes))
    return costs[0] if len(costs) == 1 else torch.cat(costs)


def _full_chunk(engine, rotoselect, lo, hi, l_state, ref_state, struct, q0s,
                q1s, kinds, angles, select, weights):
    """Entries lo .. hi-1 of one full-cost cycle on device tensors (kinds
    and angles are updated in place). Returns (l_state, n_evals). No host
    synchronisation: the probe's choice is made and applied on the device."""
    dtype = l_state.dtype
    u_all = sv_core.build_u4(kinds, angles, dtype)
    plans = _suffix_plans(engine, struct, q0s, u_all, lo,
                          getattr(l_state, "n", None))
    evals = 0
    for i in range(lo, min(hi, len(struct))):
        k = struct[i]
        if k == G.NOP:
            continue
        u = u_all[i]
        if select[i]:
            pk, pa = _probe_specs(rotoselect, kinds[i], angles)
            costs = _probe_costs(engine, l_state, ref_state, struct, q0s,
                                 q1s, u_all, i,
                                 sv_core.build_u4(pk, pa, dtype), weights,
                                 plans[i + 1])
            if rotoselect:
                thetas, mins = minimum_of_sinusoidal_dev(
                    costs[0].expand(3), costs[1::2], costs[2::2])
                best = torch.argmin(mins).reshape(1)
                kinds[i] = G.RX + best[0]
                angles[i] = thetas.gather(0, best)[0]
            else:
                angles[i] = minimum_of_sinusoidal_dev(costs[0], costs[1],
                                                      costs[2])[0]
            u = sv_core.build_u4(kinds[i:i + 1], angles[i:i + 1], dtype)[0]
            u_all[i] = u
            evals += costs.shape[0]
            full_sweep_counts["probed_gates"] += 1
        l_state = engine.apply(l_state, k, q0s[i], q1s[i], u)
    return l_state, evals


def _host_tape(kd, ad):
    return kd.cpu().numpy().astype(np.int32), ad.cpu().numpy()


def _own_device_tape(state, kinds, angles):
    """_device_tape as tensors of the caller's own: _full_chunk writes
    into them, and as_tensor may share a host array's memory."""
    kd, ad = _device_tape(state, kinds, angles)
    return kd.clone(), ad.clone()


def sweep_full_chunk(engine: SweepEngine, rotoselect: bool, chunk_len: int,
                     k_start: int, l_state_in, ref_state, kinds, q0s, q1s,
                     angles, select, weights):
    """Entries k_start .. k_start+chunk_len-1 of one full-cost cycle (host
    arrays in; entries past the tape's end are ignored). l_state_in is the
    state in front of entry k_start. Returns (kinds, angles, l_state_out,
    n_evals). A cycle may be driven in chunks, carrying the left state and
    the tape between calls: the result is that of one whole-tape call."""
    struct, q0l, q1l, sel = _host_structure(kinds, q0s, q1s, select)
    kd, ad = _own_device_tape(l_state_in, kinds, angles)
    l_state, evals = _full_chunk(engine, rotoselect, int(k_start),
                                 int(k_start) + int(chunk_len), l_state_in,
                                 ref_state, struct, q0l, q1l, kd, ad, sel,
                                 weights)
    return (*_host_tape(kd, ad), l_state, evals)


def sweep_full(engine: SweepEngine, rotoselect: bool, prefix_state, ref_state,
               kinds, q0s, q1s, angles, select, weights):
    """One whole-tape full-cost Rotosolve/Rotoselect cycle; `weights` =
    (w_global, w_local, alpha). Returns (new_kinds, new_angles, final_cost,
    final_state, n_evals)."""
    ks, angs, l_state, evals = sweep_full_chunk(
        engine, rotoselect, len(np.asarray(kinds)), 0, prefix_state,
        ref_state, kinds, q0s, q1s, angles, select, weights)
    cost = float(full_cost_of(engine, ref_state, weights, l_state))
    return ks, angs, cost, l_state, evals


def sweep_full_chunked_until_converged(engine: SweepEngine, rotoselect: bool,
                                       max_cycles: int, prefix_state,
                                       ref_state, kinds, q0s, q1s, angles,
                                       select, stop_val, tol, weights,
                                       init_state=None, chunk: int = None):
    """Full-cost cycles until converged, the reference's host loop
    (cost_minimiser.py:90-105): stop at cost <= stop_val, at the cycle
    budget, or when a 3-cycle window of the cost history has stopped
    improving by `tol` (after 3 cycles). The local and softened costs do
    not saturate at 1 as a tiny overlap does, so no overlap^2 history is
    kept. The device is read once a cycle (the cycle's cost).

    `init_state`: the engine state of prefix + tape at the input angles
    when the caller holds it (the compiler's full-state cache); None has it
    computed here by a probe-free pass over the tape. `chunk`: entries a
    call of the inner loop (the whole tape by default; any value gives the
    same result).

    Returns (kinds, angles, final_cost, cycles, evals, final_state, cost0);
    cost0 is the cost at the input angles (the minimiser's backwards
    guard)."""
    full_sweep_counts["calls"] += 1
    struct, q0l, q1l, sel = _host_structure(kinds, q0s, q1s, select)
    kd, ad = _own_device_tape(prefix_state, kinds, angles)
    gp = len(struct)
    chunk = gp if chunk is None else max(1, int(chunk))
    if init_state is None:
        init_state = apply_all(engine, prefix_state, kinds, q0s, q1s, angles)
    cost0 = float(full_cost_of(engine, ref_state, weights, init_state))
    hist = [float("inf")] * 3
    evals, cycles, cost, final_state = 0, 0, None, None
    for cycle in range(int(max_cycles)):
        l_state = prefix_state
        for k0 in range(0, gp, chunk):
            l_state, ev = _full_chunk(engine, rotoselect, k0, k0 + chunk,
                                      l_state, ref_state, struct, q0l, q1l,
                                      kd, ad, sel, weights)
            evals += ev
        final_state = l_state
        cost = float(full_cost_of(engine, ref_state, weights, l_state))
        cycles = cycle + 1
        full_sweep_counts["cycles"] += 1
        hist = [hist[1], hist[2], cost]
        if cost <= float(stop_val):
            break
        if cycles > 3 and has_stopped_improving(hist, float(tol)):
            break
    return (*_host_tape(kd, ad), cost, cycles, evals, final_state, cost0)


def sweep_full_until_converged(engine: SweepEngine, rotoselect: bool,
                               max_cycles: int, prefix_state, ref_state,
                               kinds, q0s, q1s, angles, select, stop_val,
                               tol, weights, init_state=None):
    """sweep_full_chunked_until_converged without its cost0: (kinds,
    angles, final_cost, cycles, evals, final_state)."""
    return sweep_full_chunked_until_converged(
        engine, rotoselect, max_cycles, prefix_state, ref_state, kinds, q0s,
        q1s, angles, select, stop_val, tol, weights, init_state)[:6]
