"""Rotosolve / Rotoselect sweep over an engine.

Counterpart of the JAX package's `optim/sweeps.py` (sweep,
sweep_until_converged, sweep_n_cycles). A sweep over a tape of G gates costs
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

The tape is host data: gate kinds and sites steer plain Python control flow.
The angles and the (possibly re-chosen) rotation kinds live on the device
for the whole sweep, and the probe's choice is applied from there, so a
sweep synchronises with the device once, at its end, to read the final
overlap; the kinds and angles are read back once per `sweep` call.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .. import config
from ..backends import sv_core
from ..circuits import gates as G
from .sinusoidal import minimum_of_sinusoidal_dev

# cost evaluations one probe stands for (cost_minimiser.py:318-342)
ROTOSELECT_EVALS = 7  # 1 identity + 2 per axis
ROTOSOLVE_EVALS = 3


class SweepEngine(NamedTuple):
    """What the sweep needs from a simulation engine."""
    name: str
    # (state, kind: int, q0: int, q1: int, u4 (4, 4)) -> state
    apply: Callable[..., Any]
    # (r_state, l_state, q) -> complex (2, 2), C[i,j] = <R| |i><j|_q |L>
    local_overlap: Callable[..., Any]
    # (a, b) -> complex 0-dim tensor <a|b>
    overlap: Callable[..., Any]


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

    # phase B: forward sweep, regenerating each block's right states
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
            if select[i]:
                cm = engine.local_overlap(r_buf[j], l_state, q0s[i])
                nk, na, _ = _best_from_overlap_matrix(cm, kinds[i], rotoselect)
                kinds[i] = nk
                angles[i] = na
                u = sv_core.build_u4(kinds[i:i + 1], angles[i:i + 1], dtype)[0]
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
                      memory_budget: int = int(4e9)) -> int:
    """Block size of the right-state checkpointing: one block when the
    whole tape's right-state buffer fits `memory_budget` bytes (the
    checkpoint pass is then skipped: 2G applies per sweep instead of 3G),
    else a sqrt-style block size."""
    if state_bytes and padded_len * state_bytes <= memory_budget:
        return padded_len
    for bl in (32, 16, 8, 4, 2, 1):
        if padded_len % bl == 0 and bl * bl <= 4 * padded_len:
            return bl
    return 1


def state_nbytes(state) -> int:
    """Total bytes of one engine state: a statevector tensor, or a tuple of
    tensors (an MPS). Iterating a tensor would walk its elements one by
    one."""
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    return sum(t.numel() * t.element_size() for t in state)


def _stopped_improving(hist3, rel_tol) -> bool:
    """Linear-fit slope over |mean| of a 3-value window
    (utilityfunctions.py:272-278)."""
    slope = (hist3[2] - hist3[0]) / 2.0
    mean = abs(hist3[0] + hist3[1] + hist3[2]) / 3.0
    return slope / max(mean, 1e-30) > -rel_tol


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
        if cycles > 3:
            ov2_slope = (ov2_hist[2] - ov2_hist[0]) / 2.0
            ov2_mean = abs(sum(ov2_hist)) / 3.0
            ov2_stopped = ov2_slope / max(ov2_mean, 1e-30) < tol
            if _stopped_improving(hist, tol) and ov2_stopped:
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
