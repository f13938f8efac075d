"""The statevector engine over a tp-sharded state, written out.

What the JAX package's GSPMD program does with a statevector sharded on its
amplitude axis (parallel/mesh.py), here with explicit collectives. With T
= 2^k tp ranks, rank t holds the amplitudes whose top k index bits are t:
qubits n-k .. n-1 are global (qubit n-k+j is bit j of t), the others local,
and the local shard is itself an (n-k)-qubit state that backends/sv_core.py
acts on unchanged.

 - A gate on local qubits runs on the local shard alone.
 - A gate that touches a global qubit mixes the shards of the ranks that
   differ in those bits (2 or 4 of them): a pair trades its two shards
   through one all-reduce, a group of four broadcasts each shard in turn,
   and each rank sums what the gate sends to its own block, block by
   block in the group's order. A rank holds at most two shards beside its
   sum: never the whole state.
 - Overlaps, the probe's 2 x 2 matrix, <Z> and the 2-site RDMs are partial
   sums over the local shard (cross terms of a global qubit through the
   same exchange) reduced over the tp ranks.
 - The gate applies, overlaps, <Z> and full_cost_terms also take a batch
   of states (P, 2^n), sharded on their last axis, and a one-qubit entry a
   batch of gates (P, 4, 4): the full-cost sweep's probe states.

A state replicated over tp (2^n not divisible by T) runs sv_core as it is.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import config
from ..backends import sv_core
from ..circuits import gates as G
from . import mesh as pm


class _Layout(NamedTuple):
    n: int      # qubits of the whole state
    k: int      # global qubits (0: the state is replicated over tp)
    t: int      # this rank's tp index
    group: object
    size: int
    bits: dict  # make_mesh's exchange groups

    @property
    def nloc(self):
        return self.n - self.k


def _layout(mesh, state) -> _Layout:
    split = pm.split_of(state)
    k = split.bit_length() - 1
    n = (pm.local(state).shape[-1] * split).bit_length() - 1
    return _Layout(n, k, mesh.get_local_rank(pm.TP), mesh.get_group(pm.TP),
                   split, mesh.adaptaqc_bit_groups)


def _wrap(y, like):
    """The local y laid out as `like` (a batch keeps its shape)."""
    return pm.wrap_as(y, like)


def _exchange(x, lay: _Layout, bits):
    """Each member's shard, in the order of its tp index, with that index:
    (tp index, shard) pairs, this rank's own shard among them, from the
    group of the ranks that differ from this one in `bits` alone. A pair
    (one bit) trades through one all-reduce of the two shards side by
    side; a group of four, one broadcast a member, so that no rank holds
    more than two shards at once (four are the whole state at tp = 4)."""
    group, members = lay.bits[tuple(sorted(bits))]
    me = torch.distributed.get_rank()
    tp = lay.size
    if len(members) == 2:
        both = pm.all_sum(pm.padded(x[None], 0, 2, members.index(me)),
                          group, 2)
        for i, r in enumerate(members):
            yield r % tp, both[i]
        return
    for r in members:
        buf = x if r == me else torch.empty_like(x)
        pm.broadcast(buf, r, group)
        yield r % tp, buf


def _bit(t, j):
    return (t >> j) & 1


def zero_state(mesh, n: int, dtype=None, device="cpu"):
    """|0...0> tp-sharded, each rank making only its own shard (the whole
    state is never allocated): mesh.shard_state of sv_core.zero_state."""
    from torch.distributed.tensor import DTensor
    tp = pm.axis_size(mesh, pm.TP)
    if (1 << n) % tp:
        return pm.shard_state(mesh, sv_core.zero_state(n, dtype, device))
    x = torch.zeros((1 << n) // tp, dtype=dtype or config.DEFAULT_DTYPE,
                    device=device)
    if mesh.get_local_rank(pm.TP) == 0:
        x[0] = 1.0
    return DTensor.from_local(x, mesh, pm._placements(mesh, pm.TP, 0),
                              run_check=False, shape=(1 << n,),
                              stride=(1,))


def apply_gate(mesh, state, kind: int, q0: int, q1: int, u4):
    """sv_core.apply_gate on a sharded state or batch of states (a
    one-qubit entry also takes u4 (P, 4, 4), gate p on state p or on P
    copies of one state)."""
    if kind == G.NOP:
        return state
    lay = _layout(mesh, state)
    x = pm.local(state)
    two = sv_core.is_two_qubit(kind)
    qs = (q0, q1) if two else (q0,)
    if all(q < lay.nloc for q in qs):
        return _wrap(sv_core.apply_gate(x, kind, q0, q1, u4), state)
    nl = lay.nloc
    y = torch.zeros_like(x)
    if not two:  # a 2x2 gate on a global qubit: u[mine, theirs] a block
        j = q0 - nl
        mine = _bit(lay.t, j)
        for tm, buf in _exchange(x, lay, (j,)):
            y = y + u4[..., mine, _bit(tm, j), None] * buf
        return _wrap(y, state)
    u = u4.reshape(2, 2, 2, 2)  # [b(q1)', b(q0)', b(q1), b(q0)]
    if q0 >= nl and q1 >= nl:  # both global: one amplitude factor a pair
        j0, j1 = q0 - nl, q1 - nl
        m0, m1 = _bit(lay.t, j0), _bit(lay.t, j1)
        for tm, buf in _exchange(x, lay, (j0, j1)):
            y = y + u[m1, m0, _bit(tm, j1), _bit(tm, j0)] * buf
        return _wrap(y, state)
    if q0 >= nl:  # q0 global, q1 local: a 2x2 block on q1
        j = q0 - nl
        mine = _bit(lay.t, j)
        for tm, buf in _exchange(x, lay, (j,)):
            y = y + sv_core.apply_u2(buf, u[:, mine, :, _bit(tm, j)], q1)
        return _wrap(y, state)
    j = q1 - nl  # q1 global, q0 local: a 2x2 block on q0
    mine = _bit(lay.t, j)
    for tm, buf in _exchange(x, lay, (j,)):
        y = y + sv_core.apply_u2(buf, u[mine, :, _bit(tm, j), :], q0)
    return _wrap(y, state)


def apply_tape(mesh, state, kinds, q0s, q1s, angles):
    u4s = sv_core.tape_u4(pm.local(state), kinds, angles)
    for i, (k, a, b) in enumerate(zip(np.asarray(kinds).tolist(),
                                      np.asarray(q0s).tolist(),
                                      np.asarray(q1s).tolist())):
        state = apply_gate(mesh, state, k, a, b, u4s[i])
    return state


def apply_tape_adjoint(mesh, state, kinds, q0s, q1s, angles):
    u4s = sv_core.tape_u4(pm.local(state), kinds, angles).mH
    entries = list(zip(np.asarray(kinds).tolist(), np.asarray(q0s).tolist(),
                       np.asarray(q1s).tolist()))
    for i in range(len(entries) - 1, -1, -1):
        k, a, b = entries[i]
        state = apply_gate(mesh, state, k, a, b, u4s[i])
    return state


def overlap(mesh, a, b):
    """<a|b>: the local shards' products summed over tp (0-dim, or (P,)
    where either is a batch)."""
    lay = _layout(mesh, b)
    return pm.all_sum(sv_core.overlap(pm.local(a), pm.local(b)), lay.group,
                      lay.size)


def local_overlap_matrix(mesh, r_state, l_state, q: int):
    """C[i, j] = <R| (|i><j| on qubit q) |L>, replicated on every rank: on
    a local qubit sv_core's matrix of the shards, on a global one this
    rank's row (its R against each member's L) through the exchange;
    summed over tp."""
    lay = _layout(mesh, l_state)
    r, l = pm.local(r_state), pm.local(l_state)
    if q < lay.nloc:
        return pm.all_sum(sv_core.local_overlap_matrix(r, l, q), lay.group,
                          lay.size)
    j = q - lay.nloc
    c = torch.zeros((2, 2), dtype=l.dtype, device=l.device)
    mine = _bit(lay.t, j)
    for tm, buf in _exchange(l, lay, (j,)):
        c[mine, _bit(tm, j)] = torch.vdot(r, buf)
    return pm.all_sum(c, lay.group, lay.size)


def global_cost(mesh, state):
    """1 - |<0...0|state>|^2: the amplitude lives on tp rank 0."""
    lay = _layout(mesh, state)
    x = pm.local(state)
    amp = x[0] if lay.t == 0 else torch.zeros((), dtype=x.dtype,
                                              device=x.device)
    amp = pm.all_sum(amp, lay.group, lay.size)
    return 1.0 - (amp.real * amp.real + amp.imag * amp.imag)


def z_expectations(mesh, state, n: int = None):
    """<Z_q> of every qubit: sv_core's marginals of the local shard for
    the local qubits, the shard's weight with the sign of this rank's bit
    for the global ones, summed over tp."""
    lay = _layout(mesh, state)
    x = pm.local(state)
    zl = sv_core.z_expectations(x, lay.nloc)
    tot = (x.real * x.real + x.imag * x.imag).sum(-1)
    zg = [tot * (1 - 2 * _bit(lay.t, j)) for j in range(lay.k)]
    z = torch.cat([zl, torch.stack(zg, dim=-1)], dim=-1) if zg else zl
    return pm.all_sum(z, lay.group, lay.size)


def full_cost_terms(mesh, state, ref):
    """(global cost against ref, local cost, Hamming-1 overlap sum) of one
    sharded state or of every state of a batch, as sv_core.full_cost_terms:
    |e_i> for a local qubit i is amplitude 2^i of tp rank 0, for global
    qubit j amplitude 0 of tp rank 2^j."""
    lay = _layout(mesh, state)
    ov = overlap(mesh, ref, state)
    g = 1.0 - (ov.real * ov.real + ov.imag * ov.imag)
    loc = 0.5 * (1.0 - z_expectations(mesh, state).mean(-1))
    x = pm.local(state)
    p = x.real * x.real + x.imag * x.imag
    if lay.t == 0:
        ones = torch.as_tensor(2 ** np.arange(lay.nloc), device=x.device)
        h = p[..., ones].sum(-1)
    else:
        h = (p[..., 0] if lay.t & (lay.t - 1) == 0
             else torch.zeros_like(p[..., 0]))
    return g, loc, pm.all_sum(h, lay.group, lay.size)


def rdm2(mesh, state, qa: int, qb: int):
    """sv_core.rdm2 of a sharded state (basis index 2 b(qb) + b(qa)): on
    local qubits sv_core's RDM of the shard; where a qubit is global, this
    rank's rows of the RDM (its global values) against each member's
    shard through the exchange; summed over tp."""
    lay = _layout(mesh, state)
    x = pm.local(state)
    nl = lay.nloc
    if qa < nl and qb < nl:
        return pm.all_sum(sv_core.rdm2(x, qa, qb), lay.group, lay.size)
    rho = torch.zeros((4, 4), dtype=x.dtype, device=x.device)
    ga, gb = qa >= nl, qb >= nl
    bits = tuple(q - nl for q, g in ((qa, ga), (qb, gb)) if g)
    if ga and gb:
        ja, jb = qa - nl, qb - nl
        r = 2 * _bit(lay.t, jb) + _bit(lay.t, ja)
        for tm, buf in _exchange(x, lay, bits):
            rho[r, 2 * _bit(tm, jb) + _bit(tm, ja)] = torch.vdot(buf, x)
        return pm.all_sum(rho, lay.group, lay.size)
    ql, j = (qb, qa - nl) if ga else (qa, qb - nl)
    mine = _bit(lay.t, j)

    def rows(v):  # (2, rest): the amplitudes by the local qubit's value
        return v.view(-1, 2, 1 << ql).transpose(0, 1).reshape(2, -1)

    pme = rows(x)
    for tm, buf in _exchange(x, lay, bits):
        blk = pme @ rows(buf).mH  # [b(ql) mine, b(ql) theirs]
        theirs = _bit(tm, j)
        for a in range(2):
            for b in range(2):
                r, c = ((2 * a + mine, 2 * b + theirs) if ga
                        else (2 * mine + a, 2 * theirs + b))
                rho[r, c] = blk[a, b]
    return pm.all_sum(rho, lay.group, lay.size)


def all_pair_rdms(mesh, state, pairs):
    """(P, 4, 4) RDMs of the pairs, as sv_core.all_pair_rdms, with the
    pairs dp-sharded (mesh.shard_pairs): each dp rank computes its share
    over the tp shards, and the shares are gathered over dp. Returns a
    tensor on this rank's device (the same on every rank)."""
    sharded, n_pairs = pm.shard_pairs(mesh, pairs)
    mine = pm.local(sharded).cpu().numpy().tolist()
    rhos = torch.stack([rdm2(mesh, state, a, b) for a, b in mine])
    full = pm.gather_dim(rhos, 0, mesh.get_group(pm.DP),
                         pm.axis_size(mesh, pm.DP), mesh.get_local_rank(pm.DP))
    return full[:n_pairs]


def sweep_engine(mesh):
    """The SweepEngine (optim/sweeps.py) of the sharded statevector: gate
    applier (also on a batch of probe states), probe matrix, <a|b> and the
    full-cost sweep's probe costs over the mesh, so the local and softened
    costs run the device sweep as on one device."""
    from ..optim.sweeps import SweepEngine
    return SweepEngine(
        "sv[mesh]",
        lambda s, kind, q0, q1, u4: apply_gate(mesh, s, kind, q0, q1, u4),
        lambda r, l, q: local_overlap_matrix(mesh, r, l, q),
        lambda a, b: overlap(mesh, a, b),
        lambda s, ref: full_cost_terms(mesh, s, ref))
