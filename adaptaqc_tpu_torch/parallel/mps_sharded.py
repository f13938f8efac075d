"""The MPS engine over a chi-sharded state, written out.

What the JAX package's GSPMD program does with an MPS sharded on its
right-bond axis (parallel/mesh.py: b (n, 2, chi, chi) and lam (n+1, chi)
on their last axis over the tp ranks), here with explicit collectives. Rank
t holds columns [t c, (t+1) c) of every site's right bond, c = chi / T.

 - A one-qubit gate acts on a site's physical index: local.
 - A two-qubit apply on sites (k, k+1) gathers the two sites and the
   bond weights of bond k (the Gram of the bond is then replicated), runs
   backends/mps_core.py's apply on every rank, so that its truncated
   eigensolve launches K2-K4 on each rank's copy, and keeps the rank's
   columns of the result: the reference's Pallas eigh on replicated
   operands inside its sharded program.
 - The environment chains of the probe and of <a|b> keep the chi x chi
   environment on every rank and contract each site over the rank's
   columns: forward, E'[:, cols] = sum_p A_p^H (E B_p[:, cols]) with the
   bra's site gathered, then E' gathered over the columns; backward, the
   rank's share of F' = sum_p conj(A_p) F B_p^T over its rows of F, summed
   over tp. This is the counterpart of the XLA scan that the JAX package's
   sharded step runs in place of its Pallas env kernel: the env-chain
   kernel (K1) is a single-device program and does not run under a mesh.
 - The pair RDMs carry each left-anchored open-leg tensor with its first
   bond index split over the ranks (rows of the rank's columns), so no
   rank holds more than a site's worth of it beyond its shard.
 - The gradient heuristic's pair contraction (pair_op_overlaps) keeps only
   the rank's columns of the prefix and suffix environment stacks, and
   each pair's open-leg tensor W is contracted over the rank's columns and
   summed over tp once; it and the verifier's re-simulation (pad_chi,
   apply_tape_adjoint, mps_dot on the state at the verify chi) run under
   mesh.payload_cap of one site: no collective carries more than 2 chi^2
   elements, and no rank holds more than its shard and a few sites.
 - Every function takes one state or a batch of probe states (a leading
   batch dimension, as backends/mps_core.py does) where the full-cost
   sweep needs it: the gate applies, mps_dot, the observables and
   full_cost_terms.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..backends import mps_core, sv_core
from ..circuits import gates as G
from ..ops.env_kernel import backward_step, boundary_env, forward_step
from . import mesh as pm


class _Shards:
    """This rank's place on the tp axis for one state: the split T (1 where
    the state is replicated over tp), its index t and the columns c it
    holds."""

    def __init__(self, mesh, state):
        self.size = pm.split_of(state.b)
        self.t = mesh.get_local_rank(pm.TP) if self.size > 1 else 0
        self.group = mesh.get_group(pm.TP)
        self.cols = pm.local(state.b).shape[-1]

    def gather(self, x, dim=-1):
        return pm.gather_dim(x, dim, self.group, self.size, self.t)

    def sum(self, x):
        return pm.all_sum(x, self.group, self.size)

    def padded(self, x, dim=-1):
        """This rank's term of a gather by sum."""
        return pm.padded(x, dim, self.size, self.t)

    def sums(self, xs):
        """Several sums over tp in one all-reduce."""
        return pm.all_sum_many(xs, self.group, self.size)

    def mine(self, x):
        """This rank's columns of a full last axis."""
        return x[..., self.t * self.cols:(self.t + 1) * self.cols]


def _wrap(like, b, lam, trunc):
    """Local b, lam, trunc as an MPS laid out as `like` (a batch, or
    another chi, keeps its shape: mesh.wrap_as)."""
    return mps_core.MPS(*(pm.wrap_as(y, ref)
                          for y, ref in zip((b, lam, trunc), like)))


def _locals(state):
    return tuple(pm.local(t) for t in state)


def _site(b, i: int):
    """Site i of a local b (n, 2, chi, c), or of a batch of them."""
    return b[..., i, :, :, :]


def zero_mps(mesh, n: int, chi: int, dtype=None, device="cpu"):
    """mps_core.zero_mps chi-sharded as mesh.shard_mps lays it out, each
    rank making only its own columns (the whole state is never
    allocated)."""
    tp = pm.axis_size(mesh, pm.TP)
    if chi % tp:
        return pm.shard_mps(mesh, mps_core.zero_mps(n, chi, dtype, device))
    dtype = dtype or config.DEFAULT_DTYPE
    rdt = config.real_dtype(dtype)
    c = chi // tp
    b = torch.zeros((n, 2, chi, c), dtype=dtype, device=device)
    lam = torch.zeros((n + 1, c), dtype=rdt, device=device)
    if mesh.get_local_rank(pm.TP) == 0:  # column 0 is tp rank 0's
        b[:, 0, 0, 0] = 1.0
        lam[:, 0] = 1.0
    trunc = torch.zeros((), dtype=rdt, device=device)
    return mps_core.MPS(pm.place(b, mesh, True), pm.place(lam, mesh, True),
                        pm.place(trunc, mesh, False))


def pad_chi(mesh, state, new_chi: int):
    """mps_core.pad_chi of a sharded state, resharded at new_chi as
    mesh.shard_mps lays it out: each site gathered alone, the rank's
    columns of its zero-padded copy kept (no rank holds more than its
    shard and one site at the old chi), the bond weights gathered once."""
    chi, n = state.chi, state.n
    if new_chi < chi:
        raise ValueError("pad_chi cannot shrink the bond dimension")
    if new_chi == chi:
        return state
    sh = _Shards(mesh, state)
    b, lam, trunc = _locals(state)
    tp = pm.axis_size(mesh, pm.TP)
    split = new_chi % tp == 0
    c = new_chi // tp if split else new_chi
    lo = mesh.get_local_rank(pm.TP) * c if split else 0
    hi = max(lo, min(lo + c, chi))  # the old columns among this rank's new
    nb = torch.zeros((n, 2, new_chi, c), dtype=b.dtype, device=b.device)
    for i in range(n):
        site = sh.gather(b[i])
        nb[i, :, :chi, :hi - lo] = site[..., lo:hi]
    nl = torch.zeros((n + 1, c), dtype=lam.dtype, device=lam.device)
    nl[:, :hi - lo] = sh.gather(lam)[:, lo:hi]
    return mps_core.MPS(pm.place(nb, mesh, split), pm.place(nl, mesh, split),
                        pm.place(trunc.clone(), mesh, False))


# --------------------------------------------------------- gate application

def _apply_2q_adjacent(mesh, state, u4, k: int, threshold):
    """mps_core._apply_2q_adjacent on sites (k, k+1) of a sharded state (or
    of every state of a batch): the two sites and bonds k, k+1 gathered
    (one all-reduce; one a site under mesh.payload_cap), the replicated
    apply, the rank's columns kept."""
    sh = _Shards(mesh, state)
    b, lam, trunc = _locals(state)
    s0, s1, bonds = sh.sums([sh.padded(_site(b, k)),
                             sh.padded(_site(b, k + 1)),
                             sh.padded(lam[..., k:k + 2, :])])
    mini = mps_core.MPS(torch.stack([s0, s1], dim=-4),
                        torch.cat([bonds, bonds[..., -1:, :]], dim=-2), trunc)
    out = mps_core._apply_2q_adjacent(mini, u4, 0, threshold)
    b = b.clone()
    b[..., k:k + 2, :, :, :] = sh.mine(out.b)
    lam = lam.clone()
    lam[..., k + 1, :] = sh.mine(out.lam[..., 1, :])
    return _wrap(state, b, lam, out.trunc)


def apply_gate(mesh, state, kind: int, q0: int, q1: int, u4, threshold):
    """mps_core.apply_gate on a sharded state or batch of states (two-qubit
    gates routed with swaps to adjacency and back; a one-qubit entry also
    takes u4 (P, 4, 4), gate p on state p or on P copies of one state)."""
    if kind == G.NOP:
        return state
    if sv_core.is_two_qubit(kind):
        swap = sv_core.u4_table(state.dtype, pm.local(state.b).device)[G.SWAP]
        for k in range(q0, q1 - 1):
            state = _apply_2q_adjacent(mesh, state, swap, k, threshold)
        state = _apply_2q_adjacent(mesh, state, u4, q1 - 1, threshold)
        for k in range(q1 - 2, q0 - 1, -1):
            state = _apply_2q_adjacent(mesh, state, swap, k, threshold)
        return state
    # a one-qubit gate acts on the physical index alone: the local shards
    out = mps_core._apply_1q_at(mps_core.MPS(*_locals(state)),
                                u4[..., :2, :2], q0)
    return _wrap(state, *out)


def apply_tape(mesh, state, kinds, q0s, q1s, angles, threshold):
    u4s = sv_core.tape_u4(pm.local(state.b), kinds, angles)
    for i, (k, a, b) in enumerate(zip(np.asarray(kinds).tolist(),
                                      np.asarray(q0s).tolist(),
                                      np.asarray(q1s).tolist())):
        state = apply_gate(mesh, state, k, a, b, u4s[i], threshold)
    return state


def apply_tape_adjoint(mesh, state, kinds, q0s, q1s, angles, threshold):
    u4s = sv_core.tape_u4(pm.local(state.b), kinds, angles).mH
    entries = list(zip(np.asarray(kinds).tolist(), np.asarray(q0s).tolist(),
                       np.asarray(q1s).tolist()))
    for i in range(len(entries) - 1, -1, -1):
        k, a, b = entries[i]
        state = apply_gate(mesh, state, k, a, b, u4s[i], threshold)
    return state


# ------------------------------------------------------ environment chains

def _chains(sh, br, bl, e0, fwd, bwd, extra=(), stacks=None):
    """The forward chain over sites `fwd` and the backward chain over sites
    `bwd` from e0, in lockstep, one all-reduce a step for both: forward,
    E' = sum_p A_p^H E B_p on this rank's columns of B with A gathered,
    then E' gathered over the columns; backward, this rank's share of F' =
    sum_p conj(A_p) F B_p^T (its rows of F against its columns of A, B
    gathered), summed over tp. Each step's all-reduce also gathers the
    next step's site, the first also the sites of `extra` ((tensor, dim)
    pairs, returned gathered). The forward chain takes a batch of states
    (br or bl with a leading batch dimension). `stacks`: lists ("e", "f")
    that collect this rank's columns of every E' and F' in step order.
    Returns (E, F, gathered extras)."""
    e = f = e0
    terms = [sh.padded(_site(br, fwd[0]))] if fwd else []
    terms += [sh.padded(bl[bwd[0]])] if bwd else []
    terms += [sh.padded(x, d) for x, d in extra]
    got = sh.sums(terms)
    a = got.pop(0) if fwd else None
    b = got.pop(0) if bwd else None
    extras = got
    for s in range(max(len(fwd), len(bwd))):
        terms, tags = [], []
        if s < len(fwd):
            share = forward_step(e, a, _site(bl, fwd[s]))
            if stacks is not None:
                stacks["e"].append(share)
            terms.append(sh.padded(share))
            tags.append("e")
            if s + 1 < len(fwd):
                terms.append(sh.padded(_site(br, fwd[s + 1])))
                tags.append("a")
        if s < len(bwd):
            rows = sh.mine(f.transpose(-1, -2)).transpose(-1, -2)
            terms.append(backward_step(rows, br[bwd[s]], b))
            tags.append("f")
            if s + 1 < len(bwd):
                terms.append(sh.padded(bl[bwd[s + 1]]))
                tags.append("b")
        got = dict(zip(tags, sh.sums(terms)))
        e, f = got.get("e", e), got.get("f", f)
        a, b = got.get("a", a), got.get("b", b)
        if stacks is not None and "f" in got:
            stacks["f"].append(sh.mine(f))
    return e, f, extras


def mps_dot(mesh, a, b):
    """<a|b> by the sharded forward chain (0-dim complex on every rank, or
    (P,) where either state is a batch)."""
    sh = _Shards(mesh, b)
    ab, bb = pm.local(a.b), pm.local(b.b)
    e0 = boundary_env(b.chi, b.dtype, bb.device)
    e, _, _ = _chains(sh, ab, bb, e0, list(range(b.n)), [])
    return e[..., 0, 0]


def local_overlap_matrix(mesh, r_state, l_state, q: int):
    """C[i, j] = <R| |i><j|_q |L> (2 x 2, on every rank) from the two
    sharded environment chains, combined at q over this rank's columns of
    R and its rows of F, summed over tp."""
    sh = _Shards(mesh, l_state)
    br, bl = pm.local(r_state.b), pm.local(l_state.b)
    n = l_state.n
    e0 = boundary_env(l_state.chi, l_state.dtype, bl.device)
    e, f, (bq,) = _chains(sh, br, bl, e0, list(range(q)),
                          list(range(n - 1, q, -1)), extra=((bl[q], -1),))
    # H_j[a, x] = (e B_j f^T)[a, x] on this rank's x (its rows of f)
    h = (e @ bq) @ sh.mine(f.transpose(-1, -2))
    return sh.sum(torch.einsum("iax,jax->ij", br[q].conj(), h))


def overlap_with_zero(mesh, state):
    """<0...0|state>: the chain of the B_i[0] rows, gathered a site at a
    time."""
    sh = _Shards(mesh, state)
    b = pm.local(state.b)
    v = boundary_env(state.chi, state.dtype, b.device)[0]
    for i in range(state.n):
        v = sh.gather(v @ b[i, 0])
    return v[0]


def _abs2(z):
    return z.real * z.real + z.imag * z.imag


def global_cost_normalized(mesh, state):
    nrm2 = torch.clamp(mps_dot(mesh, state, state).real, min=1e-30)
    return 1.0 - _abs2(overlap_with_zero(mesh, state)) / nrm2


def z_expectations(mesh, state):
    """<Z_i> per site, self-normalised (n,), or (P, n) for a batch: the
    bond weights gathered once, each rank's columns' weights summed over
    tp."""
    sh = _Shards(mesh, state)
    b, lam, _ = _locals(state)
    lam2 = sh.gather(lam[..., :-1, :]) ** 2
    w = sh.sum(torch.einsum("...ia,...ipab->...ip", lam2, _abs2(b)))
    return ((w[..., 0] - w[..., 1])
            / torch.clamp(w[..., 0] + w[..., 1], min=1e-30))


def hamming1_overlaps(mesh, state):
    """|<e_i|state>|^2 for the n states of Hamming weight 1 (as
    mps_core.hamming1_overlaps), (n,) or (P, n) for a batch: prefix rows
    gathered a site at a time, suffix columns summed over tp, each
    amplitude summed over tp."""
    sh = _Shards(mesh, state)
    b = pm.local(state.b)
    n = state.n
    b0, b1 = b[..., 0, :, :], b[..., 1, :, :]  # (..., n, chi, c)

    def vm(v, m):  # a row vector (or a batch of them) times a matrix
        return (v.unsqueeze(-2) @ m).squeeze(-2)

    v0 = boundary_env(state.chi, state.dtype, b.device)[0]
    pre = [v0.expand(state.batch + v0.shape)]
    for i in range(n - 1):
        pre.append(sh.gather(vm(pre[-1], b0[..., i, :, :])))
    suf = [pre[0]]
    for i in range(n - 1, 0, -1):
        suf.append(sh.sum((b0[..., i, :, :]
                           @ sh.mine(suf[-1]).unsqueeze(-1)).squeeze(-1)))
    suf = suf[::-1]
    amps = torch.stack([(vm(pre[i], b1[..., i, :, :]) * sh.mine(suf[i])
                         ).sum(-1) for i in range(n)], dim=-1)
    return _abs2(sh.sum(amps))


def softened_cost_terms(mesh, state):
    nrm2 = torch.clamp(mps_dot(mesh, state, state).real, min=1e-30)
    cost = 1.0 - _abs2(overlap_with_zero(mesh, state)) / nrm2
    return cost, hamming1_overlaps(mesh, state).sum() / nrm2


def full_cost_terms(mesh, state, ref):
    """mps_core.full_cost_terms of a sharded state or batch of states:
    (global cost against ref, local cost 0.5 (1 - mean <Z_q>), Hamming-1
    sum), each normalised by <psi|psi>; real 0-dim, or (P,) each."""
    nrm2 = torch.clamp(mps_dot(mesh, state, state).real, min=1e-30)
    g = 1.0 - _abs2(mps_dot(mesh, ref, state)) / nrm2
    loc = 0.5 * (1.0 - z_expectations(mesh, state).mean(-1))
    return g, loc, hamming1_overlaps(mesh, state).sum(-1) / nrm2


def all_pair_rdms(mesh, state):
    """rho(i, j) of every site pair (n, n, 4, 4), as mps_core.all_pair_rdms
    (valid for j > i, qubit i the low bit). Each open-leg tensor T_i
    [p, p', a, b] keeps the rank's rows a (its columns of site i); at each
    site j, gathered once, every T_i gives its share of rho(i, j) and of
    its next T, whose rows the rank keeps after the sum over tp; the RDMs
    are summed over tp once at the end."""
    sh = _Shards(mesh, state)
    b, lam, _ = _locals(state)
    n = state.n
    lam2 = sh.gather(lam[:-1]) ** 2
    rhos = torch.zeros((n, n, 4, 4), dtype=b.dtype, device=b.device)
    ts = [None] * n
    for j in range(n):
        bj = sh.gather(b[j])          # (2, chi, chi)
        rows = sh.mine(bj.transpose(-1, -2)).transpose(-1, -2)  # my a
        for i in range(j):
            t = ts[i]
            rho = torch.einsum("pqab,rac,sbc->rpsq", t, rows, bj.conj())
            rhos[i, j] = rho.reshape(4, 4)
            nxt = torch.einsum("pqab,rax,rby->pqxy", t, rows, bj.conj())
            ts[i] = sh.mine(sh.sum(nxt).transpose(-1, -2)).transpose(-1, -2)
        # T_j[p, p', a, b] = sum_c lam2[j][c] B_j[p][c, a] conj(B_j[p'][c, b])
        ts[j] = torch.einsum("c,pca,qcb->pqab", lam2[j].to(b.dtype), b[j],
                             bj.conj())
    return sh.sum(rhos)


def pair_op_overlaps(mesh, bra, ket, ops_a, ops_b, pairs, max_dist: int):
    """mps_core.pair_op_overlaps on chi-sharded states: <bra| A^(k,m)
    B^(k,m) |ket> for every operator k and pair p, summed over the Schmidt
    terms m (A on site pairs[p, 1], B on pairs[p, 0]); ops_a, ops_b complex
    (K, M, 2, 2); returns (K, P) complex on every rank. `max_dist` is the
    contract's (every pair's span is walked here).

    The prefix and suffix environments come from _chains (one collective
    a step for both), and the rank keeps only its columns of each, 2 n chi
    chi / T in all. Then for each left site lo of the pairs: its prefix
    and the bra's site gathered, the open-leg tensor X[u, v, x, y] =
    sum conj(A_lo[u][a, x]) pre[a, b] B_lo[v][b, y] on the rank's columns
    y, gathered, carried site by site (a forward step for each (u, v)) to
    every right site hi of a pair, where the rank contracts W[u, v, w, z] =
    sum conj(A_hi[w][x, a]) X[u, v, x, y] B_hi[z][y, b] suf[a, b] over its
    columns b. The W of every pair are summed over tp once. Everything
    runs under mesh.payload_cap of one site (2 chi^2 elements)."""
    sh = _Shards(mesh, ket)
    ab, kb = pm.local(bra.b), pm.local(ket.b)
    n, chi = ket.n, ket.chi
    pairs = np.asarray(pairs)
    lo_np = np.minimum(pairs[:, 0], pairs[:, 1])
    hi_np = np.maximum(pairs[:, 0], pairs[:, 1])
    e0 = boundary_env(chi, ket.dtype, kb.device)
    w = torch.zeros((len(pairs), 2, 2, 2, 2), dtype=ket.dtype,
                    device=kb.device)
    with pm.payload_cap(2 * chi * chi):
        stacks = {"e": [], "f": []}
        _chains(sh, ab, kb, e0, list(range(n - 1)),
                list(range(n - 1, 0, -1)), stacks=stacks)
        pre = [sh.mine(e0)] + stacks["e"]        # pre[i]: sites < i
        suf = stacks["f"][::-1] + [sh.mine(e0)]  # suf[i]: sites > i
        for lo in sorted(set(lo_np.tolist())):
            his = sorted(set(hi_np[lo_np == lo].tolist()))
            e, a = sh.sums([sh.padded(pre[lo]), sh.padded(ab[lo])])
            x = torch.einsum("uax,ab,vby->uvxy", a.conj(), e, kb[lo])
            for site in range(lo + 1, his[-1] + 1):
                x0, x1, a = sh.sums([sh.padded(x[0]), sh.padded(x[1]),
                                     sh.padded(ab[site])])
                x = torch.stack([x0, x1])
                if site in his:
                    g = torch.einsum("zyb,ab->zya", kb[site], suf[site])
                    part = torch.einsum("wxa,uvxy,zya->uvwz", a.conj(), x, g)
                    for p in np.flatnonzero((lo_np == lo) & (hi_np == site)):
                        w[int(p)] = part
                if site < his[-1]:
                    x = forward_step(x, a, kb[site])
        w = sh.sum(w)
    # B acts on pairs[p, 0]: where a pair arrives descending, swap the groups
    desc = torch.as_tensor(pairs[:, 0] > pairs[:, 1], device=w.device)
    w = torch.where(desc[:, None, None, None, None], w.permute(0, 3, 4, 1, 2),
                    w)
    return torch.einsum("kmuv,kmwz,puvwz->kp", ops_b, ops_a, w)


def sweep_engine(mesh, threshold: float):
    """The SweepEngine (optim/sweeps.py) of the sharded MPS: gate applier
    (also on a batch of probe states), probe matrix, <a|b> and the
    full-cost sweep's probe costs over the mesh, so the local and softened
    costs run the device sweep as on one card. No env-chain kernel and no
    incremental environments under a mesh, as in the JAX package."""
    from ..optim.sweeps import SweepEngine
    return SweepEngine(
        f"mps[{threshold},mesh]",
        lambda s, kind, q0, q1, u4: apply_gate(mesh, s, kind, q0, q1, u4,
                                               threshold),
        lambda r, l, q: local_overlap_matrix(mesh, r, l, q),
        lambda a, c: mps_dot(mesh, a, c),
        lambda s, ref: full_cost_terms(mesh, s, ref))
