"""Center-gauge (mixed-canonical) MPS engine: the independent second engine.

Counterpart of the JAX package's `backends/center_mps.py`. The reference
ships an alternative MPS backend over ITensorNetworks.jl
(adaptaqc/backends/itensor_backend.py:17-62) whose value is an independent
tensor-network engine to cross-check the primary simulator. This is that
engine: mixed-canonical site tensors with an explicit orthogonality center,
gates applied by moving the center into the bond and truncating with a
`cutoff`. It shares no state layout, gauge convention or update algebra with
the primary Hastings B-form engine (`mps_core.py`):

  - mps_core: Vidal/Hastings gauge (B tensors and bond weight vectors), all
    bonds canonical at once, spectra renormalised at every apply;
  - here: plain site tensors and one orthogonality center that holds the
    weights; no renormalisation (the norm decays by exactly the truncated
    weight, as ITensor's `apply` has it).

State: `CMPS` with t (n, 2, chi, chi) complex site tensors [p, left, right]
on one device, chi-padded; sites left of `center` are left-canonical
isometries, sites right of it right-canonical. `center` is a Python int (the
JAX engine threaded a traced index through `lax.while_loop` center moves;
here they are plain loops). As in mps_core, a state may carry one leading
batch dimension on t and trunc (the probe states of one gate of the
full-cost sweep): they share one center, since they differ by a one-qubit
gate, which moves no center.

Both center moves decompose a (2 chi, chi) matrix, so their Gram matrices
are chi x chi: the eigensolver kernels see m = chi here, and m = 2 chi from
the two-qubit applies.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import config
from ..circuits import gates as G
from ..ops import cplx
from ..ops.env_kernel import boundary_env, env_chain, forward_step
from . import sv_core

__all__ = [
    "CMPS", "zero_cmps", "from_bform", "apply_tape", "apply_tape_adjoint",
    "move_center_to", "overlap_with_zero", "cmps_dot", "norm_sq",
    "global_cost_normalized", "z_expectations", "all_pair_rdms", "to_dense",
    "cmps_from_numpy", "cmps_to_numpy",
]


class CMPS(NamedTuple):
    t: torch.Tensor      # (n, 2, chi, chi) complex site tensors
    center: int          # the orthogonality-center site
    trunc: torch.Tensor  # () real: accumulated relative discarded weight

    @property
    def n(self) -> int:
        return self.t.shape[-4]

    @property
    def chi(self) -> int:
        return self.t.shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.t.dtype

    @property
    def device(self):
        return self.t.device

    @property
    def batch(self) -> tuple:
        return tuple(self.t.shape[:-4])


def zero_cmps(n: int, chi: int, dtype=None, device="cuda") -> CMPS:
    dtype = dtype or config.DEFAULT_DTYPE
    t = torch.zeros((n, 2, chi, chi), dtype=dtype, device=device)
    t[:, 0, 0, 0] = 1.0
    return CMPS(t, 0, torch.zeros((), dtype=config.real_dtype(dtype),
                                  device=device))


def from_bform(state) -> CMPS:
    """Exact gauge conversion from the primary engine's B-form. A B-form
    state is diag(lam_0) B_0 B_1 ... B_{n-1} with every B_i right-canonical,
    so absorbing the (trivial) left boundary weight into site 0 gives a
    center-gauge state with its center at site 0."""
    t = state.b.clone()
    t[0] = state.b[0] * state.lam[0][None, :, None]
    return CMPS(t, 0, state.trunc.clone())


def cmps_from_numpy(t_re, t_im, center, trunc=0.0, dtype=None,
                    device="cpu") -> CMPS:
    """A CMPS from host arrays (the JAX engine's t.re, t.im, center,
    trunc)."""
    dtype = dtype or config.DEFAULT_DTYPE
    t = torch.as_tensor(np.asarray(t_re) + 1j * np.asarray(t_im),
                        dtype=dtype, device=device)
    return CMPS(t, int(center),
                torch.as_tensor(float(np.asarray(trunc)),
                                dtype=config.real_dtype(dtype),
                                device=device))


def cmps_to_numpy(state: CMPS):
    """(t_re, t_im, center, trunc) as host values."""
    t = state.t.detach().cpu().numpy()
    return t.real.copy(), t.imag.copy(), int(state.center), float(state.trunc)


# ------------------------------------------------------------- center moves

def _site(state: CMPS, k: int) -> torch.Tensor:
    return state.t[..., k, :, :, :]


def _put_sites(state: CMPS, center: int, trunc, sites: dict) -> CMPS:
    """A new state with the sites {index: tensor} replaced."""
    t = state.t.clone()
    for k, tk in sites.items():
        t[..., k, :, :, :] = tk
    return CMPS(t, center, trunc)


def _shift_right(state: CMPS, eigh: str = None) -> CMPS:
    """Move the center one site right: T_c splits into a left-canonical
    isometry (kept at c) and a weight carry multiplied into T_{c+1}."""
    c, chi, lead = state.center, state.chi, state.batch
    m = _site(state, c).reshape(lead + (2 * chi, chi))  # rows (p, a)
    u, s, vh = cplx.svd_trunc(m, chi, 0.0, eigh)  # a gauge move: no cutoff
    carry = s[..., :, None] * vh  # (chi, chi)
    new_tn = torch.einsum("...ac,...pcb->...pab", carry, _site(state, c + 1))
    return _put_sites(state, c + 1, state.trunc, {
        c: u.reshape(lead + (2, chi, chi)), c + 1: new_tn})


def _shift_left(state: CMPS, eigh: str = None) -> CMPS:
    """Move the center one site left: T_c = carry . (right-canonical part),
    from the SVD of M^H so that the decomposed matrix is again (2 chi,
    chi): M = Vh^H S U^H with U^H a row isometry."""
    c, chi, lead = state.center, state.chi, state.batch
    m = _site(state, c).transpose(-3, -2).reshape(lead + (chi, 2 * chi))
    u, s, vh = cplx.svd_trunc(m.mH, chi, 0.0, eigh)  # rows a, cols (p, b)
    new_tc = u.mH.reshape(lead + (chi, 2, chi)).transpose(-3, -2)
    carry = vh.mH * s[..., None, :]
    new_tp = torch.einsum("...pab,...bc->...pac", _site(state, c - 1), carry)
    return _put_sites(state, c - 1, state.trunc, {
        c: new_tc, c - 1: new_tp})


def move_center_to(state: CMPS, k: int, eigh: str = None) -> CMPS:
    k = int(k)
    while state.center < k:
        state = _shift_right(state, eigh)
    while state.center > k:
        state = _shift_left(state, eigh)
    return state


# ---------------------------------------------------------- gate application

def _expand(state: CMPS, lead) -> CMPS:
    return CMPS(state.t.expand(*lead, *state.t.shape), state.center,
                state.trunc.expand(*lead))


def _apply_1q_at(state: CMPS, u2: torch.Tensor, q: int) -> CMPS:
    """A one-qubit unitary keeps both canonical conditions, so it applies at
    any site without moving the center. u2 (P, 2, 2): gate p on state p, or
    on P copies of one state."""
    new = torch.einsum("...pq,...qab->...pab", u2, _site(state, q))
    lead = tuple(new.shape[:-3])
    if lead != state.batch:
        state = _expand(state, lead)
    return _put_sites(state, state.center, state.trunc, {q: new})


def apply_1q_layer(state: CMPS, u2s: torch.Tensor) -> CMPS:
    """u2s[i] (n, 2, 2) applied at site i, every site in one einsum (a
    one-qubit unitary moves no center)."""
    return CMPS(torch.einsum("ipq,...iqab->...ipab", u2s, state.t),
                state.center, state.trunc)


def _apply_2q_adjacent(state: CMPS, u4: torch.Tensor, k: int, cutoff,
                       eigh: str = None) -> CMPS:
    """Gate on adjacent sites (k, k+1): move the center into the bond,
    contract the two-site tensor, apply, SVD with `cutoff`, keep the left
    factor canonical; the center lands on k+1. The kept spectrum is not
    renormalised: the norm decays by exactly the discarded weight, which
    `trunc` accumulates."""
    state = move_center_to(state, min(max(state.center, k), k + 1), eigh)
    chi, lead = state.chi, state.batch
    theta = torch.einsum("...pac,...qcb->...apqb", _site(state, k),
                         _site(state, k + 1))
    theta = torch.einsum("qpsr,...arsb->...apqb", u4.reshape(2, 2, 2, 2),
                         theta)
    m = theta.reshape(lead + (chi * 2, 2 * chi))  # rows (a, pl), cols (pr, b)
    eff_cutoff = max(float(cutoff), 0.1 * config.lambda_eps(state.dtype))
    u, s, vh = cplx.svd_trunc(m, chi, eff_cutoff, eigh)
    kept = (s * s).sum(-1)
    total = (m.real * m.real + m.imag * m.imag).sum((-2, -1))
    discarded = (torch.clamp(total - kept, min=0.0)
                 / torch.clamp(total, min=1e-30))
    new_tl = u.reshape(lead + (chi, 2, chi)).transpose(-3, -2)
    new_tr = (s[..., :, None] * vh).reshape(
        lead + (chi, 2, chi)).transpose(-3, -2)  # carries the weights
    return _put_sites(state, k + 1, state.trunc + discarded,
                      {k: new_tl, k + 1: new_tr})


def _apply_2q_routed(state: CMPS, u4, q0: int, q1: int, cutoff,
                     eigh: str = None) -> CMPS:
    """Two-qubit gate on (q0 < q1), routed with swaps to adjacency and
    back, as the primary engine does."""
    swap = sv_core.u4_table(state.dtype, state.device)[G.SWAP]
    for k in range(q0, q1 - 1):
        state = _apply_2q_adjacent(state, swap, k, cutoff, eigh)
    state = _apply_2q_adjacent(state, u4, q1 - 1, cutoff, eigh)
    for k in range(q1 - 2, q0 - 1, -1):
        state = _apply_2q_adjacent(state, swap, k, cutoff, eigh)
    return state


def apply_gate(state: CMPS, kind: int, q0: int, q1: int, u4: torch.Tensor,
               cutoff, eigh: str = None) -> CMPS:
    """Apply one tape entry whose 4x4 matrix is u4 (kind only steers)."""
    if kind == G.NOP:
        return state
    if sv_core.is_two_qubit(kind):
        return _apply_2q_routed(state, u4, q0, q1, cutoff, eigh)
    return _apply_1q_at(state, u4[..., :2, :2], q0)


def _entries(kinds, q0s, q1s):
    return list(zip(np.asarray(kinds).tolist(), np.asarray(q0s).tolist(),
                    np.asarray(q1s).tolist()))


def apply_tape(state: CMPS, kinds, q0s, q1s, angles, cutoff,
               eigh: str = None) -> CMPS:
    u4s = sv_core.tape_u4(state, kinds, angles)
    for i, (k, a, b) in enumerate(_entries(kinds, q0s, q1s)):
        state = apply_gate(state, k, a, b, u4s[i], cutoff, eigh)
    return state


def apply_tape_adjoint(state: CMPS, kinds, q0s, q1s, angles, cutoff,
                       eigh: str = None) -> CMPS:
    """Apply the adjoint of a tape: gates reversed, each as its dagger."""
    u4s = sv_core.tape_u4(state, kinds, angles).mH
    entries = _entries(kinds, q0s, q1s)
    for i in range(len(entries) - 1, -1, -1):
        k, a, b = entries[i]
        state = apply_gate(state, k, a, b, u4s[i], cutoff, eigh)
    return state


# ---------------------------------------------------------------- observables
# All by full-chain transfer contractions that assume no gauge: they stay
# exact even where float32 rounding erodes the canonical conditions
# mid-tape, which is the point of a cross-check engine.

def _abs2(z: torch.Tensor) -> torch.Tensor:
    return z.real * z.real + z.imag * z.imag


def cmps_dot(a: CMPS, b: CMPS) -> torch.Tensor:
    """<a|b> by a full transfer-matrix chain (no canonical form assumed)."""
    e = boundary_env(a.chi, a.dtype, a.device)
    for i in range(a.n):
        e = forward_step(e, _site(a, i), _site(b, i))
    return e[..., 0, 0]


def norm_sq(state: CMPS) -> torch.Tensor:
    return cmps_dot(state, state).real


def overlap_with_zero(state: CMPS) -> torch.Tensor:
    v = boundary_env(state.chi, state.dtype, state.device)[0]  # e_0
    for i in range(state.n):
        v = (v.unsqueeze(-2) @ state.t[..., i, 0, :, :]).squeeze(-2)
    return v[..., 0]


def global_cost_normalized(state: CMPS) -> torch.Tensor:
    """1 - |<0|psi>|^2 / <psi|psi>: the reference's ITensor global cost
    (itensor_backend.py:34-42) on the normalised state, which also absorbs
    the norm decay of this engine's truncation."""
    nrm2 = torch.clamp(norm_sq(state), min=1e-30)
    return 1.0 - _abs2(overlap_with_zero(state)) / nrm2


def _left_envs(state: CMPS):
    """lefts[i] = transfer environment of sites < i."""
    e = boundary_env(state.chi, state.dtype, state.device)
    lefts = [e.expand(state.batch + e.shape)]
    for i in range(state.n - 1):
        lefts.append(forward_step(lefts[-1], _site(state, i),
                                  _site(state, i)))
    return torch.stack(lefts, dim=-3)


def z_expectations(state: CMPS) -> torch.Tensor:
    """<Z_q> of every site from generic left and right transfer
    environments, self-normalised per site like the primary engine's."""
    e = boundary_env(state.chi, state.dtype, state.device)
    rights = [e.expand(state.batch + e.shape)]
    for i in range(state.n - 1, 0, -1):
        tk = _site(state, i)
        rights.append(torch.einsum(
            "...pxa,...pay->...xy", tk.conj(),
            rights[-1].unsqueeze(-3) @ tk.transpose(-1, -2)))
    rights = torch.stack(rights[::-1], dim=-3)
    # w[i, p] = <psi| |p><p|_i |psi>
    w = torch.einsum("...iab,...ipax,...ipby,...ixy->...ip",
                     _left_envs(state), state.t.conj(), state.t, rights).real
    return ((w[..., 0] - w[..., 1])
            / torch.clamp(w[..., 0] + w[..., 1], min=1e-30))


def all_pair_rdms(state: CMPS, eigh: str = None) -> torch.Tensor:
    """rho(i, j) of every pair i < j, (n, n, 4, 4) with qubit i as the low
    bit: the primary engine's layout. The center moves to site 0 first, so
    every site right of a pair closes with the identity; left environments
    come from a generic transfer chain. Each RDM is normalised by its trace
    (this engine's truncation does not keep the norm)."""
    state = move_center_to(state, 0, eigh)
    n = state.n
    ts, tc = state.t, state.t.conj()
    # T[i, p, q, a, b]: open physical legs at site i over its left env
    t = torch.einsum("icd,ipda,iqcb->ipqab", _left_envs(state), ts, tc)
    sites = torch.arange(n, device=ts.device)
    rhos = []
    for j in range(n):
        valid = (sites < j)[:, None, None, None, None]
        rho = torch.einsum("ipqab,rac,sbc->irpsq", t, ts[j], tc[j])
        rho = rho.reshape(n, 4, 4)
        tr = torch.clamp(rho.diagonal(dim1=-2, dim2=-1).real.sum(-1),
                         min=1e-30)
        rho = rho / tr[:, None, None]
        rhos.append(torch.where(valid.reshape(n, 1, 1), rho,
                                torch.zeros_like(rho)))
        t_new = torch.einsum("ipqab,rax,rby->ipqxy", t, ts[j], tc[j])
        t = torch.where(valid, t_new, t)
    return torch.stack(rhos, dim=1)


# ------------------------------------------------------------- sweep engine

def local_overlap_matrix(r_state: CMPS, l_state: CMPS, q: int):
    """C[i,j] = <R| |i><j|_q |L>, the probe's 2x2 local overlap, by generic
    prefix and suffix transfer environments: the env-chain wrapper assumes
    no gauge (the CUDA kernel on a CUDA device, its plain version on the
    CPU). Neither state need be normalised: a global scale multiplies every
    probe value alike and leaves the closed-form maximisation of |z|^2
    alone."""
    return env_chain(r_state.t.contiguous(), l_state.t.contiguous(), q)


def full_cost_terms(state: CMPS, ref: CMPS):
    """(global cost against ref, local cost, Hamming-1 sum) of a state or
    of every state of a batch: the probe costs of the full-cost sweep.
    Hamming-1 overlaps are not implemented for this engine (the backend
    raises for soften_global_cost before any sweep runs): the third term is
    zero."""
    nrm2 = torch.clamp(norm_sq(state), min=1e-30)
    g = 1.0 - _abs2(cmps_dot(ref, state)) / nrm2
    loc = 0.5 * (1.0 - z_expectations(state).mean(-1))
    return g, loc, torch.zeros_like(loc)


def sweep_engine(cutoff: float, eigh: str = None):
    """The SweepEngine of this engine (optim/sweeps.py): the device probe
    sweep that the reference's ITensorBackend never had (its every cost
    query is a full re-simulation, itensor_backend.py:34-42)."""
    from ..optim.sweeps import SweepEngine

    def apply(state, kind, q0, q1, u4):
        return apply_gate(state, kind, q0, q1, u4, cutoff, eigh)

    return SweepEngine(f"center_mps[{cutoff}]", apply, local_overlap_matrix,
                       cmps_dot, full_cost_terms, apply_1q_layer)


# -------------------------------------------------------------- host helpers

def to_dense(state: CMPS) -> np.ndarray:
    """Contract to a 2^n little-endian statevector (host, small n)."""
    t = state.t.detach().cpu().numpy()
    n = t.shape[0]
    vec = t[0][:, 0, :]  # (2, chi): left boundary index 0
    for i in range(1, n):
        vec = np.einsum("...a,pab->...pb", vec, t[i])
    vec = vec[..., 0]  # right boundary index 0
    # axes are (p_0, ..., p_{n-1}); qubit 0 is the low bit
    return np.transpose(vec, tuple(reversed(range(n)))).reshape(-1)
