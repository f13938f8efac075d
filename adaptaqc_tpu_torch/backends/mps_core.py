"""MPS engine: B-form matrix product state simulation in PyTorch.

Counterpart of the JAX package's `backends/mps_core.py`. The state is an
`MPS` of tensors on one device:

  b      (n, 2, chi, chi) complex  B-form site tensors B_i[p] =
                                   Gamma_i[p] diag(lam_{i+1}) (Hastings)
  lam    (n+1, chi) real           bond weights, lam[0] = lam[n] = e0
  trunc  () real                   accumulated relative discarded weight

with a fixed, padded bond dimension chi; amplitude(bits) =
(prod_i B_i[b_i])[0, 0], little-endian (site i = qubit i).

A state may carry one leading batch dimension P on all three tensors (b
(P, n, 2, chi, chi), lam (P, n + 1, chi), trunc (P,)): the probe states of
one gate of the full-cost sweep (optim/sweeps.py), which the JAX package
maps its engine over. Gate application, <a|b> and the cost terms take such
a batch as they take one state; a two-qubit apply then truncates all P
bonds through one call of each eigensolver kernel.

The JAX engine traced every gate with lax.cond / dynamic slices; here the
tape is host data, so gate kind and site are plain Python values and every
branch is a Python `if`. Gate matrices are built on the device
(sv_core.build_u4). Updates are functional: each apply returns a new MPS
and leaves its input untouched, as the sweep keeps earlier states.

Two-qubit applies truncate through ops.cplx.svd_trunc, whose eigensolver is
the explicit `eigh` argument ("kernels" by default, see ops/cplx.py).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .. import config
from ..circuits import gates as G
from ..ops import cplx
from ..ops.env_kernel import (backward_step, boundary_env, env_chain,
                              env_chain_plain, forward_step)
from . import sv_core


class MPS(NamedTuple):
    b: torch.Tensor      # (n, 2, chi, chi) complex
    lam: torch.Tensor    # (n + 1, chi) real
    trunc: torch.Tensor  # () real

    @property
    def n(self) -> int:
        return self.b.shape[-4]

    @property
    def batch(self) -> tuple:
        """() for one state, (P,) for a batch of probe states."""
        return tuple(self.b.shape[:-4])

    @property
    def chi(self) -> int:
        return self.b.shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.b.dtype

    @property
    def device(self):
        return self.b.device


def zero_mps(n: int, chi: int, dtype=None, device="cpu") -> MPS:
    dtype = dtype or config.DEFAULT_DTYPE
    rdt = config.real_dtype(dtype)
    b = torch.zeros((n, 2, chi, chi), dtype=dtype, device=device)
    b[:, 0, 0, 0] = 1.0
    lam = torch.zeros((n + 1, chi), dtype=rdt, device=device)
    lam[:, 0] = 1.0
    return MPS(b, lam, torch.zeros((), dtype=rdt, device=device))


def product_mps(amps: np.ndarray, chi: int, dtype=None, device="cpu") -> MPS:
    """chi-padded product state from per-site (n, 2) complex amplitudes."""
    amps = np.asarray(amps)
    st = zero_mps(amps.shape[0], chi, dtype, device)
    b = st.b.clone()
    b[:, :, 0, 0] = torch.as_tensor(amps, dtype=b.dtype, device=b.device)
    return MPS(b, st.lam, st.trunc)


def b_tensors(state: MPS) -> torch.Tensor:
    return state.b


def mps_from_numpy(b_re, b_im, lam, trunc=0.0, dtype=None,
                   device="cpu") -> MPS:
    """An MPS from host arrays (the JAX engine's b.re, b.im, lam, trunc)."""
    dtype = dtype or config.DEFAULT_DTYPE
    rdt = config.real_dtype(dtype)
    b = torch.as_tensor(np.asarray(b_re) + 1j * np.asarray(b_im),
                        dtype=dtype, device=device)
    lam = torch.as_tensor(np.array(lam), dtype=rdt, device=device)
    return MPS(b, lam,
               torch.as_tensor(float(np.asarray(trunc)), dtype=rdt,
                               device=device))


def mps_to_numpy(state: MPS):
    """(b_re, b_im, lam, trunc) as host numpy arrays."""
    b = state.b.detach().cpu().numpy()
    return (b.real.copy(), b.imag.copy(), state.lam.detach().cpu().numpy(),
            float(state.trunc))


# ------------------------------------------------------------ gate application

def _site(state: MPS, k: int) -> torch.Tensor:
    return state.b[..., k, :, :, :]


def _expand(state: MPS, lead) -> MPS:
    """One state seen as a batch of shape `lead` (views, no copy)."""
    return MPS(state.b.expand(*lead, *state.b.shape),
               state.lam.expand(*lead, *state.lam.shape),
               state.trunc.expand(*lead))


def _apply_1q_at(state: MPS, u2: torch.Tensor, q: int) -> MPS:
    """u2 (2, 2) on site q of a state or of every state of a batch; u2
    (P, 2, 2) applies gate p to state p, or to P copies of one state (the
    probes of one gate): one einsum either way."""
    new = torch.einsum("...pq,...qab->...pab", u2, _site(state, q))
    lead = tuple(new.shape[:-3])
    if lead != state.batch:
        state = _expand(state, lead)
    b = state.b.clone()
    b[..., q, :, :, :] = new
    return MPS(b, state.lam, state.trunc)


def apply_1q_layer(state: MPS, u2s: torch.Tensor) -> MPS:
    """u2s[i] (n, 2, 2) applied at site i, every site of a state (or of
    every state of a batch) in one einsum."""
    return MPS(torch.einsum("ipq,...iqab->...ipab", u2s, state.b), state.lam,
               state.trunc)


def _apply_2q_adjacent(state: MPS, u4: torch.Tensor, k: int, threshold,
                       eigh: str = None) -> MPS:
    """Apply the 4x4 u4 (r = 2*p_right + p_left) on sites (k, k+1) of a
    state, or of every state of a batch.

    Hastings update: no bond weight is ever divided by --
      theta~ = B_l B_r;  theta = diag(lam_l) theta~ = U S V^H
      B_r' = V^H;  B_l' = theta~ V / ||S||."""
    chi = state.chi
    lead = state.batch
    theta_t = torch.einsum("...pac,...qcb->...apqb", _site(state, k),
                           _site(state, k + 1))
    theta_t = torch.einsum("qpsr,...arsb->...apqb", u4.reshape(2, 2, 2, 2),
                           theta_t)
    theta = theta_t * state.lam[..., k, :][..., :, None, None, None]
    m = theta.reshape(lead + (chi * 2, 2 * chi))
    # floor the user threshold at the working precision's noise scale
    eff_threshold = max(float(threshold),
                        0.1 * config.lambda_eps(state.dtype))
    _, s, vh = cplx.svd_trunc(m, chi, eff_threshold, eigh)
    kept = (s * s).sum(-1)
    snorm = torch.clamp(torch.sqrt(kept), min=1e-30)
    total = (m.real * m.real + m.imag * m.imag).sum((-2, -1))
    discarded = (torch.clamp(total - kept, min=0.0)
                 / torch.clamp(total, min=1e-30))
    br_new = vh.reshape(lead + (chi, 2, chi)).transpose(-3, -2)
    bl_flat = cplx._matmul(theta_t.reshape(lead + (chi * 2, 2 * chi)), vh.mH)
    bl_new = (bl_flat.reshape(lead + (chi, 2, chi)).transpose(-3, -2)
              / snorm[..., None, None, None])
    b = state.b.clone()
    b[..., k, :, :, :] = bl_new
    b[..., k + 1, :, :, :] = br_new
    lam = state.lam.clone()
    lam[..., k + 1, :] = s / snorm[..., None]
    return MPS(b, lam, state.trunc + discarded)


def _swap_u4(dtype, device) -> torch.Tensor:
    return sv_core.u4_table(dtype, device)[G.SWAP]


def _apply_2q_routed(state: MPS, u4, q0: int, q1: int, threshold,
                     eigh: str = None) -> MPS:
    """2q gate on (q0 < q1), routed with swaps to adjacency and back."""
    swap = _swap_u4(state.dtype, state.device)
    for k in range(q0, q1 - 1):
        state = _apply_2q_adjacent(state, swap, k, threshold, eigh)
    state = _apply_2q_adjacent(state, u4, q1 - 1, threshold, eigh)
    for k in range(q1 - 2, q0 - 1, -1):
        state = _apply_2q_adjacent(state, swap, k, threshold, eigh)
    return state


def apply_gate(state: MPS, kind: int, q0: int, q1: int, u4: torch.Tensor,
               threshold, eigh: str = None) -> MPS:
    """Apply one tape entry whose 4x4 matrix is u4 (kind only steers) to a
    state or to every state of a batch. A one-qubit entry also takes u4
    (P, 4, 4): gate p on state p (or on P copies of one state)."""
    if kind == G.NOP:
        return state
    if sv_core.is_two_qubit(kind):
        return _apply_2q_routed(state, u4, q0, q1, threshold, eigh)
    return _apply_1q_at(state, u4[..., :2, :2], q0)


def apply_tape(state: MPS, kinds, q0s, q1s, angles, threshold,
               eigh: str = None) -> MPS:
    u4s = sv_core.tape_u4(state, kinds, angles)
    for i, (k, a, b) in enumerate(zip(np.asarray(kinds).tolist(),
                                      np.asarray(q0s).tolist(),
                                      np.asarray(q1s).tolist())):
        state = apply_gate(state, k, a, b, u4s[i], threshold, eigh)
    return state


def apply_tape_adjoint(state: MPS, kinds, q0s, q1s, angles, threshold,
                       eigh: str = None) -> MPS:
    """Apply the adjoint of a tape: gates reversed, each as its dagger."""
    u4s = sv_core.tape_u4(state, kinds, angles).mH
    entries = list(zip(np.asarray(kinds).tolist(), np.asarray(q0s).tolist(),
                       np.asarray(q1s).tolist()))
    for i in range(len(entries) - 1, -1, -1):
        k, a, b = entries[i]
        state = apply_gate(state, k, a, b, u4s[i], threshold, eigh)
    return state


# ---------------------------------------------------------------- observables

def mps_dot(a: MPS, b: MPS) -> torch.Tensor:
    """<a|b> by transfer-matrix contraction: a complex 0-dim tensor, or
    (P,) where either state is a batch."""
    e = boundary_env(a.chi, a.dtype, a.device)
    for i in range(a.n):
        e = forward_step(e, _site(a, i), _site(b, i))
    return e[..., 0, 0]


def _boundary_vec(state: MPS) -> torch.Tensor:
    """e_0 on the padded boundary bond (a row of the shared boundary
    environment: read-only)."""
    return boundary_env(state.chi, state.dtype, state.device)[0]


def amplitude(state: MPS, bits) -> torch.Tensor:
    """<bits|state> for n bit values (little-endian: site i = qubit i):
    the chain of the B_i[bits[i]] matrices."""
    v = _boundary_vec(state)
    for i, bit in enumerate(np.asarray(bits).tolist()):
        v = (v.unsqueeze(-2) @ state.b[..., i, int(bit), :, :]).squeeze(-2)
    return v[..., 0]


def overlap_with_zero(state: MPS) -> torch.Tensor:
    """<0...0|state>: chain of the B_i[0] matrices."""
    return amplitude(state, [0] * state.n)


def hamming1_overlaps(state: MPS) -> torch.Tensor:
    """|<e_i|state>|^2 for the n basis states of Hamming weight 1,
    e_i = 2^i, from prefix and suffix products of the B[0] matrices
    (aer_mps_backend.py:88-93): real (n,), or (P, n) for a batch."""
    n = state.n
    b0 = state.b[..., 0, :, :]  # (..., n, chi, chi)
    v = _boundary_vec(state)
    pre = [v.expand(state.batch + (state.chi,))]
    for i in range(n - 1):
        pre.append((pre[-1].unsqueeze(-2) @ b0[..., i, :, :]).squeeze(-2))
    suf = [pre[0]]
    for i in range(n - 1, 0, -1):
        suf.append((b0[..., i, :, :] @ suf[-1].unsqueeze(-1)).squeeze(-1))
    amps = torch.einsum("...ia,...iab,...ib->...i", torch.stack(pre, -2),
                        state.b[..., 1, :, :], torch.stack(suf[::-1], -2))
    return _abs2(amps)


def _abs2(z: torch.Tensor) -> torch.Tensor:
    return z.real * z.real + z.imag * z.imag


def global_cost_normalized(state: MPS) -> torch.Tensor:
    """1 - |<0...0|state>|^2 / <state|state> (real 0-dim tensor)."""
    nrm2 = torch.clamp(mps_dot(state, state).real, min=1e-30)
    return 1.0 - _abs2(overlap_with_zero(state)) / nrm2


def softened_cost_terms(state: MPS):
    """(normalised global cost, normalised sum of Hamming-1 overlaps): the
    softening penalty shares the <psi|psi> normalisation, or the softened
    cost would not be scale-invariant."""
    nrm2 = torch.clamp(mps_dot(state, state).real, min=1e-30)
    cost = 1.0 - _abs2(overlap_with_zero(state)) / nrm2
    return cost, hamming1_overlaps(state).sum(-1) / nrm2


def z_expectations(state: MPS) -> torch.Tensor:
    """<Z_i> per site, self-normalised per site."""
    lam2 = state.lam[..., :-1, :] ** 2
    w = torch.einsum("...ia,...ipab->...ip", lam2, _abs2(state.b))
    return ((w[..., 0] - w[..., 1])
            / torch.clamp(w[..., 0] + w[..., 1], min=1e-30))


def full_cost_terms(state: MPS, ref: MPS):
    """(global cost against ref, local cost, Hamming-1 overlap sum) of one
    state or of every state of a batch: the probe costs of the full-cost
    sweep. As the backend's cost layer has them: the normalised global
    cost, the local cost 0.5 (1 - mean <Z_q>), and the Hamming-1 sum under
    the same <psi|psi> normalisation."""
    nrm2 = torch.clamp(mps_dot(state, state).real, min=1e-30)
    g = 1.0 - _abs2(mps_dot(ref, state)) / nrm2
    loc = 0.5 * (1.0 - z_expectations(state).mean(-1))
    return g, loc, hamming1_overlaps(state).sum(-1) / nrm2


def local_overlap_matrix(r_state: MPS, l_state: MPS, q: int) -> torch.Tensor:
    """C[i,j] = <R| |i><j|_q |L> (2x2 complex) in plain PyTorch."""
    return env_chain_plain(r_state.b, l_state.b, q)


def _local_overlap_dispatch(r_state: MPS, l_state: MPS, q: int):
    """local_overlap_matrix through the env-chain kernel wrapper (the CUDA
    kernel on a CUDA device, its plain version on the CPU)."""
    return env_chain(r_state.b.contiguous(), l_state.b.contiguous(), q)


def all_pair_rdms(state: MPS) -> torch.Tensor:
    """rho(i, j) of every site pair: a complex (n, n, 4, 4) tensor whose
    entry [i, j], valid for j > i (zero elsewhere), is the two-site RDM with
    qubit i as the low bit of the basis index.

    One left-anchored open-leg tensor T_i per site i, all i at once as a
    batch; a walk over j emits rho(i, j) for every i < j and carries T_i
    through site j. O(n^2 chi^3) in n steps."""
    n = state.n
    bs = state.b
    bc = bs.conj()
    lam2 = (state.lam[:-1] ** 2).to(bs.dtype)
    # T[i, p, p', a, b] = sum_c lam2[i][c] B_i[p][c, a] conj(B_i[p'][c, b])
    t = torch.einsum("ic,ipca,iqcb->ipqab", lam2, bs, bc)
    sites = torch.arange(n, device=bs.device)
    rhos = []
    for j in range(n):
        valid = (sites < j)[:, None, None, None, None]
        rho = torch.einsum("ipqab,rac,sbc->irpsq", t, bs[j], bc[j])
        rhos.append(torch.where(valid, rho, torch.zeros_like(rho))
                    .reshape(n, 4, 4))
        t_new = torch.einsum("ipqab,rax,rby->ipqxy", t, bs[j], bc[j])
        t = torch.where(valid, t_new, t)
    return torch.stack(rhos, dim=1)


# -------------------------------------------------- host conversion utilities

def to_dense(state: MPS) -> np.ndarray:
    """Contract to a 2^n little-endian statevector (host, small n)."""
    b = state.b.detach().cpu().numpy()
    n, _, chi, _ = b.shape
    acc = b[0][:, 0, :]
    for i in range(1, n):
        acc = np.einsum("xc,pcd->xpd", acc, b[i]).reshape(-1, chi)
    vec = acc[:, 0].reshape([2] * n)
    return np.transpose(vec, range(n)[::-1]).reshape(-1)


def from_dense(vec, chi: int, dtype=None, device="cpu") -> MPS:
    """Exact B-form MPS of a dense little-endian statevector by sequential
    host SVDs; Schmidt ranks above chi are truncated and the discarded
    weight recorded in trunc."""
    v = np.asarray(vec, dtype=complex).ravel()
    n = int(np.log2(v.size))
    if v.size != 2 ** n:
        raise ValueError("statevector length must be a power of 2")
    v = v / np.linalg.norm(v)
    t = v.reshape([2] * n).transpose(range(n)[::-1])
    g = np.zeros((n, 2, chi, chi), dtype=complex)
    lam = np.zeros((n + 1, chi))
    lam[0, 0] = lam[n, 0] = 1.0
    discarded = 0.0
    m = t.reshape(1, -1)
    lam_left = np.ones(1)
    for i in range(n):
        chi_l = m.shape[0]
        m = m.reshape(chi_l * 2, -1)
        u, s, vh = np.linalg.svd(m, full_matrices=False)
        keep = min(int((s > 1e-14).sum()) or 1, chi)
        discarded += float((s[keep:] ** 2).sum())
        u, s, vh = u[:, :keep], s[:keep], vh[:keep]
        s = s / np.linalg.norm(s)
        a = u.reshape(chi_l, 2, keep)
        inv_l = np.where(lam_left > 1e-14, 1.0 / np.maximum(lam_left, 1e-30),
                         0.0)
        for p in (0, 1):
            g[i, p, :chi_l, :keep] = inv_l[:, None] * a[:, p, :] * s[None, :]
        if i < n - 1:
            lam[i + 1, :keep] = s
        lam_left = s
        m = s[:, None] * vh
    return mps_from_numpy(g.real, g.imag, lam, discarded, dtype, device)


def from_qiskit_mps(qmps, chi: int, dtype=None, device="cpu") -> MPS:
    """Import the Qiskit MPS format (per-site (G0, G1), per-bond lambdas);
    the Gamma tensors fold in their right bond weights to become B-form.
    A non-unit norm is corrected on the host in float64."""
    gams, lams = qmps
    n = len(gams)
    b = np.zeros((n, 2, chi, chi), dtype=complex)
    lam = np.zeros((n + 1, chi))
    lam[0, 0] = lam[n, 0] = 1.0
    for i, v in enumerate(lams):
        v = np.asarray(v)
        lam[i + 1, :v.size] = v
    for i, pair in enumerate(gams):
        lam_r = lam[i + 1, :]
        for p in (0, 1):
            m = np.asarray(pair[p])
            if m.ndim == 1:
                m = m.reshape(1, -1) if i == 0 else m.reshape(-1, 1)
            dl, dr = m.shape
            if dl > chi or dr > chi:
                raise ValueError(f"bond dim {m.shape} exceeds padded chi={chi}")
            b[i, p, :dl, :dr] = m * lam_r[:dr]
    host = MPS(torch.as_tensor(b), torch.as_tensor(lam),
               torch.zeros((), dtype=torch.float64))
    nrm2 = float(mps_dot(host, host).real)
    if not np.isfinite(nrm2) or nrm2 <= 0:
        raise ValueError(f"qiskit MPS import has invalid norm^2 {nrm2}")
    if abs(nrm2 - 1.0) > 1e-6:
        b[0] *= 1.0 / np.sqrt(nrm2)
    return mps_from_numpy(b.real, b.imag, lam, 0.0, dtype, device)


def to_qiskit_mps(state: MPS):
    """Export to the Qiskit MPS format, stripping bond padding (Gamma
    tensors recovered on the host, in float64, by unweighting the right
    bond)."""
    b = state.b.detach().cpu().numpy().astype(complex)
    lam = state.lam.detach().cpu().numpy().astype(np.float64)
    n = state.n
    dims = [1]
    for i in range(1, n):
        dims.append(max(int((lam[i] > 1e-14).sum()), 1))
    dims.append(1)
    gams, lams = [], []
    for i in range(n):
        dl, dr = dims[i], dims[i + 1]
        lam_r = lam[i + 1, :dr] if i < n - 1 else np.ones(1)
        inv_r = np.where(lam_r > 1e-14, 1.0 / np.maximum(lam_r, 1e-30), 0.0)
        gams.append((b[i, 0, :dl, :dr] * inv_r, b[i, 1, :dl, :dr] * inv_r))
        if i < n - 1:
            lams.append(lam[i + 1, :dims[i + 1]])
    return gams, lams


def pad_chi(state: MPS, new_chi: int) -> MPS:
    """Exact embedding into a larger padded bond dimension."""
    n, chi = state.n, state.chi
    if new_chi < chi:
        raise ValueError("pad_chi cannot shrink the bond dimension")
    if new_chi == chi:
        return state
    b = torch.zeros((n, 2, new_chi, new_chi), dtype=state.dtype,
                    device=state.device)
    b[:, :, :chi, :chi] = state.b
    lam = torch.zeros((n + 1, new_chi), dtype=state.lam.dtype,
                      device=state.device)
    lam[:, :chi] = state.lam
    return MPS(b, lam, state.trunc)


def regauge(state: MPS, new_chi: int) -> MPS:
    """An MPS in another padded bond dimension, on the same device and in
    the same dtype. Growing is pad_chi's exact zero-padding. Shrinking
    keeps the new_chi largest Schmidt values of every bond (the greedy
    per-bond truncation of a capped two-qubit apply) through the Qiskit
    format on the host; from_qiskit_mps renormalises. Serves
    compile_with_chi_schedule, whose stages work at different chi on one
    engine-MPS target."""
    if new_chi == state.chi:
        return state
    if new_chi > state.chi:
        return pad_chi(state, new_chi)
    gams, lams = to_qiskit_mps(state)
    cut_gams, cut_lams = [], []
    keep_l = np.array([0])  # bond 0 is the trivial left edge
    for i in range(state.n):
        if i < state.n - 1:
            lam = np.asarray(lams[i])
            keep_r = np.sort(np.argsort(-lam)[:new_chi])
            cut_lams.append(lam[keep_r])
        else:
            keep_r = np.array([0])
        g0, g1 = gams[i]
        cut_gams.append((np.asarray(g0)[np.ix_(keep_l, keep_r)],
                         np.asarray(g1)[np.ix_(keep_l, keep_r)]))
        keep_l = keep_r
    return from_qiskit_mps((cut_gams, cut_lams), new_chi, state.dtype,
                           state.device)


def check_mps(obj) -> bool:
    """True for an engine MPS or a Qiskit-format MPS tuple."""
    if isinstance(obj, MPS):
        return True
    return (isinstance(obj, tuple) and len(obj) == 2
            and isinstance(obj[0], (list, tuple))
            and isinstance(obj[1], (list, tuple))
            and len(obj[0]) > 0 and isinstance(obj[0][0], (tuple, list)))


# ------------------------------------------------------------------ sweep

class SweepEnv(NamedTuple):
    """The incremental probe environments of one sweep (optim/sweeps.py
    EnvOps), between the sweep's current R and L states:

      e_buf[i]  env of sites < i, valid for i <= e_ptr;
      g_buf[x]  env of sites > n-1-x, valid for x <= g_ptr: the right
                chain in reversed coordinates, so both chains advance
                upward.

    The buffers (n, chi, chi) stay on the state's device and are written
    in place as the frontiers advance; the pointers are host ints. The JAX
    package advances ENV_CHUNK sites a while-loop iteration into buffers
    with slack rows (a TPU loop iteration has a fixed dispatch cost); here
    a site is one step, and every environment read is the same."""
    e_buf: torch.Tensor
    g_buf: torch.Tensor
    e_ptr: int
    g_ptr: int


def _env_init(state: MPS) -> SweepEnv:
    n, chi = state.n, state.chi
    e0 = boundary_env(chi, state.dtype, state.device)
    e_buf = torch.empty((n, chi, chi), dtype=state.dtype, device=state.device)
    g_buf = torch.empty_like(e_buf)
    e_buf[0] = e0  # device-to-device copies: no host synchronisation
    g_buf[0] = e0
    return SweepEnv(e_buf, g_buf, 0, 0)


def _env_touch(env: SweepEnv, t0: int, t1: int) -> SweepEnv:
    """A gate moved sites t0..t1 of the R or the L state: left envs stay
    valid up to position t0, right envs up to reversed position n-1-t1."""
    n = env.e_buf.shape[0]
    return env._replace(e_ptr=min(env.e_ptr, t0),
                        g_ptr=min(env.g_ptr, n - 1 - t1))


def _env_probe(env: SweepEnv, r_state: MPS, l_state: MPS, q: int):
    """Advance both frontiers to site q and contract
    C[i, j] = <R| |i><j|_q |L>: |q - previous probe site| site steps
    instead of local_overlap_matrix's n. Returns (C (2, 2), env)."""
    n = r_state.n
    br, bl = r_state.b, l_state.b
    e_buf, g_buf = env.e_buf, env.g_buf
    for i in range(env.e_ptr, q):  # E_{i+1} = step(E_i, site i)
        e_buf[i + 1] = forward_step(e_buf[i], br[i], bl[i])
    xq = n - 1 - q
    for x in range(env.g_ptr, xq):  # G_{x+1} = step(G_x, site n-1-x)
        g_buf[x + 1] = backward_step(g_buf[x], br[n - 1 - x], bl[n - 1 - x])
    cm = torch.einsum("iax,ab,jby,xy->ij", br[q].conj(), e_buf[q], bl[q],
                      g_buf[xq])
    return cm, SweepEnv(e_buf, g_buf, max(env.e_ptr, q), max(env.g_ptr, xq))


def sweep_engine(threshold: float, eigh: str = None, allow_env_cache=None):
    """The SweepEngine of this engine (optim/sweeps.py): the gate applier
    (a state or a batch of probe states), the probe's local overlap
    (through the env-chain kernel wrapper), <a|b> and the full-cost
    sweep's cost terms.

    allow_env_cache: the incremental probe environments (EnvOps; the
    probes then run as plain PyTorch site steps, not K1). None reads
    ADAPTAQC_ENVCACHE as the JAX package does: any non-empty value turns
    them on; off by default."""
    from ..optim.sweeps import EnvOps, SweepEngine

    use_env = (bool(os.environ.get("ADAPTAQC_ENVCACHE"))
               if allow_env_cache is None else bool(allow_env_cache))

    def apply(state, kind, q0, q1, u4):
        return apply_gate(state, kind, q0, q1, u4, threshold, eigh)

    env_ops = EnvOps(_env_init, _env_touch, _env_probe) if use_env else None
    return SweepEngine(f"mps[{threshold}{',env' if use_env else ''}]",
                       apply, _local_overlap_dispatch, mps_dot,
                       full_cost_terms, apply_1q_layer, env_ops)


# ------------------------------------------------------ pair-gradient overlaps

def _env_stacks(bra: MPS, ket: MPS):
    """prefixes[i] = env of sites < i, suffixes[i] = env of sites > i."""
    n, chi = bra.n, bra.chi
    e0 = boundary_env(chi, bra.dtype, bra.device)
    pre = [e0]
    for i in range(n - 1):
        pre.append(forward_step(pre[-1], bra.b[i], ket.b[i]))
    suf = [e0]
    for i in range(n - 1, 0, -1):
        suf.append(backward_step(suf[-1], bra.b[i], ket.b[i]))
    return torch.stack(pre), torch.stack(suf[::-1])


def pair_op_overlaps(bra: MPS, ket: MPS, ops_a: torch.Tensor,
                     ops_b: torch.Tensor, pairs, max_dist: int):
    """<bra| A^{(k,m)} B^{(k,m)} |ket> for every operator k and pair p,
    summed over Schmidt terms m: A acts on site pairs[p, 1], B on pairs[p, 0];
    ops_a/ops_b are complex (K, M, 2, 2). Returns (K, P) complex.

    The transfer environments away from a pair are shared by every
    operator: build them once, then per pair the two-site open-leg tensor
        W[u, v, w, z] = <bra| (|u><v| at lo) (|w><z| at hi) |ket>
    and read every operator off as a 16-term dot with W. `max_dist` bounds
    |pairs[:, 1] - pairs[:, 0]| (1 for a linear coupling map)."""
    pairs = np.asarray(pairs)
    n = bra.n
    pre, suf = _env_stacks(bra, ket)
    lo_np = np.minimum(pairs[:, 0], pairs[:, 1])
    hi_np = np.maximum(pairs[:, 0], pairs[:, 1])
    dev = bra.device
    lo = torch.as_tensor(lo_np, device=dev)
    hi = torch.as_tensor(hi_np, device=dev)
    bb = bra.b.conj()
    x_t = torch.einsum("Puax,Pab,Pvby->Puvxy", bb[lo], pre[lo], ket.b[lo])
    for d in range(1, max_dist):
        mid = torch.clamp(lo + d, max=n - 1)
        x_new = torch.einsum("Ppxa,Puvxy,Ppyb->Puvab", bb[mid], x_t,
                             ket.b[mid])
        live = torch.as_tensor(lo_np + d < hi_np, device=dev)
        x_t = torch.where(live[:, None, None, None, None], x_new, x_t)
    w = torch.einsum("Pwxa,Puvxy,Pzyb,Pab->Puvwz", bb[hi], x_t, ket.b[hi],
                     suf[hi])
    # B acts on pairs[p, 0]: when a pair arrives descending, swap the groups
    desc = torch.as_tensor(pairs[:, 0] > pairs[:, 1], device=dev)
    w = torch.where(desc[:, None, None, None, None],
                    w.permute(0, 3, 4, 1, 2), w)
    return torch.einsum("kmuv,kmwz,puvwz->kp", ops_b, ops_a, w)


def batched_op_overlaps(bra: MPS, ket: MPS, ops_a: torch.Tensor,
                        ops_b: torch.Tensor, pairs):
    """pair_op_overlaps' contract by plain chains: for every operator k and
    Schmidt term m one n-site transfer chain with A inserted at site
    pairs[p, 1] and B at pairs[p, 0], all pairs at once; summed over m.
    ops_a/ops_b complex (K, M, 2, 2); returns (K, P) complex. O(K M n):
    the independent check of pair_op_overlaps."""
    pairs = np.asarray(pairs)
    dev = bra.device
    k_n, m_n = ops_a.shape[0], ops_a.shape[1]
    p_n = pairs.shape[0]
    c_sites = torch.as_tensor(pairs[:, 0], device=dev)
    t_sites = torch.as_tensor(pairs[:, 1], device=dev)
    eye = torch.eye(2, dtype=bra.dtype, device=dev)
    e0 = boundary_env(bra.chi, bra.dtype, dev).expand(p_n, -1, -1)
    bb = bra.b.conj()
    vals = []
    for a_op, b_op in zip(ops_a.reshape(-1, 2, 2), ops_b.reshape(-1, 2, 2)):
        e = e0
        for i in range(bra.n):
            is_c = (c_sites == i).to(bra.dtype)[:, None, None]
            is_t = (t_sites == i).to(bra.dtype)[:, None, None]
            o = eye + is_c * (b_op - eye) + is_t * (a_op - eye)  # (P, 2, 2)
            e = torch.einsum("qax,lqp,lab,pby->lxy", bb[i], o, e, ket.b[i])
        vals.append(e[:, 0, 0])
    return torch.stack(vals).reshape(k_n, m_n, p_n).sum(dim=1)
