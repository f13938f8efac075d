"""Statevector engine over a flat complex (2**n,) tensor, and the gate
matrices of tape entries that every engine uses.

Counterpart of the JAX package's `backends/sv_core.py`. Convention:
little-endian (qubit 0 is the least-significant bit of the basis index), so
the amplitude of |0...0> is state[0] and the global cost is 1 - |state[0]|^2.
Two-qubit gate matrices use the basis index r = 2*b(q1) + b(q0); one-qubit
gates act on q0 and embed as kron(I2, U).

The JAX engine gathered over all 2**n indices so that one `lax.scan` could
serve traced qubit indices. Here the qubits are host ints, and every op is a
matrix product on a view of the flat state, with no gather and no copy:

 - a window of W = 5 index bits [p, p+W) that holds the gate's qubits gives
   the view (2**(n-W-p), 2**W, 2**p). The gate, embedded in the window as
   one 32x32 matrix, is applied by one (batched) product: one read and one
   write of the state. cuBLAS is slow on the bare 2x2 and 4x4 products of
   the (X, 2, Z) view (measured on an H100: 3.3 ms against 0.58 ms at
   n=26), and a 32x32 matrix still keeps the product memory-bound;
 - the probe's 2x2 local overlap matrix and the two-qubit RDMs are partial
   traces of the window's 32x32 Gram matrix sum_{x,z} conj(R) L, whose
   products are split so that none runs a huge inner dimension in one
   block (cuBLAS does not split a batched product's inner dimension).

Pairs that no window holds fall back to einsum (applies) or a permuted
copy (RDMs). Updates are functional: the sweep keeps earlier states, so an
apply never writes into its input.

A state may carry one leading batch dimension, (P, 2**n): the probe states
of one gate of the full-cost sweep (optim/sweeps.py). The batch index is the
slowest, so every view above folds it into its outer dimension and one gate
is applied to all P states by the same single product.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..circuits import gates as G
from ..circuits.tape import U4_TABLE

_TABLE_CACHE = {}
_PAULI_CACHE = {}


def u4_table(dtype: torch.dtype, device) -> torch.Tensor:
    """U4_TABLE (N_KINDS + 1, 4, 4) on the device, built once per dtype."""
    key = (dtype, str(device))
    t = _TABLE_CACHE.get(key)
    if t is None:
        t = torch.as_tensor(U4_TABLE, dtype=dtype, device=device)
        _TABLE_CACHE[key] = t
    return t


def paulis(dtype: torch.dtype, device) -> torch.Tensor:
    """(X, Y, Z) as a (3, 2, 2) tensor on the device."""
    key = (dtype, str(device))
    t = _PAULI_CACHE.get(key)
    if t is None:
        t = torch.as_tensor(G.PAULIS_NP, dtype=dtype, device=device)
        _PAULI_CACHE[key] = t
    return t


def rotation_u2(axis: torch.Tensor, angle: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """cos(a/2) I - i sin(a/2) P_axis for (batched) axis in {0, 1, 2} =
    (X, Y, Z) and real angle; stays on the device (no host sync)."""
    dev = angle.device
    p = paulis(dtype, dev)[axis]  # (..., 2, 2)
    half = angle.to(torch.empty((), dtype=dtype).real.dtype) * 0.5
    c = torch.cos(half)[..., None, None]
    s = torch.sin(half)[..., None, None]
    eye = torch.eye(2, dtype=dtype, device=dev)
    return c * eye - 1j * s * p


def build_u4(kinds: torch.Tensor, angles: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """(G, 4, 4) gate matrices for tape entries (kinds (G,) int tensor,
    angles (G,) real tensor, both on the target device)."""
    dev = kinds.device
    fixed = u4_table(dtype, dev)[kinds]
    is_rot = (kinds >= G.RX) & (kinds <= G.RZ)
    axis = torch.clamp(kinds - G.RX, 0, 2)
    u2 = rotation_u2(axis, angles, dtype)
    rot = torch.zeros_like(fixed)
    rot[..., :2, :2] = u2
    rot[..., 2:, 2:] = u2
    return torch.where(is_rot[..., None, None], rot, fixed)


def tape_u4(like, kinds, angles) -> torch.Tensor:
    """(G, 4, 4) matrices of host tape arrays, built on the device and in
    the complex dtype of `like` (a state tensor or an MPS)."""
    dev = like.device
    k = torch.as_tensor(np.asarray(kinds), dtype=torch.long, device=dev)
    a = torch.as_tensor(np.asarray(angles),
                        dtype=config.real_dtype(like.dtype), device=dev)
    return build_u4(k, a, like.dtype)


def is_two_qubit(kind: int) -> bool:
    return kind in (G.CX, G.CZ, G.SWAP) or kind >= G.N_KINDS


def two_qubit_mask(kinds: np.ndarray) -> np.ndarray:
    kinds = np.asarray(kinds)
    return ((kinds == G.CX) | (kinds == G.CZ) | (kinds == G.SWAP)
            | (kinds >= G.N_KINDS))


# ---------------------------------------------------------------- states

def num_qubits(state: torch.Tensor) -> int:
    """Qubits of a flat state (2**n,) or of a batch of them (P, 2**n)."""
    n = state.shape[-1].bit_length() - 1
    if state.dim() not in (1, 2) or state.shape[-1] != 1 << n:
        raise ValueError(f"not a flat statevector: shape {tuple(state.shape)}")
    return n


def zero_state(n: int, dtype=None, device="cpu") -> torch.Tensor:
    state = torch.zeros(1 << n, dtype=dtype or config.DEFAULT_DTYPE,
                        device=device)
    state[0] = 1.0
    return state


def state_from_vector(vec, dtype=None, device="cpu") -> torch.Tensor:
    """A normalised engine state from a host vector (normalised in
    float64 on the host)."""
    v = np.asarray(vec, dtype=np.complex128).ravel()
    v = v / np.linalg.norm(v)
    return torch.as_tensor(v, dtype=dtype or config.DEFAULT_DTYPE,
                           device=device)


def state_from_numpy(re, im, dtype=None, device="cpu") -> torch.Tensor:
    """An engine state from host arrays (the JAX engine's state.re,
    state.im), taken as they are."""
    v = np.asarray(re, dtype=np.float64) + 1j * np.asarray(im,
                                                           dtype=np.float64)
    return torch.as_tensor(v, dtype=dtype or config.DEFAULT_DTYPE,
                           device=device)


def state_to_numpy(state: torch.Tensor):
    """(re, im) of a state as host numpy arrays."""
    v = state.detach().cpu().numpy()
    return v.real.copy(), v.imag.copy()


# -------------------------------------------------------- gate application

W = 5  # bits of the index window a gate is embedded in (a 32x32 matrix)
_SPLIT = 1 << 14  # inner dimension of one block of a split Gram product


def _pair_view(state: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """(2**(n-1-hi), 2, 2**(hi-lo-1), 2, 2**lo) view: axis 1 is b(hi),
    axis 3 is b(lo)."""
    return state.view(-1, 2, 1 << (hi - lo - 1), 2, 1 << lo)


def _embed(u: torch.Tensor, w: int, bits) -> torch.Tensor:
    """The 2**w matrix of gate u on the window bits `bits` (u's basis
    index is sum_t b(bits[t]) 2**t)."""
    k = len(bits)
    d = 1 << w
    eye = torch.eye(d, dtype=u.dtype, device=u.device).reshape([2] * w + [d])
    axes = [w - 1 - b for b in reversed(bits)]  # big-endian tensor axes
    t = torch.tensordot(u.reshape([2] * (2 * k)), eye,
                        dims=(list(range(k, 2 * k)), axes))
    return torch.movedim(t, list(range(k)), axes).reshape(d, d)


def _window(n: int, lo: int, hi: int):
    """(p, w): the window [p, p+w) that starts at bit 0 when it can, else
    at the lower qubit (or as high as the state allows). It holds the
    qubits when hi - p < w."""
    w = min(W, n)
    return (0 if hi < w else min(lo, n - w)), w


def _window_product(state: torch.Tensor, m: torch.Tensor, p: int,
                    w: int) -> torch.Tensor:
    """m (2**w, 2**w) applied to the window bits: one product over the
    (X, 2**w, 2**p) view (a batch of states folds into X). m (P, 2**w,
    2**w) applies matrix i to state i, or to P copies of one state."""
    if m.dim() == 3:
        size = state.shape[-1]
        st = state.expand(m.shape[0], size)
        if p == 0:
            return (st.reshape(m.shape[0], -1, 1 << w) @ m.mT).reshape(-1, size)
        return torch.matmul(m[:, None], st.reshape(m.shape[0], -1, 1 << w,
                                                   1 << p)).reshape(-1, size)
    if p == 0:
        return (state.view(-1, 1 << w) @ m.T).reshape(state.shape)
    return torch.matmul(m, state.view(-1, 1 << w, 1 << p)).reshape(state.shape)


def apply_u2(state: torch.Tensor, u2: torch.Tensor, q: int) -> torch.Tensor:
    """A 2x2 gate on qubit q; u2 (P, 2, 2) applies gate i to state i of a
    batch, or to P copies of one state (the probes of one gate)."""
    p, w = _window(num_qubits(state), q, q)
    if u2.dim() == 3:
        m = torch.stack([_embed(u, w, [q - p]) for u in u2])
    else:
        m = _embed(u2, w, [q - p])
    return _window_product(state, m, p, w)


def apply_u4(state: torch.Tensor, u4: torch.Tensor, q0: int,
             q1: int) -> torch.Tensor:
    """A 4x4 gate (basis index 2*b(q1) + b(q0)) on qubits q0 != q1: a
    window product where a window holds both qubits and its inner size is
    1 or at least 8 (inner sizes 2 and 4 measured slower than einsum's
    copies on an H100), else einsum over the pair view."""
    lo, hi = min(q0, q1), max(q0, q1)
    p, w = _window(num_qubits(state), lo, hi)
    if hi - p < w and not 0 < p < 3:
        return _window_product(state, _embed(u4, w, [q0 - p, q1 - p]), p, w)
    u = u4 if q1 > q0 else (u4.reshape(2, 2, 2, 2).permute(1, 0, 3, 2)
                            .reshape(4, 4))
    out = torch.einsum("abcd,xcydz->xaybz", u.reshape(2, 2, 2, 2),
                       _pair_view(state, lo, hi))
    return out.reshape(state.shape)


def apply_gate(state: torch.Tensor, kind: int, q0: int, q1: int,
               u4: torch.Tensor) -> torch.Tensor:
    """Apply one tape entry whose 4x4 matrix is u4 (kind only steers) to a
    state or to every state of a batch; a one-qubit entry also takes u4
    (P, 4, 4), one gate a state."""
    if kind == G.NOP:
        return state
    if is_two_qubit(kind):
        return apply_u4(state, u4, q0, q1)
    return apply_u2(state, u4[..., :2, :2], q0)


def apply_tape(state: torch.Tensor, kinds, q0s, q1s, angles) -> torch.Tensor:
    u4s = tape_u4(state, kinds, angles)
    for i, (k, a, b) in enumerate(zip(np.asarray(kinds).tolist(),
                                      np.asarray(q0s).tolist(),
                                      np.asarray(q1s).tolist())):
        state = apply_gate(state, k, a, b, u4s[i])
    return state


def apply_tape_adjoint(state: torch.Tensor, kinds, q0s, q1s,
                       angles) -> torch.Tensor:
    """Apply the adjoint of a tape: gates reversed, each as its dagger."""
    u4s = tape_u4(state, kinds, angles).mH
    entries = list(zip(np.asarray(kinds).tolist(), np.asarray(q0s).tolist(),
                       np.asarray(q1s).tolist()))
    for i in range(len(entries) - 1, -1, -1):
        k, a, b = entries[i]
        state = apply_gate(state, k, a, b, u4s[i])
    return state


# ------------------------------------------------------------- observables

def overlap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a|b>: a complex 0-dim tensor, or (P,) where either is a batch."""
    if a.dim() == 1 and b.dim() == 1:
        return torch.vdot(a, b)
    return (a.conj() * b).sum(-1)


def _abs2(z: torch.Tensor) -> torch.Tensor:
    return z.real * z.real + z.imag * z.imag


def global_cost(state: torch.Tensor) -> torch.Tensor:
    """1 - |<0...0|state>|^2 (real 0-dim tensor)."""
    return 1.0 - _abs2(state[0])


def probabilities(state: torch.Tensor) -> torch.Tensor:
    return _abs2(state)


def z_expectations(state: torch.Tensor, n: int = None) -> torch.Tensor:
    """<Z_q> for every qubit q, from one (2**n,) probability vector: the
    marginal of qubit q is a sum over the (X, 2, Z) view."""
    n = num_qubits(state) if n is None else n
    probs = probabilities(state)
    lead = tuple(probs.shape[:-1])
    out = []
    for q in range(n):
        m = probs.view(lead + (-1, 2, 1 << q)).sum(dim=(-3, -1))
        out.append(m[..., 0] - m[..., 1])
    return torch.stack(out, dim=-1)


def full_cost_terms(state: torch.Tensor, ref: torch.Tensor):
    """(global cost against ref, local cost, Hamming-1 overlap sum) of one
    state or of every state of a batch: the probe costs of the full-cost
    sweep, as the backend's cost layer has them: 1 - |<ref|psi>|^2,
    0.5 (1 - mean <Z_q>), and the sum of |<e_i|psi>|^2 over the n basis
    states of Hamming weight 1."""
    n = num_qubits(state)
    g = 1.0 - _abs2(overlap(ref, state))
    loc = 0.5 * (1.0 - z_expectations(state, n).mean(-1))
    ones = torch.as_tensor(2 ** np.arange(n), device=state.device)
    return g, loc, probabilities(state)[..., ones].sum(-1)


def _gram_window(n: int, lo: int, hi: int):
    """(p, w) of a window [p, p+w) holding qubits lo..hi whose Gram product
    parallelises: p = 0 (one split product), or at least 128 batches of
    inner size >= 32, or at most 4 batches (split along z). None if no
    window fits."""
    w = min(W, n)
    if hi < w:
        return 0, w
    p = min(lo, n - w - 7)
    if p >= max(w, hi - w + 1):
        return p, w
    p = min(lo, n - w)
    if hi - p < w and n - w - p <= 2:
        return p, w
    return None


def _gram(r: torch.Tensor, l: torch.Tensor, p: int, w: int) -> torch.Tensor:
    """G[a, b] = sum_{x,z} conj(R[x, a, z]) L[x, b, z] over the
    (X, 2**w, 2**p) views (a (2**w, 2**w) matrix)."""
    d, z = 1 << w, 1 << p
    x = r.numel() // (d * z)
    if z == 1:  # one product of inner size X, split into blocks
        k = min(x, _SPLIT)
        return torch.matmul(r.view(x // k, k, d).mH,
                            l.view(x // k, k, d)).sum(0)
    if x >= 128:  # one product per x, inner size z
        return torch.matmul(l.view(x, d, z), r.view(x, d, z).mH).sum(0).T
    # few x: rows (x, a) have the uniform stride z; split z into blocks
    k = min(z, _SPLIT)
    lb = l.view(x * d, z // k, k).transpose(0, 1)
    rb = r.view(x * d, z // k, k).transpose(0, 1)
    g = torch.matmul(lb, rb.mH).sum(0).view(x, d, x, d)
    return g.diagonal(dim1=0, dim2=2).sum(-1).T


def local_overlap_matrix(r_state: torch.Tensor, l_state: torch.Tensor,
                         q: int) -> torch.Tensor:
    """C[i, j] = <R| (|i><j| on qubit q) |L>, the 2x2 local overlap matrix
    of the sweep's probes: the partial trace of the window Gram matrix over
    the window's other bits (or, where no window fits, one product of the
    (X, 2, Z) views, summed)."""
    n = num_qubits(l_state)
    win = _gram_window(n, q, q)
    if win is None:
        r3, l3 = r_state.view(-1, 2, 1 << q), l_state.view(-1, 2, 1 << q)
        return (r3.conj()[:, :, None, :] * l3[:, None, :, :]).sum((0, 3))
    p, w = win
    b = q - p
    g = _gram(r_state, l_state, p, w).view(1 << (w - 1 - b), 2, 1 << b,
                                           1 << (w - 1 - b), 2, 1 << b)
    return torch.einsum("aibajb->ij", g)


def rdm2(state: torch.Tensor, qa: int, qb: int) -> torch.Tensor:
    """Two-qubit reduced density matrix of qubits qa != qb, basis index
    r = 2*b(qb) + b(qa) (so with qa < qb the smaller qubit is the low bit,
    as qiskit's partial_trace has it).

    A partial trace of the window Gram matrix where a window holds both
    qubits; otherwise the pair's amplitudes are gathered into one
    contiguous (4, 2**(n-2)) block Psi and rho = Psi Psi^H."""
    n = num_qubits(state)
    lo, hi = min(qa, qb), max(qa, qb)
    win = _gram_window(n, lo, hi)
    if win is not None:
        p, w = win
        a, b = hi - p, lo - p  # window bits of hi and lo
        # rho over the window = G^T, G[a, b] = sum conj(psi[a]) psi[b]
        g = _gram(state, state, p, w).T.reshape(
            1 << (w - 1 - a), 2, 1 << (a - b - 1), 2, 1 << b,
            1 << (w - 1 - a), 2, 1 << (a - b - 1), 2, 1 << b)
        rho = torch.einsum("xhyjz xkylz->hjkl".replace(" ", ""), g)
        rho = rho.reshape(4, 4)  # index 2*b(hi) + b(lo)
    else:
        psi = _pair_view(state, lo, hi).permute(1, 3, 0, 2, 4).reshape(4, -1)
        rho = psi @ psi.mH
    if qb == hi:
        return rho
    return rho.reshape(2, 2, 2, 2).permute(1, 0, 3, 2).reshape(4, 4)


def all_pair_rdms(state: torch.Tensor, pairs) -> torch.Tensor:
    """(P, 4, 4) RDMs for host integer pairs (P, 2): rho of pairs[p, 0],
    pairs[p, 1] as rdm2 has it."""
    pairs = np.asarray(pairs).reshape(-1, 2).tolist()
    return torch.stack([rdm2(state, a, b) for a, b in pairs])


# ------------------------------------------------------------------ sweep

def sweep_engine():
    """The SweepEngine of this engine (optim/sweeps.py): gate applier (a
    state or a batch of probe states), the probe's local overlap matrix,
    <a|b> and the full-cost sweep's cost terms."""
    from ..optim.sweeps import SweepEngine
    return SweepEngine("sv", apply_gate, local_overlap_matrix, overlap,
                       full_cost_terms)
