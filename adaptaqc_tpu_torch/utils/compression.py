"""chi=1 variational compression: best product-state approximation.

Port of the JAX package's `utils/compression.py`, the
starting_circuit="tenpy_product_state" start: alternating single-site
optimisation, where the optimal local vector given all others is the
normalised single-site environment of <s|psi>. The restarts draw from
numpy's default_rng(seed), as in the JAX package, so both start alike.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..backends import mps_core
from ..circuits.circuit import Circuit

logger = logging.getLogger(__name__)


def _sequential_sweep(target: mps_core.MPS, s_amps: torch.Tensor):
    """One left-to-right Gauss-Seidel compression sweep of <s|psi>: each
    site takes the normalised environment built from the already-updated
    sites to its left and the previous amplitudes to its right.
    Returns (new amplitudes (n, 2), |<s_new|psi>| as a tensor)."""
    bt = target.b
    n, chi = target.n, target.chi
    m_old = torch.einsum("ip,ipab->iab", s_amps.conj(), bt)
    v0 = torch.zeros(chi, dtype=bt.dtype, device=bt.device)
    v0[0] = 1.0
    suffixes = [None] * n
    v = v0
    for i in range(n - 1, -1, -1):
        suffixes[i] = v
        v = m_old[i] @ v
    prefix = v0
    new_amps = []
    for i in range(n):
        env = torch.einsum("a,pab,b->p", prefix, bt[i], suffixes[i])
        nrm = torch.sqrt((env.real * env.real + env.imag * env.imag).sum())
        inv = torch.where(nrm > 1e-30, 1.0 / torch.clamp(nrm, min=1e-30),
                          torch.zeros_like(nrm))
        amp = env * inv  # E/||E|| maximises |sum_p conj(s_p) E_p|
        new_amps.append(amp)
        prefix = prefix @ torch.einsum("p,pab->ab", amp.conj(), bt[i])
    return torch.stack(new_amps), prefix[0].abs()


def _site_rdm_eigvecs(target: mps_core.MPS) -> np.ndarray:
    """(n, 2) dominant eigenvectors of the single-site RDMs: the mean-field
    initial guess."""
    lam2 = (target.lam[:-1] ** 2).to(target.dtype)
    rho = torch.einsum("ia,ipab,iqab->ipq", lam2, target.b, target.b.conj())
    rho_np = rho.cpu().numpy()
    amps = np.empty((target.n, 2), dtype=complex)
    for i in range(target.n):
        _, v = np.linalg.eigh(rho_np[i])
        amps[i] = v[:, -1]
    return amps


def best_product_state(target: mps_core.MPS, sweeps: int = 50,
                       min_sweeps: int = 5, tol: float = 1e-10,
                       restarts: int = 2, seed: int = 0) -> np.ndarray:
    """(n, 2) complex product-state amplitudes maximising |<s|psi>|, best
    of sweeps from the mean-field guess, |0...0> and `restarts` random
    product states."""
    n = target.n
    rng = np.random.default_rng(seed)
    zero_init = np.zeros((n, 2), dtype=complex)
    zero_init[:, 0] = 1.0
    inits = [_site_rdm_eigvecs(target), zero_init]
    for _ in range(restarts):
        r = rng.normal(size=(n, 2)) + 1j * rng.normal(size=(n, 2))
        inits.append(r / np.linalg.norm(r, axis=1, keepdims=True))

    best_amps, best_overlap = None, -1.0
    for init in inits:
        amps = torch.as_tensor(init, dtype=target.dtype, device=target.device)
        prev = 0.0
        for it in range(sweeps):
            amps, overlap_t = _sequential_sweep(target, amps)
            overlap = float(overlap_t)
            if it + 1 >= min_sweeps and abs(overlap - prev) < tol:
                break
            prev = overlap
        if overlap > best_overlap:
            best_amps, best_overlap = amps.cpu().numpy(), overlap
    logger.info(f"chi=1 compression overlap |<s|psi>| = {best_overlap:.6f}")
    return best_amps


def product_state_to_circuit(amps: np.ndarray, variant: int = 0) -> Circuit:
    """Per-qubit Rz(lead) Ry(theta) Rz(phi) preparation of the product
    state. The leading Rz acts on |0> and is a pure per-qubit global phase:
    variant 0 pins it to 0, variant k > 0 draws it from default_rng(k)."""
    n = amps.shape[0]
    qc = Circuit(n)
    lead = np.zeros(n)
    if variant:
        lead = np.random.default_rng(int(variant)).uniform(-np.pi, np.pi, n)
    for q in range(n):
        a, b = amps[q]
        theta = 2 * np.arctan2(abs(b), abs(a))
        phi = float(np.angle(b) - np.angle(a))
        qc.rz(float(lead[q]), q)
        qc.ry(float(theta), q)
        qc.rz(phi, q)
    return qc


def best_product_state_circuit(compiler) -> Circuit:
    """starting_circuit='tenpy_product_state' entry point. On a backend
    other than MPSBackend, the target is simulated into an MPS by a
    default MPSBackend on the same device and dtype."""
    from ..backends.backend import MPSBackend
    backend = compiler.backend
    if not isinstance(backend, MPSBackend):
        backend = MPSBackend(device=backend.device, dtype=backend.dtype)
    target = backend.mps_from_compiler_target(compiler.circuit_to_compile)
    amps = best_product_state(target)
    return product_state_to_circuit(amps,
                                    getattr(compiler, "start_variant", 0))
