"""TenPy <-> Qiskit-MPS interop (utilityfunctions.py:291-385, 428-481).

The port's copy of the JAX package's `utils/tenpy_interop.py` (NumPy
only; the tenpy import is gated as there).

The reference uses TenPy for chi=1 variational compression, DMRG/TEBD target
generation, and MPS format conversion. The engines here speak the Qiskit MPS
format natively, so interop is pure layout work:

 - TenPy stores per-site tensors with labelled legs (p, vL, vR) and
   per-bond singular values, with two possible physical-basis conventions
   (SpinHalfSite counts up-spin first = qiskit order; SpinSite the reverse).
 - The Qiskit format is ([(G_i[p=0], G_i[p=1])...], [lambda_i...]) with
   descending-sorted singular values.

Only `qiskit_to_tenpy_mps` needs the tenpy package (it constructs TenPy
objects); the TenPy->Qiskit direction works on any object implementing the
TenPy MPS protocol (L, sites, canonical_form, get_B, get_SR, get_theta),
which also makes it testable without the dependency.
"""

from __future__ import annotations

from typing import List

import numpy as np


def _tenpy_modules():
    try:
        from tenpy.networks.mps import MPS as TenpyMPS
        from tenpy.networks.site import SpinHalfSite, SpinSite
    except ModuleNotFoundError as exc:  # pragma: no cover - optional dep
        raise ImportError(
            "tenpy is required for qiskit_to_tenpy_mps; install tenpy or "
            "work with the Qiskit MPS format ((gammas, lambdas)) directly"
        ) from exc
    return TenpyMPS, SpinHalfSite, SpinSite


def check_flipped_basis_states(tenpy_mps) -> List[bool]:
    """Per-site basis convention probe (utilityfunctions.py:428-451): read
    each site's Sz matrix; diag(+1/2, -1/2) means the site already orders
    basis states like qiskit (|0> = up first), diag(-1/2, +1/2) means the
    ordering is reversed and the physical leg must be flipped on export."""
    flags = []
    for i, site in enumerate(tenpy_mps.sites):
        sz = np.asarray(site.get_op("Sz").to_ndarray())
        if np.array_equal(sz, np.diag([0.5, -0.5])):
            flags.append(False)
        elif np.array_equal(sz, np.diag([-0.5, 0.5])):
            flags.append(True)
        else:
            raise ValueError(
                f"site {i} has an unrecognised Sz convention: {sz}")
    return flags


def tenpy_to_qiskit_mps(tenpy_mps):
    """TenPy MPS -> Qiskit format (utilityfunctions.py:291-326).

    Gamma tensors come from the "G" (Vidal) form with legs ordered
    (p, vL, vR). Qiskit expects every bond's singular values descending, so
    each bond spectrum is sorted and the adjacent tensors' virtual legs are
    permuted consistently; flipped-convention sites swap their physical
    slices."""
    n = tenpy_mps.L
    tenpy_mps.canonical_form()
    flip = check_flipped_basis_states(tenpy_mps)

    gammas = []
    lambdas = []
    right_perm = None  # permutation applied to the previous bond
    for i in range(n):
        g = np.array(tenpy_mps.get_B(i, form="G")
                     .itranspose(["p", "vL", "vR"]).to_ndarray())
        if right_perm is not None:
            g = g[:, right_perm, :]
        if i < n - 1:
            spectrum = np.asarray(tenpy_mps.get_SR(i))
            right_perm = np.argsort(spectrum)[::-1]
            lambdas.append(spectrum[right_perm])
            g = g[:, :, right_perm]
        slices = (g[1], g[0]) if flip[i] else (g[0], g[1])
        gammas.append(tuple(np.array(s) for s in slices))
    return gammas, lambdas


def tenpy_mps_to_statevector(tenpy_mps) -> np.ndarray:
    """TenPy MPS -> little-endian dense statevector
    (utilityfunctions.py:454-481)."""
    n = tenpy_mps.L
    theta = np.asarray(tenpy_mps.get_theta(0, n).to_ndarray()).reshape([2] * n)
    for i, flipped in enumerate(check_flipped_basis_states(tenpy_mps)):
        if flipped:
            theta = np.flip(theta, axis=i)
    # theta axes run site 0 first (big-endian w.r.t. qiskit's bit order)
    return theta.transpose(range(n)[::-1]).ravel()


def tenpy_chi_1_mps_to_circuit(tenpy_mps):
    """chi=1 TenPy MPS -> per-qubit preparation circuit
    (utilityfunctions.py:329-353)."""
    from .compression import product_state_to_circuit
    n = tenpy_mps.L
    flip = check_flipped_basis_states(tenpy_mps)
    amps = np.zeros((n, 2), dtype=complex)
    for i in range(n):
        b = np.asarray(tenpy_mps.get_B(i, form="B")
                       .itranspose(["p", "vL", "vR"]).to_ndarray())
        if b.shape[1] != 1 or b.shape[2] != 1:
            raise Exception("MPS must have bond dimension 1 for all bonds.")
        vec = b[::-1, 0, 0] if flip[i] else b[:, 0, 0]
        amps[i] = vec
    return product_state_to_circuit(amps)


def _qiskit_mps_to_b_tensors(qiskit_mps) -> List[np.ndarray]:
    """(gammas, lambdas) -> per-site right-weighted B tensors (p, vL, vR)
    (the preprocessing aqc_research applies before from_Bflat)."""
    gammas, lambdas = qiskit_mps
    n = len(gammas)
    tensors = []
    for i, pair in enumerate(gammas):
        mats = []
        for p in (0, 1):
            m = np.asarray(pair[p])
            if m.ndim == 1:
                m = m.reshape(1, -1) if i == 0 else m.reshape(-1, 1)
            mats.append(m)
        b = np.stack(mats)  # (2, dl, dr)
        if i < n - 1:
            b = b * np.asarray(lambdas[i])[None, None, :]
        tensors.append(b)
    return tensors


def qiskit_to_tenpy_mps(qiskit_mps, return_form: str = "SpinSite"):
    """Qiskit format -> TenPy MPS (utilityfunctions.py:356-385). Requires
    the tenpy package."""
    TenpyMPS, SpinHalfSite, SpinSite = _tenpy_modules()
    tensors = _qiskit_mps_to_b_tensors(qiskit_mps)
    n = len(tensors)
    if return_form == "SpinSite":
        sites = [SpinSite(conserve=None)] * n
        tensors = [b[::-1] for b in tensors]  # SpinSite counts down-spin first
    elif return_form == "SpinHalfSite":
        sites = [SpinHalfSite(conserve=None)] * n
    else:
        raise ValueError(
            f"return_form must be SpinSite or SpinHalfSite, got {return_form}")
    return TenpyMPS.from_Bflat(sites, tensors, SVs=None)
