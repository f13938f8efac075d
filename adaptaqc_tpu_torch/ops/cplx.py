"""Truncated complex SVD of the MPS bond update, and its eigh switch.

Counterpart of the JAX package's `ops/cplx.py` `svd_trunc`. There the
engine's complex numbers were split (re, im) pairs because the TPU had no
complex dtype; here they are native complex64/complex128 tensors, so only
the SVD contract is left in this module.

The SVD comes from the top eigenpairs of the Gram matrix theta^H theta,
through one of two eigensolvers, chosen by the explicit `eigh` argument:

  "kernels"  (the default) the three eigensolver kernels of
             ops/eigh_kernels.py: tridiagonalize -> tridiagonal eigensolver
             -> back-transform. On a CUDA tensor these are hand-written CUDA
             kernels (complex64 and complex128; a call above their reach
             raises, ops/dispatch.py); on a CPU tensor their plain PyTorch
             versions.
  "native"   torch.linalg.eigh in complex128 (cuSOLVER's zheevd on the
             card), on the Gram formed in complex128, with its exactly zero
             rows and columns split off (`split_zero_rows`).

`verification_eigh()` makes "native" the default inside its block: one-shot
verification re-simulations must not share the failure modes of the sweep
path they verify (the JAX package pins them to its `embed` eigh for the same
reason).

Why the split: a Gram of a padded MPS bond has whole rows and columns that
are exactly zero (at chi = 1024, m = 2048, 2044 of them), and on such
matrices cuSOLVER's zheevd fails to converge ("error 967", 10 of the 98
Grams of a deep re-simulation at chi = 1024 on an H100; the same Grams
turned by a random unitary, and full-rank Grams, converge). A zero row and
column is a decoupled 1 x 1 block with eigenvalue 0 and eigenvector e_i;
giving each such block its own negative eigenvalue, below the rest of the
spectrum, leaves every other eigenpair exactly as it was and removes the
exactly-degenerate null space that zheevd trips on. The shifted pairs come
last, are reported with eigenvalue 0, and give theta e_i = 0, so svd_trunc
drops them as before. The route is chosen by the arguments alone: there is
no retry with another solver.
"""

from __future__ import annotations

import contextlib

import torch

from . import eigh_kernels

EIGH_MODES = ("kernels", "native")
_default_eigh = "kernels"


def default_eigh() -> str:
    return _default_eigh


@contextlib.contextmanager
def verification_eigh():
    """Select eigh="native" for every svd_trunc that does not name one."""
    global _default_eigh
    prev = _default_eigh
    _default_eigh = "native"
    try:
        yield
    finally:
        _default_eigh = prev


def eigh_top(h: torch.Tensor, keep: int, eigh: str = None):
    """Top-`keep` eigenpairs of Hermitian h: (w (keep,) descending,
    V (m, keep) eigenvector columns); h may carry leading batch dimensions
    (one, under "kernels")."""
    eigh = eigh or _default_eigh
    if eigh == "kernels":
        return eigh_kernels.eigh_top_kernels(h, keep)
    if eigh == "native":
        # in complex128: the single-precision LAPACK driver fails to
        # converge on Grams with a large exactly-degenerate null space
        h64 = h.to(torch.complex128)
        w, v = torch.linalg.eigh(split_zero_rows(h64))  # ascending
        # the split-off pairs (each below -max|h| / 2) back at eigenvalue 0
        w = torch.where(w < -0.5 * _split_scale(h64), torch.zeros_like(w), w)
        return (w.flip(-1)[..., :keep].to(h.real.dtype),
                v.flip(-1)[..., :keep].to(h.dtype))
    raise ValueError(f"eigh must be one of {EIGH_MODES}, got {eigh!r}")


def _split_scale(h: torch.Tensor) -> torch.Tensor:
    """max |h| of each matrix (1 for a zero matrix), shape (..., 1)."""
    scale = h.abs().amax(dim=(-2, -1)).unsqueeze(-1)
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def split_zero_rows(h: torch.Tensor) -> torch.Tensor:
    """h with diagonal entry i set to -(1 + i) max|h| wherever row i is
    exactly zero. h is a Gram, Hermitian positive semidefinite, so a zero
    row is a zero column, and the new eigenvalues lie apart from each other
    and below the rest, which do not change. No read-back: the same
    launches whatever the data."""
    m = h.shape[-1]
    zero = (h == 0).all(dim=-1)
    ramp = -(1.0 + torch.arange(m, device=h.device, dtype=h.real.dtype))
    diag = torch.where(zero, ramp * _split_scale(h), torch.zeros_like(ramp))
    return h + torch.diag_embed(diag.to(h.dtype))


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b. For a batch on the CPU the product is taken matrix by matrix:
    the CPU's batched product rounds differently from its single product,
    and a batch of probe states must reproduce separate calls bit for bit
    there (the tests hold it to that). On a CUDA device it is one batched
    product."""
    if a.dim() > 2 and a.device.type == "cpu":
        return torch.stack([x @ y for x, y in zip(a, b)])
    return a @ b


def svd_trunc(theta: torch.Tensor, chi_keep: int, threshold: float,
              eigh: str = None):
    """Truncated SVD of complex theta (m, n): top chi_keep singular values.

    Returns (U (m, chi_keep), s (chi_keep,), Vh (chi_keep, n)), singular
    values descending; values at or below `threshold` are zeroed (Aer's
    matrix_product_state_truncation_threshold semantics).

    The singular values are the column norms ||theta v_i|| rather than the
    square roots of the Gram eigenvalues: on rank-deficient input the Gram's
    noise eigenvalues can be arbitrarily small while v_i still overlaps the
    true support, and dividing by their square root manufactures huge U
    columns. Columns below 8 eps max(s) are unresolvable Gram-noise
    directions and are zeroed even when threshold == 0.

    theta may carry a leading batch dimension (P, m, n): the probe states of
    one gate of the full-cost sweep. Every matrix is truncated on its own
    (its own noise floor and keep mask), through one eigensolver call."""
    eigh = eigh or _default_eigh
    # the native route forms the Gram in complex128, as it solves it
    t = theta.to(torch.complex128) if eigh == "native" else theta
    h = _matmul(t.mH, t)
    _, v = eigh_top(h, chi_keep, eigh)
    v = v.to(theta.dtype)
    u = _matmul(theta, v)  # columns theta v_i, of norm s_i
    s = torch.sqrt((u.real * u.real + u.imag * u.imag).sum(dim=-2))
    floor = 8.0 * torch.finfo(s.dtype).eps * s.max(dim=-1,
                                                   keepdim=True).values
    keep = (s > threshold) & (s > floor)
    s_k = torch.where(keep, s, torch.zeros_like(s))
    inv_s = torch.where(keep, 1.0 / torch.clamp(s, min=1e-30),
                        torch.zeros_like(s))
    u = u * inv_s[..., None, :]
    vh = v.mH * keep[..., :, None]
    return u, s_k, vh
