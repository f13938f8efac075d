"""The eigensolver chain (tridiag -> teig -> backtransform) above m = 128,
where the card runs the wide variants of K2-K4: the plain versions (CPU)
against numpy float64 eigh on graded Grams. The Pallas kernels in interpret
mode are held at m <= 128 in test_torch_eigh_kernels.py (interpret mode at
m = 256 is too slow for these tests)."""

import numpy as np
import pytest
import torch

from adaptaqc_tpu_torch.ops import dispatch, eigh_kernels as ek

torch.set_num_threads(1)


def _graded(m, decades, seed=7):
    """theta^H theta for theta with singular values over `decades`."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
    u, _, vh = np.linalg.svd(a)
    th = (u * np.logspace(0, -decades, m)) @ vh
    h = th.conj().T @ th
    hre = np.asarray(h.real, np.float32)
    him = np.asarray(h.imag, np.float32)
    return (hre + hre.T) * np.float32(0.5), (him - him.T) * np.float32(0.5)


@pytest.mark.parametrize("m,decades", [(192, 3), (256, 7)])
def test_plain_chain_above_128_matches_numpy_f64(m, decades):
    """Eigenvalues 2e-5 of the scale, orthonormality 2e-4 and residuals
    2e-4 of the scale, over all m/2 kept pairs."""
    hre, him = _graded(m, decades)
    keep = m // 2
    hh = hre.astype(float) + 1j * him.astype(float)
    wx = np.linalg.eigh(hh)[0][::-1]
    scale = np.abs(wx).max()
    w, v = ek.eigh_top_kernels(
        torch.tensor(hre + 1j * him, dtype=torch.complex64), keep)
    w = w.numpy().astype(float)
    V = v.numpy().T.astype(complex)  # rows = eigenvectors
    assert np.abs(w - wx[:keep]).max() / scale < 2e-5
    assert np.abs(V.conj() @ V.T - np.eye(keep)).max() < 2e-4
    resid = np.linalg.norm(hh @ V.T - V.T * w, axis=0) / scale
    assert resid.max() < 2e-4


def test_plain_chain_batch_at_256_equals_single_calls():
    """A batch of two m = 256 Grams gives what each gives alone, bit for
    bit (the card's batched wide launches are held to the same)."""
    hs = [torch.tensor(re + 1j * im, dtype=torch.complex64)
          for re, im in (_graded(256, 3, seed=1), _graded(256, 5, seed=2))]
    wb, vb = ek.eigh_top_kernels(torch.stack(hs), 16)
    for i, h in enumerate(hs):
        w, v = ek.eigh_top_kernels(h, 16)
        assert torch.equal(wb[i], w) and torch.equal(vb[i], v)


def test_the_wide_range_is_the_kernels_route_on_the_card():
    """m in (128, 560] launches the kernels (their wide variants), as far
    as the JAX kernels reach (pallas_eigh.supported: 10 m^2 4 B <= 12 MiB),
    and so does m in (560, 16384], where the reference runs XLA's eigh and
    the wide variants keep what no longer fits on chip in global memory;
    past 16384 the call raises. complex128 has the same range."""
    for dt in (torch.complex64, torch.complex128):
        for m in (130, 192, 256, 512, 560, 568, 768, 1024, 1025, 1536, 2048,
                  2049, 4096, 4097, 8192, 8193, 8576, 16384):
            assert m > ek.NARROW_MAX_M
            assert dispatch.use_kernel("eigh", "cuda", dt, m)
        with pytest.raises(ValueError):
            dispatch.use_kernel("eigh", "cuda", dt, 16385)
    assert 10 * 560 ** 2 * 4 <= 12 * 2 ** 20 < 10 * 568 ** 2 * 4
    assert ek.REACH_M[False] == 560
