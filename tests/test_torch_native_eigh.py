"""The native verifier's eigensolver route: cplx.eigh_top under
eigh="native" splits the exactly zero rows and columns off a Gram
(cplx.split_zero_rows) and solves the rest with torch.linalg.eigh in
complex128, so that cuSOLVER meets no exactly-degenerate null space on the
padded Grams of a deep re-simulation. Held here against numpy float64 eigh
on padded and turned Grams, and svd_trunc under verification_eigh() against
the JAX package's svd_trunc on its `embed` path (x64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptaqc_tpu.ops import cplx as jcplx

from adaptaqc_tpu_torch.ops import cplx

torch.set_num_threads(1)

TOL = 1e-10  # kept-subspace projector, eigenvalues / scale


def _theta(m, rank, seed, turned):
    """(m, m) complex128 theta with `rank` nonzero columns at random places
    (a padded bond: the Gram's other rows and columns exactly zero), or that
    theta times a random unitary (the same spectrum, no zero rows)."""
    rng = np.random.default_rng(seed)
    th = np.zeros((m, m), complex)
    cols = rng.choice(m, rank, replace=False)
    th[:, cols] = (rng.standard_normal((m, rank))
                   + 1j * rng.standard_normal((m, rank)))
    th /= np.linalg.norm(th)
    if turned:
        g = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
        q, _ = np.linalg.qr(g)
        th = th @ q
    return th


@pytest.mark.parametrize("turned", [False, True], ids=["padded", "turned"])
def test_native_route_on_a_padded_gram_matches_numpy(turned):
    """m = 256, rank 8: the top 8 eigenvalues and the projector on their
    eigenvectors against numpy float64 eigh within 1e-10; the next 8
    columns orthonormal and in the null space, reported at eigenvalue 0 (a
    split-off row's pair: exactly 0)."""
    m, rank, keep = 256, 8, 16
    th = _theta(m, rank, seed=256, turned=turned)
    h = th.conj().T @ th
    hz = torch.tensor(h)
    assert bool((hz == 0).all(-1).any()) is not turned
    w, v = cplx.eigh_top(hz, keep, "native")
    wn, vn = np.linalg.eigh(h)
    wn, vn = wn[::-1][:rank], vn[:, ::-1][:, :rank]
    scale = wn.max()
    w, v = w.numpy(), v.numpy()
    assert np.abs(w[:rank] - wn).max() / scale < TOL
    proj = v[:, :rank] @ v[:, :rank].conj().T
    assert np.abs(proj - vn @ vn.conj().T).max() < TOL
    assert np.abs(v.conj().T @ v - np.eye(keep)).max() < TOL
    assert np.abs(h @ v[:, rank:]).max() / scale < TOL
    if turned:
        assert np.abs(w[rank:]).max() / scale < TOL
    else:
        assert (w[rank:] == 0).all()


def test_split_zero_rows_leaves_the_rest_and_takes_batches():
    """The split matrix differs from h only on the zero rows' diagonal,
    each set to its own value below -max|h|/2; a zero matrix takes -1, -2,
    ...; a batch splits each matrix by its own scale."""
    th = _theta(32, 4, seed=3, turned=False)
    h = torch.tensor(th.conj().T @ th)
    s = cplx.split_zero_rows(h)
    zero = (h == 0).all(-1)
    off = ~torch.eye(32, dtype=torch.bool)
    assert torch.equal(s[off], h[off])
    assert torch.equal(s.diagonal()[~zero], h.diagonal()[~zero])
    d = s.diagonal()[zero].real
    assert len(set(d.tolist())) == int(zero.sum())
    assert bool((d < -0.5 * h.abs().max()).all())
    z = torch.zeros((2, 3, 3), dtype=torch.complex128)
    z[1] = h[:3, :3] * 0 + torch.eye(3) * 4.0
    sb = cplx.split_zero_rows(z)
    assert torch.equal(sb[0].diagonal().real,
                       torch.tensor([-1.0, -2.0, -3.0], dtype=torch.float64))
    assert torch.equal(sb[1], z[1])
    w, _ = cplx.eigh_top(z[0], 2, "native")
    assert torch.equal(w, torch.zeros(2, dtype=torch.float64))


@pytest.mark.parametrize("case", ["padded", "turned", "random"])
def test_verification_svd_trunc_matches_jax_embed(case):
    """svd_trunc under verification_eigh() (the native route) against the
    JAX package's svd_trunc (its `embed` eigh on the CPU), x64, on the same
    numpy theta: kept singular values and U S Vh within 1e-10."""
    m, keep = 64, 32
    if case == "random":
        rng = np.random.default_rng(64)
        th = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
        th /= np.linalg.norm(th)
    else:
        th = _theta(m, 8, seed=64, turned=case == "turned")
    ju, js, jvh = jcplx.svd_trunc(jcplx.C(jnp.asarray(th.real, jnp.float64),
                                          jnp.asarray(th.imag, jnp.float64)),
                                  keep, 1e-12)
    rec_j = (jcplx.to_np(ju) * np.asarray(js)) @ jcplx.to_np(jvh)
    with cplx.verification_eigh():
        tu, ts, tvh = cplx.svd_trunc(torch.tensor(th), keep, 1e-12)
    assert tu.dtype == torch.complex128
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=TOL)
    rec_t = (tu.numpy() * ts.numpy()) @ tvh.numpy()
    np.testing.assert_allclose(rec_t, rec_j, atol=TOL)
