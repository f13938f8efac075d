"""The port's eigensolver kernels (plain versions, CPU) against the JAX
package's Pallas kernels in interpret mode and against numpy float64 eigh,
on the Gram-spectrum cases of test_eigh_tridiag.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptaqc_tpu.ops import cplx as jcplx
from adaptaqc_tpu.ops import pallas_eigh

from adaptaqc_tpu_torch.ops import eigh_kernels as ek

torch.set_num_threads(1)


def _case(name, n, seed=7):
    rng = np.random.default_rng(seed)
    if name == "rand":
        a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        return a.conj().T @ a
    if name == "spec7":
        a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        u, _, vh = np.linalg.svd(a)
        th = (u * np.logspace(0, -7, n)) @ vh
        return th.conj().T @ th
    if name == "flat":
        return np.eye(n, dtype=complex)
    if name == "lowrank":
        a = rng.standard_normal((n, 4)) + 1j * rng.standard_normal((n, 4))
        return a @ a.conj().T
    if name == "decoupled":  # an exact zero bond splits T into blocks
        a = rng.standard_normal((n, n))
        h = a.T @ a
        h[: n // 2, n // 2:] = 0.0
        h[n // 2:, : n // 2] = 0.0
        return h.astype(complex)
    raise ValueError(name)


def _hermitized_f32(h):
    hre = np.asarray(h.real, np.float32)
    him = np.asarray(h.imag, np.float32)
    return (hre + hre.T) * np.float32(0.5), (him - him.T) * np.float32(0.5)


@pytest.mark.parametrize("n", [8, 16])
def test_tridiag_plain_matches_pallas_interpret(n):
    """d, e and tau within 1e-5 of the Pallas kernel (same reflector
    conventions), and Q T Q^H reconstructs H."""
    h = _case("rand", n, seed=1)
    hre, him = _hermitized_f32(h)
    _, _, _, _, packed = pallas_eigh._tridiag_call(
        jnp.asarray(hre, jnp.float32), jnp.asarray(him, jnp.float32), True)
    packed = np.asarray(packed)
    ht = torch.tensor(hre + 1j * him, dtype=torch.complex64)
    vrows, tau, d, e = ek.tridiag(ht)
    scale = np.abs(packed[3]).max()
    assert np.abs(d.numpy() - packed[3]).max() / scale < 1e-5
    assert np.abs(e.numpy()[: n - 1] - packed[2, : n - 1]).max() / scale < 1e-5
    tau_j = (packed[0] + 1j * packed[1])[: n - 1]
    tau_err = np.abs(tau.numpy()[: n - 1] - tau_j) / np.abs(tau_j).max()
    assert tau_err.max() < 1e-5
    # reconstruction in float64 from the float32 factors
    q = ek.backtransform_plain(vrows.to(torch.complex128),
                               tau.to(torch.complex128),
                               torch.eye(n, dtype=torch.float64), n).numpy()
    t = (np.diag(d.numpy().astype(float))
         + np.diag(e.numpy()[: n - 1].astype(float), 1)
         + np.diag(e.numpy()[: n - 1].astype(float), -1))
    assert np.abs(q @ q.conj().T - np.eye(n)).max() < 1e-5
    hh = hre + 1j * him
    assert np.abs(q @ t @ q.conj().T - hh).max() / np.abs(hh).max() < 1e-5


def _padded_gram(m, r, seed):
    """The Gram theta^H theta of a rank-r theta (m x m, m = 2 chi) with the
    zero pattern of mps_core's two-qubit apply: a column (q, b) of theta is
    zero where the right-bond index b >= r, for both physical indices q."""
    rng = np.random.default_rng(seed)
    chi = m // 2
    x = rng.standard_normal((m, r)) + 1j * rng.standard_normal((m, r))
    y = (rng.standard_normal((r, 2, chi))
         + 1j * rng.standard_normal((r, 2, chi)))
    y[:, :, r:] = 0.0
    th = x @ y.reshape(r, m)
    th = th / np.linalg.norm(th)
    return th.conj().T @ th


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("m", [16, 32])
def test_tridiag_plain_skips_inactive_steps_as_pallas(m, r):
    """On a padded Gram, wherever the Pallas kernel's e_k and tau_k are 0
    (the column below the diagonal is exactly zero), the port's are exactly
    0 and vrows[k] is e_{k+1}: the step is an exact no-op. d and e agree to
    1e-5 of the scale everywhere; tau where the step's column is above the
    rounding noise of the rank-deficient trailing block (a reflector built
    from residue is arbitrary in both)."""
    hre, him = _hermitized_f32(_padded_gram(m, r, seed=m + r))
    _, _, _, _, packed = pallas_eigh._tridiag_call(
        jnp.asarray(hre, jnp.float32), jnp.asarray(him, jnp.float32), True)
    packed = np.asarray(packed)
    vrows, tau, d, e = ek.tridiag(torch.tensor(hre + 1j * him,
                                               dtype=torch.complex64))
    e_j = packed[2, : m - 1]
    tau_j = (packed[0] + 1j * packed[1])[: m - 1]
    inactive = np.nonzero((e_j == 0) & (tau_j == 0))[0]
    assert len(inactive) >= m // 2 - r  # every step past the bond's support
    eye = torch.eye(m, dtype=torch.complex64)
    for k in inactive:
        assert e[k] == 0 and tau[k] == 0
        assert torch.equal(vrows[k], eye[k + 1])
    scale = np.abs(packed[3]).max()
    assert np.abs(d.numpy() - packed[3]).max() / scale < 1e-5
    assert np.abs(e.numpy()[: m - 1] - e_j).max() / scale < 1e-5
    data = np.abs(e_j) > 1e-3 * scale
    assert data.sum() >= 1
    assert np.abs(tau.numpy()[: m - 1] - tau_j)[data].max() < 1e-5


@pytest.mark.parametrize("scale", [1e-20, 1e-21])
def test_tridiag_plain_reflectors_stay_unitary_on_tiny_columns(scale):
    """Columns whose sum of squares underflows into subnormals (the
    residue of a rank-deficient Gram decays there) still give unitary
    reflectors and Q T Q^H = H: the norm is taken scaled below tiny/eps."""
    n = 16
    h = torch.tensor(_case("rand", n, seed=5) * scale, dtype=torch.complex64)
    h = (h + h.mH) * 0.5
    vrows, tau, d, e = ek.tridiag(h)
    q = ek.backtransform_plain(vrows.to(torch.complex128),
                               tau.to(torch.complex128),
                               torch.eye(n, dtype=torch.float64), n)
    assert float((q @ q.mH - torch.eye(n)).abs().max()) < 1e-5
    t = (torch.diag(d.double()) + torch.diag(e[:-1].double(), 1)
         + torch.diag(e[:-1].double(), -1)).to(q.dtype)
    h64 = h.to(torch.complex128)
    assert float((q @ t @ q.mH - h64).abs().max() / h64.abs().max()) < 1e-5


def _backtransform_panels(vrows, tau, z, keep, nb=16):
    """The panel order of the backtransform kernel, in torch: the reflectors
    with tau != 0 (an inactive one is the identity), in order, grouped into
    compact-WY panels of nb, P = H_a ... H_b = I - V T V^H with
    T[i, i] = tau_i, T[:i, i] = -tau_i T[:i, :i] (V[:, :i]^H v_i); panels
    applied last first: Y = V^H Z, W = T Y, Z -= V W."""
    m = vrows.shape[0]
    active = [k for k in range(m - 1) if tau[k] != 0]
    out = z[:, :keep].to(vrows.dtype).clone()
    panels = [active[i:i + nb] for i in range(0, len(active), nb)]
    for idx in reversed(panels):
        v = vrows[idx].T  # (m, pn)
        g = v.conj().T @ v
        pn = len(idx)
        t = torch.zeros((pn, pn), dtype=vrows.dtype)
        for i in range(pn):
            t[i, i] = tau[idx[i]]
            t[:i, i] = -tau[idx[i]] * (t[:i, :i] @ g[:i, i])
        out = out - v @ (t @ (v.conj().T @ out))
    return out


def _bt_inputs(m, dtype, seed):
    """Reflectors of a padded Gram's tridiagonalization (a run of inactive
    steps at the end), with a further run of 16 zeroed, and orthonormal z."""
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    h = torch.tensor(_padded_gram(m, max(1, m // 8), seed), dtype=dtype)
    vrows, tau, _, _ = ek.tridiag_plain((h + h.mH) * 0.5)
    if m >= 32:  # an all-inactive panel in the middle of active ones
        tau = tau.clone()
        tau[2:18] = 0
    rng = np.random.default_rng(seed)
    z = np.linalg.qr(rng.standard_normal((m, m)))[0]
    return vrows, tau, torch.tensor(z, dtype=rdt)


@pytest.mark.parametrize("dtype,tol", [(torch.complex64, 1e-5),
                                       (torch.complex128, 1e-12)])
@pytest.mark.parametrize("keep", ["one", "half", "all"])
@pytest.mark.parametrize("m", [8, 16, 64])
def test_backtransform_panel_order_matches_plain(m, keep, dtype, tol):
    """Compact-WY panels of 16 over the active reflectors give
    backtransform_plain's Q z[:, :keep]: 1e-5 in complex64, 1e-12 in
    complex128."""
    vrows, tau, z = _bt_inputs(m, dtype, seed=m)
    assert int((tau[: m - 1] == 0).sum()) >= 1
    kp = {"one": 1, "half": m // 2, "all": m}[keep]
    ref = ek.backtransform_plain(vrows, tau, z, kp)
    out = _backtransform_panels(vrows, tau, z, kp)
    assert out.shape == (m, kp)
    assert float((out - ref).abs().max()) < tol


@pytest.mark.parametrize("case", ["rand", "spec7", "flat", "lowrank",
                                  "decoupled"])
@pytest.mark.parametrize("n", [4, 16, 32])
def test_teig_chain_matches_pallas_and_numpy(case, n):
    """The whole chain (tridiag -> teig -> backtransform) against the JAX
    teig chain in interpret mode and against numpy float64 eigh, at the
    bounds of test_eigh_tridiag.py: eigenvalues 2e-5 scale,
    orthonormality 2e-4, residuals 2e-4."""
    h = _case(case, n)
    hre, him = _hermitized_f32(h)
    hc = jcplx.C(jnp.asarray(hre, jnp.float32), jnp.asarray(him, jnp.float32))
    keep = n // 2
    hh = hre.astype(float) + 1j * him.astype(float)
    wx = np.linalg.eigh(hh)[0][::-1]
    scale = max(1e-30, np.abs(wx).max())
    w, v = ek.eigh_top_kernels(torch.tensor(hre + 1j * him,
                                            dtype=torch.complex64), keep)
    w = w.numpy()
    V = v.numpy().T  # rows = eigenvectors, as in the JAX contract
    assert np.abs(w - wx[:keep]).max() / scale < 2e-5
    assert np.abs(V.conj() @ V.T - np.eye(keep)).max() < 2e-4
    for i in range(min(4, keep)):
        assert np.linalg.norm(hh @ V[i] - w[i] * V[i]) / scale < 2e-4
    if n >= 8:  # the Pallas kernels need 8 | n
        w_p, _ = pallas_eigh.eigh_top_pallas_teig(hc, keep, interpret=True)
        assert np.abs(w - np.asarray(w_p)).max() / scale < 2e-5


def test_teig_plain_matches_pallas_teig_kernel():
    """teig_plain on the Pallas tridiagonalisation's (d, e): the same
    eigenvalues as the Pallas teig kernel, and the same eigenvectors up to
    sign (its b0 is the same array)."""
    n = 16
    h = _case("rand", n, seed=3)
    hre, him = _hermitized_f32(h)
    _, _, _, _, packed = pallas_eigh._tridiag_call(
        jnp.asarray(hre, jnp.float32), jnp.asarray(him, jnp.float32), True)
    wp, zp = pallas_eigh._teig_call(packed, pallas_eigh._teig_b0(n), True)
    packed = np.asarray(packed)
    d = torch.tensor(packed[3])
    e = torch.tensor(packed[2])
    w, z = ek.teig(d, e)
    scale = np.abs(packed[3]).max() + np.abs(packed[2]).max()
    assert np.abs(w.numpy() - np.asarray(wp)[0]).max() / scale < 1e-6
    overlap = np.abs(np.sum(z.numpy() * np.asarray(zp), axis=0))
    assert np.abs(overlap - 1.0).max() < 1e-4


def test_teig_float64_constants():
    """complex128 runs 60 bisection rounds at eps 2.3e-16: eigenvalues to
    1e-12 of numpy, orthonormal columns to 1e-12."""
    h = _case("spec7", 16)
    w, v = ek.eigh_top_kernels(torch.tensor(h, dtype=torch.complex128), 8)
    wx = np.linalg.eigh(h)[0][::-1][:8]
    assert np.abs(w.numpy() - wx).max() / np.abs(wx).max() < 1e-12
    V = v.numpy()
    assert np.abs(V.conj().T @ V - np.eye(8)).max() < 1e-12


def test_wrappers_take_plain_path_only_on_cpu():
    """A CPU tensor runs the plain version and counts no launch."""
    before = (ek.tridiag.launches, ek.teig.launches,
              ek.backtransform.launches)
    ek.eigh_top_kernels(torch.eye(4, dtype=torch.complex64), 2)
    assert (ek.tridiag.launches, ek.teig.launches,
            ek.backtransform.launches) == before


def _meta_calls():
    from adaptaqc_tpu_torch.ops import env_kernel
    meta = torch.device("meta")
    c = torch.empty((8, 8), dtype=torch.complex64, device=meta)
    r = torch.empty(8, dtype=torch.float32, device=meta)
    return {
        "env_chain": lambda: env_kernel.env_chain(
            torch.empty((4, 2, 4, 4), dtype=torch.complex64, device=meta),
            torch.empty((4, 2, 4, 4), dtype=torch.complex64, device=meta), 1),
        "tridiag": lambda: ek.tridiag(c),
        "teig": lambda: ek.teig(r, r),
        "backtransform": lambda: ek.backtransform(
            c, torch.empty(8, dtype=torch.complex64, device=meta),
            torch.empty((8, 8), dtype=torch.float32, device=meta), 4),
    }


@pytest.mark.parametrize("kernel", ["env_chain", "tridiag", "teig",
                                    "backtransform"])
def test_wrapper_never_falls_back_off_cpu(kernel):
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel path, which refuses a non-CUDA tensor before building
    anything."""
    from adaptaqc_tpu_torch.ops import cuda_lib
    with pytest.raises(ValueError, match="CUDA tensor"):
        _meta_calls()[kernel]()
    assert cuda_lib._lib is None
