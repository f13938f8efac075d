"""chip_smoke.py's arithmetic, checked on the CPU: the least time the card
could take for each kernel's work (its bound) against hand counts at the
main path's shapes, the library call that stands beside K4 (torch.ormqr
of the reflectors in geqrf layout computes the back-transform), the
eigenvector measures that the teig check uses, the probe sites of the
sweep workload, and the wide K1's floor on its cluster."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from adaptaqc_tpu_torch.circuits.circuit import Circuit  # noqa: E402
from adaptaqc_tpu_torch.circuits.tape import compile_tape  # noqa: E402
from adaptaqc_tpu_torch.ops import eigh_kernels as ek  # noqa: E402

FLOPS = 67e12   # H100 SXM fp32 outside the tensor cores, FLOP/s
BYTES = 3.35e12  # H100 SXM device memory, bytes/s

# hand counts: (kernel, shape, flops, bytes)
CASES = [
    # 49 chain steps and the combine of 32 chi^3 flops each, four chi^2
    # dots of 32 chi^2; both (50, 2, 64, 64) complex64 stacks read once
    ("env_chain", dict(n=50, chi=64),
     32 * 64 ** 3 * 50 + 32 * 64 ** 2, 2 * 50 * 2 * 64 * 64 * 8 + 32),
    ("env_chain", dict(n=50, chi=32),
     32 * 32 ** 3 * 50 + 32 * 32 ** 2, 2 * 50 * 2 * 32 * 32 * 8 + 32),
    # zhetrd: 16/3 m^3; h in, v (m x m complex), tau, d, e out
    ("tridiag", dict(m=128), 16 * 128 ** 3 / 3,
     2 * 128 * 128 * 8 + 128 * 8 + 2 * 128 * 4),
    # 30 x 3 m^2 bisection, 6 m^2 LU, 24 m^2 inverse iteration, 4 m^3 CGS2
    ("teig", dict(m=128), 120 * 128 ** 2 + 4 * 128 ** 3,
     2 * 128 * 4 + 2 * 128 * 128 * 4 + 128 * 4),
    # 8 m^2 keep; v, tau, keep columns of z in, (m, keep) complex out
    ("backtransform", dict(m=128, keep=64), 8 * 128 ** 2 * 64,
     128 * 128 * 8 + 128 * 8 + 128 * 64 * 4 + 128 * 64 * 8),
    ("backtransform", dict(m=64, keep=32), 8 * 64 ** 2 * 32,
     64 * 64 * 8 + 64 * 8 + 64 * 32 * 4 + 64 * 32 * 8),
]


@pytest.mark.parametrize("name,shape,flops,nbytes", CASES,
                         ids=[f"{c[0]}-{'-'.join(map(str, c[1].values()))}"
                              for c in CASES])
def test_kernel_bound_matches_hand_counts(name, shape, flops, nbytes):
    ms, by, f, b = chip_smoke.kernel_bound(name, **shape)
    assert f == pytest.approx(flops, rel=1e-12)
    assert b == nbytes
    t_ops, t_bytes = flops / FLOPS * 1e3, nbytes / BYTES * 1e3
    assert ms == pytest.approx(max(t_ops, t_bytes), rel=1e-12)
    assert by == ("operations" if t_ops >= t_bytes else "bytes")


@pytest.mark.parametrize("name,shape,flops", [
    # active steps k = 0, 3 of m = 8: trailing blocks of 7 and 4
    ("tridiag", dict(m=8), 16 * 7 ** 2 + 16 * 4 ** 2),
    ("backtransform", dict(m=8, keep=4), 16 * 7 * 4 + 16 * 4 * 4),
])
def test_kernel_bound_counts_only_the_active_steps(name, shape, flops):
    """Where the data leaves steps out (tau = 0), the bound counts the
    work of the active ones; the bytes are unchanged."""
    _, _, f, b = chip_smoke.kernel_bound(name, active=[0, 3], **shape)
    assert f == flops
    assert b == chip_smoke.kernel_bound(name, **shape)[3]
    assert chip_smoke.kernel_bound(name, active=[], **shape)[1] == "bytes"


def _factors(e, tau):
    return (torch.tensor(e + [0.0]),
            torch.tensor([complex(t) for t in tau] + [0j],
                         dtype=torch.complex64))


@pytest.mark.parametrize("kernel,plain,ok", [
    # the kernel finds every plain-inactive step and one more
    (([0.0, 1.0, 0.0], [0, 1, 0]), ([0.0, 1.0, 2.0], [0, 1, 1]), True),
    # a plain-inactive step active in the kernel
    (([1.0, 1.0, 0.0], [1, 1, 0]), ([0.0, 1.0, 0.0], [0, 1, 0]), False),
    # e and tau zeros at different steps
    (([0.0, 1.0, 1.0], [1, 1, 1]), ([1.0, 1.0, 1.0], [1, 1, 1]), False),
])
def test_zeros_equal_holds_the_kernels_inactive_steps(kernel, plain, ok):
    e, tau = _factors(*kernel)
    ep, taup = _factors(*plain)
    if ok:
        assert chip_smoke.zeros_equal(e, tau, ep, taup, "case") == 2
    else:
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.zeros_equal(e, tau, ep, taup, "case")


def test_env_chain_bound_at_the_sweep_shape():
    """n = 50, chi = 64: about 419 MFLOP, about 6.3 us at the fp32 peak,
    bound by operations (the 6.55 MB of sites alone take about 2 us)."""
    ms, by, flops, nbytes = chip_smoke.kernel_bound("env_chain", n=50, chi=64)
    assert 419e6 < flops < 420e6 and by == "operations"
    assert 0.0062 < ms < 0.0063 and 6.5e6 < nbytes < 6.6e6


def _hermitian(m, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, m)) + 1j * rng.normal(size=(m, m))
    h = a.conj().T @ a
    return torch.tensor((h + h.conj().T) / 2, dtype=torch.complex64)


@pytest.mark.parametrize("m,keep", [(8, 4), (16, 16)])
def test_ormqr_computes_the_backtransform(m, keep):
    """K4's library call: torch.ormqr on the reflectors laid out as geqrf
    leaves them gives rows 1.. of Q z[:, :keep]; row 0 is z's."""
    vrows, tau, d, e = ek.tridiag_plain(_hermitian(m, m))
    _, z = ek.teig_plain(d, e)
    a, t, other = chip_smoke.ormqr_inputs(torch, vrows, tau, z, keep)
    out = ek.backtransform_plain(vrows, tau, z, keep)
    np.testing.assert_allclose(torch.ormqr(a, t, other).numpy(),
                               out[1:].numpy(), atol=1e-5)
    np.testing.assert_allclose(out[0].numpy(), z[0, :keep].numpy(),
                               atol=1e-6)


def test_teig_vector_measures():
    """On a spectrum with a degenerate pair the plain eigenvectors score
    zero against themselves; a rotation inside the pair moves z but not
    the pair's projector, and both stay orthonormal eigenvectors."""
    d = torch.tensor([3.0, 1.0, 1.0, -2.0, 0.5, 0.5, 0.5, 4.0])
    e = torch.zeros(8)
    w, z = ek.teig_plain(d, e)
    out = chip_smoke.teig_vector_errors(d, e, w, z, z)
    assert out["z"] == 0.0
    assert out["ortho"] < 1e-6 and out["resid"] < 1e-6
    assert out["cluster"] < 1e-6
    c, s = np.cos(0.7), np.sin(0.7)
    rot = z.clone()
    pair = [i for i in range(8) if abs(float(w[i]) - 1.0) < 1e-6]
    assert len(pair) == 2
    i, j = pair
    rot[:, i], rot[:, j] = c * z[:, i] - s * z[:, j], s * z[:, i] + c * z[:, j]
    moved = chip_smoke.teig_vector_errors(d, e, w, rot, z)
    assert moved["z"] > 0.1
    assert moved["ortho"] < 1e-6 and moved["resid"] < 1e-6
    assert moved["cluster"] < 1e-6


def test_sweep_probe_sites():
    """bench.py's window of 12 dressed-CNOT layers: 48 probes, each on a
    site of the 50-qubit chain, as many as the tape has trainable
    entries."""
    from adaptaqc_tpu_torch.workloads.bench_sweep import bench_workload
    sites = chip_smoke.sweep_probe_sites(Circuit, compile_tape)
    _, ansatz = bench_workload(50, 12)
    assert len(sites) == 48 == int(np.sum(compile_tape(ansatz).trainable))
    assert all(0 <= q < 50 for q in sites)


def test_teig_bound_counts_the_double_rounds():
    """complex128 (the double instantiation): 60 bisection rounds, twice
    the bytes, operations at the fp64 peak."""
    m = 64
    ms, by, f, b = chip_smoke.kernel_bound("teig", m=m, f64=True)
    assert f == 60 * 3 * m ** 2 + 30 * m ** 2 + 4 * m ** 3
    assert b == 2 * chip_smoke.kernel_bound("teig", m=m)[3]
    t_ops = f / (chip_smoke.FP64_TFLOPS * 1e12) * 1e3
    assert ms == pytest.approx(max(t_ops, b / BYTES * 1e3), rel=1e-12)
    assert by == "operations"


@pytest.mark.parametrize("chi,q,sites", [(128, 25, 26), (96, 0, 50),
                                         (65, 49, 50)])
def test_wide_k1_cluster_floor(chi, q, sites):
    """The wide K1's floor on one chain's cluster of 16 SMs: the longer
    chain's max(q, n-1-q) dependent sites and the combine, 32 chi^3 flops
    each, at 16/132 of the fp32 peak (0.2148 ms at chi = 128, q = 25)."""
    ms, how = chip_smoke.cluster_floor(50, chi, q, 16)
    assert ms == pytest.approx(sites * 32 * chi ** 3
                               / (FLOPS * 16 / 132) * 1e3, rel=1e-12)
    assert how.startswith(f"{sites} dependent sites")
    if (chi, q) == (128, 25):
        assert ms == pytest.approx(0.2148, abs=1e-4)
    # the whole card's bound is the lower: the floor counts one cluster
    assert chip_smoke.kernel_bound("env_chain", n=50, chi=chi)[0] < ms
