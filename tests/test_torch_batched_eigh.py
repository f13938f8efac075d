"""The batched forms of the eigensolver kernels' plain versions, of
svd_trunc and of the MPS engine's gate application, on the CPU: each matrix
of a batch must equal the unbatched call on it exactly (bit for bit), in
complex64 and in complex128, and a batched apply must equal separate
applies to rounding (its einsums are batched products, which round in
another order: 1e-4 in complex64, 1e-10 in complex128). (The CUDA kernels' batched launches are held to the same, and
against these plain versions, by chip_smoke.py on the card.) Also the JAX
package's vmapped kernels in interpret mode against the port's batched plain
versions, float32, at the tolerances of tests/test_torch_eigh_kernels.py."""

import numpy as np
import pytest
import torch

from adaptaqc_tpu_torch.backends import mps_core, sv_core
from adaptaqc_tpu_torch.circuits.circuit import Circuit
from adaptaqc_tpu_torch.circuits.tape import compile_tape
from adaptaqc_tpu_torch.ops import cplx
from adaptaqc_tpu_torch.ops import eigh_kernels as ek

torch.set_num_threads(1)
DTYPES = [torch.complex64, torch.complex128]


def _grams(m, p, dtype, seed=0):
    """P Hermitian Grams of normalised thetas: full rank, rank 3, and
    copies of the first perturbed at 1e-3 (the probe states of one gate
    give Grams that are close but not equal)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(p):
        if i == 1:
            a = rng.normal(size=(m, 3)) + 1j * rng.normal(size=(m, 3))
            th = a @ a.conj().T
        elif i >= 2:
            th = base + 1e-3 * (rng.normal(size=(m, m))
                                + 1j * rng.normal(size=(m, m)))
        else:
            th = rng.normal(size=(m, m)) + 1j * rng.normal(size=(m, m))
            base = th
        th = torch.tensor(th / np.linalg.norm(th), dtype=dtype)
        h = th.mH @ th
        out.append((h + h.mH) * 0.5)
    return torch.stack(out)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,p", [(8, 3), (12, 7)])
def test_batched_plain_versions_equal_unbatched(m, p, dtype):
    h = _grams(m, p, dtype)
    keep = m // 2
    vr, tau, d, e = ek.tridiag(h)  # the wrapper: plain on the CPU
    w, z = ek.teig(d, e)
    out = ek.backtransform(vr, tau, z, keep)
    wk, vk = ek.eigh_top_kernels(h, keep)
    assert vr.shape == (p, m, m) and tau.shape == (p, m)
    assert w.shape == (p, m) and out.shape == (p, m, keep)
    for i in range(p):
        one = ek.tridiag_plain(h[i])
        for got, want in zip((vr, tau, d, e), one):
            assert torch.equal(got[i], want)
        w1, z1 = ek.teig_plain(one[2], one[3])
        assert torch.equal(w[i], w1) and torch.equal(z[i], z1)
        assert torch.equal(out[i], ek.backtransform_plain(one[0], one[1],
                                                          z1, keep))
        wk1, vk1 = ek.eigh_top_kernels(h[i], keep)
        assert torch.equal(wk[i], wk1) and torch.equal(vk[i], vk1)


def test_more_than_one_batch_dimension_is_refused_on_a_kernel_path():
    with pytest.raises(ValueError, match="one batch dimension"):
        ek._batch_of(torch.zeros(2, 3, 4, 4), 2, "tridiag")
    assert ek._batch_of(torch.zeros(4, 4), 2, "tridiag") == ((), 1)
    assert ek._batch_of(torch.zeros(7, 4), 1, "teig") == ((7,), 7)


@pytest.mark.parametrize("eigh", ["kernels", "native"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_svd_trunc_equals_separate_calls(dtype, eigh):
    rng = np.random.default_rng(3)
    thetas = []
    for i in range(7):
        a = rng.normal(size=(12, 12)) + 1j * rng.normal(size=(12, 12))
        if i == 4:  # rank 2: its own noise floor and keep mask
            a = a[:, :2] @ a[:2, :]
        thetas.append(torch.tensor(a / np.linalg.norm(a), dtype=dtype))
    batch = cplx.svd_trunc(torch.stack(thetas), 6, 1e-8, eigh)
    for i, th in enumerate(thetas):
        one = cplx.svd_trunc(th, 6, 1e-8, eigh)
        for got, want in zip(batch, one):
            assert torch.equal(got[i], want)
    assert int((batch[1][4] > 0).sum()) == 2  # the rank-2 matrix kept 2


def _random_tape(n, depth, seed):
    rng = np.random.default_rng(seed)
    qc = Circuit(n)
    for _ in range(depth):
        k = int(rng.integers(4))
        if k == 0:
            a, b = rng.choice(n, 2, replace=False)
            qc.cx(int(a), int(b))
        else:
            getattr(qc, ("rx", "ry", "rz")[k - 1])(
                float(rng.uniform(-3, 3)), int(rng.integers(n)))
    return compile_tape(qc)


@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_mps_apply_equals_separate_applies(dtype):
    """P probe states (one state under P one-qubit gates) through a tape of
    one- and two-qubit gates, routed ones included: the batch equals P
    separate runs to rounding, and so do its cost terms."""
    n, chi = 5, 4
    t0 = _random_tape(n, 20, 1)
    base = mps_core.apply_tape(mps_core.zero_mps(n, chi, dtype), t0.kinds,
                               t0.q0, t0.q1, t0.angles, 1e-10)
    rdt = base.lam.dtype
    pk = torch.tensor([1, 1, 1, 2, 2, 3, 3])
    pa = torch.tensor([0.0, 1.5, -1.5, 1.5, -1.5, 1.5, -1.5], dtype=rdt)
    pu = sv_core.build_u4(pk, pa, dtype)
    tape = _random_tape(n, 12, 2)
    u4s = sv_core.tape_u4(base, tape.kinds, tape.angles)
    entries = list(zip(tape.kinds.tolist(), tape.q0.tolist(),
                       tape.q1.tolist()))

    def run(state, first):
        state = mps_core.apply_gate(state, 1, 2, 0, first, 1e-10)
        for i, (k, a, b) in enumerate(entries):
            state = mps_core.apply_gate(state, k, a, b, u4s[i], 1e-10)
        return state

    batch = run(base, pu)
    assert batch.batch == (7,) and batch.b.shape == (7, n, 2, chi, chi)
    ref = mps_core.zero_mps(n, chi, dtype)
    g, loc, h1 = mps_core.full_cost_terms(batch, ref)
    for i in range(7):
        one = run(base, pu[i])
        tol = 1e-4 if dtype == torch.complex64 else 1e-10
        np.testing.assert_allclose(mps_core.to_dense(
            mps_core.MPS(batch.b[i], batch.lam[i], batch.trunc[i])),
            mps_core.to_dense(one), atol=tol)
        assert float((batch.lam[i] - one.lam).abs().max()) < tol
        assert abs(float(batch.trunc[i] - one.trunc)) < tol
        g1, loc1, h11 = mps_core.full_cost_terms(one, ref)
        for got, want in ((g[i], g1), (loc[i], loc1), (h1[i], h11)):
            assert abs(float(got) - float(want)) < tol


def test_batched_sv_apply_equals_separate_applies():
    n = 7
    tape = _random_tape(n, 25, 5)
    base = sv_core.apply_tape(sv_core.zero_state(n, torch.complex128),
                              tape.kinds, tape.q0, tape.q1, tape.angles)
    pk = torch.tensor([1, 2, 3])
    pa = torch.tensor([0.3, 1.5, -1.5], dtype=torch.float64)
    pu = sv_core.build_u4(pk, pa, torch.complex128)
    u4s = sv_core.tape_u4(base, tape.kinds, tape.angles)
    entries = list(zip(tape.kinds.tolist(), tape.q0.tolist(),
                       tape.q1.tolist()))
    for q in (0, 3, 6):
        def run(first):
            st = sv_core.apply_gate(base, 1, q, 0, first)
            for i, (k, a, b) in enumerate(entries):
                st = sv_core.apply_gate(st, k, a, b, u4s[i])
            return st
        batch = run(pu)
        assert batch.shape == (3, 2 ** n)
        terms = sv_core.full_cost_terms(batch, sv_core.zero_state(
            n, torch.complex128))
        for i in range(3):
            one = run(pu[i])
            assert float((batch[i] - one).abs().max()) < 1e-13
            for got, want in zip(terms, sv_core.full_cost_terms(
                    one, sv_core.zero_state(n, torch.complex128))):
                assert abs(float(got[i]) - float(want)) < 1e-12


def test_mps_cost_terms_match_dense():
    """amplitude, hamming1_overlaps and full_cost_terms against the dense
    statevector of the same state (1e-10, complex128)."""
    n, chi = 5, 4
    tape = _random_tape(n, 30, 9)
    st = mps_core.apply_tape(mps_core.zero_mps(n, chi, torch.complex128),
                             tape.kinds, tape.q0, tape.q1, tape.angles, 1e-14)
    dense = mps_core.to_dense(st)
    bits = [1, 0, 1, 1, 0]
    idx = sum(b << i for i, b in enumerate(bits))
    assert abs(complex(mps_core.amplitude(st, bits)) - dense[idx]) < 1e-10
    h1 = mps_core.hamming1_overlaps(st).numpy()
    np.testing.assert_allclose(h1, np.abs(dense[2 ** np.arange(n)]) ** 2,
                               atol=1e-10)
    sv = torch.tensor(dense)
    want = sv_core.full_cost_terms(sv, sv_core.zero_state(
        n, torch.complex128))
    got = mps_core.full_cost_terms(st, mps_core.zero_mps(
        n, chi, torch.complex128))
    for a, b in zip(got, want):
        assert abs(float(a) - float(b)) < 1e-10
    cost, h1s = mps_core.softened_cost_terms(st)
    assert abs(float(cost) - float(want[0])) < 1e-10
    assert abs(float(h1s) - float(want[2])) < 1e-10


def test_regauge_grows_exactly_and_shrinks_like_a_capped_apply():
    n = 6
    tape = _random_tape(n, 40, 11)
    st = mps_core.apply_tape(mps_core.zero_mps(n, 8, torch.complex128),
                             tape.kinds, tape.q0, tape.q1, tape.angles, 1e-14)
    assert mps_core.regauge(st, 8) is st
    big = mps_core.regauge(st, 16)
    np.testing.assert_allclose(mps_core.to_dense(big), mps_core.to_dense(st),
                               atol=1e-12)
    small = mps_core.regauge(st, 2)
    assert small.chi == 2 and small.dtype == st.dtype
    assert abs(float(mps_core.mps_dot(small, small).real) - 1.0) < 1e-8
    ov = mps_core.mps_dot(mps_core.pad_chi(small, 8), st)
    assert 0.05 < abs(complex(ov)) ** 2 <= 1.0 + 1e-9


def test_batched_op_overlaps_match_pair_op_overlaps():
    n, chi = 5, 4
    dt = torch.complex128
    ta, tb = _random_tape(n, 25, 13), _random_tape(n, 25, 14)
    bra = mps_core.apply_tape(mps_core.zero_mps(n, chi, dt), ta.kinds, ta.q0,
                              ta.q1, ta.angles, 1e-14)
    ket = mps_core.apply_tape(mps_core.zero_mps(n, chi, dt), tb.kinds, tb.q0,
                              tb.q1, tb.angles, 1e-14)
    rng = np.random.default_rng(5)
    ops_a = torch.tensor(rng.normal(size=(3, 2, 2, 2))
                         + 1j * rng.normal(size=(3, 2, 2, 2)), dtype=dt)
    ops_b = torch.tensor(rng.normal(size=(3, 2, 2, 2))
                         + 1j * rng.normal(size=(3, 2, 2, 2)), dtype=dt)
    pairs = np.array([(0, 1), (2, 1), (3, 4), (1, 2)])
    fast = mps_core.pair_op_overlaps(bra, ket, ops_a, ops_b, pairs, 1)
    slow = mps_core.batched_op_overlaps(bra, ket, ops_a, ops_b, pairs)
    np.testing.assert_allclose(fast.numpy(), slow.numpy(), atol=1e-10)


def test_vmapped_jax_kernels_match_the_batched_plain_versions():
    """The JAX package's three kernels under jax.vmap in interpret mode
    (what its full-cost sweep launches) against the port's batched plain
    versions on the same float32 Grams: d, e 1e-5 of the scale, kept
    eigenvalues 1e-5, Q T Q^H through the chain's top eigenvectors 1e-4."""
    import jax
    import jax.numpy as jnp
    from adaptaqc_tpu.ops import cplx as jcplx
    from adaptaqc_tpu.ops import pallas_eigh
    m, p, keep = 8, 3, 4
    h = _grams(m, p, torch.complex64, seed=4)
    hj = jcplx.C(jnp.asarray(h.real.numpy()), jnp.asarray(h.imag.numpy()))
    wj, vj = jax.vmap(lambda x: pallas_eigh.eigh_top_pallas_teig(
        x, keep, interpret=True))(hj)
    wk, vk = ek.eigh_top_kernels(h, keep)
    scale = float(wk.abs().max())
    assert np.abs(np.asarray(wj) - wk.numpy()).max() < 1e-5 * scale
    vjn = np.asarray(vj.re) + 1j * np.asarray(vj.im)
    for i in range(p):
        # eigenvectors up to phase: compare the projectors on the top
        # eigenvector of the full-rank matrices
        if i == 1:
            continue
        a, b = vjn[i][0], vk[i].numpy()[:, 0]  # the JAX chain has V as rows
        assert abs(abs(np.vdot(a, b)) - 1.0) < 1e-4
