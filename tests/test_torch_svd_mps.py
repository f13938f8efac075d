"""The port's truncated SVD and MPS engine against the JAX package and the
dense statevector. The JAX engine runs its CPU path (the `embed` eigh); the
port runs its default eigh="kernels" path (the kernels' plain versions on
the CPU). Singular vectors are compared only through U S Vh (gauge)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptaqc_tpu.backends import mps_core as jmps
from adaptaqc_tpu.circuits.circuit import Circuit as JCircuit
from adaptaqc_tpu.circuits.tape import compile_tape as jcompile
from adaptaqc_tpu.ops import cplx as jcplx

from adaptaqc_tpu_torch.backends import mps_core
from adaptaqc_tpu_torch.ops import cplx

torch.set_num_threads(1)

F32 = (jnp.float32, torch.complex64, 1e-5)
F64 = (jnp.float64, torch.complex128, 1e-10)


def _thetas():
    rng = np.random.default_rng(2)
    out = {}
    th = np.zeros((4, 4), complex)
    th[0, 0] = th[3, 3] = 1 / np.sqrt(2)
    out["bell"] = th
    th = np.zeros((8, 8), complex)
    th[0, 0] = th[7, 7] = 1 / np.sqrt(2)
    out["ghz"] = th
    a = rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))
    out["random"] = a / np.linalg.norm(a)
    # rank-deficient: rank 2 in a 16 x 16 theta (test_oracles
    # TestSvdTruncRankDeficient's input class)
    x = rng.standard_normal((16, 2)) + 1j * rng.standard_normal((16, 2))
    y = rng.standard_normal((2, 16)) + 1j * rng.standard_normal((2, 16))
    out["rank2"] = (x @ y) / np.linalg.norm(x @ y)
    return out


@pytest.mark.parametrize("prec", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["bell", "ghz", "random", "rank2"])
def test_svd_trunc_matches_jax(name, prec):
    jdt, tdt, tol = prec
    th = _thetas()[name]
    keep = th.shape[0] // 2
    u, s, vh = jcplx.svd_trunc(jcplx.C(jnp.asarray(th.real, jdt),
                                       jnp.asarray(th.imag, jdt)), keep, 1e-7)
    rec_j = (jcplx.to_np(u) * np.asarray(s)) @ jcplx.to_np(vh)
    tu, ts, tvh = cplx.svd_trunc(torch.tensor(th, dtype=tdt), keep, 1e-7)
    np.testing.assert_allclose(ts.numpy(), np.asarray(s), atol=tol)
    rec_t = (tu.numpy() * ts.numpy()) @ tvh.numpy()
    np.testing.assert_allclose(rec_t, rec_j, atol=tol)
    if np.linalg.matrix_rank(th) <= keep:
        np.testing.assert_allclose(rec_t, th, atol=tol)


def test_svd_trunc_native_agrees_with_kernels():
    th = _thetas()["random"]
    t = torch.tensor(th, dtype=torch.complex128)
    ref = [x.numpy() for x in cplx.svd_trunc(t, 4, 0.0, eigh="kernels")]
    with cplx.verification_eigh():
        assert cplx.default_eigh() == "native"
        nat = [x.numpy() for x in cplx.svd_trunc(t, 4, 0.0)]
    assert cplx.default_eigh() == "kernels"
    np.testing.assert_allclose(nat[1], ref[1], atol=1e-12)
    np.testing.assert_allclose((nat[0] * nat[1]) @ nat[2],
                               (ref[0] * ref[1]) @ ref[2], atol=1e-12)


def _random_circuit(n, depth, seed, cls):
    rng = np.random.default_rng(seed)
    qc = cls(n)
    for _ in range(depth):
        for q in range(n):
            getattr(qc, ["rx", "ry", "rz"][rng.integers(3)])(
                float(rng.uniform(-3, 3)), q)
        a, b = rng.choice(n, 2, replace=False)
        if rng.random() < 0.3:
            qc.cz(int(a), int(b))
        else:
            qc.cx(int(a), int(b))
    return qc


def _ghz(n, cls):
    qc = cls(n)
    qc.h(0)
    for i in range(n - 1):
        qc.cx(i, i + 1)
    return qc


def _run_both(qc_args, n, chi, prec, port=True):
    jdt, tdt, _ = prec
    depth, seed = qc_args
    if depth == 0:
        jqc = _ghz(n, JCircuit)
    else:
        jqc = _random_circuit(n, depth, seed, JCircuit)
    tape = jcompile(jqc)
    jst = jmps.apply_tape(jmps.zero_mps(n, chi, jdt), jnp.asarray(tape.kinds),
                          jnp.asarray(tape.q0), jnp.asarray(tape.q1),
                          jnp.asarray(tape.angles).astype(jdt), 1e-14)
    if not port:
        return jst, None
    tst = mps_core.apply_tape(mps_core.zero_mps(n, chi, tdt), tape.kinds,
                              tape.q0, tape.q1, tape.angles, 1e-14)
    return jst, tst


@pytest.mark.parametrize("prec", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("circ", [(0, 0), (8, 11)], ids=["ghz", "random"])
def test_apply_tape_matches_jax_and_dense(circ, prec):
    """Random circuits (non-adjacent gates routed through swaps) and GHZ at
    n <= 6, chi large enough to be exact: the port's dense vector matches
    the JAX engine's and numpy's, 1e-5 in float32, 1e-10 in float64."""
    n, chi = 6, 8
    tol = prec[2]
    jst, tst = _run_both(circ, n, chi, prec)
    dense_t = mps_core.to_dense(tst)
    dense_j = jmps.to_dense(jst)
    np.testing.assert_allclose(dense_t, dense_j, atol=tol)
    assert abs(np.linalg.norm(dense_t) - 1.0) < tol
    assert float(tst.trunc) < tol


def test_observables_match_jax():
    """mps_dot, global_cost_normalized and z_expectations on JAX states
    carried over with mps_from_numpy, float64: 1e-12."""
    prec = F64
    jst, _ = _run_both((6, 21), 6, 8, prec, port=False)
    jst2, _ = _run_both((6, 22), 6, 8, prec, port=False)
    to_t = lambda s: mps_core.mps_from_numpy(  # noqa: E731
        np.asarray(s.b.re), np.asarray(s.b.im), np.asarray(s.lam),
        np.asarray(s.trunc), dtype=torch.complex128)
    a, b = to_t(jst), to_t(jst2)
    np.testing.assert_allclose(mps_core.mps_dot(a, b).numpy(),
                               jcplx.to_np(jmps.mps_dot(jst, jst2)),
                               atol=1e-12)
    np.testing.assert_allclose(float(mps_core.global_cost_normalized(a)),
                               float(jmps.global_cost_normalized(jst)),
                               atol=1e-12)
    np.testing.assert_allclose(mps_core.z_expectations(a).numpy(),
                               np.asarray(jmps.z_expectations(jst)),
                               atol=1e-12)
    back = mps_core.mps_to_numpy(a)
    np.testing.assert_array_equal(back[0], np.asarray(jst.b.re))
    np.testing.assert_array_equal(back[2], np.asarray(jst.lam))


def test_pair_op_overlaps_matches_jax():
    """pair_op_overlaps for a linear map (ascending and descending pairs)
    and a span-2 map, float64: 1e-12."""
    rng = np.random.default_rng(5)
    jst, _ = _run_both((5, 31), 5, 4, F64, port=False)
    jst2, _ = _run_both((5, 32), 5, 4, F64, port=False)
    to_t = lambda s: mps_core.mps_from_numpy(  # noqa: E731
        np.asarray(s.b.re), np.asarray(s.b.im), np.asarray(s.lam),
        np.asarray(s.trunc), dtype=torch.complex128)
    ops_a = rng.standard_normal((3, 2, 2, 2)) + 1j * rng.standard_normal(
        (3, 2, 2, 2))
    ops_b = rng.standard_normal((3, 2, 2, 2)) + 1j * rng.standard_normal(
        (3, 2, 2, 2))
    for pairs, max_dist in (([(0, 1), (2, 1), (3, 4)], 1),
                            ([(0, 2), (3, 1), (2, 4), (1, 2)], 2)):
        pairs = np.asarray(pairs, dtype=np.int32)
        ref = jcplx.to_np(jmps.pair_op_overlaps(
            jst, jst2, jcplx.from_np(ops_a, jnp.float64),
            jcplx.from_np(ops_b, jnp.float64), jnp.asarray(pairs), max_dist))
        out = mps_core.pair_op_overlaps(
            to_t(jst), to_t(jst2), torch.tensor(ops_a), torch.tensor(ops_b),
            pairs, max_dist)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-12)


def test_qiskit_roundtrip_and_from_dense():
    jst, tst = _run_both((6, 41), 5, 4, F64)
    q = mps_core.to_qiskit_mps(tst)
    back = mps_core.from_qiskit_mps(q, 4, dtype=torch.complex128)
    np.testing.assert_allclose(mps_core.to_dense(back),
                               mps_core.to_dense(tst), atol=1e-10)
    dense = jmps.to_dense(jst)
    fd = mps_core.from_dense(dense, 4, dtype=torch.complex128)
    np.testing.assert_allclose(mps_core.to_dense(fd), dense, atol=1e-10)
    padded = mps_core.pad_chi(fd, 8)
    np.testing.assert_allclose(mps_core.to_dense(padded), dense, atol=1e-12)
    assert mps_core.check_mps(q) and mps_core.check_mps(fd)
