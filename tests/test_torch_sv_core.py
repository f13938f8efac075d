"""The port's statevector engine against the JAX package's
`backends/sv_core.py`, on the same seeded numpy states carried across with
`state_from_numpy`: gate application over every kind, both qubit orders and
non-adjacent pairs (and its adjoint), the probe's local overlap matrix, <Z>,
the two-qubit RDMs, the global cost, the MPS engine's all-pair RDMs, and one
Rotoselect sweep over the statevector engine. Tolerances: 1e-10 in
complex128 (x64 on the JAX side), 1e-5 in complex64 (float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptaqc_tpu.backends import mps_core as jmps
from adaptaqc_tpu.backends import sv_core as jsv
from adaptaqc_tpu.ops import cplx as jcplx
from adaptaqc_tpu.optim import sweeps as jsweeps

from adaptaqc_tpu_torch.backends import mps_core, sv_core
from adaptaqc_tpu_torch.circuits import gates as G
from adaptaqc_tpu_torch.circuits.circuit import Circuit
from adaptaqc_tpu_torch.circuits.tape import CXR, compile_tape
from adaptaqc_tpu_torch.optim import sweeps

torch.set_num_threads(1)

# (torch dtype, JAX real dtype, tolerance)
DTYPES = {"c128": (torch.complex128, jnp.float64, 1e-10),
          "c64": (torch.complex64, jnp.float32, 1e-5)}


def _vec(n, rng):
    v = rng.normal(size=2 ** n) + 1j * rng.normal(size=2 ** n)
    return v / np.linalg.norm(v)


def _pair(v, tdt, jdt):
    """The same state in both packages."""
    return (sv_core.state_from_numpy(v.real, v.imag, dtype=tdt),
            jcplx.from_np(v, jdt))


def _np(t):
    return t.detach().cpu().numpy()


def _every_kind_tape(n, rng):
    """Every gate kind (CXR included) on adjacent, non-adjacent and
    descending qubit pairs, at random angles."""
    pairs = [(0, 1), (1, 3), (3, 1), (n - 1, 0), (2, n - 1)]
    rows = [(k, a, b, rng.uniform(-np.pi, np.pi))
            for k in list(range(G.RX, G.N_KINDS)) + [CXR]
            for a, b in pairs]
    rng.shuffle(rows)
    kinds, q0, q1, angles = (np.array(c) for c in zip(*rows))
    return (kinds.astype(np.int32), q0.astype(np.int32),
            q1.astype(np.int32), angles.astype(np.float64))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_apply_tape_and_adjoint_match_jax(dt):
    tdt, jdt, tol = DTYPES[dt]
    n = 5
    rng = np.random.default_rng(0)
    ts, js = _pair(_vec(n, rng), tdt, jdt)
    kinds, q0, q1, angles = _every_kind_tape(n, rng)
    ja = jnp.asarray(angles, jdt)
    out = sv_core.apply_tape(ts, kinds, q0, q1, angles)
    ref = jcplx.to_np(jsv.apply_tape(js, kinds, q0, q1, ja))
    np.testing.assert_allclose(_np(out), ref, atol=tol)
    back = sv_core.apply_tape_adjoint(out, kinds, q0, q1, angles)
    ref_back = jcplx.to_np(jsv.apply_tape_adjoint(
        jsv.apply_tape(js, kinds, q0, q1, ja), kinds, q0, q1, ja))
    np.testing.assert_allclose(_np(back), ref_back, atol=tol)
    np.testing.assert_allclose(_np(back), _np(ts), atol=tol)


def test_two_qubit_gates_on_a_circuit_match_dense_matrices():
    """CX both ways, CZ and SWAP on non-adjacent qubits, through the
    Circuit/tape path, against kron-built dense matrices."""
    n = 4
    rng = np.random.default_rng(1)
    v = _vec(n, rng)
    qc = Circuit(n)
    qc.cx(3, 0)
    qc.cx(0, 2)
    qc.cz(1, 3)
    qc.swap(2, 0)
    tape = compile_tape(qc)
    out = _np(sv_core.apply_tape(sv_core.state_from_numpy(
        v.real, v.imag, dtype=torch.complex128), tape.kinds, tape.q0,
        tape.q1, tape.angles))

    def perm_matrix(f):
        m = np.zeros((2 ** n, 2 ** n))
        for i in range(2 ** n):
            m[f(i), i] = 1.0
        return m

    def bit(i, q):
        return (i >> q) & 1

    cx30 = perm_matrix(lambda i: i ^ (bit(i, 3) << 0))
    cx02 = perm_matrix(lambda i: i ^ (bit(i, 0) << 2))
    cz13 = np.diag([(-1.0) ** (bit(i, 1) & bit(i, 3)) for i in range(2 ** n)])
    swap20 = perm_matrix(lambda i: (i & ~0b101) | (bit(i, 0) << 2)
                         | bit(i, 2))
    ref = swap20 @ cz13 @ cx02 @ cx30 @ v
    np.testing.assert_allclose(out, ref, atol=1e-12)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_local_overlap_matrix_matches_jax(dt):
    """Every qubit of n = 7."""
    tdt, jdt, tol = DTYPES[dt]
    n = 7
    rng = np.random.default_rng(2)
    tl, jl = _pair(_vec(n, rng), tdt, jdt)
    tr, jr = _pair(_vec(n, rng), tdt, jdt)
    for q in range(n):
        out = _np(sv_core.local_overlap_matrix(tr, tl, q))
        ref = jcplx.to_np(jsv.local_overlap_matrix(jr, jl, q))
        np.testing.assert_allclose(out, ref, atol=tol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_observables_match_jax(dt):
    """<Z_q>, global cost, probabilities and <a|b>."""
    tdt, jdt, tol = DTYPES[dt]
    n = 6
    rng = np.random.default_rng(3)
    ta, ja = _pair(_vec(n, rng), tdt, jdt)
    tb, jb = _pair(_vec(n, rng), tdt, jdt)
    np.testing.assert_allclose(_np(sv_core.z_expectations(ta)),
                               np.asarray(jsv.z_expectations(ja, n)),
                               atol=tol)
    assert abs(float(sv_core.global_cost(ta))
               - float(jsv.global_cost(ja))) < tol
    np.testing.assert_allclose(_np(sv_core.probabilities(ta)),
                               np.asarray(jsv.probabilities(ja)), atol=tol)
    ov = complex(sv_core.overlap(ta, tb))
    jov = jsv.overlap(ja, jb)
    assert abs(ov - (float(jov.re) + 1j * float(jov.im))) < tol


@pytest.mark.parametrize("dt", list(DTYPES))
def test_rdms_match_jax(dt):
    """rdm2 on ascending, descending and non-adjacent pairs, and the
    batched all_pair_rdms over the full map."""
    tdt, jdt, tol = DTYPES[dt]
    n = 5
    rng = np.random.default_rng(4)
    ts, js = _pair(_vec(n, rng), tdt, jdt)
    for a, b in [(0, 1), (1, 0), (0, 4), (4, 2), (1, 3)]:
        np.testing.assert_allclose(_np(sv_core.rdm2(ts, a, b)),
                                   jcplx.to_np(jsv.rdm2(js, a, b)), atol=tol)
    pairs = np.array([(a, b) for a in range(n) for b in range(a + 1, n)],
                     np.int32)
    out = _np(sv_core.all_pair_rdms(ts, pairs))
    ref = jcplx.to_np(jsv.all_pair_rdms(js, jnp.asarray(pairs)))
    np.testing.assert_allclose(out, ref, atol=tol)


def test_rdm_index_order_on_a_product_state():
    """|1> on qubit 3, |0> on qubit 1: rho(1, 3) has its weight at
    r = 2*b(3) + b(1) = 2, rho(3, 1) at r = 2*b(1) + b(3) = 1."""
    qc = Circuit(4)
    qc.x(3)
    tape = compile_tape(qc)
    st = sv_core.apply_tape(sv_core.zero_state(4, torch.complex128),
                            tape.kinds, tape.q0, tape.q1, tape.angles)
    assert abs(complex(sv_core.rdm2(st, 1, 3)[2, 2]) - 1) < 1e-12
    assert abs(complex(sv_core.rdm2(st, 3, 1)[1, 1]) - 1) < 1e-12


def test_state_numpy_round_trip_and_vector_import():
    rng = np.random.default_rng(5)
    v = 3.0 * _vec(4, rng)
    re, im = sv_core.state_to_numpy(sv_core.state_from_numpy(
        v.real, v.imag, dtype=torch.complex128))
    np.testing.assert_array_equal(re + 1j * im, v)
    st = sv_core.state_from_vector(v, torch.complex128)
    np.testing.assert_allclose(_np(st), jcplx.to_np(jsv.state_from_vector(v)),
                               atol=1e-15)
    assert sv_core.num_qubits(st) == 4


def test_mps_all_pair_rdms_match_jax():
    """The MPS engine's (n, n, 4, 4) RDMs of a random entangled state,
    float64: 1e-10."""
    n, chi = 6, 8
    rng = np.random.default_rng(6)
    qc = Circuit(n)
    for _ in range(3):
        for q in range(n):
            qc.ry(float(rng.uniform(-3, 3)), q)
            qc.rz(float(rng.uniform(-3, 3)), q)
        for q in range(n - 1):
            qc.cx(q, q + 1)
    qc.cx(0, 3)
    tape = compile_tape(qc)
    jst = jmps.apply_tape(jmps.zero_mps(n, chi, jnp.float64),
                          jnp.asarray(tape.kinds), jnp.asarray(tape.q0),
                          jnp.asarray(tape.q1), jnp.asarray(tape.angles),
                          1e-16)
    tst = mps_core.mps_from_numpy(np.asarray(jst.b.re), np.asarray(jst.b.im),
                                  np.asarray(jst.lam), np.asarray(jst.trunc),
                                  dtype=torch.complex128)
    out = _np(mps_core.all_pair_rdms(tst))
    ref = jcplx.to_np(jmps.all_pair_rdms(jst))
    np.testing.assert_allclose(out, ref, atol=1e-10)
    # and against the dense engine's partial trace
    dense = sv_core.state_from_vector(mps_core.to_dense(tst), torch.complex128)
    for a, b in [(0, 1), (0, 5), (2, 4)]:
        np.testing.assert_allclose(out[a, b], _np(sv_core.rdm2(dense, a, b)),
                                   atol=1e-10)


def test_sweep_on_sv_engine_matches_jax_x64():
    """One Rotoselect sweep over a window of dressed-CNOT layers on a
    random-entangling target, n = 6: kinds equal, angles 1e-8, cost
    1e-10."""
    n = 6
    rng = np.random.default_rng(7)
    target = Circuit(n)
    for q in range(n):
        target.ry(float(rng.uniform(-3, 3)), q)
    for layer in range(3):
        for q in range(layer % 2, n - 1, 2):
            target.cx(q, q + 1)
        for q in range(n):
            target.rz(float(rng.uniform(-3, 3)), q)
    ansatz = Circuit(n)
    for _ in range(4):
        a, b = (int(x) for x in rng.choice(n, 2, replace=False))
        ansatz.rz(0.1, a)
        ansatz.rz(0.1, b)
        ansatz.cx(a, b)
        ansatz.rz(0.1, a)
        ansatz.rz(0.1, b)
    tt, at = compile_tape(target), compile_tape(ansatz)
    jprefix = jsv.apply_tape(jsv.zero_state(n, jnp.float64), tt.kinds, tt.q0,
                             tt.q1, tt.angles)
    jref = jsv.zero_state(n, jnp.float64)
    jk, ja, jc, _, jev, _ = jsweeps.sweep(
        jsv.sweep_engine(), at.padded_length, True, jprefix, jref,
        jnp.asarray(at.kinds), jnp.asarray(at.q0), jnp.asarray(at.q1),
        jnp.asarray(at.angles), jnp.asarray(at.trainable))
    prefix = sv_core.state_from_numpy(np.asarray(jprefix.re),
                                      np.asarray(jprefix.im),
                                      dtype=torch.complex128)
    ref = sv_core.zero_state(n, torch.complex128)
    bl = sweeps.default_block_len(at.padded_length, sweeps.state_nbytes(ref))
    tk, ta, tc, state, tev, _ = sweeps.sweep(
        sv_core.sweep_engine(), bl, True, prefix, ref, at.kinds, at.q0, at.q1,
        at.angles, at.trainable)
    np.testing.assert_array_equal(tk, np.asarray(jk))
    np.testing.assert_allclose(ta, np.asarray(ja), atol=1e-8)
    assert abs(tc - float(jc)) < 1e-10
    assert tev == int(jev)
    assert abs(1 - abs(complex(state[0])) ** 2 - tc) < 1e-12


class _NoIter(torch.Tensor):
    def __iter__(self):
        raise AssertionError("state_nbytes iterated over the amplitudes")


def test_state_nbytes_of_a_flat_statevector():
    """A statevector is one tensor: its size is read from its shape, not
    summed over its elements (which would walk 2**n amplitudes one by one
    in Python on every sweep call)."""
    st = sv_core.zero_state(20, torch.complex64).as_subclass(_NoIter)
    assert sweeps.state_nbytes(st) == 8 * 2 ** 20
    mps = mps_core.zero_mps(5, 4, torch.complex128)
    assert sweeps.state_nbytes(mps) == 16 * 5 * 2 * 16 + 8 * 6 * 4 + 8


@pytest.mark.parametrize("n", [6, 13, 17])
def test_window_products_take_every_branch(n):
    """Every window placement and Gram split (bit 0, >= 128 batches, a
    few batches split along z, no window) against plain contractions of
    the (X, 2, Y, 2, Z) views, complex128: 1e-10."""
    rng = np.random.default_rng(n)
    r, l = (sv_core.state_from_vector(_vec(n, rng), torch.complex128)
            for _ in range(2))
    u2 = torch.as_tensor(np.linalg.qr(rng.normal(size=(2, 2)))[0] + 0j)
    u4 = torch.as_tensor(np.linalg.qr(rng.normal(size=(4, 4))
                                      + 1j * rng.normal(size=(4, 4)))[0])
    for q in range(n):
        v3 = l.view(-1, 2, 1 << q)
        np.testing.assert_allclose(
            _np(sv_core.apply_u2(l, u2, q)),
            _np(torch.einsum("ab,xbz->xaz", u2, v3).reshape(-1)), atol=1e-10)
        c = torch.einsum("xiz,xjz->ij", r.view(-1, 2, 1 << q).conj(), v3)
        np.testing.assert_allclose(_np(sv_core.local_overlap_matrix(r, l, q)),
                                   _np(c), atol=1e-10)
    pairs = {(0, 1), (0, 4), (1, 5), (2, 6), (3, 7), (n - 5, n - 1),
             (n // 2, n // 2 + 1), (0, n - 1)}
    for lo, hi in sorted((a, b) for a, b in pairs if a < b < n):
        v5 = l.view(-1, 2, 1 << (hi - lo - 1), 2, 1 << lo)
        ref = torch.einsum("abcd,xcydz->xaybz", u4.reshape(2, 2, 2, 2), v5)
        np.testing.assert_allclose(_np(sv_core.apply_u4(l, u4, lo, hi)),
                                   _np(ref.reshape(-1)), atol=1e-10)
        psi = v5.permute(1, 3, 0, 2, 4).reshape(4, -1)
        np.testing.assert_allclose(_np(sv_core.rdm2(l, lo, hi)),
                                   _np(psi @ psi.mH), atol=1e-10)
