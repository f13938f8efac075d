"""The port's center-gauge MPS engine, CenterMPSBackend and
cross_engine_overlap, case for case with tests/test_center_mps.py:33-287,
on the CPU in complex128: against exact dense simulation (1e-10: the
acceptance bound for n <= 10), against the primary B-form engine, against
the JAX package's engine on the same numpy-seeded circuits (states and
observables 1e-10, cross_engine_overlap 1e-8), and end to end through
AdaptCompiler."""

import unittest.mock as mock

import numpy as np
import pytest
import torch

import adaptaqc_tpu as jport
from adaptaqc_tpu.backends import center_mps as jcenter
from adaptaqc_tpu.circuits.tape import compile_tape as jcompile
from adaptaqc_tpu.utils.verification import cross_engine_overlap as jcross

import adaptaqc_tpu_torch as port
from adaptaqc_tpu_torch.backends import center_mps, mps_core
from adaptaqc_tpu_torch.circuits import operations as co
from adaptaqc_tpu_torch.circuits.tape import compile_tape
from adaptaqc_tpu_torch.optim import sweeps
from adaptaqc_tpu_torch.utils import constants as vconstants
from adaptaqc_tpu_torch.utils.verification import cross_engine_overlap

from reference_sim import simulate
from test_torch_full_cost_sweep import _ry_dressed_layer, random_circuit

torch.set_num_threads(1)
C128 = torch.complex128
KW = dict(device="cpu", dtype=C128)
CUT = 1e-12


def both(n, depth, seed):
    """The same random circuit in the JAX package's and the port's IR."""
    return (random_circuit(jport.Circuit, n, depth,
                           np.random.default_rng(seed)),
            random_circuit(port.Circuit, n, depth,
                           np.random.default_rng(seed)))


def run_cmps(qc, chi):
    tape = compile_tape(qc)
    st = center_mps.zero_cmps(qc.num_qubits, chi, **KW)
    return center_mps.apply_tape(st, tape.kinds, tape.q0, tape.q1,
                                 tape.angles, CUT)


def run_jax_cmps(jqc, chi):
    tape = jcompile(jqc)
    return jcenter.apply_tape(jcenter.zero_cmps(jqc.num_qubits, chi),
                              tape.kinds, tape.q0, tape.q1, tape.angles, CUT)


@pytest.mark.parametrize("n,chi,seed", [(2, 2, 0), (3, 4, 1), (5, 8, 2),
                                        (10, 32, 3)])
def test_cmps_matches_dense_random(n, chi, seed):
    jqc, qc = both(n, 24, seed)
    np.testing.assert_allclose(center_mps.to_dense(run_cmps(qc, chi)),
                               simulate(jqc), atol=1e-10)


def test_cmps_matches_jax_engine():
    """Same circuit through both packages' engines: dense states, norms,
    truncation records and observables to 1e-10; and the JAX state carried
    over by cmps_from_numpy gives the port's observables the same values."""
    jqc, qc = both(6, 40, 12)
    js, ts = run_jax_cmps(jqc, 4), run_cmps(qc, 4)  # chi = 4 truncates
    assert int(js.center) == ts.center
    np.testing.assert_allclose(center_mps.to_dense(ts), jcenter.to_dense(js),
                               atol=1e-10)
    assert abs(float(js.trunc) - float(ts.trunc)) < 1e-10
    assert abs(float(jcenter.norm_sq(js)) - float(center_mps.norm_sq(ts))) \
        < 1e-10
    carried = center_mps.cmps_from_numpy(
        np.asarray(js.t.re), np.asarray(js.t.im), int(js.center),
        np.asarray(js.trunc), dtype=C128)
    for state in (ts, carried):
        np.testing.assert_allclose(
            center_mps.z_expectations(state).numpy(),
            np.asarray(jcenter.z_expectations(js)), atol=1e-10)
        assert abs(float(center_mps.global_cost_normalized(state))
                   - float(jcenter.global_cost_normalized(js))) < 1e-10
    jr = jcenter.all_pair_rdms(js)
    np.testing.assert_allclose(
        center_mps.all_pair_rdms(ts).numpy(),
        np.asarray(jr.re) + 1j * np.asarray(jr.im), atol=1e-10)
    t_re, t_im, center, trunc = center_mps.cmps_to_numpy(ts)
    assert center == ts.center and t_re.shape == (6, 2, 4, 4)
    back = center_mps.cmps_from_numpy(t_re, t_im, center, trunc, dtype=C128)
    assert torch.equal(back.t, ts.t)


def test_cmps_nonadjacent_and_reversed_gates():
    def build(cls):
        qc = cls(5)
        qc.h(0)
        qc.cx(0, 4)      # long-range, swap-routed
        qc.ry(0.7, 2)
        qc.cx(4, 1)      # reversed control/target
        qc.cz(3, 0)
        return qc
    st = run_cmps(build(port.Circuit), 8)
    np.testing.assert_allclose(center_mps.to_dense(st),
                               simulate(build(jport.Circuit)), atol=1e-10)


def test_center_moves_are_pure_gauge():
    _, qc = both(4, 20, 3)
    st = run_cmps(qc, 8)
    dense = center_mps.to_dense(st)
    for k in (3, 0, 2, 1):
        st = center_mps.move_center_to(st, k)
        assert st.center == k
        np.testing.assert_allclose(center_mps.to_dense(st), dense,
                                   atol=1e-10)


@pytest.mark.parametrize("n", [2, 4, 6])
def test_degenerate_schmidt_spectra(n):
    qc = port.Circuit(n)
    qc.h(0)
    for q in range(n - 1):
        qc.cx(q, q + 1)
    st = run_cmps(qc, max(2, 2 ** (n // 2)))
    expected = np.zeros(2 ** n, complex)
    expected[0] = expected[-1] = 1 / np.sqrt(2)
    np.testing.assert_allclose(np.abs(center_mps.to_dense(st)),
                               np.abs(expected), atol=1e-10)
    assert abs(float(center_mps.norm_sq(st)) - 1.0) < 1e-10


def test_truncation_tracks_discarded_weight():
    _, qc = both(6, 60, 4)
    full = run_cmps(qc, 8)
    assert float(full.trunc) < 1e-6
    capped = run_cmps(qc, 2)   # chi = 2 must truncate
    assert float(capped.trunc) > 1e-4
    # the norm decays by the discarded weight: nothing is renormalised
    assert float(center_mps.norm_sq(capped)) < 1.0 - 1e-4


def test_observables_match_dense():
    jqc, qc = both(4, 20, 5)
    st = run_cmps(qc, 8)
    sv = simulate(jqc)
    assert abs(complex(center_mps.overlap_with_zero(st)) - sv[0]) < 1e-10
    gc = float(center_mps.global_cost_normalized(st))
    assert abs(gc - (1 - abs(sv[0]) ** 2)) < 1e-10
    z = center_mps.z_expectations(st).numpy()
    probs = np.abs(sv) ** 2
    for q in range(4):
        signs = np.array([1 if not (i >> q) & 1 else -1 for i in range(16)])
        assert abs(z[q] - np.sum(signs * probs)) < 1e-10


def test_all_pair_rdms_match_dense():
    jqc, qc = both(4, 20, 6)
    rhos = center_mps.all_pair_rdms(run_cmps(qc, 8)).numpy()
    psi = simulate(jqc).reshape([2] * 4)  # axes (q3, q2, q1, q0)
    for i in range(4):
        for j in range(i + 1, 4):
            m = np.moveaxis(psi, [3 - j, 3 - i], [0, 1]).reshape(4, -1)
            np.testing.assert_allclose(rhos[i, j], m @ m.conj().T,
                                       atol=1e-10)


def test_from_bform_conversion_exact():
    _, qc = both(5, 30, 7)
    tape = compile_tape(qc)
    b = mps_core.apply_tape(mps_core.zero_mps(5, 8, C128), tape.kinds,
                            tape.q0, tape.q1, tape.angles, 1e-12)
    c = center_mps.from_bform(b)
    assert c.center == 0 and c.device == b.device and c.dtype == b.dtype
    np.testing.assert_allclose(center_mps.to_dense(c), mps_core.to_dense(b),
                               atol=1e-12)


def test_cross_engine_global_cost_agreement():
    _, qc = both(6, 40, 8)
    tape = compile_tape(qc)
    b = mps_core.apply_tape(mps_core.zero_mps(6, 8, C128), tape.kinds,
                            tape.q0, tape.q1, tape.angles, 1e-12)
    gb = float(mps_core.global_cost_normalized(b))
    gc = float(center_mps.global_cost_normalized(run_cmps(qc, 8)))
    assert abs(gb - gc) < 1e-10


def test_backend_end_to_end_compile():
    jqc, qc = both(3, 10, 9)
    backend = port.CenterMPSBackend(chi=4, **KW)
    cfg = port.AdaptConfig(sufficient_cost=0.01, max_layers=30)
    comp = port.AdaptCompiler(qc, backend=backend, adapt_config=cfg)
    assert not comp.is_mps_backend  # as in the JAX package: its own path
    result = comp.compile()
    assert result.overlap > 0.99
    assert comp._current_state().device.type == "cpu"
    # the claimed overlap, on exact statevectors
    tape = compile_tape(co.make_quantum_only_circuit(result.circuit))
    from adaptaqc_tpu_torch.backends import sv_core
    sv_sol = sv_core.apply_tape(sv_core.zero_state(3, C128), tape.kinds,
                                tape.q0, tape.q1, tape.angles).numpy()
    assert abs(np.vdot(sv_sol, simulate(jqc))) ** 2 > 0.98


def test_backend_parity_scope():
    _, qc = both(3, 6, 10)
    backend = port.CenterMPSBackend(chi=4, **KW)
    compiler = port.AdaptCompiler(qc, backend=backend,
                                  soften_global_cost=True)
    with pytest.raises(NotImplementedError):
        backend.evaluate_global_cost(compiler)  # itensor_backend.py:35-38
    with pytest.raises(Exception):  # an MPS target needs the MPSBackend
        port.AdaptCompiler(mps_core.zero_mps(3, 4, C128), backend=backend)
    assert port.CENTER_MPS_SIM.engine_name == "center_mps"


def test_cross_engine_overlap_verifier():
    jqc, qc = both(4, 8, 7)
    jother, other = both(4, 6, 8)
    assert abs(cross_engine_overlap(qc, qc, chi=8, **KW) - 1.0) < 1e-10
    got = cross_engine_overlap(qc, other, chi=8, **KW)
    assert abs(got - jcross(jqc, jother, chi=8)) < 1e-8

    def bform(c):  # the B-form engine's independent verdict
        t = compile_tape(c)
        return mps_core.apply_tape(mps_core.zero_mps(4, 8, C128), t.kinds,
                                   t.q0, t.q1, t.angles, 1e-16)
    a, b = bform(qc), bform(other)
    want = (abs(complex(mps_core.mps_dot(a, b))) ** 2
            / (float(mps_core.mps_dot(a, a).real)
               * float(mps_core.mps_dot(b, b).real)))
    assert abs(got - want) < 1e-10
    # engine-MPS and Qiskit-format targets go through the same verifier; an
    # engine MPS brings its own device and dtype
    assert abs(cross_engine_overlap(a, qc, chi=8) - 1.0) < 1e-10
    assert abs(cross_engine_overlap(mps_core.to_qiskit_mps(a), qc, chi=8,
                                    **KW) - 1.0) < 1e-10


def _prepared_center_compiler(seed, n=4, depth=16, **kwargs):
    qc = random_circuit(port.Circuit, n, depth, np.random.default_rng(seed))
    comp = port.AdaptCompiler(
        qc, backend=port.CenterMPSBackend(chi=8, **KW),
        custom_layer_2q_gate=_ry_dressed_layer(port.Circuit), **kwargs)
    return comp, comp._add_entangling_layer(0)


def _minimize(comp, idx, rotoselect, force_host):
    if force_host:
        comp.minimizer._can_fast_sweep = lambda *_a, **_k: False
        comp.minimizer._can_full_sweep = lambda *_a, **_k: False
    alg = (vconstants.ALG_ROTOSELECT if rotoselect
           else vconstants.ALG_ROTOSOLVE)
    cost = comp.minimizer.minimize_cost(
        algorithm_kind=alg, max_cycles=1, stop_val=-np.inf, tol=1e-10,
        indexes_to_modify=idx)
    angles = co.find_angles_in_circuit(comp.full_circuit,
                                       comp.variational_circuit_range())
    return cost, np.asarray(angles)


@pytest.mark.parametrize("rotoselect", [False, True])
def test_center_sweep_device_matches_host(rotoselect):
    ca, idx_a = _prepared_center_compiler(41)
    cb, idx_b = _prepared_center_compiler(41)
    assert idx_a == idx_b
    assert ca.minimizer._can_fast_sweep()
    cost_dev, ang_dev = _minimize(ca, idx_a, rotoselect, force_host=False)
    cost_host, ang_host = _minimize(cb, idx_b, rotoselect, force_host=True)
    assert abs(cost_dev - cost_host) < 1e-6
    if cost_host > 1e-10:
        np.testing.assert_allclose(ang_dev, ang_host, atol=1e-6)


def test_center_local_cost_sweep_matches_host():
    ca, idx_a = _prepared_center_compiler(43, optimise_local_cost=True)
    cb, idx_b = _prepared_center_compiler(43, optimise_local_cost=True)
    assert ca.minimizer._can_full_sweep(False)
    cost_dev, ang_dev = _minimize(ca, idx_a, False, force_host=False)
    cb.minimizer._can_full_sweep = lambda *_a, **_k: False
    cost_host, ang_host = _minimize(cb, idx_b, False, force_host=False)
    assert abs(cost_dev - cost_host) < 1e-6
    if cost_host > 1e-10:
        np.testing.assert_allclose(ang_dev, ang_host, atol=1e-6)


def test_backend_compile_uses_device_sweep():
    calls = {"n": 0}
    orig = sweeps.sweep_until_converged

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    qc = random_circuit(port.Circuit, 3, 10, np.random.default_rng(44))
    comp = port.AdaptCompiler(
        qc, backend=port.CenterMPSBackend(chi=8, **KW),
        adapt_config=port.AdaptConfig(max_layers=30, sufficient_cost=1e-2))
    with mock.patch.object(sweeps, "sweep_until_converged", counting):
        result = comp.compile()
    assert calls["n"] > 0
    assert result.overlap > 0.97
