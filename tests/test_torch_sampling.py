"""The port's sampling ("QASM") backend, host probe loop, entanglement
measures and circuit-running helpers against the JAX package.

The measures and the simulated tomography are host numpy in both packages
and must agree to 1e-12 on the same inputs and seed. The device draws use a
torch.Generator, so they are held to the exact distribution (and to
themselves: a seed repeats its counts), not to the JAX package's draws."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

from adaptaqc_tpu import AdaptCompiler as JAdaptCompiler
from adaptaqc_tpu import SVBackend as JSVBackend
from adaptaqc_tpu.backends import sv_core as jsv
from adaptaqc_tpu.circuits import pauli_ops as jpauli
from adaptaqc_tpu.circuits import running as jrunning
from adaptaqc_tpu.circuits.operations import add_to_circuit as jadd
from adaptaqc_tpu.ops import cplx as jcplx
from adaptaqc_tpu.utils import ansatzes as jans
from adaptaqc_tpu.utils import entanglement_measures as jem

from adaptaqc_tpu_torch import (AdaptCompiler, AdaptConfig, SamplingBackend,
                                SVBackend)
from adaptaqc_tpu_torch.backends import sv_core
from adaptaqc_tpu_torch.circuits import pauli_ops, running
from adaptaqc_tpu_torch.circuits.circuit import Circuit
from adaptaqc_tpu_torch.circuits.operations import (add_to_circuit,
                                                    make_quantum_only_circuit)
from adaptaqc_tpu_torch.circuits.tape import compile_tape
from adaptaqc_tpu_torch.utils import ansatzes as ans
from adaptaqc_tpu_torch.utils import entanglement_measures as em

sys.path.insert(0, os.path.dirname(__file__))
from test_sv_core import random_circuit as j_random_circuit  # noqa: E402

torch.set_num_threads(1)
C128 = torch.complex128
TOL = 1e-12


def random_circuit(n, depth, rng, twoq="cx"):
    """tests/test_sv_core.random_circuit on the port's Circuit: the same
    draws give the same circuit."""
    qc = Circuit(n)
    for _ in range(depth):
        kind = rng.choice(["rx", "ry", "rz", twoq, "h"])
        if kind in ("cx", "cz"):
            a, b = rng.choice(n, 2, replace=False)
            getattr(qc, kind)(int(a), int(b))
        elif kind == "h":
            qc.h(int(rng.integers(n)))
        else:
            getattr(qc, kind)(float(rng.uniform(-np.pi, np.pi)),
                              int(rng.integers(n)))
    return qc


def _rdms(rng):
    """A Bell state, a product state and random mixed states."""
    bell = np.zeros((4, 4), complex)
    bell[0, 0] = bell[0, 3] = bell[3, 0] = bell[3, 3] = 0.5
    prod = np.diag([1.0, 0, 0, 0]).astype(complex)
    out = [bell, prod]
    for rank in (1, 2, 4):
        a = rng.normal(size=(4, rank)) + 1j * rng.normal(size=(4, rank))
        rho = a @ a.conj().T
        out.append(rho / np.trace(rho))
    return out


def test_entanglement_measures_match_jax():
    rng = np.random.default_rng(0)
    methods = [em.EM_TOMOGRAPHY_CONCURRENCE, em.EM_TOMOGRAPHY_EOF,
               em.EM_TOMOGRAPHY_NEGATIVITY, em.EM_TOMOGRAPHY_LOG_NEGATIVITY,
               em.EM_OBSERVABLE_CONCURRENCE_LOWER_BOUND]
    for rho in _rdms(rng):
        for m in methods:
            assert abs(em.measure_from_rdm(m, rho)
                       - jem.measure_from_rdm(m, rho)) < TOL, m
    v = rng.normal(size=16) + 1j * rng.normal(size=16)
    for a, b in [(0, 1), (3, 1), (0, 3)]:
        np.testing.assert_allclose(em.partial_trace(v, a, b),
                                   jem.partial_trace(v, a, b), atol=TOL)


def test_sample_tomography_rdm_matches_jax():
    """Same RDM, same numpy seed: the same multinomial draws, the same
    linear inversion and cone projection."""
    for i, rho in enumerate(_rdms(np.random.default_rng(1))):
        out = em.sample_tomography_rdm(rho, 2048, np.random.default_rng(i))
        ref = jem.sample_tomography_rdm(rho, 2048, np.random.default_rng(i))
        np.testing.assert_allclose(out, ref, atol=TOL)


def _state(n, rng):
    v = rng.normal(size=2 ** n) + 1j * rng.normal(size=2 ** n)
    return sv_core.state_from_vector(v, C128)


def test_sampler_repeats_its_counts_and_puts_qubit_0_rightmost():
    st = _state(5, np.random.default_rng(2))
    a, b, c = (SamplingBackend(seed=s, dtype=C128, device="cpu").sample_state(
        st, 1000, 5) for s in (3, 3, 4))
    assert a == b and a != c
    assert sum(a.values()) == 1000
    qc = Circuit(3)
    qc.x(0)
    tape = compile_tape(qc)
    one = sv_core.apply_tape(sv_core.zero_state(3, C128), tape.kinds,
                             tape.q0, tape.q1, tape.angles)
    sampler = SamplingBackend(dtype=C128, device="cpu")
    assert sampler.sample_state(one, 50, 3) == {"001": 50}


def test_sampler_distribution():
    """65536 draws from a random 4-qubit state: the total-variation
    distance to |psi|^2 is within 0.02 (its mean is about 0.004, its
    standard deviation about 0.001)."""
    n, shots = 4, 65536
    st = _state(n, np.random.default_rng(5))
    counts = SamplingBackend(seed=0, dtype=C128, device="cpu").sample_state(
        st, shots, n)
    p = sv_core.probabilities(st).numpy()
    q = np.zeros(2 ** n)
    for key, c in counts.items():
        q[int(key, 2)] = c / shots
    assert 0.5 * np.abs(p - q).sum() < 0.02


def _compilers(n=3, seed=4):
    """The same target circuit and one inserted dressed-CNOT layer in both
    packages, on statevector backends in float64."""
    rng = np.random.default_rng(seed)
    jt = j_random_circuit(n, 12, rng)
    tt = random_circuit(n, 12, np.random.default_rng(seed))
    jc = JAdaptCompiler(jt, backend=JSVBackend())
    tc = AdaptCompiler(tt, backend=SVBackend(dtype=C128, device="cpu"))
    for comp, layer, add in ((jc, jans.thinly_dressed_cnot(), jadd),
                             (tc, ans.thinly_dressed_cnot(), add_to_circuit)):
        for instr in layer.data:
            instr.label = instr.name
        at = comp.variational_circuit_range()[1]
        add(comp.full_circuit, layer, at, qubit_subset=[0, 2])
        comp._invalidate_current()
    return jc, tc


def test_host_probe_loop_matches_jax():
    """find_best_angle and replace_with_best_1q_gate on each rotation of
    the inserted layer, against the JAX package's: angles and costs to
    1e-10."""
    jc, tc = _compilers()
    start, end = tc.variational_circuit_range()
    assert (start, end) == jc.variational_circuit_range()
    for i in range(start, end):
        if not tc.full_circuit.data[i].is_supported_1q_gate():
            continue
        ta, tcost = tc.minimizer.find_best_angle(i, "ry")
        ja, jcost = jc.minimizer.find_best_angle(i, "ry")
        assert abs(ta - ja) < 1e-10 and abs(tcost - jcost) < 1e-10
        tbest = tc.minimizer.replace_with_best_1q_gate(i)
        jbest = jc.minimizer.replace_with_best_1q_gate(i)
        assert abs(tbest - jbest) < 1e-10
        assert tc.full_circuit.data[i].name == jc.full_circuit.data[i].name
        assert abs(tc.full_circuit.data[i].params[0]
                   - jc.full_circuit.data[i].params[0]) < 1e-10


def test_sampling_backend_takes_the_host_loop():
    """No sweep engine: Rotoselect runs the host probe loop, each probe a
    shot-based cost."""
    qc = random_circuit(2, 6, np.random.default_rng(13))
    backend = SamplingBackend(shots=256, dtype=C128, device="cpu")
    comp = AdaptCompiler(qc, backend=backend, execute_kwargs={"shots": 128},
                         adapt_config=AdaptConfig(max_layers=1))
    assert comp.backend.sweep_engine() is None
    # execute_kwargs' shots (8192 when absent) overrule the backend's, as in
    # the JAX package
    assert backend.shots == 128
    assert comp.full_circuit.num_clbits == 2
    res = comp.compile()
    assert res.cost_evaluations > 7
    assert res.exact_overlap == "Not computable without SV backend"


def test_sampling_compile_reaches_the_jax_bound():
    """The JAX package's own sampling case (tests/test_adapt_compiler.py
    test_sampling_backend): 4096 shots, sufficient_cost 0.05, at most 10
    layers; the exact overlap of the result exceeds 0.85."""
    qc = random_circuit(2, 6, np.random.default_rng(13))
    comp = AdaptCompiler(qc, backend=SamplingBackend(shots=4096, device="cpu"),
                         adapt_config=AdaptConfig(sufficient_cost=0.05,
                                                  max_layers=10))
    res = comp.compile()
    tt = compile_tape(make_quantum_only_circuit(qc))
    ts = compile_tape(make_quantum_only_circuit(res.circuit))
    a = sv_core.apply_tape(sv_core.zero_state(2, C128), tt.kinds, tt.q0,
                           tt.q1, tt.angles)
    b = sv_core.apply_tape(sv_core.zero_state(2, C128), ts.kinds, ts.q0,
                           ts.q1, ts.angles)
    assert abs(complex(sv_core.overlap(a, b))) ** 2 > 0.85


def test_run_circuit_and_pauli_expectation_match_jax():
    """Statevector runs equal the JAX package's; sampled runs repeat with
    the backend's seed (the JAX package seeds them from Python's
    per-process string hash); <H> of a Pauli sum on a statevector backend
    equals the JAX package's."""
    rng = np.random.default_rng(6)
    jqc = j_random_circuit(3, 10, rng)
    tqc = random_circuit(3, 10, np.random.default_rng(6))
    sv = running.run_circuit_without_transpilation(
        tqc, SVBackend(dtype=C128, device="cpu"), return_statevector=True)
    ref = jrunning.run_circuit_without_transpilation(
        jqc, JSVBackend(), return_statevector=True)
    np.testing.assert_allclose(sv, ref, atol=TOL)
    c1 = running.run_circuit_without_transpilation(
        tqc, SamplingBackend(seed=1, device="cpu"),
        execute_kwargs={"shots": 500})
    c2 = running.run_circuit_without_transpilation(
        tqc, SamplingBackend(seed=1, device="cpu"),
        execute_kwargs={"shots": 500})
    assert c1 == c2 and sum(c1.values()) == 500
    op = {"XZI": 0.5, "IYY": -0.3, "ZZZ": 0.2, "III": 0.1}
    out = pauli_ops.expectation_value_of_pauli_operator(
        tqc, op, SVBackend(dtype=C128, device="cpu"))
    ref = jpauli.expectation_value_of_pauli_operator(jqc, op, JSVBackend())
    assert abs(out - ref) < 1e-9


def test_concurrence_lower_bound_protocol_matches_jax():
    """The two-copy protocol on an exact backend (no draws): 1e-10."""
    rng = np.random.default_rng(7)
    jqc = j_random_circuit(3, 10, rng)
    tqc = random_circuit(3, 10, np.random.default_rng(7))
    for a, b in [(0, 1), (0, 2)]:
        out = em.measure_concurrence_lower_bound(
            tqc, a, b, SVBackend(dtype=C128, device="cpu"))
        ref = jem.measure_concurrence_lower_bound(jqc, a, b, JSVBackend())
        assert abs(out - ref) < 1e-10


def _bell():
    qc = Circuit(2)
    qc.h(0)
    qc.cx(0, 1)
    return qc


def test_circuit_tomography_runs_under_the_noise_model():
    """Deviation from the JAX package, which measures the noiseless state
    whatever the noise model: the 9 tomography circuits of a Bell pair run
    under strong amplitude damping lose most of its concurrence."""
    backend = SamplingBackend(shots=4096, seed=0, dtype=C128,
                              device="cpu")
    clean = em.perform_quantum_tomography(_bell(), 0, 1, backend)
    noise = running.create_noisemodel(1e-4, 1e-4, log_fidelities=False)
    noisy = em.perform_quantum_tomography(
        _bell(), 0, 1, backend, execute_kwargs={"noise_model": noise})
    assert em.concurrence(clean) > 0.9
    assert em.concurrence(noisy) < 0.5


def test_sampling_rdms_are_simulated_tomography_of_the_exact_rdms():
    """SamplingBackend.all_pair_rdms draws its tomography from host_rng:
    with the same seed it equals sample_tomography_rdm of the statevector
    backend's exact RDMs."""
    st = _state(3, np.random.default_rng(8))
    pairs = [(0, 1), (1, 2)]
    out = SamplingBackend(shots=1024, seed=9, dtype=C128,
                          device="cpu").all_pair_rdms(
        st, pairs)
    exact = SVBackend(dtype=C128, device="cpu").all_pair_rdms(st, pairs)
    rng = np.random.default_rng(9)
    for o, e in zip(out, exact):
        np.testing.assert_allclose(o, em.sample_tomography_rdm(e, 1024, rng),
                                   atol=TOL)
    # and the exact ones are the JAX engine's
    v = st.numpy()
    ref = jsv.all_pair_rdms(jcplx.from_np(v, jnp.float64),
                            jnp.asarray(pairs, jnp.int32))
    np.testing.assert_allclose(np.stack(exact), jcplx.to_np(ref), atol=TOL)
