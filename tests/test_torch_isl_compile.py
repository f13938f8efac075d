"""The port's default compile path, AdaptCompiler(target) on SVBackend with
the ISL heuristic, and the other pair heuristics, against the JAX package
in float64 on the CPU (n <= 6).

Where the JAX package's choice is deterministic and free of ties, the port
must make the same one: the same pairs (ISL, basic, brickwall, random under
the same np.random seed), the same method history on the expectation
fallback, the same history lengths with the initial single-qubit layer.
Outcomes are held to overlap > 0.99 with exact_overlap within 1e-5."""

import numpy as np
import pytest
import torch

import adaptaqc_tpu as jport
from adaptaqc_tpu.circuits import operations as jco
from adaptaqc_tpu.compilers import approximate_compiler as japprox

import adaptaqc_tpu_torch as port
from adaptaqc_tpu_torch.backends import mps_core, sv_core
from adaptaqc_tpu_torch.circuits import operations as co
from adaptaqc_tpu_torch.circuits.tape import compile_tape
from adaptaqc_tpu_torch.compilers import approximate_compiler as approx

torch.set_num_threads(1)
C128 = torch.complex128


def _sv():
    return port.SVBackend(dtype=C128, device="cpu")


def _readme(pkg):
    qc = pkg.Circuit(3)
    qc.rx(1.23, 0)
    qc.cx(0, 1)
    qc.ry(2.5, 1)
    qc.rx(-1.6, 2)
    qc.ccx(2, 1, 0)
    return qc


def _dense(qc, n):
    tape = compile_tape(co.make_quantum_only_circuit(qc))
    return sv_core.apply_tape(sv_core.zero_state(n, C128), tape.kinds,
                              tape.q0, tape.q1, tape.angles)


def test_default_compiler_is_statevector_isl():
    """With no backend the compile runs on SVBackend() with ISL, on the
    card: building the compiler touches no device."""
    comp = port.AdaptCompiler(_readme(port))
    assert isinstance(comp.backend, port.SVBackend)
    assert comp.backend.device == torch.device("cuda")
    assert comp.adapt_config.method == "ISL"
    assert len(comp.coupling_map) == 3


def test_isl_compile_matches_jax():
    """A random 4-qubit state (create_random_initial_state_circuit, seed
    0): the same first three pairs as the JAX compile, both overlaps above
    0.99, and the port's exact_overlap within 1e-5 of its overlap."""
    jres = jport.AdaptCompiler(
        jco.create_random_initial_state_circuit(4, seed=0),
        backend=jport.SVBackend()).compile()
    tres = port.AdaptCompiler(
        co.create_random_initial_state_circuit(4, seed=0),
        backend=_sv()).compile()
    assert tres.qubit_pair_history[:3] == jres.qubit_pair_history[:3]
    assert set(tres.method_history) == {"ISL"}
    assert jres.overlap > 0.99 and tres.overlap > 0.99
    assert abs(tres.exact_overlap - tres.overlap) < 1e-5
    assert len(tres.entanglement_measures_history) == len(
        tres.qubit_pair_history)


def test_readme_compile_and_exact_overlap():
    """The README example on the default path: overlap > 0.99, and the
    exact overlap is the dense |<target|result>|^2."""
    qc = _readme(port)
    res = port.AdaptCompiler(qc, backend=_sv()).compile()
    dense = abs(complex(sv_core.overlap(_dense(qc, 3),
                                        _dense(res.circuit, 3)))) ** 2
    assert res.overlap > 0.99
    assert abs(res.exact_overlap - dense) < 1e-12
    assert abs(res.exact_overlap - res.overlap) < 1e-5


def _product_target(pkg):
    qc = pkg.Circuit(4)
    for q, a in enumerate((2.1, 0.4, 2.9, 1.3)):
        qc.ry(a, q)
    qc.x(1)
    return qc


def test_expectation_fallback_matches_jax():
    """A product-state target has no entanglement on any pair, so ISL
    falls back to the expectation heuristic: the same method history and
    pairs as the JAX compile."""
    cfg = dict(max_layers=4)
    jres = jport.AdaptCompiler(_product_target(jport),
                               backend=jport.SVBackend(),
                               adapt_config=jport.AdaptConfig(**cfg)).compile()
    tres = port.AdaptCompiler(_product_target(port), backend=_sv(),
                              adapt_config=port.AdaptConfig(**cfg)).compile()
    assert "expectation" in jres.method_history
    assert tres.method_history == jres.method_history
    assert tres.qubit_pair_history == jres.qubit_pair_history
    for a, b in zip(tres.e_val_history, jres.e_val_history):
        if a is None:
            assert b is None
        else:
            np.testing.assert_allclose(a, b, atol=1e-10)


def _random_target(pkg, n=4, seed=3):
    rng = np.random.default_rng(seed)
    qc = pkg.Circuit(n)
    for _ in range(3):
        for q in range(n):
            qc.ry(float(rng.uniform(-3, 3)), q)
        for q in range(n - 1):
            qc.cx(q, q + 1)
    return qc


@pytest.mark.parametrize("method", ["basic", "brickwall", "random"])
def test_pair_sequences_match_jax(method):
    """The state-free heuristics pick the JAX package's pairs; random draws
    from the global np.random, seeded the same for both compiles."""
    cfg = dict(method=method, max_layers=5, cost_improvement_num_layers=100)
    np.random.seed(11)
    jres = jport.AdaptCompiler(_random_target(jport),
                               backend=jport.SVBackend(),
                               adapt_config=jport.AdaptConfig(**cfg)).compile()
    np.random.seed(11)
    tres = port.AdaptCompiler(_random_target(port), backend=_sv(),
                              adapt_config=port.AdaptConfig(**cfg)).compile()
    assert tres.qubit_pair_history == jres.qubit_pair_history
    assert tres.method_history == jres.method_history
    assert abs(tres.overlap - jres.overlap) < 1e-8


def test_initial_single_qubit_layer_matches_jax():
    cfg = dict(max_layers=4, cost_improvement_num_layers=100)
    jres = jport.AdaptCompiler(_random_target(jport),
                               backend=jport.SVBackend(),
                               adapt_config=jport.AdaptConfig(**cfg),
                               initial_single_qubit_layer=True).compile()
    tres = port.AdaptCompiler(_random_target(port), backend=_sv(),
                              adapt_config=port.AdaptConfig(**cfg),
                              initial_single_qubit_layer=True).compile()
    for name in ("qubit_pair_history", "method_history",
                 "entanglement_measures_history", "e_val_history",
                 "global_cost_history", "cnot_depth_history"):
        assert len(getattr(tres, name)) == len(getattr(jres, name)), name
    assert tres.qubit_pair_history[0] == (None, None)
    assert tres.qubit_pair_history[:3] == jres.qubit_pair_history[:3]


def test_isl_on_mps_backend():
    """ISL reads its RDMs from the MPS engine: the backend's per-pair RDMs
    equal the JAX MPSBackend's (1e-10, a descending pair included), and a
    compile of the README target on MPSBackend picks by ISL and converges
    with a verified overlap above 0.99."""
    n, chi = 5, 4
    qc_t, qc_j = _random_target(port, n, 5), _random_target(jport, n, 5)
    pairs = [(0, 1), (3, 2), (1, 4)]
    jb = jport.MPSBackend(max_chi=chi)
    tb = port.MPSBackend(max_chi=chi, dtype=C128, device="cpu")
    ref = jb.all_pair_rdms(jb.mps_from_compiler_target(qc_j), pairs)
    out = tb.all_pair_rdms(tb.mps_from_compiler_target(qc_t), pairs)
    np.testing.assert_allclose(np.stack(out), np.stack(ref), atol=1e-10)
    res = port.AdaptCompiler(
        _readme(port),
        backend=port.MPSBackend(dtype=C128, device="cpu")).compile()
    assert set(res.method_history) <= {"ISL", "expectation"}
    assert "ISL" in res.method_history
    assert res.overlap > 0.99
    assert res.exact_overlap == "Not computable without SV backend"


def test_statevector_compile_skips_the_mps_epilogue():
    """The compile's epilogue reads MPS bond weights only on an MPS
    backend: a statevector compile reports no truncated weight and an
    exact overlap."""
    res = port.AdaptCompiler(_readme(port), backend=_sv(),
                             adapt_config=port.AdaptConfig(
                                 max_layers=1)).compile()
    assert res.mps_truncated_weight is None
    assert isinstance(res.exact_overlap, float)
    assert set(res.phase_timings) >= {"pair_selection", "verification"}


def test_verification_applies_only_on_mps():
    """The chi-doubled re-simulation verifies only the MPS engine's
    estimate, as in the JAX package (adapt_compiler.py:832-834)."""
    sv = port.AdaptCompiler(_readme(port), backend=_sv())
    mps = port.AdaptCompiler(_readme(port),
                             backend=port.MPSBackend(dtype=C128, device="cpu"))
    assert not sv._verification_applies()
    assert mps._verification_applies()
    assert sv._sufficient_cost_verified()


def test_overlap_between_circuits_matches_jax(monkeypatch):
    """Dense below DENSE_OVERLAP_MAX_QUBITS and MPS above it (the limit
    lowered to 2 for the second case): 1e-10 against the JAX package."""
    a_t, b_t = _random_target(port, 4, 1), _random_target(port, 4, 2)
    a_j, b_j = _random_target(jport, 4, 1), _random_target(jport, 4, 2)
    dense = approx.calculate_overlap_between_circuits(a_t, b_t, dtype=C128,
                                                   device="cpu")
    ref = japprox.calculate_overlap_between_circuits(a_j, b_j)
    assert abs(dense - ref) < 1e-10
    monkeypatch.setattr(approx, "DENSE_OVERLAP_MAX_QUBITS", 2)
    monkeypatch.setattr(japprox, "DENSE_OVERLAP_MAX_QUBITS", 2)
    via_mps = approx.calculate_overlap_between_circuits(a_t, b_t, mps_chi=4,
                                                        dtype=C128,
                                                        device="cpu")
    ref_mps = japprox.calculate_overlap_between_circuits(a_j, b_j,
                                                         mps_chi=4)
    assert abs(via_mps - ref_mps) < 1e-10
    assert abs(via_mps - dense) < 1e-10


def test_heuristic_and_backend_guards():
    """As in the JAX package: general_gradient needs the MPS backend and an
    MPS target needs an MPS backend; unknown methods raise."""
    with pytest.raises(ValueError):
        port.AdaptCompiler(_readme(port), backend=_sv(),
                           adapt_config=port.AdaptConfig(
                               method="general_gradient"))
    st = mps_core.zero_mps(3, 2, C128)
    with pytest.raises(ValueError):
        port.AdaptCompiler(st, backend=_sv())
    comp = port.AdaptCompiler(_readme(port), backend=_sv(),
                              adapt_config=port.AdaptConfig(method="nope"))
    with pytest.raises(ValueError):
        comp.compile()


def test_product_state_start_on_statevector_backend():
    """starting_circuit='tenpy_product_state' on SVBackend compresses the
    target through a default MPS backend, as the JAX package does: the
    start prepares a product state whose overlap with the target matches
    the JAX package's to 1e-8."""
    qc_t, qc_j = _random_target(port, 4, 9), _random_target(jport, 4, 9)
    tc = port.AdaptCompiler(qc_t, backend=_sv(),
                            starting_circuit="tenpy_product_state")
    jc = jport.AdaptCompiler(qc_j, backend=jport.SVBackend(),
                             starting_circuit="tenpy_product_state")
    target = _dense(qc_t, 4)

    def start_overlap(start):
        st = _dense(co.make_quantum_only_circuit(start), 4)
        return abs(complex(sv_core.overlap(st, target))) ** 2

    assert tc.rhs_gate_count == 12
    ours = start_overlap(tc.starting_circuit)
    assert abs(ours - start_overlap(_port_circuit(jc.starting_circuit))) < 1e-8
    assert ours > 0.05


def _port_circuit(jqc):
    """A JAX-package circuit rebuilt in the port through QASM."""
    from adaptaqc_tpu.circuits import qasm as jqasm
    from adaptaqc_tpu_torch.circuits import qasm
    return qasm.loads(jqasm.dumps(jqc))
