"""The port's utility modules (utils/{utilityfunctions,hamiltonians,
gate_tomography,fixed_ansatz_circuits,tenpy_interop}.py) against the JAX
package's, on the same inputs: the cases of tests/test_utils.py,
tests/test_util_parity.py and tests/test_tenpy_interop.py. The NumPy
modules agree to 1e-12; what goes through an MPS engine (complex128 against
x64) to 1e-10."""

import inspect

import numpy as np
import pytest
import torch

from adaptaqc_tpu.circuits.circuit import Circuit as JCircuit
from adaptaqc_tpu.utils import fixed_ansatz_circuits as jfa
from adaptaqc_tpu.utils import gate_tomography as jgt
from adaptaqc_tpu.utils import hamiltonians as jham
from adaptaqc_tpu.utils import tenpy_interop as jti
from adaptaqc_tpu.utils import utilityfunctions as juf

import adaptaqc_tpu_torch.utils as port_utils
from adaptaqc_tpu_torch.backends import mps_core
from adaptaqc_tpu_torch.backends.backend import MPSBackend
from adaptaqc_tpu_torch.circuits.circuit import Circuit
from adaptaqc_tpu_torch.utils import constants as vc
from adaptaqc_tpu_torch.utils import fixed_ansatz_circuits as fa
from adaptaqc_tpu_torch.utils import gate_tomography as gt
from adaptaqc_tpu_torch.utils import hamiltonians as ham
from adaptaqc_tpu_torch.utils import tenpy_interop as ti
from adaptaqc_tpu_torch.utils import utilityfunctions as uf

from reference_sim import simulate
from test_sv_core import random_circuit
from test_tenpy_interop import FakeTenpyMPS, _random_vidal

C128 = torch.complex128
TOL = 1e-12


def _gates(qc):
    return [(i.name, tuple(i.qubits), tuple(float(p) for p in i.params),
             i.label) for i in qc.data]


def _same_circuit(port_qc, jax_qc):
    a, b = _gates(port_qc), _gates(jax_qc)
    assert [g[:2] + g[3:] for g in a] == [g[:2] + g[3:] for g in b]
    for ga, gb in zip(a, b):
        np.testing.assert_allclose(ga[2], gb[2], atol=TOL, rtol=0)


def _same_terms(port_ham, jax_ham):
    assert set(port_ham) == set(jax_ham)
    for term in jax_ham:
        assert abs(port_ham[term] - jax_ham[term]) < TOL


def test_utils_package_imports_the_reference_submodules():
    for name in ("ansatzes", "constants", "entanglement_measures",
                 "fixed_ansatz_circuits", "gate_tomography", "hamiltonians"):
        assert inspect.ismodule(getattr(port_utils, name))


# ------------------------------------------------------------ gate_tomography
def test_gate_tomography_matches_jax():
    """tests/test_utils.py's case: the cost of two rotation angles of a
    real circuit on the 3^2 grid, transformed and reconstructed."""
    rng = np.random.default_rng(1)
    base = random_circuit(2, 6, rng)
    base.ry(0.0, 0)
    base.rx(0.0, 1)
    i0, i1 = len(base.data) - 2, len(base.data) - 1

    def cost(a0, a1):
        qc = base.copy()
        qc.data[i0].params = (a0,)
        qc.data[i1].params = (a1,)
        return 1 - abs(simulate(qc)[0]) ** 2

    grid = gt.angle_sets_to_evaluate(2)
    np.testing.assert_array_equal(grid, jgt.angle_sets_to_evaluate(2))
    measurements = [cost(*row) for row in grid]
    coeffs = gt.measurements_to_zero_delta_pi_bases(measurements)
    np.testing.assert_allclose(
        coeffs, jgt.measurements_to_zero_delta_pi_bases(measurements),
        atol=TOL, rtol=0)
    for a0, a1 in [(0.3, -1.2), (2.0, 0.7), (-2.5, 3.0)]:
        out = gt.reconstructed_cost([a0, a1], coeffs)
        assert abs(out - jgt.reconstructed_cost([a0, a1], coeffs)) < TOL
        assert abs(out - cost(a0, a1)) < 1e-8
    three = np.random.default_rng(2).uniform(size=27)
    assert abs(gt.reconstructed_cost([0.1, 0.2, -0.4], three)
               - jgt.reconstructed_cost([0.1, 0.2, -0.4], three)) < TOL


# --------------------------------------------------------------- hamiltonians
@pytest.mark.parametrize("kwargs", [
    dict(n=2, jx=1.0), dict(n=3, jx=0.5, jz=0.3, hz=0.1),
    dict(n=4, jx=0.7, jy=0.2, jz=-0.4, hx=0.3, hy=-0.1, periodic_bc=True)])
def test_heisenberg_hamiltonian_matches_jax(kwargs):
    port_h = ham.heisenberg_hamiltonian(**kwargs)
    _same_terms(port_h, jham.heisenberg_hamiltonian(**kwargs))
    n = kwargs["n"]
    m = ham.hamiltonian_matrix(port_h, n)
    np.testing.assert_allclose(m, jham.hamiltonian_matrix(port_h, n),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(m, m.conj().T, atol=TOL)
    energy, wf = ham.calculate_ground_state(port_h, n)
    jenergy, jwf = jham.calculate_ground_state(port_h, n)
    assert abs(energy - jenergy) < TOL
    np.testing.assert_allclose(m @ wf, energy * wf, atol=1e-10)
    if kwargs == dict(n=2, jx=1.0):
        assert abs(energy - (-1.0)) < 1e-10  # H = -X0 X1


def test_anderson_hamiltonian_matches_jax():
    port_h = ham.anderson_model_qubit_hamiltonian()
    _same_terms(port_h, jham.anderson_model_qubit_hamiltonian())
    m = ham.hamiltonian_matrix(port_h, 4)
    np.testing.assert_allclose(m, m.conj().T, atol=1e-10)
    assert any("Z" in t for t in port_h)
    kw = dict(v_i=np.array([0.0, 0.8, 0.3]),
              epsilon_i=np.array([1.0, 2.0, -0.5]), u=3, mu=0.2)
    _same_terms(ham.anderson_model_qubit_hamiltonian(**kw),
                jham.anderson_model_qubit_hamiltonian(**kw))
    with pytest.raises(ValueError):
        ham.anderson_model_qubit_hamiltonian(v_i=np.array([0, 1, 2]))


# ------------------------------------------------------ fixed ansatz circuits
def test_fixed_ansatz_factories_match_jax():
    """tests/test_utils.py's cases, gate for gate against the JAX
    package's circuits."""
    qc = fa.hardware_efficient_circuit(3, "rxry", 2)
    _same_circuit(qc, jfa.hardware_efficient_circuit(3, "rxry", 2))
    assert qc.num_2q_gates() == 4
    assert sum(1 for i in qc.data if len(i.qubits) == 1) == 12
    kw = dict(gates_to_fix={0: 0.5}, gates_to_remove=[1])
    fixed = fa.hardware_efficient_circuit(3, "ry", 1, **kw)
    _same_circuit(fixed, jfa.hardware_efficient_circuit(3, "ry", 1, **kw))
    assert fixed.data[0].label == vc.FIXED_GATE_LABEL
    assert fixed.data[0].params[0] == 0.5
    cz = fa.hardware_efficient_circuit(4, "rzrx", 1, entangling_gate="cz",
                                       coupling_map=vc.coupling_map_ladder(4))
    _same_circuit(cz, jfa.hardware_efficient_circuit(
        4, "rzrx", 1, entangling_gate="cz",
        coupling_map=vc.coupling_map_ladder(4)))
    npa = fa.number_preserving_ansatz(4, 1)
    _same_circuit(npa, jfa.number_preserving_ansatz(4, 1))
    from adaptaqc_tpu_torch.circuits import operations as co
    angles = co.find_angles_in_circuit(npa)
    co.update_angles_in_circuit(npa, [0.3] * len(angles))
    dep = [i for i in npa.data if i.label and "@" in i.label]
    assert dep and all(abs(i.params[0] + 0.3) < 1e-12 for i in dep)
    ca = fa.custom_ansatz(4, Circuit(2).cx(0, 1), 2)
    _same_circuit(ca, jfa.custom_ansatz(4, JCircuit(2).cx(0, 1), 2))
    assert ca.num_2q_gates() == 2 * len(vc.coupling_map_ladder(4))


# ---------------------------------------------------------- utilityfunctions
def test_utilityfunctions_counts_match_jax():
    sv = np.zeros(4)
    sv[0] = np.sqrt(0.25)
    sv[2] = np.sqrt(0.75)
    counts = uf.counts_data_from_statevector(sv, num_shots=1000)
    assert counts == juf.counts_data_from_statevector(sv, num_shots=1000)
    assert abs(counts["00"] - 250) <= 1 and abs(counts["10"] - 750) <= 1
    evs = uf.expectation_value_of_qubits(counts)
    np.testing.assert_allclose(evs, juf.expectation_value_of_qubits(counts),
                               atol=TOL, rtol=0)
    assert abs(evs[0] - 1.0) < 1e-2 and abs(evs[1] - (-0.5)) < 1e-2
    rng = np.random.default_rng(3)
    vec = rng.normal(size=8) + 1j * rng.normal(size=8)
    vec /= np.linalg.norm(vec)
    np.testing.assert_allclose(uf.expectation_value_of_qubits(vec),
                               juf.expectation_value_of_qubits(vec),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(uf.statevector_from_counts_data(counts),
                               juf.statevector_from_counts_data(counts),
                               atol=TOL, rtol=0)
    with pytest.raises(ValueError):
        uf._ev_from_counts(3, counts, 2)


def test_sinusoid_and_degeneracy_helpers_match_jax():
    for args in [(0.3, 0.7, 0.1), (1.0, 0.0, 0.5), (0.2, 0.2, 0.9)]:
        for name in ("minimum_of_sinusoidal", "amplitude_of_sinusoidal"):
            np.testing.assert_allclose(getattr(uf, name)(*args),
                                       getattr(juf, name)(*args), atol=TOL,
                                       rtol=0)
        np.testing.assert_allclose(uf.derivative_of_sinusoidal(0.4, *args),
                                   juf.derivative_of_sinusoidal(0.4, *args),
                                   atol=TOL, rtol=0)
    items = [(0, 1), (1, 2), (0, 1), (2, 3), (1, 2), (0, 1)]
    assert (uf.get_distinct_items_and_degeneracies(items)
            == juf.get_distinct_items_and_degeneracies(items)
            == ([(0, 1), (1, 2), (2, 3)], [3, 2, 1]))


def _depth_case(cls, case):
    qc = cls(4)
    for gate in case:
        getattr(qc, gate[0])(*gate[1:])
    return qc


@pytest.mark.parametrize("case, depth", [
    ([], 0), ([("rx", 0.3, 0), ("ry", 0.2, 1)], 0), ([("cx", 0, 1)], 1),
    ([("cx", 0, 1), ("cx", 1, 2)], 2), ([("cx", 0, 1), ("cx", 2, 3)], 1),
    ([("rx", 0.2, 0), ("cx", 0, 1), ("ry", 0.4, 1)], 1),
    ([("cx", 0, 1), ("cx", 1, 2), ("cx", 2, 3)], 3)])
def test_multi_qubit_gate_depth_matches_jax(case, depth):
    """tests/test_util_parity.py's depth cases through the re-export."""
    assert (uf.multi_qubit_gate_depth(_depth_case(Circuit, case))
            == juf.multi_qubit_gate_depth(_depth_case(JCircuit, case))
            == depth)


def test_find_rotation_indices_matches_jax():
    def build(cls):
        qc = cls(2)
        qc.rx(0.1, 0)
        qc.cx(0, 1)
        qc.ry(0.2, 1)
        qc.cz(0, 1)
        qc.rz(0.3, 0)
        return qc
    for idx in ([0, 1, 2, 3, 4], [1, 3]):
        assert (uf.find_rotation_indices(build(Circuit), idx)
                == juf.find_rotation_indices(build(JCircuit), idx))
    assert uf.find_rotation_indices(build(Circuit), [0, 1, 2, 3, 4]) == \
        [0, 2, 4]
    cmap = [(0, 1), (1, 0), (1, 2)]
    assert (uf.remove_permutations_from_coupling_map(cmap)
            == juf.remove_permutations_from_coupling_map(cmap))


def _z_circuit(cls):
    qc = cls(3)
    qc.x(1)
    qc.h(2)
    qc.ry(0.7, 0)
    qc.cx(0, 2)
    return qc


def test_expectation_value_of_qubits_mps_matches_jax():
    """<Z_i> through the MPS engine, complex128 against x64: 1e-10; the
    zero and flipped-qubit cases of tests/test_util_parity.py."""
    backend = MPSBackend(device="cpu", dtype=C128)
    out = uf.expectation_value_of_qubits_mps(_z_circuit(Circuit), backend)
    ref = juf.expectation_value_of_qubits_mps(_z_circuit(JCircuit))
    np.testing.assert_allclose(out, ref, atol=1e-10, rtol=0)
    flipped = Circuit(3)
    flipped.x(1)
    np.testing.assert_allclose(
        uf.expectation_value_of_qubits_mps(Circuit(3), backend), [1, 1, 1],
        atol=1e-10)
    np.testing.assert_allclose(
        uf.expectation_value_of_qubits_mps(flipped, backend), [1, -1, 1],
        atol=1e-10)


def test_mps_to_statevector_matches_jax():
    gammas, lambdas, vec = _random_vidal(4, seed=3)
    qmps = ([(g[0], g[1]) for g in gammas], lambdas)
    out = uf.mps_to_statevector(qmps, device="cpu")
    np.testing.assert_allclose(out, juf.mps_to_statevector(qmps), atol=1e-12)
    np.testing.assert_allclose(out, vec, atol=1e-10)
    state = mps_core.from_qiskit_mps(qmps, 4, dtype=C128)
    np.testing.assert_allclose(uf.mps_to_statevector(state), vec,
                               atol=1e-10)


def test_chi_1_mps_to_circuit_matches_jax():
    rng = np.random.default_rng(13)
    amps = rng.normal(size=(3, 2)) + 1j * rng.normal(size=(3, 2))
    amps /= np.linalg.norm(amps, axis=1, keepdims=True)
    qmps = ([(a[0].reshape(1, 1), a[1].reshape(1, 1)) for a in amps],
            [np.ones(1), np.ones(1)])
    qc = uf.chi_1_mps_to_circuit(qmps)
    _same_circuit(qc, juf.chi_1_mps_to_circuit(qmps))
    state = mps_core.from_qiskit_mps(qmps, 2, dtype=C128)
    _same_circuit(uf.chi_1_mps_to_circuit(state), qc)
    gammas, lambdas, _ = _random_vidal(4, seed=3)
    with pytest.raises(Exception, match="bond dimension 1"):
        uf.chi_1_mps_to_circuit(([(g[0], g[1]) for g in gammas], lambdas))


def test_state_building_utilities_default_to_the_card(monkeypatch):
    """A function that builds an engine state takes a device, "cuda" by
    default, and without a card raises rather than use the CPU."""
    for fn in (uf.expectation_value_of_qubits_mps, uf.mps_to_statevector):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    gammas, lambdas, _ = _random_vidal(3, seed=5)
    with pytest.raises((RuntimeError, AssertionError)):
        uf.mps_to_statevector(([(g[0], g[1]) for g in gammas], lambdas))
    with pytest.raises((RuntimeError, AssertionError)):
        uf.expectation_value_of_qubits_mps(Circuit(2))


# --------------------------------------------------------------- tenpy interop
@pytest.mark.parametrize("flipped", [[False] * 4, [True] * 4,
                                     [True, False, True, False]])
def test_tenpy_to_qiskit_matches_jax(flipped):
    gammas, lambdas, vec = _random_vidal(4, seed=3)
    out = ti.tenpy_to_qiskit_mps(FakeTenpyMPS(gammas, lambdas, flipped))
    ref = jti.tenpy_to_qiskit_mps(FakeTenpyMPS(gammas, lambdas, flipped))
    for (a0, a1), (b0, b1) in zip(out[0], ref[0]):
        np.testing.assert_allclose(a0, b0, atol=TOL, rtol=0)
        np.testing.assert_allclose(a1, b1, atol=TOL, rtol=0)
    for a, b in zip(out[1], ref[1]):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    state = mps_core.from_qiskit_mps(out, 4, dtype=C128)
    assert np.abs(mps_core.to_dense(state) - vec).max() < 1e-10


def test_unsorted_bond_spectrum_gets_sorted_as_in_jax():
    gammas, lambdas, vec = _random_vidal(4, seed=9, shuffle_bond=1)
    out = ti.tenpy_to_qiskit_mps(FakeTenpyMPS(gammas, lambdas, [False] * 4))
    ref = jti.tenpy_to_qiskit_mps(FakeTenpyMPS(gammas, lambdas, [False] * 4))
    for a, b in zip(out[1], ref[1]):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
        assert np.all(np.diff(a) <= 1e-14)
    state = mps_core.from_qiskit_mps(out, 4, dtype=C128)
    assert np.abs(mps_core.to_dense(state) - vec).max() < 1e-10


def test_tenpy_mps_to_statevector_matches_jax():
    gammas, lambdas, vec = _random_vidal(5, seed=11)
    for flipped in ([False] * 5, [True, False, False, True, True]):
        fake = FakeTenpyMPS(gammas, lambdas, flipped)
        out = ti.tenpy_mps_to_statevector(fake)
        np.testing.assert_allclose(out, jti.tenpy_mps_to_statevector(fake),
                                   atol=TOL, rtol=0)
        assert np.abs(out - vec).max() < 1e-10
        np.testing.assert_array_equal(ti.check_flipped_basis_states(fake),
                                      flipped)


def test_tenpy_chi1_mps_to_circuit_matches_jax():
    rng = np.random.default_rng(13)
    n = 3
    amps = rng.normal(size=(n, 2)) + 1j * rng.normal(size=(n, 2))
    amps /= np.linalg.norm(amps, axis=1, keepdims=True)
    gammas = [amps[i].reshape(2, 1, 1) for i in range(n)]
    lambdas = [np.ones(1) for _ in range(n - 1)]
    for flipped in ([False] * n, [True, False, True]):
        fake = FakeTenpyMPS(gammas, lambdas, flipped)
        _same_circuit(ti.tenpy_chi_1_mps_to_circuit(fake),
                      jti.tenpy_chi_1_mps_to_circuit(fake))
    entangled, lams, _ = _random_vidal(4, seed=3)
    with pytest.raises(Exception, match="bond dimension 1"):
        ti.tenpy_chi_1_mps_to_circuit(FakeTenpyMPS(entangled, lams,
                                                   [False] * 4))


def test_qiskit_to_tenpy_requires_tenpy_as_in_jax():
    gammas, lambdas, _ = _random_vidal(3, seed=5)
    try:
        import tenpy  # noqa: F401
    except ModuleNotFoundError:
        for module in (ti, jti):
            with pytest.raises(ImportError, match="tenpy"):
                module.qiskit_to_tenpy_mps((gammas, lambdas))
    else:  # pragma: no cover - tenpy is not installed here
        assert ti.qiskit_to_tenpy_mps((gammas, lambdas)).L == 3


def test_b_tensor_preprocessing_matches_jax():
    gammas, lambdas, vec = _random_vidal(4, seed=7)
    out = ti._qiskit_mps_to_b_tensors((gammas, lambdas))
    ref = jti._qiskit_mps_to_b_tensors((gammas, lambdas))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    acc = out[0][:, 0, :]
    for b in out[1:]:
        acc = np.einsum("...c,pcd->...pd", acc, b)
    sv = acc[..., 0].transpose(range(4)[::-1]).ravel()
    assert np.abs(sv - vec).max() < 1e-10
