"""Checkpoints, compile_in_parts and compile_with_chi_schedule in the port,
case for case with tests/test_features.py:26-136 and :305-458, on the CPU
in complex128; where a run is deterministic on a tie-free target (brickwall
pairs, or ISL without ties) its pair history must equal the JAX package's.
The MPS compiles here run on the native eigensolver (cplx.verification_eigh):
these tests hold the features, the eigensolver kernels' plain versions have
their own files, and their Python loops would take minutes here."""

import os
import pickle
import time

import numpy as np
import pytest
import torch

import adaptaqc_tpu as jport

import adaptaqc_tpu_torch as port
from adaptaqc_tpu_torch.backends import mps_core
from adaptaqc_tpu_torch.circuits import operations as co
from adaptaqc_tpu_torch.circuits.tape import compile_tape
from adaptaqc_tpu_torch.compilers.approximate_compiler import \
    ApproximateCompiler
from adaptaqc_tpu_torch.io import checkpoint as ckpt
from adaptaqc_tpu_torch.ops import cplx

from reference_sim import simulate
from test_torch_full_cost_sweep import random_circuit

torch.set_num_threads(1)
C128 = torch.complex128
KW = dict(device="cpu", dtype=C128)
SUFFICIENT = 1e-2


@pytest.fixture(autouse=True)
def native_eigh():
    with cplx.verification_eigh():
        yield


def sv():
    return port.SVBackend(**KW)


def mps(**kw):
    return port.MPSBackend(**kw, **KW)


def both(n, depth, seed):
    return (random_circuit(jport.Circuit, n, depth,
                           np.random.default_rng(seed)),
            random_circuit(port.Circuit, n, depth,
                           np.random.default_rng(seed)))


def true_overlap(jqc, solution):
    """|<target|solution>|^2 on exact statevectors (the port's solution is
    rebuilt gate by gate in the JAX package's IR for the dense oracle)."""
    jsol = jport.Circuit(solution.num_qubits)
    for instr in co.make_quantum_only_circuit(solution).data:
        getattr(jsol, instr.name)(*instr.params, *instr.qubits)
    return abs(np.vdot(simulate(jqc), simulate(jsol))) ** 2


def test_checkpoint_and_resume(tmp_path):
    jqc, qc = both(3, 12, 21)
    ckpt_dir = str(tmp_path / "ckpt")
    compiler = port.AdaptCompiler(
        qc, backend=sv(), adapt_config=port.AdaptConfig(max_layers=2))
    compiler.compile(checkpoint_every=1, checkpoint_dir=ckpt_dir)
    files = sorted(os.listdir(ckpt_dir))
    assert len(files) >= 1
    with open(os.path.join(ckpt_dir, files[0]), "rb") as f:
        resumed = pickle.load(f)
    assert resumed.resume_from_layer == 1
    assert resumed.backend.device.type == "cpu"
    assert resumed.backend.dtype == C128
    resumed.adapt_config.max_layers = 100
    result2 = resumed.compile()
    assert result2.overlap > 1 - SUFFICIENT
    assert true_overlap(jqc, result2.circuit) > 1 - 3 * SUFFICIENT


def test_checkpoint_delete_prev(tmp_path):
    _, qc = both(3, 12, 22)
    ckpt_dir = str(tmp_path / "ckpt2")
    compiler = port.AdaptCompiler(
        qc, backend=sv(), adapt_config=port.AdaptConfig(max_layers=3))
    compiler.compile(checkpoint_every=1, checkpoint_dir=ckpt_dir,
                     delete_prev_chkpt=True)
    files = [f for f in os.listdir(ckpt_dir) if f.endswith(".pkl")]
    assert len(files) <= 2


@pytest.mark.parametrize("local", [False, True])
def test_mps_checkpoint_resume_equals_straight_run(tmp_path, local):
    """On the MPS backend (the absorbed prefix and the target are engine
    MPS, saved in the Qiskit format): a run resumed from its layer-1
    checkpoint gives the straight run's pair history and, to 1e-6, its
    costs. The checkpoint also loads onto a named device."""
    _, qc = both(4, 16, 27)
    cfg = dict(method="brickwall", max_layers=4, sufficient_cost=1e-9,
               local_window_layers=2, global_polish_frequency=2)

    def build():
        return port.AdaptCompiler(
            qc, backend=mps(max_chi=4),
            adapt_config=port.AdaptConfig(**cfg),
            coupling_map=[(0, 1), (1, 2), (2, 3)], optimise_local_cost=local)
    straight = build().compile()
    d = str(tmp_path / "ck")
    build().compile(checkpoint_every=1, checkpoint_dir=d)
    resumed = ckpt.load(os.path.join(d, "1.pkl"), device="cpu")
    assert resumed.resume_from_layer == 2
    assert isinstance(resumed.full_circuit.data[0].payload, mps_core.MPS)
    assert resumed.full_circuit.data[0].payload.dtype == C128
    result = resumed.compile()
    assert result.qubit_pair_history == straight.qubit_pair_history
    np.testing.assert_allclose(result.global_cost_history,
                               straight.global_cost_history, atol=1e-6)
    assert result.time_taken >= resumed.prev_checkpoint_time_taken


def test_checkpoint_stores_the_backend_by_its_arguments():
    _, qc = both(3, 6, 2)
    for backend in (sv(), mps(max_chi=4, truncation_threshold=1e-9),
                    port.SamplingBackend(shots=128, seed=3, **KW),
                    port.CenterMPSBackend(chi=4, cutoff=1e-11, **KW)):
        comp = port.AdaptCompiler(qc, backend=backend)
        back = pickle.loads(pickle.dumps(comp))
        assert type(back.backend) is type(backend)
        for attr in ("device", "dtype", "max_chi", "truncation_threshold",
                     "shots", "seed", "chi", "cutoff"):
            if hasattr(backend, attr):
                assert getattr(back.backend, attr) == getattr(backend, attr)
        assert back._prefix_cache is None and back.minimizer is not None


def test_compile_in_parts():
    jqc, qc = both(3, 14, 23)
    result = port.AdaptCompiler(qc, backend=sv()).compile_in_parts(
        max_depth_per_block=5)
    assert isinstance(result, port.CompileInPartsResult)
    assert result.overlap > 1 - 5e-2
    assert len(result.individual_results) >= 2
    assert abs(true_overlap(jqc, result.circuit) - result.overlap) < 1e-8


def test_compile_in_parts_pair_history_matches_jax():
    """Brickwall ladders are deterministic: the same parts, with the same
    pair histories, in both packages."""
    out = {}
    for name, pkg, backend in (("jax", jport, jport.SVBackend()),
                               ("torch", port, sv())):
        qc = random_circuit(pkg.Circuit, 3, 14, np.random.default_rng(23))
        comp = pkg.AdaptCompiler(
            qc, backend=backend,
            adapt_config=pkg.AdaptConfig(method="brickwall", max_layers=6))
        out[name] = comp.compile_in_parts(max_depth_per_block=5)
    assert len(out["torch"].individual_results) == len(
        out["jax"].individual_results)
    for rt, rj in zip(out["torch"].individual_results,
                      out["jax"].individual_results):
        assert rt.qubit_pair_history == rj.qubit_pair_history
    # part 0 is the same trajectory: its sweeps run the same cycles
    first_t = out["torch"].individual_results[0]
    first_j = out["jax"].individual_results[0]
    assert first_t.cost_evaluations == first_j.cost_evaluations
    assert abs(first_t.overlap - first_j.overlap) < 1e-10
    # part 0 ends with Rotoselect ties: gates that act on |0> up to a phase,
    # where rx(0) and rz(pi) give one cost and the last bit of rounding picks
    # (rz in the JAX package, rx here). The carried solutions then differ by
    # phase gates that no longer commute with part 1's new layers, so part 1
    # follows another trajectory (its sweeps stop after other cycle counts:
    # 1108 against 2704 evaluations) to overlaps 1.2e-3 apart
    for rt, rj in zip(out["torch"].individual_results[1:],
                      out["jax"].individual_results[1:]):
        assert abs(rt.overlap - rj.overlap) < 2e-3
    assert abs(out["torch"].overlap - out["jax"].overlap) < 2e-3


def _bell_pairs(cls):
    # two Bell pairs across the middle cut: chi = 4 with four equal Schmidt
    # values, so a working cap of 2 pins the fidelity near 0.5
    qc = cls(4)
    qc.h(0)
    qc.h(1)
    qc.cx(0, 2)
    qc.cx(1, 3)
    return qc


def test_compile_with_chi_schedule_escalates_past_binding_cap():
    compiler = port.AdaptCompiler(
        _bell_pairs(port.Circuit), backend=mps(max_chi=2),
        adapt_config=port.AdaptConfig(max_layers=40, sufficient_cost=1e-2))
    result = compiler.compile_with_chi_schedule(chis=(2, 4))
    assert result.overlap > 1 - 1e-2
    assert [chi for chi, _ in result.chi_schedule] == [2, 4]
    assert result.cost_evaluations > 0
    assert result.independent_overlap > 1 - 1e-2
    assert true_overlap(_bell_pairs(jport.Circuit), result.circuit) > 1 - 3e-2


def test_chi_schedule_stage_backends_inherit_device_and_dtype(monkeypatch):
    seen = []
    orig = port.AdaptCompiler.compile

    def spy(self, *a, **kw):
        seen.append((self.backend.max_chi, self.backend.device,
                     self.backend.dtype, self.backend.truncation_threshold))
        return orig(self, *a, **kw)

    monkeypatch.setattr(port.AdaptCompiler, "compile", spy)
    compiler = port.AdaptCompiler(
        _bell_pairs(port.Circuit),
        backend=mps(max_chi=2, truncation_threshold=1e-12),
        adapt_config=port.AdaptConfig(max_layers=3, sufficient_cost=1e-2))
    compiler.compile_with_chi_schedule(chis=(2, 4))
    assert seen == [(2, torch.device("cpu"), C128, 1e-12),
                    (4, torch.device("cpu"), C128, 1e-12)]


def test_compile_with_chi_schedule_early_exit():
    _, qc = both(3, 12, 24)
    compiler = port.AdaptCompiler(
        qc, backend=mps(max_chi=8),
        adapt_config=port.AdaptConfig(max_layers=60, sufficient_cost=1e-2))
    result = compiler.compile_with_chi_schedule(chis=(8, 16, 32))
    assert result.overlap > 1 - 1e-2
    assert len(result.chi_schedule) == 1


def test_compile_with_chi_schedule_requires_mps_backend():
    _, qc = both(3, 12, 25)
    with pytest.raises(ValueError):
        port.AdaptCompiler(qc, backend=sv()).compile_with_chi_schedule(
            chis=(2, 4))


def test_compile_in_parts_mps_backend_with_starting_circuit():
    rng = np.random.default_rng(29)
    n = 4
    qc, jqc = port.Circuit(n), jport.Circuit(n)
    prep = port.Circuit(n)
    for q in range(1, n, 2):
        prep.x(q)
        qc.x(q)
        jqc.x(q)
    for _ in range(3):
        for q in range(n):
            a = float(rng.uniform(-1.0, 1.0))
            qc.ry(a, q)
            jqc.ry(a, q)
        for q in range(n - 1):
            qc.cx(q, q + 1)
            jqc.cx(q, q + 1)
    fired = []
    compiler = port.AdaptCompiler(qc, backend=mps(), starting_circuit=prep)
    result = compiler.compile_in_parts(
        max_depth_per_block=4,
        part_callback=lambda i, r, c: fired.append((i, r.overlap, len(c))))
    assert len(result.individual_results) >= 2
    assert [f[0] for f in fired] == list(range(len(fired)))
    assert result.overlap > 1 - 5e-2
    assert true_overlap(jqc, result.circuit) > 1 - 5e-2


def test_compile_in_parts_rejects_mps_target():
    qmps = mps_core.to_qiskit_mps(mps_core.zero_mps(3, 2, C128))
    compiler = port.AdaptCompiler(qmps, backend=mps())
    with pytest.raises(ValueError, match="gate-level"):
        compiler.compile_in_parts(max_depth_per_block=4)


def test_compile_with_chi_schedule_engine_mps_target():
    """An engine-MPS target is pinned to its padded chi: each stage brings
    it to its own working chi (mps_core.regauge)."""
    def build(cls):
        qc = cls(4)
        qc.h(0)
        qc.cx(0, 1)
        qc.ry(0.4, 2)
        qc.cx(2, 3)
        return qc
    tape = compile_tape(build(port.Circuit))
    mps_target = mps_core.apply_tape(mps_core.zero_mps(4, 2, C128),
                                     tape.kinds, tape.q0, tape.q1,
                                     tape.angles, 1e-16)
    compiler = port.AdaptCompiler(
        mps_target, backend=mps(max_chi=2),
        adapt_config=port.AdaptConfig(max_layers=40, sufficient_cost=1e-2))
    result = compiler.compile_with_chi_schedule(chis=(2, 4))
    assert result.overlap > 1 - 1e-2
    assert result.independent_overlap is not None
    assert true_overlap(build(jport.Circuit), result.circuit) > 1 - 3e-2


def test_compile_with_chi_schedule_accounting(monkeypatch):
    """time_taken includes the between-stage _overlap_at_chi walls and the
    result always carries independent_overlap, on the early exit and at
    the end of the schedule. Stage compiles and the verifier are stubs."""
    class FakeResult:
        def __init__(self, overlap, evals, t):
            self.overlap = overlap
            self.cost_evaluations = evals
            self.time_taken = t
            self.circuit = port.Circuit(4)
            self.independent_overlap = None

    qc = port.Circuit(4)
    qc.h(0)
    qc.cx(0, 1)

    def run(stage_overlaps, verify_value, sufficient):
        results = [FakeResult(ov, 100, 1.0) for ov in stage_overlaps]
        calls = {"compile": 0, "verify": 0}

        def fake_compile(self, initial_ansatz=None, **kw):
            r = results[calls["compile"]]
            calls["compile"] += 1
            return r

        def fake_verify(self, circuit, chi):
            calls["verify"] += 1
            time.sleep(0.05)
            return verify_value

        monkeypatch.setattr(port.AdaptCompiler, "compile", fake_compile)
        monkeypatch.setattr(port.AdaptCompiler, "_overlap_at_chi",
                            fake_verify)
        compiler = port.AdaptCompiler.__new__(port.AdaptCompiler)
        compiler.backend = mps(max_chi=8)
        compiler.target = qc
        compiler.full_circuit = qc
        compiler.starting_circuit = None
        compiler.adapt_config = port.AdaptConfig(sufficient_cost=sufficient)
        compiler._ctor_kwargs = dict(adapt_config=compiler.adapt_config)
        return compiler.compile_with_chi_schedule(chis=(8, 16)), calls

    res, calls = run([0.999, 0.999], 0.999, sufficient=1e-2)
    assert res.independent_overlap == 0.999
    assert res.cost_evaluations == 100
    assert res.time_taken >= 1.0 + 0.05
    assert len(res.chi_schedule) == 1
    res, calls = run([0.5, 0.6], 0.61, sufficient=1e-3)
    assert res.independent_overlap == 0.61
    assert res.cost_evaluations == 200
    assert res.time_taken >= 2.0 + 0.05
    assert [c for c, _ in res.chi_schedule] == [8, 16]


def test_compile_in_parts_resume_matches_straight_run():
    _, qc = both(3, 14, 31)
    saved = {}

    def grab(i, part_result, circuit):
        saved[i] = (part_result.overlap, circuit.copy())

    straight = port.AdaptCompiler(qc, backend=sv()).compile_in_parts(
        max_depth_per_block=5, part_callback=grab)
    n_parts = len(straight.individual_results)
    assert set(saved) == set(range(n_parts))
    assert straight.overlap > 1 - 5e-2
    resumed = port.AdaptCompiler(qc, backend=sv()).compile_in_parts(
        max_depth_per_block=5, initial_ansatz=saved[0][1], start_part=1)
    assert len(resumed.individual_results) == n_parts - 1
    assert resumed.overlap > 1 - 5e-2


def test_compile_in_parts_resume_validates_args():
    _, qc = both(3, 14, 33)
    compiler = port.AdaptCompiler(qc, backend=sv())
    with pytest.raises(ValueError, match="initial_ansatz"):
        compiler.compile_in_parts(max_depth_per_block=3, start_part=1)
    with pytest.raises(ValueError, match="out of range"):
        compiler.compile_in_parts(max_depth_per_block=5, start_part=99,
                                  initial_ansatz=qc)


def _ladder_target(n, layers, seed):
    rng = np.random.default_rng(seed)
    target = port.Circuit(n)
    for _ in range(layers):
        for q in range(n):
            target.ry(float(rng.uniform(-1.2, 1.2)), q)
        for q in range(n - 1):
            target.cx(q, q + 1)
    return target


def test_compile_in_parts_preserves_carried_fidelity():
    np.random.seed(3)
    compiler = port.AdaptCompiler(_ladder_target(3, 6, 9), backend=sv())
    result = compiler.compile_in_parts(max_depth_per_block=4,
                                       reoptimise_carried="never")
    assert len(result.individual_results) >= 2
    for r in result.individual_results:
        assert r.overlap > 0.95, [x.overlap
                                  for x in result.individual_results]
    assert result.overlap > 0.97


def test_compile_in_parts_auto_widens_on_miss(monkeypatch):
    np.random.seed(4)
    compiler = port.AdaptCompiler(_ladder_target(2, 4, 11), backend=sv())
    calls = []
    orig = port.AdaptCompiler.compile

    def spy(self, *a, **kw):
        calls.append(kw.get("optimise_initial_ansatz", True))
        return orig(self, *a, **kw)

    monkeypatch.setattr(port.AdaptCompiler, "compile", spy)
    # a bar no part can reach: every frozen attempt misses
    monkeypatch.setattr(ApproximateCompiler, "_part_overlap_target",
                        lambda self: 2.0)
    result = compiler.compile_in_parts(max_depth_per_block=3,
                                       reoptimise_carried="auto")
    assert False in calls and calls.count(True) >= 1
    assert result.overlap > 0.9


def test_ranges_and_part_target():
    _, qc = both(3, 8, 5)
    prep = port.Circuit(3)
    prep.x(1)
    comp = port.AdaptCompiler(qc, backend=sv(), starting_circuit=prep)
    end = len(comp.full_circuit.data)
    assert comp.ansatz_range() == (comp.lhs_gate_count, end)
    assert comp._starting_circuit_range() == (end - 1, end)
    assert abs(comp._part_overlap_target()
               - (1 - comp.adapt_config.sufficient_cost)) < 1e-15
