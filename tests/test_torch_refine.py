"""The port's warm-start refinement scripts and record tools
(adaptaqc_tpu_torch/workloads/{refine,spin_refine,reverify_spin,
summarize}.py), the compiler's profile_dir and unknown keywords, and
_common.compile_with_recovery's compile keywords, against the JAX
package's benchmarks/ scripts in float64 on the CPU (JAX at x64, the port
in complex128).

Every records file, circuit and checkpoint lives in pytest's tmp_path:
the JAX scripts' HERE / RESULTS / CIRCUITS_DIR are monkeypatched there, so
nothing is written under benchmarks/ or local/. Tolerances: record
look-ups and summaries equal; true_overlap 1e-10; a refinement's pair
history equal and its overlap 1e-6. MPS compiles run under
cplx.verification_eigh() (the plain K2-K4 are Python loops)."""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

import adaptaqc_tpu_torch as port
from adaptaqc_tpu_torch.circuits import operations as co
from adaptaqc_tpu_torch.io import checkpoint
from adaptaqc_tpu_torch.ops import cplx
from adaptaqc_tpu_torch.utils import targets
from adaptaqc_tpu_torch.workloads import (_common, random_mps, refine,
                                          reverify_spin, spin_refine,
                                          summarize)

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks")
sys.path.insert(0, BENCH)
import _common as j_common  # noqa: E402
import refine as j_refine  # noqa: E402
import reverify_spin as j_reverify  # noqa: E402
import spin_chain as j_spin_chain  # noqa: E402
import spin_refine as j_spin_refine  # noqa: E402
import summarize as j_summarize  # noqa: E402

torch.set_num_threads(1)
C128 = torch.complex128


def _write(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


_RMPS = [
    {"seed": 1, "source": "synthetic n=6", "overlap": 0.41,
     "overlap_chi64_check": 0.43, "circuit": "circuits/a.qasm.gz",
     "wall_seconds": 5.0},
    {"seed": 1, "source": "synthetic n=6", "overlap": 0.45,
     "overlap_chi64_check": None, "circuit": "circuits/b.qasm.gz"},
    {"seed": 1, "source": "synthetic n=6", "overlap": 0.99,
     "circuit": None},
    {"seed": 2, "source": "synthetic n=6", "overlap": 0.2,
     "circuit": "circuits/c.qasm.gz"},
    {"seed": 1, "source": "reference paper target", "overlap": 0.995,
     "overlap_chi64_check": 0.993, "circuit": "circuits/d.qasm.gz",
     "wall_seconds": 30.0},
    {"seed": 3, "source": "reference paper target", "overlap": 0.97,
     "circuit": "circuits/e.qasm.gz", "wall_seconds": 7.0},
    {"seed": 3, "source": "reference paper target", "overlap": 0.992,
     "circuit": "circuits/f.qasm.gz", "wall_seconds": 9.0},
    {"seed": 4, "source": "synthetic n=50", "overlap": 0.9951,
     "overlap_chi64_check": 0.9949, "circuit": "circuits/g.qasm.gz",
     "wall_seconds": 3.0},
    {"seed": 5, "source": "synthetic n=50", "overlap": 0.6,
     "circuit": "circuits/h.qasm.gz"},
]
_SPIN = [
    {"workload": "xxz_trotter_n6_steps1_dt0.2", "overlap": 0.95,
     "circuit": "circuits/s1.qasm.gz", "solution_2q_depth": 9,
     "raw_2q_depth": 12, "sm_raw": 0.5, "sm_solution": 0.49,
     "wall_seconds": 4.0, "solution_2q_gates": 20},
    {"workload": "xxz_trotter_n6_steps1_dt0.2", "overlap": 0.97,
     "independent_engine_overlap": 0.96, "circuit": "circuits/s2.qasm.gz",
     "solution_2q_depth": 10, "sm_raw": 0.5, "sm_solution": None},
    {"workload": "xxz_trotter_n6_steps2_dt0.25", "overlap": 0.9,
     "independent_overlap": 0.91, "circuit": "circuits/s3.qasm.gz",
     "parts": [0.99, 0.98]},
    {"workload": "xxz_trotter_n6_steps2_dt0.25", "overlap": None,
     "circuit": None},
]


@pytest.fixture
def records(tmp_path, monkeypatch):
    """The same two records files for both packages' scripts."""
    _write(tmp_path / "results_random_mps.jsonl", _RMPS)
    _write(tmp_path / "results_spin_chain.jsonl", _SPIN)
    monkeypatch.setattr(j_refine, "RESULTS",
                        str(tmp_path / "results_random_mps.jsonl"))
    monkeypatch.setattr(j_spin_refine, "RESULTS",
                        str(tmp_path / "results_spin_chain.jsonl"))
    monkeypatch.setattr(j_summarize, "HERE", str(tmp_path))
    monkeypatch.setattr(summarize, "HERE", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("seed,source", [
    (1, "synthetic n=6"), (2, "synthetic n=6"),
    (1, "reference paper target"), (3, "reference paper target")])
def test_best_saved_circuit_matches_jax(records, seed, source):
    """refine.best_saved_circuit picks the JAX script's record: equal."""
    path = str(records / "results_random_mps.jsonl")
    assert (refine.best_saved_circuit(seed, source, path)
            == j_refine.best_saved_circuit(seed, source))
    with pytest.raises(SystemExit):
        refine.best_saved_circuit(9, source, path)


@pytest.mark.parametrize("pinned", [None, "circuits/s1.qasm.gz"])
def test_spin_best_saved_circuit_matches_jax(records, monkeypatch, pinned):
    """spin_refine.best_saved_circuit, with and without SPIN_REFINE_FROM:
    equal to the JAX script's."""
    if pinned:
        monkeypatch.setenv("SPIN_REFINE_FROM", pinned)
    else:
        monkeypatch.delenv("SPIN_REFINE_FROM", raising=False)
    path = str(records / "results_spin_chain.jsonl")
    for w in ("xxz_trotter_n6_steps1_dt0.2", "xxz_trotter_n6_steps2_dt0.25"):
        if pinned and w.endswith("0.25"):
            with pytest.raises(SystemExit):
                spin_refine.best_saved_circuit(w, path)
            continue
        assert (spin_refine.best_saved_circuit(w, path)
                == j_spin_refine.best_saved_circuit(w))


def test_summaries_match_jax(records):
    """random_mps_summary (on the JAX script's source), spin_chain_summary
    and fig5_cz_table (no paper CSV on either side) equal the JAX
    script's; the port's default source counts its own n=50 records."""
    assert (summarize.random_mps_summary("reference paper target")
            == j_summarize.random_mps_summary())
    assert summarize.spin_chain_summary() == j_summarize.spin_chain_summary()
    assert summarize.fig5_cz_table() == j_summarize.fig5_cz_table()
    own = summarize.random_mps_summary()
    assert own["runs"] == 2 and own["converged"] == [4]
    assert own["outstanding"] == {5: 0.6}
    assert own["fastest_wall_s"] == {"seed": 4, "wall_seconds": 3.0}


def test_summarize_main(records, capsys):
    """--markdown prints the tallies and tables; --converged-seed exits 0
    for a converged seed and 1 otherwise; the JSON form parses."""
    d = str(records)
    summarize.main(["--results-dir", d, "--markdown"])
    out = capsys.readouterr().out
    assert "1/2 distinct seeds" in out and "xxz_trotter_n6_steps1" in out
    summarize.main(["--results-dir", d])
    assert json.loads(capsys.readouterr().out)["random_mps"]["runs"] == 2
    for seed, code in ((4, 0), (5, 1)):
        with pytest.raises(SystemExit) as exc:
            summarize.main(["--results-dir", d, "--converged-seed",
                            str(seed)])
        assert exc.value.code == code


def _spin_solution(n, jax_side=False):
    """A solution near the n-qubit, 1-step, dt = 0.2 spin-chain target:
    the Neel state, one Trotter step of dt = 0.15 and an ry(0.1)."""
    if jax_side:
        from adaptaqc_tpu.circuits import operations as jco
        qc = j_spin_chain.neel_circuit(n)
        jco.add_to_circuit(qc, j_spin_chain.trotter_circuit(n, 1, 0.15))
    else:
        qc = targets.neel_circuit(n)
        co.add_to_circuit(qc, targets.trotter_circuit(n, 1, 0.15))
    qc.ry(0.1, 0)
    return qc


def test_true_overlap_matches_jax():
    """reverify_spin.true_overlap of a solution against the Neel + Trotter
    target, n = 6, chi = 8: the JAX script's to 1e-10."""
    from adaptaqc_tpu.circuits import operations as jco
    n, chi = 6, 8
    jtarget = j_spin_chain.neel_circuit(n)
    jco.add_to_circuit(jtarget, j_spin_chain.trotter_circuit(n, 1, 0.2))
    ref = j_reverify.true_overlap(jtarget, _spin_solution(n, True), chi)
    target, _, _ = spin_refine.spin_target(n, 1, 0.2)
    out = reverify_spin.true_overlap(target, _spin_solution(n), chi,
                                     device="cpu", dtype=C128)
    assert abs(out - ref) < 1e-10 and 0.5 < out < 1


def test_reverify_record(tmp_path, monkeypatch):
    """reverify's record: the JAX script's keys and the port's device;
    independent_overlap is a copy of overlap, as the JAX script writes
    it."""
    monkeypatch.setenv("REVERIFY_CHI", "8")
    monkeypatch.chdir(tmp_path)
    path = _common.save_circuit(_spin_solution(6), "sol",
                                str(tmp_path))
    rec = reverify_spin.reverify(os.path.basename(path), 6, 1, 0.2, "cpu",
                                 C128)
    keys = _record_keys("reverify_spin.py")
    assert keys | {"device"} == set(rec)
    assert rec["independent_overlap"] == rec["overlap"]
    assert rec["workload"] == "xxz_trotter_n6_steps1_dt0.2"
    assert rec["reverified_from"] == rec["circuit"]


def _record_keys(filename):
    import ast
    with open(os.path.join(BENCH, filename)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "record"
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no record in {filename}")


def test_refine_matches_the_jax_script(tmp_path, monkeypatch):
    """A warm-start refinement at n = 6 on the CPU: a 2-layer compile of
    random_target(1) is recorded, then both packages' refine scripts
    (REFINE_N branch, REFINE_CHI 8, 2 more layers) start from its saved
    circuit: the same pair history, each layer's cost and the overlap
    within 1e-6, and the port's record has the JAX script's keys and its
    own (device, stopped, launches).

    Two layers, because the two trajectories part by rounding: absorbing
    the warm start truncates its bonds through each package's eigensolver
    (the JAX package embeds the complex Gram in a real one on the CPU, the
    port solves it in complex128), the first layer's costs then agree to
    about 1e-11, and the gap grows about a thousandfold a layer (a third
    layer: 2e-4)."""
    n = 6
    monkeypatch.setenv("RMPS_CHI", "4")
    monkeypatch.setenv("RMPS_LAYERS", "2")
    monkeypatch.setenv("RMPS_CROSS_ENGINE", "0")
    monkeypatch.setenv("REFINE_CHI", "8")
    monkeypatch.setenv("REFINE_LAYERS", "2")
    monkeypatch.setenv("REFINE_N", str(n))
    monkeypatch.setenv("BENCH_CHECKPOINT_EVERY", "0")
    # each package appends its record to its own copy of the records
    results = str(tmp_path / "results_random_mps.jsonl")
    j_results = str(tmp_path / "j_results_random_mps.jsonl")
    with cplx.verification_eigh():
        first = random_mps.run_seed(1, n, "cpu", checkpoint_every=0,
                                    circuits_dir=str(tmp_path / "circuits"))
    for path in (results, j_results):
        _common.append_record(path, json.dumps(first))

    monkeypatch.setattr(j_refine, "RESULTS", j_results)
    monkeypatch.setattr(j_refine, "HERE", str(tmp_path))
    monkeypatch.setattr(j_common, "CIRCUITS_DIR", str(tmp_path / "circuits"))
    captured = {}
    real = j_refine.compile_with_recovery

    def capture(*args, **kwargs):
        captured["out"] = real(*args, **kwargs)
        return captured["out"]

    monkeypatch.setattr(j_refine, "compile_with_recovery", capture)
    j_refine.refine(1)
    jres = captured["out"][1]

    with cplx.verification_eigh():
        rec, tres = refine.refine(1, n, "cpu", results, checkpoint_every=0,
                                  circuits_dir=str(tmp_path / "circuits"),
                                  dtype=C128)
    assert tres.qubit_pair_history == jres.qubit_pair_history
    assert len(tres.qubit_pair_history) == 2
    np.testing.assert_allclose(tres.global_cost_history,
                               jres.global_cost_history, atol=1e-6)
    assert abs(tres.overlap - jres.overlap) < 1e-6
    assert tres.global_cost_history[0] <= 1 - first["overlap"] + 1e-6
    own = {"device", "stopped", "launches"}
    assert _record_keys("refine.py") | own == set(rec)
    assert rec["source"] == f"synthetic n={n}"
    assert rec["refined_from"] == first["circuit"]
    assert os.path.exists(rec["circuit"])
    assert not glob.glob(os.path.join(BENCH, "circuits",
                                      "seed_1_refined_*"))


def test_spin_refine_runs_from_the_saved_circuit(tmp_path, monkeypatch):
    """spin_refine at n = 6, 2 Trotter steps of dt = 0.2, SPIN_REFINE_CHI
    8, 2 more layers, from a recorded one-step solution (dt = 0.4, which
    the warm start's Rotosolve cannot turn into the target): its record
    has the JAX script's keys and the port's own, and its first layer's
    cost is no worse than the saved circuit's (1e-6). SPIN_REFINE_LOCAL
    and SPIN_REFINE_SOFTEN together are refused."""
    n, steps, dt = 6, 2, 0.2
    monkeypatch.setenv("SPIN_REFINE_CHI", "8")
    monkeypatch.setenv("SPIN_REFINE_LAYERS", "2")
    monkeypatch.setenv("SPIN_CROSS_ENGINE", "0")
    results = str(tmp_path / "results_spin_chain.jsonl")
    solution = targets.neel_circuit(n)
    co.add_to_circuit(solution, targets.trotter_circuit(n, 1, 2 * dt))
    target, _, _ = spin_refine.spin_target(n, steps, dt)
    saved_ov = reverify_spin.true_overlap(target, solution, 8, "cpu", C128)
    assert saved_ov < 0.99
    path = _common.save_circuit(solution, "sol", str(tmp_path / "circuits"))
    _common.append_record(results, json.dumps(
        {"workload": f"xxz_trotter_n{n}_steps{steps}_dt{dt}",
         "overlap": saved_ov, "circuit": path}))
    with cplx.verification_eigh():
        rec, res = spin_refine.refine(n, steps, dt, "cpu", results,
                                      checkpoint_every=0,
                                      circuits_dir=str(tmp_path / "c2"),
                                      dtype=C128)
    own = {"device", "stopped", "launches"}
    assert _record_keys("spin_refine.py") | own == set(rec)
    assert rec["refined_from"] == path and rec["layers"] == 2
    assert res.global_cost_history[0] <= 1 - saved_ov + 1e-6
    monkeypatch.setenv("SPIN_REFINE_LOCAL", "1")
    monkeypatch.setenv("SPIN_REFINE_SOFTEN", "1")
    with pytest.raises(ValueError, match="soften_global_cost"):
        spin_refine.refine(n, steps, dt, "cpu", results, checkpoint_every=0,
                           dtype=C128)


class _StubCompiler:
    def __init__(self, resume_from_layer=None):
        self.resume_from_layer = resume_from_layer
        self.kwargs = None

    def compile(self, **kwargs):
        self.kwargs = kwargs
        return type("R", (), {"stop_reason": "sufficient_cost"})()


def test_compile_with_recovery_passes_compile_kwargs(tmp_path, monkeypatch):
    """A fresh start passes initial_ansatz on (with and without
    checkpoints); a resume from a checkpoint drops it, as the JAX script's
    does."""
    ansatz = object()
    for every in (0, 3):
        stub = _StubCompiler()
        _common.compile_with_recovery(stub, str(tmp_path / f"ck{every}"),
                                      every, initial_ansatz=ansatz)
        assert stub.kwargs["initial_ansatz"] is ansatz
    ckdir = tmp_path / "ck"
    ckdir.mkdir()
    (ckdir / "4.pkl").write_bytes(b"")
    resumed = _StubCompiler(resume_from_layer=5)
    monkeypatch.setattr(checkpoint, "load", lambda path, device=None: resumed)
    comp, result = _common.compile_with_recovery(
        _StubCompiler(), str(ckdir), 3, initial_ansatz=ansatz)
    assert comp is resumed and "initial_ansatz" not in resumed.kwargs
    assert resumed.kwargs["checkpoint_every"] == 3
    assert result.resumed_from_layer == 5


def _readme():
    qc = port.Circuit(3)
    qc.rx(1.23, 0)
    qc.cx(0, 1)
    qc.ry(2.5, 1)
    return qc


def test_profile_dir_writes_a_trace_and_unknown_keywords_pass(tmp_path):
    """AdaptCompiler(profile_dir=...) writes a torch.profiler trace of the
    compile there (JSON with trace events); an unknown keyword is accepted
    and ignored, as the JAX package does; the stage clones get no
    profile_dir."""
    backend = port.SVBackend(dtype=C128, device="cpu")
    comp = port.AdaptCompiler(_readme(), backend=backend,
                              profile_dir=str(tmp_path / "prof"),
                              adapt_config=port.AdaptConfig(max_layers=1),
                              some_future_option=True)
    result = comp.compile()
    traces = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]
    assert np.isfinite(result.overlap)
    assert comp._clone_with_target(_readme()).profile_dir is None
    plain = port.AdaptCompiler(_readme(), backend=backend, unknown=1,
                               adapt_config=port.AdaptConfig(max_layers=1))
    assert abs(plain.compile().overlap - result.overlap) < 1e-10


def test_checkpoint_from_before_the_switches_loads(tmp_path, monkeypatch):
    """A checkpoint without profile_dir, the minimiser's zigzag flag and
    zigzag in _ctor_kwargs (as written before those existed) loads, and
    its compile resumes to the straight run's pair history."""
    qmps = targets.random_target(1, n=4, dtype=C128, device="cpu")

    def compiler():
        return port.AdaptCompiler(
            qmps, backend=port.MPSBackend(max_chi=4, dtype=C128,
                                          device="cpu"),
            adapt_config=port.AdaptConfig(method="basic", max_layers=3))

    with cplx.verification_eigh():
        straight = compiler().compile()
    real = checkpoint.encode_compiler_state

    def old_format(comp):
        state = real(comp)
        state.pop("profile_dir")
        state.pop("minimizer_zigzag")
        state["_ctor_kwargs"] = {k: v for k, v in
                                 state["_ctor_kwargs"].items()
                                 if k != "zigzag"}
        return state

    monkeypatch.setattr(checkpoint, "encode_compiler_state", old_format)
    with cplx.verification_eigh():
        compiler().compile(checkpoint_every=1, checkpoint_dir=str(tmp_path))
    monkeypatch.setattr(checkpoint, "encode_compiler_state", real)
    loaded = checkpoint.load(str(tmp_path / "1.pkl"))
    assert loaded.profile_dir is None and loaded.minimizer.zigzag is False
    with cplx.verification_eigh():
        resumed = loaded.compile()
    assert resumed.qubit_pair_history == straight.qubit_pair_history


@pytest.mark.parametrize("call", [
    lambda: refine.main(["1", "--n", "4"]),
    lambda: spin_refine.main(["4"]),
    lambda: reverify_spin.main(["x.qasm.gz", "4"]),
], ids=["refine", "spin_refine", "reverify_spin"])
def test_refinement_scripts_default_to_the_card_and_raise_without_one(
        call, monkeypatch):
    """No fallback: with no CUDA device every new script raises before it
    reads a record."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
