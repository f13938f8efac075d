"""The port's workload scripts (adaptaqc_tpu_torch/workloads) against the
JAX package's benchmarks/, in float64 on the CPU (JAX at x64, the port in
complex128): the random-MPS script's compile, its checkpoint and resume,
the spin-chain script's record and staggered magnetisation, entry() and
bench_sweep's count of evaluations.

The random-MPS script runs at the size of tests/test_torch_compile.py's
slice (n = 6, max_chi = 4, at most 8 layers). The port's compiles run on
the native eigensolver (cplx.verification_eigh): the plain K2-K4 are Python
loops, and these tests are about the scripts, not the eigensolver."""

import ast
import os
import sys

import numpy as np
import pytest
import torch

from adaptaqc_tpu_torch.backends import mps_core
from adaptaqc_tpu_torch.circuits import operations as co
from adaptaqc_tpu_torch.circuits.tape import compile_tape
from adaptaqc_tpu_torch.compilers import adapt_compiler
from adaptaqc_tpu_torch.ops import cplx
from adaptaqc_tpu_torch.utils import targets
from adaptaqc_tpu_torch.workloads import (_common, bench_sweep, entry,
                                          random_mps, spin_chain)

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks")
sys.path.insert(0, BENCH)
import random_mps as j_random_mps  # noqa: E402
import spin_chain as j_spin_chain  # noqa: E402

C128 = torch.complex128


def _reference_record_keys(filename):
    """The keys of the dict the JAX benchmark assigns to `record`."""
    with open(os.path.join(BENCH, filename)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "record"
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no record in {filename}")


def _port_compile(tmp_path, checkpoint_every=0, n=6):
    qmps = targets.random_target(1, n=n, dtype=C128, device="cpu")
    with cplx.verification_eigh():
        return random_mps.compile_target(
            qmps, max_chi=4, max_layers=8, device="cpu", dtype=C128,
            checkpoint_every=checkpoint_every,
            checkpoint_dir=str(tmp_path / "ck"))


def _resimulated_overlap(qmps, circuit, n, chi=8):
    tape = compile_tape(co.make_quantum_only_circuit(circuit))
    st = mps_core.apply_tape(mps_core.zero_mps(n, chi, C128), tape.kinds,
                             tape.q0, tape.q1, tape.angles, 1e-16,
                             eigh="native")
    tgt = mps_core.from_qiskit_mps(qmps, chi, dtype=C128)
    return abs(complex(mps_core.mps_dot(tgt, st))) ** 2


def test_random_mps_workload_matches_the_jax_benchmark(tmp_path, monkeypatch):
    """compile_target of both scripts at n = 6, max_chi = 4, 8 layers on
    the same target: the first two pair picks are equal (later picks may
    part on Rotoselect ties), both reach overlap > 0.99, and the port's
    returned circuit, re-simulated, gives its reported overlap to 1e-6."""
    monkeypatch.setenv("BENCH_CHECKPOINT_EVERY", "0")
    n = 6
    jres, _ = j_random_mps.compile_target(
        j_random_mps.random_target(1, n=n), max_chi=4, max_layers=8)
    tres, wall = _port_compile(tmp_path)
    assert tres.qubit_pair_history[:2] == jres.qubit_pair_history[:2]
    assert jres.overlap > 0.99 and tres.overlap > 0.99
    assert tres.stop_reason == "sufficient_cost" and wall > 0
    assert tres.resumed_from_layer is None
    qmps = targets.random_target(1, n=n, dtype=C128, device="cpu")
    assert abs(_resimulated_overlap(qmps, tres.circuit, n)
               - tres.overlap) < 1e-6


def test_random_mps_resume_gives_the_straight_run(tmp_path, monkeypatch):
    """A compile stopped by its deadline after 2 layers keeps its
    checkpoint; a second compile_target resumes from it at layer 2 and
    ends with the straight run's pair history and overlap (1e-10), and
    removes the checkpoint directory."""
    straight, _ = _port_compile(tmp_path / "straight")
    calls = [0]

    def after_two_layers():  # the deadline check runs once a layer
        calls[0] += 1
        return calls[0] >= 2

    monkeypatch.setattr(adapt_compiler, "_wall_deadline_passed",
                        after_two_layers)
    cut, _ = _port_compile(tmp_path, checkpoint_every=5)
    assert cut.stop_reason == "deadline"
    assert len(cut.qubit_pair_history) == 2
    ckdir = tmp_path / "ck"
    assert _common.newest_checkpoint(str(ckdir)).endswith("1.pkl")
    monkeypatch.setattr(adapt_compiler, "_wall_deadline_passed",
                        lambda: False)
    resumed, _ = _port_compile(tmp_path, checkpoint_every=5)
    assert resumed.resumed_from_layer == 2
    assert resumed.qubit_pair_history == straight.qubit_pair_history
    assert abs(resumed.overlap - straight.overlap) < 1e-10
    assert resumed.stop_reason == "sufficient_cost"
    assert not ckdir.exists()


def test_random_mps_record_has_the_reference_keys(tmp_path, monkeypatch):
    """run_seed's record holds every key of benchmarks/random_mps.py's
    record and the port's own; the chi=64 and center-gauge re-simulations
    agree with the compile's overlap (1e-5: complex64, 4 qubits)."""
    monkeypatch.setenv("RMPS_CHI", "4")
    monkeypatch.setenv("RMPS_LAYERS", "3")
    with cplx.verification_eigh():
        rec = random_mps.run_seed(1, 4, "cpu", checkpoint_every=0,
                                  circuits_dir=str(tmp_path))
    own = {"device", "stopped", "resumed_from_layer", "launches",
           "qubit_pair_history", "wall_seconds_total"}
    assert _reference_record_keys("random_mps.py") | own == set(rec)
    assert rec["source"] == "synthetic n=4" and rec["platform"] == "cpu"
    assert rec["working_chi"] == 4
    assert rec["launches"] == {"env_chain": 0, "tridiag": 0, "teig": 0,
                               "backtransform": 0}  # CPU: plain versions
    assert abs(rec["overlap_chi64_check"] - rec["overlap"]) < 1e-5
    assert abs(rec["independent_engine_overlap"] - rec["overlap"]) < 1e-5
    assert os.path.exists(rec["circuit"])


@pytest.mark.parametrize("zigzag", ["0", "1"])
def test_random_mps_record_source_and_zigzag(tmp_path, monkeypatch, zigzag):
    """The record's source is the JAX script's for a synthetic target
    ("synthetic n=<n>", which refine.py looks records up by), and its
    zigzag is the flag the minimiser ran under (ADAPTAQC_ZIGZAG), as
    benchmarks/random_mps.py writes them."""
    monkeypatch.setenv("RMPS_CHI", "4")
    monkeypatch.setenv("RMPS_LAYERS", "1")
    monkeypatch.setenv("RMPS_CROSS_ENGINE", "0")
    monkeypatch.setenv("ADAPTAQC_ZIGZAG", zigzag)
    with cplx.verification_eigh():
        rec = random_mps.run_seed(2, 4, "cpu", checkpoint_every=0,
                                  circuits_dir=str(tmp_path))
    assert rec["source"] == "synthetic n=4"
    assert rec["zigzag"] is (zigzag == "1")


def test_spin_chain_workload_record_and_magnetisation(tmp_path, monkeypatch):
    """The spin-chain script at n = 6, 1 Trotter step: the record holds
    every key of benchmarks/spin_chain.py's record and the port's own,
    and its staggered magnetisations equal the JAX package's at x64 to
    1e-10."""
    monkeypatch.setenv("SPIN_LAYERS", "2")
    monkeypatch.setenv("SPIN_CHI", "8")
    n, steps, dt = 6, 1, 0.25
    with cplx.verification_eigh():
        rec = spin_chain.run(n, steps, dt, device="cpu", checkpoint_every=0,
                             circuits_dir=str(tmp_path), dtype=C128)
    own = {"device", "stopped", "resumed_from_layer", "launches",
           "qubit_pair_history", "wall_seconds_total"}
    assert _reference_record_keys("spin_chain.py") | own == set(rec)
    assert rec["workload"] == "xxz_trotter_n6_steps1_dt0.25"
    assert rec["layers"] == 2 and rec["stopped"] == "max_layers"
    jtarget = j_spin_chain.neel_circuit(n)
    from adaptaqc_tpu.circuits import operations as jco
    jco.add_to_circuit(jtarget, j_spin_chain.trotter_circuit(n, steps, dt))
    assert abs(rec["sm_raw"]
               - j_spin_chain.staggered_magnetisation(jtarget)) < 1e-10
    import gzip
    from adaptaqc_tpu.circuits import qasm as jqasm
    with gzip.open(rec["circuit"], "rt") as f:
        jsolution = jqasm.loads(f.read())
    assert abs(rec["sm_solution"]
               - j_spin_chain.staggered_magnetisation(jsolution)) < 1e-10
    neel = targets.neel_circuit(n)  # Z = +1 on even, -1 on odd sites: SM 1
    assert abs(targets.staggered_magnetisation(neel, dtype=C128,
                                               device="cpu") - 1) < 1e-12


def test_entry_matches_graft_entry():
    """entry()'s cost of the 12-qubit, 24-deep tape equals the JAX
    package's __graft_entry__.entry() at x64: 1e-10."""
    sys.path.insert(0, os.path.dirname(BENCH))
    import __graft_entry__
    jfn, jargs = __graft_entry__.entry()
    fn, args = entry.entry(device="cpu", dtype=C128)
    assert args[0].device.type == "cpu" and args[0].dtype == C128
    np.testing.assert_array_equal(args[1], np.asarray(jargs[2]))
    assert abs(float(fn(*args)) - float(jfn(*jargs))) < 1e-10


def test_bench_sweep_counts_evaluations_as_bench_py():
    """bench_sweep at n = 8, chi = 4: 7 evaluations a probed rotation
    (bench.py's Rotoselect count), 48 probes in 12 dressed-CNOT layers,
    and iters sweeps timed."""
    rec = bench_sweep.run(n=8, chi=4, iters=2, device="cpu")
    assert rec["probes_per_sweep"] == 48
    assert rec["evals_per_sweep"] == 7 * rec["probes_per_sweep"]
    assert rec["evals_timed"] == 2 * rec["evals_per_sweep"]
    assert rec["evals_per_sec"] > 0 and np.isfinite(rec["cost"])
    assert rec["device"] == "cpu"


@pytest.mark.parametrize("call", [
    lambda: random_mps.main(["1", "--n", "4"]),
    lambda: spin_chain.main(["--n", "4"]),
    lambda: bench_sweep.main(["--n", "4"]),
    lambda: entry.entry(),
], ids=["random_mps", "spin_chain", "bench_sweep", "entry"])
def test_workloads_default_to_the_card_and_raise_without_one(call,
                                                           monkeypatch):
    """No fallback: with no CUDA device every workload raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_spin_chain_parts_and_chi_schedule_modes(tmp_path, monkeypatch):
    """SPIN_PARTS=1 (one Trotter step a part, each part's solution saved,
    a ladder resumed from a saved part by SPIN_RESUME_FROM/_PART) and
    SPIN_CHI_SCHEDULE (the stages' overlaps in the record) run at n = 4,
    2 steps, 1 layer a part or stage."""
    import glob
    monkeypatch.setenv("SPIN_LAYERS", "1")
    monkeypatch.setenv("SPIN_CHI", "4")
    monkeypatch.setenv("SPIN_CROSS_ENGINE", "0")
    monkeypatch.setenv("SPIN_PARTS", "1")
    with cplx.verification_eigh():
        rec = spin_chain.run(4, 2, 0.25, device="cpu",
                             circuits_dir=str(tmp_path), dtype=C128)
        parts = len(rec["parts"])  # blocks of one step's depth
        assert parts >= 2 and rec["layers"] == parts
        assert rec["independent_engine_overlap"] is None
        part0 = glob.glob(str(tmp_path / "spin_n4_s2_part0_*.qasm.gz"))
        assert len(part0) == 1
        monkeypatch.setenv("SPIN_RESUME_FROM", part0[0])
        monkeypatch.setenv("SPIN_RESUME_PART", "1")
        resumed = spin_chain.run(4, 2, 0.25, device="cpu",
                                 circuits_dir=str(tmp_path), dtype=C128)
        assert len(resumed["parts"]) == parts - 1
        monkeypatch.setenv("SPIN_PARTS", "0")
        monkeypatch.setenv("SPIN_CHI_SCHEDULE", "2,4")
        sched = spin_chain.run(4, 2, 0.25, device="cpu",
                               circuits_dir=str(tmp_path), dtype=C128)
    assert sched["working_chi"] == 4
    assert [c for c, _ in sched["chi_schedule"]] in ([2], [2, 4])
    for r in (rec, resumed, sched):
        assert np.isfinite(r["overlap"]) and np.isfinite(r["sm_solution"])
