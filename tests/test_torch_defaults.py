"""The port's entry points run on the CUDA card unless the caller asks for
the CPU: the backends, `mps_backend_with_args`, the module singletons and
`calculate_overlap_between_circuits` default to "cuda"; building one touches
no device; `device="cpu"` still computes; and without a card the first
engine state raises instead of carrying on on the CPU."""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import adaptaqc_tpu_torch as port
from adaptaqc_tpu_torch.backends import backend as backend_mod
from adaptaqc_tpu_torch.backends import sv_core
from adaptaqc_tpu_torch.circuits.circuit import Circuit
from adaptaqc_tpu_torch.compilers import approximate_compiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C128 = torch.complex128

BUILDERS = {
    "SVBackend": lambda: port.SVBackend(),
    "MPSBackend": lambda: port.MPSBackend(),
    "SamplingBackend": lambda: port.SamplingBackend(),
    "mps_backend_with_args": lambda: port.mps_backend_with_args(),
    "CenterMPSBackend": lambda: port.CenterMPSBackend(),
    "CENTER_MPS_SIM": lambda: port.CENTER_MPS_SIM,
    "SV_SIM": lambda: port.SV_SIM,
    "MPS_SIM": lambda: port.MPS_SIM,
    "QASM_SIM": lambda: port.QASM_SIM,
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_backends_default_to_the_card(name):
    assert BUILDERS[name]().device == torch.device("cuda")


def test_overlap_helper_defaults_to_the_card():
    sig = inspect.signature(
        approximate_compiler.calculate_overlap_between_circuits)
    assert sig.parameters["device"].default == "cuda"


def test_random_target_defaults_to_the_card():
    """The synthetic random-MPS target is simulated on the card unless the
    caller asks for the CPU; without a card the default raises. Either way
    it comes back in the Qiskit format, on the host."""
    from adaptaqc_tpu_torch.utils import targets
    sig = inspect.signature(targets.random_target)
    assert sig.parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            targets.random_target(2, n=3)
    gams, lams = targets.random_target(2, n=3, dtype=C128, device="cpu")
    assert len(gams) == 3 and len(lams) == 2
    assert isinstance(gams[0][0], np.ndarray)


def test_building_a_sampler_makes_no_generator():
    """The draws' generator is made at first use: building the backend,
    as importing the package builds QASM_SIM, creates none."""
    assert port.SamplingBackend(seed=5)._generator is None
    script = ("import torch, adaptaqc_tpu_torch as p\n"
              "assert p.QASM_SIM._generator is None\n"
              "assert not torch.cuda.is_initialized()\n"
              "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cpu_backends_still_compute():
    """Asked for the CPU, the sampler makes its generator there, seeded as
    before, and the statevector engine computes there."""
    v = np.random.default_rng(4).normal(size=8) + 0j
    st = sv_core.state_from_vector(v / np.linalg.norm(v), C128, "cpu")
    a = port.SamplingBackend(seed=7, dtype=C128, device="cpu")
    b = port.SamplingBackend(seed=7, dtype=C128, device="cpu")
    assert a.sample_state(st, 500, 3) == b.sample_state(st, 500, 3)
    assert a.generator.device == torch.device("cpu")
    state = port.SVBackend(device="cpu", dtype=C128).initial_state(
        Circuit(3), 3)
    assert state.device.type == "cpu"
    assert abs(complex(state[0]) - 1) < 1e-15


@pytest.mark.parametrize("name", ["SVBackend", "MPSBackend",
                                  "SamplingBackend", "CenterMPSBackend"])
def test_engine_state_on_the_card_raises_without_cuda(name):
    """On a torch without CUDA the first engine state of a default backend
    raises; nothing falls back to the CPU. With a card it lies there."""
    backend = BUILDERS[name]()
    if torch.cuda.is_available():
        assert backend.initial_state(Circuit(2), 2).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            backend.initial_state(Circuit(2), 2)


def test_default_sampler_draws_raise_without_cuda():
    if torch.cuda.is_available():
        assert backend_mod.SamplingBackend().generator.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            backend_mod.SamplingBackend().generator


def test_verifier_and_spin_chain_helpers_default_to_the_card():
    """cross_engine_overlap, staggered_magnetisation and zero_cmps simulate
    on the card unless the caller asks for the CPU; without a card the
    defaults raise, and on the CPU they compute."""
    from adaptaqc_tpu_torch.backends import center_mps
    from adaptaqc_tpu_torch.utils import targets, verification
    for fn in (verification.cross_engine_overlap,
               targets.staggered_magnetisation, center_mps.zero_cmps):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    qc = targets.neel_circuit(4)
    from adaptaqc_tpu_torch.circuits import operations as co
    co.add_to_circuit(qc, targets.trotter_circuit(4, 1, 0.25))
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            verification.cross_engine_overlap(qc, qc, chi=4)
        with pytest.raises((AssertionError, RuntimeError)):
            targets.staggered_magnetisation(qc, chi=4)
    assert abs(verification.cross_engine_overlap(
        qc, qc, chi=4, device="cpu", dtype=C128) - 1.0) < 1e-10
    sm0 = targets.staggered_magnetisation(targets.neel_circuit(4), chi=4,
                                          dtype=C128, device="cpu")
    assert abs(sm0 - 1.0) < 1e-12  # the Neel state itself
    sm = targets.staggered_magnetisation(qc, chi=4, dtype=C128, device="cpu")
    assert -1.0 <= sm < 1.0


def test_spin_chain_targets_match_the_jax_benchmark():
    """trotter_circuit, neel_circuit and staggered_magnetisation are copies
    of benchmarks/spin_chain.py's: the same gates (angles to 1e-12) and the
    same observable (1e-8) for the same arguments."""
    import importlib.util
    import logging
    spec = importlib.util.spec_from_file_location(
        "spin_chain_bench", os.path.join(ROOT, "benchmarks", "spin_chain.py"))
    bench = importlib.util.module_from_spec(spec)
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    handlers = list(logging.root.handlers)
    try:
        spec.loader.exec_module(bench)
    finally:
        sys.path.remove(os.path.join(ROOT, "benchmarks"))
        # the benchmark script configures logging when imported: undo it
        logging.root.handlers[:] = handlers
        logging.getLogger("adaptaqc_tpu").setLevel(logging.NOTSET)
    from adaptaqc_tpu_torch.circuits import operations as co
    from adaptaqc_tpu_torch.utils import targets
    n = 6
    jt, tt = bench.trotter_circuit(n, 2, 0.25), targets.trotter_circuit(
        n, 2, 0.25)
    assert len(jt.data) == len(tt.data)
    for a, b in zip(jt.data, tt.data):
        assert a.name == b.name and tuple(a.qubits) == tuple(b.qubits)
        np.testing.assert_allclose(a.params, b.params, atol=1e-12)
    assert [i.qubits for i in bench.neel_circuit(n).data] == [
        i.qubits for i in targets.neel_circuit(n).data]
    jfull = bench.neel_circuit(n)
    from adaptaqc_tpu.circuits import operations as jco
    jco.add_to_circuit(jfull, jt)
    tfull = targets.neel_circuit(n)
    co.add_to_circuit(tfull, tt)
    assert abs(bench.staggered_magnetisation(jfull, chi=8)
               - targets.staggered_magnetisation(tfull, chi=8, dtype=C128,
                                                 device="cpu")) < 1e-8


def _schedule_compiler(n=14):
    qc = Circuit(n)
    for q in range(n):
        qc.ry(0.3 + 0.1 * q, q)
    for q in range(n - 1):
        qc.cx(q, q + 1)
    return port.AdaptCompiler(
        qc, backend=port.MPSBackend(max_chi=32, device="cpu", dtype=C128),
        adapt_config=port.AdaptConfig(method="brickwall", max_layers=1),
        coupling_map=[(q, q + 1) for q in range(n - 1)])


def test_chi_schedule_past_the_kernel_caps_fails_before_stage_one(
        monkeypatch):
    """On a CUDA device the kernels take chi <= 8192 (env_chain) and m = 2
    chi <= 16384 (the eigensolver), in complex64 and complex128 alike, and
    a call above a cap raises (ops/dispatch.py). A stage whose working chi
    exceeds the cap stops the schedule before its first stage, with a
    message that names the cap (at n = 28, where (32, 16384) works at chi
    16384, in either dtype); the README's (32, 64, 128) schedule, (32, 64,
    128, 256) and the cap, (32, 8192), are let through (stage 1 is reached
    on the recorder, and nothing launches on the CPU), as is any schedule
    at n = 14, where the working chi stops at 2**7 = 128."""
    compiled = []
    monkeypatch.setattr(port.AdaptCompiler, "compile",
                        lambda self, **kw: compiled.append(self) or 1 / 0)
    compiler = _schedule_compiler()
    compiler.backend.device = torch.device("cuda")
    for chis in ((32, 64, 128), (32, 64), (32, 512)):
        with pytest.raises(ZeroDivisionError):  # stage 1 is reached
            compiler.compile_with_chi_schedule(chis=chis)
    assert len(compiled) == 3
    for dt, cap in ((torch.complex64, 8192), (C128, 8192)):
        wide = _schedule_compiler(n=28)
        wide.backend.device = torch.device("cuda")
        wide.backend.dtype = dt
        with pytest.raises(ValueError, match=rf"chi <= {cap}.*env_chain chi "
                                             rf"<= 8192, eigensolver m = 2 "
                                             rf"chi <= {2 * cap}"):
            wide.compile_with_chi_schedule(chis=(32, 2 * cap))
        with pytest.raises(ZeroDivisionError):
            wide.compile_with_chi_schedule(chis=(32, 64, 128))
        with pytest.raises(ZeroDivisionError):
            wide.compile_with_chi_schedule(chis=(32, 64, 128, 256))
        with pytest.raises(ZeroDivisionError):
            wide.compile_with_chi_schedule(chis=(32, cap))
    assert len(compiled) == 9


def test_chi_schedule_past_the_kernel_caps_runs_on_the_cpu():
    """The plain versions have no cap: on device="cpu" the README's
    (32, 64, 128) schedule runs (here at n = 14, where the working chi
    stops at 2**7 = 128, cut to one layer a stage, native eigensolver)."""
    from adaptaqc_tpu_torch.ops import cplx
    with cplx.verification_eigh():
        result = _schedule_compiler().compile_with_chi_schedule(
            chis=(32, 64, 128))
    assert [c for c, _ in result.chi_schedule] == [32, 64, 128]
    assert 0.0 <= result.independent_overlap <= 1.0 + 1e-9
