"""The port's loader of the native circuit kernels (ops/native.py: its own
locked, atomic build of native/circkit.cpp under the package's _build/)
against the port's Python peephole and depth functions: the cases of
tests/test_native.py, which skips as a whole where the JAX package's copy
of the library is missing. This file needs only g++."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from adaptaqc_tpu_torch.circuits import peephole
from adaptaqc_tpu_torch.circuits.circuit import Circuit
from adaptaqc_tpu_torch.ops import native

from reference_sim import simulate
from test_torch_full_cost_sweep import random_circuit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def needs_compiler():
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler: the native library cannot be built")


def python_peephole(qc, **kw):
    """The pure-Python path, whatever the native library's state."""
    out = qc.copy()
    gate_range = [0, len(out.data)]
    last = len(out.data)
    i = 0
    while True:
        if i == 0:
            peephole.remove_unnecessary_1q_gates_from_circuit(
                out, kw.get("remove_zero_gates", True),
                kw.get("remove_small_gates", False), tuple(gate_range))
            i = 1
        else:
            peephole.remove_unnecessary_2q_gates_from_circuit(
                out, tuple(gate_range))
            i = 0
        new = len(out.data)
        if new != last:
            gate_range[1] -= last - new
            last = new
        elif i == 0:
            return out


def _jax_copy(qc):
    from adaptaqc_tpu.circuits.circuit import Circuit as JCircuit
    out = JCircuit(qc.num_qubits)
    for instr in qc.data:
        getattr(out, instr.name)(*instr.params, *instr.qubits)
    return out


def test_native_library_builds_and_loads():
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert not list(path.parent.glob("libcirckit_*.tmp"))


@pytest.mark.parametrize("seed", range(6))
def test_native_peephole_matches_python(seed):
    rng = np.random.default_rng(seed)
    qc = random_circuit(Circuit, 4, 40, rng)
    qc.cx(0, 1)
    qc.cx(0, 1)
    qc.rz(0.0, 2)
    py = python_peephole(qc)
    nat = qc.copy()
    assert native.peephole(nat)
    assert len(nat.data) == len(py.data)
    # the same state as the original, up to a global phase
    s0, s1 = simulate(_jax_copy(qc)), simulate(_jax_copy(nat))
    assert abs(abs(np.vdot(s0, s1)) - 1.0) < 1e-8
    for a, b in zip(nat.data, py.data):
        assert a.name == b.name and a.qubits == b.qubits
        if a.params:
            assert abs(a.params[0] - b.params[0]) < 1e-9


@pytest.mark.parametrize("small", [False, True])
def test_native_peephole_small_gates_and_range(small):
    rng = np.random.default_rng(40)
    qc = random_circuit(Circuit, 3, 30, rng)
    qc.rx(1e-5, 0)
    qc.ry(2e-4, 1)
    py = python_peephole(qc, remove_small_gates=small)
    nat = qc.copy()
    assert native.peephole(nat, remove_small_gates=small)
    assert [(i.name, i.qubits) for i in nat.data] == [
        (i.name, i.qubits) for i in py.data]


def test_native_depth_matches_python():
    rng = np.random.default_rng(7)
    qc = random_circuit(Circuit, 5, 30, rng)
    assert native.multi_qubit_gate_depth(qc) == qc.multi_qubit_gate_depth()


def test_native_fallback_on_unsupported():
    qc = Circuit(2)
    qc.set_statevector(np.array([1, 0, 0, 0]))
    qc.rx(0.3, 0)
    assert not native.peephole(qc)  # a state injection: the Python path


def test_failed_load_is_not_latched(monkeypatch, tmp_path):
    """A failed build is tried again after the retry time, not remembered
    for the life of the process."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_failed_at", None)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "b")
    monkeypatch.setenv("CXX", "no-such-compiler")
    assert native._load() is None and native._failed_at is not None
    monkeypatch.delenv("CXX")
    assert native._load() is None  # inside the retry time: not tried
    monkeypatch.setattr(native, "_RETRY_SECONDS", 0.0)
    assert native._load() is not None
    assert (tmp_path / "b").exists()


def test_concurrent_processes_share_one_library(tmp_path):
    """Four processes that all find no library build under the lock and
    load the same file; none sees a partial one."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from pathlib import Path\n"
        "from adaptaqc_tpu_torch.ops import native\n"
        "native._BUILD_DIR = Path(sys.argv[2])\n"
        "assert native.available()\n"
        "print(native.library_path().name)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, ROOT,
                               str(tmp_path / "shared")],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    names = {p.communicate(timeout=300)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    assert len(names) == 1
    built = list((tmp_path / "shared").glob("libcirckit_*"))
    assert [b.name for b in built] == [names.pop()]
