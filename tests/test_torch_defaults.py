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
                                  "SamplingBackend"])
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
