"""Checkpoint codec: what makes an AdaptCompiler picklable.

Counterpart of the JAX package's `io/checkpoint.py`. The reference pickles
the whole compiler object (adapt_compiler.py:484-506). Here every engine MPS
held by a circuit (a set_mps payload) goes to the host as numpy arrays in the
Qiskit MPS format on save and comes back as an engine MPS on load; state
caches are dropped and rebuilt at first use; the backend is stored by its
constructor arguments, its device and dtype included, so a checkpoint
written on the card resumes there. `load` can send it to another device
(a checkpoint written on the card loads on the CPU and back).
"""

from __future__ import annotations

import pickle
from typing import Any, Dict

import numpy as np
import torch

_CIRCUIT_ATTRS = ("full_circuit", "circuit_to_compile", "layers_saved_to_mps",
                  "starting_circuit", "initial_state_circuit")
_QISKIT_TAG = "qiskit_mps"

# set by `load` around unpickling: the device the backend is rebuilt on
# instead of the one it was saved from
_device_override = None


def _encode_instr(instr):
    from ..backends import mps_core
    from ..parallel.mesh import unshard
    out = instr.copy()
    if out.name == "set_mps" and isinstance(out.payload, mps_core.MPS):
        # a payload sharded over a mesh is gathered whole first
        out.payload = (_QISKIT_TAG,
                       mps_core.to_qiskit_mps(unshard(out.payload)))
    elif out.name == "set_statevector":
        out.payload = np.asarray(out.payload)
    return out


def _encode_circuit(circuit):
    if circuit is None:
        return None
    qc = circuit.copy()
    qc.data = [_encode_instr(instr) for instr in qc.data]
    return qc


def _decode_instr(instr, chi, backend):
    from ..backends import mps_core
    p = instr.payload
    if (instr.name == "set_mps" and isinstance(p, tuple) and len(p) == 2
            and p[0] == _QISKIT_TAG):
        instr.payload = mps_core.from_qiskit_mps(
            p[1], chi, dtype=backend.dtype, device=backend.device)
    return instr


def _backend_spec(backend):
    """The backend's constructor arguments, its device and dtype. A mesh is
    process-local and is not stored, as in the JAX package
    (io/checkpoint.py:63): a loaded backend has mesh=None."""
    from ..backends.backend import (CenterMPSBackend, MPSBackend,
                                    SamplingBackend, SVBackend)
    where = (str(backend.device), backend.dtype) if hasattr(
        backend, "device") else None
    if isinstance(backend, MPSBackend):
        return ("mps", where, backend.truncation_threshold, backend.max_chi,
                backend.mps_log_data)
    if isinstance(backend, CenterMPSBackend):
        return ("center_mps", where, backend.chi, backend.cutoff)
    if isinstance(backend, SamplingBackend):
        return ("sampling", where, backend.shots, backend.seed)
    if isinstance(backend, SVBackend):
        return ("sv", where)
    return ("custom", backend)


def _backend_from_spec(spec):
    from ..backends.backend import (CenterMPSBackend, MPSBackend,
                                    SamplingBackend, SVBackend)
    if spec[0] == "custom":
        return spec[1]
    device, dtype = spec[1]
    if _device_override is not None:
        device = _device_override
    kind, args = spec[0], spec[2:]
    cls = {"mps": MPSBackend, "center_mps": CenterMPSBackend,
           "sampling": SamplingBackend, "sv": SVBackend}[kind]
    return cls(*args, device=device, dtype=dtype)


def encode_compiler_state(compiler) -> Dict[str, Any]:
    state = dict(compiler.__dict__)
    # caches are rebuilt at first use
    state["_prefix_cache"] = None
    state["_current_cache"] = None
    state["_advance_hint"] = None
    minimizer = state.pop("minimizer", None)
    if minimizer is not None:
        state["minimizer_fraction"] = minimizer.rotosolve_fraction
        state["minimizer_zigzag"] = minimizer.zigzag
    for attr in _CIRCUIT_ATTRS:
        if attr in state:
            state[attr] = _encode_circuit(state[attr])
    if "_orig_target_instr" in state:
        state["_orig_target_instr"] = _encode_instr(
            state["_orig_target_instr"])
    state["__backend_spec__"] = _backend_spec(state.pop("backend"))
    state.pop("target", None)  # may hold device tensors; not needed to resume
    state.pop("_gradient_ops", None)  # device tensors; rebuilt on load
    return state


def decode_compiler_state(compiler, state: Dict[str, Any]) -> None:
    from ..backends.backend import MPSBackend
    from ..optim.minimiser import CostMinimiser

    backend = _backend_from_spec(state.pop("__backend_spec__"))
    compiler.__dict__.update(state)
    compiler.backend = backend
    compiler.target = None
    compiler.__dict__.setdefault("_advance_hint", None)
    compiler.__dict__.setdefault("_absorption_bias", 0.0)
    compiler.__dict__.setdefault("_layers_since_verify", 0)
    compiler.__dict__.setdefault("profile_dir", None)  # older checkpoints

    n = compiler.full_circuit.num_qubits if compiler.full_circuit else 0
    chi = backend.chi_for(n) if isinstance(backend, MPSBackend) else None
    for attr in _CIRCUIT_ATTRS:
        circuit = getattr(compiler, attr, None)
        if circuit is not None:
            for instr in circuit.data:
                _decode_instr(instr, chi, backend)
    if getattr(compiler, "_orig_target_instr", None) is not None:
        _decode_instr(compiler._orig_target_instr, chi, backend)

    fraction = getattr(compiler, "minimizer_fraction", None) or 1.0
    # a checkpoint without the zigzag flag resumes as a new minimiser
    # starts: ADAPTAQC_ZIGZAG decides
    compiler.minimizer = CostMinimiser(compiler.evaluate_cost,
                                       compiler.variational_circuit_range,
                                       compiler, fraction,
                                       zigzag=state.get("minimizer_zigzag"))
    if (getattr(compiler, "adapt_config", None) is not None
            and compiler.adapt_config.method == "general_gradient"):
        from ..utils import gradients as gr
        compiler._gradient_ops = gr.prepare_gradient_ops(
            compiler.inverse_zero_ansatz, compiler.generators)


def load(path, device=None):
    """The compiler pickled at `path` (a checkpoint of
    AdaptCompiler.compile), on the device it was saved from, or on `device`
    if one is given: its compile() resumes at the next layer."""
    global _device_override
    _device_override = None if device is None else str(torch.device(device))
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    finally:
        _device_override = None
