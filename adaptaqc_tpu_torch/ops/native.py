"""ctypes bindings for the native circuit-runtime kernels (native/circkit.cpp).

Builds (at first use) and loads the package's own copy of the library and
exposes the peephole simplifier and depth kernels over flat gate arrays.
Falls back cleanly when the toolchain or library is unavailable, or when a
circuit contains constructs outside the flat-gate ABI (parameterised labels,
measures, state-injection instructions).

The library is compiled with g++ into `_build/` beside the package (a
directory git ignores), under a name keyed by a hash of the source and the
flags. Several processes may want it at once (test workers): the build runs
under a file lock, to a temporary name, and is moved into place by one atomic
rename, so no process ever loads half a file. A failed attempt is not latched
for the life of the process: it is tried again after `_RETRY_SECONDS`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np

from ..circuits import gates as G
from ..circuits.circuit import Circuit, Instruction

logger = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG.parent / "native" / "circkit.cpp"
_BUILD_DIR = _PKG / "_build"
# no -march=native: the build directory may travel with a copy of the tree
# to a machine with another CPU
_CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_RETRY_SECONDS = 10.0

_LIB: Optional[ctypes.CDLL] = None
_failed_at: Optional[float] = None  # time.monotonic() of the last failure


def library_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes())
    digest.update(" ".join(_CXXFLAGS).encode())
    return _BUILD_DIR / f"libcirckit_{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile the library if this source state has none yet."""
    path = library_path()
    if path.exists():
        return path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "circkit.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not path.exists():  # another process may have built it
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(
                    [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", str(tmp),
                     str(_SOURCE)],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _failed_at
    if _LIB is not None:
        return _LIB
    if os.environ.get("ADAPTAQC_TPU_NO_NATIVE"):
        return None
    if (_failed_at is not None
            and time.monotonic() - _failed_at < _RETRY_SECONDS):
        return None
    try:
        lib = ctypes.CDLL(str(_build()))
        lib.ck_peephole.restype = ctypes.c_int
        lib.ck_multi_qubit_gate_depth.restype = ctypes.c_int
    except Exception as e:  # no toolchain, read-only install, failed load
        logger.debug(f"native circkit unavailable: {e}")
        _failed_at = time.monotonic()
        return None
    _LIB = lib
    _failed_at = None
    return _LIB


def available() -> bool:
    return _load() is not None


def _circuit_to_arrays(circuit: Circuit, gate_range):
    lo, hi = gate_range
    n = hi - lo
    kinds = np.zeros(n, np.int32)
    q0 = np.zeros(n, np.int32)
    q1 = np.full(n, -1, np.int32)
    angles = np.zeros(n, np.float64)
    flags = np.zeros(n, np.uint8)
    from ..circuits.tape import CXR
    for i in range(n):
        instr = circuit.data[lo + i]
        if instr.clbits or instr.name not in G.NAME_TO_KIND:
            return None
        if instr.label is not None and ("#" in instr.label or "@" in instr.label):
            return None
        kind = G.NAME_TO_KIND[instr.name]
        if len(instr.qubits) == 2:
            a, b = instr.qubits
            if instr.name == "cx" and a > b:
                kind, a, b = CXR, b, a
            elif a > b:
                a, b = b, a
            kinds[i], q0[i], q1[i] = kind, a, b
        else:
            kinds[i], q0[i] = kind, instr.qubits[0]
            angles[i] = instr.params[0] if instr.params else 0.0
            if instr.is_supported_1q_gate():
                flags[i] = 1
    return kinds, q0, q1, angles, flags


def _arrays_to_instructions(kinds, q0, q1, angles, flags, count):
    out = []
    from ..circuits.tape import CXR
    for i in range(count):
        k = int(kinds[i])
        if k == CXR:
            out.append(Instruction("cx", (int(q1[i]), int(q0[i]))))
        elif int(q1[i]) >= 0:
            out.append(Instruction(G.KIND_NAMES[k], (int(q0[i]), int(q1[i]))))
        else:
            name = G.KIND_NAMES[k]
            label = name if (flags[i] & 1) else None
            params = (float(angles[i]),) if k in G.ROTATION_KINDS else ()
            out.append(Instruction(name, (int(q0[i]),), params, label=label))
    return out


def peephole(circuit: Circuit, remove_zero_gates=True, remove_small_gates=False,
             gate_range=None, min_rotation_angle=1e-3) -> bool:
    """Native fixpoint peephole. Returns True if applied (circuit mutated),
    False if the caller must use the Python fallback."""
    lib = _load()
    if lib is None:
        return False
    if gate_range is None:
        gate_range = (0, len(circuit.data))
    arrays = _circuit_to_arrays(circuit, gate_range)
    if arrays is None:
        return False
    kinds, q0, q1, angles, flags = arrays
    new_count = lib.ck_peephole(
        ctypes.c_int(len(kinds)),
        kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        q0.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        q1.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        angles.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int(0), ctypes.c_int(-1),
        ctypes.c_int(1 if remove_zero_gates else 0),
        ctypes.c_int(1 if remove_small_gates else 0),
        ctypes.c_double(min_rotation_angle))
    new_instrs = _arrays_to_instructions(kinds, q0, q1, angles, flags, new_count)
    circuit.data[gate_range[0]:gate_range[1]] = new_instrs
    return True


def multi_qubit_gate_depth(circuit: Circuit) -> Optional[int]:
    lib = _load()
    if lib is None:
        return None
    arrays = _circuit_to_arrays(circuit, (0, len(circuit.data)))
    if arrays is None:
        return None
    kinds, q0, q1, angles, flags = arrays
    return int(lib.ck_multi_qubit_gate_depth(
        ctypes.c_int(len(kinds)),
        q0.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        q1.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int(circuit.num_qubits)))
