"""Build and load the package's CUDA kernels (csrc/*.cu) as one shared
library with a plain C interface, bound through ctypes.

The library is compiled with nvcc for sm_90a at the first kernel launch of a
process, into `_build/` beside the package (a directory git ignores), under a
file name keyed by a hash of the sources, so an edited source is never served
by a stale binary: one nvcc process a source, all started together, then one
link. Importing this module builds nothing and needs no nvcc.

Every launcher in the library takes device pointers and the CUDA stream as
`void*`, launches on that stream without synchronising, and returns the
`cudaError_t` of the launch (0 on success); `check` turns a nonzero code into
an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("env_chain.cu", "env_chain_wide.cu", "env_chain_stream.cu",
           "eigh_tridiag.cu", "tridiag_grid.cu", "backtransform_wide.cu",
           "backtransform_strip.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong  # a stride between the matrices of a batch, in elements
# launcher name -> argument types (pointers and the stream as void*)
_SIGNATURES = {
    "env_chain_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "env_chain_f64_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "env_chain_cluster_size": (_I, _I),
    "env_chain_wide_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "env_chain_wide_cluster_size": (_I,),
    "env_chain_wide_plan": (_I, _P),
    "env_chain_stream_launch": (_P, _P, _P, _P, _L, _P, _I, _I, _I, _I,
                                _P),
    "env_chain_stream_plan": (_I, _I, _I, _I, _P),
    "env_chain_stream_step2": (_P, _P, _P, _P, _L, _I, _I, _P),
    "tridiag_launch": (_P, _P, _P, _P, _P, _I, _I, _L, _P),
    "teig_launch": (_P, _P, _P, _P, _P, _I, _I, _L, _L, _P),
    "backtransform_launch": (_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _P),
    "tridiag_wide_launch": (_P, _P, _P, _P, _P, _I, _I, _L, _P),
    "teig_wide_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _L,
                         _P),
    "teig_cluster_size": (_I, _I),
    "eigh_wide_routes": (_I, _I),
    "tridiag_cluster_size": (_I, _I),
    "tridiag_routes": (_I, _I),
    "tridiag_grid_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _L, _P),
    "tridiag_grid_f64_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _L, _P),
    "tridiag_grid_plan": (_I, _I, _P),
    "backtransform_wide_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _L, _L,
                                  _L, _P),
    "backtransform_cluster_size": (_I, _I, _I),
    "tridiag_f64_launch": (_P, _P, _P, _P, _P, _I, _I, _L, _P),
    "teig_f64_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _L,
                        _P),
    "teig_grid_plan": (_I, _I, _P),
    "backtransform_f64_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _L, _L,
                                 _L, _P),
    "backtransform_strip_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _L,
                                   _L, _L, _I, _P),
    "backtransform_route": (_I, _I),
}
_RESTYPES = {"teig_wide_scratch": ((_I,), ctypes.c_longlong),
             "env_chain_f64_partials": ((_I,), ctypes.c_longlong),
             "env_chain_stream_work": ((_I, _I), ctypes.c_longlong),
             "backtransform_workspace": ((_I, _I), ctypes.c_longlong),
             "backtransform_apply_smem": ((_I, _I, _I), ctypes.c_longlong),
             "backtransform_strip_workspace": ((_I, _I), ctypes.c_longlong),
             "backtransform_strip_zbuf": ((_I, _I, _I), ctypes.c_longlong),
             "backtransform_strip_smem": ((_I, _I), ctypes.c_longlong),
             "tridiag_grid_workspace": ((_I, _I), ctypes.c_longlong)}

_lib = None
build_seconds = None  # wall time of this process's nvcc run, if it built


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in SOURCES + HEADERS:
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libadaptaqc_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this source state has no library yet."""
    global build_seconds
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    objs = [path.with_suffix(f".{os.getpid()}.{name}.o") for name in SOURCES]
    t0 = time.perf_counter()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    procs = [subprocess.Popen([nvcc, *compile_flags, "-c", "-o", str(obj),
                               str(CSRC / name)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for name, obj in zip(SOURCES, objs)]
    errors = []
    for name, proc in zip(SOURCES, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name} ({proc.returncode}):\n{err}")
    if not errors:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode != 0:
            errors.append(f"link ({link.returncode}):\n{link.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    os.replace(tmp, path)  # atomic: concurrent builders never see half a file
    build_seconds = time.perf_counter() - t0
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        for name, (argtypes, restype) in _RESTYPES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        handle.adaptaqc_error_string.argtypes = [ctypes.c_int]
        handle.adaptaqc_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(rc: int, kernel: str) -> None:
    if rc != 0:
        msg = lib().adaptaqc_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc} "
                           f"({msg})")


def stream_of(t) -> int:
    """The current CUDA stream of the tensor's device, as an address."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, dtype, shape) -> None:
    """Kernel argument check: a contiguous CUDA tensor of exact dtype/shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def require_columns(t, name: str, dtype, lead: tuple, rows: int, cols: int,
                    row_stride: int) -> int:
    """Kernel argument check for the first `cols` columns of a matrix (or a
    batch of them, `lead`): a CUDA tensor of exact dtype with `rows` rows
    of at least `cols` columns, unit column stride and the given row
    stride. Returns the stride between the matrices of a batch (rows x
    row_stride for one matrix)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if (tuple(t.shape[:-1]) != tuple(lead) + (rows,)
            or not cols <= t.shape[-1] <= row_stride or t.stride(-1) != 1
            or t.stride(-2) != row_stride):
        raise ValueError(f"{name}: expected {rows} rows of at least {cols} "
                         f"columns at row stride {row_stride}, batched as "
                         f"{tuple(lead)}, got shape {tuple(t.shape)} strides "
                         f"{t.stride()}")
    return t.stride(0) if lead else rows * row_stride
