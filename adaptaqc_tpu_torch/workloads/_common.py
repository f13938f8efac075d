"""Shared helpers of the workload scripts.

Counterpart of the JAX package's `benchmarks/_common.py`: the build and
device a record names, the compiled circuit saved as QASM, and a compile
that checkpoints every few layers and resumes from the newest checkpoint in
a later process. Every path a workload script writes defaults to a directory under
`local/` at the root of the checkout, which git ignores.
"""

from __future__ import annotations

import glob
import gzip
import json
import logging
import os
import shutil
import subprocess
import time

import torch

from ..circuits import qasm
from ..circuits.operations import make_quantum_only_circuit
from ..io import checkpoint

logger = logging.getLogger(__name__)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LOCAL = os.path.join(ROOT, "local")


def git_rev():
    """Short hash of the checkout's HEAD, or None outside a git checkout
    (a record must say which build produced it)."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=ROOT,
            capture_output=True, text=True, timeout=10).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def platform(device="cuda") -> str:
    """The card's name for a CUDA device, else "cpu"."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def require_device(device) -> torch.device:
    """`device` as a torch.device; raises for a CUDA device on a machine
    without a card (a workload never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the workloads run on the card "
                           "unless given --device cpu")
    return device


def build_kernels(device) -> float:
    """Build and load the CUDA kernels before a compile's clock starts, so
    that no compile wall includes nvcc. Returns the build's seconds (0 off
    the card or when the library was already built)."""
    if torch.device(device).type != "cuda":
        return 0.0
    from ..ops import cuda_lib
    cuda_lib.lib()
    return cuda_lib.build_seconds or 0.0


def kernel_launches() -> dict:
    """The kernel wrappers' launch counters: K1 and K2-K4."""
    from ..ops import eigh_kernels as ek
    from ..ops import env_kernel as envk
    return {fn.__name__: fn.launches for fn in (
        envk.env_chain, ek.tridiag, ek.teig, ek.backtransform)}


def reset_kernel_launches() -> None:
    from ..ops import eigh_kernels as ek
    from ..ops import env_kernel as envk
    for fn in (envk.env_chain, ek.tridiag, ek.teig, ek.backtransform):
        fn.launches = 0


def env(name, default, cast):
    """A workload's knob: environment variable `name`, else `default`."""
    return cast(os.environ.get(name, default))


def sync(device) -> None:
    """Wait for the card, so that a host clock read next includes its
    work."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def save_circuit(circuit, name_prefix, directory=None):
    """Write a compiled circuit as gzipped QASM into `directory` (default
    `local/circuits`) and return its path, so that any record can be
    re-simulated later."""
    directory = directory or os.path.join(LOCAL, "circuits")
    text = qasm.dumps(make_quantum_only_circuit(circuit))
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory,
                        f"{name_prefix}_{int(time.time())}.qasm.gz")
    with gzip.open(path, "wt") as f:
        f.write(text)
    return path


def load_circuit(path, base_dir):
    """The circuit a record names: gzipped QASM at `path`, a path relative
    to `base_dir` (the records file's directory) unless absolute, with
    classical operations dropped."""
    with gzip.open(os.path.join(base_dir, path), "rt") as f:
        return make_quantum_only_circuit(qasm.loads(f.read()))


def read_records(path):
    """The JSON records of a JSONL file, [] if there is none."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def newest_checkpoint(ckdir):
    """The path of the newest `<layer>.pkl` in `ckdir`, or None."""
    pkls = glob.glob(os.path.join(ckdir, "*.pkl"))
    if not pkls:
        return None
    return max(pkls, key=lambda p: int(os.path.basename(p)[:-4]))


def compile_with_recovery(compiler, ckdir, every, device=None,
                          **compile_kwargs):
    """compiler.compile(**compile_kwargs), checkpointed every `every`
    layers into `ckdir` and resumed from its newest checkpoint where one
    exists (`benchmarks/_common.py:59-102`). `every` <= 0 compiles without
    checkpoints. A resumed compile ignores compile_kwargs (such as
    initial_ansatz): they are in the checkpointed state already.

    A compile that reaches its stop removes `ckdir`, so a later run starts
    clean; one stopped by ADAPTAQC_WALL_DEADLINE keeps its checkpoint for
    the next process. Returns (compiler, result): on resume the compiler
    is the one loaded from the checkpoint (on `device` if given).
    `result.resumed_from_layer` is the layer the compile resumed at, or
    None for a fresh start."""
    if every <= 0:
        result = compiler.compile(**compile_kwargs)
        result.resumed_from_layer = None
        return compiler, result
    os.makedirs(ckdir, exist_ok=True)
    newest = newest_checkpoint(ckdir)
    resumed_from = None
    if newest is not None:
        logger.warning(f"resuming from checkpoint {newest}")
        if compile_kwargs:
            logger.warning(f"a resumed compile ignores "
                           f"{sorted(compile_kwargs)}: they are in the "
                           f"checkpointed state")
        compiler = checkpoint.load(newest, device=device)
        resumed_from = compiler.resume_from_layer
        compile_kwargs = {}
    result = compiler.compile(checkpoint_every=every, checkpoint_dir=ckdir,
                              delete_prev_chkpt=True, **compile_kwargs)
    if result.stop_reason != "deadline":
        shutil.rmtree(ckdir, ignore_errors=True)
    result.resumed_from_layer = resumed_from
    return compiler, result


def set_deadline(seconds) -> None:
    """ADAPTAQC_WALL_DEADLINE = now + `seconds` in epoch seconds, the stop
    the compiler's layer loops read; None leaves it as it is."""
    if seconds is not None:
        os.environ["ADAPTAQC_WALL_DEADLINE"] = str(time.time() + seconds)


def add_run_arguments(parser, results_name):
    """The flags both compile workloads take."""
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--deadline", type=float, default=None,
                        metavar="SECONDS",
                        help="stop the compile this many seconds after "
                             "the start, keeping its checkpoint")
    parser.add_argument("--checkpoint-every", type=int, default=50,
                        metavar="K", help="checkpoint every K layers "
                                          "(0: never)")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="where checkpoints go (default "
                             "local/checkpoints/<tag>)")
    parser.add_argument("--results", default=os.path.join(
        LOCAL, results_name), metavar="PATH",
                        help="the JSONL file each record is appended to")
    parser.add_argument("--circuits-dir", default=None,
                        help="where compiled circuits go (default "
                             "local/circuits)")


def append_record(path, line: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(line + "\n")
