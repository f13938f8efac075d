"""The port stands alone: every module of adaptaqc_tpu_torch imports with
JAX made unimportable, and importing builds no kernel and needs no nvcc."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, os, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["adaptaqc_tpu"] = None  # nor may the JAX package be reached
os.environ["PATH"] = ""            # no nvcc (or any tool) on the path
import adaptaqc_tpu_torch
names = []
for mod in pkgutil.walk_packages(adaptaqc_tpu_torch.__path__,
                                 "adaptaqc_tpu_torch."):
    importlib.import_module(mod.name)
    names.append(mod.name)
from adaptaqc_tpu_torch.ops import cuda_lib
assert cuda_lib._lib is None, "a kernel library was loaded at import"
assert cuda_lib.build_seconds is None, "nvcc ran at import"
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None)
assert not any(m.startswith("triton") for m in sys.modules)
print(len(names))
"""


def test_port_imports_without_jax_and_builds_nothing():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 25


def test_public_entry_points():
    import adaptaqc_tpu_torch as port
    for name in ("AdaptCompiler", "AdaptConfig", "mps_backend_with_args",
                 "CenterMPSBackend", "CENTER_MPS_SIM", "CompileInPartsResult",
                 "ApproximateCompiler"):
        assert hasattr(port, name)


def test_new_modules_are_among_those_imported_without_jax():
    """The spin-chain slice's modules are found by the walk above (it
    imports every module of the package)."""
    import pkgutil

    import adaptaqc_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(
        adaptaqc_tpu_torch.__path__, "adaptaqc_tpu_torch.")}
    for mod in ("backends.center_mps", "utils.verification",
                "io.checkpoint", "utils.targets", "ops.native"):
        assert f"adaptaqc_tpu_torch.{mod}" in names


def test_workloads_examples_and_utilities_are_among_those_imported():
    """The workload scripts, the example twins and the utility modules are
    found by the walk of the first test, so they too import with JAX made
    unimportable and build nothing (each example's compile runs only
    under `__main__`)."""
    import pkgutil

    import adaptaqc_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(
        adaptaqc_tpu_torch.__path__, "adaptaqc_tpu_torch.")}
    for mod in ("workloads._common", "workloads.random_mps",
                "workloads.spin_chain", "workloads.bench_sweep",
                "workloads.entry", "workloads.refine",
                "workloads.spin_refine", "workloads.reverify_spin",
                "workloads.summarize", "examples.readme_example",
                "examples.simple_sv_example", "examples.advanced_sv_example",
                "examples.simple_mps_example",
                "examples.advanced_mps_example", "utils.utilityfunctions",
                "utils.hamiltonians", "utils.gate_tomography",
                "utils.fixed_ansatz_circuits", "utils.tenpy_interop"):
        assert f"adaptaqc_tpu_torch.{mod}" in names


def test_zigzag_and_env_cache_import_without_jax():
    """The zigzag sweeps and the incremental probe environments are the
    port's own: they import with JAX made unimportable."""
    script = ("import sys\nsys.modules['jax'] = None\n"
              "sys.modules['adaptaqc_tpu'] = None\n"
              "from adaptaqc_tpu_torch.optim.sweeps import (EnvOps, "
              "sweep_zigzag_until_converged, sweep_zigzag_n_cycles)\n"
              "from adaptaqc_tpu_torch.backends.mps_core import (SweepEnv, "
              "_env_init, _env_touch, _env_probe)\nprint('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_parallel_modules_are_among_those_imported():
    """M7's modules (the launcher and mesh, the sharded engines) are found
    by the walk of the first test, so they import with JAX made
    unimportable and build nothing; importing them starts no process
    group."""
    import pkgutil

    import torch.distributed as dist

    import adaptaqc_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(
        adaptaqc_tpu_torch.__path__, "adaptaqc_tpu_torch.")}
    for mod in ("parallel", "parallel.mesh", "parallel.sv_sharded",
                "parallel.mps_sharded"):
        assert f"adaptaqc_tpu_torch.{mod}" in names
    from adaptaqc_tpu_torch.parallel import mesh, mps_sharded  # noqa: F401
    from adaptaqc_tpu_torch.parallel import sv_sharded  # noqa: F401
    assert not dist.is_initialized()
