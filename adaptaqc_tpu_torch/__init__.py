"""adaptaqc_tpu_torch: ADAPT-AQC on PyTorch with hand-written Hopper kernels.

The PyTorch port of the JAX package `adaptaqc_tpu`, which stays beside it as
the reference. The port covers the statevector, MPS, sampling and
center-gauge MPS backends, `AdaptCompiler` with the ISL, expectation, basic,
random, brickwall and general_gradient pair heuristics, the
Rotoselect/Rotosolve sweeps of the global, local and softened costs and the
host probe loop, `compile_in_parts`, `compile_with_chi_schedule`,
checkpoints, and the chi=1 product-state start. `AdaptCompiler(target)` with
no backend runs, as in the JAX package, on `SVBackend()` with ISL. Engine
state lives in native complex tensors on the backend's device, the CUDA
card unless the caller passes `device="cpu"`; the four TPU
kernels of the MPS path are CUDA C++ kernels for sm_90a (csrc/), built with
nvcc at their first launch. On a CPU tensor every kernel wrapper runs its
plain PyTorch version instead.

Importing the package builds nothing and needs neither a GPU nor nvcc.
"""

from .backends.backend import (CENTER_MPS_SIM, MPS_SIM, QASM_SIM, SV_SIM,
                               AQCBackend, CenterMPSBackend, MPSBackend,
                               SamplingBackend, SVBackend,
                               mps_backend_with_args)
from .circuits.circuit import Circuit
from .compilers import AdaptCompiler, AdaptConfig, AdaptResult
from .compilers.approximate_compiler import (ApproximateCompiler,
                                             CompileInPartsResult)

__all__ = ["AdaptCompiler", "AdaptConfig", "AdaptResult",
           "ApproximateCompiler", "CompileInPartsResult", "AQCBackend",
           "CenterMPSBackend", "SVBackend", "MPSBackend", "SamplingBackend",
           "mps_backend_with_args", "SV_SIM", "MPS_SIM", "QASM_SIM",
           "CENTER_MPS_SIM", "Circuit"]
