"""adaptaqc_tpu_torch: ADAPT-AQC on PyTorch with hand-written Hopper kernels.

The PyTorch port of the JAX package `adaptaqc_tpu`, which stays beside it as
the reference. The port covers the MPS compile path: `AdaptCompiler` over
`MPSBackend`, the Rotoselect/Rotosolve sweep, the general_gradient pair
heuristic and the chi=1 product-state start. Engine state lives in native
complex tensors on an explicit device; the four TPU kernels of that path are
CUDA C++ kernels for sm_90a (csrc/), built with nvcc at their first launch.
On a CPU tensor every kernel wrapper runs its plain PyTorch version instead.

Importing the package builds nothing and needs neither a GPU nor nvcc.
"""

from .backends.backend import AQCBackend, MPSBackend, mps_backend_with_args
from .circuits.circuit import Circuit
from .compilers import AdaptCompiler, AdaptConfig, AdaptResult

__all__ = ["AdaptCompiler", "AdaptConfig", "AdaptResult", "AQCBackend",
           "MPSBackend", "mps_backend_with_args", "Circuit"]
