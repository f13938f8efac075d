"""Numeric policy of the port.

The engine works in native complex tensors. complex64 is the default: it is
the card's working type and the type every CUDA kernel of this package takes
(the TPU kernels it replaces were float32-only). complex128 is available on
request, for CPU parity tests against the JAX package under x64; the CUDA
kernel wrappers refuse it.

Matrix products stay in full float32: TF32 is switched off for both cuBLAS
matmuls and cuDNN (the JAX package ran every accuracy-relevant product at
Precision.HIGHEST; TF32 keeps about three decimal digits).
"""

import torch

DEFAULT_DTYPE = torch.complex64

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real type matching a complex (or real) dtype."""
    return torch.empty((), dtype=dtype).real.dtype


def lambda_eps(dtype: torch.dtype) -> float:
    """Smallest bond weight treated as nonzero, by the dtype's itemsize: in
    float32, weights below ~10 machine-eps are rounding noise."""
    return 1e-12 if real_dtype(dtype).itemsize >= 8 else 1e-6
