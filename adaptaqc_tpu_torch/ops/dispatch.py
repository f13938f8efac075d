"""Whether a kernel wrapper launches its CUDA kernel: one rule of (op,
device type, dtype, size), decided before anything is launched.

  CPU                                  -> False: the wrapper runs its plain
                                          PyTorch version
  CUDA, a dtype and size within REACH  -> True: the wrapper launches the
                                          kernel
  CUDA, anything else                  -> raises (TypeError for the dtype,
                                          ValueError for the size)

Any device but the CPU is held to the card's rule; the wrapper then
refuses a tensor that is not on a CUDA device.

There is no other route on the card: a call that no kernel takes is
refused, not sent to plain or library code. The size is the bond dimension
chi for the env chain (op "env", K1) and the Gram's m = 2 chi (or chi, from
the center-gauge engine's moves) for the eigensolver (op "eigh", K2-K4).
Counterpart of the JAX package's `supported()` gates (ops/pallas_env.py:36,
ops/pallas_eigh.py:37), which send what its TPU kernels do not take down
its XLA path instead.
"""

from __future__ import annotations

import torch

# op -> complex dtype -> (smallest, largest) size its kernels take
REACH = {
    # csrc/env_chain.cu to chi 128 (complex64 narrow to 64, wide to 128;
    # complex128 in its double instantiation), then the streamed kernel of
    # csrc/env_chain_stream.cu to chi 8192, in both dtypes: it has no cap of
    # its own (every offset 64-bit), so this one is the size the card has
    # been checked at, at n = 4-6 sites (past it the eigensolver's m = 2 chi
    # would pass its cap; a sweep at chi 8192 and n >= 25 takes the device
    # mesh, whose sharded chains do not run K1: ROADMAP F5)
    "env": {torch.complex64: (1, 8192), torch.complex128: (1, 8192)},
    # csrc/eigh_tridiag.cu: complex64 to m 128 in the register and
    # shared-memory designs, then the wide variants; complex128 in the wide
    # variants' double instantiation; past each kernel's shared-memory fit
    # K2 and K3 run their card-wide routes (csrc/tridiag_grid.cu and
    # teig_grid: the matrix and the iterate in global memory), K4 its strip
    # route (csrc/backtransform_strip.cu: a CTA a strip of columns kept in
    # global memory). No kernel caps m in shared memory any more: past
    # its fit each of K3's stages reads from global memory (teig_grid_plan
    # "global"). Both dtypes to m 16384, the size the card has been checked
    # at and the largest K4's strip plan and workspace are defined for; what
    # sets the cap past it: K4's kMaxM, and the bytes (at m 16384 a
    # complex128 Gram is 4.3 GB, K2's workspace as much again, K3's scratch
    # 6.4 GB; a sweep at chi 8192 holds its states only over a mesh of at
    # least four cards, and past it more)
    "eigh": {torch.complex64: (2, 16384), torch.complex128: (2, 16384)},
}


def use_kernel(op: str, device_type: str, dtype: torch.dtype,
               size: int) -> bool:
    """True where the call launches the kernel, False where it runs the
    plain version (a CPU tensor); raises for a call on the card that no
    kernel takes. `dtype` is the complex dtype of the call (teig's real
    input maps to its complex counterpart)."""
    reach = REACH[op]
    if device_type == "cpu":
        return False
    if dtype not in reach:
        raise TypeError(f"{op}: the CUDA kernels take "
                        f"{sorted(map(str, reach))}, got {dtype}")
    lo, hi = reach[dtype]
    if not lo <= size <= hi:
        raise ValueError(f"{op}: the CUDA kernels take {lo} <= size <= {hi} "
                         f"in {dtype}, got {size}")
    return True
