"""How far the float32 tridiagonal factors (d, e, tau) of a random Gram
drift from the float64 ones of the same algorithm, by m: the plain version
of K2 (ops/eigh_kernels.tridiag_plain) on the CPU, on chip_smoke.py's
"rand" class (a normalised complex Gaussian theta, H = theta^H theta).
Both are exact reductions up to rounding; the late factors of this Krylov
process amplify rounding, so two float32 reductions are comparable only
so deep.

    PYTHONPATH=. python tools/factor_drift.py [m ...]
"""

import sys

import numpy as np
import torch

from adaptaqc_tpu_torch.ops import eigh_kernels as ek


def drift(m, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
    t = torch.tensor(a / np.linalg.norm(a), dtype=torch.complex64)
    h = t.mH @ t
    h = ((h + h.mH) * 0.5).contiguous()
    _, tau, d, e = ek.tridiag_plain(h)
    _, tau64, d64, e64 = ek.tridiag_plain(h.to(torch.complex128))
    scale = float(h.abs().max())
    return (float((d.double() - d64).abs().max()) / scale,
            float((e.double() - e64).abs().max()) / scale,
            float((tau.to(torch.complex128) - tau64).abs().max()))


if __name__ == "__main__":
    for m in [int(x) for x in sys.argv[1:]] or [128, 256, 512]:
        dd, de, dt = drift(m)
        print(f"m={m}: float32 vs float64 factors: d {dd:.3e}, e {de:.3e} "
              f"(/ max|H|), tau {dt:.3e}")
