"""One forward step of the compiler: a full-tape statevector cost
evaluation, the innermost object every ADAPT iteration is built from.

Counterpart of `entry()` in the JAX package's `__graft_entry__.py`
(:47-67): a 12-qubit tape of 24 random CX blocks through
`sv_core.apply_tape`, then `global_cost`.

    python3 -m adaptaqc_tpu_torch.workloads.entry [--device cuda|cpu]

prints the cost of the example tape.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..backends import sv_core
from ..circuits.circuit import Circuit
from ..circuits.tape import compile_tape
from . import _common


def example_tape(n, depth, seed=0):
    """A layer of random RY, then `depth` blocks RZ(a), CX(a, a+1),
    RX(a+1) on random adjacent pairs (`__graft_entry__._example_tape`)."""
    rng = np.random.default_rng(seed)
    qc = Circuit(n)
    for q in range(n):
        qc.ry(float(rng.uniform(-3, 3)), q)
    for _ in range(depth):
        a = int(rng.integers(n - 1))
        qc.rz(float(rng.uniform(-3, 3)), a)
        qc.cx(a, a + 1)
        qc.rx(float(rng.uniform(-3, 3)), a + 1)
    return compile_tape(qc)


def fn(state, kinds, q0, q1, angles):
    """1 - |<0|tape|state>|^2 as a real 0-dim tensor."""
    return sv_core.global_cost(sv_core.apply_tape(state, kinds, q0, q1,
                                                  angles))


def entry(device="cuda", dtype=None):
    """(fn, example_args): the 12-qubit |0> on `device` (the card unless
    the caller asks for the CPU) and the host arrays of a 24-deep tape."""
    device = _common.require_device(device)
    n = 12
    tape = example_tape(n, 24)
    return fn, (sv_core.zero_state(n, dtype, device), tape.kinds, tape.q0,
                tape.q1, tape.angles)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    f, example_args = entry(args.device)
    print(f"cost {float(f(*example_args))!r} on "
          f"{_common.platform(args.device)}")


if __name__ == "__main__":
    main()
