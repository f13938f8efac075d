"""The timed Rotoselect sweep of `bench.py`, on the port.

One sweep over a window of 12 dressed-CNOT layers on random adjacent pairs,
against a 3-layer random-entangling 50-qubit target held as an MPS at
chi=64 (`bench.py:59-106`). It counts what the reference's Rotoselect
counts: 7 cost evaluations a probed rotation. Prints one JSON line:

    python3 -m adaptaqc_tpu_torch.workloads.bench_sweep [--n 50] [--chi 64]
        [--device cuda|cpu]

{"evals_per_sec": ..., ...}: evaluations a second over 10 timed sweeps
after one warm-up sweep, on the card unless given `--device cpu` (where
`--n 8 --chi 4` keeps it to seconds).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..backends import mps_core
from ..circuits.circuit import Circuit
from ..circuits.tape import compile_tape
from ..optim import sweeps
from . import _common


def bench_workload(n, window, seed=0):
    """`bench.py`'s circuits: a 3-layer random-entangling target and a
    window of `window` dressed-CNOT layers on random adjacent pairs."""
    rng = np.random.default_rng(seed)
    target = Circuit(n)
    for q in range(n):
        target.ry(float(rng.uniform(-3, 3)), q)
    for layer in range(3):
        for q in range(layer % 2, n - 1, 2):
            target.cx(q, q + 1)
        for q in range(n):
            target.rz(float(rng.uniform(-3, 3)), q)
    ansatz = Circuit(n)
    for _ in range(window):
        a = int(rng.integers(n - 1))
        ansatz.rz(0.1, a)
        ansatz.rz(0.1, a + 1)
        ansatz.cx(a, a + 1)
        ansatz.rz(0.1, a)
        ansatz.rz(0.1, a + 1)
    return target, ansatz


def build(n, chi, window, device="cuda", dtype=None):
    """(the sweep's arguments after `rotoselect`, the ansatz tape): the
    target MPS at bond dimension chi, |0>, the engine and block length."""
    target, ansatz = bench_workload(n, window)
    tt, at = compile_tape(target), compile_tape(ansatz)
    prefix = mps_core.apply_tape(mps_core.zero_mps(n, chi, dtype, device),
                                 tt.kinds, tt.q0, tt.q1, tt.angles, 1e-16)
    ref = mps_core.zero_mps(n, chi, dtype, device)
    engine = mps_core.sweep_engine(1e-16)
    bl = sweeps.default_block_len(at.padded_length, sweeps.state_nbytes(ref))
    return (engine, bl, prefix, ref), at


def run(n=50, chi=64, window=12, iters=10, device="cuda", dtype=None):
    """One warm-up sweep, then `iters` timed sweeps; returns the record."""
    (engine, bl, prefix, ref), at = build(n, chi, window, device, dtype)
    tape = (at.kinds, at.q0, at.q1, at.angles, at.trainable)
    kinds, angles, cost, _, evals_per_sweep, _ = sweeps.sweep(
        engine, bl, True, prefix, ref, *tape)
    _common.sync(device)
    t0 = time.perf_counter()
    _, _, cost, evals = sweeps.sweep_n_cycles(
        engine, bl, True, iters, prefix, ref, kinds, at.q0, at.q1, angles,
        at.trainable)
    _common.sync(device)
    dt = (time.perf_counter() - t0) / iters
    return {"evals_per_sec": evals_per_sweep / dt,
            "evals_per_sweep": evals_per_sweep,
            "ms_per_sweep": dt * 1e3,
            "probes_per_sweep": int(np.sum(at.trainable)),
            "evals_timed": evals,
            "cost": cost, "n": n, "chi": chi, "window_layers": window,
            "iters": iters, "device": _common.platform(device)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=50)
    parser.add_argument("--chi", type=int, default=64)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = _common.require_device(args.device)
    _common.build_kernels(device)
    print(json.dumps(run(args.n, args.chi, device=device)), flush=True)


if __name__ == "__main__":
    main()
