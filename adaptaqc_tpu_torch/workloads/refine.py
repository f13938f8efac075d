"""Warm-start refinement of a recorded random-MPS compile, on the port.

Counterpart of the JAX package's `benchmarks/refine.py`: the best recorded
circuit of a seed (`best_saved_circuit`) is fed back through
`AdaptCompiler.compile(initial_ansatz=...)`: the ansatz goes into the full
circuit, its angles are re-optimised by one whole-range Rotosolve, then
ADAPT adds layers, at a higher working bond dimension. A run that stalled at
overlap 0.98 restarts from cost about 0.02 instead of 1 - 1e-6.

The paper's target pickles are not in the repository, so the target is the
JAX script's REFINE_N branch: `utils/targets.random_target(seed, n)`, whose
records `workloads/random_mps.py` writes with source "synthetic n=<n>".

    python3 -m adaptaqc_tpu_torch.workloads.refine [seed ...] [--n 50]
        [--device cuda|cpu] [--deadline SECONDS] [--checkpoint-every K]
        [--checkpoint-dir DIR] [--results PATH] [--circuits-dir DIR]

The records are read from and appended to `--results` (default
`local/results_random_mps.jsonl`); a record's circuit path is relative to
that file's directory unless absolute. Knobs, as the JAX script's:
REFINE_CHI (64), REFINE_LAYERS (extra layers, 300), REFINE_SUFF (8e-3),
REFINE_LOCAL (train on the local cost; the recorded overlap stays global),
REFINE_N (the target's n when --n is not given, 50) and RMPS_CROSS_ENGINE.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

from .. import AdaptCompiler, AdaptConfig, mps_backend_with_args
from ..utils.ansatzes import identity_resolvable
from ..utils.constants import CMAP_LINEAR, generate_coupling_map
from ..utils.targets import random_target
from ..utils.verification import cross_engine_overlap
from . import _common
from .random_mps import independent_overlap

RESULTS = os.path.join(_common.LOCAL, "results_random_mps.jsonl")


def best_saved_circuit(seed, source="reference paper target", results=None):
    """(circuit path, recorded overlap) of the seed's best recorded run of
    `source` that saved its circuit; the overlap is the larger of the
    compile's and its chi=64 re-check."""
    best = None
    for r in _common.read_records(results or RESULTS):
        if (r.get("seed") == seed and r.get("circuit")
                and r.get("source") == source):
            ov = max(r.get("overlap") or 0.0,
                     r.get("overlap_chi64_check") or 0.0)
            if best is None or ov > best[1]:
                best = (r["circuit"], ov)
    if best is None:
        raise SystemExit(f"no recorded circuit for seed {seed}")
    return best


def refine(seed, n, device="cuda", results=None, checkpoint_every=50,
           checkpoint_dir=None, circuits_dir=None, dtype=None):
    """One refinement of seed's best record; returns (record, result). The
    record has the JAX script's keys and the port's own: device, stopped
    and the kernels' launches."""
    results = results or RESULTS
    chi = _common.env("REFINE_CHI", 64, int)
    extra_layers = _common.env("REFINE_LAYERS", 300, int)
    sufficient = _common.env("REFINE_SUFF", 8e-3, float)
    source = f"synthetic n={n}"
    circ_path, prev_ov = best_saved_circuit(seed, source, results)
    ansatz = _common.load_circuit(
        circ_path, os.path.dirname(os.path.abspath(results)))
    qmps = random_target(seed, n=n, dtype=dtype, device=device)

    config = AdaptConfig(method="general_gradient",
                         cost_improvement_num_layers=1000,
                         sufficient_cost=sufficient, max_layers=extra_layers)
    backend = mps_backend_with_args(mps_truncation_threshold=1e-8,
                                    max_chi=chi, dtype=dtype, device=device)
    compiler = AdaptCompiler(
        qmps, backend=backend, adapt_config=config,
        coupling_map=generate_coupling_map(n, CMAP_LINEAR),
        custom_layer_2q_gate=identity_resolvable(),
        optimise_local_cost=bool(_common.env("REFINE_LOCAL", "0", int)))
    ckdir = checkpoint_dir or os.path.join(
        _common.LOCAL, "checkpoints", f"refine_seed{seed}_chi{chi}")
    _common.reset_kernel_launches()
    t0 = time.perf_counter()
    compiler, result = _common.compile_with_recovery(
        compiler, ckdir, checkpoint_every, device=device,
        initial_ansatz=ansatz)
    _common.sync(device)
    wall = time.perf_counter() - t0
    launches = _common.kernel_launches()

    overlap64 = independent_overlap(qmps, result.circuit, device=device,
                                    dtype=dtype)
    engine_ov = None
    if _common.env("RMPS_CROSS_ENGINE", "1", int):
        engine_ov = cross_engine_overlap(qmps, result.circuit, chi=64,
                                         device=device, dtype=dtype)
    saved = _common.save_circuit(result.circuit, f"seed_{seed}_refined",
                                 circuits_dir)
    record = {
        "seed": seed,
        "source": source,
        "n_qubits": n,
        "overlap": result.overlap,
        "overlap_chi64_check": overlap64,
        "working_chi": chi,
        "layers": len(result.qubit_pair_history),
        "num_2q_gates": result.num_2q_gates,
        "cnot_depth": result.cnot_depth_history[-1],
        "cost_evaluations": result.cost_evaluations,
        "wall_seconds": wall,
        "evals_per_sec": result.cost_evaluations / max(wall, 1e-9),
        "sufficient_cost": sufficient,
        "refined_from": circ_path,
        "refined_from_overlap": prev_ov,
        "independent_engine_overlap": engine_ov,
        "circuit": saved,
        "build": _common.git_rev(),
        "platform": _common.platform(device),
        "device": _common.platform(device),
        "stopped": result.stop_reason,
        "launches": launches,
    }
    return record, result


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Refine the best recorded random-MPS compile of each "
                    "seed from its saved circuit.")
    parser.add_argument("seeds", nargs="*", type=int, default=[67])
    parser.add_argument("--n", type=int,
                        default=_common.env("REFINE_N", 50, int))
    _common.add_run_arguments(parser, "results_random_mps.jsonl")
    args = parser.parse_args(argv)
    logging.basicConfig(stream=sys.stderr)
    logging.getLogger("adaptaqc_tpu_torch").setLevel(logging.INFO)
    _common.set_deadline(args.deadline)
    device = _common.require_device(args.device)
    _common.build_kernels(device)
    for seed in args.seeds:
        record, _ = refine(seed, args.n, device, args.results,
                           args.checkpoint_every, args.checkpoint_dir,
                           args.circuits_dir)
        line = json.dumps(record)
        print(line, flush=True)
        _common.append_record(args.results, line)


if __name__ == "__main__":
    main()
