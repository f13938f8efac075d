"""Warm-start refinement of a recorded spin-chain compile, on the port.

Counterpart of the JAX package's `benchmarks/spin_refine.py`: the best
recorded solution circuit of an (n, steps, dt) spin-chain workload
(`workloads/spin_chain.py`'s records) is fed back through
`AdaptCompiler.compile(initial_ansatz=...)` at a higher working bond
dimension, as `refine.py` does for the random-MPS targets. The saved
circuit already holds the Neel preparation, so the refinement runs with no
starting circuit.

    python3 -m adaptaqc_tpu_torch.workloads.spin_refine [n] [steps] [dt]
        [--device cuda|cpu] [--deadline SECONDS] [--checkpoint-every K]
        [--checkpoint-dir DIR] [--results PATH] [--circuits-dir DIR]

n, steps and dt default to 50, 1 and 0.2, as in the JAX script. The
records are read from and appended to `--results` (default
`local/results_spin_chain.jsonl`). Knobs, as the JAX script's:
SPIN_REFINE_CHI (64), SPIN_REFINE_LAYERS (extra layers, 300),
SPIN_REFINE_SUFF (1e-2), SPIN_REFINE_WINDOW (max_layers_to_modify, 100),
SPIN_REFINE_LOCAL (train on the local cost), SPIN_REFINE_SOFTEN (soften the
global cost; excludes SPIN_REFINE_LOCAL: the compiler refuses both),
SPIN_REFINE_FROM (refine this circuit path only), SPIN_DELTA, SPIN_H and
SPIN_CROSS_ENGINE.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

from .. import AdaptCompiler, AdaptConfig, mps_backend_with_args
from ..circuits import operations as co
from ..utils.ansatzes import identity_resolvable
from ..utils.constants import CMAP_LINEAR, generate_coupling_map
from ..utils.targets import (neel_circuit, staggered_magnetisation,
                             trotter_circuit)
from ..utils.verification import cross_engine_overlap
from . import _common

RESULTS = os.path.join(_common.LOCAL, "results_spin_chain.jsonl")


def best_saved_circuit(workload: str, results=None):
    """(circuit path, recorded overlap) of the workload's best recorded run
    that saved its circuit; SPIN_REFINE_FROM pins one circuit path."""
    pinned = os.environ.get("SPIN_REFINE_FROM")
    best = None
    for r in _common.read_records(results or RESULTS):
        if r.get("workload") == workload and r.get("circuit"):
            if pinned and r["circuit"] != pinned:
                continue
            ov = r.get("overlap") or 0.0
            if best is None or ov > best[1]:
                best = (r["circuit"], ov)
    if best is None:
        raise SystemExit(f"no recorded circuit for workload {workload}")
    return best


def spin_target(n, steps, dt):
    """(target circuit, delta, h): the Neel preparation followed by the
    XXZ Trotter circuit, SPIN_DELTA and SPIN_H as spin_chain.py reads
    them."""
    delta = _common.env("SPIN_DELTA", 1.5, float)
    hfield = _common.env("SPIN_H", 1.0, float)
    target = neel_circuit(n)
    co.add_to_circuit(target, trotter_circuit(n, steps, dt, delta=delta,
                                              h=hfield))
    return target, delta, hfield


def refine(n=50, steps=1, dt=0.2, device="cuda", results=None,
           checkpoint_every=50, checkpoint_dir=None, circuits_dir=None,
           dtype=None):
    """One refinement of the workload's best record; returns (record,
    result). The record has the JAX script's keys and the port's own:
    device, stopped and the kernels' launches."""
    results = results or RESULTS
    chi = _common.env("SPIN_REFINE_CHI", 64, int)
    extra_layers = _common.env("SPIN_REFINE_LAYERS", 300, int)
    sufficient = _common.env("SPIN_REFINE_SUFF", 1e-2, float)
    window = _common.env("SPIN_REFINE_WINDOW", 100, int)
    local_cost = bool(_common.env("SPIN_REFINE_LOCAL", "0", int))
    soften = bool(_common.env("SPIN_REFINE_SOFTEN", "0", int))

    workload = f"xxz_trotter_n{n}_steps{steps}_dt{dt}"
    circ_path, prev_ov = best_saved_circuit(workload, results)
    ansatz = _common.load_circuit(
        circ_path, os.path.dirname(os.path.abspath(results)))
    target, delta, hfield = spin_target(n, steps, dt)

    config = AdaptConfig(method="brickwall",
                         cost_improvement_num_layers=1000,
                         sufficient_cost=sufficient, max_layers=extra_layers,
                         max_layers_to_modify=window)
    backend = mps_backend_with_args(mps_truncation_threshold=1e-8,
                                    max_chi=chi, dtype=dtype, device=device)
    compiler = AdaptCompiler(
        target, backend=backend, adapt_config=config,
        coupling_map=generate_coupling_map(n, CMAP_LINEAR),
        custom_layer_2q_gate=identity_resolvable(),
        optimise_local_cost=local_cost, soften_global_cost=soften)
    ckdir = checkpoint_dir or os.path.join(
        _common.LOCAL, "checkpoints", f"spin_refine_n{n}_s{steps}_chi{chi}")
    _common.reset_kernel_launches()
    t0 = time.perf_counter()
    compiler, result = _common.compile_with_recovery(
        compiler, ckdir, checkpoint_every, device=device,
        initial_ansatz=ansatz)
    _common.sync(device)
    wall = time.perf_counter() - t0
    launches = _common.kernel_launches()

    sol_2q, _ = co.find_num_gates(result.circuit)
    sol_depth = result.circuit.multi_qubit_gate_depth()
    saved = _common.save_circuit(result.circuit, f"spin_n{n}_s{steps}_refined",
                                 circuits_dir)
    sm_raw = staggered_magnetisation(target, 64, dtype, device)
    sm_sol = staggered_magnetisation(result.circuit, 64, dtype, device)
    engine_ov = None
    if _common.env("SPIN_CROSS_ENGINE", "1", int):
        engine_ov = cross_engine_overlap(target, result.circuit, chi=64,
                                         device=device, dtype=dtype)
    record = {
        "workload": workload,
        "delta": delta,
        "h": hfield,
        "overlap": result.overlap,
        "layers": len(result.qubit_pair_history),
        "solution_2q_gates": sol_2q,
        "solution_2q_depth": sol_depth,
        "wall_seconds": wall,
        "cost_evaluations": result.cost_evaluations,
        "working_chi": chi,
        "method": "brickwall",
        "rotosolve_window": window,
        "local_cost": local_cost,
        "softened": soften,
        "refined_from": circ_path,
        "refined_from_overlap": prev_ov,
        "independent_engine_overlap": engine_ov,
        "sm_raw": sm_raw,
        "sm_solution": sm_sol,
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
        description="Refine the best recorded spin-chain compile from its "
                    "saved circuit.")
    parser.add_argument("n", nargs="?", type=int, default=50)
    parser.add_argument("steps", nargs="?", type=int, default=1)
    parser.add_argument("dt", nargs="?", type=float, default=0.2)
    _common.add_run_arguments(parser, "results_spin_chain.jsonl")
    args = parser.parse_args(argv)
    logging.basicConfig(stream=sys.stderr)
    logging.getLogger("adaptaqc_tpu_torch").setLevel(logging.INFO)
    _common.set_deadline(args.deadline)
    device = _common.require_device(args.device)
    _common.build_kernels(device)
    record, _ = refine(args.n, args.steps, args.dt, device, args.results,
                       args.checkpoint_every, args.checkpoint_dir,
                       args.circuits_dir)
    line = json.dumps(record)
    print(line, flush=True)
    _common.append_record(args.results, line)


if __name__ == "__main__":
    main()
