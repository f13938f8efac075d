"""Paper-fig5-style workload: 50-qubit spin-chain Trotter dynamics from the
Neel state, compiled to a shallow circuit, on the port.

Counterpart of the JAX package's `benchmarks/spin_chain.py`: first-order
Trotter of the XXZ chain H = sum_i (XX + YY + delta ZZ) + h Z from |Neel>
(`utils/targets.trotter_circuit`), compiled with brickwall pairs and
identity_resolvable layers at working chi 32 from the Neel preparation.
Reported: the overlap, the solution's two-qubit depth against the raw
Trotter circuit's, and the staggered magnetisation of both, re-simulated at
chi=64, with a check in the center-gauge engine.

    python3 -m adaptaqc_tpu_torch.workloads.spin_chain [--n 50] [--steps 3]
        [--dt 0.25] [--device cuda|cpu] [--deadline SECONDS]
        [--checkpoint-every K] [--checkpoint-dir DIR] [--results PATH]

The direct compile checkpoints and resumes as `random_mps` does.
SPIN_PARTS=1 compiles one Trotter step a part (`compile_in_parts`), saving
each part's solution; SPIN_RESUME_FROM=<saved .qasm.gz> and
SPIN_RESUME_PART=<next part> resume such a ladder. SPIN_CHI_SCHEDULE=32,64
compiles through `compile_with_chi_schedule`. SPIN_DELTA, SPIN_H,
SPIN_LAYERS, SPIN_CHI, SPIN_METHOD, SPIN_SUFF, SPIN_LOCAL,
SPIN_LOCAL_WINDOW, SPIN_POLISH_FREQ, SPIN_BLOCK_DEPTH and
SPIN_CROSS_ENGINE are the JAX benchmark's knobs.
"""

from __future__ import annotations

import argparse
import gzip
import json
import logging
import os
import sys
import time

from .. import AdaptCompiler, AdaptConfig, mps_backend_with_args
from ..circuits import operations as co
from ..circuits import qasm
from ..utils.ansatzes import identity_resolvable
from ..utils.constants import CMAP_LINEAR, generate_coupling_map
from ..utils.targets import (neel_circuit, staggered_magnetisation,
                             trotter_circuit)
from ..utils.verification import cross_engine_overlap
from . import _common

logger = logging.getLogger(__name__)


def build_compiler(n, steps, dt, device="cuda", dtype=None):
    """(compiler, target, evolution, settings) of
    `benchmarks/spin_chain.py:81-149` on `device`."""
    s = dict(delta=_common.env("SPIN_DELTA", 1.5, float),
             h=_common.env("SPIN_H", 1.0, float),
             max_layers=_common.env("SPIN_LAYERS", 800, int),
             max_chi=_common.env("SPIN_CHI", 32, int),
             # brickwall: the Trotter target is a brickwall
             method=os.environ.get("SPIN_METHOD", "brickwall"),
             sufficient=_common.env("SPIN_SUFF", 1e-2, float),
             local_cost=bool(_common.env("SPIN_LOCAL", "0", int)))
    prep = neel_circuit(n)
    evolution = trotter_circuit(n, steps, dt, delta=s["delta"], h=s["h"])
    target = prep.copy()
    co.add_to_circuit(target, evolution)
    config = AdaptConfig(method=s["method"],
                         cost_improvement_num_layers=1000,
                         sufficient_cost=s["sufficient"],
                         max_layers=s["max_layers"],
                         local_window_layers=_common.env("SPIN_LOCAL_WINDOW", 16,
                                                  int),
                         global_polish_frequency=_common.env("SPIN_POLISH_FREQ", 10,
                                                      int))
    backend = mps_backend_with_args(mps_truncation_threshold=1e-8,
                                    max_chi=s["max_chi"], dtype=dtype,
                                    device=device)
    compiler = AdaptCompiler(
        target, backend=backend, adapt_config=config,
        coupling_map=generate_coupling_map(n, CMAP_LINEAR),
        custom_layer_2q_gate=identity_resolvable(),
        starting_circuit=prep, optimise_local_cost=s["local_cost"])
    return compiler, target, evolution, s


def _compile_in_parts(compiler, n, steps, dt, s, circuits_dir):
    """One Trotter step a block (SPIN_BLOCK_DEPTH overrides), each part's
    solution saved as it lands (`benchmarks/spin_chain.py:151-199`)."""
    step_depth = trotter_circuit(n, 1, dt, delta=s["delta"],
                                 h=s["h"]).depth()
    block_depth = _common.env("SPIN_BLOCK_DEPTH", step_depth, int)
    resume_from = os.environ.get("SPIN_RESUME_FROM")
    start_part = _common.env("SPIN_RESUME_PART", "0", int)
    resume_ansatz = None
    if resume_from:
        with gzip.open(resume_from, "rt") as f:
            resume_ansatz = co.make_quantum_only_circuit(qasm.loads(f.read()))

    def save_part(i, part_result, circuit):
        path = _common.save_circuit(circuit, f"spin_n{n}_s{steps}_part{i}",
                                    circuits_dir)
        logger.warning(f"part {i}: overlap={part_result.overlap:.4f} "
                       f"saved {path}")

    result = compiler.compile_in_parts(
        max_depth_per_block=block_depth, initial_ansatz=resume_ansatz,
        start_part=start_part, part_callback=save_part)
    parts = result.individual_results
    result.qubit_pair_history = [p for r in parts
                                 for p in r.qubit_pair_history]
    result.cost_evaluations = sum(r.cost_evaluations for r in parts)
    result.part_overlaps = [r.overlap for r in parts]
    result.stop_reason = parts[-1].stop_reason if parts else None
    result.resumed_from_layer = None
    result.time_taken = sum(r.time_taken for r in parts)
    return result


def run(n=50, steps=3, dt=0.25, device="cuda", checkpoint_every=50,
        checkpoint_dir=None, circuits_dir=None, dtype=None) -> dict:
    """One spin-chain compile; returns its record (the keys of
    `benchmarks/spin_chain.py:229-259` and the port's own: device, stopped,
    resumed_from_layer, launches, the pair history and the compile wall
    summed over resumed processes)."""
    compiler, target, evolution, s = build_compiler(n, steps, dt, device,
                                                    dtype)
    raw_depth = evolution.multi_qubit_gate_depth()
    raw_2q, _ = co.find_num_gates(evolution)
    max_chi = s["max_chi"]
    schedule = os.environ.get("SPIN_CHI_SCHEDULE")
    _common.reset_kernel_launches()
    t0 = time.perf_counter()
    if _common.env("SPIN_PARTS", "0", int):
        result = _compile_in_parts(compiler, n, steps, dt, s, circuits_dir)
    elif schedule:
        chis = tuple(int(c) for c in schedule.split(","))
        result = compiler.compile_with_chi_schedule(chis=chis)
        result.resumed_from_layer = None
        max_chi = chis[-1]
    else:
        tag = f"spin_n{n}_s{steps}_chi{max_chi}_loc{int(s['local_cost'])}"
        ckdir = checkpoint_dir or os.path.join(_common.LOCAL, "checkpoints",
                                               tag)
        compiler, result = _common.compile_with_recovery(
            compiler, ckdir, checkpoint_every, device=device)
    _common.sync(device)
    wall = time.perf_counter() - t0
    launches = _common.kernel_launches()

    sol_2q, _ = co.find_num_gates(result.circuit)
    sol_depth = result.circuit.multi_qubit_gate_depth()
    circ_path = _common.save_circuit(result.circuit, f"spin_n{n}_s{steps}",
                                     circuits_dir)
    # the observable the paper's fig. 5 measures, of the solution and of
    # the raw Trotter state, and the center-gauge engine's overlap, all
    # re-simulated at chi=64
    sm_raw = staggered_magnetisation(target, 64, dtype, device)
    sm_sol = staggered_magnetisation(result.circuit, 64, dtype, device)
    engine_ov = None
    if _common.env("SPIN_CROSS_ENGINE", "1", int):
        engine_ov = cross_engine_overlap(target, result.circuit, chi=64,
                                         device=device, dtype=dtype)
    total = getattr(result, "time_taken", None) or wall
    independent = getattr(result, "independent_overlap", None)
    return {
        "workload": f"xxz_trotter_n{n}_steps{steps}_dt{dt}",
        "delta": s["delta"],
        "h": s["h"],
        "overlap": result.overlap,
        "layers": len(result.qubit_pair_history),
        "solution_2q_gates": sol_2q,
        "solution_2q_depth": sol_depth,
        "raw_2q_gates": raw_2q,
        "raw_2q_depth": raw_depth,
        "depth_reduction": raw_depth / max(sol_depth, 1),
        "wall_seconds": wall,
        "wall_seconds_total": total,
        "cost_evaluations": result.cost_evaluations,
        "max_layers": s["max_layers"],
        "working_chi": max_chi,
        "method": s["method"],
        "local_cost": s["local_cost"],
        "parts": getattr(result, "part_overlaps", None),
        "chi_schedule": [[c, float(ov)] for c, ov in
                         getattr(result, "chi_schedule", [])] or None,
        "independent_overlap": (None if independent is None
                                else float(independent)),
        "independent_engine_overlap": engine_ov,
        "sm_raw": sm_raw,
        "sm_solution": sm_sol,
        "circuit": circ_path,
        "build": _common.git_rev(),
        "platform": _common.platform(device),
        "device": _common.platform(device),
        "stopped": result.stop_reason,
        "resumed_from_layer": result.resumed_from_layer,
        "launches": launches,
        "qubit_pair_history": [list(p) for p in result.qubit_pair_history],
    }


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Compile the XXZ Trotter spin-chain workload.")
    parser.add_argument("--n", type=int, default=50)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--dt", type=float, default=0.25)
    _common.add_run_arguments(parser, "results_spin_chain.jsonl")
    args = parser.parse_args(argv)
    logging.basicConfig(stream=sys.stderr)
    logging.getLogger("adaptaqc_tpu_torch").setLevel(logging.INFO)
    _common.set_deadline(args.deadline)
    device = _common.require_device(args.device)
    _common.build_kernels(device)
    record = run(args.n, args.steps, args.dt, device, args.checkpoint_every,
                 args.checkpoint_dir, args.circuits_dir)
    line = json.dumps(record)
    print(line, flush=True)
    _common.append_record(args.results, line)


if __name__ == "__main__":
    main()
