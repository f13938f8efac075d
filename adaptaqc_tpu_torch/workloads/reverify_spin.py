"""Re-measure a recorded spin-chain solution circuit and append a fresh
record, on the port.

Counterpart of the JAX package's `benchmarks/reverify_spin.py`: the saved
circuit and the target are both simulated from scratch at REVERIFY_CHI
(128) on the native eigensolver (`cplx.verification_eigh()`), normalised
by both norms; the center-gauge engine's overlap and the staggered
magnetisations are measured at chi=64. Records are append-only: the new
record names the circuit it re-measured (`reverified_from`).
`independent_overlap` is a copy of `overlap`, as the JAX script writes it.

    python3 -m adaptaqc_tpu_torch.workloads.reverify_spin CIRCUIT [n]
        [steps] [dt] [--device cuda|cpu] [--results PATH]

CIRCUIT is a gzipped QASM path (relative to the working directory unless
absolute); n, steps and dt default to 50, 1 and 0.2. SPIN_DELTA and SPIN_H
as spin_chain.py.
"""

from __future__ import annotations

import argparse
import json
import os

from ..backends import mps_core
from ..circuits import operations as co
from ..circuits.tape import compile_tape
from ..ops import cplx
from ..utils.targets import staggered_magnetisation
from ..utils.verification import cross_engine_overlap
from . import _common
from .spin_refine import spin_target


def true_overlap(target_circuit, circuit, chi, device="cuda", dtype=None):
    """|<target|circuit|0>|^2 at bond dimension chi, both sides simulated
    from scratch and normalised by both norms (the compiler's chi-doubled
    verification, standalone)."""
    n = circuit.num_qubits
    with cplx.verification_eigh():
        def sim(qc):
            tape = compile_tape(co.make_quantum_only_circuit(qc))
            return mps_core.apply_tape(
                mps_core.zero_mps(n, chi, dtype, device), tape.kinds,
                tape.q0, tape.q1, tape.angles, 1e-16)
        target = sim(target_circuit)
        state = sim(circuit)
        nrm2 = float(mps_core.mps_dot(state, state).real)
        tnrm2 = float(mps_core.mps_dot(target, target).real)
        ov = complex(mps_core.mps_dot(target, state))
        return abs(ov) ** 2 / max(nrm2 * tnrm2, 1e-30)


def reverify(circuit_path, n=50, steps=1, dt=0.2, device="cuda",
             dtype=None):
    """The fresh record of the circuit at `circuit_path`: the JAX script's
    keys and the port's device."""
    circuit = _common.load_circuit(circuit_path, os.getcwd())
    target, delta, hfield = spin_target(n, steps, dt)
    chi = _common.env("REVERIFY_CHI", 128, int)
    ov = true_overlap(target, circuit, chi, device, dtype)
    engine_ov = cross_engine_overlap(target, circuit, chi=64, device=device,
                                     dtype=dtype)
    sol_2q, _ = co.find_num_gates(circuit)
    return {
        "workload": f"xxz_trotter_n{n}_steps{steps}_dt{dt}",
        "delta": delta,
        "h": hfield,
        "overlap": ov,
        "independent_overlap": ov,
        "independent_engine_overlap": engine_ov,
        "solution_2q_gates": sol_2q,
        "solution_2q_depth": circuit.multi_qubit_gate_depth(),
        "working_chi": chi,
        "sm_raw": staggered_magnetisation(target, 64, dtype, device),
        "sm_solution": staggered_magnetisation(circuit, 64, dtype, device),
        "circuit": circuit_path,
        "reverified_from": circuit_path,
        "build": _common.git_rev(),
        "platform": _common.platform(device),
        "device": _common.platform(device),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Re-measure a saved spin-chain solution circuit.")
    parser.add_argument("circuit")
    parser.add_argument("n", nargs="?", type=int, default=50)
    parser.add_argument("steps", nargs="?", type=int, default=1)
    parser.add_argument("dt", nargs="?", type=float, default=0.2)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--results", default=os.path.join(
        _common.LOCAL, "results_spin_chain.jsonl"), metavar="PATH",
                        help="the JSONL file the record is appended to")
    args = parser.parse_args(argv)
    device = _common.require_device(args.device)
    _common.build_kernels(device)
    record = reverify(args.circuit, args.n, args.steps, args.dt, device)
    line = json.dumps(record)
    print(line, flush=True)
    _common.append_record(args.results, line)


if __name__ == "__main__":
    main()
