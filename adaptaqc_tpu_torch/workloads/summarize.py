"""Summarise the port's workload records (random-MPS seeds and spin
chain).

Counterpart of the JAX package's `benchmarks/summarize.py`: per-seed
tallies of the random-MPS records (a seed's best is the larger of the
compile's overlap and its chi=64 re-check), the spin-chain rows, and the
best verified spin-chain record per workload beside the paper's fig. 5 CZ
rows where their CSV is given.

    python3 -m adaptaqc_tpu_torch.workloads.summarize [--markdown]
        [--converged-seed SEED] [--results-dir DIR] [--source SOURCE]
        [--paper-csv PATH]

The records are read from `results_random_mps.jsonl` and
`results_spin_chain.jsonl` in `--results-dir` (default `local/`). The
random-MPS tallies count the records of `--source` (default
"synthetic n=50", what `random_mps.py` and `refine.py` write at n=50; the
JAX script's "reference paper target" needs the paper's pickles).
`--converged-seed SEED` exits 0 if the seed has a record above 0.99, else 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import _common

HERE = _common.LOCAL
SOURCE = "synthetic n=50"


def load(name):
    return _common.read_records(os.path.join(HERE, name))


def best_overlap(record):
    vals = [record.get("overlap") or 0.0]
    if record.get("overlap_chi64_check") is not None:
        vals.append(record["overlap_chi64_check"])
    return max(vals)


def random_mps_summary(source=SOURCE):
    records = [r for r in load("results_random_mps.jsonl")
               if r.get("source") == source and r.get("seed") is not None]
    best, fastest = {}, {}
    for r in records:
        s = r["seed"]
        ov = best_overlap(r)
        best[s] = max(best.get(s, 0.0), ov)
        if ov > 0.99:
            w = r.get("wall_seconds") or float("inf")
            if s not in fastest or w < fastest[s]:
                fastest[s] = w
    converged = sorted(s for s, v in best.items() if v > 0.99)
    quickest = min(fastest, key=fastest.get) if fastest else None
    return {
        "runs": len(records),
        "seeds_tried": len(best),
        "seeds_converged": len(converged),
        "converged": converged,
        "outstanding": {s: round(v, 4) for s, v in sorted(best.items())
                        if v <= 0.99},
        "fastest_wall_s": ({"seed": quickest,
                            "wall_seconds": fastest[quickest]}
                           if fastest else None),
    }


def spin_chain_summary():
    keys = ("workload", "overlap", "solution_2q_depth", "raw_2q_depth",
            "parts", "sm_raw", "sm_solution", "wall_seconds")
    return [{k: r.get(k) for k in keys}
            for r in load("results_spin_chain.jsonl")]


def _paper_rows(paper_csv):
    """t -> (CZ depth, CZ count) of the ADAPT-AQC rows of the paper's fig. 5
    CSV (method,t,depth,count), {} without one."""
    paper = {}
    if paper_csv and os.path.exists(paper_csv):
        with open(paper_csv) as f:
            next(f)
            for line in f:
                method, t, d, c = line.strip().split(",")
                if method == "ADAPT-AQC":
                    paper[float(t)] = (int(d), int(c))
    return paper


def fig5_cz_table(paper_csv=None):
    """The best spin-chain record per workload (its strictest verified
    overlap) beside the paper's fig. 5 CZ rows. The solution's layers are
    CX-based; CZ and CX are equivalent up to one-qubit gates, so two-qubit
    depth and count compare directly. The paper's time tau is 4 t: our
    Trotter Hamiltonian is the Pauli-operator XXZ, the paper's the
    spin-1/2-operator one (H_pauli = 4 H_spin)."""
    paper = _paper_rows(paper_csv)
    best = {}
    for r in load("results_spin_chain.jsonl"):
        w = r.get("workload", "")
        checks = [v for v in (r.get("overlap"), r.get("independent_overlap"),
                              r.get("independent_engine_overlap"))
                  if v is not None]
        if not checks:
            continue
        ov = min(checks)  # strictest available verification
        if w not in best or ov > best[w][0]:
            best[w] = (ov, r)
    rows = []
    for w, (ov, r) in sorted(best.items()):
        try:
            steps = int(w.split("steps")[1].split("_")[0])
            dt = float(w.split("dt")[1])
            t = round(steps * dt, 3)
        except (IndexError, ValueError):
            t = None
        tau = 4.0 * t if t is not None else None
        pt = paper.get(tau) or (paper.get(round(tau)) if tau is not None
                                else None)
        rows.append({
            "workload": w, "t": t, "paper_tau": tau,
            "best_verified_overlap": round(ov, 4),
            "cz_depth": r.get("solution_2q_depth"),
            "cz_count": r.get("solution_2q_gates"),
            "paper_cz_depth": pt[0] if pt else None,
            "paper_cz_count": pt[1] if pt else None,
            "raw_cz_depth": r.get("raw_2q_depth"),
        })
    return rows


def markdown(rm, sc, cz, source=SOURCE):
    """The --markdown text of the three summaries."""
    lines = [f"Random-MPS targets ({source}): {rm['seeds_converged']}/"
             f"{rm['seeds_tried']} distinct seeds with a recorded >0.99 "
             f"compile ({rm['runs']} runs).",
             f"Converged: {', '.join(map(str, rm['converged']))}"]
    if rm["outstanding"]:
        lines.append("Outstanding: " + ", ".join(
            f"{s} ({v})" for s, v in rm["outstanding"].items()))
    if rm["fastest_wall_s"]:
        f = rm["fastest_wall_s"]
        lines.append(f"Fastest convergence: seed {f['seed']} in "
                     f"{f['wall_seconds']} s.")
    lines += ["", "| spin-chain workload | overlap | depth (sol/raw) | "
              "SM (sol/raw) | wall s |", "|---|---|---|---|---|"]
    for r in sc:
        sm = (f"{r['sm_solution']}/{r['sm_raw']}"
              if r["sm_solution"] is not None else "—")
        lines.append(f"| {r['workload']} | {r['overlap']} | "
                     f"{r['solution_2q_depth']}/{r['raw_2q_depth']} | {sm} |"
                     f" {r['wall_seconds']} |")
    if cz:
        lines += ["", "| fig5 workload (best verified) | t | overlap | "
                  "CZ depth (ours/paper/raw) | CZ count (ours/paper) |",
                  "|---|---|---|---|---|"]
        for r in cz:
            lines.append(f"| {r['workload']} | {r['t']} | "
                         f"{r['best_verified_overlap']} | "
                         f"{r['cz_depth']}/{r['paper_cz_depth']}/"
                         f"{r['raw_cz_depth']} | "
                         f"{r['cz_count']}/{r['paper_cz_count']} |")
    return "\n".join(lines)


def main(argv=None):
    global HERE
    parser = argparse.ArgumentParser(
        description="Summarise the port's workload records.")
    parser.add_argument("--markdown", action="store_true")
    parser.add_argument("--converged-seed", type=int, default=None)
    parser.add_argument("--results-dir", default=_common.LOCAL)
    parser.add_argument("--source", default=SOURCE)
    parser.add_argument("--paper-csv", default=None,
                        help="the paper's fig5/cz_depth_count.csv")
    args = parser.parse_args(argv)
    HERE = args.results_dir
    rm = random_mps_summary(args.source)
    if args.converged_seed is not None:
        # a queue's helper: exit 0 iff the seed has a > 0.99 record
        sys.exit(0 if args.converged_seed in rm["converged"] else 1)
    sc = spin_chain_summary()
    cz = fig5_cz_table(args.paper_csv)
    if args.markdown:
        print(markdown(rm, sc, cz, args.source))
    else:
        print(json.dumps({"random_mps": rm, "spin_chain": sc,
                          "fig5_cz": cz}, indent=1))


if __name__ == "__main__":
    main()
