"""bench.py's MPS sweep for an older tree and this one, in turns, on one
CUDA card; then one profiled sweep of each.

    python3 tools/sweep_ab.py [--parent DIR] [--chi 128] [--f64]

DIR is an unpacked older tree (for example `git archive` of the parent
commit). Each run is its own process, which builds that tree's kernels and
times chip_smoke.phase_sweep REPS times (each prints the mean of three
sweeps); the order is parent, this tree, this tree, parent, so
drift on the card shows in both. Without --parent, this tree alone, twice.
The profile, in a process of its own for each tree, sums each kernel's
device time over one sweep (torch.profiler) and sets it beside the same
sweep's unprofiled wall time. --chi sets the bond dimension (64, bench.py's,
by default; 128 runs the wide variants, 256 and 512 the streamed env chain;
past 256 the target is applied at 256 and padded, as chip_smoke.py's reach
sweeps do); --f64 runs the sweep in complex128.
"""

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 3  # phase_sweep calls a process: the host time varies a lot


def sweep_args(tree, chi, dtype):
    import torch
    import chip_smoke as cs
    from adaptaqc_tpu_torch.backends import mps_core
    from adaptaqc_tpu_torch.circuits.circuit import Circuit
    from adaptaqc_tpu_torch.circuits.tape import compile_tape
    from adaptaqc_tpu_torch.optim import sweeps
    try:
        from adaptaqc_tpu_torch.workloads.bench_sweep import bench_workload
    except ImportError:  # a tree from before the workloads package

        def bench_workload(n, window):
            return cs.bench_workload(Circuit, n, window)
    n, dev = 50, torch.device("cuda")
    target, ansatz = bench_workload(n, 12)
    tt, at = compile_tape(target), compile_tape(ansatz)
    prefix = mps_core.apply_tape(
        mps_core.zero_mps(n, min(chi, 256), dtype, dev), tt.kinds, tt.q0,
        tt.q1, tt.angles, 1e-16)
    if chi > 256:
        prefix = mps_core.pad_chi(prefix, chi)
    ref = mps_core.zero_mps(n, chi, dtype, dev)
    bl = sweeps.default_block_len(at.padded_length, sweeps.state_nbytes(ref))
    return sweeps, (mps_core.sweep_engine(1e-16), bl, True, prefix, ref,
                    at.kinds, at.q0, at.q1, at.angles, at.trainable)


def run_one(tree, chi, f64):
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    import chip_smoke as cs
    from adaptaqc_tpu_torch.backends import mps_core
    from adaptaqc_tpu_torch.circuits.circuit import Circuit
    from adaptaqc_tpu_torch.circuits.tape import compile_tape
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    from adaptaqc_tpu_torch.ops import env_kernel as envk
    from adaptaqc_tpu_torch.optim import sweeps
    card = cs.gpu_line()
    dtype = torch.complex128 if f64 else torch.complex64
    for _ in range(REPS):
        if chi == 64 and not f64:
            cs.phase_sweep(torch, mps_core, sweeps, Circuit, compile_tape,
                           card)
        else:
            cs.phase_sweep(torch, mps_core, sweeps, Circuit, compile_tape,
                           card, chi=chi, ek=ek, envk=envk, dtype=dtype)


def profile(tree, tag, chi, f64):
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    from torch.profiler import ProfilerActivity
    import chip_smoke as cs
    sweeps, args = sweep_args(
        tree, chi, torch.complex128 if f64 else torch.complex64)
    for _ in range(2):
        sweeps.sweep(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweeps.sweep(*args)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        sweeps.sweep(*args)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", 0)
        if dt and not ev.key.startswith("aten::"):
            rows.append((dt / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"profile {tag} chi={chi}{' complex128' if f64 else ''}: one "
          f"sweep: {total:.2f} ms of kernel time, "
          f"unprofiled wall {wall:.2f} ms, busy {total / wall:.3f} on "
          f"{cs.gpu_line()}",
          flush=True)
    for ms, count, key in rows[:12]:
        print(f"profile {tag}: {ms:9.3f} ms {count:5d} launches  {key[:70]}",
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent")
    ap.add_argument("--chi", type=int, default=64)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--profile", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return run_one(args.one, args.chi, args.f64)
    parent = os.path.abspath(args.parent) if args.parent else None
    if args.profile:
        return profile(*((parent, "parent") if args.profile == "parent"
                         else (ROOT, "this tree")), args.chi, args.f64)
    turns = ((("parent", parent), ("this tree", ROOT), ("this tree", ROOT),
              ("parent", parent)) if parent else
             (("this tree", ROOT), ("this tree", ROOT)))
    common = (["--chi", str(args.chi)] + (["--f64"] if args.f64 else [])
              + (["--parent", parent] if parent else []))
    for tag, tree in turns:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              *common, "--one", tree],
                             capture_output=True, text=True)
        for line in out.stdout.splitlines():
            if line.startswith("sweep:"):
                print(f"ab {tag}: {line}", flush=True)
        if out.returncode:
            print(f"ab {tag} failed: {out.stderr[-2000:]}", flush=True)
            return 1
    for which in ("parent", "this") if parent else ("this",):
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             *common, "--profile", which]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
