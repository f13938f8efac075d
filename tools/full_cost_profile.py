"""Where one full-cost sweep cycle spends its time on the card.

    python3 tools/full_cost_profile.py [--layers 16]

Runs chip_smoke.full_cost_workload (n=50, chi=32, a window of identity_
resolvable layers behind the spin-chain target, Rotosolve: batches of 3
probe states) for one cycle three times: a warm-up, a timed cycle (host
clock around a synchronise) and a cycle under torch.profiler. Prints the
unprofiled wall, the device's busy share (kernel time over that wall),
kernel time by name, and the host time by operator (self CPU time), the
largest first. Needs one CUDA card.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from adaptaqc_tpu_torch.backends import mps_core
    from adaptaqc_tpu_torch.optim import sweeps
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=16)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("full_cost_profile: no CUDA device", file=sys.stderr)
        return 2
    card = cs.gpu_line()
    args, probed, entries = cs.full_cost_workload(torch, mps_core,
                                                  opts.layers)

    def cycle():
        out = sweeps.sweep_full_chunked_until_converged(*args)
        torch.cuda.synchronize()
        return out

    cycle()
    for k in sweeps.full_sweep_counts:
        sweeps.full_sweep_counts[k] = 0
    t0 = time.perf_counter()
    cycle()
    wall = time.perf_counter() - t0
    counts = dict(sweeps.full_sweep_counts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cycle()
    rows = prof.key_averages()
    kernels = sorted(((r.self_device_time_total / 1e3, r.count, r.key)
                      for r in rows
                      if r.device_type.name == "CUDA"
                      and r.self_device_time_total > 0), reverse=True)
    device_ms = sum(k[0] for k in kernels)
    host = sorted(((r.self_cpu_time_total / 1e3, r.count, r.key)
                   for r in rows if r.self_cpu_time_total > 0), reverse=True)
    print(f"full_cost_profile: one Rotosolve cycle, n=50 chi=32, a window of "
          f"{opts.layers} layers ({probed} probed gates of {entries} tape "
          f"entries): wall {wall * 1e3:.2f} ms unprofiled, "
          f"{counts['batched_applies']} batched applies "
          f"({counts['batched_2q_applies']} two-qubit), "
          f"{wall * 1e3 / max(counts['batched_applies'], 1):.4f} ms an apply;"
          f" device time {device_ms:.2f} ms, busy {device_ms / (wall * 1e3):.3f}"
          f" on {card}")
    for ms, count, key in kernels[:10]:
        print(f"full_cost_profile: kernel {ms:9.3f} ms {count:6d} x "
              f"{key[:70]}")
    for ms, count, key in host[:10]:
        print(f"full_cost_profile: host   {ms:9.3f} ms {count:6d} x "
              f"{key[:70]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
