"""Where a compile's time goes on the card: a few layers of a checkpointed
compile under torch.profiler.

    python3 tools/compile_profile.py CHECKPOINT_DIR [--layers 3]

Loads the newest checkpoint in CHECKPOINT_DIR (written by
`adaptaqc_tpu_torch.workloads.random_mps` or `spin_chain`), runs its
compile on for --layers more layers (the final cleanup and cost included),
once unprofiled and once under torch.profiler, and prints one JSON line:
the unprofiled wall, the sum of the layers' times, the device time of the
four kernels (K1 env_chain, K2 tridiag, K3 teig, K4 backtransform) and of
all kernels, each kernel's share of the unprofiled wall, and the card's
name and power limit. Nothing is written into CHECKPOINT_DIR.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a kernel row's name holds one of these (templates and variants included)
KERNEL_NAMES = {"env_chain": "env_chain_kernel", "tridiag": "tridiag_",
                "teig": "teig_", "backtransform": "backtransform_"}


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def window(path, layers):
    """A compiler loaded from `path`, set to stop `layers` layers on."""
    from adaptaqc_tpu_torch.io import checkpoint
    compiler = checkpoint.load(path, device="cuda")
    compiler.adapt_config.max_layers = compiler.resume_from_layer + layers
    return compiler


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint_dir")
    ap.add_argument("--layers", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from adaptaqc_tpu_torch.ops import cuda_lib
    from adaptaqc_tpu_torch.workloads import _common
    if not torch.cuda.is_available():
        raise SystemExit("compile_profile: no CUDA device")
    os.environ.pop("ADAPTAQC_WALL_DEADLINE", None)
    cuda_lib.lib()
    path = _common.newest_checkpoint(args.checkpoint_dir)
    if path is None:
        raise SystemExit(f"no checkpoint in {args.checkpoint_dir}")
    compiler = window(path, args.layers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = compiler.compile()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    layer_s = sum(result.layer_times[-args.layers:])
    compiler = window(path, args.layers)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        compiler.compile()
        torch.cuda.synchronize()
    by_kernel = dict.fromkeys(KERNEL_NAMES, 0.0)
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    device_s = 0.0
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", 0) / 1e6
        if not dt or ev.key.startswith("aten::"):
            continue
        device_s += dt
        for name, part in KERNEL_NAMES.items():
            if part in ev.key:
                by_kernel[name] += dt
                launches[name] += ev.count
    print(json.dumps({
        "checkpoint": os.path.basename(path),
        "layers": args.layers, "wall_s": wall, "layer_times_s": layer_s,
        "device_s_all_kernels": device_s, "busy": device_s / wall,
        "kernel_s": by_kernel, "kernel_launches": launches,
        "kernel_share_of_wall": {k: v / wall for k, v in by_kernel.items()},
        "k1_share": by_kernel["env_chain"] / wall,
        "k2_k4_share": sum(by_kernel[k] for k in ("tridiag", "teig",
                                                  "backtransform")) / wall,
        "card": card()}), flush=True)


if __name__ == "__main__":
    main()
