"""The streamed env chain (K1 past chi = 128) and its plain cuBLAS chain,
profiled by kernel name on one CUDA card.

    python3 tools/env_stream_profile.py [--chi 1024] [--out FILE] [--ptxas]

At n = 50, q = 25, in complex64 and complex128: both functions' times over
20 calls (CUDA events), then one torch.profiler trace of each: the device
time of every kernel the plain chain runs, summed by name, and the streamed
kernel's launches in order, split by the host loop's stage (step 1, step 2,
their slice reductions, the combine's products and its reduction), with the
ms of one launch of each. Prints one line per function and dtype; writes
the rows as JSON to FILE. With --ptxas, first nvcc's register and spill
report for csrc/env_chain_stream.cu and the count of DMMA, DFMA and FFMA
instructions in its product kernels (cuobjdump -sass of the built
library).
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402


def ptxas_report(cuda_lib):
    src = str(cuda_lib.CSRC / "env_chain_stream.cu")
    flags = [f for f in cuda_lib.NVCC_FLAGS if f != "-shared"]
    out = subprocess.run([cuda_lib._nvcc(), *flags, "-Xptxas", "-v", "-c",
                          "-o", os.devnull, src], capture_output=True,
                         text=True)
    for line in (out.stdout + out.stderr).splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("env_stream_profile: ptxas " + line.strip(), flush=True)
    cuobj = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobj, "-sass", str(cuda_lib.library_path())],
                          capture_output=True, text=True).stdout
    fn, counts = None, {}
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and "stream_product" in fn:
            for op in ("DMMA", "DFMA", "FFMA"):
                if f" {op}" in line:
                    counts.setdefault(fn, dict.fromkeys(
                        ("DMMA", "DFMA", "FFMA"), 0))[op] += 1
    for fn, c in counts.items():
        print(f"env_stream_profile: sass {fn[:90]} {c}", flush=True)


def kernel_events(prof):
    """(name, start us, device us) of every kernel in the trace, in
    order of start."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.elapsed_us()))
    return sorted(out, key=lambda x: x[1])


def by_name(events):
    sums = {}
    for name, _, us in events:
        ms, count = sums.get(name, (0.0, 0))
        sums[name] = (ms + us / 1e3, count + 1)
    return {k: dict(ms=round(v[0], 4), launches=v[1])
            for k, v in sorted(sums.items(), key=lambda kv: -kv[1][0])}


def stream_stages(events):
    """The streamed kernel's launches grouped by the host loop's stage:
    a product launch, then its reduction of slices where it split; the
    last products and reduction are the combine's, then the combine."""
    stages = {}
    prods = [i for i, e in enumerate(events) if "product" in e[0]]
    for order, i in enumerate(prods):
        last = order == len(prods) - 1
        kind = "combine_products" if last else (
            "step1" if order % 2 == 0 else "step2")
        stages.setdefault(kind, []).append(events[i][2])
        nxt = events[i + 1] if i + 1 < len(events) else None
        if nxt is not None and "reduce" in nxt[0]:
            stages.setdefault(kind + "_reduce", []).append(nxt[2])
    comb = [e[2] for e in events if "combine" in e[0]]
    if comb:
        stages["combine"] = comb
    return {k: dict(launches=len(v), ms_total=round(sum(v) / 1e3, 4),
                    ms_per_launch=round(sum(v) / len(v) / 1e3, 5))
            for k, v in stages.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chi", type=int, default=1024)
    ap.add_argument("--out", default=None)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("env_stream_profile: no CUDA card")
    import chip_smoke as cs
    from adaptaqc_tpu_torch.ops import cuda_lib
    from adaptaqc_tpu_torch.ops import env_kernel as envk
    cuda_lib.lib()
    if args.ptxas:
        ptxas_report(cuda_lib)
    n, q, chi = 50, 25, args.chi
    dev = torch.device("cuda")
    br64, bl64 = cs.env_inputs(torch, n, chi, dev)
    rows = []
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for dt in (torch.complex64, torch.complex128):
        br, bl = br64.to(dt), bl64.to(dt)
        for fname, fn in (("env_chain_plain", envk.env_chain_plain),
                          ("env_chain", envk.env_chain)):
            ms = cs.cuda_ms(lambda: fn(br, bl, q), 20, torch)
            with torch.profiler.profile(activities=acts) as prof:
                fn(br, bl, q)
                torch.cuda.synchronize()
            ev = kernel_events(prof)
            row = dict(function=fname, dtype=str(dt)[6:], n=n, q=q, chi=chi,
                       ms=round(ms, 4),
                       device_ms=round(sum(e[2] for e in ev) / 1e3, 4),
                       kernels=by_name(ev))
            if fname == "env_chain":
                row["stages"] = stream_stages(ev)
            rows.append(row)
            print("env_stream_profile: " + json.dumps(row), flush=True)
        del br, bl
    print(f"env_stream_profile: on {cs.gpu_line()}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
