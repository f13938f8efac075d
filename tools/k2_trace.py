"""K2 (the tridiagonalization) on the Grams the reach sweeps give it, on one
CUDA card.

    python3 tools/k2_trace.py [--chi 512,1024] [--dtypes c64,c128]
        [--routes] [--sass]

For each bond dimension and dtype, one Rotoselect sweep of chip_smoke.py's
reach shape (bench.py's n=50 target applied at chi=256 and padded to chi,
12 dressed-CNOT layers) runs with a recorder around the tridiag wrapper.
Every recorded Gram (m = 2 chi) is then launched again alone: the line per
Gram gives its exactly zero rows, the steps active in the plain version
(tau != 0) and in the kernel, the last active step, the kernel's time (3
launches, CUDA events) and its bound on the kernel's own active steps
(chip_smoke.kernel_bound(..., active=...)). A summary line per sweep gives
the means and the sums. --routes instead times K2's two wide
routes against each other below the cluster's shared-memory fit (the
cluster launcher and the card-wide one on the same random Gram, in turns:
cluster, grid, grid, cluster, 10 launches each, CUDA events), at complex64
m = 256, 512, 640 and complex128 m = 256, 438. --sass instead compiles
csrc/tridiag_grid.cu alone (the package's flags) and counts, in each
instantiation of its kernel, the DMMA, DFMA, FFMA and HMMA instructions of
its SASS, and the DFMA, FFMA and HMMA between its first and last DMMA (the
trailing update's tile product).
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def sweep_grams(chi, dtype):
    """The Grams of every tridiag launch of one reach sweep at chi."""
    import chip_smoke as cs
    from adaptaqc_tpu_torch.backends import mps_core
    from adaptaqc_tpu_torch.circuits.tape import compile_tape
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    from adaptaqc_tpu_torch.optim import sweeps
    _, _, args = cs.sweep_setup(torch, mps_core, sweeps, compile_tape, chi,
                                dtype)
    seen = cs.record_eigh_inputs(torch, ek, lambda: sweeps.sweep(*args))
    return [a[0] for a in seen["tridiag"]]


def trace(chi, f64, card):
    import chip_smoke as cs
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    dtype = torch.complex128 if f64 else torch.complex64
    tag = "c128" if f64 else "c64"
    t0 = time.perf_counter()
    grams = sweep_grams(chi, dtype)
    rows = []
    for i, h in enumerate(grams):
        m = h.shape[-1]
        v, tau, d, e = ek.tridiag(h)
        _, taup, _, ep = ek.tridiag_plain(h)
        torch.cuda.synchronize()
        act = [k for k in range(m - 1) if tau[k] != 0]
        act_plain = int((taup[:-1] != 0).sum())
        cs.zeros_equal(e, tau, ep, taup, f"{tag} chi={chi} Gram {i}")
        zero_rows = int((h.abs().amax(dim=1) == 0).sum())
        ms = cs.cuda_ms(lambda: ek.tridiag(h), 3, torch)
        bound = cs.kernel_bound("tridiag", m=m, active=act, f64=f64)[0]
        rows.append((len(act), act_plain, ms, bound))
        print(f"k2 {tag} chi={chi} Gram {i}: m={m}, {zero_rows} zero rows, "
              f"active steps plain {act_plain} kernel {len(act)} (last "
              f"{act[-1] if act else -1}), {ms:.4f} ms, bound on the "
              f"active steps {bound:.5f} ms", flush=True)
    a = np.array(rows)
    print(f"k2 {tag} chi={chi}: {len(rows)} launches, active steps a Gram "
          f"plain {a[:, 1].mean():.1f} kernel {a[:, 0].mean():.1f} "
          f"(min {a[:, 0].min():.0f}, max {a[:, 0].max():.0f}), "
          f"{a[:, 2].mean():.4f} ms a launch, {a[:, 2].sum():.3f} ms in all, "
          f"bound on the active steps {a[:, 3].mean():.5f} ms a launch "
          f"({time.perf_counter() - t0:.1f} s) on {card}", flush=True)


def routes(card):
    """The cluster route against the card-wide route where both launch."""
    import chip_smoke as cs
    from adaptaqc_tpu_torch.ops import cuda_lib
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    lib = cuda_lib.lib()
    rng = np.random.default_rng(3)
    for f64, m in ((False, 256), (False, 512), (False, 640), (True, 256),
                   (True, 438)):
        dt = torch.complex128 if f64 else torch.complex64
        rdt = torch.float64 if f64 else torch.float32
        hh = cs._sym_gram(torch, cs._gram_cases(m, rng)["rand"], "cuda").to(dt)
        vrows = torch.empty_like(hh)
        tau = torch.empty(m, dtype=dt, device="cuda")
        d = torch.empty(m, dtype=rdt, device="cuda")
        e = torch.empty(m, dtype=rdt, device="cuda")
        ws = torch.empty(ek.tridiag_grid_workspace_bytes(m, f64),
                         dtype=torch.uint8, device="cuda")
        st = cuda_lib.stream_of(hh)
        ptrs = (vrows.data_ptr(), tau.data_ptr(), d.data_ptr(), e.data_ptr())
        cl = lib.tridiag_f64_launch if f64 else lib.tridiag_wide_launch
        gr = lib.tridiag_grid_f64_launch if f64 else lib.tridiag_grid_launch
        run = {"cluster": lambda: cuda_lib.check(
                   cl(hh.data_ptr(), *ptrs, m, 1, m * m, st), "cluster"),
               "grid": lambda: cuda_lib.check(
                   gr(hh.data_ptr(), ws.data_ptr(), *ptrs, m, 1, m * m, st),
                   "grid")}
        got = {k: [] for k in run}
        for k in ("cluster", "grid", "grid", "cluster"):
            got[k].append(cs.cuda_ms(run[k], 10, torch))
        print(f"k2 routes {'c128' if f64 else 'c64'} m={m}: cluster "
              f"{np.mean(got['cluster']):.4f} ms, card-wide "
              f"{np.mean(got['grid']):.4f} ms (means of two turns) on {card}",
              flush=True)


def sass_counts():
    """The card-wide K2's SASS instruction counts (nvcc and cuobjdump of
    the toolkit that builds the package)."""
    import subprocess
    import tempfile
    from adaptaqc_tpu_torch.ops.cuda_lib import CSRC, NVCC_FLAGS, _nvcc
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "tridiag_grid.cubin")
        subprocess.run([_nvcc(), *flags, "-cubin", "-o", cubin,
                        str(CSRC / "tridiag_grid.cu")], check=True)
        sass = subprocess.run([os.path.join(os.path.dirname(_nvcc()),
                                            "cuobjdump"), "-sass", cubin],
                              capture_output=True, text=True,
                              check=True).stdout
    fn, body = None, {}
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            body[fn] = []
        elif fn:
            body[fn].append(line)
    ops = ("DMMA", "DFMA", "FFMA", "HMMA")
    for fn, lines in body.items():
        count = {op: sum(f" {op}" in ln for ln in lines) for op in ops}
        at = [i for i, ln in enumerate(lines) if " DMMA" in ln]
        inner = ({op: sum(f" {op}" in ln for ln in lines[at[0]:at[-1] + 1])
                  for op in ops[1:]} if at else {})
        print(f"k2 sass {fn[-60:]}: {count}; between its first and last "
              f"DMMA {inner}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chi", default="512,1024")
    ap.add_argument("--dtypes", default="c64,c128")
    ap.add_argument("--routes", action="store_true")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    if args.sass:
        sass_counts()
        return 0
    if not torch.cuda.is_available():
        print("k2_trace: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    card = cs.gpu_line()
    if args.routes:
        routes(card)
        return 0
    for chi in map(int, args.chi.split(",")):
        for tag in args.dtypes.split(","):
            trace(chi, tag == "c128", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
