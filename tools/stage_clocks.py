"""Where the cycles of the two redesigned kernels go, on one CUDA card.

    python3 tools/stage_clocks.py [--parent DIR]

Builds instrumented copies of the kernel sources (clock64() stamps taken by
thread 0 at each stage boundary) into tools/_build/, a git-ignored
directory, and prints:

  teig      cycles per stage (bisection, shift, inverse iteration, CGS2) at
            m = 64 and 128 on a random Gram's tridiagonal, and on the 24
            tridiagonals that one bench.py sweep (n=50, chi=64) feeds it;
            with the kernel's time on both inputs, and the same for a build
            whose divisions are plain __fdiv_rn. With --parent DIR (an
            unpacked older tree) also the older kernel's split and times.
  env_chain cycles per site (B wait, step 1, step 2, cluster barrier, sum
            of received partials) on rank 0 of each chain's cluster at
            n = 50, chi = 32 and 64, clusters of 8 and 16 CTAs, q = 25.

The stamps are thread 0's view; the stages are separated by block
barriers, so they are the block's stages. Needs nvcc and one card.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "tools", "_build")
sys.path.insert(0, ROOT)

STAMP = "  if (threadIdx.x == 0) g_stamp[{k}] = clock64();\n"
# stage boundaries of teig: (text the stamp goes before, stage it ends)
TEIG_MARKS = [
    ("  // Sturm multisection", None),
    ("  const int j = tid;\n  if (j < m) {", "bisection"),
    ("    // two rounds of inverse iteration", "shift"),
    ("  // Blocked CGS2 across columns", "inverse iteration"),
    ("  for (int idx = tid; idx < m * m; idx += nt)\n    z_out[idx]", "CGS2"),
]
# the same stages in the one-thread-a-lane kernel of the first port
TEIG_MARKS_FIRST = [
    ("  // Sturm bisection", None),
    ("  if (j < m) {\n    // shift lam_j", "bisection"),
    ("    // two rounds of inverse iteration", "shift and LU"),
    ("  // CGS2 across columns", "inverse iteration"),
    ("  for (int idx = tid; idx < m * m; idx += nt) z_out[idx] = bb[idx];",
     "CGS2"),
]
PLAIN_DIV = ("  const float q = __fdiv_rn(a == 0.f ? 1.f : a, b);\n"
             "  return a == 0.f\n",
             "  return __fdiv_rn(a, b);\n  const float q = 0.f;\n"
             "  return a == 0.f\n")
ENV_MARKS = [
    ("  for (int step = 0; step < count; ++step) {",
     "  long long acc_t[5] = {0, 0, 0, 0, 0};\n"
     "  for (int step = 0; step < count; ++step) {"),
    ("    mbar_wait(&bar, step & 1);",
     "    const long long tA = clock64();\n    mbar_wait(&bar, step & 1);\n"
     "    const long long tB = clock64();"),
    ("    cp_async_wait<1>();  // this thread's copies of A (this site) landed\n"
     "    __syncthreads();",
     "    cp_async_wait<1>();\n    __syncthreads();\n"
     "    const long long tC = clock64();"),
    ("    cluster.sync();\n    for (int idx = tid; idx < rows * c;",
     "    const long long tD = clock64();\n    cluster.sync();\n"
     "    const long long tE = clock64();\n"
     "    for (int idx = tid; idx < rows * c;"),
    ("      E[idx] = acc;\n    }\n    __syncthreads();\n  }\n",
     "      E[idx] = acc;\n    }\n    __syncthreads();\n"
     "    const long long tF = clock64();\n"
     "    acc_t[0] += tB - tA; acc_t[1] += tC - tB; acc_t[2] += tD - tC;\n"
     "    acc_t[3] += tE - tD; acc_t[4] += tF - tE;\n  }\n"
     "  if (tid == 0 && rank == 0)\n"
     "    for (int k = 0; k < 5; ++k) g_stamp[(fwd ? 0 : 8) + k] = acc_t[k];\n"
     "  if (tid == 0 && rank == 0) g_stamp[(fwd ? 0 : 8) + 6] = count;\n"),
]
ENV_MARKS += [
    # the cluster size is the kernel's own choice; this copy takes it from
    # set_cluster (0: the kernel's choice)
    ("  const int cs = pick_cluster(chi, &err);",
     "  const int cs = g_cluster ? (g_cluster < chi ? g_cluster : chi)\n"
     "                           : pick_cluster(chi, &err);"),
    ("namespace cg = cooperative_groups;",
     "namespace cg = cooperative_groups;\nstatic int g_cluster = 0;\n"
     "extern \"C\" void set_cluster(int c) { g_cluster = c; }"),
]
ENV_LABELS = ["B wait", "step 1", "step 2", "cluster barrier", "sum"]


def build(src, tag, edits):
    """Compile `src` with `edits` (text replacements) and a stamp array."""
    text = open(src).read()
    text = text.replace("namespace {", "__device__ long long g_stamp[16];\n"
                        "namespace {", 1)
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{tag}: marker not found: {old!r}")
        text = text.replace(old, new, 1)
    text += ("\nextern \"C\" int read_stamps(long long* out) {\n"
             "  return (int)cudaMemcpyFromSymbol(out, g_stamp, "
             "16 * sizeof(long long));\n}\n")
    os.makedirs(BUILD, exist_ok=True)
    cu = os.path.join(BUILD, f"{tag}.cu")
    with open(cu, "w") as f:
        f.write(text)
    so = os.path.join(BUILD, f"lib{tag}.so")
    from adaptaqc_tpu_torch.ops.cuda_lib import NVCC_FLAGS, _nvcc
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", os.path.dirname(src), "-o",
                    so, cu], check=True)
    lib = ctypes.CDLL(so)
    lib.read_stamps.argtypes = [ctypes.c_void_p]
    return lib


def stamps(lib):
    out = (ctypes.c_longlong * 16)()
    if lib.read_stamps(out) != 0:
        raise RuntimeError("reading the stamps failed")
    return np.array(out[:], dtype=np.float64)


def teig_marks(src):
    marks = TEIG_MARKS if "Blocked CGS2" in open(src).read() \
        else TEIG_MARKS_FIRST
    return marks, [(old, STAMP.format(k=k) + old)
                   for k, (old, _) in enumerate(marks)]


def sweep_tridiagonals():
    """The (d, e) of every teig launch of one bench.py sweep."""
    import chip_smoke as cs
    from adaptaqc_tpu_torch.backends import mps_core
    from adaptaqc_tpu_torch.circuits.circuit import Circuit
    from adaptaqc_tpu_torch.circuits.tape import compile_tape
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    from adaptaqc_tpu_torch.optim import sweeps
    seen = []
    kernel = ek.teig

    def record(d, e):
        seen.append((d.clone(), e.clone()))
        return kernel(d, e)
    record.launches = 0  # the wrapper counts on its module's name
    n, chi, dev = 50, 64, torch.device("cuda")
    target, ansatz = cs.bench_workload(Circuit, n, 12)
    tt, at = compile_tape(target), compile_tape(ansatz)
    prefix = mps_core.apply_tape(
        mps_core.zero_mps(n, chi, torch.complex64, dev), tt.kinds, tt.q0,
        tt.q1, tt.angles, 1e-16)
    ref = mps_core.zero_mps(n, chi, torch.complex64, dev)
    bl = sweeps.default_block_len(at.padded_length, sweeps.state_nbytes(ref))
    ek.teig = record
    try:
        sweeps.sweep(mps_core.sweep_engine(1e-16), bl, True, prefix, ref,
                     at.kinds, at.q0, at.q1, at.angles, at.trainable)
        torch.cuda.synchronize()
    finally:
        ek.teig = kernel
    return seen


def random_tridiagonal(m):
    import chip_smoke as cs
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    th = cs._gram_cases(m, np.random.default_rng(2026))["rand"]
    t = torch.tensor(th, dtype=torch.complex64, device="cuda")
    h = t.mH @ t
    _, _, d, e = ek.tridiag_plain(((h + h.mH) * 0.5).contiguous())
    return d, e


def teig_runner(lib, first_port):
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.teig_launch.argtypes = [P] * (6 if first_port else 5) + [I, P]

    def run(d, e):
        m = d.shape[0]
        b0 = ek.teig_b0(m, torch.float32, d.device)
        w = torch.empty(m, device=d.device)
        z = torch.empty(m, m, device=d.device)
        ptrs = [d.data_ptr(), e.data_ptr(), b0.data_ptr(), w.data_ptr(),
                z.data_ptr()]
        if first_port:
            scratch = torch.empty(5 * m * m, device=d.device)
            ptrs.append(scratch.data_ptr())
        rc = lib.teig_launch(*ptrs, m, torch.cuda.current_stream()
                             .cuda_stream)
        if rc:
            raise RuntimeError(f"teig launch failed: {rc}")
        return w, z
    return run


def report_teig(tag, src, sweep_inputs, edits=()):
    import chip_smoke as cs
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    marks, stamp_edits = teig_marks(src)
    lib = build(src, f"teig_{tag}", list(edits) + stamp_edits)
    run = teig_runner(lib, marks is TEIG_MARKS_FIRST)
    cases = [(f"random m={m}", [random_tridiagonal(m)]) for m in (64, 128)]
    cases.append(("sweep's 24 m=128", sweep_inputs))
    for label, inputs in cases:
        cyc = np.zeros(len(marks) - 1)
        for d, e in inputs:
            run(d, e)
            torch.cuda.synchronize()
            cyc += np.diff(stamps(lib)[:len(marks)])
        cyc /= len(inputs)
        ms = np.mean([cs.cuda_ms(lambda: run(d, e), 10, torch)
                      for d, e in inputs])
        wdiff = max(float((run(d, e)[0] - ek.teig_plain(d, e)[0]).abs().max())
                    for d, e in inputs[:4])
        print(f"teig {tag} on {label}: {ms:.4f} ms, {cyc.sum():.0f} cycles: "
              + ", ".join(f"{lab} {c:.0f} ({c / cyc.sum():.3f})"
                          for (_, lab), c in zip(marks[1:], cyc))
              + f"; max |w - w_plain| {wdiff:.1e}", flush=True)


def report_env():
    import chip_smoke as cs
    src = os.path.join(ROOT, "adaptaqc_tpu_torch", "csrc", "env_chain.cu")
    lib = build(src, "env_chain", ENV_MARKS)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.env_chain_launch.argtypes = [P] * 5 + [I] * 3 + [P]
    lib.set_cluster.argtypes = [I]
    for chi in (32, 64):
        br, bl = cs.env_inputs(torch, 50, chi, torch.device("cuda"))
        snaps = torch.empty(2, chi, chi, dtype=torch.complex64, device="cuda")
        out = torch.empty(2, 2, dtype=torch.complex64, device="cuda")
        counter = torch.zeros(1, dtype=torch.int32, device="cuda")
        for cluster in (8, 16):
            lib.set_cluster(cluster)
            launch = lambda q: lib.env_chain_launch(  # noqa: E731
                br.data_ptr(), bl.data_ptr(), snaps.data_ptr(),
                counter.data_ptr(), out.data_ptr(), 50, chi, q,
                torch.cuda.current_stream().cuda_stream)
            ms = {q: cs.cuda_ms(lambda: launch(q), 20, torch)
                  for q in (0, 25)}
            rc = launch(25)
            if rc:
                raise RuntimeError(f"env_chain launch failed: {rc}")
            torch.cuda.synchronize()
            st = stamps(lib)
            for off, chain in ((0, "forward"), (8, "backward")):
                sites = max(st[off + 6], 1)
                total = st[off:off + 5].sum() / sites
                print(f"env_chain chi={chi} cluster={cluster} (q=0 "
                      f"{ms[0]:.4f} ms, q=25 {ms[25]:.4f} ms) q=25 {chain} "
                      f"({st[off + 6]:.0f} sites): {total:.0f} cycles a site: "
                      + ", ".join(f"{lab} {st[off + k] / sites:.0f}"
                                  for k, lab in enumerate(ENV_LABELS)),
                      flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an unpacked older tree to compare")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stage_clocks: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    print(f"stage_clocks: on {cs.gpu_line()}", flush=True)
    src = os.path.join(ROOT, "adaptaqc_tpu_torch", "csrc", "eigh_tridiag.cu")
    inputs = sweep_tridiagonals()
    if args.parent:
        report_teig("parent", os.path.join(
            args.parent, "adaptaqc_tpu_torch", "csrc", "eigh_tridiag.cu"),
            inputs)
    report_teig("plain_division", src, inputs, [PLAIN_DIV])
    report_teig("this_tree", src, inputs)
    report_env()
    return 0


if __name__ == "__main__":
    sys.exit(main())
