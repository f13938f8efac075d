"""Where the cycles of the redesigned kernels go, on one CUDA card.

    python3 tools/stage_clocks.py [--parent DIR] [--kernels tridiag,teig,
        teig_wide,teig_grid,tridiag_wide,tridiag_grid,backtransform_ormqr,
        env_chain]

Builds instrumented copies of the kernel sources (clock64() stamps taken by
thread 0 at each stage boundary) into tools/_build/, a git-ignored
directory, and prints (--kernels picks the reports; all by default):

  tridiag   cycles a launch by stage (norm and the scans that skip
            inactive runs, matrix-vector product, reflector with s and w,
            rank-2 update; the first port's: norm with reflector and v,
            product, s and w, update), active and inactive
            steps, load cycles and the kernel's time, at m = 64 and 128 on
            a random Gram and on the 24 Grams that one bench.py sweep
            (n=50, chi=64) feeds it; with the backtransform kernel's time on
            random reflectors and on the sweep's own inputs. With --parent,
            in the order parent, this tree, this tree, parent.
  teig      cycles per stage (bisection, shift, inverse iteration, CGS2) at
            m = 64 and 128 on a random Gram's tridiagonal, and on the 24
            tridiagonals that one bench.py sweep (n=50, chi=64) feeds it;
            with the kernel's time on both inputs, and the same for a build
            whose divisions are plain __fdiv_rn. With --parent DIR (an
            unpacked older tree) also the older kernel's split and times.
  teig_grid K3's card-wide route (complex64 m > 640, complex128 m > 512)
            at m = 768, 1024, 1536, 2048 (float32) and 1024, 2048
            (float64), keep = m and m / 2: each stage's device time and
            launches (torch.profiler), their sum and the call's time; with
            --parent DIR first the parent's wide K3 at those sizes (its
            global-iterate route there) split by stage as teig_wide;
            with --variants then this tree's route with the tuning
            choices of TG_VARIANTS undone one at a time.
  teig_wide the wide K3 (complex64 128 < m <= 560, complex128 every m):
            cycles by stage (bisection, shift, inverse iteration, BCGS2
            projections, in-panel CGS2; in the cluster design also the
            cluster barriers and the exchanges of w and of the partial
            projections), on the owner of each panel for the BCGS2, and
            the kernel's time, in float32 at m = 256 and 512 and in float64
            at m = 64, 256 and 504, on a random Gram's tridiagonal and on
            the 24 tridiagonals of one chi=128 bench.py sweep (m = 256).
            With --parent, in the order parent, this tree, this tree,
            parent.
  tridiag_wide
            the wide K2 (complex64 128 < m <= 560, complex128 every m):
            cycles by stage of a step (PR 6's one CTA: row read and norm,
            reflector, product u, s and w, rank-2 update, and the inactive
            steps; the cluster design, rank 0's view: the posted rows and
            inactive rows, the pull of v, the product u and its posts, the
            two cluster barriers, the update, the next reflector), the load
            and the loop, the active and inactive steps and the kernel's
            time, in complex64 at m = 192, 256 and 512 and in complex128 at
            m = 64, 256 and 504 on a random Gram, and on the 24 Grams of
            one chi=128 bench.py sweep (m = 256) in both. With --parent, in
            the order parent, this tree, this tree, parent; with
            --variants, then this tree's kernel at other cluster sizes.
  tridiag_grid
            K2's card-wide route (complex64 m > 640, complex128 m > 438):
            CTA 0's cycles by stage (the load, the panels' flags, skipped
            steps, a column's four phases and its two grid barriers, the
            panel's end, the trailing update and its barrier) from one
            launch of the source built with TRIDIAG_GRID_STAGES, on a
            random Gram at complex64 and complex128 m = 1024 and 2048, and
            each stage's device time as its share of the instrumented
            launch's time; then the same summed over the 32 Grams of the
            chi=1024 reach sweep (chip_smoke.sweep_setup) in both dtypes.
  backtransform_ormqr
            K4 against torch.ormqr on the same reflectors, complex64 m=512
            and complex128 m=504: 20 pairs in turns, medians and spread.
  env_chain cycles per site (B wait, step 1, step 2, cluster barrier, sum
            of received partials) on rank 0 of each chain's cluster at
            n = 50, chi = 32 and 64, clusters of 8 and 16 CTAs, q = 25;
            then the complex64 wide K1 at chi = 96 and 128 by stage, with
            its times at q = 0/25/49: with --parent DIR the parent's wide
            variant too, in the order parent, this tree, this tree,
            parent.

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
# a clock read that the compiler keeps in order with the memory operations
# (and so the barriers) around it
STAMP_CLOCK = ("__device__ __forceinline__ long long stamp_clock() {\n"
               "  long long t;\n"
               "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t) :: "
               "\"memory\");\n  return t;\n}\n")
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
    # (the wide variants have no B wait: step 1 ends with A's slab landed)
    ("  for (int step = 0; step < count; ++step) {",
     "  long long acc_t[5] = {0, 0, 0, 0, 0};\n"
     "  for (int step = 0; step < count; ++step) {\n"
     "    long long tA = clock64(), tB = tA, tC = tA;"),
    ("      cp_async_wait<0>();\n      __syncthreads();\n    } else {",
     "      cp_async_wait<0>();\n      __syncthreads();\n"
     "      tC = clock64();\n    } else {"),
    ("    mbar_wait(&bar, step & 1);",
     "    tA = clock64();\n    mbar_wait(&bar, step & 1);\n"
     "    tB = clock64();"),
    ("      cp_async_wait<1>();  // this thread's copies of A (this site) "
     "landed\n      __syncthreads();",
     "      cp_async_wait<1>();\n      __syncthreads();\n"
     "      tC = clock64();"),
    ("    cluster.sync();\n    for (int idx = tid; idx < rows * c;",
     "    const long long tD = clock64();\n    cluster.sync();\n"
     "    const long long tE = clock64();\n"
     "    for (int idx = tid; idx < rows * c;"),
    ("      E[idx] = acc;\n    }\n"
     "    // the wide variant's single receive buffer: every CTA has summed it\n"
     "    // before any CTA stores the next site's partials into it\n"
     "    if (kWide)\n      cluster.sync();\n    else\n      __syncthreads();\n"
     "  }\n",
     "      E[idx] = acc;\n    }\n"
     "    if (kWide)\n      cluster.sync();\n    else\n      __syncthreads();\n"
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
    ("  const int cs = pick_cluster(chi, f64, &err);",
     "  const int cs = g_cluster ? (g_cluster < chi ? g_cluster : chi)\n"
     "                           : pick_cluster(chi, f64, &err);"),
    ("namespace cg = cooperative_groups;",
     "namespace cg = cooperative_groups;\nstatic int g_cluster = 0;\n"
     "extern \"C\" void set_cluster(int c) { g_cluster = c; }"),
]
ENV_LABELS = ["B wait", "step 1", "step 2", "cluster barrier", "sum"]

def _wide_lap(k):
    return f"    tN = clock64();\n    acc_t[{k}] += tN - tS;\n    tS = tN;\n"


# the complex64 wide K1 (csrc/env_chain_wide.cu): every CTA's cycles a site
# by stage, summed in registers of its thread 0 and stored after the loop
# into g_steps[CTA][stage] (the sites in slot ENV_WIDE_SLOTS - 1)
ENV_WIDE_LABELS = ["E wait", "step 1", "B issue", "A wait", "rfree wait",
                   "step 2 and post", "partials wait", "sum", "efree wait",
                   "post E", "(of step 2: the products)"]
ENV_WIDE_SLOTS = 12
# tuning choices of the wide K1 tried on the card (--variants): text edits
# of csrc/env_chain_wide.cu
ENV_WIDE_VARIANTS = {
    "threads512": [("constexpr int kThreads = 256;",
                    "constexpr int kThreads = 512;")],
    "step1_unroll4": [
        ("#pragma unroll 8\n    for (int b = 0; b < P.ld; b += 2) {",
         "#pragma unroll 4\n    for (int b = 0; b < P.ld; b += 2) {")],
    "step2_unroll8": [
        ("#pragma unroll 4\n      for (int a = 0; a < rows; ++a) {",
         "#pragma unroll 8\n      for (int a = 0; a < rows; ++a) {")],
}
ENV_WIDE_MARKS = [
    ("  for (int step = 0; step < count; ++step) {\n",
     "  long long acc_t[11] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  for (int step = 0; step < count; ++step) {\n"
     "    long long tS = clock64(), tN;\n"),
    ("    wait_copies<1>(&bbar, bph, P);  // Bs (this site) landed\n",
     "    wait_copies<1>(&bbar, bph, P);\n" + _wide_lap(0)),
    ("    __syncthreads();  // E_row, Bs read; M written\n",
     "    __syncthreads();\n" + _wide_lap(1)),
    ("    cp_async_commit();  // (an empty group on the last site)\n",
     "    cp_async_commit();\n" + _wide_lap(2)),
    ("    wait_copies<1>(&abar, aph, P);  // As (this site) landed\n",
     "    wait_copies<1>(&abar, aph, P);\n" + _wide_lap(3)),
    ("    if (step > 0) mbar_wait_cluster(&rfree, prev);\n",
     "    if (step > 0) mbar_wait_cluster(&rfree, prev);\n" + _wide_lap(4)
     + "    const long long t_s2 = tS;\n"),
    ("    __syncthreads();  // As read; every partial of this CTA posted\n",
     "    __syncthreads();\n" + _wide_lap(5)
     + "    acc_t[10] += g_mark[blockIdx.x] - t_s2;\n"),
    # thread 0's products end before its posts (one tile a thread at chi =
    # 128)
    ("// Step 2: this CTA's partial",
     "__device__ long long g_mark[64];\n// Step 2: this CTA's partial"),
    ("#pragma unroll\n    for (int i = 0; i < RX; ++i) {\n"
     "      const int x = xg + i * nx;",
     "    if (threadIdx.x == 0) g_mark[blockIdx.x] = clock64();\n"
     "#pragma unroll\n    for (int i = 0; i < RX; ++i) {\n"
     "      const int x = xg + i * nx;"),
    ("    mbar_wait_cluster(&rfull, ph);\n",
     "    mbar_wait_cluster(&rfull, ph);\n" + _wide_lap(6)),
    ("    __syncthreads();  // R read\n",
     "    __syncthreads();\n" + _wide_lap(7)),
    ("    mbar_wait_cluster(&efree, ph);  // the row peers are done with "
     "E_row\n",
     "    mbar_wait_cluster(&efree, ph);\n" + _wide_lap(8)),
    ("    // stage: end of the site\n  }\n",
     _wide_lap(9) + "  }\n"
     "  if (tid == 0) {\n"
     "    for (int k = 0; k < 11; ++k) g_steps[blockIdx.x][k] = acc_t[k];\n"
     f"    g_steps[blockIdx.x][{ENV_WIDE_SLOTS - 1}] = count;\n  }}\n"),
]

# tridiag: thread 0 stores a clock stamp a stage boundary of every step
# (g_steps[k]: the top, the start of the product, after each of the three
# barriers; an inactive run stores its length, negated, and its end), and
# the host sums them by stage
TRI_LABELS = ["norm and skip scans", "matrix-vector product",
              "reflector, s and w", "rank-2 update"]


def _step_stamp(slot):
    return (f"    if (tid == 0) g_steps[k][{slot}] = stamp_clock();\n")


TRI_OUT = ("  if (tid == 0) {\n"
           "    g_stamp[6] = t_loop - t_start;\n"
           "    g_stamp[7] = stamp_clock() - t_loop;\n"
           "  }\n")
TRI_DECL = "  const long long t_loop = stamp_clock();\n"
# the redesigned kernel (a step: the norm and the skip scan, the product,
# the reflector with s and w, the update; an inactive run counts its
# steps and puts its scan under the first stage)
TRI_MARKS = [
    ("  const int li = tid & (kMaxM - 1), g = tid / kMaxM;\n",
     "  const int li = tid & (kMaxM - 1), g = tid / kMaxM;\n"
     "  const long long t_start = stamp_clock();\n"),
    ("  int k = 0;\n  while (k < m - 1) {\n",
     TRI_DECL + "  int k = 0;\n  while (k < m - 1) {\n" + _step_stamp(0)),
    ("      __syncthreads();\n      k = next;\n      continue;",
     "      __syncthreads();\n"
     "      if (tid == 0) {\n        g_steps[k][1] = k - next;\n"
     "        g_steps[k][4] = stamp_clock();\n      }\n"
     "      k = next;\n      continue;"),
    ("    // 1. y_i over this row group",
     _step_stamp(1) + "    // 1. y_i over this row group"),
    ("    // 2. the reflector, u = A v",
     _step_stamp(2) + "    // 2. the reflector, u = A v"),
    ("    // 3. A[j][i] -= ", _step_stamp(3) + "    // 3. A[j][i] -= "),
    ("    __syncthreads();\n    k = k1;\n  }\n",
     "    __syncthreads();\n" + _step_stamp(4) + "    k = k1;\n  }\n"
     + TRI_OUT),
]
# the first port's kernel (norm, thread-0 scalars and v; product; s and w;
# update; every step active)
TRI_LABELS_FIRST = ["norm, reflector and v", "matrix-vector product",
                    "s and w", "rank-2 update"]
TRI_MARKS_FIRST = [
    ("  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;\n",
     "  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;\n"
     "  const long long t_start = stamp_clock();\n"),
    ("  for (int k = 0; k < m - 1; ++k) {\n    float part = 0.f;",
     TRI_DECL + "  for (int k = 0; k < m - 1; ++k) {\n" + _step_stamp(0)
     + "    float part = 0.f;"),
    ("    // u = A v (v is zero on indices <= k)",
     _step_stamp(1) + "    // u = A v (v is zero on indices <= k)"),
    ("    // s = v^H u", _step_stamp(2) + "    // s = v^H u"),
    ("    // A <- A - v w^H - w v^H",
     _step_stamp(3) + "    // A <- A - v w^H - w v^H"),
    ("    __syncthreads();\n  }\n  for (int i = tid; i < m; i += nt) d_out",
     "    __syncthreads();\n" + _step_stamp(4) + "  }\n" + TRI_OUT
     + "  for (int i = tid; i < m; i += nt) d_out"),
]


def build(src, tag, edits, steps=(128, 5)):
    """Compile `src` with `edits` (text replacements), a stamp array and a
    per-step stamp array of `steps` (rows, slots)."""
    text = open(src).read()
    text = text.replace("namespace {", "__device__ long long g_stamp[16];\n"
                        f"__device__ long long g_steps[{steps[0]}]"
                        f"[{steps[1]}];\n"
                        + STAMP_CLOCK + "namespace {", 1)
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{tag}: marker not found: {old!r}")
        text = text.replace(old, new, 1)
    text += ("\nextern \"C\" int read_steps(long long* out) {\n"
             "  return (int)cudaMemcpyFromSymbol(out, g_steps, "
             "sizeof(g_steps));\n}\n"
             "extern \"C\" int clear_steps() {\n"
             f"  static long long zero[{steps[0]}][{steps[1]}];\n"
             "  cudaMemcpyToSymbol(g_stamp, zero, 16 * sizeof(long long));\n"
             "  return (int)cudaMemcpyToSymbol(g_steps, zero, sizeof(zero));\n"
             "}\n")
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


def step_stages(lib):
    """K2's per-step stamps of the last launch, summed by stage: (cycles of
    the four stages, active steps, inactive steps, cycles outside them)."""
    out = (ctypes.c_longlong * (128 * 5))()
    if lib.read_steps(out) != 0:
        raise RuntimeError("reading the step stamps failed")
    st = np.array(out[:], dtype=np.float64).reshape(128, 5)
    cyc, n_act, n_in, covered = np.zeros(4), 0, 0, 0.0
    for row in st:
        if row[0] == 0:
            continue
        if row[1] < 0:  # an inactive run
            n_in += int(-row[1])
            cyc[0] += row[4] - row[0]
        else:
            n_act += 1
            cyc += np.diff(row)
        covered += row[4] - row[0]
    return cyc, n_act, n_in, covered


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


def sweep_inputs():
    """The arguments of every eigensolver kernel launch of one bench.py
    sweep (n=50, chi=64): chip_smoke.sweep_eigh_inputs."""
    import chip_smoke as cs
    from adaptaqc_tpu_torch.backends import mps_core
    from adaptaqc_tpu_torch.circuits.circuit import Circuit
    from adaptaqc_tpu_torch.circuits.tape import compile_tape
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    from adaptaqc_tpu_torch.optim import sweeps
    return cs.sweep_eigh_inputs(torch, ek, mps_core, sweeps, Circuit,
                                compile_tape)


def random_gram(m):
    import chip_smoke as cs
    th = cs._gram_cases(m, np.random.default_rng(2026))["rand"]
    t = torch.tensor(th, dtype=torch.complex64, device="cuda")
    h = t.mH @ t
    return ((h + h.mH) * 0.5).contiguous()


def random_tridiagonal(m):
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    _, _, d, e = ek.tridiag_plain(random_gram(m))
    return d, e


def _batch_args(lib, *strides):
    """The launchers' batch arguments (one matrix, its strides), for a
    build whose launchers take them; none for a build of an older source."""
    if not hasattr(lib, "eigh_batched_launchers"):
        return [], []
    L = ctypes.c_longlong
    return [ctypes.c_int] + [L] * len(strides), [1, *strides]


def teig_runner(lib, first_port):
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    P, I = ctypes.c_void_p, ctypes.c_int
    btypes, _ = _batch_args(lib, 0, 0)
    lib.teig_launch.argtypes = ([P] * (6 if first_port else 5) + [I] + btypes
                                + [P])

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
        rc = lib.teig_launch(*ptrs, m, *_batch_args(lib, m, m)[1],
                             torch.cuda.current_stream().cuda_stream)
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


# The wide K3 (teig_wide_kernel<T>, one CTA a matrix; the design of PR 6):
# stamps at its stage boundaries, the shift as the slowest lane's clock
# (it runs inside the lane loop, with no block barrier around it), and
# every CGS2 panel's start, projection end and end in g_steps[panel].
def _mark(k):
    return f"  if (threadIdx.x == 0) g_stamp[{k}] = stamp_clock();\n"


def _panel_mark(k):
    return (f"    if (tid == 0) g_steps[c0 / kPanel][{k}] = "
            "stamp_clock();\n")


TEIG_WIDE_ONE_CTA = [
    ("  // multisection as in teig_kernel, at least two threads a lane",
     _mark(0) + "  // multisection as in teig_kernel"),
    ("  __syncthreads();\n\n  for (int j = tid; j < m; j += nt) {\n",
     "  __syncthreads();\n" + _mark(1)
     + "  for (int j = tid; j < m; j += nt) {\n"
     "    const long long t_shift0 = stamp_clock();\n"),
    ("    for (int rep = 0; rep < 2; ++rep) {\n      T a_i = sub_rn(d[0], lam)",
     "    atomicMax((unsigned long long*)&g_stamp[15],\n"
     "              (unsigned long long)(stamp_clock() - t_shift0));\n"
     "    for (int rep = 0; rep < 2; ++rep) {\n      T a_i = sub_rn(d[0], lam)"),
    ("  // BCGS2: W = Q^T P, P -= Q W twice", _mark(2) + "  // BCGS2:"),
    ("  for (int c0 = 0; c0 < m; c0 += kPanel) {\n    const int pw = min(kPanel, "
     "m - c0);\n    for (int idx = tid; idx < m * kPanel; idx += nt) {",
     "  for (int c0 = 0; c0 < m; c0 += kPanel) {\n" + _panel_mark(0)
     + "    const int pw = min(kPanel, m - c0);\n"
     "    for (int idx = tid; idx < m * kPanel; idx += nt) {"),
    ("    for (int p = 0; p < pw; ++p) {\n      if (c0 + p == 0) continue;",
     _panel_mark(1) + "    for (int p = 0; p < pw; ++p) {\n"
     "      if (c0 + p == 0) continue;"),
    ("      if (p < pw) bb[(size_t)i * m + c0 + p] = pan[idx];\n    }\n"
     "    __syncthreads();\n  }\n",
     "      if (p < pw) bb[(size_t)i * m + c0 + p] = pan[idx];\n    }\n"
     "    __syncthreads();\n" + _panel_mark(2) + "  }\n" + _mark(3)),
]
TEIG_WIDE_ONE_CTA_LABELS = ["bisection", "shift (slowest lane)",
                            "inverse iteration", "BCGS2 projections",
                            "in-panel CGS2"]


def one_cta_stages(st, steps):
    """The PR 6 kernel's cycles by stage, and its total."""
    used = steps[steps[:, 0] != 0]
    shift = st[15]
    return ([st[1] - st[0], shift, st[2] - st[1] - shift,
             float((used[:, 1] - used[:, 0]).sum()),
             float((used[:, 2] - used[:, 1]).sum())], st[3] - st[0])


# The cluster design (teig_cluster_kernel<T>): rank 0's stage boundaries,
# the shift's slowest lane over the cluster, and for every BCGS2 panel the
# owner's cycles in its projections (pulling the panel, W and Q W), its
# cluster barriers, its exchange of partials and its in-panel CGS2 (with
# the copy of the projected panel back into its shared memory), summed
# over the panel's two passes by thread 0 of every CTA and stored by the
# owner's (g_steps[panel][0..3], [4] = 1).
def _cmark(k):
    return (f"  if (threadIdx.x == 0 && rank == 0) g_stamp[{k}] = "
            "stamp_clock();\n")


def _lap(k, indent="      "):
    return (f"{indent}if (tid == 0) {{\n{indent}  const long long t_ = "
            f"stamp_clock();\n{indent}  acc_t[{k}] += t_ - t_prev;\n"
            f"{indent}  t_prev = t_;\n{indent}}}\n")


TEIG_CLUSTER_MARKS = [
    ("  // Sturm multisection of this CTA's lanes",
     _cmark(0) + "  // Sturm multisection of this CTA's lanes"),
    ("  // every rank's eigenvalues: pulled from their owners",
     _cmark(1) + "  // every rank's eigenvalues: pulled"),
    ("  __syncthreads();\n\n  if (tid < nl) {\n",
     "  __syncthreads();\n" + _cmark(2) + "  if (tid < nl) {\n"),
    ("    T lam = add_rn(hi0, scale);\n",
     "    const long long t_shift0 = stamp_clock();\n"
     "    T lam = add_rn(hi0, scale);\n"),
    ("    // two rounds of inverse iteration on this lane's column",
     "    atomicMax((unsigned long long*)&g_stamp[15],\n"
     "              (unsigned long long)(stamp_clock() - t_shift0));\n"
     "    // two rounds of inverse iteration"),
    ("  // Distributed BCGS2 (see above)", _cmark(3) + "  // Distributed"),
    ("    const int o = c0 / L, cl0 = c0 - o * L;\n",
     "    const int o = c0 / L, cl0 = c0 - o * L;\n"
     "    long long t_prev = stamp_clock(), acc_t[4] = {0, 0, 0, 0};\n"),
    ("      if (pass > 0 || cl0 == 0)\n        cluster.sync();\n      else\n"
     "        __syncthreads();\n",
     _lap(0) + "      if (pass > 0 || cl0 == 0)\n        cluster.sync();\n"
     "      else\n        __syncthreads();\n" + _lap(1)),
    ("      cluster.sync();  // every partial is in place\n",
     _lap(0) + "      cluster.sync();\n" + _lap(1)),
    ("          if (4 * pg + q < pw) row[q] = __ldcg(row + q) - sub4[q];\n"
     "      }\n",
     "          if (4 * pg + q < pw) row[q] = __ldcg(row + q) - sub4[q];\n"
     "      }\n" + _lap(2)),
    ("    if (c0 > 0) cluster.sync();  // the panel in z_out is projected\n",
     "    if (c0 > 0) cluster.sync();\n" + _lap(1, "    ")),
    ("        cgs2_panel_rows(bb, ldb, m, c0, cl0, pw, red);\n    }\n",
     "        cgs2_panel_rows(bb, ldb, m, c0, cl0, pw, red);\n    }\n"
     + _lap(3, "    ")
     + "    if (tid == 0 && rank == o) {\n"
     "      for (int k = 0; k < 4; ++k) g_steps[c0 / kPanel][k] = acc_t[k];\n"
     "      g_steps[c0 / kPanel][4] = 1;\n    }\n"),
    ("  __syncthreads();\n  for (int idx = tid; idx < m * nl; idx += kClThreads)"
     " {\n    const int i = idx / nl, jl = idx - i * nl;\n    z_out",
     "  __syncthreads();\n" + _cmark(4)
     + "  for (int idx = tid; idx < m * nl; idx += kClThreads) {\n"
     "    const int i = idx / nl, jl = idx - i * nl;\n    z_out"),
    ("  cluster.sync();  // no CTA leaves while another may read its memory\n",
     _cmark(5) + "  cluster.sync();\n"),
]
TEIG_CLUSTER_LABELS = ["bisection", "w exchange", "shift (slowest lane)",
                       "inverse iteration", "BCGS2 projections",
                       "BCGS2 cluster barriers", "partials exchange",
                       "in-panel CGS2", "write-out"]


def cluster_stages(st, steps):
    """The cluster kernel's cycles by stage (the BCGS2 from the panels'
    owners), and its total on rank 0."""
    used = steps[steps[:, 4] != 0]
    comp, bar, exch, cgs = used[:, :4].sum(axis=0)
    shift = st[15]
    return ([st[1] - st[0], st[2] - st[1], shift, st[3] - st[2] - shift,
             comp, bar, exch, cgs, st[5] - st[4]], st[5] - st[0])


# an older cluster kernel called its in-panel CGS2 by the route's row count
# (its global-iterate route, kIterSmem = false, ran m = 641-2048)
CGS_CALL = "        cgs2_panel_rows(bb, ldb, m, c0, cl0, pw, red);\n    }\n"
CGS_CALL_PR14 = (
    "        cgs2_panel_rows<kIterSmem      ? kClCgsRowsSmem\n"
    "                        : kPanelGlobal ? kClCgsRowsWide\n"
    "                                       : kClCgsRows>(bb, ldb, m, c0, "
    "cl0, pw,\n                                                     red);\n"
    "    }\n")


def teig_wide_design(src):
    """(edits, labels, stage function, cluster) for the wide K3 in `src`:
    the cluster design of this tree or PR 6's one CTA a matrix."""
    text = open(src).read()
    if "teig_cluster_kernel" in text:
        marks = TEIG_CLUSTER_MARKS
        if CGS_CALL_PR14 in text:
            marks = [(old.replace(CGS_CALL, CGS_CALL_PR14),
                      new.replace(CGS_CALL, CGS_CALL_PR14))
                     for old, new in marks]
        return (marks, TEIG_CLUSTER_LABELS, cluster_stages, True)
    return (TEIG_WIDE_ONE_CTA, TEIG_WIDE_ONE_CTA_LABELS, one_cta_stages,
            False)


def teig_wide_runner(lib, f64):
    """Launch the instrumented wide K3 (float32) or its double
    instantiation on one matrix through the build's own launcher (all m
    eigenpairs; the launchers of a build with the card-wide route take keep
    and the scratch's stride too)."""
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.teig_f64_launch if f64 else lib.teig_wide_launch
    keep_args = hasattr(lib, "teig_grid_plan")
    fn.argtypes = [P] * 6 + ([I, I, I, L, L, L, P] if keep_args
                             else [I, I, L, L, P])
    lib.teig_wide_scratch.argtypes = [I]
    lib.teig_wide_scratch.restype = L
    lib.clear_steps.argtypes = []
    lib.read_steps.argtypes = [P]

    def run(d, e):
        m, dt, dev = d.shape[0], d.dtype, d.device
        b0 = ek.teig_b0(m, dt, dev)
        w = torch.empty(m, dtype=dt, device=dev)
        z = torch.empty(m, m, dtype=dt, device=dev)
        sn = lib.teig_wide_scratch(m)
        scratch = torch.empty(sn, dtype=dt, device=dev)
        shape = [m, m, 1, m, m, sn] if keep_args else [m, 1, m, m]
        rc = fn(d.data_ptr(), e.data_ptr(), b0.data_ptr(), w.data_ptr(),
                z.data_ptr(), scratch.data_ptr(), *shape,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"teig wide launch failed: {rc}")
        return w, z
    return run


def random_tridiagonal64(m):
    """A random complex128 Gram's tridiagonal (float64 d, e)."""
    import chip_smoke as cs
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    th = cs._gram_cases(m, np.random.default_rng(2026))["rand"]
    t = torch.tensor(th, dtype=torch.complex128, device="cuda")
    h = t.mH @ t
    _, _, d, e = ek.tridiag_plain(((h + h.mH) * 0.5).contiguous())
    return d, e


def build_teig_wide(tag, src):
    """An instrumented build of `src` and its wide K3 design."""
    design = teig_wide_design(src)
    return build(src, f"teig_wide_{tag}", design[0]), design


def report_teig_wide(tag, lib, design, sweep128):
    """The wide K3's cycles by stage and its time (CUDA events, on the
    instrumented build) in float32 at m = 256 and 512 and in float64 at
    m = 64, 256 and 504, on a random Gram's tridiagonal and (m = 256) on
    the 24 tridiagonals of one chi=128 bench.py sweep."""
    import chip_smoke as cs
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    _, labels, stages, cluster = design
    sweep64 = [(d.double(), e.double()) for d, e in sweep128]
    cases = [(False, "random m=256", [random_tridiagonal(256)]),
             (False, "random m=512", [random_tridiagonal(512)]),
             (False, f"the chi=128 sweep's {len(sweep128)} m=256", sweep128),
             (True, "random m=64", [random_tridiagonal64(64)]),
             (True, "random m=256", [random_tridiagonal64(256)]),
             (True, f"the chi=128 sweep's {len(sweep64)} m=256", sweep64),
             (True, "random m=504", [random_tridiagonal64(504)])]
    for f64, label, inputs in cases:
        run = teig_wide_runner(lib, f64)
        cyc, total = np.zeros(len(labels)), 0.0
        for d, e in inputs:
            lib.clear_steps()
            run(d, e)
            torch.cuda.synchronize()
            out = (ctypes.c_longlong * (128 * 5))()
            if lib.read_steps(out) != 0:
                raise RuntimeError("reading the step stamps failed")
            c, t = stages(stamps(lib), np.array(out[:], dtype=np.float64)
                          .reshape(128, 5))
            cyc += np.asarray(c, dtype=np.float64)
            total += t
        cyc, total = cyc / len(inputs), total / len(inputs)
        ms = np.mean([cs.cuda_ms(lambda: run(d, e), 10, torch)
                      for d, e in inputs])
        d, e = inputs[0]
        wdiff = float((run(d, e)[0] - ek.teig_plain(d, e)[0]).abs().max())
        size = (f", clusters of {lib.teig_cluster_size(d.shape[0], int(f64))}"
                " CTAs" if cluster else ", one CTA")
        print(f"teig wide {tag} {'float64' if f64 else 'float32'} on {label}"
              f"{size}: {ms:.4f} ms, {total:.0f} cycles: "
              + ", ".join(f"{lab} {c:.0f} ({c / max(total, 1):.3f})"
                          for lab, c in zip(labels, cyc))
              + f"; max |w - w_plain| {wdiff:.1e}", flush=True)


# K3's card-wide route: its launches by kernel name, and what each stage is
TEIG_GRID_STAGES = (("tg_bisect_kernel", "multisection"),
                    ("tg_invit_kernel", "shift and inverse iteration"),
                    ("tg_wpart_kernel", "W = Q^T P slab partials"),
                    ("tg_wsum_kernel", "W slab sums"),
                    ("tg_update_kernel", "P -= Q W"),
                    ("tg_inblock_kernel", "in-block CGS2"))
TEIG_GRID_SIZES = ((False, 768), (False, 1024), (False, 1536),
                   (False, 2048), (True, 1024), (True, 2048))


# teig_grid's tuning choices, each a text edit of this tree's source
# (--variants): the in-block CGS2's rows a rank and threads a CTA, one CTA
# wherever the block fits, the multisection's threads a lane, the W
# partials' slab and Q columns a thread
TG_VARIANTS = {
    "inblock_rows256_threads256": [
        ("constexpr int kTgInThreads = 128;",
         "constexpr int kTgInThreads = 256;"),
        ("constexpr int kTgInRows = 128;", "constexpr int kTgInRows = 256;")],
    "inblock_fewest_ranks": [
        ("constexpr int kTgInRows = 128;",
         "constexpr int kTgInRows = 1 << 20;")],
    "bisect_16_threads_a_lane": [
        ("constexpr int kTgThreads = 256;", "constexpr int kTgThreads = 128;"),
        ("constexpr int kTgLaneThreads = 32;",
         "constexpr int kTgLaneThreads = 16;"),
        ("constexpr int k = 5;  // log2", "constexpr int k = 4;  // log2")],
    "slab128": [("constexpr int kTgSlab = 64;", "constexpr int kTgSlab = 128;")],
    "wpart_one_column": [("constexpr int kTgWCols = 2;",
                          "constexpr int kTgWCols = 1;")],
}


def build_plain(src, variants):
    """{tag: `src` with that tag's text edits compiled as the package
    compiles it (no stamps), its K3 launchers typed}, one nvcc process a
    tag, all started together."""
    from adaptaqc_tpu_torch.ops.cuda_lib import NVCC_FLAGS, _nvcc
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for tag, edits in variants.items():
        text = open(src).read()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{tag}: marker not found: {old!r}")
            text = text.replace(old, new, 1)
        cu = os.path.join(BUILD, f"teig_grid_{tag}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(BUILD, f"libteig_grid_{tag}.so")
        procs[tag] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", os.path.dirname(src), "-o", so,
             cu]))
    libs = {}
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for tag, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"{tag}: nvcc failed")
        lib = ctypes.CDLL(so)
        for fn in (lib.teig_wide_launch, lib.teig_f64_launch):
            fn.argtypes = [P] * 6 + [I, I, I, L, L, L, P]
        lib.teig_wide_scratch.argtypes = [I]
        lib.teig_wide_scratch.restype = L
        libs[tag] = lib
    return libs


def report_teig_grid(tag, lib):
    """K3's card-wide route through `lib`'s own launcher on a random Gram's
    tridiagonal at TEIG_GRID_SIZES, keep = m and m / 2: each stage's device
    time and launches from one profiled call (torch.profiler, kernel rows
    only), their sum, and the call's time by CUDA events (3 calls; the rest
    is the card idle between launches)."""
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    for f64, m in TEIG_GRID_SIZES:
        d, e = random_tridiagonal64(m) if f64 else random_tridiagonal(m)
        dt, dev = d.dtype, d.device
        b0 = ek.teig_b0(m, dt, dev)
        w = torch.empty(m, dtype=dt, device=dev)
        z = torch.empty(m, m, dtype=dt, device=dev)
        sn = lib.teig_wide_scratch(m)
        scratch = torch.empty(sn, dtype=dt, device=dev)
        fn = lib.teig_f64_launch if f64 else lib.teig_wide_launch
        wp = ek.teig_plain(d, e)[0]
        for keep in (m, m // 2):
            def run():
                rc = fn(d.data_ptr(), e.data_ptr(), b0.data_ptr(),
                        w.data_ptr(), z.data_ptr(), scratch.data_ptr(), m,
                        keep, 1, m, m, sn,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"teig launch failed: {rc}")
            run()
            torch.cuda.synchronize()
            wdiff = float((w[:keep] - wp[:keep]).abs().max())
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            by = {name: [0.0, 0] for name, _ in TEIG_GRID_STAGES}
            for ev in prof.key_averages():
                dt_us = getattr(ev, "self_device_time_total", 0)
                for name, _ in TEIG_GRID_STAGES:
                    if dt_us and name in ev.key and not ev.key.startswith(
                            "aten::"):
                        by[name][0] += dt_us / 1e3
                        by[name][1] += ev.count
            busy = sum(v[0] for v in by.values())
            ms = cs.cuda_ms(run, 3, torch)
            print(f"teig grid {tag} {'float64' if f64 else 'float32'} "
                  f"m={m} keep={keep}: {ms:.4f} ms, kernels {busy:.4f} ms "
                  f"(idle {1 - busy / ms:.3f}): "
                  + ", ".join(f"{lab} {by[n][0]:.4f} ms ({by[n][1]})"
                              for n, lab in TEIG_GRID_STAGES)
                  + f"; max |w - w_plain| {wdiff:.1e}", flush=True)


def report_teig_global_parent(lib, design):
    """The parent's wide K3 at TEIG_GRID_SIZES (an older tree's: its
    global-iterate route there), cycles by stage as report_teig_wide
    splits them, and its time."""
    import chip_smoke as cs
    _, labels, stages, _ = design
    for f64, m in TEIG_GRID_SIZES:
        d, e = random_tridiagonal64(m) if f64 else random_tridiagonal(m)
        run = teig_wide_runner(lib, f64)
        lib.clear_steps()
        run(d, e)
        torch.cuda.synchronize()
        out = (ctypes.c_longlong * (128 * 5))()
        if lib.read_steps(out) != 0:
            raise RuntimeError("reading the step stamps failed")
        cyc, total = stages(stamps(lib), np.array(out[:], dtype=np.float64)
                            .reshape(128, 5))
        ms = cs.cuda_ms(lambda: run(d, e), 3, torch)
        print(f"teig global parent {'float64' if f64 else 'float32'} m={m}: "
              f"{ms:.4f} ms, {total:.0f} cycles: "
              + ", ".join(f"{lab} {c:.0f} ({c / max(total, 1):.3f})"
                          for lab, c in zip(labels, cyc)), flush=True)


def tridiag_runner(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tridiag_launch.argtypes = ([P] * 5 + [I] + _batch_args(lib, 0)[0]
                                   + [P])

    def run(h):
        m = h.shape[0]
        out = (torch.empty((m, m), dtype=torch.complex64, device=h.device),
               torch.empty(m, dtype=torch.complex64, device=h.device),
               torch.empty(m, device=h.device),
               torch.empty(m, device=h.device))
        rc = lib.tridiag_launch(h.data_ptr(), *(t.data_ptr() for t in out), m,
                                *_batch_args(lib, m * m)[1],
                                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"tridiag launch failed: {rc}")
        return out
    return run


def backtransform_runner(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.backtransform_launch.argtypes = ([P] * 4 + [I, I]
                                         + _batch_args(lib, 0, 0, 0)[0] + [P])

    def run(vrows, tau, z, keep):
        m = vrows.shape[0]
        out = torch.empty((m, keep), dtype=torch.complex64, device=z.device)
        rc = lib.backtransform_launch(
            vrows.data_ptr(), tau.data_ptr(), z.data_ptr(), out.data_ptr(), m,
            keep, *_batch_args(lib, m * m, m, m * m)[1],
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"backtransform launch failed: {rc}")
        return out
    return run


def build_tridiag(tag, src):
    """An instrumented build of `src` and its K2 stage labels."""
    marks, labels = ((TRI_MARKS, TRI_LABELS)
                     if "kTriThreads" in open(src).read()
                     else (TRI_MARKS_FIRST, TRI_LABELS_FIRST))
    lib = build(src, f"tridiag_{tag}", marks)
    lib.clear_steps.argtypes = []
    lib.read_steps.argtypes = [ctypes.c_void_p]
    return lib, labels


def report_tridiag(tag, lib, labels, inputs):
    """K2's cycles by stage and its time (CUDA events, on this instrumented
    build), and K4's time, on random Grams and on the sweep's own inputs."""
    import chip_smoke as cs
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    run, bt = tridiag_runner(lib), backtransform_runner(lib)
    cases = [(f"random m={m}", [random_gram(m)]) for m in (64, 128)]
    cases.append((f"sweep's {len(inputs['tridiag'])} m=128",
                  [a[0] for a in inputs["tridiag"]]))
    for label, grams in cases:
        cyc, n_act, n_in, load, loop, covered = np.zeros(4), 0, 0, 0, 0, 0
        for h in grams:
            lib.clear_steps()
            run(h)
            torch.cuda.synchronize()
            c, a, i, cov = step_stages(lib)
            st = stamps(lib)
            cyc += c
            n_act += a
            n_in += i
            covered += cov
            load += st[6]
            loop += st[7]
        cnt = len(grams)
        cyc, n_act, n_in = cyc / cnt, n_act / cnt, n_in / cnt
        load, loop, covered = load / cnt, loop / cnt, covered / cnt
        ms = np.mean([cs.cuda_ms(lambda: run(h), 10, torch) for h in grams])
        ddiff = max(float((run(h)[2] - ek.tridiag_plain(h)[2]).abs().max())
                    for h in grams[:4])
        print(f"tridiag {tag} on {label}: {ms:.4f} ms; {n_act:.1f} active "
              f"and {n_in:.1f} inactive steps; load {load:.0f} cycles, loop "
              f"{loop:.0f}: "
              + ", ".join(f"{lab} {c:.0f} ({c / max(loop, 1):.3f})"
                          for lab, c in zip(labels, cyc))
              + f", between steps {loop - covered:.0f}; "
              f"{cyc.sum() / max(n_act, 1):.0f} cycles an active step; max "
              f"|d - d_plain| {ddiff:.1e}", flush=True)
    for m in (64, 128):
        vp, taup, dp, ep = ek.tridiag_plain(random_gram(m))
        _, zp = ek.teig_plain(dp, ep)
        ms = cs.cuda_ms(lambda: bt(vp, taup, zp, m // 2), 20, torch)
        print(f"backtransform {tag} on random m={m} keep={m // 2}: "
              f"{ms:.4f} ms", flush=True)
    sweep = inputs["backtransform"]
    ms = np.mean([cs.cuda_ms(lambda: bt(*a), 10, torch) for a in sweep])
    err = max(float((bt(*a) - ek.backtransform_plain(*a)).abs().max())
              for a in sweep)
    print(f"backtransform {tag} on the sweep's {len(sweep)} inputs: "
          f"{ms:.4f} ms, max |out - plain| {err:.1e}", flush=True)


# The wide K2. Every step's stamps go to g_steps[k] (slot 8: 1 for an
# active step, 2 for an inactive one of the one-CTA kernel), taken by
# thread 0 (of rank 0 in the cluster design); g_stamp[6] and [7] hold the
# load's and the step loop's cycles.
TW_STEPS = (2048, 9)  # K2's steps (m <= 2048) and slots


def _tw(slot, indent="    "):
    return f"{indent}if (tid == 0) g_steps[k][{slot}] = stamp_clock();\n"


TW_OUT = ("  if (tid == 0 && {cond}) {{\n"
          "    g_stamp[6] = t_loop - t_start;\n"
          "    g_stamp[7] = stamp_clock() - t_loop;\n  }}\n")
# PR 6's kernel, one CTA of 1024 threads a matrix, A in global memory
TW_ONE_CTA = [
    ("  const T zero = 0, one = 1;\n\n  for (int idx = tid; idx < m * m; "
     "idx += kWideThreads) work[idx] = h[idx];",
     "  const T zero = 0, one = 1;\n  const long long t_start = stamp_clock();"
     "\n  for (int idx = tid; idx < m * m; idx += kWideThreads) work[idx] = "
     "h[idx];"),
    ("  for (int k = 0; k < m - 1; ++k) {\n    const int k1 = k + 1;\n"
     "    T part = zero;\n",
     "  const long long t_loop = stamp_clock();\n"
     "  for (int k = 0; k < m - 1; ++k) {\n    const int k1 = k + 1;\n"
     "    T part = zero;\n" + _tw(0)),
    ("    const T ss = block_sum(part, red);\n",
     "    const T ss = block_sum(part, red);\n" + _tw(1)),
    ("        e_out[k] = zero;\n      }\n      continue;",
     "        e_out[k] = zero;\n      }\n"
     "      if (tid == 0) {\n        g_steps[k][8] = 2;\n"
     "        g_steps[k][6] = stamp_clock();\n      }\n      continue;"),
    ("    __syncthreads();\n    const V gam = make_c(scal[0], scal[1]);",
     "    __syncthreads();\n" + _tw(2)
     + "    const V gam = make_c(scal[0], scal[1]);"),
    ("    // u = A v over the trailing block, a warp a row",
     _tw(3) + "    // u = A v over the trailing block, a warp a row"),
    ("    __syncthreads();\n    V sp = make_c(zero, zero);",
     "    __syncthreads();\n" + _tw(4) + "    V sp = make_c(zero, zero);"),
    ("    // A[j][i] -= v_j conj(w_i) + w_j conj(v_i), rounded as written: the",
     _tw(5) + "    // A[j][i] -= v_j conj(w_i) + w_j conj(v_i), rounded as "
     "written: the"),
    ("      a = make_c(sub_rn(a.x, re), sub_rn(a.y, im));\n    }\n"
     "    __syncthreads();\n  }\n",
     "      a = make_c(sub_rn(a.x, re), sub_rn(a.y, im));\n    }\n"
     "    __syncthreads();\n" + _tw(6)
     + "    if (tid == 0) g_steps[k][8] = 1;\n  }\n"
     + TW_OUT.format(cond="true")),
]
TW_ONE_CTA_LABELS = ["row read and norm", "reflector", "v", "product u",
                     "s and w", "rank-2 update"]


def _tws(slot):
    return f"    if (tid == 0) ts_[{slot}] = stamp_clock();\n"


# the cluster design (tridiag_cluster_kernel<T>): rank 0's stages of an
# active step
TW_CLUSTER = [
    ("  const V czero = make_c(zero, zero);\n  auto row = [&](int l)",
     "  const V czero = make_c(zero, zero);\n"
     "  const long long t_start = stamp_clock();\n  auto row = [&](int l)"),
    ("  int k = next_active(-1);\n",
     "  const long long t_loop = stamp_clock();\n  int k = next_active(-1);\n"),
    ("  for (int it = 0; k < m - 1;) {\n    const int p = it & 1;\n",
     "  for (int it = 0; k < m - 1;) {\n    const int p = it & 1;\n"
     "    long long ts_[5];\n" + _tws(0)),
    ("    const int k1 = k + 1;\n    if (rank == k % G) {\n",
     _tws(1) + "    const int k1 = k + 1;\n    if (rank == k % G) {\n"),
    ("    // every CTA's u: each CTA releases",
     _tws(2) + "    // every CTA's u: each CTA releases"),
    ("    __syncwarp();\n    if (l0 + warp < nr) {\n",
     "    __syncwarp();\n" + _tws(3) + "    if (l0 + warp < nr) {\n"),
    ("    __syncthreads();\n    k = k1;\n    ++it;\n  }\n",
     "    __syncthreads();\n" + _tws(4) + "    if (tid == 0 && rank == 0) {\n"
     "      for (int q = 0; q < 5; ++q) g_steps[k][q] = ts_[q];\n"
     "      g_steps[k][8] = 1;\n    }\n"
     "    k = k1;\n    ++it;\n  }\n" + TW_OUT.format(cond="rank == 0")),
]
TW_CLUSTER_LABELS = ["wait for the step's message",
                     "vrows, product u and posts", "all-gather of u",
                     "s, w, update and next message"]
# other cluster sizes for this tree's kernel (--variants): G = ceil(m / 8)
# or ceil(m / 32)
TW_VARIANTS = {
    "rows8": [("constexpr int kTcRowsPerCta = 16;",
               "constexpr int kTcRowsPerCta = 8;")],
    "rows32": [("constexpr int kTcRowsPerCta = 16;",
                "constexpr int kTcRowsPerCta = 32;")],
}


def tridiag_wide_design(src):
    """(edits, labels) for the wide K2 in `src`: the cluster design of
    this tree or the one CTA a matrix of PR 6."""
    if "tridiag_cluster_kernel" in open(src).read():
        return TW_CLUSTER, TW_CLUSTER_LABELS
    return TW_ONE_CTA, TW_ONE_CTA_LABELS


def tridiag_wide_stages(steps, nlab):
    """(cycles by stage, inactive-run cycles) summed over the steps."""
    cyc, inactive = np.zeros(nlab), 0.0
    for row in steps:
        if row[8] == 1:
            cyc += np.diff(row[:nlab + 1])
        elif row[8] == 2:
            inactive += row[6] - row[0]
    return cyc, inactive


def tridiag_wide_runner(lib, f64):
    """Launch the instrumented wide K2 (complex64) or its double
    instantiation on one matrix through the build's own launcher."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.tridiag_f64_launch if f64 else lib.tridiag_wide_launch
    # since the card-wide route took the sizes past the cluster's shared
    # memory, the cluster launcher has no `work` matrix
    spill = not hasattr(lib, "tridiag_routes")
    fn.argtypes = [P] * (6 if spill else 5) + [I, I, L, P]

    def run(h):
        m, dev = h.shape[0], h.device
        rdt = torch.float64 if f64 else torch.float32
        work, vrows = torch.empty_like(h), torch.empty_like(h)
        tau = torch.empty(m, dtype=h.dtype, device=dev)
        d = torch.empty(m, dtype=rdt, device=dev)
        e = torch.empty(m, dtype=rdt, device=dev)
        ptrs = ([h.data_ptr(), work.data_ptr()] if spill
                else [h.data_ptr()])
        rc = fn(*ptrs, vrows.data_ptr(), tau.data_ptr(), d.data_ptr(),
                e.data_ptr(), m, 1, m * m,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"tridiag wide launch failed: {rc}")
        return vrows, tau, d, e
    return run


def random_gram64(m):
    """A random complex128 Gram, exactly Hermitian."""
    import chip_smoke as cs
    th = cs._gram_cases(m, np.random.default_rng(2026))["rand"]
    t = torch.tensor(th, dtype=torch.complex128, device="cuda")
    h = t.mH @ t
    return ((h + h.mH) * 0.5).contiguous()


def build_tridiag_wide(tag, src, extra=()):
    edits, labels = tridiag_wide_design(src)
    lib = build(src, f"tridiag_wide_{tag}", list(extra) + edits, TW_STEPS)
    lib.clear_steps.argtypes = []
    lib.read_steps.argtypes = [ctypes.c_void_p]
    return lib, labels


def report_tridiag_wide(tag, lib, labels, sweep128, sizes=None):
    """The wide K2's cycles by stage (rank 0's view in the cluster design)
    and its time (CUDA events, on the instrumented build), with its active
    and inactive steps, in complex64 at m = 192, 256 and 512 and in
    complex128 at m = 64, 256 and 504 on a random Gram, and on the 24
    Grams of one chi=128 bench.py sweep (m = 256) in both; or, given
    `sizes` ((f64, m), ...), on a random Gram at each of them alone."""
    import chip_smoke as cs
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    if sizes:
        cases = [(f64, f"random m={m}",
                  [random_gram64(m) if f64 else random_gram(m)])
                 for f64, m in sizes]
    else:
        sweep64 = [h.to(torch.complex128) for h in sweep128]
        cases = [(False, f"random m={m}", [random_gram(m)]) for m in
                 (192, 256, 512)]
        cases.append((False, f"the chi=128 sweep's {len(sweep128)} m=256",
                      sweep128))
        cases += [(True, f"random m={m}", [random_gram64(m)]) for m in
                  (64, 256, 504)]
        cases.append((True, f"the chi=128 sweep's {len(sweep64)} m=256",
                      sweep64))
    for f64, label, grams in cases:
        m = grams[0].shape[-1]
        if hasattr(lib, "tridiag_routes") and lib.tridiag_routes(m, int(f64)):
            print(f"tridiag wide {tag}: m={m} runs the card-wide route "
                  "(--kernels tridiag_grid)", flush=True)
            continue
        run = tridiag_wide_runner(lib, f64)
        cyc, inact_cyc, load, loop, n_act = np.zeros(len(labels)), 0.0, 0, 0, 0
        for h in grams:
            lib.clear_steps()
            out = run(h)
            torch.cuda.synchronize()
            raw = (ctypes.c_longlong * (TW_STEPS[0] * TW_STEPS[1]))()
            if lib.read_steps(raw) != 0:
                raise RuntimeError("reading the step stamps failed")
            c, ic = tridiag_wide_stages(
                np.array(raw[:], dtype=np.float64).reshape(TW_STEPS),
                len(labels))
            st = stamps(lib)
            cyc, inact_cyc = cyc + c, inact_cyc + ic
            load, loop = load + st[6], loop + st[7]
            n_act += int((out[3][:-1] != 0).sum())
        cnt = len(grams)
        cyc, inact_cyc, load, loop = (cyc / cnt, inact_cyc / cnt, load / cnt,
                                      loop / cnt)
        m = grams[0].shape[0]
        act = n_act / cnt
        ms = np.mean([cs.cuda_ms(lambda: run(h), 10, torch) for h in grams])
        err = cs.tridiag_residual(torch, ek, *run(grams[0]), grams[0])
        plan = ""
        if hasattr(lib, "tridiag_cluster_size"):
            g = lib.tridiag_cluster_size(m, int(f64))
            rows = -(-m // g)
            rs = (lib.tridiag_smem_rows(m, int(f64))
                  if hasattr(lib, "tridiag_smem_rows") else rows)
            plan = (f", clusters of {g} CTAs, {rs} of {rows} rows a CTA in "
                    "shared memory")
        else:
            plan = ", one CTA"
        print(f"tridiag wide {tag} {'complex128' if f64 else 'complex64'} on "
              f"{label}{plan}: {ms:.4f} ms; {act:.1f} active and "
              f"{m - 1 - act:.1f} inactive steps; load {load:.0f} cycles, "
              f"loop {loop:.0f}: "
              + ", ".join(f"{lab} {c:.0f} ({c / max(loop, 1):.3f})"
                          for lab, c in zip(labels, cyc))
              + (f", inactive steps {inact_cyc:.0f} "
                 f"({inact_cyc / max(loop, 1):.3f})" if inact_cyc else "")
              + f"; {cyc.sum() / max(act, 1):.0f} cycles an active step; "
              f"Q T Q^H rel {err:.1e}", flush=True)


# K2's card-wide route (csrc/tridiag_grid.cu built with TRIDIAG_GRID_STAGES:
# CTA 0's thread 0 adds the cycles since its last stamp to each stage)
TG_LABELS = ["load", "panel start (flags)", "skipped steps",
             "A: column update", "barrier 1", "B: reflector",
             "C: y pass and slabs", "barrier 2", "D: a, b, s and w",
             "panel end: barrier and d", "trailing update",
             "barrier after the update", "end barrier"]
TG_SIZES = ((False, 1024), (False, 2048), (True, 1024), (True, 2048))


def build_tridiag_grid(tag, src):
    """`src` (a tridiag_grid.cu) with its stage clocks, as its own library."""
    from adaptaqc_tpu_torch.ops.cuda_lib import NVCC_FLAGS, _nvcc
    os.makedirs(BUILD, exist_ok=True)
    so = os.path.join(BUILD, f"libtridiag_grid_{tag}.so")
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-DTRIDIAG_GRID_STAGES", "-I",
                    os.path.dirname(src), "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.tridiag_grid_launch, lib.tridiag_grid_f64_launch):
        fn.argtypes = [P] * 6 + [I, I, L, P]
    lib.tridiag_grid_workspace.argtypes = [I, I]
    lib.tridiag_grid_workspace.restype = L
    lib.tridiag_grid_stages.argtypes = [P]
    return lib


def report_tridiag_grid(tag, lib, sizes=TG_SIZES, grams=None):
    """K2's card-wide route: CTA 0's cycles by stage from one instrumented
    launch on a random Gram at each of `sizes` (or on each of `grams`,
    summed), the stages' share, their device time (the share of the
    instrumented launch's time by CUDA events) and the active columns."""
    import chip_smoke as cs
    cases = grams or [(f64, f"random m={m}",
                       [random_gram64(m) if f64 else random_gram(m)])
                      for f64, m in sizes]
    for f64, label, hs in cases:
        fn = lib.tridiag_grid_f64_launch if f64 else lib.tridiag_grid_launch
        cyc, ms, act = np.zeros(16), 0.0, 0
        for h in hs:
            m, dev = h.shape[-1], h.device
            rdt = torch.float64 if f64 else torch.float32
            ws = torch.empty(lib.tridiag_grid_workspace(m, int(f64)),
                             dtype=torch.uint8, device=dev)
            vrows = torch.empty_like(h)
            tau = torch.empty(m, dtype=h.dtype, device=dev)
            d = torch.empty(m, dtype=rdt, device=dev)
            e = torch.empty(m, dtype=rdt, device=dev)

            def run():
                rc = fn(h.data_ptr(), ws.data_ptr(), vrows.data_ptr(),
                        tau.data_ptr(), d.data_ptr(), e.data_ptr(), m, 1,
                        m * m, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"tridiag grid launch failed: {rc}")
            ms += cs.cuda_ms(run, 3, torch)
            raw = (ctypes.c_longlong * 16)()
            lib.tridiag_grid_stages(raw)  # cleared
            run()
            torch.cuda.synchronize()
            if lib.tridiag_grid_stages(raw) != 0:
                raise RuntimeError("reading the stage clocks failed")
            cyc += np.array(raw[:], dtype=np.float64)
            act += int((tau[:-1] != 0).sum())
        counts = cyc[13:16].copy()
        cyc[13:16] = 0
        total = max(cyc.sum(), 1.0)
        print(f"tridiag grid {tag} {'complex128' if f64 else 'complex64'} "
              f"on {label}: {ms:.4f} ms (instrumented), {act} active "
              f"columns, {total:.0f} cycles of CTA 0: "
              + ", ".join(f"{lab} {c:.0f} ({c / total:.3f}, "
                          f"{ms * c / total:.3f} ms)"
                          for lab, c in zip(TG_LABELS, cyc) if c)
              + (f"; {total / act:.0f} cycles an active column"
                 if act else "")
              + f"; {counts[0]:.0f} panels, {counts[1]:.0f} columns found "
              f"inactive by their step, {counts[2]:.0f} panels ended by a "
              "residue column", flush=True)


def report_backtransform_ormqr(pairs=20):
    """K4 (this tree's package build) against torch.ormqr on the same
    reflectors at complex64 m=512 and complex128 m=504, keep = m/2: `pairs`
    pairs timed in turns (each the mean of 10 calls, CUDA events); medians
    and the spread (min, max) of each."""
    import chip_smoke as cs
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    for m, dt in ((512, torch.complex64), (504, torch.complex128)):
        h = random_gram(m) if dt == torch.complex64 else random_gram64(m)
        vp, taup, dp, ep = ek.tridiag_plain(h)
        _, zp = ek.teig_plain(dp, ep)
        keep = m // 2
        a = vp[: m - 1, 1:].transpose(0, 1).contiguous()
        otau = taup[: m - 1].contiguous()
        oz = zp[1:, :keep].to(dt).contiguous()
        kern, lib = [], []
        for _ in range(pairs):
            kern.append(cs.cuda_ms(lambda: ek.backtransform(vp, taup, zp,
                                                            keep), 10, torch))
            lib.append(cs.cuda_ms(lambda: torch.ormqr(a, otau, oz), 10,
                                  torch))
        print(f"backtransform vs ormqr {dt} m={m} keep={keep}, {pairs} pairs "
              f"in turns: kernel median {np.median(kern):.4f} ms (min "
              f"{min(kern):.4f}, max {max(kern):.4f}), ormqr median "
              f"{np.median(lib):.4f} ms (min {min(lib):.4f}, max "
              f"{max(lib):.4f}); kernel faster in "
              f"{sum(k < l for k, l in zip(kern, lib))} of {pairs} pairs",
              flush=True)


ENV_WIDE_CHI = (96, 128)


def _env_run(lib, launcher, chi, labels, tag, what, per_cta=False):
    """Time one env-chain build at n = 50, chi (q = 0/25/49, 20 launches
    each), then launch it once at q = 25 and print the cycles a site by
    stage for each chain: rank 0's (g_stamp[0..5] forward, [8..13]
    backward, the sites at [6] and [14]), or with per_cta the mean over the
    chain's 16 CTAs and the largest (g_steps[CTA][stage], the sites in the
    last slot)."""
    import chip_smoke as cs
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, launcher)
    fn.argtypes = [P] * 5 + [I] * 3 + [P]
    br, bl = cs.env_inputs(torch, 50, chi, torch.device("cuda"))
    snaps = torch.empty(2, chi, chi, dtype=torch.complex64, device="cuda")
    out = torch.empty(2, 2, dtype=torch.complex64, device="cuda")
    counter = torch.zeros(1, dtype=torch.int32, device="cuda")

    def launch(q):
        return fn(br.data_ptr(), bl.data_ptr(), snaps.data_ptr(),
                  counter.data_ptr(), out.data_ptr(), 50, chi, q,
                  torch.cuda.current_stream().cuda_stream)
    ms = {q: cs.cuda_ms(lambda: launch(q), 20, torch) for q in (0, 25, 49)}
    rc = launch(25)
    if rc:
        raise RuntimeError(f"{tag} env_chain launch failed: {rc}")
    torch.cuda.synchronize()
    if per_cta:
        out = (ctypes.c_longlong * (32 * ENV_WIDE_SLOTS))()
        if lib.read_steps(out) != 0:
            raise RuntimeError("reading the per-CTA stamps failed")
        st = np.array(out[:], dtype=np.float64).reshape(32, ENV_WIDE_SLOTS)
        for c0, chain in ((0, "forward"), (16, "backward")):
            blk = st[c0:c0 + 16]
            sites = max(blk[0, -1], 1)
            mean, top = blk.mean(0) / sites, blk.max(0) / sites
            # the stages that add up to a site ("(of ...)" is a part of one)
            total = sum(mean[k] for k, lab in enumerate(labels)
                        if not lab.startswith("("))
            print(f"env_chain {tag} chi={chi} {what} (q=0 {ms[0]:.4f} ms, "
                  f"q=25 {ms[25]:.4f} ms, q=49 {ms[49]:.4f} ms) q=25 {chain} "
                  f"({blk[0, -1]:.0f} sites), cycles a site, mean (max) over "
                  f"the 16 CTAs: {total:.0f}: "
                  + ", ".join(f"{lab} {mean[k]:.0f} ({top[k]:.0f})"
                              for k, lab in enumerate(labels)), flush=True)
        return
    st = stamps(lib)
    for off, chain in ((0, "forward"), (8, "backward")):
        sites = max(st[off + 6], 1)
        total = st[off:off + len(labels)].sum() / sites
        print(f"env_chain {tag} chi={chi} {what} (q=0 {ms[0]:.4f} ms, q=25 "
              f"{ms[25]:.4f} ms, q=49 {ms[49]:.4f} ms) q=25 {chain} "
              f"({st[off + 6]:.0f} sites): {total:.0f} cycles a site: "
              + ", ".join(f"{lab} {st[off + k] / sites:.0f}"
                          for k, lab in enumerate(labels)), flush=True)


def report_env(parent=None, variants=False):
    """The narrow K1 (this tree, chi = 32 and 64, clusters of 8 and 16) by
    stage; then the complex64 wide K1 at ENV_WIDE_CHI: the parent's (its
    env_chain.cu, with --parent) and this tree's (csrc/env_chain_wide.cu),
    in the order parent, this tree, this tree, parent."""
    csrc = os.path.join(ROOT, "adaptaqc_tpu_torch", "csrc")
    lib = build(os.path.join(csrc, "env_chain.cu"), "env_chain", ENV_MARKS)
    lib.set_cluster.argtypes = [ctypes.c_int]
    for chi in (32, 64):
        for cluster in (8, 16):
            lib.set_cluster(cluster)
            _env_run(lib, "env_chain_launch", chi, ENV_LABELS, "this_tree",
                     f"cluster={cluster}")
    lib.set_cluster(0)
    trees = {}
    if parent:
        plib = build(os.path.join(parent, "adaptaqc_tpu_torch", "csrc",
                                  "env_chain.cu"), "env_chain_parent",
                     ENV_MARKS)
        plib.set_cluster.argtypes = [ctypes.c_int]
        plib.set_cluster(0)
        trees["parent"] = (plib, "env_chain_launch", ENV_LABELS)
    wide = os.path.join(csrc, "env_chain_wide.cu")
    if os.path.exists(wide):
        trees["this_tree"] = (build(wide, "env_chain_wide", ENV_WIDE_MARKS,
                                    steps=(32, ENV_WIDE_SLOTS)),
                              "env_chain_wide_launch", ENV_WIDE_LABELS)
    for tag in ("parent", "this_tree", "this_tree", "parent"):
        if tag in trees:
            for chi in ENV_WIDE_CHI:
                _env_run(*trees[tag][:2], chi, trees[tag][2], tag, "wide",
                         per_cta=tag == "this_tree")
    for tag, edits in (ENV_WIDE_VARIANTS.items() if variants else ()):
        try:
            vlib = build(wide, f"env_chain_wide_{tag}",
                         ENV_WIDE_MARKS + edits, steps=(32, ENV_WIDE_SLOTS))
        except subprocess.CalledProcessError:
            print(f"env_chain {tag}: the variant does not build", flush=True)
            continue
        for chi in ENV_WIDE_CHI:
            _env_run(vlib, "env_chain_wide_launch", chi, ENV_WIDE_LABELS,
                     tag, "wide", per_cta=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an unpacked older tree to compare")
    ap.add_argument("--kernels", default="tridiag,teig,teig_wide,teig_grid,"
                    "tridiag_wide,tridiag_grid,backtransform_ormqr,"
                    "env_chain",
                    help="which reports, comma-separated (tridiag also "
                    "times backtransform)")
    ap.add_argument("--variants", action="store_true",
                    help="tridiag_wide: also this tree's kernel at other "
                    "cluster sizes (TW_VARIANTS); teig_grid: also this "
                    "tree's route with other tuning choices (TG_VARIANTS); "
                    "env_chain: the wide K1 with the edits of "
                    "ENV_WIDE_VARIANTS")
    ap.add_argument("--wide-sizes",
                    help="tridiag_wide: only a random Gram at each of these "
                    "sizes, for example c64:1024,c128:2048")
    args = ap.parse_args()
    which = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        print("stage_clocks: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    print(f"stage_clocks: on {cs.gpu_line()}", flush=True)
    src = os.path.join(ROOT, "adaptaqc_tpu_torch", "csrc", "eigh_tridiag.cu")
    inputs = sweep_inputs() if which & {"tridiag", "teig"} else None
    parent = (os.path.join(args.parent, "adaptaqc_tpu_torch", "csrc",
                           "eigh_tridiag.cu") if args.parent else None)
    if "tridiag" in which:
        trees = {"this_tree": build_tridiag("this_tree", src)}
        if parent:
            trees["parent"] = build_tridiag("parent", parent)
        for tag in ("parent", "this_tree", "this_tree", "parent"):
            if tag in trees:
                report_tridiag(tag, *trees[tag], inputs)
    if "teig" in which:
        teig_in = [a[:2] for a in inputs["teig"]]
        if parent:
            report_teig("parent", parent, teig_in)
        report_teig("plain_division", src, teig_in, [PLAIN_DIV])
        report_teig("this_tree", src, teig_in)
    if "teig_wide" in which:
        import chip_smoke as cs
        from adaptaqc_tpu_torch.backends import mps_core
        from adaptaqc_tpu_torch.circuits.circuit import Circuit
        from adaptaqc_tpu_torch.circuits.tape import compile_tape
        from adaptaqc_tpu_torch.ops import eigh_kernels as ek
        from adaptaqc_tpu_torch.optim import sweeps
        sweep128 = [a[:2] for a in cs.sweep_eigh_inputs(
            torch, ek, mps_core, sweeps, Circuit, compile_tape,
            chi=128)["teig"]]
        trees = {"this_tree": build_teig_wide("this_tree", src)}
        if parent:
            trees["parent"] = build_teig_wide("parent", parent)
        for tag in ("parent", "this_tree", "this_tree", "parent"):
            if tag in trees:
                report_teig_wide(tag, *trees[tag], sweep128)
    if "teig_grid" in which:
        if parent:
            report_teig_global_parent(*build_teig_wide("parent", parent))
        libs = build_plain(src, {"this_tree": [], **(
            TG_VARIANTS if args.variants else {})})
        for tag, lib in libs.items():
            report_teig_grid(tag, lib)
    if "tridiag_wide" in which:
        import chip_smoke as cs
        from adaptaqc_tpu_torch.backends import mps_core
        from adaptaqc_tpu_torch.circuits.circuit import Circuit
        from adaptaqc_tpu_torch.circuits.tape import compile_tape
        from adaptaqc_tpu_torch.ops import eigh_kernels as ek
        from adaptaqc_tpu_torch.optim import sweeps
        sizes = [(s.split(":")[0] == "c128", int(s.split(":")[1]))
                 for s in args.wide_sizes.split(",")] if args.wide_sizes \
            else None
        sweep128 = None if sizes else [a[0] for a in cs.sweep_eigh_inputs(
            torch, ek, mps_core, sweeps, Circuit, compile_tape,
            chi=128)["tridiag"]]
        trees = {"this_tree": build_tridiag_wide("this_tree", src)}
        if parent:
            trees["parent"] = build_tridiag_wide("parent", parent)
        for tag in ("parent", "this_tree", "this_tree", "parent"):
            if tag in trees:
                report_tridiag_wide(tag, *trees[tag], sweep128, sizes)
        for tag, extra in (TW_VARIANTS.items() if args.variants else ()):
            report_tridiag_wide(tag, *build_tridiag_wide(tag, src, extra),
                                sweep128)
    if "tridiag_grid" in which:
        gsrc = os.path.join(ROOT, "adaptaqc_tpu_torch", "csrc",
                            "tridiag_grid.cu")
        glib = build_tridiag_grid("this_tree", gsrc)
        report_tridiag_grid("this_tree", glib)
        import chip_smoke as cs
        from adaptaqc_tpu_torch.backends import mps_core
        from adaptaqc_tpu_torch.circuits.tape import compile_tape
        from adaptaqc_tpu_torch.ops import eigh_kernels as ek
        from adaptaqc_tpu_torch.optim import sweeps
        for chi, f64 in ((1024, False), (1024, True)):
            dt = torch.complex128 if f64 else torch.complex64
            _, _, sargs = cs.sweep_setup(torch, mps_core, sweeps,
                                         compile_tape, chi, dt)
            grams = [a[0] for a in cs.record_eigh_inputs(
                torch, ek, lambda: sweeps.sweep(*sargs))["tridiag"]]
            report_tridiag_grid("this_tree", glib, grams=[(
                f64, f"the chi={chi} sweep's {len(grams)} Grams", grams)])
    if "backtransform_ormqr" in which:
        report_backtransform_ormqr()
    if "env_chain" in which:
        report_env(args.parent, args.variants)
    return 0


if __name__ == "__main__":
    sys.exit(main())
