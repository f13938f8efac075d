"""Drive the PyTorch port (adaptaqc_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py [--only kernels,spin,...]

(`--only` runs the named phases alone, for work on one of them; the whole
run, with no arguments, is the one that prints the result lines.) Builds the package's CUDA kernels from adaptaqc_tpu_torch/csrc with nvcc
(sm_90a) and runs sixteen phases, each printing lines that start with its
name; any failure exits non-zero:

  device    torch / CUDA versions, the card's name and power limit, build s
  kernels   every kernel against its plain PyTorch version on the card at
            the main path's shapes (K1 at chi 2/24/32/64 and q 0/1/17/25/
            48/49; K3's eigenvectors also against float64: orthogonality,
            residual, degenerate-cluster projectors), with its time, its
            bound (kernel_bound), the plain version's time and, where one
            PyTorch call computes the same function, that call's time; K1
            at q = 0/25/49 and over the sweep's 48 probe sites; K2 and K4
            also on the 24 Grams (and their reflectors) that one sweep
            gives them, with the count of exactly inactive K2 steps (every
            step inactive in the plain version must be inactive in the
            kernel); the eigensolver also against float64 on a 7-decade
            spectrum; K2-K4 launched once for a batch of P = 7 and P = 3
            Grams at m = 32/64/128 (every spectrum class, and the probe
            batches one full-cost sweep gives them): each matrix against
            the plain version and, bit for bit, against the P = 1 launch of
            the same matrix, with times for P = 1/3/7; K2-K4 on the
            center-gauge engine's inputs (m = chi from its center moves);
            the wide variants: K1 at chi 65/96/127/128 (the complex64 wide
            kernel of csrc/env_chain_wide.cu: its plan mirror equal to the
            library's at every chi of 65..128, a rerun at chi = 128 the same
            bits, its cluster floor beside the bound) and K2-K4 at m =
            192/256/512 to the same checks (a batch of 3 bit for bit
            against its P = 1 launches, and of 7 at m = 256), with the
            chain's yardstick torch.linalg.eigh of the complex H and K3's
            cluster size; K4 on the chi=128 sweep's own reflectors (m =
            256) against torch.ormqr; the complex128 instantiations (K3's
            w bit for bit), timed at m = 64/256/504 with
            torch.linalg.eigh(H); K2's
            cluster kernel also at complex64 m = 560 and at the complex128
            sizes on each side of its shared-memory fit, on the chi=128
            sweep's Grams (inactive steps as the plain version's; time,
            active steps, bound) and on the center-gauge inputs in
            complex128, with its cluster size and route at every m
  hazard    a deep two-qubit-chain re-simulation at n=50, chi=64 and
            chi=128 under eigh="kernels" and eigh="native": overlaps agree
            to 1e-3
  slice     AdaptCompiler on the synthetic 50-qubit random-MPS target
            (chi=32, general_gradient, identity_resolvable layers,
            product-state start, linear map), a few layers, with every
            kernel's launch count from that run (each must be > 0); then a
            full compile at n=10 to overlap > 0.99
  sweep     one Rotoselect sweep at bench.py's shape (n=50, chi=64, a
            window of 12 dressed-CNOT layers), and the same at chi=128 (K1
            and K2-K4 in their wide variants): ms/sweep and evals/s
  sv        the statevector engine: a 20-qubit circuit of every gate kind
            on the card (complex64) against the CPU (complex128); each op's
            time and bandwidth at n=26; one Rotoselect sweep at n=26 on the
            sweep phase's workload; AdaptCompiler(target,
            backend=SVBackend(device="cuda")) with the default ISL config on
            that target, 4 layers; full compiles of the README example (with
            no backend argument: the default SVBackend on the card) and a
            random 4-qubit state to overlap > 0.99
  sampling  the JAX package's sampling compile (2 qubits, bound 0.85) and
            the README example on SamplingBackend(device="cuda"); 65,536
            draws from the n=26 target state against its exact <Z>
  isl_mps   ISL on MPSBackend(max_chi=32, device="cuda") on the slice's
            50-qubit target, 2 layers, with every kernel's launch count
  spin      the spin-chain compile (benchmarks/spin_chain.py: n=50, XXZ
            Trotter from the Neel state, brickwall, identity_resolvable
            layers, chi=32) under optimise_local_cost, cut to a few layers:
            the full-cost sweep's batched launches of K2-K4 (one a batched
            two-qubit apply), the global polish through K1, the
            center-gauge verifier and the staggered magnetisation; one
            full-cost cycle over a 16-layer window, timed; the same compile
            at n=10 to its stop on MPSBackend and on CenterMPSBackend
  ladder    compile_in_parts (one Trotter step a part) and the README's
            compile_with_chi_schedule(chis=(32, 64, 128)) on that target,
            cut the same way: stage 3 runs every wide variant, no complex64
            call takes a non-kernel route, and the result agrees with the
            center-gauge verifier at chi=128; a checkpoint written
            mid-compile on the card, loaded (also onto the CPU) and resumed
            to the straight run's pair history
  reach     past the sizes whose operands fit on chip: the streamed K1
            (chi 129/192/256/512/768/1024 in complex64, 192/256/512/1024 in
            complex128, q 0/1/25/48/49 at n=50, and chi 8192 at n=4, q
            0/2/3, in both; its plan as the library's, a rerun the same
            bits at chi 256 and 1024, its cuBLAS chain and one step-2
            product against torch.matmul timed beside it) and K2-K4 at m =
            561/1024/2048/16384 (complex64) and 512/1024/2048/16384
            (complex128) against their plain versions ("rand" and
            "lowrank" Grams to m = 1024 with a batch of 3, "rand" at 2048;
            at m = 16384 "rand"
            alone against the float64 yardstick, K2 by a probe residual,
            K4 on its strip route against its plain version; K3 also alone
            in complex128 at m = 8448 and 8576, either side of its inverse
            iteration's shared-memory fit, against scipy in float64),
            with times, bounds and library calls (K3 against
            torch.linalg.eigh(T), its card-wide route also at keep = m/2:
            the first columns of its keep = m launch, alone and in a batch
            of 3; K4 against torch.ormqr, its workspace and shared memory
            equal to the mirrors in eigh_kernels), and K4 alone on its
            strip route at complex128 m = 4096 (strips of 16 columns) and
            complex64 m = 3072 (its crossover), a rerun and a batch of 3
            bit for bit; then at n=50
            the sweep phase's workload at chi=256, 512 and 1024 in
            complex64 and complex128, and the spin chain through
            workloads/spin_chain.py with SPIN_CHI_SCHEDULE=32,64,128,256
            cut to 2 layers a stage (center-gauge verifier within 1e-3,
            relative): every launch is counted by the code it runs, and
            each new code path must launch on them (the chi = 128 stage
            the wide K1); the deep re-simulation at chi=256 (2 layers) and
            1024 (1 layer) at n=50 and at chi=4096, n=24 (CX on sites
            10-13, both dtypes), its native verifier beside it; one sweep
            at chi=4096, n=23 in both dtypes with its peak device memory
            (K4's strip route launched in both); a compile at working
            chi=512, n=21, whose verified stop re-simulates at chi=1024 on
            the native verifier
  optim     on the slice's target (n=50, chi=32): BOBYQA layers with the
            final BOBYQA minimisation (use_roto_algos=False,
            perform_final_minimisation=True), and Rotosolve layers
            subsampled by rotosolve_fraction=0.5; a complex128 MPS compile
            at n=10 on the card, which takes the counted non-kernel routes
  zigzag    the opt-in sweep modes at bench.py's shape (n=50, chi=64,
            12 dressed-CNOT layers, Rotoselect): the first zigzag forward
            cycle against the standard sweep (kinds equal, angles 1e-5);
            sweep_zigzag_until_converged's state against apply_all at its
            angles (1e-4); the env-cached sweep against the full-chain
            sweep (complex128 kinds equal, angles 1e-8; complex64 costs
            1e-4) with no K1 launch; K2-K4 launches of a zigzag pair
            against two standard cycles; ms a cycle of each mode in turns;
            at chi=128 the first forward cycle and the ms of each mode
  workloads the scripts of adaptaqc_tpu_torch/workloads as a user runs
            them, each its own process: random_mps at n=50 stopped by a
            20 s deadline with its checkpoint, a second process resuming it
            for 10 s (resumed at the checkpoint's layer, the first run's
            pairs first), spin_chain at its defaults for 15 s alongside,
            each launching every kernel; then bench_sweep's evals/s, the
            readme, simple_sv and advanced_sv example twins to their
            floors, and entry()'s cost against the CPU's
  refine    the warm-start scripts on the workloads phase's n=50 records
            (alone: on its own compiles, each stopped by a deadline):
            refine and spin_refine at chi=64, 2 more layers under a
            deadline, start from the saved circuit (first cost at most 1 -
            its overlap + 1e-3, final overlap no lower than its overlap -
            1e-3); reverify_spin of the refined spin circuit at chi=128
            within 1e-3 of its record; summarize counts every record
  mesh      M7, the device mesh (adaptaqc_tpu_torch/parallel): at once,
            the sharded MPS compile (complex128, 2 layers) on 4 ranks
            sharing the card over gloo against this process's unsharded
            compile (pairs equal, overlap within 1e-8; every rank launches
            K2-K4 and no K1), the dry run's MPS step on a 1 x 1 NCCL mesh
            and dryrun_multichip(4, backend="gloo") (its four parts, each
            rank's peak allocation), its chi = 256 step (tp 4) and the
            1 x 1 step each against the unsharded sweep of its tape on the
            card (complex64, cost and RDMs within 1e-6); the same 4 ranks
            without backend="gloo" refused before any rank starts. On a
            machine with 4 cards the ranks take one each over NCCL
            (`--only mesh`), and then one Rotoselect sweep at chi 8192
            (n=26, complex64; complex128 at the largest chi whose peak
            fits a rank) over tp = 4: each rank's peak memory, its K2-K4
            launches at m = 2 chi, the walls, and the swept circuit
            re-simulated on the kernels against the verifier on shards
            (native eigensolver) within 1e-3

The third-to-last line is one JSON object with a record per kernel (its
launches on the slice, its times at the slice's shapes, bound and library
call), per batched kernel shape (its batched launches on the spin phase),
per wide variant (its launches on the ladder's chi schedule, its times
at chi = 128 and m = 256; K1's also by chi with its cluster floor), per
complex128 variant (the optim phase) and per
variant whose code only sizes past the old caps run, `[reach]` and
`[reach_f64]` (reach_rows: its launches on the reach phase's sweeps and
spin chain, its times at chi = 256 and m = 1024), and K4's strip route,
`backtransform[strip]` and `backtransform[strip_f64]` (complex64 and
complex128: its launches on the chi = 4096 sweep, its times at m = 16384),
the line before the last the card's name and power limit from
nvidia-smi, and the last line {"ok": true, "device": {...}}. Without a
CUDA card, or without the package beside this script, it exits non-zero
and prints no result.
"""

import json
import subprocess
import sys
import time
import warnings

import numpy as np

KERNELS = {
    "env_chain": ("adaptaqc_tpu_torch/csrc/env_chain.cu",
                  "adaptaqc_tpu/ops/pallas_env.py:46"),
    "tridiag": ("adaptaqc_tpu_torch/csrc/eigh_tridiag.cu",
                "adaptaqc_tpu/ops/pallas_eigh.py:56"),
    "teig": ("adaptaqc_tpu_torch/csrc/eigh_tridiag.cu",
             "adaptaqc_tpu/ops/pallas_eigh.py:194"),
    "backtransform": ("adaptaqc_tpu_torch/csrc/eigh_tridiag.cu",
                      "adaptaqc_tpu/ops/pallas_eigh.py:136"),
}
WIDE_M = (192, 256, 512)  # the wide variants of K2-K4 (128 < m <= 560)
WIDE_CHI = (65, 96, 127, 128)  # the complex64 wide K1 (64 < chi <= 128,
                               # csrc/env_chain_wide.cu): its edges, odd
                               # chi and the ladder's 96 and 128
# BOBYQA's own maxfun, a call, in the optim phase: uncapped, the layers'
# global-minimum restarts may ask for 500 (d + 1) x 3 evaluations
BOBYQA_MAXFUN = 200

# tolerances of the kernel-vs-plain comparisons (float32 on both sides;
# sums are taken in other orders, so agreement is to rounding, not bits)
TOL_ENV_REL = 1e-4      # |C - C_plain| / max|C_plain|, n = 50 chains
TOL_TRIDIAG_REL = 1e-4  # the kernel's Q T Q^H = H (/ max|H|), Q unitary
TOL_TRIDIAG_FACTORS = 1e-3  # its d, e (/ max|H|), tau vs the plain version
                            # on a random Gram: m-1 sequential reflectors
                            # accumulate rounding in another order
TOL_TEIG_W_REL = 1e-5   # eigenvalues on identical (d, e), / scale
TOL_VEC = 1e-3          # eigenvector columns (same b0, same shifts)
TOL_BT = 1e-5           # back-transform on identical inputs
TOL_CHAIN_W = 2e-5      # whole chain vs float64: eigenvalues / scale
TOL_ORTHO = 2e-4        # orthonormality of the kept vectors
TOL_RESID = 2e-4        # eigen-residual / scale
TOL_T64 = 2e-6          # teig eigenvalues vs float64 eigh of T, / scale
TOL_S64 = 5e-4          # svd_trunc kept s and action vs float64 SVD
TOL_HAZARD = 1e-3       # kernels vs native overlap, deep re-simulation
TOL_LADDER_REL = 1e-3   # chi schedule's overlap vs the center-gauge
                        # verifier, relative
TOL_SV_REL = 1e-4       # statevector engine, card complex64 vs CPU
                        # complex128, / max|reference|
TOL_EXACT = 1e-4        # |exact_overlap - overlap| of a statevector compile
SV_N = 26               # DENSE_OVERLAP_MAX_QUBITS: the JAX package's limit
                        # for a dense state
HBM_GBS = 3350.0        # H100 SXM device memory, GB/s (published peak)
SM_COUNT = 132          # H100 SXM streaming multiprocessors
FP32_TFLOPS = 67.0      # H100 SXM fp32 outside the tensor cores (published
                        # peak); the port computes in exact float32, so no
                        # TF32 or bf16 rate applies
FP64_TFLOPS = 67.0      # H100 SXM fp64 on the tensor cores (DMMA, full
                        # IEEE fp64; NVIDIA's data sheet): the complex128
                        # instantiations, whose work is mostly products that
                        # could run there
TOL_F64_ENV = 1e-12     # complex128 K1 vs its plain version, relative
TOL_F64 = 1e-10         # complex128 K2-K4: Q T Q^H = H, w (/ scale), K4 vs
                        # plain, the chain vs numpy (w, ortho, resid)


def kernel_bound(name, n=None, chi=None, m=None, keep=None, active=None,
                 batch=1, f64=False):
    """(bound_ms, bound_by, flops, bytes) of one launch of kernel `name` (on
    `batch` matrices: that many times the work of one):
    the larger of its operations over FP32_TFLOPS and its bytes (each
    input read once, each output written once) over HBM_GBS. f64: the
    complex128 instantiation, twice the bytes and its operations over
    FP64_TFLOPS (the sizes below are complex64 and float32).

      env_chain      n sites of (2, chi, chi) complex64 for bra and ket;
                     n-1 chain steps of 2 x 2 complex chi^3 products
                     (32 chi^3 flops each) and the combine at site q (two
                     chi^3 products per ket index, 32 chi^3, and four
                     chi^2 dots, 32 chi^2): the same for every q
      tridiag        m x m complex64 in; v (m x m complex), tau, d, e out;
                     zhetrd's 16/3 m^3 flops
      teig           the top `keep` eigenpairs (keep = m by default): d, e
                     (m float32) and keep columns of b0 in, w (keep) and
                     z (m x keep) out; 30 bisection rounds (60 in float64)
                     of keep lanes x m Sturm steps (3 ops), the LU (6 m
                     keep) and two inverse-iteration rounds (24 m keep
                     with the normalisation; the LU and the solves are per
                     lane), and CGS2: two passes of a dot and an update
                     over j earlier columns of m (8 j m flops for column
                     j, 4 m keep^2 in all)
      backtransform  m-1 reflectors (m x m complex64 and tau) and the keep
                     columns of z (float32) in, (m, keep) complex64 out;
                     reflector k touches m-k-1 rows of each column with a
                     dot and an update: 16 (m-k-1) keep flops, 8 m^2 keep
                     in all
    `active` (tridiag, backtransform): the steps k whose reflector is not
    the identity, where the data leaves some out (an inactive step costs
    neither kernel any work); tridiag's step k is a product and a rank-2
    update of the trailing (m-k-1)^2 block, 16 (m-k-1)^2 flops."""
    if name == "env_chain":
        flops = 32 * chi ** 3 * (n - 1) + 32 * chi ** 3 + 32 * chi ** 2
        nbytes = 2 * n * 2 * chi * chi * 8 + 4 * 8
    elif name == "tridiag":
        flops = (16 * m ** 3 / 3 if active is None
                 else sum(16 * (m - k - 1) ** 2 for k in active))
        nbytes = m * m * 8 + m * m * 8 + m * 8 + 2 * m * 4
    elif name == "teig":
        rounds = 60 if f64 else 30  # _teig_constants
        k = m if keep is None else keep
        flops = (rounds * k * m * 3 + 6 * m * k + 24 * m * k
                 + 4 * m * k * k)
        nbytes = 2 * m * 4 + m * k * 4 + k * 4 + m * k * 4
    elif name == "backtransform":
        flops = (8 * m * m * keep if active is None
                 else sum(16 * (m - k - 1) * keep for k in active))
        nbytes = m * m * 8 + m * 8 + m * keep * 4 + m * keep * 8
    else:
        raise ValueError(f"no bound for kernel {name}")
    flops, nbytes = flops * batch, nbytes * batch * (2 if f64 else 1)
    t_ops = flops / ((FP64_TFLOPS if f64 else FP32_TFLOPS) * 1e12) * 1e3
    t_bytes = nbytes / (HBM_GBS * 1e9) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, flops, nbytes


def cluster_floor(n, chi, q, ctas=16):
    """(floor_ms, how) of the wide K1 on its clusters: a chain's sites are
    dependent, so its time is at least the critical path, max(q, n-1-q)
    sites and the combine at 32 chi^3 flops each, at the FP32 peak of the
    `ctas` SMs of one chain's cluster (FP32_TFLOPS x ctas / SM_COUNT)."""
    sites = max(q, n - 1 - q) + 1
    rate = FP32_TFLOPS * 1e12 * ctas / SM_COUNT
    return sites * 32 * chi ** 3 / rate * 1e3, (
        f"{sites} dependent sites of 32 chi^3 flops at the FP32 peak of "
        f"{ctas} of {SM_COUNT} SMs")


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


# K4's counters (ops/eigh_kernels.py), the strip route's among them
BT_COUNTERS = ("launches", "batched_launches", "wide_launches",
               "f64_launches", "reach_launches", "reach_f64_launches",
               "strip_launches")


def reset_counts(ek, envk):
    """Every kernel's launch counters to 0."""
    for fn in (envk.env_chain, ek.tridiag, ek.teig, ek.backtransform):
        fn.launches = fn.wide_launches = fn.f64_launches = 0
        fn.reach_launches = fn.reach_f64_launches = 0
    for fn in (ek.tridiag, ek.teig, ek.backtransform):
        fn.batched_launches = 0
    ek.backtransform.strip_launches = 0


def variant_counts(ek, envk):
    """{kernel: {variant: launches}} of every counted variant."""
    return {fn.__name__: {v: getattr(fn, f"{v}_launches") for v in (
        "wide", "f64", "reach", "reach_f64")} for fn in (
        envk.env_chain, ek.tridiag, ek.teig, ek.backtransform)}


def wide_counts(ek, envk):
    return {fn.__name__: fn.wide_launches for fn in (
        envk.env_chain, ek.tridiag, ek.teig, ek.backtransform)}


def f64_counts(ek, envk):
    return {fn.__name__: fn.f64_launches for fn in (
        envk.env_chain, ek.tridiag, ek.teig, ek.backtransform)}


def gpu_line():
    """`name, power.limit` of the card as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    check(out.returncode == 0 and lines,
          f"nvidia-smi gave no card name and power limit: {out.stderr}")
    return lines[0]


def cuda_ms(fn, reps, torch, warm=True):
    """Mean milliseconds per call over `reps` calls, CUDA events, after one
    call that is not timed (`warm`)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_ms(fn, torch):
    """(fn()'s result, the milliseconds of that one call), CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def count_syncs(torch, fn):
    """Run fn once; returns (its result, the number of host-device
    synchronisations it made, as PyTorch's sync debug mode reports them)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


# ---------------------------------------------------------------- phase 1
def phase_device(torch, cuda_lib):
    t0 = time.perf_counter()
    cuda_lib.lib()
    build_s = time.perf_counter() - t0
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"card {torch.cuda.get_device_name(0)} [{gpu_line()}] "
          f"count {torch.cuda.device_count()} kernels built in "
          f"{build_s:.2f} s (nvcc {cuda_lib.build_seconds})", flush=True)


# ---------------------------------------------------------------- phase 2
def _gram_cases(m, rng, spec7=True):
    """Normalised thetas (||theta|| = 1, as every MPS bond update sees)
    whose Grams span the spectrum classes of the eigensolver tests.
    spec7=False leaves out "spec7", whose host SVD takes most of the time
    at large m; the random draws, and so every other case and the later
    calls on rng, are the same either way."""
    cases = {}
    a = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
    cases["rand"] = a / np.linalg.norm(a)
    if spec7:
        u, _, vh = np.linalg.svd(a)
        th = (u * np.logspace(0, -7, m)) @ vh
        cases["spec7"] = th / np.linalg.norm(th)
    cases["flat"] = np.eye(m, dtype=complex) / np.sqrt(m)
    a = rng.standard_normal((m, min(4, m))) + 1j * rng.standard_normal(
        (m, min(4, m)))
    cases["lowrank"] = (a @ a.conj().T) / np.linalg.norm(a @ a.conj().T)
    a = rng.standard_normal((m, m))
    a[: m // 2, m // 2:] = 0.0
    a[m // 2:, : m // 2] = 0.0
    cases["decoupled"] = a.astype(complex) / np.linalg.norm(a)
    th = np.zeros((m, m), complex)
    th[0, 0] = th[m - 1, m - 1] = 1 / np.sqrt(2)
    cases["bell"] = th
    return cases


def sweep_probe_sites(Circuit, compile_tape):
    """The site of every probe of phase_sweep's tape, in sweep order."""
    from adaptaqc_tpu_torch.workloads.bench_sweep import bench_workload
    _, ansatz = bench_workload(50, 12)
    at = compile_tape(ansatz)
    return [int(q) for q in np.asarray(at.q0)[np.asarray(at.trainable)]]


def sweep_eigh_inputs(torch, ek, mps_core, sweeps, Circuit, compile_tape,
                      chi=64):
    """The arguments of every tridiag, teig and backtransform launch of one
    sweep at phase_sweep's shape (n=50, chi=64, or the chi given):
    {name: [args, ...]}, in launch order, cloned as they were passed."""
    from adaptaqc_tpu_torch.workloads.bench_sweep import bench_workload
    n, dev = 50, torch.device("cuda")
    target, ansatz = bench_workload(n, 12)
    tt, at = compile_tape(target), compile_tape(ansatz)
    prefix = mps_core.apply_tape(
        mps_core.zero_mps(n, chi, torch.complex64, dev), tt.kinds, tt.q0,
        tt.q1, tt.angles, 1e-16)
    ref = mps_core.zero_mps(n, chi, torch.complex64, dev)
    bl = sweeps.default_block_len(at.padded_length, sweeps.state_nbytes(ref))
    return record_eigh_inputs(torch, ek, lambda: sweeps.sweep(
        mps_core.sweep_engine(1e-16), bl, True, prefix, ref, at.kinds,
        at.q0, at.q1, at.angles, at.trainable))


def record_eigh_inputs(torch, ek, fn):
    """Run fn() with recorders around ek.tridiag, teig and backtransform:
    {name: [args, ...]} of every launch, in launch order, cloned as they
    were passed, strides and all (K3's z is a view of the first columns of
    an (m, m) buffer, and K4 reads it at row stride m)."""
    seen = {"tridiag": [], "teig": [], "backtransform": []}
    kernels = {name: getattr(ek, name) for name in seen}

    def copy(a):
        if not isinstance(a, torch.Tensor):
            return a
        b = torch.empty_strided(a.size(), a.stride(), dtype=a.dtype,
                                device=a.device)
        return b.copy_(a)

    def recorder(name):
        def record(*args):
            seen[name].append(tuple(copy(a) for a in args))
            return kernels[name](*args)
        record.launches = 0  # a wrapper counts on its module-level name
        record.batched_launches = record.wide_launches = 0
        record.f64_launches = record.strip_launches = 0
        record.reach_launches = record.reach_f64_launches = 0
        return record
    try:
        for name in seen:
            setattr(ek, name, recorder(name))
        fn()
        torch.cuda.synchronize()
    finally:
        for name, fn_ in kernels.items():
            setattr(ek, name, fn_)
    return seen


def env_inputs(torch, n, chi, dev):
    """Bra and ket site stacks (n, 2, chi, chi) from a seed: a ket close to
    the bra keeps C of order one over 50 sites, as the probes of a
    converging sweep see it (independent random tensors make the chains
    decay to ~1e-11). Past chi = 1024 drawn on the card (2 x 3.4 GB at chi
    = 2048 would take the host half a minute)."""
    gdev = dev if chi > 1024 else "cpu"
    g = torch.Generator(device=gdev).manual_seed(chi)
    scale = (2.0 * chi) ** -0.5
    br = torch.randn(n, 2, chi, chi, generator=g, device=gdev,
                     dtype=torch.complex64) * scale
    bl = br + 0.1 * scale * torch.randn(n, 2, chi, chi, generator=g,
                                        device=gdev, dtype=torch.complex64)
    return br.to(dev), bl.to(dev)


def ormqr_inputs(torch, vrows, tau, z, keep):
    """K4's function as one torch.ormqr call: Q = H_0 ... H_{m-2} acts as
    the identity on row 0, and on rows 1.. as the product of m-1
    reflectors stored in geqrf layout (column k holds v_k[1:], whose
    leading entry is v_k[k+1] = 1). Returns (a, tau, other) such that
    out[1:] = ormqr(a, tau, other) and out[0] = z[0, :keep]."""
    m = vrows.shape[0]
    a = vrows[: m - 1, 1:].transpose(0, 1).contiguous()
    other = z[1:, :keep].to(torch.complex64).contiguous()
    return a, tau[: m - 1].contiguous(), other


def teig_vector_errors(d, e, w, z, zp):
    """The eigenvectors z of teig (kernel) on the tridiagonal (d, e),
    measured in float64 (the products on z's device, T's float64
    eigenvectors on the host by scipy's tridiagonal solver):
      z        max |z - zp| after each column's sign is matched to the
               plain version's zp (meaningful where w is well separated)
      ortho    max |z^T z - I|
      resid    max_j ||T z_j - w_j z_j|| / max|w|
      cluster  max |Z_c Z_c^T - V_c V_c^T| over the degenerate clusters c
               of the float64 spectrum (eigenvalues equal to 1e-9 of the
               scale, at least 1e-2 of the scale from every other one),
               V from float64 eigh of T: an eigenspace's projector is
               fixed even where its vectors may rotate."""
    import scipy.linalg
    import torch
    d64, e64 = d.double(), e.double()[:-1]
    zz, zr, wk = z.double(), zp.double(), w.double()
    m = d64.shape[0]
    sign = torch.where((zz * zr).sum(0) < 0, -1.0, 1.0)
    tz = d64[:, None] * zz  # T z, T tridiagonal
    tz[:-1] += e64[:, None] * zz[1:]
    tz[1:] += e64[:, None] * zz[:-1]
    w64, v64 = scipy.linalg.eigh_tridiagonal(d64.cpu().numpy(),
                                             e64.cpu().numpy())
    w64, v64 = w64[::-1], v64[:, ::-1]
    scale = max(np.abs(w64).max(), 1e-30)
    eye = torch.eye(m, dtype=torch.float64, device=zz.device)
    out = {"z": float((zz * sign - zr).abs().max()),
           "ortho": float((zz.T @ zz - eye).abs().max()),
           "resid": float(torch.linalg.vector_norm(tz - zz * wk, dim=0).max())
           / scale,
           "cluster": 0.0}
    starts = [0] + [i for i in range(1, m)
                    if w64[i - 1] - w64[i] > 1e-9 * scale] + [m]
    for a, b in zip(starts[:-1], starts[1:]):
        gap_lo = w64[a - 1] - w64[a] if a > 0 else np.inf
        gap_hi = w64[b - 1] - w64[b] if b < m else np.inf
        if b - a < 2 or min(gap_lo, gap_hi) < 1e-2 * scale:
            continue
        vc = torch.from_numpy(np.ascontiguousarray(v64[:, a:b])).to(zz.device)
        pk = zz[:, a:b] @ zz[:, a:b].T
        out["cluster"] = max(out["cluster"],
                             float((pk - vc @ vc.T).abs().max()))
    return out


def zeros_equal(e, tau, ep, taup, what):
    """K2's exactly inactive steps: wherever the plain version's e_k and
    tau_k are 0 the kernel's are exactly 0 too, and the kernel's e and tau
    are 0 at the same steps. Returns the kernel's count of inactive steps.
    (The kernel may find more: a residue column that its rounding drives
    to exact zero, where the plain version's stays at rounding level.)"""
    ek_, tk = e[:-1] == 0, tau[:-1] == 0
    check(bool((ek_ == tk).all()), f"{what}: e and tau zeros differ")
    plain = (ep[:-1] == 0) & (taup[:-1] == 0)
    check(bool((ek_ | ~plain).all()),
          f"{what}: {int((plain & ~ek_).sum())} steps inactive in the plain "
          "version are active in the kernel")
    return int(ek_.sum())


def sweep_eigh_check(torch, ek, inputs, rec, card):
    """K2 and K4 on the inputs one sweep gives them (n=50, chi=64: 24 Grams
    at m=128 and their reflectors), against their plain versions at the
    tolerances of the class loop, with their mean time on those inputs and
    the count of exactly inactive steps; the bound counts the active ones."""
    grams = [a[0] for a in inputs["tridiag"]]
    bts = inputs["backtransform"]
    inactive, worst_t, worst_b, bound2, bound4 = 0, 0.0, 0.0, [], []
    for hh in grams:
        m = hh.shape[0]
        v, tau, d, e = ek.tridiag(hh)
        _, taup, _, ep = ek.tridiag_plain(hh)
        inactive += zeros_equal(e, tau, ep, taup, "tridiag on a sweep Gram")
        err = tridiag_residual(torch, ek, v, tau, d, e, hh)
        worst_t = max(worst_t, err)
        check(err < TOL_TRIDIAG_REL, f"tridiag on a sweep Gram: rel {err}")
        act = [k for k in range(m - 1) if e[k] != 0]
        bound2.append(kernel_bound("tridiag", m=m, active=act)[0])
    for vr, ta, z, keep in bts:
        o = ek.backtransform(vr, ta, z, keep)
        err = float((o - ek.backtransform_plain(vr, ta, z, keep)).abs().max())
        worst_b = max(worst_b, err)
        check(err < TOL_BT, f"backtransform on a sweep input: {err}")
        m = vr.shape[0]
        act = [k for k in range(m - 1) if ta[k] != 0]
        bound4.append(kernel_bound("backtransform", m=m, keep=keep,
                                   active=act)[0])
    ms2 = float(np.mean([cuda_ms(lambda: ek.tridiag(hh), 10, torch)
                         for hh in grams]))
    ms4 = float(np.mean([cuda_ms(lambda: ek.backtransform(*a), 10, torch)
                         for a in bts]))
    lib4 = []  # torch.ormqr on the same reflectors (timed only)
    for vr, ta, z, keep in bts:
        oa, otau, oz = ormqr_inputs(torch, vr, ta, z, keep)
        lib4.append(cuda_ms(lambda: torch.ormqr(oa, otau, oz), 10, torch))
    rec["backtransform"]["library_ms_sweep_inputs"] = float(np.mean(lib4))
    steps = sum(h.shape[0] - 1 for h in grams)
    rec["tridiag"]["ms_sweep_inputs"] = ms2
    rec["backtransform"]["ms_sweep_inputs"] = ms4
    print(f"kernels: the sweep's own inputs (n=50, chi=64): {len(grams)} "
          f"Grams, {inactive} of {steps} tridiag steps exactly inactive "
          f"(zeros of e and tau equal, and every plain-inactive step "
          f"inactive); tridiag mean {ms2:.4f} ms (bound on the active steps "
          f"{np.mean(bound2):.5f}), Q T Q^H {worst_t:.2e} < {TOL_TRIDIAG_REL};"
          f" backtransform ({len(bts)} launches, keep "
          f"{sorted({a[3] for a in bts})}) mean {ms4:.4f} ms (bound "
          f"{np.mean(bound4):.5f}; torch.ormqr {np.mean(lib4):.4f} ms), vs "
          f"plain {worst_b:.2e} < {TOL_BT} on {card}", flush=True)


def tridiag_residual(torch, ek, v, tau, d, e, hh):
    """How far K2's own factorisation of one matrix is from exact, in
    float64: max of |Q Q^H - I| and |Q T Q^H - H| / max|H|."""
    m = hh.shape[-1]
    dev = hh.device
    q = ek.backtransform_plain(
        v.to(torch.complex128), tau.to(torch.complex128),
        torch.eye(m, dtype=torch.float64, device=dev), m)
    d64, e64 = d.double(), e[:-1].double()
    tm = torch.diag(d64) + torch.diag(e64, 1) + torch.diag(e64, -1)
    h64 = hh.to(torch.complex128)
    return max(float((q @ q.mH - torch.eye(m, device=dev)).abs().max()),
               float((q @ tm.to(q.dtype) @ q.mH - h64).abs().max())
               / max(float(h64.abs().max()), 1e-30))


def batch_against_singles(torch, ek, h, keep, what, worst):
    """K2 -> K3 -> K4 launched once on the batch h (P, m, m): every matrix
    must equal, bit for bit, the P = 1 launches on it, and agree with the
    plain versions at the tolerances of the unbatched checks (K2's own
    factorisation; K3's eigenvalues, orthogonality and residual on the
    kernel's (d, e); K4 on the kernel's reflectors). Returns the batched
    outputs."""
    v, tau, d, e = ek.tridiag(h)
    w, z = ek.teig(d, e)
    o = ek.backtransform(v, tau, z, keep)
    for i in range(h.shape[0]):
        one2 = ek.tridiag(h[i].contiguous())
        one3 = ek.teig(one2[2], one2[3])
        one4 = ek.backtransform(one2[0], one2[1], one3[1], keep)
        same = all(torch.equal(a[i], b) for a, b in zip(
            (v, tau, d, e, w, z, o), (*one2, *one3, one4)))
        check(same, f"{what}: matrix {i} of the batch differs from its "
                    "P = 1 launch")
        err_t = tridiag_residual(torch, ek, v[i], tau[i], d[i], e[i], h[i])
        wp, zp = ek.teig_plain(d[i], e[i])
        err_w = float((w[i] - wp).abs().max()) / max(float(wp.abs().max()),
                                                     1e-30)
        tv = teig_vector_errors(d[i], e[i], w[i], z[i], zp)
        err_b = float((o[i] - ek.backtransform_plain(v[i], tau[i], z[i],
                                                     keep)).abs().max())
        check(err_t < TOL_TRIDIAG_REL and err_w < TOL_TEIG_W_REL
              and tv["ortho"] < TOL_ORTHO and tv["resid"] < TOL_RESID
              and tv["cluster"] < TOL_VEC and err_b < TOL_BT,
              f"{what}: matrix {i}: tridiag {err_t}, teig w {err_w} "
              f"{tv}, backtransform {err_b}")
        for k, val in (("tridiag", err_t), ("teig", err_w),
                       ("teig_ortho", tv["ortho"]),
                       ("teig_resid", tv["resid"]), ("backtransform", err_b)):
            worst[k] = max(worst.get(k, 0.0), val)
    return v, tau, d, e, w, z, o


def _sym_gram(torch, th, dev):
    t = torch.tensor(th, dtype=torch.complex64, device=dev)
    h = t.mH @ t
    return ((h + h.mH) * 0.5).contiguous()


def batched_kernel_check(torch, ek, card, dev, probe_inputs=None):
    """K2-K4 over a batch in one launch, as the full-cost sweep launches
    them: P = 7 (Rotoselect's probes) and P = 3 (Rotosolve's), m = 32, 64,
    128, on the spectrum classes (and a copy of `rand` perturbed at 1e-3:
    the probe states of one gate give Grams that are close, not equal) and
    on probe batches recorded from a full-cost sweep; then times for
    P = 1, 3, 7 beside the bound of P matrices' work. Returns the records
    of the batched shapes of the spin phase (chi = 32: m = 64)."""
    rng = np.random.default_rng(77)
    worst, n_checked = {}, 0
    for m in (32, 64, 128):
        cases = _gram_cases(m, rng)
        near = cases["rand"] + 1e-3 * (rng.standard_normal((m, m)) + 1j
                                       * rng.standard_normal((m, m))) / m
        grams = {k: _sym_gram(torch, th, dev) for k, th in cases.items()}
        grams["near"] = _sym_gram(torch, near / np.linalg.norm(near), dev)
        for names in (list(grams), ["rand", "lowrank", "bell"]):
            h = torch.stack([grams[k] for k in names])
            batch_against_singles(torch, ek, h, m // 2,
                                  f"batched m={m} P={len(names)}", worst)
            n_checked += len(names)
    for m in WIDE_M:  # the wide variants: a batch of 3
        cases = _gram_cases(m, rng)
        h = torch.stack([_sym_gram(torch, cases[k], dev)
                         for k in ("rand", "lowrank", "bell")])
        batch_against_singles(torch, ek, h, m // 2, f"batched m={m} P=3",
                              worst)
        n_checked += 3
        if m == 256:  # 7 clusters of K3, more than the card runs at once
            h = torch.stack([_sym_gram(torch, th, dev)
                             for th in cases.values()]
                            + [_sym_gram(torch, _gram_cases(m, rng)["rand"],
                                         dev)])
            batch_against_singles(torch, ek, h, m // 2,
                                  f"batched m={m} P={h.shape[0]}", worst)
            n_checked += h.shape[0]
    n_probe = 0
    if probe_inputs is not None:
        batches = [a[0] for a in probe_inputs["tridiag"] if a[0].dim() == 3]
        check(batches, "the full-cost sweep gave K2 no batch")
        for h in batches[:4] + batches[-4:]:
            batch_against_singles(torch, ek, h, h.shape[-1] // 2,
                                  f"probe batch P={h.shape[0]}", worst)
            n_probe += h.shape[0]
    print(f"kernels: batched launches: {n_checked} matrices of the spectrum "
          f"classes in batches of 7 and 3 at m=32/64/128, of 3 at m="
          f"{'/'.join(map(str, WIDE_M))} and of 7 at m=256, and {n_probe} of "
          f"recorded probe batches each equal their P=1 launch bit for bit "
          f"and agree with the plain versions (worst: tridiag QTQ^H "
          f"{worst['tridiag']:.2e} < {TOL_TRIDIAG_REL}, teig w "
          f"{worst['teig']:.2e} < {TOL_TEIG_W_REL} ortho "
          f"{worst['teig_ortho']:.2e} < {TOL_ORTHO} resid "
          f"{worst['teig_resid']:.2e} < {TOL_RESID}, backtransform "
          f"{worst['backtransform']:.2e} < {TOL_BT})", flush=True)

    rec, ms_p3 = {}, {}
    for m in (32, 64, 128):
        keep = m // 2
        row = []
        for p in (1, 3, 7):
            h = torch.stack([_sym_gram(
                torch, _gram_cases(m, rng)["rand"], dev) for _ in range(p)])
            v, tau, d, e = ek.tridiag(h)
            w, z = ek.teig(d, e)
            tdense = (torch.diag_embed(d) + torch.diag_embed(e[:, :-1], 1)
                      + torch.diag_embed(e[:, :-1], -1)).contiguous()
            oa = v[:, : m - 1, 1:].transpose(1, 2).contiguous()
            otau = tau[:, : m - 1].contiguous()
            oz = z[:, 1:, :keep].to(torch.complex64).contiguous()
            calls = {
                "tridiag": (lambda: ek.tridiag(h),
                            lambda: ek.tridiag_plain(h), None),
                "teig": (lambda: ek.teig(d, e), lambda: ek.teig_plain(d, e),
                         lambda: torch.linalg.eigh(tdense)),
                "backtransform": (
                    lambda: ek.backtransform(v, tau, z, keep),
                    lambda: ek.backtransform_plain(v, tau, z, keep),
                    lambda: torch.ormqr(oa, otau, oz)),
            }
            for kname, (kfn, pfn, lfn) in calls.items():
                ms = cuda_ms(kfn, 20, torch)
                bound = bound_fields(
                    kname, m=m, keep=m if kname == "teig" else keep, batch=p)
                row.append(f"{kname} P={p} {ms:.4f} ms (bound "
                           f"{bound['bound_ms']:.5f})")
                if m == 64 and p == 3:
                    ms_p3[kname] = ms
                if m == 64 and p == 7:
                    lib = {"tridiag": None, "teig":
                           "torch.linalg.eigh of the (7, m, m) dense T",
                           "backtransform":
                           "torch.ormqr on the batch of 7"}[kname]
                    rec[f"{kname}[batched]"] = dict(
                        ms=ms, plain_ms=cuda_ms(pfn, 1, torch),
                        library_call=lib,
                        library_ms=cuda_ms(lfn, 20, torch) if lfn else None,
                        shape="P=7, m=64", max_abs_err=None,
                        ms_p3=ms_p3[kname], **bound)
        print(f"kernels: batched m={m}: " + "; ".join(row) + f" on {card}",
              flush=True)
    rec["tridiag[batched]"]["max_abs_err"] = worst["tridiag"]
    rec["teig[batched]"]["max_abs_err"] = worst["teig"]
    rec["backtransform[batched]"]["max_abs_err"] = worst["backtransform"]
    for kname in ("tridiag", "teig", "backtransform"):
        r = rec[f"{kname}[batched]"]
        print(f"kernels: {kname} P=7 m=64: kernel {r['ms']:.4f} ms (P=3 "
              f"{r['ms_p3']:.4f}), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}), "
              + (f"{r['library_call']} {r['library_ms']:.4f} ms"
                 if r["library_ms"] is not None else "no library call")
              + f" on {card}", flush=True)
    return rec


def center_kernel_check(torch, ek, inputs, card):
    """K2-K4 on what the center-gauge engine gives them (one Trotter step
    at n=50, chi=32: its center moves decompose a (2 chi, chi) matrix, a
    Gram of m = chi, beside the m = 2 chi of its two-qubit applies):
    against the plain versions at the tolerances of the class loop, with
    the mean time by m."""
    by_m = {}
    for idx, args in enumerate(inputs["tridiag"]):
        by_m.setdefault(args[0].shape[-1], []).append(idx)
    check(set(by_m) == {32, 64}, f"center engine Grams of m {sorted(by_m)}")
    parts = []
    for m, idxs in sorted(by_m.items()):
        worst_t = worst_w = worst_b = 0.0
        for idx in idxs[:4] + idxs[-4:]:
            hh = inputs["tridiag"][idx][0]
            v, tau, d, e = ek.tridiag(hh)
            worst_t = max(worst_t, tridiag_residual(torch, ek, v, tau, d, e,
                                                    hh))
            dd, ee, kk = inputs["teig"][idx]  # as eigh_top_kernels calls it
            w, z = ek.teig(dd, ee, kk)
            wp, _ = ek.teig_plain(dd, ee, keep=kk)
            worst_w = max(worst_w, float((w - wp).abs().max())
                          / max(float(wp.abs().max()), 1e-30))
            bt = inputs["backtransform"][idx]
            worst_b = max(worst_b, float(
                (ek.backtransform(*bt) - ek.backtransform_plain(*bt))
                .abs().max()))
        check(worst_t < TOL_TRIDIAG_REL and worst_w < TOL_TEIG_W_REL
              and worst_b < TOL_BT,
              f"center engine inputs m={m}: tridiag {worst_t}, teig w "
              f"{worst_w}, backtransform {worst_b}")
        ms = {name: float(np.mean([cuda_ms(
            lambda: getattr(ek, name)(*inputs[name][i]), 5, torch)
            for i in idxs[:8]])) for name in inputs}
        # the bounds (K2 and K4 on their active steps) and the library
        # calls of the same functions, over the same eight inputs
        bnd = {"tridiag": [], "teig": [], "backtransform": []}
        lib = {"teig": [], "backtransform": []}
        for i in idxs[:8]:
            _, _, _, e2 = ek.tridiag(inputs["tridiag"][i][0])
            bnd["tridiag"].append(kernel_bound(
                "tridiag", m=m,
                active=[k for k in range(m - 1) if e2[k] != 0])[0])
            dd, ee, kk = inputs["teig"][i]
            bnd["teig"].append(kernel_bound("teig", m=m, keep=kk)[0])
            vr, ta, z, keep = inputs["backtransform"][i]
            bnd["backtransform"].append(kernel_bound(
                "backtransform", m=m, keep=keep,
                active=[k for k in range(m - 1) if ta[k] != 0])[0])
            tdense = (torch.diag(dd) + torch.diag(ee[:-1], 1)
                      + torch.diag(ee[:-1], -1)).contiguous()
            lib["teig"].append(cuda_ms(lambda: torch.linalg.eigh(tdense), 5,
                                       torch))
            oa, otau, oz = ormqr_inputs(torch, vr, ta, z, keep)
            lib["backtransform"].append(cuda_ms(
                lambda: torch.ormqr(oa, otau, oz), 5, torch))
        parts.append(
            f"m={m} ({len(idxs)} Grams, keep "
            f"{sorted({inputs['backtransform'][i][3] for i in idxs})}): "
            f"tridiag {ms['tridiag']:.4f} ms (bound "
            f"{np.mean(bnd['tridiag']):.5f}, no library call) QTQ^H "
            f"{worst_t:.2e}, teig {ms['teig']:.4f} ms (bound "
            f"{np.mean(bnd['teig']):.5f}, linalg.eigh(T) "
            f"{np.mean(lib['teig']):.4f}) w {worst_w:.2e}, backtransform "
            f"{ms['backtransform']:.4f} ms (bound "
            f"{np.mean(bnd['backtransform']):.5f}, ormqr "
            f"{np.mean(lib['backtransform']):.4f}) {worst_b:.2e}")
    print("kernels: the center-gauge engine's inputs (one Trotter step, "
          "n=50, chi=32): " + "; ".join(parts) + f" on {card}", flush=True)


def f64_kernel_check(torch, ek, envk, card, dev, rec):
    """The complex128 instantiations against their plain versions in
    complex128 on the card: K1 at n=50, chi 2/32/128 and q 0/1/25/48/49
    (TOL_F64_ENV); K2-K4 at m = 4 and 64 on every spectrum class and at
    m = 256 and 504 (their cap) on "rand" and "lowrank": K2's own Q T Q^H
    = H, K3's eigenvalues, orthogonality and residual, K4, and the chain
    against numpy float64 (TOL_F64); a batch of 3 bit for bit against its
    P = 1 launches; K3's w bit for bit equal to the plain version's. Times
    at the shapes of the optim phase's complex128 compile (n=10, chi=32: K1
    at q=5, K2-K4 at m=64) and at m=256 and 504, with the bound at the fp64
    peak and the library calls (every m in the record's `by_m`)."""
    rng = np.random.default_rng(64)
    c128 = torch.complex128
    worst = {"env": 0.0, "tridiag": 0.0, "teig": 0.0, "ortho": 0.0,
             "resid": 0.0, "bt": 0.0, "chain": 0.0}
    for chi in (2, 32, 128):
        br, bl = (t.to(c128) for t in env_inputs(torch, 50, chi, dev))
        for q in (0, 1, 25, 48, 49):
            c = envk.env_chain(br, bl, q)
            cp = envk.env_chain_plain(br, bl, q)
            rel = float((c - cp).abs().max()) / max(float(cp.abs().max()),
                                                    1e-300)
            worst["env"] = max(worst["env"], rel)
            check(rel < TOL_F64_ENV, f"env_chain complex128 chi={chi} q={q}: "
                                     f"rel {rel}")
    for m in (4, 64, 256, 504):
        cases = _gram_cases(m, rng)
        names = list(cases) if m <= 64 else ["rand", "lowrank"]
        for name in names:
            t = torch.tensor(cases[name], dtype=c128, device=dev)
            h = t.mH @ t
            hh = ((h + h.mH) * 0.5).contiguous()
            v, tau, d, e = ek.tridiag(hh)
            worst["tridiag"] = max(worst["tridiag"], tridiag_residual(
                torch, ek, v, tau, d, e, hh))
            _, taup, _, ep = ek.tridiag_plain(hh)
            zeros_equal(e, tau, ep, taup, f"tridiag complex128 m={m} {name}")
            w, z = ek.teig(d, e)
            wp, zp = ek.teig_plain(d, e)
            check(torch.equal(w, wp), f"teig complex128 m={m} {name}: w "
                  "differs from the plain version's")
            worst["teig"] = max(worst["teig"], float((w - wp).abs().max())
                                / max(float(wp.abs().max()), 1e-300))
            tv = teig_vector_errors(d, e, w, z, zp)
            worst["ortho"] = max(worst["ortho"], tv["ortho"])
            worst["resid"] = max(worst["resid"], tv["resid"])
            keep = max(1, m // 2)
            o = ek.backtransform(v, tau, z, keep)
            worst["bt"] = max(worst["bt"], float(
                (o - ek.backtransform_plain(v, tau, z, keep)).abs().max()))
            h64 = hh.cpu().numpy()
            wx = np.linalg.eigvalsh(h64)[::-1][:keep]
            sc = max(np.abs(wx).max(), 1e-300)
            wk, vk = ek.eigh_top_kernels(hh, keep)
            V = vk.cpu().numpy()
            worst["chain"] = max(
                worst["chain"], np.abs(wk.cpu().numpy() - wx).max() / sc,
                np.abs(V.conj().T @ V - np.eye(keep)).max(),
                max(np.linalg.norm(h64 @ V[:, i] - float(wk[i]) * V[:, i])
                    / sc for i in range(min(4, keep))))
            check(max(worst.values()) < TOL_F64,
                  f"complex128 eigensolver m={m} {name}: {worst}")
        if m in (64, 504):
            h = torch.stack([_sym_gram(torch, cases[k], dev).to(c128)
                             for k in ("rand", "lowrank", "bell")])
            batch_against_singles(torch, ek, h, m // 2,
                                  f"complex128 batched m={m} P=3", {})

    # times at the complex128 compile's shapes, and at m=256
    br, bl = (t.to(c128) for t in env_inputs(torch, 10, 32, dev))
    ms = cuda_ms(lambda: envk.env_chain(br, bl, 5), 20, torch)
    pms = cuda_ms(lambda: envk.env_chain_plain(br, bl, 5), 5, torch)
    bound = bound_fields("env_chain", n=10, chi=32, f64=True)
    rec["env_chain[f64]"].update(
        ms=ms, plain_ms=pms, max_abs_err=worst["env"],
        shape="n=10, chi=32, q=5, complex128", **bound)
    parts = [f"env_chain n=10 chi=32 ({envk.cluster_size(32, True)} CTAs a "
             f"cluster) {ms:.4f} ms plain {pms:.4f} ms bound "
             f"{bound['bound_ms']:.5f} ms ({bound['bound_by']})"]
    for m in (64, 256, 504):
        th = _gram_cases(m, rng)["rand"]
        hh = _sym_gram(torch, th, dev).to(c128)
        vp, taup, dp, ep = ek.tridiag_plain(hh)
        wp, zp = ek.teig_plain(dp, ep)
        keep = m // 2
        tdense = (torch.diag(dp) + torch.diag(ep[:-1], 1)
                  + torch.diag(ep[:-1], -1)).contiguous()
        oa = vp[: m - 1, 1:].transpose(0, 1).contiguous()
        otau, oz = taup[: m - 1].contiguous(), zp[1:, :keep].to(c128)
        check(float((torch.ormqr(oa, otau, oz) - ek.backtransform_plain(
            vp, taup, zp, keep)[1:]).abs().max()) < TOL_F64,
              f"torch.ormqr does not compute backtransform in complex128")
        calls = {
            "tridiag": (lambda: ek.tridiag(hh), lambda: ek.tridiag_plain(hh),
                        None, None),
            "teig": (lambda: ek.teig(dp, ep), lambda: ek.teig_plain(dp, ep),
                     "torch.linalg.eigh(T) of the dense float64 T",
                     lambda: torch.linalg.eigh(tdense)),
            "backtransform": (
                lambda: ek.backtransform(vp, taup, zp, keep),
                lambda: ek.backtransform_plain(vp, taup, zp, keep),
                "torch.ormqr(v in geqrf layout, tau, z[1:, :keep]), "
                "complex128", lambda: torch.ormqr(oa, otau, oz))}
        for kname, (kfn, pfn, lname, lfn) in calls.items():
            ms = cuda_ms(kfn, 10, torch)
            pms = cuda_ms(pfn, 1, torch)
            lms = cuda_ms(lfn, 10, torch) if lfn else None
            bound = bound_fields(
                kname, m=m, keep=m if kname == "teig" else keep, f64=True)
            ctas = (ek.teig_cluster_size(m, True) if kname == "teig" else
                    tridiag_ctas(ek, m, True) if kname == "tridiag" else None)
            cl = (f" ({tridiag_plan_text(ek, m, True)})"
                  if kname == "tridiag" else
                  f" (clusters of {ctas} CTAs)" if ctas else "")
            parts.append(f"m={m} {kname}{cl} {ms:.4f} ms plain {pms:.4f} ms "
                         f"bound {bound['bound_ms']:.5f} ms "
                         f"({bound['bound_by']}) " + (
                             f"{lname} {lms:.4f} ms" if lfn
                             else "no library call"))
            rec[f"{kname}[f64]"].setdefault("by_m", {})[m] = dict(
                ms=ms, plain_ms=pms, library_ms=lms, cluster_ctas=ctas,
                **bound)
            if kname == "tridiag":
                rec["tridiag[f64]"]["by_m"][m]["route"] = (
                    ek.tridiag_routes(m, True))
            if m == 64:
                rec[f"{kname}[f64]"].update(
                    ms=ms, plain_ms=pms, library_call=lname, library_ms=lms,
                    shape="m=64, complex128", **bound)
        native_ms = cuda_ms(lambda: torch.linalg.eigh(hh), 10, torch)
        parts.append(f"m={m} the whole K2-K4 chain's yardstick "
                     f"torch.linalg.eigh(H) complex128 {native_ms:.4f} ms")
        rec["tridiag[f64]"]["by_m"][m]["eigh_h_ms"] = native_ms
    rec["tridiag[f64]"]["max_abs_err"] = worst["tridiag"]
    rec["teig[f64]"]["max_abs_err"] = worst["teig"]
    rec["backtransform[f64]"]["max_abs_err"] = worst["bt"]
    print("kernels: complex128 (double instantiations) agree with their "
          f"plain versions in complex128 (worst: env_chain rel "
          f"{worst['env']:.2e} < {TOL_F64_ENV}; tridiag QTQ^H "
          f"{worst['tridiag']:.2e}, teig w {worst['teig']:.2e} ortho "
          f"{worst['ortho']:.2e} resid {worst['resid']:.2e}, backtransform "
          f"{worst['bt']:.2e}, chain vs numpy {worst['chain']:.2e}, all < "
          f"{TOL_F64}; w bit-equal; batches of 3 at m=64/504 bit for bit); "
          + "; ".join(parts) + f" on {card}", flush=True)


def bt_sweep128_check(torch, ek, bts, rec, card):
    """K4's wide design on the reflectors one chi=128 sweep gives it (m =
    256, its 24 launches) against the plain version (TOL_BT), with its mean
    time over those inputs, the bound on their active reflectors and
    torch.ormqr on the same reflectors."""
    worst, bounds, lib = 0.0, [], []
    for vr, ta, z, keep in bts:
        err = float((ek.backtransform(vr, ta, z, keep)
                     - ek.backtransform_plain(vr, ta, z, keep)).abs().max())
        worst = max(worst, err)
        check(err < TOL_BT, f"backtransform on a chi=128 sweep input: {err}")
        m = vr.shape[0]
        act = [k for k in range(m - 1) if ta[k] != 0]
        bounds.append(kernel_bound("backtransform", m=m, keep=keep,
                                   active=act)[0])
        oa, otau, oz = ormqr_inputs(torch, vr, ta, z, keep)
        lib.append(cuda_ms(lambda: torch.ormqr(oa, otau, oz), 10, torch))
    ms = float(np.mean([cuda_ms(lambda: ek.backtransform(*a), 10, torch)
                        for a in bts]))
    rec["backtransform[wide]"]["sweep_chi128"] = dict(
        launches=len(bts), ms=ms, bound_ms=float(np.mean(bounds)),
        library_ms=float(np.mean(lib)), max_abs_err=worst)
    print(f"kernels: backtransform on the chi=128 sweep's {len(bts)} inputs "
          f"(m=256, keep {sorted({a[3] for a in bts})}, clusters of "
          f"{ek.backtransform_cluster_size(256, 128)} CTAs): {ms:.4f} ms a "
          f"launch "
          f"(bound on the active reflectors {np.mean(bounds):.5f} ms; "
          f"torch.ormqr {np.mean(lib):.4f} ms), vs plain {worst:.2e} < "
          f"{TOL_BT} on {card}", flush=True)


def tridiag_plan_text(ek, m, f64=False):
    """K2's wide plan at m, as the kernels lines print it: its cluster, or
    past the cluster's shared memory its card-wide route."""
    if ek.tridiag_routes(m, f64) == "grid":
        pl = ek.tridiag_grid_plan(m, f64)
        return (f"card-wide route: {pl['ctas']} CTAs, panels of "
                f"{pl['panel']} columns, {pl['smem']} bytes of shared "
                f"memory a CTA")
    pl = ek.tridiag_cluster_plan(m, f64)
    return (f"clusters of {pl['ctas']} CTAs, {pl['rows']} rows a CTA in "
            f"shared memory (route smem)")


def tridiag_ctas(ek, m, f64=False):
    """The CTAs K2's wide variant runs a matrix of size m on: its cluster,
    or past the cluster's shared memory the card-wide route's grid."""
    if ek.tridiag_routes(m, f64) == "grid":
        return ek.tridiag_grid_plan(m, f64)["ctas"]
    return ek.tridiag_cluster_plan(m, f64)["ctas"]


def tridiag_cluster_check(torch, ek, card, dev, rec, sweep128,
                          center_inputs=None):
    """K2's wide and complex128 kernel (tridiag_cluster_kernel) beyond the
    class loop: Q T Q^H = H at complex64 m=560 and at the complex128 sizes
    on each side of the fit of a CTA's rows in its shared memory (both
    routes); the inactive steps against the plain version's on the chi=128
    sweep's 24 Grams (complex64, and the first 8 in complex128) and on the
    center-gauge engine's inputs in complex128; complex128 batches of 3
    and 7 at m=256 bit for bit against their P=1 launches; and the
    kernel's mean time on the chi=128 sweep's Grams with its active steps
    and the bound on them."""
    rng = np.random.default_rng(560)
    c128 = torch.complex128
    fit = max(m for m in range(2, 505)
              if ek.tridiag_routes(m, True) == "smem")
    worst = {False: 0.0, True: 0.0}
    sizes = [(560, False), (fit, True)] + ([(fit + 1, True)]
                                            if fit < 504 else [])
    for m, f64 in sizes:
        cases = _gram_cases(m, rng)
        for name in ("rand", "lowrank", "bell"):
            t = torch.tensor(cases[name], dtype=c128 if f64 else
                             torch.complex64, device=dev)
            h = t.mH @ t
            hh = ((h + h.mH) * 0.5).contiguous()
            v, tau, d, e = ek.tridiag(hh)
            err = tridiag_residual(torch, ek, v, tau, d, e, hh)
            worst[f64] = max(worst[f64], err)
            check(err < (TOL_F64 if f64 else TOL_TRIDIAG_REL),
                  f"tridiag m={m} {'complex128' if f64 else 'complex64'} "
                  f"{name}: rel {err}")
            _, taup, _, ep = ek.tridiag_plain(hh)
            zeros_equal(e, tau, ep, taup, f"tridiag m={m} {name}")
    plans = "; ".join(f"m={m} {'c128' if f64 else 'c64'} "
                      + tridiag_plan_text(ek, m, f64) for m, f64 in sizes)
    print(f"kernels: tridiag cluster kernel past the class loop: Q T Q^H "
          f"complex64 {worst[False]:.2e} < {TOL_TRIDIAG_REL}, complex128 "
          f"{worst[True]:.2e} < {TOL_F64} (the largest complex128 m whose "
          f"rows fit in shared memory: {fit}); {plans} on {card}",
          flush=True)

    # the chi=128 sweep's Grams, and the center-gauge engine's in complex128
    inactive, steps, act_n, bounds = {}, 0, [], []
    for f64, grams in ((False, sweep128),
                       (True, [g.to(c128) for g in sweep128[:8]])):
        inactive[f64] = 0
        for hh in grams:
            v, tau, d, e = ek.tridiag(hh)
            err = tridiag_residual(torch, ek, v, tau, d, e, hh)
            check(err < (TOL_F64 if f64 else TOL_TRIDIAG_REL),
                  f"tridiag on a chi=128 sweep Gram: rel {err}")
            _, taup, _, ep = ek.tridiag_plain(hh)
            inactive[f64] += zeros_equal(e, tau, ep, taup,
                                         "tridiag on a chi=128 sweep Gram")
            if not f64:
                m = hh.shape[0]
                steps += m - 1
                act = [k for k in range(m - 1) if e[k] != 0]
                act_n.append(len(act))
                bounds.append(kernel_bound("tridiag", m=m, active=act)[0])
    n_center = 0
    if center_inputs is not None:
        by_m = {}
        for idx, args in enumerate(center_inputs["tridiag"]):
            by_m.setdefault(args[0].shape[-1], []).append(idx)
        for m, idxs in sorted(by_m.items()):
            for idx in idxs[:4] + idxs[-4:]:
                hh = center_inputs["tridiag"][idx][0].to(c128)
                v, tau, d, e = ek.tridiag(hh)
                err = tridiag_residual(torch, ek, v, tau, d, e, hh)
                check(err < TOL_F64, f"tridiag complex128 on a center-gauge "
                                     f"Gram m={m}: rel {err}")
                _, taup, _, ep = ek.tridiag_plain(hh)
                zeros_equal(e, tau, ep, taup,
                            f"tridiag complex128 on a center-gauge Gram m={m}")
                n_center += 1
    ms = float(np.mean([cuda_ms(lambda: ek.tridiag(hh), 10, torch)
                        for hh in sweep128]))
    ms64 = float(np.mean([cuda_ms(lambda: ek.tridiag(hh.to(c128)), 10, torch)
                          for hh in sweep128[:8]]))
    rec["tridiag[wide]"]["sweep_chi128"] = dict(
        grams=len(sweep128), ms=ms, active_steps=float(np.mean(act_n)),
        steps=steps / len(sweep128), bound_ms=float(np.mean(bounds)),
        ms_complex128_first8=ms64)
    for p in (3, 7):  # complex128 batches at m=256
        cases = _gram_cases(256, rng)
        names = (["rand", "lowrank", "bell"] if p == 3 else list(cases))
        grams = [_sym_gram(torch, cases[k], dev).to(c128) for k in names]
        grams += [_sym_gram(torch, _gram_cases(256, rng)["rand"],
                            dev).to(c128) for _ in range(p - len(grams))]
        batch_against_singles(torch, ek, torch.stack(grams), 128,
                              f"complex128 batched m=256 P={p}", {})
    print(f"kernels: tridiag on the chi=128 sweep's {len(sweep128)} Grams "
          f"(m=256, {tridiag_plan_text(ek, 256)}): {ms:.4f} ms a launch, "
          f"{np.mean(act_n):.1f} of {steps / len(sweep128):.0f} steps "
          f"active, bound on the active steps {np.mean(bounds):.5f} ms; in "
          f"complex128 (first 8) {ms64:.4f} ms; inactive steps "
          f"{inactive[False]} (complex64) and {inactive[True]} (complex128, "
          f"first 8), every plain-inactive step inactive, and on {n_center} "
          f"center-gauge Grams in complex128; complex128 batches of 3 and 7 "
          f"at m=256 bit-equal to P=1 on {card}", flush=True)


def wide_plan_check(envk):
    """The complex64 wide K1's plan mirror (env_kernel.wide_plan) equal to
    the library's (env_chain_wide_plan) at every chi of 65..128: cluster,
    blocks, depth, tiles, shared memory and threads."""
    import ctypes
    from adaptaqc_tpu_torch.ops import cuda_lib
    lib = cuda_lib.lib()
    for chi in range(envk.NARROW_MAX_CHI + 1, envk.CLUSTER_MAX_CHI + 1):
        out = (ctypes.c_int * 12)()
        check(lib.env_chain_wide_plan(chi, out) == 0,
              f"env_chain_wide_plan refused chi={chi}")
        pl = envk.wide_plan(chi)
        want = [pl["ctas"], *pl["grid"], pl["br"], pl["bc"], pl["ld"],
                *pl["step1"], *pl["step2"], pl["smem"], pl["threads"]]
        check(list(out) == want, f"env_chain wide plan at chi={chi}: the "
              f"library's {list(out)}, the mirror's {want}")
    print(f"kernels: env_chain wide plan mirror equal to the library's at "
          f"chi {envk.NARROW_MAX_CHI + 1}..{envk.CLUSTER_MAX_CHI} "
          f"(128: {envk.wide_plan(128)})", flush=True)


def bound_fields(name, **shape):
    ms, by, _, _ = kernel_bound(name, **shape)
    return {"bound_ms": ms, "bound_by": by}


def phase_kernels(torch, ek, envk, cplx, card, probe_sites,
                  sweep_inputs=None, probe_inputs=None, center_inputs=None,
                  dev="cuda", sweep128_inputs=None):
    dev = torch.device(dev)
    rng = np.random.default_rng(2026)
    rec = {k: {"max_abs_err": None, "ms": None, "plain_ms": None,
               "bound_ms": None, "bound_by": None, "library_call": None,
               "library_ms": None}
           for k in list(KERNELS) + [f"{k}[{v}]" for k in KERNELS
                                     for v in ("wide", "f64")]}
    worst = {"env_chain": 0.0, "tridiag": 0.0, "tridiag_factors": 0.0,
             "teig": 0.0, "teig_z": 0.0, "teig_ortho": 0.0,
             "teig_resid": 0.0, "teig_cluster": 0.0,
             "backtransform": 0.0, "chain_w": 0.0, "ortho": 0.0,
             "resid": 0.0}
    # K1: n = 50 chains at every width the contract takes a ragged slab
    # at, at chi 32 (the compile) and 64 (bench.py's sweep), and in the
    # wide variant at its edges, odd chi and 96 and 128 (the chi
    # schedule's last stage)
    n = 50
    wide_plan_check(envk)
    for chi in (2, 24, 32, 64) + WIDE_CHI:
        br, bl = env_inputs(torch, n, chi, dev)
        for q in (0, 1, 17, 25, 48, 49):
            c = envk.env_chain(br, bl, q)
            cp = envk.env_chain_plain(br, bl, q)
            err = float((c - cp).abs().max())
            rel = err / max(float(cp.abs().max()), 1e-30)
            worst["env_chain"] = max(worst["env_chain"], rel)
            check(rel < TOL_ENV_REL, f"env_chain chi={chi} q={q} rel {rel}")
            if chi == 32 and q == 17:
                rec["env_chain"]["max_abs_err"] = err
            if chi in WIDE_CHI:
                wide_err = rec["env_chain[wide]"]["max_abs_err"] or 0.0
                rec["env_chain[wide]"]["max_abs_err"] = max(wide_err, err)
        if chi == 128:
            check(torch.equal(envk.env_chain(br, bl, 25),
                              envk.env_chain(br, bl, 25)),
                  "env_chain chi=128: a rerun gave other bits")
        if chi < 32:
            continue
        by_q = {q: cuda_ms(lambda: envk.env_chain(br, bl, q), 20, torch)
                for q in (0, 25, 49)}
        site_ms = [cuda_ms(lambda: envk.env_chain(br, bl, q), 5, torch)
                   for q in probe_sites]
        pms = cuda_ms(lambda: envk.env_chain_plain(br, bl, 25), 3, torch)
        bound = bound_fields("env_chain", n=n, chi=chi)
        floor = ""
        if chi in WIDE_CHI:
            floor_ms, how = cluster_floor(n, chi, 25,
                                          envk.cluster_size(chi))
            floor = f"; cluster floor q=25 {floor_ms:.4f} ms ({how})"
            rec["env_chain[wide]"].setdefault("by_chi", {})[chi] = dict(
                ms_q0=by_q[0], ms=by_q[25], ms_q49=by_q[49],
                sweep_sites_ms=float(np.mean(site_ms)), plain_ms=pms,
                cluster_floor_ms=floor_ms, **bound)
        print(f"kernels: env_chain n={n} chi={chi} clusters of "
              f"{envk.cluster_size(chi)} CTAs, kernel "
              + ", ".join(f"q={q} {t:.4f} ms" for q, t in by_q.items())
              + f", mean over the sweep's {len(site_ms)} probe sites "
              f"{np.mean(site_ms):.4f} ms; plain q=25 {pms:.4f} ms; bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}){floor}; "
              f"no library call on {card}", flush=True)
        if chi == 32:
            rec["env_chain"].update(ms=by_q[25], plain_ms=pms,
                                    shape="n=50, chi=32, q=25", **bound)
        if chi == 128:
            rec["env_chain[wide]"].update(
                ms=by_q[25], plain_ms=pms, shape="n=50, chi=128, q=25",
                cluster_floor_ms=floor_ms, cluster_floor_by=how, **bound)

    # K2-K4 on every spectrum class, m = 4 .. 128, and the wide variants
    for m in (4, 16, 64, 128) + WIDE_M:
        for name, th in _gram_cases(m, rng).items():
            t = torch.tensor(th, dtype=torch.complex64, device=dev)
            h = t.mH @ t
            hh = ((h + h.mH) * 0.5).contiguous()
            v, tau, d, e = ek.tridiag(hh)
            vp, taup, dp, ep = ek.tridiag_plain(hh)
            # the kernel's own factorisation: Q unitary, Q T Q^H = H (a
            # reflector's sign is a free choice where Re(alpha) ~ 0, so
            # factors are compared with the plain version's only on "rand")
            hscale = max(float(hh.abs().max()), 1e-30)
            err_t = tridiag_residual(torch, ek, v, tau, d, e, hh)
            worst["tridiag"] = max(worst["tridiag"], err_t)
            check(err_t < TOL_TRIDIAG_REL,
                  f"tridiag m={m} {name}: rel {err_t}")
            zeros_equal(e, tau, ep, taup, f"tridiag m={m} {name}")
            # the factors of a random Gram are comparable between two
            # float32 reductions only so deep (tools/factor_drift.py: the
            # plain version's float32 and float64 tau differ by 1.7e-2 at
            # m=256 and by O(1) at m=512; the reduction is a Krylov process,
            # whose late vectors amplify rounding), so above m=128 Q T Q^H
            # = H and the chain's checks hold the kernel
            if name == "rand" and m <= 128:
                err_f = max(float((d - dp).abs().max()) / hscale,
                            float((e - ep).abs().max()) / hscale,
                            float((tau - taup).abs().max()))
                worst["tridiag_factors"] = max(worst["tridiag_factors"],
                                               err_f)
                check(err_f < TOL_TRIDIAG_FACTORS,
                      f"tridiag m={m} factors vs plain: {err_f}")
            w, z = ek.teig(dp, ep)
            wp, zp = ek.teig_plain(dp, ep)
            wscale = max(float(wp.abs().max()), 1e-30)
            err_w = float((w - wp).abs().max()) / wscale
            worst["teig"] = max(worst["teig"], err_w)
            check(err_w < TOL_TEIG_W_REL, f"teig m={m} {name}: w {err_w}")
            tv = teig_vector_errors(dp, ep, w, z, zp)
            err_z = tv["z"] if name == "rand" else 0.0
            for k in ("ortho", "resid", "cluster"):
                worst["teig_" + k] = max(worst["teig_" + k], tv[k])
            worst["teig_z"] = max(worst["teig_z"], err_z)
            check(err_z < TOL_VEC and tv["ortho"] < TOL_ORTHO
                  and tv["resid"] < TOL_RESID and tv["cluster"] < TOL_VEC,
                  f"teig m={m} {name}: z vs plain {err_z}, " + ", ".join(
                      f"{k} {v}" for k, v in tv.items()))
            keep = m // 2
            o = ek.backtransform(vp, taup, zp, keep)
            op = ek.backtransform_plain(vp, taup, zp, keep)
            err_b = float((o - op).abs().max())
            worst["backtransform"] = max(worst["backtransform"], err_b)
            check(err_b < TOL_BT, f"backtransform m={m} {name}: {err_b}")
            # the whole kernel chain against float64
            hh64 = hh.to(torch.complex128).cpu().numpy()
            wx = np.linalg.eigvalsh(hh64)[::-1][:keep]
            sc = max(np.abs(wx).max(), 1e-30)
            wk, vk = ek.eigh_top_kernels(hh, keep)
            wk = wk.cpu().numpy().astype(float)
            V = vk.cpu().numpy().astype(complex)
            cw = np.abs(wk - wx).max() / sc
            co = np.abs(V.conj().T @ V - np.eye(keep)).max()
            cr = max(np.linalg.norm(hh64 @ V[:, i] - wk[i] * V[:, i]) / sc
                     for i in range(min(4, keep)))
            worst["chain_w"] = max(worst["chain_w"], cw)
            worst["ortho"] = max(worst["ortho"], co)
            worst["resid"] = max(worst["resid"], cr)
            check(cw < TOL_CHAIN_W and co < TOL_ORTHO and cr < TOL_RESID,
                  f"eigh chain m={m} {name}: w {cw} ortho {co} resid {cr}")
            if m in (64, 256) and name == "rand":
                sfx = "" if m == 64 else "[wide]"
                rec["tridiag" + sfx]["max_abs_err"] = max(
                    float((d - dp).abs().max()), float((e - ep).abs().max()),
                    float((tau - taup).abs().max()))
                rec["teig" + sfx]["max_abs_err"] = max(
                    float((w - wp).abs().max()), tv["z"])
                rec["backtransform" + sfx]["max_abs_err"] = err_b
        if m in (64, 128) + WIDE_M:
            th = _gram_cases(m, rng)["rand"]
            t = torch.tensor(th, dtype=torch.complex64, device=dev)
            hh = ((t.mH @ t + (t.mH @ t).mH) * 0.5).contiguous()
            vp, taup, dp, ep = ek.tridiag_plain(hh)
            wp, zp = ek.teig_plain(dp, ep)
            keep = m // 2
            # the library calls that compute the same functions (timed
            # here only; the port never calls them): eigh of the dense T,
            # and ormqr of the reflectors in geqrf layout, checked first
            tdense = (torch.diag(dp) + torch.diag(ep[:-1], 1)
                      + torch.diag(ep[:-1], -1)).contiguous()
            oa, otau, oz = ormqr_inputs(torch, vp, taup, zp, keep)
            lib_bt = torch.ormqr(oa, otau, oz)
            ref_bt = ek.backtransform_plain(vp, taup, zp, keep)
            check(float((lib_bt - ref_bt[1:]).abs().max()) < TOL_BT,
                  f"torch.ormqr does not compute backtransform at m={m}")
            times = {
                "tridiag": (lambda: ek.tridiag(hh),
                            lambda: ek.tridiag_plain(hh), None, None),
                "teig": (lambda: ek.teig(dp, ep),
                         lambda: ek.teig_plain(dp, ep),
                         "torch.linalg.eigh(T) of the dense float32 T",
                         lambda: torch.linalg.eigh(tdense)),
                "backtransform": (
                    lambda: ek.backtransform(vp, taup, zp, keep),
                    lambda: ek.backtransform_plain(vp, taup, zp, keep),
                    "torch.ormqr(v in geqrf layout, tau, z[1:, :keep])",
                    lambda: torch.ormqr(oa, otau, oz)),
            }
            parts = []
            for kname, (kfn, pfn, lname, lfn) in times.items():
                ms = cuda_ms(kfn, 20, torch)
                pms = cuda_ms(pfn, 2, torch)
                lms = cuda_ms(lfn, 20, torch) if lfn else None
                bound = bound_fields(
                    kname, m=m, keep=m if kname == "teig" else keep)
                ctas = (None if m <= 128 else ek.teig_cluster_size(m)
                        if kname == "teig" else tridiag_ctas(ek, m)
                        if kname == "tridiag" else None)
                cl = (f" ({tridiag_plan_text(ek, m)})"
                      if kname == "tridiag" and ctas else
                      f" (clusters of {ctas} CTAs)" if ctas else "")
                parts.append(
                    f"{kname}{cl} kernel {ms:.4f} ms plain {pms:.4f} ms bound "
                    f"{bound['bound_ms']:.5f} ms ({bound['bound_by']}) "
                    + (f"{lname} {lms:.4f} ms" if lfn else "no library call"))
                if m > 128:
                    rec[kname + "[wide]"].setdefault("by_m", {})[m] = dict(
                        ms=ms, plain_ms=pms, library_ms=lms,
                        cluster_ctas=ctas, **bound)
                    if kname == "tridiag":
                        rec["tridiag[wide]"]["by_m"][m]["route"] = (
                            ek.tridiag_routes(m))
                if m in (64, 256):
                    rec[kname + ("" if m == 64 else "[wide]")].update(
                        ms=ms, plain_ms=pms, library_call=lname,
                        library_ms=lms, shape=f"m={m}", **bound)
            native_ms = cuda_ms(lambda: torch.linalg.eigh(hh), 20, torch)
            if m > 128:
                rec["tridiag[wide]"]["by_m"][m]["eigh_h_ms"] = native_ms
            print(f"kernels: m={m} " + "; ".join(parts) + "; the whole "
                  f"K2-K4 chain's yardstick torch.linalg.eigh(H) complex "
                  f"{native_ms:.4f} ms on {card}", flush=True)

    if sweep_inputs is not None:
        sweep_eigh_check(torch, ek, sweep_inputs, rec, card)
    rec.update(batched_kernel_check(torch, ek, card, dev, probe_inputs))
    if center_inputs is not None:
        center_kernel_check(torch, ek, center_inputs, card)
    f64_kernel_check(torch, ek, envk, card, dev, rec)
    if sweep128_inputs is not None:
        tridiag_cluster_check(torch, ek, card, dev, rec,
                              [a[0] for a in sweep128_inputs["tridiag"]],
                              center_inputs)
        bt_sweep128_check(torch, ek, sweep128_inputs["backtransform"], rec,
                          card)

    # K3 and the whole eigensolver chain against float64 truth on 7-decade
    # spectra: the kernel's eigenvalues of T against float64 eigh of the
    # same T, and svd_trunc's kept singular values and kept-subspace action
    # against a float64 SVD of the same float32 theta (the two metrics and
    # bounds of benchmarks/teig_check.py)
    t_worst = s_worst = act_worst = 0.0
    for m in (64, 128):
        a = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
        u, _, vh = np.linalg.svd(a)
        th = (u * np.logspace(0, -7, m)) @ vh
        th = th / np.linalg.norm(th)
        t = torch.tensor(th, dtype=torch.complex64, device=dev)
        h = t.mH @ t
        _, _, d, e = ek.tridiag(((h + h.mH) * 0.5).contiguous())
        w, _ = ek.teig(d, e)
        tm = (torch.diag(d.double()) + torch.diag(e[:-1].double(), 1)
              + torch.diag(e[:-1].double(), -1))
        w64 = torch.linalg.eigvalsh(tm).flip(0)
        t_worst = max(t_worst, float((w.double() - w64).abs().max())
                      / float(w64.abs().max()))
        th32 = t.cpu().numpy().astype(complex)
        _, s_true, vh_true = np.linalg.svd(th32)
        keep = m // 2
        vk_true = vh_true[:keep].conj().T
        act_true = th32 @ (vk_true @ vk_true.conj().T)
        _, s, vh_k = cplx.svd_trunc(t, keep, 1e-9, eigh="kernels")
        s = s.cpu().numpy().astype(float)
        vk = vh_k.cpu().numpy().astype(complex).conj().T
        s_worst = max(s_worst, np.abs(s - s_true[:keep]).max())
        act_worst = max(act_worst,
                        np.abs(th32 @ (vk @ vk.conj().T) - act_true).max())
    check(t_worst < TOL_T64, f"teig eigenvalues vs float64: {t_worst}")
    check(s_worst < TOL_S64 and act_worst < TOL_S64,
          f"kept singular values {s_worst} / action {act_worst} vs float64")
    print("kernels: all kernels agree with their plain versions on the card "
          f"(worst: env_chain rel {worst['env_chain']:.2e} < {TOL_ENV_REL}, "
          f"tridiag QTQ^H {worst['tridiag']:.2e} < {TOL_TRIDIAG_REL}, "
          f"factors {worst['tridiag_factors']:.2e} < {TOL_TRIDIAG_FACTORS}, "
          f"teig w "
          f"rel {worst['teig']:.2e} < {TOL_TEIG_W_REL}, z up to sign on rand "
          f"{worst['teig_z']:.2e} < {TOL_VEC}, z vs float64 ortho "
          f"{worst['teig_ortho']:.2e} < {TOL_ORTHO} resid "
          f"{worst['teig_resid']:.2e} < {TOL_RESID} cluster projector "
          f"{worst['teig_cluster']:.2e} < {TOL_VEC}, backtransform "
          f"{worst['backtransform']:.2e} < {TOL_BT}; chain vs float64: w "
          f"{worst['chain_w']:.2e} < {TOL_CHAIN_W}, ortho {worst['ortho']:.2e}"
          f" < {TOL_ORTHO}, resid {worst['resid']:.2e} < {TOL_RESID}; "
          f"7-decade spectra vs float64: teig w {t_worst:.2e} < {TOL_T64}, "
          f"kept s {s_worst:.2e} and action {act_worst:.2e} < {TOL_S64})",
          flush=True)
    return rec


# ---------------------------------------------------------------- phase 3
def hazard_circuit(Circuit, n, layers, cx_sites=None):
    """The deep re-simulation's chain C: `layers` brickwork layers of
    random RY and RZ on every site, each CX on the sites of `cx_sites`
    alone where given (numpy seed 7)."""
    rng = np.random.default_rng(7)
    qc = Circuit(n)
    for layer in range(layers):
        for q in range(n):
            qc.ry(float(rng.uniform(-0.6, 0.6)), q)
            qc.rz(float(rng.uniform(-0.6, 0.6)), q)
        for q in range(layer % 2, n - 1, 2):
            if cx_sites is None or q in cx_sites:
                qc.cx(q, q + 1)
    return qc


def phase_hazard(torch, mps_core, Circuit, compile_tape, card, chi=64,
                 layers=8, native_chi=None, dtype=None, n=50, cx_sites=None):
    """(C^dag C)|0> at n (50 unless given) for a random two-qubit chain C of
    `layers` brickwork layers (each CX on the sites of `cx_sites` alone
    where given); |<0|psi>|^2 / <psi|psi> under both eigensolvers (at
    chi = 128 the wide variants of K2-K4, past 256 the reach kernels), the
    native one at native_chi (chi unless given), in `dtype` (complex64
    unless given)."""
    dtype = dtype or torch.complex64
    native_chi = native_chi or chi
    tape = compile_tape(hazard_circuit(Circuit, n, layers, cx_sites))
    n2q = int(np.sum(tape.kinds == 4))
    dev = torch.device("cuda")
    out = {}
    for eigh in ("kernels", "native"):
        t0 = time.perf_counter()
        st = mps_core.zero_mps(n, chi if eigh == "kernels" else native_chi,
                               dtype, dev)
        st = mps_core.apply_tape(st, tape.kinds, tape.q0, tape.q1,
                                 tape.angles, 1e-16, eigh=eigh)
        st = mps_core.apply_tape_adjoint(st, tape.kinds, tape.q0, tape.q1,
                                         tape.angles, 1e-16, eigh=eigh)
        cost = float(mps_core.global_cost_normalized(st))
        torch.cuda.synchronize()
        out[eigh] = (1.0 - cost, float(st.trunc), time.perf_counter() - t0)
    diff = abs(out["kernels"][0] - out["native"][0])
    print(f"hazard: n={n} chi={chi} {str(dtype)[6:]} {layers} layers, "
          f"{2 * n2q} two-qubit applies: overlap "
          f"kernels {out['kernels'][0]:.8f} native {out['native'][0]:.8f} "
          f"|diff| {diff:.2e} < {TOL_HAZARD}; discarded weight kernels "
          f"{out['kernels'][1]:.3e} native {out['native'][1]:.3e}"
          + (f" (native at chi={native_chi})" if native_chi != chi else "")
          + f"; wall "
          f"kernels {out['kernels'][2]:.2f} s native {out['native'][2]:.2f} s"
          f" on {card}", flush=True)
    check(diff < TOL_HAZARD, f"kernels vs native overlap differ by {diff}")
    check(out["kernels"][0] > 0.5, "deep re-simulation collapsed")


# ---------------------------------------------------------------- phase 4
def _compile(torch, port, n, max_layers, seed=1):
    from adaptaqc_tpu_torch.utils.ansatzes import identity_resolvable
    from adaptaqc_tpu_torch.utils.constants import (CMAP_LINEAR,
                                                    generate_coupling_map)
    from adaptaqc_tpu_torch.utils.targets import random_target
    dev = torch.device("cuda")
    qmps = random_target(seed, n=n, device=dev)
    config = port.AdaptConfig(method="general_gradient",
                              cost_improvement_num_layers=1000,
                              sufficient_cost=9.5e-3, max_layers=max_layers)
    backend = port.mps_backend_with_args(mps_truncation_threshold=1e-8,
                                         max_chi=32, device=dev)
    t0 = time.perf_counter()
    compiler = port.AdaptCompiler(
        qmps, backend=backend, adapt_config=config,
        coupling_map=generate_coupling_map(n, CMAP_LINEAR),
        custom_layer_2q_gate=identity_resolvable(),
        starting_circuit="tenpy_product_state")
    setup = time.perf_counter() - t0
    result = compiler.compile()
    torch.cuda.synchronize()
    return result, setup, time.perf_counter() - t0, qmps


def phase_slice(torch, port, counted, card):
    for fn in counted.values():
        fn.launches = 0
    result, setup, wall, _ = _compile(torch, port, 50, 4)
    launches = {k: fn.launches for k, fn in counted.items()}
    layers = len(result.qubit_pair_history)
    costs = ", ".join(f"{c:.6f}" for c in result.global_cost_history)
    ltimes = ", ".join(f"{t:.2f}" for t in result.layer_times)
    print(f"slice: n=50 chi=32 {layers} layers, per-layer cost [{costs}] "
          f"(last = verified final), per-layer wall s [{ltimes}], setup "
          f"{setup:.2f} s, total {wall:.2f} s, {result.cost_evaluations} cost "
          f"evaluations, phases "
          + json.dumps({k: round(v, 3) for k, v in
                        result.phase_timings.items()})
          + f", launches {json.dumps(launches)} on {card}", flush=True)
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the main path")
    check(np.isfinite(result.overlap) and 0.0 <= result.overlap <= 1.0 + 1e-6,
          f"slice overlap out of range: {result.overlap}")
    check(result.num_2q_gates > 0, "slice produced no two-qubit gates")

    result, setup, wall, qmps = _compile(torch, port, 10, 80)
    from adaptaqc_tpu_torch.backends import mps_core
    from adaptaqc_tpu_torch.circuits.operations import \
        make_quantum_only_circuit
    from adaptaqc_tpu_torch.circuits.tape import compile_tape
    from adaptaqc_tpu_torch.ops import cplx
    # independent check: re-simulate the returned circuit at chi = 32 on
    # the native eigensolver and overlap it with the target
    with cplx.verification_eigh():
        tape = compile_tape(make_quantum_only_circuit(result.circuit))
        st = mps_core.apply_tape(
            mps_core.zero_mps(10, 32, torch.complex64, "cuda"), tape.kinds,
            tape.q0, tape.q1, tape.angles, 1e-16)
        tgt = mps_core.from_qiskit_mps(qmps, 32, torch.complex64, "cuda")
        ov = mps_core.mps_dot(tgt, st)
        nrm = float(mps_core.mps_dot(st, st).real)
        check_ov = float(abs(complex(ov)) ** 2) / nrm
    print(f"slice: n=10 full compile: overlap {result.overlap:.6f} "
          f"(independent re-simulation {check_ov:.6f}) in "
          f"{len(result.qubit_pair_history)} layers, {wall:.2f} s, "
          f"{result.cost_evaluations} cost evaluations, "
          f"{result.num_2q_gates} two-qubit gates on {card}", flush=True)
    check(result.overlap > 0.99, f"n=10 compile overlap {result.overlap}")
    check(abs(check_ov - result.overlap) < 1e-3,
          f"n=10 independent overlap {check_ov} vs {result.overlap}")
    return launches


# ---------------------------------------------------------------- phase 5
def sweep_variants(ek, envk, chi, f64):
    """{kernel: the counted variant it launches in a sweep at bond
    dimension chi} (the Grams have m = 2 chi): the one of the code its
    wrapper runs there (K3 by its route, ek.wide_routes); the narrow
    variants have no counter of their own and are left out."""
    def pick(reach, wide):
        if reach:
            return "reach_f64" if f64 else "reach"
        return "f64" if f64 else "wide" if wide else None
    m = 2 * chi
    wide = f64 or m > ek.NARROW_MAX_M
    past = m > ek.REACH_M[f64]
    routes = ek.wide_routes(m, f64) if past else {}
    return {k: v for k, v in {
        "env_chain": pick(chi > envk.CLUSTER_MAX_CHI,
                          chi > envk.NARROW_MAX_CHI),
        "tridiag": pick(past, wide),
        "teig": pick(routes.get("teig") == "global", wide),
        "backtransform": pick(past, wide),
    }.items() if v}


def sweep_setup(torch, mps_core, sweeps, compile_tape, chi, dtype, n=50,
                window=12):
    """bench.py's sweep at bond dimension chi in `dtype`: (the ansatz's
    tape, the block length, the arguments of sweeps.sweep)."""
    from adaptaqc_tpu_torch.workloads.bench_sweep import bench_workload
    dev = torch.device("cuda")
    target, ansatz = bench_workload(n, window)
    tt = compile_tape(target)
    # past chi = 256 the target is applied at 256 and padded: its bond rank
    # stays far below that, so the state is the same, set up in seconds
    prefix = mps_core.pad_chi(mps_core.apply_tape(
        mps_core.zero_mps(n, min(chi, 256), dtype, dev), tt.kinds, tt.q0,
        tt.q1, tt.angles, 1e-16), chi)
    at = compile_tape(ansatz)
    engine = mps_core.sweep_engine(1e-16)
    ref = mps_core.zero_mps(n, chi, dtype, dev)
    bl = sweeps.default_block_len(at.padded_length, sweeps.state_nbytes(ref))
    return at, bl, (engine, bl, True, prefix, ref, at.kinds, at.q0, at.q1,
                    at.angles, at.trainable)


def phase_sweep(torch, mps_core, sweeps, Circuit, compile_tape, card,
                chi=64, ek=None, envk=None, dtype=None, reps=3):
    """bench.py's workload: a 3-layer random-entangling 50-qubit target at
    bond dimension chi (64: bench.py's) and a window of 12 dressed-CNOT
    layers, one Rotoselect sweep timed over `reps` sweeps after a warm-up
    (reps = 1: the one sweep, timed without one), in complex64 (or
    dtype);
    with ek and envk given, the launches of the timed sweeps are printed
    by variant, each kernel's counted variant at this chi and dtype
    (sweep_variants) must have launched, and they are returned."""
    n, window = 50, 12
    t_setup = time.perf_counter()
    dtype = dtype or torch.complex64
    at, bl, args = sweep_setup(torch, mps_core, sweeps, compile_tape, chi,
                               dtype, n, window)
    if reps > 1:
        _, syncs = count_syncs(torch, lambda: sweeps.sweep(*args))  # warm-up
    if ek is not None:
        reset_counts(ek, envk)
    t0 = time.perf_counter()
    if reps == 1:  # one sweep, timed and its syncs counted (no warm-up:
        # past chi = 256 the reach phase's checks have run every kernel)
        out, syncs = count_syncs(torch, lambda: sweeps.sweep(*args))
        _, _, cost, _, evals, ov2 = out
    for _ in range(reps if reps > 1 else 0):
        _, _, cost, _, evals, ov2 = sweeps.sweep(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    counts = None if ek is None else variant_counts(ek, envk)
    launched = ("" if ek is None else
                f", launches by variant in {reps} sweeps "
                f"{json.dumps(counts)}")
    tag = "" if dtype == torch.complex64 else " " + str(dtype)[6:]
    wall = time.perf_counter() - t_setup
    print(f"sweep: n={n} chi={chi}{tag} {window} layers "
          f"({int(at.trainable.sum())} probes, {int(np.sum(at.kinds == 4))} "
          f"CX, block {bl}): {ms:.2f} ms/sweep, {evals / (ms / 1e3):.1f} "
          f"evals/s, {syncs} host syncs/sweep, final |<0|psi>|^2 "
          f"{ov2:.3e}{launched} ({wall:.1f} s with the prefix and the "
          f"warm-up) on {card}", flush=True)
    if ek is not None:
        missing = {k: v for k, v in sweep_variants(
            ek, envk, chi, dtype == torch.complex128).items()
                   if counts[k][v] == 0}
        check(not missing, f"the chi={chi}{tag} sweep did not launch "
                           f"{missing}: {counts}")
    check(np.isfinite(cost) and np.isfinite(ms), "sweep produced no number")
    return counts


# ---------------------------------------------------------------- phase 6
def random_tape(n, depth, rng):
    """Tape arrays of `depth` random gates: every kind (CXR included), on
    random ordered pairs, so both qubit orders and non-adjacent pairs
    occur."""
    from adaptaqc_tpu_torch.circuits import gates as G
    from adaptaqc_tpu_torch.circuits.tape import CXR
    kinds = rng.choice(list(range(G.RX, G.N_KINDS)) + [CXR], size=depth)
    pairs = np.array([rng.choice(n, 2, replace=False) for _ in range(depth)])
    return (kinds.astype(np.int32), pairs[:, 0].astype(np.int32),
            pairs[:, 1].astype(np.int32), rng.uniform(-np.pi, np.pi, depth))


def _rel(out, ref):
    out, ref = out.cpu().to(ref.dtype), ref.cpu()
    return float((out - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


def sv_engine_check(torch, sv_core, dev, n):
    """One random circuit of every gate kind on `dev` in complex64 against
    the CPU in complex128: the state, <Z>, the probe's local overlap matrix
    and the RDMs of a linear map, each / max|reference|."""
    rng = np.random.default_rng(11)
    tape = random_tape(n, 300, rng)
    more = random_tape(n, 4, rng)
    v = rng.normal(size=2 ** n) + 1j * rng.normal(size=2 ** n)
    worst = {}
    states = {}
    for name, d, dt in (("card", dev, torch.complex64),
                        ("cpu", "cpu", torch.complex128)):
        st = sv_core.apply_tape(sv_core.state_from_vector(v, dt, d), *tape)
        states[name] = (st, sv_core.apply_tape(st, *more))
    (a, a2), (b, b2) = states["card"], states["cpu"]
    worst["state"] = _rel(a, b)
    worst["z"] = _rel(sv_core.z_expectations(a), sv_core.z_expectations(b))
    worst["local_overlap"] = max(
        _rel(sv_core.local_overlap_matrix(a2, a, q),
             sv_core.local_overlap_matrix(b2, b, q))
        for q in (0, 1, 4, 5, n // 2, n - 1))
    pairs = [(q, q + 1) for q in range(n - 1)]
    worst["rdms"] = _rel(sv_core.all_pair_rdms(a, pairs),
                         sv_core.all_pair_rdms(b, pairs))
    check(a.device.type == dev.type, "engine state left the card")
    for k, v in worst.items():
        check(v < TOL_SV_REL, f"sv engine {k} rel {v}")
    return worst


def sweep_op_model(tape, bl, is_two_qubit, t):
    """One sweep's gate applies and probes (optim/sweeps._sweep's passes:
    the checkpoints, each block's right states, the forward pass) priced
    at the per-qubit op times `t`: (counts, ms by op)."""
    kinds, q0 = list(tape.kinds), list(tape.q0)
    nb = len(kinds) // bl
    idx = (list(range(bl, len(kinds)))
           + [b * bl + j for b in range(nb) for j in range(1, bl)]
           + list(range(len(kinds))))
    live = [i for i in idx if kinds[i] != 0]
    two = [i for i in live if is_two_qubit(kinds[i])]
    one = [i for i in live if not is_two_qubit(kinds[i])]
    probes = [i for i in range(len(kinds)) if tape.trainable[i]]
    counts = {"apply_1q": len(one), "apply_2q": len(two),
              "probe": len(probes)}
    ms = {"apply_1q": sum(t["apply_1q"][q0[i]] for i in one),
          "apply_2q": sum(t["apply_2q_adjacent"][q0[i]] for i in two),
          "probe": sum(t["probe"][q0[i]] for i in probes)}
    return counts, ms


def sv_op_times(torch, sv_core, st, n, card):
    """Each statevector op of the sweep and the pair scoring at n qubits,
    on every qubit (CUDA events): ms, and GB/s against the bytes it must
    move (an apply reads and writes the state, a probe reads two states,
    an RDM and <Z> read one). Returns {op: {qubit: ms}}."""
    nbytes = st.numel() * st.element_size()
    u2 = torch.eye(2, dtype=st.dtype, device=st.device)
    u4 = torch.eye(4, dtype=st.dtype, device=st.device)
    t = {"apply_1q": {q: cuda_ms(lambda: sv_core.apply_u2(st, u2, q), 10,
                                 torch) for q in range(n)},
         "apply_2q_adjacent": {q: cuda_ms(
             lambda: sv_core.apply_u4(st, u4, q, q + 1), 10, torch)
             for q in range(n - 1)},
         "apply_2q_apart": {(a, b): cuda_ms(
             lambda: sv_core.apply_u4(st, u4, a, b), 5, torch)
             for a, b in ((0, 9), (3, n - 6), (n // 2, n // 2 + 3))},
         "probe": {q: cuda_ms(lambda: sv_core.local_overlap_matrix(st, st, q),
                              10, torch) for q in range(n)},
         "rdm2": {(a, b): cuda_ms(lambda: sv_core.rdm2(st, a, b), 5, torch)
                  for a, b in ((n // 2 - 1, n // 2), (3, n - 6), (0, n - 1))},
         "z_expectations": {0: cuda_ms(lambda: sv_core.z_expectations(st), 3,
                                       torch)}}
    moved = {"apply_1q": 2, "apply_2q_adjacent": 2, "apply_2q_apart": 2,
             "probe": 2, "rdm2": 1, "z_expectations": 1}
    parts = []
    for k, by_q in t.items():
        v = np.array(list(by_q.values()))
        gbs = moved[k] * nbytes / (v.mean() * 1e-3) / 1e9
        parts.append(f"{k} mean {v.mean():.4f} max {v.max():.4f} ms, "
                     f"{gbs:.0f} GB/s at the mean ({gbs / HBM_GBS:.2f} of "
                     "peak)")
    print(f"sv: ops at n={n} ({nbytes / 2**20:.0f} MiB state) over every "
          "qubit: " + "; ".join(parts) + f" on {card}", flush=True)
    return t


def phase_sv(torch, port, card, dev="cuda", n_engine=20, n=SV_N):
    """The statevector engine and the default compile path on the card.
    Returns the n-qubit target state (for the sampling phase)."""
    from adaptaqc_tpu_torch.backends import sv_core
    from adaptaqc_tpu_torch.circuits.circuit import Circuit
    from adaptaqc_tpu_torch.circuits.operations import \
        create_random_initial_state_circuit
    from adaptaqc_tpu_torch.circuits.tape import compile_tape
    from adaptaqc_tpu_torch.optim import sweeps
    dev = torch.device(dev)
    worst = sv_engine_check(torch, sv_core, dev, n_engine)
    print(f"sv: engine n={n_engine} card complex64 vs cpu complex128, 304 "
          "gates of every kind (both orders, non-adjacent pairs): "
          + ", ".join(f"{k} rel {v:.2e}" for k, v in worst.items())
          + f" < {TOL_SV_REL}", flush=True)

    # the sweep phase's workload at n qubits
    from adaptaqc_tpu_torch.workloads.bench_sweep import bench_workload
    target, ansatz = bench_workload(n, 12)
    tt, at = compile_tape(target), compile_tape(ansatz)
    prefix = sv_core.apply_tape(sv_core.zero_state(n, torch.complex64, dev),
                                tt.kinds, tt.q0, tt.q1, tt.angles)
    times = sv_op_times(torch, sv_core, prefix, n, card)
    ref = sv_core.zero_state(n, torch.complex64, dev)
    engine = sv_core.sweep_engine()
    bl = sweeps.default_block_len(at.padded_length, sweeps.state_nbytes(ref))
    args = (engine, bl, True, prefix, ref, at.kinds, at.q0, at.q1, at.angles,
            at.trainable)
    torch.cuda.reset_peak_memory_stats()
    _, syncs = count_syncs(torch, lambda: sweeps.sweep(*args))  # warm-up
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        _, _, cost, state, evals, ov2 = sweeps.sweep(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts, model = sweep_op_model(at, bl, sv_core.is_two_qubit, times)
    print(f"sv: sweep n={n} {at.length} entries padded to {at.padded_length}"
          f", block {bl}: {ms:.2f} ms/sweep, {evals / (ms / 1e3):.1f} evals/s"
          f", {syncs} host syncs/sweep, peak {peak:.2f} GiB, final "
          f"|<0|psi>|^2 {ov2:.3e}; op model "
          + " + ".join(f"{counts[k]} {k} {v:.1f} ms" for k, v in model.items())
          + f" = {sum(model.values()):.1f} ms on {card}", flush=True)
    check(np.isfinite(cost) and np.isfinite(ms), "sv sweep produced no number")
    check(state.device.type == dev.type, "sv sweep state left the card")
    del state, args

    # the default compile path at n qubits: ISL, full map, default layer
    config = port.AdaptConfig(max_layers=4)
    t0 = time.perf_counter()
    compiler = port.AdaptCompiler(target, backend=port.SVBackend(device=dev),
                                  adapt_config=config)
    result = compiler.compile()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(compiler._prefix_state().device.type == dev.type
          and compiler._current_state().device.type == dev.type,
          "sv slice cached state is not on the card")
    costs = ", ".join(f"{c:.6f}" for c in result.global_cost_history)
    ltimes = ", ".join(f"{x:.2f}" for x in result.layer_times)
    print(f"sv: slice n={n} ISL {len(compiler.coupling_map)} pairs, "
          f"{len(result.qubit_pair_history)} layers, pairs "
          f"{result.qubit_pair_history}, methods {result.method_history}, "
          f"per-layer cost [{costs}] (last = final), per-layer wall s "
          f"[{ltimes}], total {wall:.2f} s, {result.cost_evaluations} cost "
          f"evaluations, exact overlap {result.exact_overlap:.6e} vs "
          f"{result.overlap:.6e}, phases "
          + json.dumps({k: round(v, 3) for k, v in
                        result.phase_timings.items()}) + f" on {card}",
          flush=True)
    check(np.isfinite(result.overlap) and 0 <= result.overlap <= 1 + 1e-6,
          f"sv slice overlap {result.overlap}")
    check(abs(result.exact_overlap - result.overlap) < TOL_EXACT,
          "sv slice exact overlap disagrees")
    check(result.num_2q_gates > 0, "sv slice produced no two-qubit gates")
    del compiler

    for name, qc in (("README", readme_circuit(Circuit)),
                     ("random 4-qubit", create_random_initial_state_circuit(
                         4, seed=0))):
        t0 = time.perf_counter()
        # the README target takes the default path: no backend argument
        compiler = (port.AdaptCompiler(qc) if name == "README" else
                    port.AdaptCompiler(qc, backend=port.SVBackend(device=dev)))
        check(compiler.backend.device.type == dev.type,
              f"{name} compile's backend is not on the card")
        result = compiler.compile()
        wall = time.perf_counter() - t0
        print(f"sv: {name} full compile: overlap {result.overlap:.6f} exact "
              f"{result.exact_overlap:.6f} in {len(result.qubit_pair_history)}"
              f" layers, {wall:.2f} s, {result.num_2q_gates} two-qubit gates"
              f" on {card}", flush=True)
        check(result.overlap > 0.99, f"{name} compile overlap "
                                     f"{result.overlap}")
        check(abs(result.exact_overlap - result.overlap) < TOL_EXACT,
              f"{name} exact overlap {result.exact_overlap}")
    return prefix


def readme_circuit(Circuit):
    """examples/readme_example.py's target."""
    qc = Circuit(3)
    qc.rx(1.23, 0)
    qc.cx(0, 1)
    qc.ry(2.5, 1)
    qc.rx(-1.6, 2)
    qc.ccx(2, 1, 0)
    return qc


# ---------------------------------------------------------------- phase 7
def sampling_target(Circuit):
    """tests/test_adapt_compiler.py test_sampling_backend's target: the
    repo's random_circuit(2, 6, default_rng(13))."""
    rng = np.random.default_rng(13)
    qc = Circuit(2)
    for _ in range(6):
        kind = rng.choice(["rx", "ry", "rz", "cx", "h"])
        if kind == "cx":
            a, b = rng.choice(2, 2, replace=False)
            qc.cx(int(a), int(b))
        elif kind == "h":
            qc.h(int(rng.integers(2)))
        else:
            getattr(qc, kind)(float(rng.uniform(-np.pi, np.pi)),
                              int(rng.integers(2)))
    return qc


def phase_sampling(torch, port, target_state, card, dev="cuda"):
    from adaptaqc_tpu_torch.backends import sv_core
    from adaptaqc_tpu_torch.circuits.circuit import Circuit
    from adaptaqc_tpu_torch.circuits.operations import \
        make_quantum_only_circuit
    from adaptaqc_tpu_torch.compilers.approximate_compiler import \
        calculate_overlap_between_circuits
    dev = torch.device(dev)
    for name, qc, cfg, bound in (
            ("sampling case", sampling_target(Circuit),
             port.AdaptConfig(sufficient_cost=0.05, max_layers=10), 0.85),
            ("README", readme_circuit(Circuit), None, None)):
        backend = port.SamplingBackend(shots=4096, seed=0, device=dev)
        t0 = time.perf_counter()
        compiler = port.AdaptCompiler(qc, backend=backend, adapt_config=cfg)
        result = compiler.compile()
        wall = time.perf_counter() - t0
        check(compiler._current_state().device.type == dev.type,
              "sampling state is not on the card")
        exact = calculate_overlap_between_circuits(
            qc, make_quantum_only_circuit(result.circuit), device=dev)
        print(f"sampling: {name} compile, {backend.shots} shots a cost: "
              f"overlap {result.overlap:.4f}, exact {exact:.6f}"
              + (f" > {bound}" if bound else "")
              + f" in {len(result.qubit_pair_history)} layers, "
              f"{result.cost_evaluations} cost evaluations, {wall:.2f} s on "
              f"{card}", flush=True)
        check(np.isfinite(exact) and 0 <= exact <= 1 + 1e-6,
              f"{name} exact overlap {exact}")
        if bound:
            check(exact > bound, f"{name} exact overlap {exact} <= {bound}")

    n = sv_core.num_qubits(target_state)
    shots = 65536
    draws = [port.SamplingBackend(seed=0, device=dev).sample_state(
        target_state, shots, n) for _ in range(2)]
    check(draws[0] == draws[1], "the same seed gave different counts")
    keys = np.array([int(k, 2) for k in draws[0]], dtype=np.int64)
    cnts = np.array(list(draws[0].values()), dtype=np.float64)
    z_counts = np.array([np.sum(cnts * (1 - 2 * ((keys >> q) & 1)))
                         for q in range(n)]) / shots
    z_exact = sv_core.z_expectations(target_state).cpu().numpy()
    err = float(np.abs(z_counts - z_exact).max())
    sampler = port.SamplingBackend(seed=1, device=dev)
    sampler.sample_state(target_state, 8192, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        sampler.sample_state(target_state, 8192, n)
    draw_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"sampling: n={n} {shots} draws: max |<Z>_counts - <Z>_exact| "
          f"{err:.4f} < {5 / np.sqrt(shots):.4f}, same seed repeats its "
          f"counts; {draw_ms:.2f} ms per 8192-shot draw on {card}",
          flush=True)
    check(err < 5 / np.sqrt(shots), f"sampled <Z> off by {err}")


# ---------------------------------------------------------------- phase 8
def phase_isl_mps(torch, port, counted, card, dev="cuda", n=50):
    """ISL on the MPS engine at the slice's n=50 target: its RDMs come from
    mps_core.all_pair_rdms, its sweeps run all four kernels."""
    from adaptaqc_tpu_torch.utils.constants import (CMAP_LINEAR,
                                                    generate_coupling_map)
    from adaptaqc_tpu_torch.utils.targets import random_target
    dev = torch.device(dev)
    qmps = random_target(1, n=n, device=dev)
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    compiler = port.AdaptCompiler(
        qmps, backend=port.MPSBackend(truncation_threshold=1e-8, max_chi=32,
                                      device=dev),
        adapt_config=port.AdaptConfig(max_layers=2),
        coupling_map=generate_coupling_map(n, CMAP_LINEAR))
    result = compiler.compile()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    print(f"isl_mps: n={n} chi=32 ISL, pairs {result.qubit_pair_history}, "
          f"methods {result.method_history}, per-layer cost "
          f"[{', '.join(f'{c:.6f}' for c in result.global_cost_history)}] "
          f"(last = verified final), {wall:.2f} s, phases "
          + json.dumps({k: round(v, 3) for k, v in
                        result.phase_timings.items()})
          + f", launches {json.dumps(launches)} on {card}", flush=True)
    check("ISL" in result.method_history, "isl_mps never picked by ISL")
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched by ISL on MPSBackend")
    check(np.isfinite(result.overlap), "isl_mps overlap is not finite")
    return launches


# ---------------------------------------------------------------- phase 9
SPIN = dict(steps=3, dt=0.25, delta=1.5, h=1.0)  # benchmarks/spin_chain.py


def spin_compiler(port, n, dev, max_layers, polish_frequency=10, steps=None,
                  local=True, backend=None, chi=32, sufficient=1e-2):
    """benchmarks/spin_chain.py's compiler: XXZ first-order Trotter from the
    Neel state, brickwall, identity_resolvable layers, linear map, the Neel
    preparation as the starting circuit, mps_backend_with_args(1e-8,
    max_chi=32), sufficient_cost 1e-2, local window 16. Returns (compiler,
    target)."""
    from adaptaqc_tpu_torch.circuits import operations as co
    from adaptaqc_tpu_torch.utils.ansatzes import identity_resolvable
    from adaptaqc_tpu_torch.utils.constants import (CMAP_LINEAR,
                                                    generate_coupling_map)
    from adaptaqc_tpu_torch.utils.targets import (neel_circuit,
                                                  trotter_circuit)
    prep = neel_circuit(n)
    target = prep.copy()
    co.add_to_circuit(target, trotter_circuit(
        n, steps or SPIN["steps"], SPIN["dt"], delta=SPIN["delta"],
        h=SPIN["h"]))
    config = port.AdaptConfig(
        method="brickwall", cost_improvement_num_layers=1000,
        sufficient_cost=sufficient, max_layers=max_layers,
        local_window_layers=16, global_polish_frequency=polish_frequency)
    if backend is None:
        backend = port.mps_backend_with_args(mps_truncation_threshold=1e-8,
                                             max_chi=chi, device=dev)
    compiler = port.AdaptCompiler(
        target, backend=backend, adapt_config=config,
        coupling_map=generate_coupling_map(n, CMAP_LINEAR),
        custom_layer_2q_gate=identity_resolvable(), starting_circuit=prep,
        optimise_local_cost=local)
    return compiler, target


def spin_probe_inputs(torch, port, ek, dev="cuda", n=50):
    """What K2-K4 are given by the first layer of the spin-chain compile
    (its Rotoselect: batches of 7 probe states)."""
    compiler, _ = spin_compiler(port, n, torch.device(dev), 1)
    return record_eigh_inputs(torch, ek, compiler.compile)


def center_engine_inputs(torch, ek, dev="cuda", n=50, chi=32):
    """What K2-K4 are given by the center-gauge engine on one Trotter step
    at n=50, chi=32; also that state under eigh="kernels" against
    eigh="native" (overlap to TOL_HAZARD)."""
    from adaptaqc_tpu_torch.backends import center_mps
    from adaptaqc_tpu_torch.circuits import operations as co
    from adaptaqc_tpu_torch.circuits.tape import compile_tape
    from adaptaqc_tpu_torch.utils.targets import (neel_circuit,
                                                  trotter_circuit)
    qc = neel_circuit(n)
    co.add_to_circuit(qc, trotter_circuit(n, 1, SPIN["dt"],
                                          delta=SPIN["delta"], h=SPIN["h"]))
    tape = compile_tape(qc)
    states = {}

    def run(eigh):
        states[eigh] = center_mps.apply_tape(
            center_mps.zero_cmps(n, chi, torch.complex64, dev),
            tape.kinds, tape.q0, tape.q1, tape.angles, 1e-8, eigh=eigh)
    inputs = record_eigh_inputs(torch, ek, lambda: run("kernels"))
    run("native")
    a, b = states["kernels"], states["native"]
    ov = abs(complex(center_mps.cmps_dot(a, b))) ** 2 / (
        float(center_mps.norm_sq(a)) * float(center_mps.norm_sq(b)))
    check(abs(ov - 1.0) < TOL_HAZARD,
          f"center engine under kernels vs native: overlap {ov}")
    return inputs


def full_cost_workload(torch, mps_core, layers=16, dev="cuda", n=50,
                       chi=32):
    """The arguments of sweeps.sweep_full_chunked_until_converged for one
    full-cost Rotosolve cycle (P = 3) at the spin-chain compile's size over
    a full local window: `layers` identity_resolvable blocks (small random
    angles from a seed) on brickwall pairs behind the n-qubit target at
    bond dimension chi, then the Neel preparation's inverse. Returns
    (args, probed gates, tape entries)."""
    from adaptaqc_tpu_torch.circuits import operations as co
    from adaptaqc_tpu_torch.circuits.circuit import Circuit
    from adaptaqc_tpu_torch.circuits.tape import compile_tape
    from adaptaqc_tpu_torch.utils.ansatzes import identity_resolvable
    from adaptaqc_tpu_torch.utils.targets import (neel_circuit,
                                                  trotter_circuit)
    dev = torch.device(dev)
    rng = np.random.default_rng(5)
    target = neel_circuit(n)
    co.add_to_circuit(target, trotter_circuit(n, SPIN["steps"], SPIN["dt"],
                                              delta=SPIN["delta"],
                                              h=SPIN["h"]))
    tt = compile_tape(target)
    prefix = mps_core.apply_tape(
        mps_core.zero_mps(n, chi, torch.complex64, dev), tt.kinds, tt.q0,
        tt.q1, tt.angles, 1e-8)
    window = Circuit(n)
    for layer in range(layers):
        block = identity_resolvable()
        for instr in block.data:
            if instr.params:
                instr.params = (float(rng.uniform(-0.3, 0.3)),)
        q = (2 * layer) % (n - 1)
        co.add_to_circuit(window, block, qubit_subset=[q, q + 1])
    n_train = len(window.data)
    co.add_to_circuit(window, neel_circuit(n).inverse())
    wt = compile_tape(window)
    mask = np.zeros(wt.padded_length, dtype=bool)
    mask[:n_train] = np.asarray(wt.trainable)[:n_train]
    engine = mps_core.sweep_engine(1e-8)
    ref = mps_core.zero_mps(n, chi, torch.complex64, dev)
    args = (engine, False, 1, prefix, ref, wt.kinds, wt.q0, wt.q1, wt.angles,
            mask, -np.inf, 1e-3, (0.0, 1.0, 0.0))
    return args, int(mask.sum()), wt.length


def full_cost_cycle(torch, port, mps_core, sweeps, ek, card, layers=16,
                    dev="cuda", n=50, chi=32):
    """One full-cost cycle on full_cost_workload: its wall, batched
    applies, launches and host syncs."""
    args, probed, entries = full_cost_workload(torch, mps_core, layers, dev,
                                               n, chi)
    counted = (ek.tridiag, ek.teig, ek.backtransform)
    for fn in counted:
        fn.launches = fn.batched_launches = 0
    for k in sweeps.full_sweep_counts:
        sweeps.full_sweep_counts[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, syncs = count_syncs(
        torch, lambda: sweeps.sweep_full_chunked_until_converged(*args))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = dict(sweeps.full_sweep_counts)
    launches = {fn.__name__: (fn.launches, fn.batched_launches)
                for fn in counted}
    print(f"spin: one full-cost Rotosolve cycle, n={n} chi={chi}, a window "
          f"of {layers} layers ({probed} probed gates of "
          f"{entries} tape entries): {wall:.2f} s, "
          f"{c['batched_applies']} batched applies "
          f"({c['batched_2q_applies']} two-qubit), launches (all, batched) "
          f"{json.dumps(launches)}, {syncs} host syncs, local cost "
          f"{out[6]:.6f} -> {out[2]:.6f} on {card}", flush=True)
    check(c["probed_gates"] == probed, "not every gate was probed")
    for name, (_, batched) in launches.items():
        check(batched == c["batched_2q_applies"],
              f"{name}: {batched} batched launches for "
              f"{c['batched_2q_applies']} batched two-qubit applies")
    check(np.isfinite(out[2]) and out[2] <= out[6] + 1e-4,
          f"the cycle raised the local cost: {out[6]} -> {out[2]}")
    # the tape's uploads (twice: the initial state's pass and the cycle),
    # the initial and the final cost, the tape's two read-backs: none a
    # probed gate or an apply
    check(syncs <= 10, f"{syncs} host syncs in one full-cost cycle")


def cut_polish(layers):
    """The polish frequency of the benchmark (10 layers), lowered until at
    least one polish falls inside a cut of `layers` layers."""
    polish = 10
    while polish >= layers and polish > 1:
        polish //= 2
    return polish


def phase_spin(torch, port, counted, card, max_layers=4, small_layers=8,
               dev="cuda", n=50, n_small=10):
    from adaptaqc_tpu_torch.backends import mps_core
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    from adaptaqc_tpu_torch.optim import sweeps
    from adaptaqc_tpu_torch.utils.targets import staggered_magnetisation
    from adaptaqc_tpu_torch.utils.verification import cross_engine_overlap
    dev = torch.device(dev)
    polish = cut_polish(max_layers)
    eigh = (ek.tridiag, ek.teig, ek.backtransform)
    for fn in counted.values():
        fn.launches = 0
    for fn in eigh:
        fn.batched_launches = 0
    for k in sweeps.full_sweep_counts:
        sweeps.full_sweep_counts[k] = 0
    t0 = time.perf_counter()
    compiler, target = spin_compiler(port, n, dev, max_layers, polish)
    setup = time.perf_counter() - t0
    result = compiler.compile()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    batched = {fn.__name__: fn.batched_launches for fn in eigh}
    c = dict(sweeps.full_sweep_counts)
    local = result.local_cost_history
    t1 = time.perf_counter()
    engine_ov = cross_engine_overlap(target, result.circuit, chi=64,
                                     device=dev)
    sm_sol = staggered_magnetisation(result.circuit, chi=64, device=dev)
    sm_raw = staggered_magnetisation(target, chi=64, device=dev)
    verify = time.perf_counter() - t1
    print(f"spin: n={n} chi=32 XXZ Trotter (3 steps, dt 0.25) from the Neel "
          f"state, brickwall, local cost, {len(local)} layers (cut), global "
          f"polish every {polish} layers (the benchmark's 10, lowered to "
          f"fit the cut): local cost ["
          + ", ".join(f"{x:.6f}" for x in local) + "], global cost ["
          + ", ".join(f"{x:.6f}" for x in result.global_cost_history)
          + f"], per-layer wall s ["
          + ", ".join(f"{x:.2f}" for x in result.layer_times)
          + f"], setup {setup:.2f} s, total {wall:.2f} s, phases "
          + json.dumps({k: round(v, 3) for k, v in
                        result.phase_timings.items()})
          + f", full-cost sweep {json.dumps(c)}, launches "
          f"{json.dumps(launches)} of which batched {json.dumps(batched)}; "
          f"overlap {result.overlap:.3e}, center-gauge engine at chi=64 "
          f"{engine_ov:.3e}; staggered magnetisation solution {sm_sol:.4f} "
          f"target {sm_raw:.4f} ({verify:.2f} s) on {card}", flush=True)
    check(c["calls"] > 0 and c["cycles"] > 0,
          "the local-cost compile never took the full-cost sweep")
    check(all(b <= a + 1e-6 for a, b in zip(local, local[1:])),
          f"the local cost rose from one layer to the next: {local}")
    check(result.phase_timings["global_polish"] > 0 and
          launches["env_chain"] > 0,
          "the global polish did not run through the env-chain kernel")
    for name, v in batched.items():
        check(v == c["batched_2q_applies"] and v > 0,
              f"{name}: {v} batched launches for {c['batched_2q_applies']} "
              "batched two-qubit applies")
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched by the spin compile")
    check(abs(engine_ov - result.overlap) < TOL_HAZARD,
          f"center-gauge overlap {engine_ov} vs the compile's "
          f"{result.overlap}")
    check(np.isfinite(sm_sol) and -1.0 <= sm_sol <= 1.0,
          f"staggered magnetisation {sm_sol}")

    full_cost_cycle(torch, port, mps_core, sweeps, ek, card, dev=dev, n=n)

    # the same compile at n=10 (2 Trotter steps) on both MPS engines, cut
    # to small_layers layers (the polish lowered as above) or stopped
    # sooner by the sufficient cost, and no clock: the headway check sees
    # the same layers on every host; its overlap against the center-gauge
    # verifier
    for name, backend in (
            ("MPSBackend", None),
            ("CenterMPSBackend", port.CenterMPSBackend(chi=32, cutoff=1e-8,
                                                       device=dev))):
        t0 = time.perf_counter()
        compiler, target = spin_compiler(port, n_small, dev, small_layers,
                                         cut_polish(small_layers), steps=2,
                                         backend=backend)
        result = compiler.compile()
        wall = time.perf_counter() - t0
        ov = cross_engine_overlap(target, result.circuit, chi=32, device=dev)
        loc = result.local_cost_history
        layers = len(result.qubit_pair_history)
        print(f"spin: n={n_small} (2 steps) local-cost compile on {name}: "
              f"{layers} layers, global polish every "
              f"{cut_polish(small_layers)} ("
              + ("stopped at the sufficient cost" if
                 result.global_cost_history[-2] < 1e-2 else
                 f"cut at {small_layers} layers" if layers >= small_layers
                 else "stopped by the compiler")
              + f"), local cost {loc[0]:.4f} -> {loc[-1]:.4f} (by layer ["
              + ", ".join(f"{x:.4f}" for x in loc) + "]), global cost "
              f"{result.global_cost_history[0]:.4f} -> "
              f"{result.global_cost_history[-1]:.4f}, "
              f"overlap {result.overlap:.6f} (center-gauge verifier "
              f"{ov:.6f}), {result.cost_evaluations} cost evaluations, "
              f"{wall:.2f} s on {card}", flush=True)
        check(compiler._current_state().device.type == dev.type,
              f"{name} state is not on the card")
        check(abs(ov - result.overlap) < TOL_HAZARD,
              f"{name} n=10: verifier {ov} vs {result.overlap}")
        check(all(b <= a + 1e-6 for a, b in zip(loc, loc[1:])) and
              loc[-1] < 0.75 * loc[0] and
              result.overlap > 1 - result.global_cost_history[0],
              f"{name} n=10 compile made no headway: local {loc}, overlap "
              f"{result.overlap}")
    return batched


# --------------------------------------------------------------- phase 10
def phase_ladder(torch, port, card, max_layers=2, dev="cuda", n=50):
    """Returns the wide variants' launches of the chi schedule."""
    import tempfile
    from adaptaqc_tpu_torch.io import checkpoint
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    from adaptaqc_tpu_torch.ops import env_kernel as envk
    from adaptaqc_tpu_torch.utils.targets import trotter_circuit
    from adaptaqc_tpu_torch.utils.verification import cross_engine_overlap
    dev = torch.device(dev)
    # compile_in_parts: one Trotter step a part (2 steps: two parts)
    compiler, _ = spin_compiler(port, n, dev, max_layers, steps=2,
                                local=False)
    depth = trotter_circuit(n, 1, SPIN["dt"], delta=SPIN["delta"],
                            h=SPIN["h"]).depth()
    fired = []
    t0 = time.perf_counter()
    parts = compiler.compile_in_parts(
        max_depth_per_block=depth,
        part_callback=lambda i, r, c: fired.append((i, r.overlap, len(c))))
    wall = time.perf_counter() - t0
    print(f"ladder: compile_in_parts n={n} chi=32, blocks of depth {depth} "
          f"(one Trotter step), {len(parts.individual_results)} parts of "
          f"{max_layers} layers (cut): part overlaps "
          f"{[f'{r.overlap:.3e}' for r in parts.individual_results]}, "
          f"callback fired for parts {[f[0] for f in fired]}, final overlap "
          f"{parts.overlap:.3e}, {wall:.2f} s on {card}", flush=True)
    check(len(parts.individual_results) >= 2, "the ladder had one part")
    check([f[0] for f in fired] == list(range(len(fired))) and
          len(fired) == len(parts.individual_results),
          "part_callback did not fire for every part")
    check(np.isfinite(parts.overlap) and 0 <= parts.overlap <= 1 + 1e-6,
          f"ladder overlap {parts.overlap}")

    # the README's compile_with_chi_schedule(chis=(32, 64, 128)) on the
    # 3-step target: stage 3 runs K1 at chi=128 and K2-K4 at m=256, all in
    # their wide variants, and no complex64 call leaves the kernels
    compiler, target = spin_compiler(port, n, dev, max_layers, local=False)
    stage_walls = []  # (chi, s) of each stage's compile()
    compile_once = port.AdaptCompiler.compile

    def timed_compile(self, *args, **kw):
        t = time.perf_counter()
        try:
            return compile_once(self, *args, **kw)
        finally:
            torch.cuda.synchronize()
            stage_walls.append((self.backend.max_chi,
                                round(time.perf_counter() - t, 2)))
    reset_counts(ek, envk)
    port.AdaptCompiler.compile = timed_compile
    t0 = time.perf_counter()
    try:
        result = compiler.compile_with_chi_schedule(chis=(32, 64, 128))
    finally:
        port.AdaptCompiler.compile = compile_once
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wide = wide_counts(ek, envk)
    launches = {fn.__name__: fn.launches for fn in (
        envk.env_chain, ek.tridiag, ek.teig, ek.backtransform)}
    t1 = time.perf_counter()
    verifier = cross_engine_overlap(target, result.circuit, chi=128,
                                    device=dev)
    ver_rel = abs(verifier - result.overlap) / max(abs(verifier),
                                                   abs(result.overlap))
    verify = time.perf_counter() - t1
    print(f"ladder: compile_with_chi_schedule(chis=(32, 64, 128)) n={n}, "
          f"{max_layers} layers a stage (cut): chi_schedule "
          f"{[(c, f'{o:.3e}') for c, o in result.chi_schedule]}, "
          f"independent overlap at chi=128 "
          f"{result.independent_overlap:.3e}, center-gauge verifier at "
          f"chi=128 {verifier:.6e} vs the compile's {result.overlap:.6e}, "
          f"relative difference {ver_rel:.2e} < {TOL_LADDER_REL} "
          f"({verify:.2f} s), "
          f"{result.cost_evaluations} cost evaluations, {wall:.2f} s "
          f"(stages (chi, s) {stage_walls}), "
          f"launches {json.dumps(launches)} of which the wide variants "
          f"{json.dumps(wide)} on {card}", flush=True)
    check([c for c, _ in result.chi_schedule] == [32, 64, 128],
          f"chi schedule stages {result.chi_schedule}")
    check(np.isfinite(result.independent_overlap),
          "no independent overlap on the schedule's result")
    # relative: the cut schedule's overlaps are of order 1e-7
    check(ver_rel < TOL_LADDER_REL,
          f"chi schedule: verifier {verifier} vs {result.overlap}")
    for k, v in wide.items():
        check(v > 0, f"the chi=128 stage launched no {k} wide variant")

    # a checkpoint written mid-compile on the card, loaded, resumed
    straight, _ = spin_compiler(port, n, dev, 3, local=False)
    want = straight.compile()
    with tempfile.TemporaryDirectory() as d:
        writer, _ = spin_compiler(port, n, dev, 3, local=False)
        writer.compile(checkpoint_every=1, checkpoint_dir=d)
        on_cpu = checkpoint.load(f"{d}/1.pkl", device="cpu")
        check(on_cpu.backend.device.type == "cpu" and
              on_cpu.full_circuit.data[0].payload.device.type == "cpu",
              "the checkpoint did not load onto the CPU")
        resumed = checkpoint.load(f"{d}/1.pkl")
    check(resumed.resume_from_layer == 2 and
          resumed.backend.device.type == dev.type and
          resumed.full_circuit.data[0].payload.device.type == dev.type,
          "the checkpoint did not come back to the card")
    got = resumed.compile()
    diff = max(abs(a - b) for a, b in zip(got.global_cost_history,
                                          want.global_cost_history))
    print(f"ladder: checkpoint at layer 1 of 3 on the card, loaded on the "
          f"CPU and back on the card, resumed: pairs "
          f"{got.qubit_pair_history} (straight run "
          f"{want.qubit_pair_history}), max cost difference {diff:.2e} on "
          f"{card}", flush=True)
    check(got.qubit_pair_history == want.qubit_pair_history,
          "the resumed run's pair history differs from the straight run's")
    check(diff < 1e-3, f"resumed costs differ by {diff}")
    return wide


# --------------------------------------------------------------- phase 11
REACH_Q = (0, 1, 25, 48, 49)
REACH_CHI = (129, 192, 256, 512, 768, 1024, 8192)  # the streamed K1, c64
REACH_CHI_F64 = (192, 256, 512, 1024, 8192)        # and in complex128
# the largest chi at n = 4 (a complex128 site stack at chi 8192 is 2.1 GB a
# site), its q in the middle and at both ends; chi = 8192, the cap,
# replaced 4096 (n = 24), the same streamed route
REACH_N_TOP = 4
REACH_Q_TOP = (0, 2, 3)
REACH_M = (561, 1024, 2048, 16384)     # K2-K4 past 560, complex64
REACH_M_F64 = (512, 1024, 2048, 16384)  # past 504 in complex128
# (m = 16384: the cap, K4 on its strip route in both dtypes, K2 in
# complex128 with each CTA's column in its workspace, K3 in complex128 on
# every stage's global-memory route; it replaced 8192 (and 8192 4096), the
# same K2 and K3 routes in complex64, and its plain K2 and K3, Python
# loops, give way to the float64 yardstick and K2's probe residual:
# reach_eigh_top. For the run's time, complex64 768 and 1536 and
# complex128 505 went: the routes of 1024 and 2048, and of 512, which the
# chi = 256 sweeps launch; and at 2048 the "lowrank" class, which the
# batches of 3 below it hold)
# K3 alone in complex128 on both sides of where its inverse iteration's d,
# e and w leave one CTA's shared memory (m = 8,488): (m, the stages read
# from global memory); at 16384 every stage reads from global memory
REACH_TEIG_FIT = ((8448, ()), (8576, ("invit",)))
# at the top m, K4 against its plain version on this many columns of z
# (its plain time there is for these columns)
REACH_BT_PLAIN_COLS = 64
# the sizes whose batch of 3 is held against its P = 1 launches (at 2048
# the plain versions of three matrices took 14 s a dtype; the same routes
# and plans run at 1024)
REACH_BATCH_MAX_M = 1024
# K4 alone at sizes whose plan no other reach m takes (synthetic
# reflectors): complex128 m = 4096, the strip route in strips of 16
# columns, and complex64 m = 3072, the strip route's crossover
REACH_BT_ONLY = ((4096, True), (3072, False))
REACH_VARIANTS = ("reach", "reach_f64")
# (chi, complex128, timed sweeps): bench.py's sweep at each chi; past chi =
# 256 one sweep, timed without a warm-up, to keep the run's time
REACH_SWEEPS = ((256, False, 3), (256, True, 3), (512, False, 1),
                (512, True, 1), (1024, False, 1), (1024, True, 1))
# (chi, layers, chi of the native run, complex128, n, CX sites) of the
# re-simulation: the native verifier at the kernels' chi (at chi = 1024
# its Grams, m = 2048, have 2044 exactly zero rows, which
# cplx.split_zero_rows takes off before cuSOLVER's eigh: without, it fails
# to converge on 10 of 98); chi = 4096, m = 8192, is the reach's cap in
# both dtypes (it replaced 2048), at n = 24, one layer whose CX sit on
# sites 10-13 (four two-qubit applies each way: a state is 12.9 GB in
# complex128 and a K2-K4 chain at m = 8192 a few seconds), the native side
# at chi = 1024, far above that layer's bonds (chi = 256 two layers and
# 1024 one at n = 50, every site)
REACH_HAZARD = ((256, 2, 256, False, 50, None),
                (1024, 1, 1024, False, 50, None),
                (4096, 1, 1024, False, 24, (10, 12)),
                (4096, 1, 1024, True, 24, (10, 12)))
# the sweep whose peak device memory is printed: chi = 4096 at n = 23 (the
# padded state is what a sweep at this chi holds; the true bonds of n = 23
# stop at 2048), both dtypes, a short tape around the middle bond (its
# K2-K4 at m = 8192, K4 on its strip route)
REACH_PEAK = dict(n=23, chi=4096)
# a compile whose verified stop re-simulates at chi = 1024: working chi 512,
# n >= 21 (2 ** ((n + 1) // 2) >= 1024), at most 2 layers
VERIFIED_STOP = dict(n=21, chi=512, max_layers=2)


def reach_rows(ek, envk):
    """The (kernel, variant) pairs of code that only sizes past the old
    caps run and that the reach phase's sweeps launch (sweep_variants at
    REACH_SWEEPS): the streamed K1, K2 and K4 past REACH_M in both dtypes,
    and K3's global-memory route where the plan takes it."""
    rows = set()
    for chi, f64, _ in REACH_SWEEPS:
        for k, v in sweep_variants(ek, envk, chi, f64).items():
            if v in REACH_VARIANTS:
                rows.add((k, v))
    return [(k, v) for k in KERNELS for v in REACH_VARIANTS
            if (k, v) in rows]
STREAM_SOURCE = "adaptaqc_tpu_torch/csrc/env_chain_stream.cu"
ENV_WIDE_SOURCE = "adaptaqc_tpu_torch/csrc/env_chain_wide.cu"
BT_WIDE_SOURCE = "adaptaqc_tpu_torch/csrc/backtransform_wide.cu"
BT_STRIP_SOURCE = "adaptaqc_tpu_torch/csrc/backtransform_strip.cu"
TRIDIAG_GRID_SOURCE = "adaptaqc_tpu_torch/csrc/tridiag_grid.cu"


def kernel_source(name, variant=None):
    """The source of a kernel row: K1 past chi = 128 is the streamed
    kernel, its complex64 wide variant its own source; K2 past REACH_M
    runs its card-wide route (every such m is past the cluster's shared
    memory); K4 past the narrow design (complex64 m > 128, every
    complex128 m) is the wide back-transform's own source."""
    if name == "env_chain" and variant in REACH_VARIANTS:
        return STREAM_SOURCE
    if name == "env_chain" and variant == "wide":
        return ENV_WIDE_SOURCE
    if name == "tridiag" and variant in REACH_VARIANTS:
        return TRIDIAG_GRID_SOURCE
    if name == "backtransform" and variant in ("wide", "f64") + REACH_VARIANTS:
        return BT_WIDE_SOURCE
    return KERNELS[name][0]


def stream_plan_check(envk, lib):
    """The streamed K1's plan mirror (env_kernel.stream_config,
    stream_slices, stream_work: what the wrapper sizes `work` by and the
    CPU tests check) against the library's own, at every chi of its reach
    and every launch of its host loop, in both dtypes."""
    import ctypes
    out = (ctypes.c_int * 2)()
    bad = []
    for chi in range(envk.CLUSTER_MAX_CHI + 1, max(REACH_CHI) + 1):
        for f64 in (False, True):
            if lib.env_chain_stream_work(chi, int(f64)) != envk.stream_work(
                    chi, f64):
                bad.append(("work", chi, f64))
            for products, np_ in envk.STREAM_LAUNCHES:
                rc = lib.env_chain_stream_plan(chi, int(f64), products, np_,
                                               out)
                if rc != 0 or (out[0], out[1]) != (
                        envk.stream_config(chi, f64),
                        envk.stream_slices(chi, f64, products, np_)):
                    bad.append((chi, f64, products, np_, tuple(out)))
    check(not bad, f"the streamed K1's plan mirror differs from the "
                   f"library's: {bad[:4]}")


def stream_step2_times(torch, envk, cuda_lib, br, f64, chi):
    """One step-2 product of the forward chain (sum_p A_p^H M_p, depth 2
    chi) through the streamed kernel's launches for it
    (env_chain_stream_step2: the product and, where the plan splits it,
    the reduction), against one torch.matmul of the same shape, (chi x 2
    chi) (2 chi x chi), A^H laid out beforehand: (kernel ms, matmul ms,
    max |difference| / max |matmul|), 20 calls each, CUDA events."""
    dt = br.dtype
    lib = cuda_lib.lib()
    g = torch.Generator(device="cpu").manual_seed(chi + 1)
    m = torch.randn((2, chi, chi), generator=g, dtype=dt).to(br.device)
    a = br[br.shape[0] // 2]
    out = torch.empty((chi, chi), dtype=dt, device=br.device)
    work = torch.empty(envk.stream_work(chi, f64), dtype=dt,
                       device=br.device)
    stream = cuda_lib.stream_of(br)

    def kernel():
        cuda_lib.check(lib.env_chain_stream_step2(
            a.data_ptr(), m.data_ptr(), out.data_ptr(), work.data_ptr(),
            work.numel(), chi, int(f64), stream), "env_chain_stream_step2")

    left = torch.cat([a[0].mH, a[1].mH], dim=1).contiguous()
    right = m.reshape(2 * chi, chi)
    kernel()
    ref = torch.matmul(left, right)
    err = float((out - ref).abs().max() / ref.abs().max())
    return (cuda_ms(kernel, 20, torch),
            cuda_ms(lambda: torch.matmul(left, right), 20, torch), err)


def reach_env_check(torch, envk, cuda_lib, card, dev, rec):
    """The streamed K1 (chi > 128) against env_chain_plain on the card, at
    n = 50 (at the largest chi, n = REACH_N_TOP): complex64 at REACH_CHI
    (TOL_ENV_REL), complex128 at REACH_CHI_F64 (TOL_F64_ENV), q in REACH_Q
    (REACH_Q_TOP at the largest chi); a rerun the same bits at chi = 256
    and 1024; at the middle site its time, the plain chain's (the chain of
    cuBLAS products, its library yardstick: 20 calls each, CUDA events)
    and the bound, and one step-2 product against one torch.matmul of its
    shape, at every chi (`by_chi`). First the plan mirror against the
    library's (stream_plan_check)."""
    t0 = time.perf_counter()
    stream_plan_check(envk, cuda_lib.lib())
    worst = {False: 0.0, True: 0.0}
    parts = {False: [], True: []}
    for chi in sorted(set(REACH_CHI) | set(REACH_CHI_F64)):
        top = chi == max(REACH_CHI)
        n = REACH_N_TOP if top else 50
        qmid = n // 2
        br64, bl64 = env_inputs(torch, n, chi, dev)
        for f64 in (False, True):
            if chi not in (REACH_CHI_F64 if f64 else REACH_CHI):
                continue
            dt = torch.complex128 if f64 else torch.complex64
            tol = TOL_F64_ENV if f64 else TOL_ENV_REL
            key = f"env_chain[{REACH_VARIANTS[f64]}]"
            br, bl = br64.to(dt), bl64.to(dt)
            for q in REACH_Q_TOP if top else REACH_Q:
                if top and q == qmid:  # the timed launches, checked here
                    c, ms = timed_ms(lambda: envk.env_chain(br, bl, q),
                                     torch)
                    cp, pms = timed_ms(
                        lambda: envk.env_chain_plain(br, bl, q), torch)
                else:
                    c = envk.env_chain(br, bl, q)
                    cp = envk.env_chain_plain(br, bl, q)
                err = float((c - cp).abs().max())
                rel = err / max(float(cp.abs().max()), 1e-300)
                worst[f64] = max(worst[f64], rel)
                check(rel < tol, f"streamed env_chain {dt} n={n} chi={chi} "
                                 f"q={q}: rel {rel}")
                if chi == 256 and q == 25:
                    rec[key]["max_abs_err"] = err
            if chi in (256, 1024):
                check(torch.equal(envk.env_chain(br, bl, 25),
                                  envk.env_chain(br, bl, 25)),
                      f"streamed env_chain {dt} chi={chi}: a rerun gave "
                      "other bits")
            if not top:  # (at the top chi: one launch each, above)
                reps = 5 if chi >= 512 else 20
                ms = cuda_ms(lambda: envk.env_chain(br, bl, qmid), reps,
                             torch)
                pms = cuda_ms(lambda: envk.env_chain_plain(br, bl, qmid),
                              reps, torch)
            sms, mms, serr = stream_step2_times(torch, envk, cuda_lib, br,
                                                f64, chi)
            check(serr < tol, f"streamed step 2 {dt} chi={chi}: rel {serr} "
                              "against torch.matmul")
            bound = bound_fields("env_chain", n=n, chi=chi, f64=f64)
            row = dict(n=n, q=qmid, ms=ms, plain_ms=pms, library_ms=pms,
                       step2_ms=sms, step2_matmul_ms=mms, **bound)
            rec[key].setdefault("by_chi", {})[chi] = row
            if chi == 256:
                rec[key].update(
                    ms=ms, plain_ms=pms, library_ms=pms,
                    library_call="env_chain_plain (the chain of cuBLAS "
                                 "products)",
                    shape="n=50, chi=256, q=25" + (", complex128" if f64
                                                   else ""), **bound)
            parts[f64].append(
                f"chi={chi} (n={n}, q={qmid}) {ms:.4f} ms plain (cuBLAS "
                f"chain) {pms:.4f} ms bound {bound['bound_ms']:.4f} ms "
                f"({bound['bound_by']}), step 2 {sms:.4f} ms against "
                f"torch.matmul {mms:.4f} ms")
            del br, bl
        del br64, bl64
        torch.cuda.empty_cache()
    for f64 in (False, True):
        print(f"reach: env_chain streamed "
              f"{'complex128' if f64 else 'complex64'} against plain over "
              f"chi {REACH_CHI_F64 if f64 else REACH_CHI} and q {REACH_Q} "
              f"at n=50 (at chi {max(REACH_CHI)}: n={REACH_N_TOP}, q "
              f"{REACH_Q_TOP}): worst rel {worst[f64]:.2e} < "
              f"{TOL_F64_ENV if f64 else TOL_ENV_REL}, reruns bit for bit, "
              f"plan as the library's; " + "; ".join(parts[f64])
              + f" ({time.perf_counter() - t0:.1f} s of checks) on {card}",
              flush=True)


def reach_eigh_check(torch, ek, card, dev, rec):
    """K2-K4 past 560 (complex64: REACH_M) and 504 (complex128:
    REACH_M_F64) against their plain versions on the card, on the "rand"
    and "lowrank" Grams (at the cap, m = 8192, reach_eigh_top): K2's own
    Q T Q^H = H and its exactly inactive steps, a rerun at m = 2048 bit for
    bit, its card-wide route's workspace as the mirror in eigh_kernels
    sizes it; K3 on the plain (d, e): w against the plain version's (bit for
    bit in complex128), z against float64:
    orthogonality, residual, degenerate-cluster projectors (z against the
    plain version is left to the class loop's m <= 512), and on its
    card-wide route at keep = m / 2 too (teig_keep_check, and on the
    batch teig_keep_batch); K4 on the plain
    reflectors; the whole chain against float64 eigenvalues; and a batch of 3
    ("rand", "lowrank", "bell") bit for bit against its P = 1 launches
    (below the cap). The
    tolerances of the class loop (complex64) and of f64_kernel_check
    (complex128). At every m: each kernel's time (20 launches), its plain
    version's (1 run), bound and library call, and the whole chain against
    torch.linalg.eigh(H)."""
    from adaptaqc_tpu_torch.ops import cuda_lib
    rng = np.random.default_rng(1024)
    for f64, sizes in ((False, REACH_M), (True, REACH_M_F64)):
        t_start = time.perf_counter()
        dt = torch.complex128 if f64 else torch.complex64
        sfx = f"[{REACH_VARIANTS[f64]}]"
        worst = {k: 0.0 for k in ("tridiag", "teig", "ortho", "resid",
                                  "cluster", "bt", "chain_w", "chain_ortho",
                                  "chain_resid")}
        tol = ({k: TOL_F64 for k in worst} if f64 else dict(
            tridiag=TOL_TRIDIAG_REL, teig=TOL_TEIG_W_REL, ortho=TOL_ORTHO,
            resid=TOL_RESID, bt=TOL_BT, chain_w=TOL_CHAIN_W,
            chain_ortho=TOL_ORTHO, chain_resid=TOL_RESID))
        tol["cluster"] = TOL_VEC
        lines = []
        for m in sizes:
            t_m = time.perf_counter()
            keep = m // 2
            top = m == max(sizes)  # the cap: "rand" alone, no batch
            bt_mirror_check(ek, cuda_lib, m, keep, f64)
            if ek.tridiag_routes(m, f64) == "grid":
                lib_ws = cuda_lib.lib().tridiag_grid_workspace(m, int(f64))
                check(lib_ws == ek.tridiag_grid_workspace_bytes(m, f64),
                      f"tridiag {dt} m={m}: the workspace mirror "
                      f"{ek.tridiag_grid_workspace_bytes(m, f64)} differs "
                      f"from the library's {lib_ws}")
            if top:
                err, plain = reach_eigh_top(torch, ek, dev, dt, m, keep)
                for k, val in err.items():
                    worst[k] = max(worst[k], val)
                bad = {k: v for k, v in err.items() if not v < tol[k]}
                check(not bad, f"eigensolver {dt} m={m} rand: {bad} "
                               f"(limits {tol})")
                lines.append(reach_eigh_times(torch, ek, rec, sfx, m, f64,
                                              plain)
                             + f" ({time.perf_counter() - t_m:.1f} s at this"
                               " m)")
                rec["backtransform" + sfx]["by_m"][m]["max_abs_err"] = err[
                    "bt"]
                del plain
                torch.cuda.empty_cache()
                continue
            cases = _gram_cases(m, rng, spec7=False)
            plain = {}  # "rand": the matrix, its plain factors and times
            for name in ("rand", "lowrank") if m < 2048 else ("rand",):
                t = torch.tensor(cases[name], dtype=dt, device=dev)
                h = t.mH @ t
                hh = ((h + h.mH) * 0.5).contiguous()
                v, tau, d, e = ek.tridiag(hh)
                t0 = time.perf_counter()
                vp, taup, dp, ep = ek.tridiag_plain(hh)
                torch.cuda.synchronize()
                t_tridiag = time.perf_counter() - t0
                err = {"tridiag": tridiag_residual(torch, ek, v, tau, d, e,
                                                   hh)}
                zeros_equal(e, tau, ep, taup, f"tridiag {dt} m={m} {name}")
                if m == 2048:
                    check(all(torch.equal(a, b) for a, b in zip(
                        (v, tau, d, e), ek.tridiag(hh))),
                          f"tridiag {dt} m={m} {name}: a rerun gave other "
                          "bits")
                w, z = ek.teig(dp, ep)
                t0 = time.perf_counter()
                wp, zp = ek.teig_plain(dp, ep)
                torch.cuda.synchronize()
                t_teig = time.perf_counter() - t0
                check(not f64 or torch.equal(w, wp),
                      f"teig {dt} m={m} {name}: w differs from the plain "
                      "version's")
                err["teig"] = float((w - wp).abs().max()) / max(
                    float(wp.abs().max()), 1e-300)
                tv = teig_vector_errors(dp, ep, w, z, zp)
                err.update(ortho=tv["ortho"], resid=tv["resid"],
                           cluster=tv["cluster"])
                if ek.wide_routes(m, f64)["teig"] == "global":
                    teig_keep_check(torch, ek, dp, ep, w, z, wp, keep,
                                    f"teig {dt} m={m} {name}")
                o = ek.backtransform(vp, taup, zp, keep)
                t0 = time.perf_counter()
                op = ek.backtransform_plain(vp, taup, zp, keep)
                torch.cuda.synchronize()
                t_bt = time.perf_counter() - t0
                err["bt"] = float((o - op).abs().max())
                if name == "rand":
                    plain = dict(
                        hh=hh, factors=(vp, taup, dp, ep, zp),
                        ms=dict(tridiag=t_tridiag * 1e3, teig=t_teig * 1e3,
                                backtransform=t_bt * 1e3))
                h64 = hh.to(torch.complex128)
                # the float64 yardstick: torch.linalg.eigvalsh in
                # complex128 on the card (numpy's on the host below m =
                # 1024; about a minute on the host at m = 4096)
                wx = (torch.linalg.eigvalsh(h64).cpu().numpy() if m >= 1024
                      else np.linalg.eigvalsh(h64.cpu().numpy()))[::-1][:keep]
                sc = max(np.abs(wx).max(), 1e-300)
                wk, vk = ek.eigh_top_kernels(hh, keep)
                vk64 = vk.to(torch.complex128)
                eye = torch.eye(keep, dtype=torch.complex128, device=dev)
                resid = torch.linalg.vector_norm(
                    h64 @ vk64[:, :4] - vk64[:, :4] * wk[:4].double(), dim=0)
                err.update(
                    chain_w=np.abs(wk.cpu().numpy().astype(float) - wx).max()
                    / sc,
                    chain_ortho=float((vk64.mH @ vk64 - eye).abs().max()),
                    chain_resid=float(resid.max()) / sc)
                for k, val in err.items():
                    worst[k] = max(worst[k], val)
                bad = {k: v for k, v in err.items() if not v < tol[k]}
                check(not bad, f"eigensolver {dt} m={m} {name}: {bad} "
                               f"(limits {tol})")
            if m <= REACH_BATCH_MAX_M:
                _, _, db, eb, _, _, _ = batch_against_singles(
                    torch, ek, torch.stack([
                        _sym_gram(torch, cases[k], dev).to(dt)
                        for k in ("rand", "lowrank", "bell")]),
                    keep, f"{dt} batched m={m} P=3", {})
                if ek.wide_routes(m, f64)["teig"] == "global":
                    teig_keep_batch(torch, ek, db, eb, keep,
                                    f"teig {dt} batched m={m} P=3")
            lines.append(reach_eigh_times(torch, ek, rec, sfx, m, f64,
                                          plain)
                         + f" ({time.perf_counter() - t_m:.1f} s at this m)")
        for k in ("tridiag", "teig", "backtransform"):
            rec[k + sfx]["max_abs_err"] = worst[
                {"tridiag": "tridiag", "teig": "teig", "backtransform": "bt"}[
                    k]]
        print(f"reach: K2-K4 {str(dt)[6:]} past their shared-memory sizes, m "
              f"{sizes}, agree with the plain versions (worst: "
              + ", ".join(f"{k} {v:.2e} < {tol[k]}" for k, v in worst.items())
              + f"; batches of 3 bit for bit to m = {REACH_BATCH_MAX_M}; "
              f"{time.perf_counter() - t_start:.1f} s of checks and times) on "
              f"{card}", flush=True)
        for line in lines:
            print(line, flush=True)


def _events(torch, fn):
    """(fn(), its milliseconds by CUDA events around the one call)."""
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    ev[0].record()
    out = fn()
    ev[1].record()
    torch.cuda.synchronize()
    return out, ev[0].elapsed_time(ev[1])


def reach_eigh_top(torch, ek, dev, dt, m, keep):
    """K2-K4 at the cap, m = 16384, on a "rand" Gram drawn on the card,
    where the plain K2 and K3 (Python loops) give way to the float64
    yardstick: K2's factors by a probe residual (Q x and Q T x for 8
    random real x through the plain K4: |H Q x - Q T x| / (max|H| max|x|),
    and |Q x| against |x|); K3 on K2's (d, e) at keep = m: w against
    torch.linalg.eigvalsh(H) in complex128 on the card, z orthonormal and
    its residual |T z - z w| / scale in float64 (no plain z, no cluster
    projector: scipy's vectors of T would take the host minutes), its keep
    = m / 2 launch the first columns of its keep = m one; K4 on K2's
    reflectors and K3's z against the plain version (one run, timed); the
    chain against the yardstick, assembled from these launches (the ones
    eigh_top_kernels makes). Each kernel's one launch here is its time
    (CUDA events; the chain's the sum of its three): at this m a K2 launch
    takes seconds.
    Returns (errors by name, the factors, the plain K4's output and times
    for reach_eigh_times)."""
    f64 = dt == torch.complex128
    g = torch.Generator(device=dev).manual_seed(m)
    t = torch.randn((m, m), generator=g, dtype=torch.complex128, device=dev)
    t = (t / torch.linalg.matrix_norm(t)).to(dt)
    hh = ((t.mH @ t + (t.mH @ t).mH) * 0.5).contiguous()
    del t
    (v, tau, d, e), tridiag_ms = _events(torch, lambda: ek.tridiag(hh))
    rdt = torch.float64 if f64 else torch.float32
    x = torch.randn((m, 8), generator=g, dtype=torch.float64, device=dev)
    v64, tau64 = v.to(torch.complex128), tau.to(torch.complex128)
    d64, e64 = d.double(), e[:-1].double()
    tx = d64[:, None] * x
    tx[:-1] += e64[:, None] * x[1:]
    tx[1:] += e64[:, None] * x[:-1]
    qx = ek.backtransform_plain(v64, tau64, x, 8)
    qtx = ek.backtransform_plain(v64, tau64, tx, 8)
    del v64, tau64
    h64 = hh.to(torch.complex128)
    hmax = float(h64.abs().max())
    err = {"tridiag": max(
        float((h64 @ qx - qtx).abs().max()) / (hmax * float(x.abs().max())),
        float((torch.linalg.vector_norm(qx, dim=0)
               - torch.linalg.vector_norm(x, dim=0)).abs().max()))}
    wx = torch.linalg.eigvalsh(h64).flip(0)
    del h64
    scale = max(float(wx.abs().max()), 1e-300)
    (w, z), teig_ms = _events(torch, lambda: ek.teig(d, e))
    err["teig"] = float((w.double() - wx).abs().max()) / scale
    z64 = z.double()
    eye = torch.eye(m, dtype=torch.float64, device=dev)
    err["ortho"] = float((z64.T @ z64 - eye).abs().max())
    del eye
    tz = d64[:, None] * z64
    tz[:-1] += e64[:, None] * z64[1:]
    tz[1:] += e64[:, None] * z64[:-1]
    err["resid"] = float(torch.linalg.vector_norm(
        tz - z64 * w.double(), dim=0).max()) / scale
    del tz, z64
    teig_keep_check(torch, ek, d, e, w, z, None, keep, f"teig {dt} m={m}")
    _, half_ms = _events(torch, lambda: ek.teig(d, e, keep))
    o, bt_ms = _events(torch, lambda: ek.backtransform(v, tau, z, keep))
    # the plain K4 on the first REACH_BT_PLAIN_COLS columns alone (a column
    # of K4 depends on its own column of z alone; all 8192 took the plain
    # loop 30-58 s)
    cols = min(keep, REACH_BT_PLAIN_COLS)
    t0 = time.perf_counter()
    op = ek.backtransform_plain(v, tau, z[:, :cols], cols)
    torch.cuda.synchronize()
    t_bt = time.perf_counter() - t0
    err["bt"] = float((o[:, :cols] - op).abs().max())
    # the chain eigh_top_kernels(hh, keep) launches K2 on hh (exactly
    # Hermitian: its symmetrised copy has the same bits), K3 at keep and K4:
    # these launches, K3 at keep the first columns of keep = m bit for bit
    # (teig_keep_check); its time is theirs (one K2 launch is seconds here)
    wk, vk = w[:keep], o
    chain_ms = tridiag_ms + half_ms + bt_ms
    vk64 = vk.to(torch.complex128)
    ek_ = torch.eye(keep, dtype=torch.complex128, device=dev)
    resid = torch.linalg.vector_norm(
        hh.to(torch.complex128) @ vk64[:, :4] - vk64[:, :4] * wk[:4].double(),
        dim=0)
    err.update(chain_w=float((wk.double() - wx[:keep]).abs().max()) / scale,
               chain_ortho=float((vk64.mH @ vk64 - ek_).abs().max()),
               chain_resid=float(resid.max()) / scale)
    del o, wk, vk, vk64, ek_
    return err, dict(hh=hh, factors=(v, tau, d, e, z), bt_plain=op,
                     ms=dict(tridiag=None, teig=None,
                             backtransform=t_bt * 1e3),
                     kernel_ms=dict(tridiag=tridiag_ms, teig=teig_ms,
                                    teig_half=half_ms, backtransform=bt_ms,
                                    chain=chain_ms))


def reach_teig_fit(torch, ek, dev, card, rec):
    """K3 alone in complex128 at REACH_TEIG_FIT, either side of where its
    inverse iteration's operands leave one CTA's shared memory: a random
    tridiagonal (d, e) drawn on the card; the plan's global-memory stages
    as expected; w against scipy's eigvalsh_tridiagonal in float64 (/
    scale), z orthonormal and its residual |T z - z w| / scale, keep = m / 2
    the first columns of keep = m bit for bit, a rerun the same bits, all
    to TOL_F64; its times at keep = m and m / 2 (CUDA events, one launch
    each after the checks' launches), the bound and torch.linalg.eigh of
    the dense float64 T, into rec["teig[reach_f64]"]["by_m"]."""
    from scipy.linalg import eigvalsh_tridiagonal
    lines = []
    for m, stages in REACH_TEIG_FIT:
        t0 = time.perf_counter()
        plan = ek.teig_grid_plan(m, True)
        check(plan["global"] == stages,
              f"teig c128 m={m}: global-memory stages {plan['global']}, "
              f"expected {stages}")
        g = torch.Generator(device=dev).manual_seed(m)
        d = torch.randn(m, generator=g, dtype=torch.float64, device=dev)
        e = torch.randn(m, generator=g, dtype=torch.float64, device=dev)
        e[-1] = 0.0
        dn, en = d.cpu().numpy(), e[:-1].cpu().numpy()
        wx = torch.tensor(eigvalsh_tridiagonal(dn, en)[::-1].copy(),
                          device=dev)
        scale = float(wx.abs().max())
        w, z = ek.teig(d, e)
        w2, z2 = ek.teig(d, e)
        check(torch.equal(w, w2) and torch.equal(z, z2),
              f"teig c128 m={m}: a rerun gave other bits")
        del w2, z2
        teig_keep_check(torch, ek, d, e, w, z, None, m // 2,
                        f"teig c128 m={m}")
        eye = torch.eye(m, dtype=torch.float64, device=dev)
        tz = d[:, None] * z
        tz[:-1] += e[:-1, None] * z[1:]
        tz[1:] += e[:-1, None] * z[:-1]
        err = dict(w=float((w - wx).abs().max()) / scale,
                   ortho=float((z.T @ z - eye).abs().max()),
                   resid=float(torch.linalg.vector_norm(
                       tz - z * w, dim=0).max()) / scale)
        del eye, tz
        bad = {k: v for k, v in err.items() if not v < TOL_F64}
        check(not bad, f"teig c128 m={m} against float64: {bad} "
                       f"(limit {TOL_F64})")
        ms = cuda_ms(lambda: ek.teig(d, e), 1, torch, warm=False)
        hms = cuda_ms(lambda: ek.teig(d, e, m // 2), 1, torch, warm=False)
        tdense = (torch.diag(d) + torch.diag(e[:-1], 1)
                  + torch.diag(e[:-1], -1))
        lms = cuda_ms(lambda: torch.linalg.eigh(tdense), 1, torch)
        bound = bound_fields("teig", m=m, keep=m, f64=True)
        hb = bound_fields("teig", m=m, keep=m // 2, f64=True)
        rec["teig[reach_f64]"].setdefault("by_m", {})[m] = dict(
            ms=ms, keep_half_ms=hms, library_ms=lms, plain_ms=None,
            keep_half_bound_ms=hb["bound_ms"], plan=plan, **bound)
        del z, tdense
        torch.cuda.empty_cache()
        lines.append(
            f"m={m} (global-memory stages {plan['global'] or 'none'}) "
            f"keep=m {ms:.4f} ms, keep=m/2 {hms:.4f} ms, bound "
            f"{bound['bound_ms']:.5f} / {hb['bound_ms']:.5f} ms "
            f"({bound['bound_by']}), torch.linalg.eigh(T) f64 {lms:.4f} ms;"
            f" w {err['w']:.2e}, ortho {err['ortho']:.2e}, resid "
            f"{err['resid']:.2e} ({time.perf_counter() - t0:.1f} s)")
    print(f"reach: K3 complex128 either side of its inverse iteration's "
          f"shared-memory fit (m = 8,488), against float64 (< {TOL_F64}), "
          f"reruns bit for bit: " + "; ".join(lines) + f" on {card}",
          flush=True)


def reach_peak_sweep(torch, mps_core, sweeps, Circuit, compile_tape, ek,
                     envk, card, n, chi):
    """One Rotoselect sweep at bond dimension chi (the cap, 4096) and n
    qubits in complex64 and complex128, on the engine bench.py's sweep
    uses: a short tape around the middle bond (two RY probes, one CX,
    whose applies run K2-K4 at m = 2 chi, K4 on its strip route; the
    probes run the streamed K1 at chi), prefix and reference the same |0>
    state. Its peak torch.cuda.max_memory_allocated, its wall, its
    launches and K4's device time (CUDA events around each call) are
    printed; every kernel must launch, every K4 launch on the strip route.
    Returns {dtype: (peak bytes, launches by kernel, strip-route launches,
    K4 ms)}."""
    dev = torch.device("cuda")
    mid = n // 2 - 1
    qc = Circuit(n)
    qc.ry(0.3, mid)
    qc.cx(mid, mid + 1)
    qc.ry(0.2, mid + 1)
    tape = compile_tape(qc)
    out = {}
    for dt in (torch.complex64, torch.complex128):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(ek, envk)
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        zero = mps_core.zero_mps(n, chi, dt, dev)
        engine = mps_core.sweep_engine(1e-16)
        bl = sweeps.default_block_len(tape.padded_length,
                                      sweeps.state_nbytes(zero))
        # K4's device time in the sweep: CUDA events around each call (the
        # wrapper counts on its module-level name, so the stand-in carries
        # the counters and hands them back)
        real, events = ek.backtransform, []

        def timed(*args, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out_ = real(*args, **kw)
            ev[1].record()
            events.append(ev)
            return out_
        for c in BT_COUNTERS:
            setattr(timed, c, getattr(real, c))
        ek.backtransform = timed
        try:
            kinds, _, cost, state, evals, _ = sweeps.sweep(
                engine, bl, True, zero, zero, tape.kinds, tape.q0, tape.q1,
                tape.angles, tape.trainable)
            torch.cuda.synchronize()
        finally:
            ek.backtransform = real
            for c in BT_COUNTERS:
                setattr(real, c, getattr(timed, c))
        wall = time.perf_counter() - t0
        k4_ms = sum(a.elapsed_time(b) for a, b in events)
        peak = torch.cuda.max_memory_allocated() - base
        launches = {fn.__name__: fn.launches for fn in (
            envk.env_chain, ek.tridiag, ek.teig, ek.backtransform)}
        strip = ek.backtransform.strip_launches
        state_gb = sweeps.state_nbytes(zero) / 1e9
        del zero, state
        print(f"reach: peak sweep n={n} chi={chi} {str(dt)[6:]}: peak "
              f"allocated {peak / 1e9:.3f} GB ({peak / state_gb / 1e9:.2f} "
              f"states of {state_gb:.3f} GB; card 80 GB), cost {cost:.6f}, "
              f"{evals} evaluations, kinds {kinds.tolist()[:3]}, {wall:.1f} "
              f"s, launches {json.dumps(launches)}, K4 strip route {strip} "
              f"({k4_ms:.4f} ms of device time, {100 * k4_ms / 1e3 / wall:.2f}"
              f"% of the sweep's wall) on {card}", flush=True)
        check(np.isfinite(cost) and -1e-6 <= cost <= 1.0 + 1e-6,
              f"peak sweep {dt}: cost {cost}")
        check(all(v > 0 for v in launches.values()),
              f"peak sweep {dt}: a kernel did not launch: {launches}")
        check(strip == launches["backtransform"] > 0,
              f"peak sweep {dt}: K4's strip route launched {strip} of "
              f"{launches['backtransform']} times")
        out[str(dt)[6:]] = (peak, launches, strip, k4_ms)
        torch.cuda.empty_cache()
    return out


def reach_bt_only(torch, ek, cuda_lib, rec, dev, m, f64, card):
    """K4 alone at m on synthetic unitary reflectors drawn on the card (v_k
    = e_{k+1} + 0.3 x below it, tau_k = 2 / |v_k|^2, a run of 20 inactive
    ones) and an orthonormal z, at keep = m / 2: against the plain version
    (TOL_BT, or TOL_F64 in complex128), its plan mirrors equal to the
    library's, a rerun the same bits, and on the strip route a batch of 3
    (the next two from the next seeds) bit for bit against its P = 1
    launches; its time (3 launches), the plain version's (one run), the
    bound and torch.ormqr, into rec["backtransform[...]"]["by_m"][m].
    Returns the line to print."""
    dt = torch.complex128 if f64 else torch.complex64
    rdt = torch.float64 if f64 else torch.float32
    keep = m // 2

    def draw(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        v = torch.triu(0.3 * torch.randn((m, m), generator=g, dtype=dt,
                                         device=dev), diagonal=2)
        idx = torch.arange(m - 1, device=dev)
        v[idx, idx + 1] = 1.0
        tau = torch.zeros(m, dtype=dt, device=dev)
        tau[:m - 1] = (2.0 / (v[:m - 1].abs() ** 2).sum(-1)).to(dt)
        tau[m // 3:m // 3 + 20] = 0
        z = torch.linalg.qr(torch.randn((m, m), generator=g, dtype=rdt,
                                        device=dev))[0].contiguous()
        return v, tau, z
    v, tau, z = draw(m + 1)
    bt_mirror_check(ek, cuda_lib, m, keep, f64)
    o = ek.backtransform(v, tau, z, keep)
    check(torch.equal(o, ek.backtransform(v, tau, z, keep)),
          f"backtransform {dt} m={m}: a rerun gave other bits")
    route = ek.backtransform_routes(m, f64)
    batch = ""
    if route == "strip":
        more = [draw(m + 2), draw(m + 3)]
        ob = ek.backtransform(*(torch.stack([a, *(x[i] for x in more)])
                                for i, a in enumerate((v, tau, z))), keep)
        singles = [o] + [ek.backtransform(*x, keep) for x in more]
        check(all(torch.equal(ob[i], singles[i]) for i in range(3)),
              f"backtransform {dt} m={m}: a batch of 3 differs from its "
              "P = 1 launches")
        batch = ", a batch of 3 bit for bit"
        del more, ob, singles
    t0 = time.perf_counter()
    op = ek.backtransform_plain(v, tau, z, keep)
    torch.cuda.synchronize()
    pms = (time.perf_counter() - t0) * 1e3
    err = float((o - op).abs().max())
    tol = TOL_F64 if f64 else TOL_BT
    check(err < tol, f"backtransform {dt} m={m} ({route} route) vs plain "
                     f"{err} (limit {tol})")
    oa, otau, _ = ormqr_inputs(torch, v, tau, z, keep)
    oz = z[1:, :keep].to(dt).contiguous()
    ms = cuda_ms(lambda: ek.backtransform(v, tau, z, keep), 3, torch)
    lms = cuda_ms(lambda: torch.ormqr(oa, otau, oz), 3, torch)
    bound = bound_fields("backtransform", m=m, keep=keep, f64=f64)
    plan = bt_plan_text(ek, m, keep, f64)
    rec[f"backtransform[{REACH_VARIANTS[f64]}]"].setdefault(
        "by_m", {})[m] = dict(ms=ms, plain_ms=pms, library_ms=lms,
                              max_abs_err=err, route=route, plan=plan,
                              inputs="synthetic reflectors", **bound)
    return (f"reach: backtransform alone {str(dt)[6:]} m={m} keep={keep} "
            f"({plan}) on synthetic reflectors: vs plain {err:.2e} < {tol}, "
            f"mirrors and rerun equal{batch}; kernel {ms:.4f} ms plain "
            f"{pms:.4f} ms bound {bound['bound_ms']:.5f} ms "
            f"({bound['bound_by']}) torch.ormqr {lms:.4f} ms on {card}")


def bt_plan_text(ek, m, keep, f64):
    """K4's wide plan at m, as the reach lines print it."""
    if ek.backtransform_routes(m, f64) == "strip":
        pl = ek.backtransform_strip_plan(m, f64)
        return (f"strip route: {-(-keep // pl['cols'])} strips of "
                f"{pl['cols']} columns, panels of {pl['nb']}, chunks of "
                f"{pl['rows']} rows")
    return (f"double route: clusters of "
            f"{ek.backtransform_cluster_size(m, keep, f64)} CTAs over 32 "
            "columns' rows, panels of 16")


def bt_mirror_check(ek, cuda_lib, m, keep, f64):
    """K4's plan at m as the mirrors in eigh_kernels make it, equal to the
    library's: the route; on the double route the workspace and the
    apply's shared memory on the plan's cluster, on the strip route the
    workspace, the working columns at keep, both launches' shared
    memory."""
    lib = cuda_lib.lib()
    route = ek.backtransform_routes(m, f64)
    check(lib.backtransform_route(m, int(f64)) == int(route == "strip"),
          f"backtransform m={m} f64={f64}: the library's route differs "
          f"from the mirror's {route}")
    if route == "strip":
        pl = ek.backtransform_strip_plan(m, f64)
        got = (lib.backtransform_strip_workspace(m, int(f64)),
               lib.backtransform_strip_zbuf(m, keep, int(f64)),
               lib.backtransform_strip_smem(m, int(f64)),
               lib.backtransform_strip_smem(0, int(f64)))
        want = (pl["workspace"], ek.backtransform_strip_zbuf_bytes(
            m, keep, f64), pl["smem"], pl["prep_smem"])
    else:
        g = ek.backtransform_cluster_size(m, keep, f64)
        got = (lib.backtransform_workspace(m, int(f64)),
               lib.backtransform_apply_smem(m, g, int(f64)))
        want = (ek.backtransform_workspace_bytes(m, f64),
                ek.backtransform_apply_smem(m, g, f64))
    check(got == want, f"backtransform m={m} f64={f64} ({route} route): "
          f"workspace and shared memory {got} from the library, {want} from "
          "the mirror")


def teig_keep_check(torch, ek, d, e, w, z, wp, keep, what):
    """K3's card-wide route at `keep` (its first keep eigenpairs only) on
    one matrix: equal to the first keep of its keep = m launch (w, z),
    bit for bit; w against the plain version's wp where given (bit for bit
    in complex128, TOL_TEIG_W_REL of the scale in complex64); z
    orthonormal to
    TOL_ORTHO (complex64) or TOL_F64 (complex128), measured in float64."""
    wk, zk = ek.teig(d, e, keep)
    check(torch.equal(wk, w[:keep]) and torch.equal(zk, z[:, :keep]),
          f"{what}: keep={keep} differs from the first columns of keep=m")
    f64 = d.dtype == torch.float64
    if wp is not None:  # (none at the cap: reach_eigh_top)
        check(not f64 or torch.equal(wk, wp[:keep]),
              f"{what}: keep={keep} w differs from the plain version's")
        rel = float((wk - wp[:keep]).abs().max()) / max(
            float(wp.abs().max()), 1e-300)
        check(rel < TOL_TEIG_W_REL, f"{what}: keep={keep} w rel {rel}")
    z64 = zk.double()
    eye = torch.eye(keep, dtype=torch.float64, device=z64.device)
    ortho = float((z64.T @ z64 - eye).abs().max())
    check(ortho < (TOL_F64 if f64 else TOL_ORTHO),
          f"{what}: keep={keep} ortho {ortho}")


def teig_keep_batch(torch, ek, d, e, keep, what):
    """K3 at `keep` on a batch (P, m): every matrix bit for bit its P = 1
    launch, and the first keep of the batch's keep = m launch."""
    wb, zb = ek.teig(d, e, keep)
    wf, zf = ek.teig(d, e)
    for i in range(d.shape[0]):
        w1, z1 = ek.teig(d[i], e[i], keep)
        check(torch.equal(wb[i], w1) and torch.equal(zb[i], z1),
              f"{what}: keep={keep}: matrix {i} of the batch differs from "
              "its P = 1 launch")
        check(torch.equal(wb[i], wf[i, :keep])
              and torch.equal(zb[i], zf[i, :, :keep]),
              f"{what}: keep={keep}: matrix {i} differs from the first "
              "columns of keep=m")


def reach_eigh_times(torch, ek, rec, sfx, m, f64, plain):
    """The kernels' times at m on the check's "rand" Gram (`plain`: the
    matrix, its plain factors (at the cap the kernels' own) and the plain
    versions' times, one run each on the host clock around a synchronise,
    None where not run), with the bounds, the library
    calls, the whole K2-K4 chain and torch.linalg.eigh(H), into
    rec[<kernel><sfx>]["by_m"][m]; returns the line to print."""
    dt = torch.complex128 if f64 else torch.complex64
    hh = plain["hh"]
    vp, taup, dp, ep, zp = plain["factors"]
    keep = m // 2
    tdense = (torch.diag(dp) + torch.diag(ep[:-1], 1)
              + torch.diag(ep[:-1], -1)).contiguous()
    oa, otau, _ = ormqr_inputs(torch, vp, taup, zp, keep)
    oz = zp[1:, :keep].to(dt).contiguous()
    bt_plain = plain.get("bt_plain")  # (its first columns, at the top m)
    if bt_plain is None:
        bt_plain = ek.backtransform_plain(vp, taup, zp, keep)
    cols = bt_plain.shape[-1]
    check(float((torch.ormqr(oa, otau, oz)[:, :cols] - bt_plain[1:])
                .abs().max()) < (TOL_F64 if f64 else TOL_BT),
          f"torch.ormqr does not compute backtransform at m={m} {dt}")
    del bt_plain
    bt_cols = "" if cols == keep else f" ({cols} of {keep} columns)"
    timed = plain.get("kernel_ms", {})  # the top m's one launch, measured
    rdt = "float64" if f64 else "float32"
    calls = {
        "tridiag": (lambda: ek.tridiag(hh), None, None),
        "teig": (lambda: ek.teig(dp, ep),
                 f"torch.linalg.eigh(T) of the dense {rdt} T",
                 lambda: torch.linalg.eigh(tdense)),
        "backtransform": (
            lambda: ek.backtransform(vp, taup, zp, keep),
            "torch.ormqr(v in geqrf layout, tau, z[1:, :keep])",
            lambda: torch.ormqr(oa, otau, oz))}
    parts = []
    # launches a mean: fewer past m = 1024, one past 2048; at the top m
    # the library calls once, untimed calls left out (seconds each)
    reps = 20 if m <= 1024 else 3 if m <= 2048 else 1
    warm = not timed
    for kname, (kfn, lname, lfn) in calls.items():
        ms = timed[kname] if kname in timed else cuda_ms(kfn, reps, torch)
        pms = plain["ms"][kname]
        lms = cuda_ms(lfn, reps, torch, warm) if lfn else None
        bound = bound_fields(
            kname, m=m, keep=m if kname == "teig" else keep, f64=f64)
        row = dict(ms=ms, plain_ms=pms, library_ms=lms, **bound)
        plan = ""
        if kname == "tridiag":
            row["route"] = ek.tridiag_routes(m, f64)
            plan = f" ({tridiag_plan_text(ek, m, f64)})"
        if kname == "teig":
            row["route"] = ek.wide_routes(m, f64)["teig"]
            if row["route"] == "global":
                # the card-wide route: also its time at keep = m / 2, what
                # the sweeps launch, with that call's bound
                gp = ek.teig_grid_plan(m, f64)
                hms = timed.get("teig_half") or cuda_ms(
                    lambda: ek.teig(dp, ep, keep), reps, torch)
                hb = bound_fields("teig", m=m, keep=keep, f64=f64)
                row.update(design="card-wide (teig_grid)", keep_half_ms=hms,
                           keep_half_bound_ms=hb["bound_ms"],
                           keep_half_bound_by=hb["bound_by"], plan=gp)
                plan = (f" (card-wide, iterate in global memory, blocks of "
                        f"{gp['block']}, in-block clusters of "
                        f"{gp['inblock_ctas']} CTAs; keep={keep} {hms:.4f} "
                        f"ms, bound {hb['bound_ms']:.5f} ms "
                        f"({hb['bound_by']}))")
            else:
                plan = (f" (clusters of {ek.teig_cluster_size(m, f64)} "
                        f"CTAs, iterate in {row['route']} memory)")
        if kname == "backtransform":
            row["route"] = ek.backtransform_routes(m, f64)
            row["plan"] = bt_plan_text(ek, m, keep, f64)
            row["plain_cols"] = cols
            plan = f" ({row['plan']})"
        rec[kname + sfx].setdefault("by_m", {})[m] = row
        if m == 1024:  # the size the chi = 512 sweeps launch
            rec[kname + sfx].update(
                ms=ms, plain_ms=pms, library_call=lname, library_ms=lms,
                shape=f"m={m}" + (", complex128" if f64 else ""), **bound)
            rec[kname + sfx].update({k: row[k] for k in (
                "design", "keep_half_ms", "keep_half_bound_ms",
                "keep_half_bound_by") if k in row})
        ptxt = (f"{pms:.4f} ms" + (bt_cols if kname == "backtransform"
                                   else "") if pms is not None
                else "not measured (a Python loop past the run's time)")
        parts.append(f"{kname}{plan} kernel {ms:.4f} ms plain {ptxt} "
                     f"bound {bound['bound_ms']:.5f} ms ({bound['bound_by']}) "
                     + (f"{lname} {lms:.4f} ms" if lfn else "no library call"))
    chain_ms = timed.get("chain") or cuda_ms(
        lambda: ek.eigh_top_kernels(hh, keep), reps, torch)
    eigh_ms = cuda_ms(lambda: torch.linalg.eigh(hh), reps, torch, warm)
    rec["tridiag" + sfx]["by_m"][m].update(chain_ms=chain_ms,
                                           eigh_h_ms=eigh_ms)
    return (f"reach: m={m} {str(dt)[6:]} " + "; ".join(parts) + f"; the "
            f"K2-K4 chain {chain_ms:.4f} ms against torch.linalg.eigh(H) "
            f"{eigh_ms:.4f} ms")


def reach_spin(torch, ek, envk, card, n=50, layers=2):
    """The spin chain through the port's workload script (workloads/
    spin_chain.py) with SPIN_CHI_SCHEDULE=32,64,128,256, cut to `layers`
    layers a stage: every stage runs, the last one on the streamed K1
    (chi = 256), and the record's center-gauge verifier agrees with the
    compile's overlap (relative: the cut schedule's overlaps are small).
    Returns the launches by variant of that run."""
    import os
    import tempfile
    from adaptaqc_tpu_torch.workloads import spin_chain
    knobs = {"SPIN_CHI_SCHEDULE": "32,64,128,256", "SPIN_LAYERS": str(layers)}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    reset_counts(ek, envk)
    try:
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            rec = spin_chain.run(n=n, steps=SPIN["steps"], dt=SPIN["dt"],
                                 device="cuda", circuits_dir=d)
            wall = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    counts = variant_counts(ek, envk)
    stages = [c for c, _ in rec["chi_schedule"] or []]
    ver, ov = rec["independent_engine_overlap"], rec["overlap"]
    rel = abs(ver - ov) / max(abs(ver), abs(ov), 1e-300)
    print(f"reach: spin chain n={n} through workloads/spin_chain.py, "
          f"SPIN_CHI_SCHEDULE=32,64,128,256, {layers} layers a stage (cut): "
          f"chi_schedule {[(c, f'{o:.3e}') for c, o in rec['chi_schedule']]}"
          f", overlap {ov:.6e}, center-gauge verifier {ver:.6e}, relative "
          f"difference {rel:.2e} < {TOL_LADDER_REL}, {rec['layers']} layers, "
          f"{rec['cost_evaluations']} cost evaluations, {wall:.2f} s, "
          f"launches {json.dumps(rec['launches'])}, by variant "
          f"{json.dumps(counts)} on {card}", flush=True)
    check(stages == [32, 64, 128, 256], f"spin chi schedule stages {stages}")
    check(counts["env_chain"]["reach"] > 0,
          "the chi=256 stage did not launch the streamed env chain")
    check(counts["env_chain"]["wide"] > 0,
          "the chi=128 stage did not launch the wide env chain")
    check(np.isfinite(ov) and rel < TOL_LADDER_REL,
          f"spin chi schedule: verifier {ver} vs {ov}")
    return counts


def reach_verified_stop(torch, port, cplx, card, n, chi, max_layers):
    """AdaptCompiler on MPSBackend(max_chi=chi) for random_target(1, n),
    cut to max_layers: its final cost is verified by a re-simulation at
    twice the working chi (1024) on the native verifier, every Gram m =
    2048. Prints the overlap, the verifier's seconds and calls of the
    native route at m = 2048, and that route's ms a call (complex128, on
    one of those Grams)."""
    from adaptaqc_tpu_torch.utils.ansatzes import identity_resolvable
    from adaptaqc_tpu_torch.utils.constants import (CMAP_LINEAR,
                                                    generate_coupling_map)
    from adaptaqc_tpu_torch.utils.targets import random_target
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    config = port.AdaptConfig(method="general_gradient",
                              cost_improvement_num_layers=1000,
                              sufficient_cost=9.5e-3, max_layers=max_layers)
    backend = port.mps_backend_with_args(mps_truncation_threshold=1e-8,
                                         max_chi=chi, device=dev)
    compiler = port.AdaptCompiler(
        random_target(1, n=n, device=dev), backend=backend,
        adapt_config=config, coupling_map=generate_coupling_map(
            n, CMAP_LINEAR),
        custom_layer_2q_gate=identity_resolvable(),
        starting_circuit="tenpy_product_state")
    verified, gram, calls = [], [], [0]
    true_cost = compiler._true_cost_of_gate_circuit
    eigh_top = cplx.eigh_top

    def timed_true_cost(qc):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        cost = true_cost(qc)
        torch.cuda.synchronize()
        verified.append((time.perf_counter() - s0, cost))
        return cost

    def counted_eigh_top(h, keep, eigh=None):
        if (eigh or cplx.default_eigh()) == "native" and h.shape[-1] == 2048:
            calls[0] += 1
            gram[:] = gram or [(h.clone(), keep)]
        return eigh_top(h, keep, eigh)

    compiler._true_cost_of_gate_circuit = timed_true_cost
    cplx.eigh_top = counted_eigh_top
    try:
        result = compiler.compile()
        torch.cuda.synchronize()
    finally:
        cplx.eigh_top = eigh_top
    wall = time.perf_counter() - t0
    calls = calls[0]
    check(verified and calls > 0,
          f"the compile at chi={chi} made no verification at m=2048 "
          f"({len(verified)} verifications, {calls} native calls)")
    h, keep = gram[0]
    route_ms = cuda_ms(lambda: cplx.eigh_top(h, keep, "native"), 5, torch)
    ov = float(result.overlap)
    print(f"reach: verified stop n={n} working chi={chi} "
          f"({len(result.qubit_pair_history)} pairs, {max_layers} layers "
          f"at most): overlap {ov:.6f}, verifier {sum(v[0] for v in verified):.2f}"
          f" s over {len(verified)} re-simulation(s) at chi={2 * chi} "
          f"({calls} native calls at m=2048; the route "
          f"{route_ms:.4f} ms a call in complex128), compile "
          f"{wall:.1f} s on {card}", flush=True)
    check(np.isfinite(ov) and -1e-6 <= ov <= 1 + 1e-6,
          f"verified stop: overlap {ov}")


# the reach sweeps whose K2 Grams are checked and timed one by one
# (the chi = 512 sweeps' Grams went for the run's time: the same K2 route)
REACH_GRAM_SWEEPS = ((1024, False), (1024, True))


def reach_sweep_grams(torch, ek, mps_core, sweeps, compile_tape, card, rec):
    """K2 on the Grams that the reach sweeps at REACH_GRAM_SWEEPS give it
    (one more sweep each, its tridiag launches recorded): every Gram
    launched again alone, its active steps (tau != 0) and time (CUDA
    events, 2 launches) beside the bound on those steps; on two of them
    (the one with the most active steps, and the padded one with the most
    zero rows among those with active steps; but in complex128 at chi =
    1024 that one alone) the zeros of e and tau against the plain version's
    (every plain-inactive step inactive) and Q T Q^H = H. Into
    rec["tridiag[<variant>]"]["sweep_grams"][chi]."""
    for chi, f64 in REACH_GRAM_SWEEPS:
        t0 = time.perf_counter()
        dt = torch.complex128 if f64 else torch.complex64
        _, _, args = sweep_setup(torch, mps_core, sweeps, compile_tape, chi,
                                 dt)
        grams = [a[0] for a in record_eigh_inputs(
            torch, ek, lambda: sweeps.sweep(*args))["tridiag"]]
        act, ms, bounds, zero_rows = [], [], [], []
        for hh in grams:
            m = hh.shape[-1]
            _, tau, _, _ = ek.tridiag(hh)
            a = [k for k in range(m - 1) if tau[k] != 0]
            act.append(len(a))
            bounds.append(kernel_bound("tridiag", m=m, active=a, f64=f64)[0])
            ms.append(cuda_ms(lambda: ek.tridiag(hh), 2, torch))
            zero_rows.append(int((hh.abs().amax(dim=1) == 0).sum()))
        dense = int(np.argmax(act))
        padded = [i for i in range(len(grams)) if act[i] and zero_rows[i]]
        pad = {max(padded, key=lambda i: zero_rows[i])} if padded else set()
        picks = sorted({dense} | pad if (chi, f64) == (1024, True) or not pad
                       else pad)
        worst, inactive = 0.0, []
        for i in picks:
            hh = grams[i]
            v, tau, d, e = ek.tridiag(hh)
            _, taup, _, ep = ek.tridiag_plain(hh)
            inactive.append(zeros_equal(e, tau, ep, taup,
                                        f"tridiag {dt} chi={chi} sweep "
                                        f"Gram {i}"))
            err = tridiag_residual(torch, ek, v, tau, d, e, hh)
            worst = max(worst, err)
            check(err < (TOL_F64 if f64 else TOL_TRIDIAG_REL),
                  f"tridiag {dt} chi={chi} sweep Gram {i}: Q T Q^H rel {err}")
        key = f"tridiag[{REACH_VARIANTS[f64]}]"
        rec[key].setdefault("sweep_grams", {})[chi] = dict(
            launches=len(grams), active_steps=float(np.mean(act)),
            ms=float(np.mean(ms)), ms_all=float(np.sum(ms)),
            bound_ms=float(np.mean(bounds)))
        print(f"reach: tridiag {str(dt)[6:]} on the chi={chi} sweep's "
              f"{len(grams)} Grams (m={2 * chi}, "
              f"{tridiag_plan_text(ek, 2 * chi, f64)}): {np.mean(ms):.4f} ms "
              f"a launch ({np.sum(ms):.3f} ms in all), active steps a Gram "
              f"{np.mean(act):.1f} (max {max(act)}), bound on the active "
              f"steps {np.mean(bounds):.5f} ms a launch; Grams {picks}: "
              f"inactive steps {inactive} (every plain-inactive step "
              f"inactive), Q T Q^H {worst:.2e} "
              f"({time.perf_counter() - t0:.1f} s) on {card}", flush=True)


def phase_reach(torch, mps_core, sweeps, Circuit, compile_tape, ek, envk,
                card, port, cplx):
    """Past the sizes whose operands fit on chip: the streamed K1 to chi =
    8192 and K2-K4 to m = 16384 against their plain versions (K3 also alone
    either side of its inverse iteration's fit, K4 also alone at complex128
    m = 4096), then the paths at full width (n = 50) that
    launch them, each counted on its own: bench.py's sweep at chi = 256,
    512 and 1024 in complex64 and complex128 (REACH_SWEEPS), and the spin
    chain's chi schedule to 256; K2 on the chi = 1024 sweeps' own Grams
    (reach_sweep_grams); then the deep re-simulation at chi = 256, 1024
    and 4096 (REACH_HAZARD), its native side beside it, one sweep at chi
    = 4096 with its peak memory (REACH_PEAK), and a compile's verified
    stop re-simulated at chi = 1024 (VERIFIED_STOP). Every row of
    reach_rows must have launched on the sweeps and the spin chain, and no
    other reach counter. Returns (the records of the new variants, their
    launches on those paths, reach_rows, the chi = 4096 sweep's peak and
    launches by dtype)."""
    from adaptaqc_tpu_torch.ops import cuda_lib
    dev = torch.device("cuda")
    rec = {f"{k}[{v}]": {"max_abs_err": None, "ms": None, "plain_ms": None,
                         "bound_ms": None, "bound_by": None,
                         "library_call": None, "library_ms": None}
           for k in KERNELS for v in REACH_VARIANTS}
    parts, last = {}, [time.perf_counter()]

    def part(name):  # the wall seconds of the part that just ended
        now = time.perf_counter()
        parts[name] = round(now - last[0], 1)
        last[0] = now

    reach_env_check(torch, envk, cuda_lib, card, dev, rec)
    part("env")
    reach_eigh_check(torch, ek, card, dev, rec)
    reach_teig_fit(torch, ek, dev, card, rec)
    for m, f64 in REACH_BT_ONLY:
        print(reach_bt_only(torch, ek, cuda_lib, rec, dev, m, f64, card),
              flush=True)
        torch.cuda.empty_cache()
    # the sizes checked so far do not launch again: their cached K3 iterates
    # (b0, m x m reals a size: 2.1 GB at complex128 m = 16384) and chi =
    # 8192 boundary environments go, so that the chi = 4096 sweep below
    # finds the memory it peaks at (67 GB in complex128)
    ek._B0_CACHE.clear()
    envk._BOUNDARY.clear()
    torch.cuda.empty_cache()
    part("eigh")
    launches = {k: dict.fromkeys(REACH_VARIANTS, 0) for k in KERNELS}

    def add(counts):
        for k, c in counts.items():
            for v in REACH_VARIANTS:
                launches[k][v] += c[v]

    sweep_args = (torch, mps_core, sweeps, Circuit, compile_tape, card)
    strip_sweeps = {}
    for chi, f64, reps in REACH_SWEEPS:
        add(phase_sweep(*sweep_args, chi=chi, ek=ek, envk=envk,
                        dtype=torch.complex128 if f64 else torch.complex64,
                        reps=reps))
        # K4's strip route launches on a sweep whose Grams reach it
        strip = ek.backtransform.strip_launches
        on_strip = ek.backtransform_routes(2 * chi, f64) == "strip"
        check((strip > 0) == on_strip,
              f"reach sweep chi={chi} f64={f64}: K4's strip route launched "
              f"{strip} times, its route at m={2 * chi} is "
              f"{ek.backtransform_routes(2 * chi, f64)}")
        if on_strip:
            strip_sweeps[f"chi={chi}" + (" c128" if f64 else "")] = strip
    print(f"reach: K4's strip route on the sweeps whose m = 2 chi takes it "
          f"{json.dumps(strip_sweeps)} on {card}", flush=True)
    part("sweeps")
    add(reach_spin(torch, ek, envk, card))
    part("spin")
    reach_sweep_grams(torch, ek, mps_core, sweeps, compile_tape, card, rec)
    part("grams")
    for chi, layers, native_chi, f64, n, cx_sites in REACH_HAZARD:
        phase_hazard(torch, mps_core, Circuit, compile_tape, card, chi=chi,
                     layers=layers, native_chi=native_chi,
                     dtype=torch.complex128 if f64 else torch.complex64,
                     n=n, cx_sites=cx_sites)
        torch.cuda.empty_cache()
    part("hazard")
    peak = reach_peak_sweep(torch, mps_core, sweeps, Circuit, compile_tape,
                            ek, envk, card, **REACH_PEAK)
    part("peak")
    reach_verified_stop(torch, port, cplx, card, **VERIFIED_STOP)
    part("verified_stop")
    print(f"reach: wall seconds by part {json.dumps(parts)}", flush=True)
    rows = reach_rows(ek, envk)
    for k, by_v in launches.items():
        for v, count in by_v.items():
            check((count > 0) == ((k, v) in rows),
                  f"{k}[{v}] launched {count} times on the reach phase's "
                  f"paths; the rows whose code they run: {rows}")
    print(f"reach: launches of the new variants on the sweeps and the spin "
          f"chain {json.dumps(launches)} on {card}", flush=True)
    return rec, launches, rows, peak


# --------------------------------------------------------------- phase 12
def phase_optim(torch, port, card, dev="cuda", n=50, n_small=10):
    """The host optimisers and the subsampled sweep on the card: BOBYQA
    layers with the final BOBYQA minimisation, and Rotosolve layers under
    rotosolve_fraction=0.5, each on the slice's target at chi=32; then a
    complex128 MPS compile, whose eigensolver and env-chain calls launch
    the kernels' double instantiations. Returns those launches."""
    import random
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    from adaptaqc_tpu_torch.ops import env_kernel as envk
    from adaptaqc_tpu_torch.optim.minimiser import CostMinimiser
    from adaptaqc_tpu_torch.utils.ansatzes import identity_resolvable
    from adaptaqc_tpu_torch.utils.constants import (CMAP_LINEAR,
                                                    generate_coupling_map)
    from adaptaqc_tpu_torch.utils.targets import random_target
    dev = torch.device(dev)

    def compile_once(name, nq, layers, dtype=torch.complex64, **kw):
        qmps = random_target(1, n=nq, device=dev, dtype=dtype)
        backend = port.mps_backend_with_args(
            mps_truncation_threshold=1e-8, max_chi=32, device=dev,
            dtype=dtype)
        compiler = port.AdaptCompiler(
            qmps, backend=backend,
            adapt_config=port.AdaptConfig(
                method="general_gradient", cost_improvement_num_layers=1000,
                sufficient_cost=9.5e-3, max_layers=layers),
            coupling_map=generate_coupling_map(nq, CMAP_LINEAR),
            custom_layer_2q_gate=identity_resolvable(),
            starting_circuit="tenpy_product_state", **kw)
        reset_counts(ek, envk)
        t0 = time.perf_counter()
        result = compiler.compile()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in (
            envk.env_chain, ek.tridiag, ek.teig, ek.backtransform)}
        f64 = f64_counts(ek, envk)
        print(f"optim: {name}: n={nq} chi=32 {len(result.qubit_pair_history)}"
              f" layers, overlap {result.overlap:.6e}, per-layer cost ["
              + ", ".join(f"{c:.6f}" for c in result.global_cost_history)
              + f"], {result.cost_evaluations} cost evaluations, {wall:.2f} s,"
              f" launches {json.dumps(launches)} of which in complex128 "
              f"{json.dumps(f64)} on {card}", flush=True)
        check(np.isfinite(result.overlap) and
              0.0 <= result.overlap <= 1.0 + 1e-6,
              f"{name}: overlap {result.overlap}")
        check(compiler._current_state().device.type == dev.type,
              f"{name}: the state is not on the card")
        return launches, f64

    # BOBYQA: each cost evaluation re-simulates the unabsorbed layers, so
    # every evaluation runs K2-K4; BOBYQA's own maxfun caps each call
    orig = CostMinimiser._pybobyqa_minimize
    CostMinimiser._pybobyqa_minimize = (
        lambda self, kw: orig(self, dict(kw, maxfun=BOBYQA_MAXFUN)))
    try:
        launches, f64 = compile_once(
            f"use_roto_algos=False, perform_final_minimisation=True (BOBYQA "
            f"maxfun {BOBYQA_MAXFUN} a call)", n, 2, use_roto_algos=False,
            perform_final_minimisation=True)
    finally:
        CostMinimiser._pybobyqa_minimize = orig
    for k in ("tridiag", "teig", "backtransform"):
        check(launches[k] > 0, f"BOBYQA compile launched no {k}")
    check(not any(f64.values()), f"BOBYQA compile launched in double {f64}")

    random.seed(6)  # the per-cycle subsample (the stdlib generator)
    launches, f64 = compile_once(
        "rotosolve_fraction=0.5, Rotosolve", n, 3, rotosolve_fraction=0.5,
        use_rotoselect=False)
    for k, v in launches.items():
        check(v > 0, f"subsampled Rotosolve compile launched no {k}")
    check(not any(f64.values()), f"subsampled compile launched in double "
                                 f"{f64}")

    launches, f64 = compile_once("complex128 MPSBackend", n_small, 3,
                                 dtype=torch.complex128)
    check(all(v > 0 and v == launches[k] for k, v in f64.items()),
          f"the complex128 compile did not run every kernel in double: "
          f"launches {launches}, in complex128 {f64}")
    return f64


# --------------------------------------------------------------- phase 13
# s: the first run stops, the second resumes (60 and 30 until the reach
# phase's m = 2048 checks needed the run's time), the spin chain alongside
RMPS_DEADLINES = (20, 10)
SPIN_DEADLINE = 15         # s
EXAMPLE_FLOORS = {"readme_example": 0.98, "simple_sv_example": 0.98,
                  "advanced_sv_example": 0.9}  # tests/test_examples.py
TOL_ENTRY = 1e-5           # entry()'s cost, card complex64 vs CPU complex128


def start_workload(module, args, workdir, name):
    """`python3 -m adaptaqc_tpu_torch.workloads.<module> args` from the
    checkout's root, its stderr to `workdir/name.log`: (process, log)."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    log = open(os.path.join(workdir, f"{name}.log"), "w")
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.Popen(
        [sys.executable, "-m", f"adaptaqc_tpu_torch.workloads.{module}",
         *args], cwd=root, env=env, stdout=subprocess.PIPE, stderr=log,
        text=True)
    return proc, log


def workload_record(proc, log, name, timeout):
    """The JSON record on the last line of the script's stdout."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    if proc.returncode != 0:
        with open(log.name) as f:
            tail = f.read()[-3000:]
        raise SmokeFailure(f"{name} exited {proc.returncode}:\n{tail}")
    lines = out.strip().splitlines()
    check(lines, f"{name} printed no record")
    return json.loads(lines[-1])


def workload_args(workdir, tag, deadline, dev):
    import os
    return ["--device", dev, "--deadline", str(deadline),
            "--checkpoint-every", "2",
            "--checkpoint-dir", os.path.join(workdir, f"{tag}_ck"),
            "--results", os.path.join(workdir, f"{tag}.jsonl"),
            "--circuits-dir", os.path.join(workdir, "circuits")]


def record_line(tag, rec):
    keys = ("overlap", "overlap_chi64_check", "independent_engine_overlap",
            "layers", "num_2q_gates", "solution_2q_gates", "cnot_depth",
            "solution_2q_depth", "cost_evaluations", "wall_seconds",
            "wall_seconds_total", "evals_per_sec", "stopped",
            "resumed_from_layer", "sm_raw", "sm_solution", "launches")
    return f"workloads: {tag} " + json.dumps(
        {k: rec[k] for k in keys if k in rec})


def workloads_dir():
    import os
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "local",
                        "chip_smoke_workloads")


def phase_workloads(torch, card, dev="cuda", n=50, spin_steps=3,
                    sweep_shape=(50, 64)):
    """The workload scripts as a user runs them, each in its own process: the n=50
    random-MPS compile stopped by its deadline and resumed from its
    checkpoint by a second process, and the spin-chain compile (alongside,
    in a third); then bench_sweep, the three small example twins and
    entry() in this process. (Smaller n, spin_steps and sweep_shape and
    dev="cpu" rehearse it on the CPU.)"""
    import contextlib
    import io
    import os
    import re
    import shutil
    from adaptaqc_tpu_torch.workloads import _common, bench_sweep, entry
    workdir = workloads_dir()
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    procs = []
    try:
        spin = start_workload("spin_chain", [
            "--n", str(n), "--steps", str(spin_steps),
            *workload_args(workdir, "spin", SPIN_DEADLINE, dev)],
            workdir, "spin")
        procs.append(spin[0])
        rmps_args = ["1", "--n", str(n)]
        first = start_workload("random_mps", rmps_args + workload_args(
            workdir, "rmps", RMPS_DEADLINES[0], dev), workdir, "rmps1")
        procs.append(first[0])
        rec1 = workload_record(*first, "random_mps (first)", 600)
        print(record_line(f"random_mps n={n} seed 1, first process", rec1),
              flush=True)
        newest = _common.newest_checkpoint(os.path.join(workdir, "rmps_ck"))
        check(rec1["stopped"] == "deadline" and rec1["layers"] >= 2,
              f"the first random-MPS run did not stop by its deadline "
              f"after >= 2 layers: {rec1['stopped']}, {rec1['layers']}")
        check(newest is not None, "the deadline stop left no checkpoint")
        check(all(v > 0 for v in rec1["launches"].values()),
              f"the random-MPS workload did not launch every kernel: "
              f"{rec1['launches']}")
        ck_layer = int(os.path.basename(newest)[:-4])
        second = start_workload("random_mps", rmps_args + workload_args(
            workdir, "rmps", RMPS_DEADLINES[1], dev), workdir, "rmps2")
        procs.append(second[0])
        rec2 = workload_record(*second, "random_mps (resumed)", 600)
        print(record_line(f"random_mps n={n} seed 1, resumed from "
                          f"{os.path.basename(newest)}", rec2), flush=True)
        resumed = rec2["resumed_from_layer"]
        check(resumed == ck_layer + 1 == rec1["layers"],
              f"resumed at layer {resumed}, checkpoint {newest}, first run "
              f"{rec1['layers']} layers")
        check(rec2["qubit_pair_history"][:resumed]
              == rec1["qubit_pair_history"][:resumed],
              "the resumed pair history does not begin with the first "
              "run's")
        for rec in (rec1, rec2):
            check(np.isfinite(rec["overlap"])
                  and 0 <= rec["overlap"] <= 1 + 1e-6,
                  f"random-MPS overlap out of range: {rec['overlap']}")
        rec3 = workload_record(*spin, "spin_chain", 600)
        print(record_line(f"spin_chain n={n} {spin_steps} steps", rec3),
              flush=True)
        check(all(v > 0 for v in rec3["launches"].values()),
              f"the spin-chain workload did not launch every kernel: "
              f"{rec3['launches']}")
        check(np.isfinite(rec3["overlap"]) and np.isfinite(rec3["sm_raw"]),
              "the spin-chain record has no finite overlap")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    sw = bench_sweep.run(n=sweep_shape[0], chi=sweep_shape[1], device=dev)
    print(f"workloads: bench_sweep n={sw['n']} chi={sw['chi']} "
          f"{sw['window_layers']} layers: {sw['evals_per_sec']:.1f} evals/s,"
          f" {sw['ms_per_sweep']:.2f} ms/sweep, {sw['evals_per_sweep']} "
          f"evaluations a sweep on {card}", flush=True)
    check(np.isfinite(sw["evals_per_sec"]) and sw["evals_per_sec"] > 0,
          "bench_sweep gave no rate")

    from adaptaqc_tpu_torch import examples  # noqa: F401
    import importlib
    for name, floor in EXAMPLE_FLOORS.items():
        mod = importlib.import_module(f"adaptaqc_tpu_torch.examples.{name}")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main(["--device", dev])
        m = re.search(r"Overlap between circuits is ([0-9.eE+-]+)",
                      buf.getvalue())
        check(m is not None, f"{name} printed no overlap")
        ov = float(m.group(1))
        print(f"workloads: example {name}: overlap {ov:.6f} (floor {floor})"
              f" in {time.perf_counter() - t0:.2f} s on {card}", flush=True)
        check(ov > floor, f"{name} overlap {ov} <= {floor}")

    fn, args = entry.entry(device=dev)
    cost = float(fn(*args))
    fn, cargs = entry.entry(device="cpu", dtype=torch.complex128)
    ref = float(fn(*cargs))
    print(f"workloads: entry() cost {cost!r} on the card (complex64), "
          f"{ref!r} on the CPU (complex128), |diff| {abs(cost - ref):.2e} <"
          f" {TOL_ENTRY}", flush=True)
    check(np.isfinite(cost) and abs(cost - ref) < TOL_ENTRY,
          f"entry() cost {cost} vs {ref}")
    return workdir  # its records feed the refine phase, which removes it


# ---------------------------------------------------------------- zigzag
TOL_ZZ_ANGLE = 1e-5      # first zigzag forward cycle vs the standard sweep
TOL_ZZ_STATE = 1e-4      # 1 - normalised |<a|b>|^2, zigzag state vs apply_all
TOL_ENV_ANGLE_F64 = 1e-8  # env-cached vs full-chain sweep, complex128
TOL_ENV_COST = 1e-4      # env-cached vs full-chain sweep's cost, complex64
ZZ_CYCLES = 4            # sweep_zigzag_until_converged's cycle budget


def _event_ms(torch, fn):
    """(fn(), its milliseconds by CUDA events, the card synchronised)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _norm_infidelity(mps_core, a, b):
    """1 - |<a|b>|^2 / (<a|a> <b|b>)."""
    ab = complex(mps_core.mps_dot(a, b))
    aa = float(mps_core.mps_dot(a, a).real)
    bb = float(mps_core.mps_dot(b, b).real)
    return 1.0 - abs(ab) ** 2 / max(aa * bb, 1e-30)


def _eigh_launches(ek):
    return {fn.__name__: fn.launches
            for fn in (ek.tridiag, ek.teig, ek.backtransform)}


def zz_first_forward(sweeps, args):
    """The standard sweep and a zigzag forward cycle given the R states at
    the input angles, on the same inputs: (kinds equal, largest angle
    gap)."""
    engine, bl, rot, prefix, ref, kinds, q0, q1, angles, sel = args
    sk, sa = sweeps.sweep(*args)[:2]
    struct, q0l, q1l, sell = sweeps._host_structure(kinds, q0, q1, sel)
    kd, ad = sweeps._device_tape(prefix, kinds, angles)
    r_buf, _ = sweeps._zz_right_states(engine, ref, struct, q0l, q1l, kd, ad)
    kd, ad = sweeps._zz_forward(engine, rot, prefix, ref, struct, q0l, q1l,
                                kd, ad, sell, r_buf)[:2]
    return (np.array_equal(kd.cpu().numpy(), sk),
            float(np.abs(ad.cpu().numpy() - sa).max()))


def zz_pair(torch, sweeps, args):
    """One (forward, backward) zigzag pair after its R states were built:
    (its milliseconds, its K2 launches, its K1 launches)."""
    engine, bl, rot, prefix, ref, kinds, q0, q1, angles, sel = args
    struct, q0l, q1l, sell = sweeps._host_structure(kinds, q0, q1, sel)
    kd, ad = sweeps._device_tape(prefix, kinds, angles)
    r_buf, _ = sweeps._zz_right_states(engine, ref, struct, q0l, q1l, kd, ad)
    torch.cuda.synchronize()
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    from adaptaqc_tpu_torch.ops import env_kernel as envk
    before = ek.tridiag.launches, envk.env_chain.launches

    def pair():
        k, a, _, _, _, l_buf = sweeps._zz_forward(
            engine, rot, prefix, ref, struct, q0l, q1l, kd, ad, sell, r_buf)
        return sweeps._zz_backward(engine, rot, prefix, ref, struct, q0l,
                                   q1l, k, a, sell, l_buf)

    _, ms = _event_ms(torch, pair)
    return (ms, ek.tridiag.launches - before[0],
            envk.env_chain.launches - before[1])


def phase_zigzag(torch, mps_core, sweeps, compile_tape, ek, envk, card,
                 chi=64, full=True):
    """The opt-in sweep modes at bench.py's shape (n=50, 12 dressed-CNOT
    layers, Rotoselect, complex64) at bond dimension chi: the first zigzag forward
    cycle against the standard sweep; with `full`, also
    sweep_zigzag_until_converged against apply_all at its angles, the
    env-cached sweep against the full-chain sweep (complex128: kinds
    equal, angles 1e-8; complex64: costs 1e-4), the launches of each mode
    and the ms a cycle of each, by CUDA events, in turns."""
    t_phase = time.perf_counter()
    at, bl, args = sweep_setup(torch, mps_core, sweeps, compile_tape, chi,
                               torch.complex64)
    check(bl == at.padded_length, f"zigzag needs one block: {bl}")
    same, gap = zz_first_forward(sweeps, args)
    print(f"zigzag: chi={chi} first forward cycle vs the standard sweep: "
          f"kinds equal {same}, largest angle gap {gap:.3e} (tol "
          f"{TOL_ZZ_ANGLE}) on {card}", flush=True)
    check(same and gap <= TOL_ZZ_ANGLE,
          f"zigzag first forward cycle at chi={chi}: kinds {same}, "
          f"angles {gap}")
    if not full:  # in turns; the first pair also grows the allocator
        ms = {"standard": [], "zigzag": []}
        for _ in range(2):
            ms["standard"].append(round(_event_ms(
                torch, lambda: sweeps.sweep(*args))[1], 4))
            ms["zigzag"].append(round(zz_pair(torch, sweeps, args)[0] / 2,
                                      4))
        print(f"zigzag: chi={chi} ms a cycle in turns (standard, zigzag, "
              f"twice): {json.dumps(ms)} ({time.perf_counter() - t_phase:.1f}"
              f" s) on {card}", flush=True)
        return
    engine, _, _, prefix, ref, kinds, q0, q1, angles, sel = args

    # sweep_zigzag_until_converged: its state is prefix + tape at its angles
    nk, na, cost, cycles, evals, state, cost0 = \
        sweeps.sweep_zigzag_until_converged(engine, True, ZZ_CYCLES, prefix,
                                            ref, kinds, q0, q1, angles, sel,
                                            -np.inf, 1e-10)
    fresh = sweeps.apply_all(engine, prefix, nk, q0, q1, na)
    infid = _norm_infidelity(mps_core, state, fresh)
    nrm2 = float(mps_core.mps_dot(state, state).real)
    ov2 = abs(complex(mps_core.mps_dot(ref, state))) ** 2
    state_cost = 1.0 - ov2 / nrm2
    # the cost pins at 1 in float32 at this overlap: |<0|psi>|^2 moves
    start = sweeps.apply_all(engine, prefix, kinds, q0, q1, angles)
    ov2_0 = abs(complex(mps_core.mps_dot(ref, start))) ** 2
    print(f"zigzag: chi={chi} sweep_zigzag_until_converged, {cycles} "
          f"cycles, cost {cost0:.6e} -> {cost:.6e}, |<0|psi>|^2 {ov2_0:.6e} "
          f"-> {ov2:.6e}; its state vs apply_all at its angles 1 - "
          f"|<a|b>|^2 {infid:.3e}, its cost vs its state's "
          f"{abs(cost - state_cost):.3e} (tol {TOL_ZZ_STATE})", flush=True)
    check(infid <= TOL_ZZ_STATE and abs(cost - state_cost) <= TOL_ZZ_STATE
          and cost <= cost0 + 1e-3 and ov2 >= ov2_0,
          f"zigzag state {infid}, cost {cost} vs {state_cost}, cost0 "
          f"{cost0}, |<0|psi>|^2 {ov2_0} -> {ov2}")

    # the env cache against the full chain: complex128, then complex64
    env_engine = mps_core.sweep_engine(1e-16, allow_env_cache=True)
    _, _, args128 = sweep_setup(torch, mps_core, sweeps, compile_tape, chi,
                                torch.complex128)
    full128 = sweeps.sweep(*args128)
    env128 = sweeps.sweep(env_engine, *args128[1:])
    gap128 = float(np.abs(full128[1] - env128[1]).max())
    same128 = np.array_equal(full128[0], env128[0])
    full64 = sweeps.sweep(*args)
    reset_counts(ek, envk)
    env64 = sweeps.sweep(env_engine, *args[1:])
    env_k1 = envk.env_chain.launches
    gap64 = float(np.abs(full64[1] - env64[1]).max())
    print(f"zigzag: chi={chi} env-cached vs full-chain sweep: complex128 "
          f"kinds equal {same128}, largest angle gap {gap128:.3e} (tol "
          f"{TOL_ENV_ANGLE_F64}), costs {env128[2]:.12e} / {full128[2]:.12e};"
          f" complex64 costs {env64[2]:.6e} / {full64[2]:.6e} (tol "
          f"{TOL_ENV_COST}), largest angle gap {gap64:.3e}, kinds equal "
          f"{np.array_equal(full64[0], env64[0])}; K1 launches of the "
          f"env-cached sweep {env_k1}", flush=True)
    check(same128 and gap128 <= TOL_ENV_ANGLE_F64,
          f"env cache c128: kinds {same128}, angles {gap128}")
    check(abs(env64[2] - full64[2]) <= TOL_ENV_COST,
          f"env cache c64 cost {env64[2]} vs {full64[2]}")
    check(env_k1 == 0, f"the env-cached sweep launched K1 {env_k1} times")

    # launches: two standard cycles against one zigzag pair
    reset_counts(ek, envk)
    sweeps.sweep_n_cycles(*args[:3], 2, *args[3:])
    std2 = _eigh_launches(ek)
    _, pair_k2, pair_k1 = zz_pair(torch, sweeps, args)
    two_q = int(sum(sweeps.sv_core.is_two_qubit(int(k)) for k in at.kinds))
    print(f"zigzag: chi={chi} K2-K4 launches: two standard cycles "
          f"{json.dumps(std2)}, one zigzag pair {pair_k2} each "
          f"({two_q} two-qubit entries, G)", flush=True)
    check(0.45 <= pair_k2 / max(std2["tridiag"], 1) <= 0.55,
          f"a zigzag pair launched K2 {pair_k2} times against "
          f"{std2['tridiag']} for two standard cycles")

    # ms a cycle, in turns: standard, zigzag, env cache, then again
    times = {"standard": [], "zigzag": [], "env_cache": []}
    k1 = {"zigzag": pair_k1 / 2}
    for _ in range(2):
        reset_counts(ek, envk)
        times["standard"].append(_event_ms(
            torch, lambda: sweeps.sweep(*args))[1])
        k1["standard"] = envk.env_chain.launches
        times["zigzag"].append(zz_pair(torch, sweeps, args)[0] / 2)
        reset_counts(ek, envk)
        times["env_cache"].append(_event_ms(
            torch, lambda: sweeps.sweep(env_engine, *args[1:]))[1])
        k1["env_cache"] = envk.env_chain.launches
    times = {k: [round(t, 4) for t in v] for k, v in times.items()}
    print(f"zigzag: chi={chi} ms a cycle in turns (standard, zigzag, env "
          f"cache, twice): {json.dumps(times)}; K1 launches a cycle "
          f"{json.dumps(k1)} ({time.perf_counter() - t_phase:.1f} s) on "
          f"{card}", flush=True)
    check(all(np.isfinite(v).all() for v in times.values()),
          "a mode gave no time")


# ---------------------------------------------------------------- refine
REFINE_DEADLINE = 6      # s, each refinement's compile
REFINE_OWN_DEADLINES = (15, 10)  # s: --only refine's own random-MPS and
# spin-chain compiles
TOL_REFINE = 1e-3        # the warm start's first cost and the final overlap
TOL_REVERIFY = 1e-3      # reverify_spin vs the refined record's overlap


def _deadline(seconds):
    """ADAPTAQC_WALL_DEADLINE `seconds` from now, for _with_env."""
    return {"ADAPTAQC_WALL_DEADLINE": str(time.time() + seconds)}


def _with_env(values, fn):
    """fn() with the environment variables `values` set, then the
    variables as they were."""
    import os
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def refine_records(workdir, dev, n=50, spin_steps=3):
    """The records the refine phase starts from, in workdir: the workloads
    phase's (rmps.jsonl, spin.jsonl) where it ran, else a random-MPS
    compile and a spin-chain compile made here, each stopped by its
    deadline. Returns (random-MPS records path, spin-chain records
    path)."""
    import os
    from adaptaqc_tpu_torch.workloads import (_common, random_mps,
                                              spin_chain)
    rmps = os.path.join(workdir, "rmps.jsonl")
    spin = os.path.join(workdir, "spin.jsonl")
    if os.path.exists(rmps) and os.path.exists(spin):
        return rmps, spin
    os.makedirs(workdir, exist_ok=True)
    circuits = os.path.join(workdir, "circuits")
    rec = _with_env(_deadline(REFINE_OWN_DEADLINES[0]),
                    lambda: random_mps.run_seed(1, n, dev, checkpoint_every=0,
                                                circuits_dir=circuits))
    _common.append_record(rmps, json.dumps(rec))
    rec = _with_env(_deadline(REFINE_OWN_DEADLINES[1]),
                    lambda: spin_chain.run(n, spin_steps, SPIN["dt"], dev,
                                           checkpoint_every=0,
                                           circuits_dir=circuits))
    _common.append_record(spin, json.dumps(rec))
    return rmps, spin


def phase_refine(torch, card, workdir, dev="cuda", n=50, spin_steps=3):
    """The warm-start scripts on the n=50 records in workdir
    (refine_records):
    refine (REFINE_CHI=64, 2 more layers, under a deadline) and
    spin_refine (the same) start from the saved circuits, reverify_spin
    re-measures the refined spin circuit at chi=128, and summarize counts
    the records. Each compile's first recorded cost is at most 1 - the
    saved circuit's overlap + 1e-3, and its final overlap no lower than
    that overlap - 1e-3."""
    import contextlib
    import io
    import os
    import shutil
    from adaptaqc_tpu_torch.workloads import (_common, refine, reverify_spin,
                                              spin_refine, summarize)
    t_phase = time.perf_counter()
    rmps_src, spin_src = refine_records(workdir, dev, n, spin_steps)
    rdir = os.path.join(workdir, "refine")
    os.makedirs(rdir, exist_ok=True)
    rmps = os.path.join(rdir, "results_random_mps.jsonl")
    spin = os.path.join(rdir, "results_spin_chain.jsonl")
    shutil.copy(rmps_src, rmps)
    shutil.copy(spin_src, spin)
    circuits = os.path.join(rdir, "circuits")
    knobs = {"REFINE_CHI": "64", "REFINE_LAYERS": "2",
             "SPIN_REFINE_CHI": "64", "SPIN_REFINE_LAYERS": "2",
             "RMPS_CROSS_ENGINE": "0", "SPIN_CROSS_ENGINE": "0"}

    src = {r["circuit"]: r for r in _common.read_records(rmps)}
    path, _ = refine.best_saved_circuit(1, f"synthetic n={n}", rmps)
    ov64 = src[path]["overlap_chi64_check"]
    t0 = time.perf_counter()
    rec, res = _with_env({**knobs, **_deadline(REFINE_DEADLINE)},
                         lambda: refine.refine(1, n, dev, rmps,
                                               checkpoint_every=0,
                                               circuits_dir=circuits))
    _common.append_record(rmps, json.dumps(rec))
    first = res.global_cost_history[0]
    print(f"refine: random_mps n={n} seed 1 from {os.path.basename(path)} "
          f"(chi=64 check {ov64:.6f}): first cost {first:.6f} (<= "
          f"{1 - ov64 + TOL_REFINE:.6f}), overlap {rec['overlap']:.6f}, chi64"
          f" check {rec['overlap_chi64_check']:.6f}, {rec['layers']} layers,"
          f" stopped {rec['stopped']}, launches "
          f"{json.dumps(rec['launches'])}, {time.perf_counter() - t0:.1f} s "
          f"on {card}", flush=True)
    check(first <= 1 - ov64 + TOL_REFINE
          and rec["overlap"] >= ov64 - TOL_REFINE,
          f"refine did not start from the saved circuit: first cost {first},"
          f" overlap {rec['overlap']}, saved {ov64}")
    check(all(v > 0 for v in rec["launches"].values())
          or torch.device(dev).type != "cuda",  # a CPU rehearsal
          f"refine did not launch every kernel: {rec['launches']}")

    workload = f"xxz_trotter_n{n}_steps{spin_steps}_dt{SPIN['dt']}"
    path, spin_ov = spin_refine.best_saved_circuit(workload, spin)
    t0 = time.perf_counter()
    rec, res = _with_env({**knobs, **_deadline(REFINE_DEADLINE)},
                         lambda: spin_refine.refine(
                             n, spin_steps, SPIN["dt"], dev, spin,
                             checkpoint_every=0, circuits_dir=circuits))
    _common.append_record(spin, json.dumps(rec))
    first = res.global_cost_history[0]
    print(f"refine: spin_refine {workload} from {os.path.basename(path)} "
          f"(overlap {spin_ov:.6f}): first cost {first:.6f}, overlap "
          f"{rec['overlap']:.6f}, {rec['layers']} layers, stopped "
          f"{rec['stopped']}, launches {json.dumps(rec['launches'])}, "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
    check(first <= 1 - spin_ov + TOL_REFINE
          and rec["overlap"] >= spin_ov - TOL_REFINE,
          f"spin_refine did not start from the saved circuit: first cost "
          f"{first}, overlap {rec['overlap']}, saved {spin_ov}")

    t0 = time.perf_counter()
    again = _with_env({"REVERIFY_CHI": "128"}, lambda: reverify_spin.reverify(
        rec["circuit"], n, spin_steps, SPIN["dt"], dev))
    _common.append_record(spin, json.dumps(again))
    gap = abs(again["overlap"] - rec["overlap"])
    print(f"refine: reverify_spin at chi=128: overlap {again['overlap']:.6f}"
          f" against the refined record's {rec['overlap']:.6f} (|diff| "
          f"{gap:.2e}, tol {TOL_REVERIFY}), center-gauge "
          f"{again['independent_engine_overlap']:.6f}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(gap <= TOL_REVERIFY, f"reverify_spin {again['overlap']} vs "
                               f"{rec['overlap']}")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summarize.main(["--results-dir", rdir, "--source",
                        f"synthetic n={n}"])
    summary = json.loads(buf.getvalue())
    runs = len(_common.read_records(rmps))
    rows = len(_common.read_records(spin))
    print(f"refine: summarize: {summary['random_mps']['runs']} random-MPS "
          f"runs (of {runs} records), {len(summary['spin_chain'])} spin-chain"
          f" rows (of {rows}), {len(summary['fig5_cz'])} fig5 workloads "
          f"({time.perf_counter() - t_phase:.1f} s in the phase)",
          flush=True)
    check(summary["random_mps"]["runs"] == runs
          and len(summary["spin_chain"]) == rows,
          f"summarize counted {summary['random_mps']['runs']} / "
          f"{len(summary['spin_chain'])} of {runs} / {rows}")


# --------------------------------------------------------------- phase 16
MESH_RANKS = 4          # ranks of the mesh (over gloo where they share
                        # the card, over NCCL with a card each)
MESH_MAX_LAYERS = 2     # the sharded compile, cut
TOL_MESH_C128 = 1e-8    # the complex128 sharded compile's overlap against
                        # the unsharded one's
TOL_MESH_C64 = 1e-6    # the complex64 MPS steps (the dry run's chi = 256
                        # over tp = 4, the 1 x 1 NCCL mesh's) against the
                        # unsharded sweep: cost and every RDM entry
MESH_STEP = dict(n=6, chi=16)  # the 1 x 1 NCCL mesh's MPS step
# on four cards (a card a rank, NCCL, tp = 4): one Rotoselect sweep at chi
# 8192, past one card, on a target built as REACH_HAZARD builds its own
# (one layer, its CX on the middle sites; the padded state is what the
# sweep holds), in complex64 at n = 26, the least n whose middle bond
# reaches 8192 (so the verifier's chi is 8192 too); then in complex128 at
# the largest chi of MESH_REACH_CHI_F64 whose sweep's peak, scaled from
# the complex64 sweep's as chi^2 and twice the bytes, stays within
# MESH_REACH_BUDGET (at chi 8192 one complex128 state is 14 GB a rank,
# and a sweep holds five or six: past a card)
MESH_REACH = dict(n=26, chi=8192)
MESH_REACH_CHI_F64 = (8192, 7168, 6144, 5120, 4096)
MESH_REACH_BUDGET = 68e9  # bytes a rank of the card's 80 GB
MESH_REACH_CX = (12,)  # the target's CX sites (n // 2 - 1 at n = 26)
TOL_MESH_REACH = 1e-3  # the verifier on shards (native eigh) against the
                       # sweep's kernel path, as TOL_HAZARD


def mesh_target(Circuit, n=4, seed=5):
    """tests/test_mesh.py's MPS compile target: two layers of random RY and
    a CX chain."""
    rng = np.random.default_rng(seed)
    qc = Circuit(n)
    for _ in range(2):
        for q in range(n):
            qc.ry(float(rng.uniform(-3, 3)), q)
        for q in range(n - 1):
            qc.cx(q, q + 1)
    return qc


def mesh_compile(port, Circuit, dev, mesh=None):
    """AdaptCompiler on MPSBackend (complex128, ISL) at MESH_MAX_LAYERS
    layers on mesh_target: (pairs, overlap)."""
    import torch
    np.random.seed(11)
    res = port.AdaptCompiler(
        mesh_target(Circuit), backend=port.MPSBackend(
            device=dev, dtype=torch.complex128, mesh=mesh),
        adapt_config=port.AdaptConfig(max_layers=MESH_MAX_LAYERS)).compile()
    return res.qubit_pair_history, res.overlap


def mesh_compile_rank():
    """One rank of the mesh phase's sharded compile: the (dp, tp) mesh of
    the ranks, mesh_compile on it, and each rank's launches of every
    kernel during it, gathered: (pairs, overlap, launches (ranks, 4) in
    KERNELS' order)."""
    import torch
    import torch.distributed as dist
    import adaptaqc_tpu_torch as port
    from adaptaqc_tpu_torch.circuits.circuit import Circuit
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    from adaptaqc_tpu_torch.ops import env_kernel as envk
    from adaptaqc_tpu_torch.parallel import mesh as pm
    mesh = pm.make_mesh()
    dev = pm.rank_device()
    reset_counts(ek, envk)
    pairs, overlap = mesh_compile(port, Circuit, dev, mesh)
    mine = torch.tensor([[fn.launches for fn in (
        envk.env_chain, ek.tridiag, ek.teig, ek.backtransform)]],
        dtype=torch.float64, device=dev)
    launches = pm.gather_dim(mine, 0, None, dist.get_world_size(),
                             dist.get_rank())
    return dict(mesh=tuple(mesh.shape), pairs=pairs, overlap=overlap,
                launches=launches, backend=dist.get_backend())


def unsharded_mps_step(tape, n, chi, dev):
    """The unsharded engine's Rotoselect sweep of `tape` from |0> at chi on
    dev (complex64), as make_mps_training_step runs it sharded: (cost,
    all-pair RDMs (n, n, 4, 4) as numpy)."""
    from adaptaqc_tpu_torch.backends import mps_core
    from adaptaqc_tpu_torch.optim import sweeps
    zero = mps_core.zero_mps(n, chi, device=dev)
    _, _, cost, state, _, _ = sweeps.sweep(
        mps_core.sweep_engine(0.0), sweeps.default_block_len(
            tape.padded_length, sweeps.state_nbytes(zero)), True, zero,
        mps_core.zero_mps(n, chi, device=dev), tape.kinds, tape.q0,
        tape.q1, tape.angles, tape.trainable)
    return cost, mps_core.all_pair_rdms(state).cpu().numpy()


def mesh_nccl_rank(n, chi):
    """A 1 x 1 mesh on one rank (NCCL on the card): the dry run's MPS step
    (make_mps_training_step) against the unsharded engine's sweep of the
    same tape on the same card."""
    import torch.distributed as dist
    from adaptaqc_tpu_torch.backends import mps_core
    from adaptaqc_tpu_torch.parallel import mesh as pm
    from adaptaqc_tpu_torch.workloads.entry import example_tape
    mesh = pm.make_mesh(1)
    dev = pm.rank_device()
    tape = example_tape(n, 6, seed=1)
    step = pm.make_mps_training_step(mesh, n, chi, tape.padded_length)
    _, _, cost, state, rhos, _ = step(mps_core.zero_mps(n, chi, device=dev),
                                      tape, tape.trainable)
    cost0, rhos0 = unsharded_mps_step(tape, n, chi, dev)
    return dict(mesh=tuple(mesh.shape), backend=dist.get_backend(),
                cost=cost, cost0=cost0,
                rdm_err=float(np.abs(rhos.cpu().numpy() - rhos0).max()),
                shards=tuple(pm.local(state.b).shape))


def mesh_reach_rank(n, chi, f64):
    """One rank of the four-card sweep at chi (MESH_REACH): the (1, 4) mesh;
    the target (hazard_circuit's one layer, CX on MESH_REACH_CX) applied to
    |0> on the shards with K2-K4; one Rotoselect sweep of a short tape
    around the middle bond (reach_peak_sweep's: two RY probes, one CX) from
    the target against |0>; then the swept circuit re-simulated as the
    verifier does, gates^dag |0> against the target, on the sweep's kernel
    path and, in complex64, on the verifier on shards (AdaptCompiler.
    _true_cost_of_gate_circuit: the native eigensolver at its own chi, no
    collective past one site), in complex128 on the native eigensolver on
    the shards at the working chi (the deep re-simulation's way; the
    verifier's chi 8192 does not fit a rank in complex128). Returns this
    rank's peak allocation, its K2-K4 launches and those at m = 2 chi, the
    walls, the costs and the largest collective of the native side,
    gathered over the ranks where they differ."""
    import torch
    import torch.distributed as dist
    from adaptaqc_tpu_torch.backends.backend import MPSBackend
    from adaptaqc_tpu_torch.circuits import gates as G
    from adaptaqc_tpu_torch.circuits.circuit import Circuit
    from adaptaqc_tpu_torch.circuits.tape import compile_tape
    from adaptaqc_tpu_torch.compilers.adapt_compiler import AdaptCompiler
    from adaptaqc_tpu_torch.ops import cplx
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    from adaptaqc_tpu_torch.ops import env_kernel as envk
    from adaptaqc_tpu_torch.optim import sweeps
    from adaptaqc_tpu_torch.parallel import mesh as pm
    from adaptaqc_tpu_torch.parallel import mps_sharded
    import types
    mesh = pm.make_mesh()
    dev = pm.rank_device()
    dt = torch.complex128 if f64 else torch.complex64
    reset_counts(ek, envk)
    torch.cuda.reset_peak_memory_stats()
    walls = {}
    t0 = time.perf_counter()
    tt = compile_tape(hazard_circuit(Circuit, n, 1, MESH_REACH_CX))
    zero = mps_sharded.zero_mps(mesh, n, chi, dt, dev)
    target = mps_sharded.apply_tape(mesh, zero, tt.kinds, tt.q0, tt.q1,
                                    tt.angles, 1e-16)
    torch.cuda.synchronize()
    walls["target"] = time.perf_counter() - t0
    mid = n // 2 - 1
    qc = Circuit(n)
    qc.ry(0.3, mid)
    qc.cx(mid, mid + 1)
    qc.ry(0.2, mid + 1)
    tape = compile_tape(qc)
    t1 = time.perf_counter()
    engine = mps_sharded.sweep_engine(mesh, 1e-16)
    bl = sweeps.default_block_len(tape.padded_length,
                                  sweeps.state_nbytes(zero))
    kinds, angles, cost, state, evals, _ = sweeps.sweep(
        engine, bl, True, target, zero, tape.kinds, tape.q0, tape.q1,
        tape.angles, tape.trainable)
    torch.cuda.synchronize()
    walls["sweep"] = time.perf_counter() - t1
    sweep_peak = torch.cuda.max_memory_allocated()
    del state
    # the swept circuit, re-simulated: kernels, then the verifier
    swept = compile_tape(qc)
    swept.kinds[:] = kinds
    swept.angles[:] = angles
    t1 = time.perf_counter()
    st = mps_sharded.apply_tape_adjoint(mesh, zero, swept.kinds,
                                        swept.q0, swept.q1, swept.angles,
                                        1e-16)
    ov = mps_sharded.mps_dot(mesh, st, target)
    nrm = (float(mps_sharded.mps_dot(mesh, st, st).real)
           * float(mps_sharded.mps_dot(mesh, target, target).real))
    cost_kernels = 1.0 - float(ov.real ** 2 + ov.imag ** 2) / max(nrm,
                                                                 1e-30)
    state_bytes = sweeps.state_nbytes(zero)
    del st
    torch.cuda.synchronize()
    walls["kernels"] = time.perf_counter() - t1
    # every Gram of a sharded two-qubit apply is 2 chi x 2 chi: each of
    # these launches is at m = 2 chi
    launches = {k: fn.launches for k, fn in (
        ("env_chain", envk.env_chain), ("tridiag", ek.tridiag),
        ("teig", ek.teig), ("backtransform", ek.backtransform))}
    t1 = time.perf_counter()
    pm.STATS["max_numel"] = 0
    if f64:
        # the native eigensolver on the shards at the working chi, as the
        # deep re-simulation runs it: the verifier's own chi (8192 at n =
        # 26) in complex128, its Gram's eigh workspace 16 GiB beside two
        # 14 GB states, passes a rank
        vchi = chi
        with cplx.verification_eigh(), pm.payload_cap(2 * chi * chi):
            st = mps_sharded.apply_tape_adjoint(
                mesh, zero, swept.kinds, swept.q0, swept.q1, swept.angles,
                1e-16)
            ov = mps_sharded.mps_dot(mesh, st, target)
            nrm = (float(mps_sharded.mps_dot(mesh, st, st).real)
                   * float(mps_sharded.mps_dot(mesh, target, target).real))
        cost_native = 1.0 - float(ov.real ** 2 + ov.imag ** 2) / max(
            nrm, 1e-30)
        del st, zero, target
    else:
        # the verifier on shards, its target at the verifier's chi on the
        # shards beforehand (the verifier's own pad is then none), the
        # working-chi copy freed
        del zero
        backend = MPSBackend(1e-16, max_chi=chi, device=dev, dtype=dt,
                             mesh=mesh)
        vchi = min(2 * backend.chi_for(n), 2 ** ((n + 1) // 2))
        target = mps_sharded.pad_chi(mesh, target, vchi)
        vqc = Circuit(n)  # set_mps(target), then the swept gates
        vqc.set_mps(target)
        del target
        for k, a, b, ang in zip(swept.kinds.tolist(), swept.q0.tolist(),
                                swept.q1.tolist(), swept.angles.tolist()):
            if k == G.CX:
                vqc.cx(a, b)
            elif k in G.ROTATION_KINDS:
                getattr(vqc, G.KIND_NAMES[k])(ang, a)
        cost_native = AdaptCompiler._true_cost_of_gate_circuit(
            types.SimpleNamespace(backend=backend), vqc)
    torch.cuda.synchronize()
    walls["verifier" if not f64 else "native"] = time.perf_counter() - t1
    walls["total"] = time.perf_counter() - t0
    mine = torch.tensor([[torch.cuda.max_memory_allocated(), sweep_peak,
                          launches["tridiag"], launches["teig"],
                          launches["backtransform"], launches["tridiag"],
                          launches["env_chain"], walls["total"]]],
                        dtype=torch.float64, device=dev)
    ranks = pm.gather_dim(mine, 0, None, dist.get_world_size(),
                          dist.get_rank())
    return dict(mesh=tuple(mesh.shape), backend=dist.get_backend(), n=n,
                chi=chi, f64=f64, ranks=ranks, walls=walls, cost=cost,
                evals=evals, kinds=np.asarray(kinds).tolist(),
                cost_kernels=cost_kernels, cost_native=cost_native,
                verify_max_numel=pm.STATS["max_numel"], verify_chi=vchi,
                state_bytes=state_bytes)


def mesh_reach(dev, card):
    """MESH_REACH on four cards, complex64 then complex128, one launch each
    (a rank's memory freed between them): each rank's peak allocation (the
    whole run's, and the sweep's), its K2-K4 launches (every one at m = 2
    chi), the wall, the sweep's cost and the re-simulation on the kernels
    against the verifier on shards (TOL_MESH_REACH). Returns a record a
    run."""
    from adaptaqc_tpu_torch.parallel import mesh as pm
    out = []
    n = MESH_REACH["n"]
    runs = [(MESH_REACH["chi"], False)]
    while runs:
        chi, f64 = runs.pop(0)
        t0 = time.perf_counter()
        r = pm.launch(mesh_reach_rank, MESH_RANKS, n, chi, f64, device=dev)
        wall = time.perf_counter() - t0
        ranks = np.asarray(r["ranks"])
        peaks = [round(float(p) / 1e9, 3) for p in ranks[:, 0]]
        sweep_peaks = [round(float(p) / 1e9, 3) for p in ranks[:, 1]]
        diff = abs(r["cost_kernels"] - r["cost_native"])
        dname = "complex128" if f64 else "complex64"
        native = ("native eigensolver on shards" if f64
                  else "verifier on shards (native)")
        print(f"mesh: chi={chi} sweep n={n} {dname} over {r['mesh']} "
              f"({r['backend']}, a card a rank): peak allocated a rank "
              f"{peaks} GB (the sweep's {sweep_peaks} GB; a state "
              f"{r['state_bytes'] / 1e9:.3f} GB a rank), K2/K3/K4 launches "
              f"a rank {ranks[:, 2:5].astype(int).tolist()}, K2 at m="
              f"{2 * chi} {ranks[:, 5].astype(int).tolist()}, K1 "
              f"{ranks[:, 6].astype(int).tolist()}; sweep cost "
              f"{r['cost']:.8f} ({r['evals']} evaluations, kinds "
              f"{r['kinds']}); re-simulation kernels {r['cost_kernels']:.8f}"
              f" {native} {r['cost_native']:.8f} |diff| "
              f"{diff:.2e} < {TOL_MESH_REACH} (at chi "
              f"{r['verify_chi']}), its largest collective "
              f"{r['verify_max_numel']} elements (a site "
              f"{2 * r['verify_chi'] ** 2}); "
              f"walls {json.dumps({k: round(v, 1) for k, v in r['walls'].items()})}"
              f" s on rank 0, {wall:.1f} s with the launch on {card}",
              flush=True)
        check(r["mesh"] == (1, MESH_RANKS) and r["backend"] == "nccl",
              f"mesh reach: mesh {r['mesh']} on {r['backend']}")
        check(np.isfinite(r["cost"]) and -1e-6 <= r["cost"] <= 1 + 1e-6,
              f"mesh reach chi={chi}: sweep cost {r['cost']}")
        check(diff < TOL_MESH_REACH,
              f"mesh reach chi={chi} {dname}: kernels {r['cost_kernels']} vs "
              f"{native} {r['cost_native']}")
        check(bool((ranks[:, 5] > 0).all()) and bool((ranks[:, 6] == 0).all()),
              f"mesh reach chi={chi}: K2 at m={2 * chi} "
              f"{ranks[:, 5].tolist()}, K1 {ranks[:, 6].tolist()} a rank")
        check(0 < r["verify_max_numel"] <= 2 * r["verify_chi"] ** 2,
              f"mesh reach: the verifier's largest collective "
              f"{r['verify_max_numel']} past one site")
        out.append(dict(n=n, chi=chi, f64=f64, peaks_gb=peaks,
                        sweep_peaks_gb=sweep_peaks, walls=r["walls"],
                        wall=wall, launches=ranks[:, 2:6].tolist()))
        if not f64:
            peak = float(ranks[:, 1].max())  # the sweep's
            fits = [c for c in MESH_REACH_CHI_F64
                    if 2 * peak * (c / chi) ** 2 <= MESH_REACH_BUDGET]
            print(f"mesh: complex128 at n={n}: the largest chi of "
                  f"{MESH_REACH_CHI_F64} whose sweep's peak scaled from "
                  f"complex64's (2 x {peak / 1e9:.3f} GB x (chi / {chi})^2) "
                  f"fits {MESH_REACH_BUDGET / 1e9:.0f} GB a rank: "
                  f"{fits[0] if fits else None}", flush=True)
            check(bool(fits), "mesh reach: no complex128 chi fits a rank")
            runs.append((fits[0], True))
    return out


def phase_mesh(torch, port, card, dev="cuda"):
    """M7 on the card(s), all at once: MESH_RANKS ranks running the sharded
    MPS compile, one NCCL rank running the MPS step on a 1 x 1 mesh,
    dryrun_multichip on MESH_RANKS more ranks (its four parts and
    assertions, each rank's peak allocation printed), and this process's
    unsharded compile in a thread. Ranks that share the one card go over
    gloo, and the same ranks without backend="gloo" are refused before any
    rank starts; with a card a rank (four cards) they go over NCCL. The
    sharded compile's pair history equals the unsharded one's and its
    overlap is within TOL_MESH_C128; every rank launches K2-K4 and no K1
    (the env-chain kernel does not run under a mesh); the dry run's chi =
    256 step (tp = 4) and the 1 x 1 step agree with the unsharded sweep of
    their tapes on the card to TOL_MESH_C64 in cost and RDMs. With a card a
    rank, then the sweep at chi 8192 (mesh_reach)."""
    from adaptaqc_tpu_torch.circuits.circuit import Circuit
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    from adaptaqc_tpu_torch.ops import env_kernel as envk
    from adaptaqc_tpu_torch.parallel import mesh as pm
    from adaptaqc_tpu_torch.workloads import entry
    t0 = time.perf_counter()
    shared = dev == "cuda" and torch.cuda.device_count() < MESH_RANKS
    gloo = "gloo" if shared else None  # else launch picks (NCCL on cards)
    if shared:
        try:
            pm.resolve_backend(MESH_RANKS, "cuda", None)
            refused = False
        except ValueError:
            refused = True
        check(refused, "mesh: ranks sharing the card were not refused "
              "without backend='gloo'")
    import threading
    sharded = pm.launch(mesh_compile_rank, MESH_RANKS, device=dev,
                        backend=gloo, wait=False)
    one = pm.launch(mesh_nccl_rank, 1, MESH_STEP["n"], MESH_STEP["chi"],
                    device=dev, wait=False)
    box = {}

    def unsharded():  # beside the dry run, which waits on its ranks
        try:
            reset_counts(ek, envk)
            box["res"] = mesh_compile(port, Circuit, dev)
            box["k1"] = envk.env_chain.launches
        except BaseException as exc:  # re-raised below
            box["exc"] = exc

    thread = threading.Thread(target=unsharded)
    thread.start()
    d = entry.dryrun_multichip(MESH_RANKS, device=dev, backend=gloo)
    t_dry = time.perf_counter() - t0
    thread.join()
    if "exc" in box:
        raise box["exc"]
    tp = d["mps"]["chi"] // d["mps"]["shards"][-1]
    check(tp > 1 and d["mps"]["shards"][:3] == (6, 2, d["mps"]["chi"]),
          f"mesh: the dry run's MPS shards {d['mps']['shards']}")
    big = d["mps_big"]
    t1 = time.perf_counter()
    bcost0, brhos0 = unsharded_mps_step(big["tape"], big["shards"][0],
                                        big["chi"], dev)
    t_big = time.perf_counter() - t1
    big_cost_err = abs(big["cost"] - bcost0)
    big_rdm_err = float(np.abs(big["rhos"] - brhos0).max())
    (pairs0, overlap0), k1_unsharded = box["res"], box["k1"]
    got, nccl = sharded.result(), one.result()
    t_compile = time.perf_counter() - t0
    launches = np.asarray(got["launches"])
    print(f"mesh: dryrun_multichip({MESH_RANKS}, backend={gloo!r}) passed "
          f"on {d['platform']}: SV step cost {d['sv']['cost']:.6f}, MPS "
          f"shards {d['mps']['shards']} and {d['mps_big']['shards']}, "
          f"sharded-only SV n={d['sv_big']['n']} {d['sv_big']['shard_bytes']}"
          f" bytes a rank (budget {d['sv_big']['budget']}), peak allocated a "
          f"rank {[round(p / 2 ** 20, 1) for p in d['sv_big']['peaks']]} MB, "
          f"{d['collectives']['collectives']} collectives on rank 0; "
          f"{t_dry:.1f} s (beside the compile's ranks); its chi="
          f"{big['chi']} step (tp {big['chi'] // big['shards'][-1]}) cost "
          f"{big['cost']:.8f} vs unsharded {bcost0:.8f} (|diff| "
          f"{big_cost_err:.2e}), RDMs max |diff| {big_rdm_err:.2e} "
          f"(unsharded {t_big:.1f} s); "
          + ("without backend='gloo' refused before any rank started "
             if shared else "NCCL, a card a rank ") + f"on {card}",
          flush=True)
    print(f"mesh: sharded compile ({got['backend']}, mesh {got['mesh']}, "
          f"complex128, {MESH_MAX_LAYERS} layers) pairs {got['pairs']} "
          f"overlap {got['overlap']!r}, unsharded pairs {pairs0} overlap "
          f"{overlap0!r} (|diff| {abs(got['overlap'] - overlap0):.2e}); "
          f"launches a rank (env_chain, tridiag, teig, "
          f"backtransform) {launches.astype(int).tolist()}, unsharded K1 "
          f"{k1_unsharded}; 1 x 1 {nccl['backend']} mesh MPS step cost "
          f"{nccl['cost']:.8f} vs unsharded {nccl['cost0']:.8f}, RDMs "
          f"{nccl['rdm_err']:.2e}, shards {nccl['shards']}; "
          f"{t_compile:.1f} s in all on {card}", flush=True)
    check([tuple(p) for p in got["pairs"]] == [tuple(p) for p in pairs0],
          f"mesh: sharded pairs {got['pairs']} != unsharded {pairs0}")
    check(abs(got["overlap"] - overlap0) < TOL_MESH_C128,
          f"mesh: sharded overlap {got['overlap']} vs {overlap0}")
    check(big["chi"] // big["shards"][-1] == tp and
          big_cost_err < TOL_MESH_C64 and big_rdm_err < TOL_MESH_C64,
          f"mesh: the dry run's chi={big['chi']} step differs from the "
          f"unsharded sweep: cost {big_cost_err}, RDMs {big_rdm_err}")
    check(bool((launches[:, 0] == 0).all()),
          f"mesh: K1 launched under the mesh: {launches.tolist()}")
    check(bool((launches[:, 1:] > 0).all()),
          f"mesh: a rank launched no K2-K4: {launches.tolist()}")
    check(nccl["mesh"] == (1, 1) and (dev != "cuda"
                                      or nccl["backend"] == "nccl"),
          f"mesh: the one-rank mesh {nccl['mesh']} on {nccl['backend']}")
    check(abs(nccl["cost"] - nccl["cost0"]) < TOL_MESH_C64
          and nccl["rdm_err"] < TOL_MESH_C64,
          f"mesh: the 1 x 1 step differs from the unsharded sweep: {nccl}")
    if not shared and dev == "cuda":  # a card a rank: past one card's reach
        mesh_reach(dev, card)
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    import adaptaqc_tpu_torch as port
    from adaptaqc_tpu_torch.backends import mps_core
    from adaptaqc_tpu_torch.circuits.circuit import Circuit
    from adaptaqc_tpu_torch.circuits.tape import compile_tape
    from adaptaqc_tpu_torch.ops import cplx, cuda_lib
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    from adaptaqc_tpu_torch.ops import env_kernel as envk
    from adaptaqc_tpu_torch.optim import sweeps

    print(f"chip_smoke: TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn TF32 {torch.backends.cudnn.allow_tf32}", flush=True)
    card = gpu_line()
    counted = {"env_chain": envk.env_chain, "tridiag": ek.tridiag,
               "teig": ek.teig, "backtransform": ek.backtransform}
    only = parse_only(sys.argv[1:])

    def wanted(name):
        return only is None or name in only

    walls, last = {}, [time.perf_counter()]

    def done(name):  # the wall seconds of the phase that just ended
        now = time.perf_counter()
        walls[name] = round(now - last[0], 1)
        last[0] = now

    phase_device(torch, cuda_lib)
    done("device")
    rec = launches = batched = wide = f64 = reach = None
    if wanted("kernels"):
        rec = phase_kernels(torch, ek, envk, cplx, card,
                            sweep_probe_sites(Circuit, compile_tape),
                            sweep_eigh_inputs(torch, ek, mps_core, sweeps,
                                              Circuit, compile_tape),
                            spin_probe_inputs(torch, port, ek),
                            center_engine_inputs(torch, ek),
                            sweep128_inputs=sweep_eigh_inputs(
                                torch, ek, mps_core, sweeps, Circuit,
                                compile_tape, chi=128))
        done("kernels")
    if wanted("hazard"):
        for chi in (64, 128):
            phase_hazard(torch, mps_core, Circuit, compile_tape, card, chi)
        done("hazard")
    if wanted("slice"):
        launches = phase_slice(torch, port, counted, card)
        done("slice")
    if wanted("sweep"):
        phase_sweep(torch, mps_core, sweeps, Circuit, compile_tape, card)
        phase_sweep(torch, mps_core, sweeps, Circuit, compile_tape, card,
                    chi=128, ek=ek, envk=envk)
        done("sweep")
    if wanted("sv") or wanted("sampling"):
        target_state = phase_sv(torch, port, card)
        done("sv")
        if wanted("sampling"):
            phase_sampling(torch, port, target_state, card)
            done("sampling")
        del target_state
    if wanted("isl_mps"):
        phase_isl_mps(torch, port, counted, card)
        done("isl_mps")
    if wanted("spin"):
        batched = phase_spin(torch, port, counted, card)
        done("spin")
    if wanted("ladder"):
        wide = phase_ladder(torch, port, card)
        done("ladder")
    if wanted("reach"):
        reach = phase_reach(torch, mps_core, sweeps, Circuit, compile_tape,
                            ek, envk, card, port, cplx)
        done("reach")
    if wanted("optim"):
        f64 = phase_optim(torch, port, card)
        done("optim")
    if wanted("zigzag"):
        phase_zigzag(torch, mps_core, sweeps, compile_tape, ek, envk, card)
        phase_zigzag(torch, mps_core, sweeps, compile_tape, ek, envk, card,
                     chi=128, full=False)
        done("zigzag")
    if wanted("workloads"):
        phase_workloads(torch, card)
        done("workloads")
    if wanted("refine"):
        import shutil
        if not wanted("workloads"):  # alone: it makes its own records
            shutil.rmtree(workloads_dir(), ignore_errors=True)
        phase_refine(torch, card, workloads_dir())
        done("refine")
    if wanted("workloads") or wanted("refine"):
        import shutil
        shutil.rmtree(workloads_dir(), ignore_errors=True)
    if wanted("mesh"):
        phase_mesh(torch, port, card)
        done("mesh")
    print(f"chip_smoke: wall seconds by phase {json.dumps(walls)}, "
          f"{sum(walls.values()):.1f} in all", flush=True)

    if only is not None:
        # some phases only: no result lines (the full run prints them)
        print(f"chip_smoke: phases {sorted(only)} passed on {card}")
        return 0
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches[name],
                            **rec[name]))
    for name, count in batched.items():  # the batched shapes: spin phase
        source, replaces = KERNELS[name]
        kernels.append(dict(name=f"{name}[batched]", route="cuda",
                            source=source, replaces=replaces, launches=count,
                            **rec[f"{name}[batched]"]))
    for name, count in wide.items():  # the wide variants: chi schedule
        replaces = KERNELS[name][1]
        kernels.append(dict(name=f"{name}[wide]", route="cuda",
                            source=kernel_source(name, "wide"),
                            replaces=replaces, launches=count,
                            **rec[f"{name}[wide]"]))
    for name, count in f64.items():  # complex128: the optim phase's compile
        replaces = KERNELS[name][1]
        kernels.append(dict(name=f"{name}[f64]", route="cuda",
                            source=kernel_source(name, "f64"),
                            replaces=replaces, launches=count,
                            **rec[f"{name}[f64]"]))
    reach_rec, reach_launches, rows, peak = reach
    for name, v in rows:  # the reach phase
        replaces = KERNELS[name][1]
        kernels.append(dict(
            name=f"{name}[{v}]", route="cuda", source=kernel_source(name, v),
            replaces=replaces, launches=reach_launches[name][v],
            **reach_rec[f"{name}[{v}]"]))
    # K4's strip route (complex64 past m = 5888, complex128 past 2816): its
    # launches on the reach phase's chi = 4096 sweep, its times at the cap
    for f64, name in ((False, "backtransform[strip]"),
                      (True, "backtransform[strip_f64]")):
        cap = max(REACH_M_F64 if f64 else REACH_M)
        top = reach_rec[f"backtransform[{REACH_VARIANTS[f64]}]"]["by_m"][cap]
        kernels.append(dict(
            name=name, route="cuda", source=BT_STRIP_SOURCE,
            replaces=KERNELS["backtransform"][1],
            launches=peak["complex128" if f64 else "complex64"][2],
            shape=f"m={cap}, keep={cap // 2}"
                  + (", complex128" if f64 else ""),
            library_call="torch.ormqr(v in geqrf layout, tau, z[1:, :keep])",
            plain_cols=top.get("plain_cols", cap // 2),
            **{k: top[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


PHASES = ("kernels", "hazard", "slice", "sweep", "sv", "sampling", "isl_mps",
          "spin", "ladder", "reach", "optim", "zigzag", "workloads", "refine",
          "mesh")


def parse_only(argv):
    """`--only a,b`: run the device phase and these phases alone (no result
    lines: those belong to the whole run, which takes no arguments)."""
    if not argv:
        return None
    if len(argv) != 2 or argv[0] != "--only":
        raise SystemExit("usage: python3 chip_smoke.py [--only "
                         + ",".join(PHASES) + "]")
    only = set(argv[1].split(","))
    if not only <= set(PHASES):
        raise SystemExit(f"unknown phases {sorted(only - set(PHASES))}; "
                         f"choose from {PHASES}")
    return only


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
