"""Drive the PyTorch port (adaptaqc_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Builds the package's CUDA kernels from adaptaqc_tpu_torch/csrc with nvcc
(sm_90a) and runs five phases, each printing one line that starts with its
name; any failure exits non-zero:

  device    torch / CUDA versions, the card's name and power limit, build s
  kernels   every kernel against its plain PyTorch version on the card at
            the main path's shapes, with both times; the eigensolver also
            against float64 on a 7-decade spectrum
  hazard    a deep two-qubit-chain re-simulation at n=50, chi=64 under
            eigh="kernels" and eigh="native": overlaps agree to 1e-3
  slice     AdaptCompiler on the synthetic 50-qubit random-MPS target
            (chi=32, general_gradient, identity_resolvable layers,
            product-state start, linear map), a few layers, with every
            kernel's launch count from that run (each must be > 0); then a
            full compile at n=10 to overlap > 0.99
  sweep     one Rotoselect sweep at bench.py's shape (n=50, chi=64, a
            window of 12 dressed-CNOT layers): ms/sweep and evals/s

The second-to-last line is one JSON object with a record per kernel, the
line before it the card's name and power limit from nvidia-smi, and the
last line {"ok": true, "device": {...}}. Without a CUDA card, or without
the package beside this script, it exits non-zero and prints no result.
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


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def gpu_line():
    """`name, power.limit` of the card as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    check(out.returncode == 0 and lines,
          f"nvidia-smi gave no card name and power limit: {out.stderr}")
    return lines[0]


def cuda_ms(fn, reps, torch):
    """Mean milliseconds per call over `reps` calls, CUDA events."""
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
def _gram_cases(m, rng):
    """Normalised thetas (||theta|| = 1, as every MPS bond update sees)
    whose Grams span the spectrum classes of the eigensolver tests."""
    cases = {}
    a = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
    cases["rand"] = a / np.linalg.norm(a)
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


def phase_kernels(torch, ek, envk, cplx):
    dev = torch.device("cuda")
    rng = np.random.default_rng(2026)
    rec = {k: {"max_abs_err": None, "ms": None, "plain_ms": None}
           for k in KERNELS}
    worst = {"env_chain": 0.0, "tridiag": 0.0, "tridiag_factors": 0.0,
             "teig": 0.0,
             "backtransform": 0.0, "chain_w": 0.0, "ortho": 0.0,
             "resid": 0.0}
    # K1: n = 50 chains at chi 32 (the compile) and 64 (bench.py's sweep)
    for chi in (32, 64):
        n = 50
        g = torch.Generator(device="cpu").manual_seed(chi)
        scale = (2.0 * chi) ** -0.5
        # a ket close to the bra keeps C of order one over 50 sites, as the
        # probes of a converging sweep see it (independent random tensors
        # make the chains decay to ~1e-11)
        br = torch.randn(n, 2, chi, chi, generator=g,
                         dtype=torch.complex64) * scale
        bl = br + 0.1 * scale * torch.randn(n, 2, chi, chi, generator=g,
                                            dtype=torch.complex64)
        br, bl = br.to(dev), bl.to(dev)
        for q in (0, 17, 49):
            c = envk.env_chain(br, bl, q)
            cp = envk.env_chain_plain(br, bl, q)
            err = float((c - cp).abs().max())
            rel = err / max(float(cp.abs().max()), 1e-30)
            worst["env_chain"] = max(worst["env_chain"], rel)
            check(rel < TOL_ENV_REL, f"env_chain chi={chi} q={q} rel {rel}")
            if chi == 32 and q == 17:
                rec["env_chain"]["max_abs_err"] = err
        ms = cuda_ms(lambda: envk.env_chain(br, bl, 25), 20, torch)
        pms = cuda_ms(lambda: envk.env_chain_plain(br, bl, 25), 3, torch)
        print(f"kernels: env_chain n=50 chi={chi} q=25 kernel {ms:.4f} ms "
              f"plain {pms:.4f} ms", flush=True)
        if chi == 32:
            rec["env_chain"]["ms"], rec["env_chain"]["plain_ms"] = ms, pms

    # K2-K4 on every spectrum class, m = 4 .. 128
    for m in (4, 16, 64, 128):
        for name, th in _gram_cases(m, rng).items():
            t = torch.tensor(th, dtype=torch.complex64, device=dev)
            h = t.mH @ t
            hh = ((h + h.mH) * 0.5).contiguous()
            v, tau, d, e = ek.tridiag(hh)
            vp, taup, dp, ep = ek.tridiag_plain(hh)
            # the kernel's own factorisation: Q unitary, Q T Q^H = H (a
            # reflector's sign is a free choice where Re(alpha) ~ 0, so
            # factors are compared with the plain version's only on "rand")
            q = ek.backtransform_plain(
                v.to(torch.complex128), tau.to(torch.complex128),
                torch.eye(m, dtype=torch.float64, device=dev), m)
            d64, e64 = d.double(), e[:-1].double()
            tm = torch.diag(d64) + torch.diag(e64, 1) + torch.diag(e64, -1)
            h64 = hh.to(torch.complex128)
            hscale = max(float(h64.abs().max()), 1e-30)
            err_t = max(float((q @ q.mH - torch.eye(m, device=dev)).abs().max()),
                        float((q @ tm.to(q.dtype) @ q.mH - h64).abs().max())
                        / hscale)
            worst["tridiag"] = max(worst["tridiag"], err_t)
            check(err_t < TOL_TRIDIAG_REL,
                  f"tridiag m={m} {name}: rel {err_t}")
            if name == "rand":
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
            err_z = float((z - zp).abs().max())
            worst["teig"] = max(worst["teig"], err_w)
            check(err_w < TOL_TEIG_W_REL and err_z < TOL_VEC,
                  f"teig m={m} {name}: w {err_w} z {err_z}")
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
            if m == 64 and name == "rand":
                rec["tridiag"]["max_abs_err"] = max(
                    float((d - dp).abs().max()), float((e - ep).abs().max()),
                    float((tau - taup).abs().max()))
                rec["teig"]["max_abs_err"] = max(
                    float((w - wp).abs().max()), err_z)
                rec["backtransform"]["max_abs_err"] = err_b
        if m in (64, 128):
            th = _gram_cases(m, rng)["rand"]
            t = torch.tensor(th, dtype=torch.complex64, device=dev)
            hh = ((t.mH @ t + (t.mH @ t).mH) * 0.5).contiguous()
            vp, taup, dp, ep = ek.tridiag_plain(hh)
            wp, zp = ek.teig_plain(dp, ep)
            times = {
                "tridiag": (lambda: ek.tridiag(hh),
                            lambda: ek.tridiag_plain(hh)),
                "teig": (lambda: ek.teig(dp, ep),
                         lambda: ek.teig_plain(dp, ep)),
                "backtransform": (
                    lambda: ek.backtransform(vp, taup, zp, m // 2),
                    lambda: ek.backtransform_plain(vp, taup, zp, m // 2)),
            }
            parts = []
            for kname, (kfn, pfn) in times.items():
                ms = cuda_ms(kfn, 20, torch)
                pms = cuda_ms(pfn, 2, torch)
                parts.append(f"{kname} kernel {ms:.4f} ms plain {pms:.4f} ms")
                if m == 64:
                    rec[kname]["ms"], rec[kname]["plain_ms"] = ms, pms
            print(f"kernels: m={m} " + "; ".join(parts), flush=True)

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
          f"rel {worst['teig']:.2e} < {TOL_TEIG_W_REL}, backtransform "
          f"{worst['backtransform']:.2e} < {TOL_BT}; chain vs float64: w "
          f"{worst['chain_w']:.2e} < {TOL_CHAIN_W}, ortho {worst['ortho']:.2e}"
          f" < {TOL_ORTHO}, resid {worst['resid']:.2e} < {TOL_RESID}; "
          f"7-decade spectra vs float64: teig w {t_worst:.2e} < {TOL_T64}, "
          f"kept s {s_worst:.2e} and action {act_worst:.2e} < {TOL_S64})",
          flush=True)
    return rec


# ---------------------------------------------------------------- phase 3
def phase_hazard(torch, mps_core, Circuit, compile_tape):
    """(C^dag C)|0> at n = 50, chi = 64 for a deep random two-qubit chain
    C; |<0|psi>|^2 / <psi|psi> under both eigensolvers."""
    n, chi, layers = 50, 64, 8
    rng = np.random.default_rng(7)
    qc = Circuit(n)
    for layer in range(layers):
        for q in range(n):
            qc.ry(float(rng.uniform(-0.6, 0.6)), q)
            qc.rz(float(rng.uniform(-0.6, 0.6)), q)
        for q in range(layer % 2, n - 1, 2):
            qc.cx(q, q + 1)
    tape = compile_tape(qc)
    n2q = int(np.sum(tape.kinds == 4))
    dev = torch.device("cuda")
    out = {}
    for eigh in ("kernels", "native"):
        t0 = time.perf_counter()
        st = mps_core.zero_mps(n, chi, torch.complex64, dev)
        st = mps_core.apply_tape(st, tape.kinds, tape.q0, tape.q1,
                                 tape.angles, 1e-16, eigh=eigh)
        st = mps_core.apply_tape_adjoint(st, tape.kinds, tape.q0, tape.q1,
                                         tape.angles, 1e-16, eigh=eigh)
        cost = float(mps_core.global_cost_normalized(st))
        torch.cuda.synchronize()
        out[eigh] = (1.0 - cost, float(st.trunc), time.perf_counter() - t0)
    diff = abs(out["kernels"][0] - out["native"][0])
    print(f"hazard: n={n} chi={chi} {2 * n2q} two-qubit applies: overlap "
          f"kernels {out['kernels'][0]:.8f} native {out['native'][0]:.8f} "
          f"|diff| {diff:.2e} < {TOL_HAZARD}; discarded weight kernels "
          f"{out['kernels'][1]:.3e} native {out['native'][1]:.3e}; wall "
          f"kernels {out['kernels'][2]:.2f} s native {out['native'][2]:.2f} s",
          flush=True)
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


def phase_slice(torch, port, counted):
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
          + f", launches {json.dumps(launches)}", flush=True)
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
          f"{result.num_2q_gates} two-qubit gates", flush=True)
    check(result.overlap > 0.99, f"n=10 compile overlap {result.overlap}")
    check(abs(check_ov - result.overlap) < 1e-3,
          f"n=10 independent overlap {check_ov} vs {result.overlap}")
    return launches


# ---------------------------------------------------------------- phase 5
def phase_sweep(torch, mps_core, sweeps, Circuit, compile_tape, card):
    """bench.py's workload: a 3-layer random-entangling 50-qubit target at
    chi = 64 and a window of 12 dressed-CNOT layers, one Rotoselect sweep."""
    n, chi, window = 50, 64, 12
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    target = Circuit(n)
    for q in range(n):
        target.ry(float(rng.uniform(-3, 3)), q)
    for layer in range(3):
        for q in range(layer % 2, n - 1, 2):
            target.cx(q, q + 1)
        for q in range(n):
            target.rz(float(rng.uniform(-3, 3)), q)
    tt = compile_tape(target)
    prefix = mps_core.apply_tape(mps_core.zero_mps(n, chi, torch.complex64,
                                                   dev),
                                 tt.kinds, tt.q0, tt.q1, tt.angles, 1e-16)
    ansatz = Circuit(n)
    for _ in range(window):
        a = int(rng.integers(n - 1))
        ansatz.rz(0.1, a)
        ansatz.rz(0.1, a + 1)
        ansatz.cx(a, a + 1)
        ansatz.rz(0.1, a)
        ansatz.rz(0.1, a + 1)
    at = compile_tape(ansatz)
    engine = mps_core.sweep_engine(1e-16)
    ref = mps_core.zero_mps(n, chi, torch.complex64, dev)
    bl = sweeps.default_block_len(at.padded_length, sweeps.state_nbytes(ref))
    args = (engine, bl, True, prefix, ref, at.kinds, at.q0, at.q1, at.angles,
            at.trainable)
    _, syncs = count_syncs(torch, lambda: sweeps.sweep(*args))  # warm-up
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        _, _, cost, _, evals, ov2 = sweeps.sweep(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"sweep: n={n} chi={chi} {window} layers ({int(at.trainable.sum())} "
          f"probes, {int(np.sum(at.kinds == 4))} CX, block {bl}): "
          f"{ms:.2f} ms/sweep, {evals / (ms / 1e3):.1f} evals/s, {syncs} "
          f"host syncs/sweep, final |<0|psi>|^2 {ov2:.3e} on {card}",
          flush=True)
    check(np.isfinite(cost) and np.isfinite(ms), "sweep produced no number")


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
    phase_device(torch, cuda_lib)
    rec = phase_kernels(torch, ek, envk, cplx)
    phase_hazard(torch, mps_core, Circuit, compile_tape)
    launches = phase_slice(torch, port, counted)
    phase_sweep(torch, mps_core, sweeps, Circuit, compile_tape, card)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches[name],
                            **rec[name]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
