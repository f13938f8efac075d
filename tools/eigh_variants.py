"""Design choices of the tridiag (K2) and backtransform (K4) kernels, timed
on one CUDA card: builds of csrc/eigh_tridiag.cu with one choice changed.

    python3 tools/eigh_variants.py

  tridiag        the rows a thread holds (a template parameter picked by
                 m): the build's choice against 16 rows at every m, on a
                 random Gram at m = 32, 64 and 128; the rank-2 update
                 rounded as written (A exactly Hermitian) against one
                 with FMA contraction: active steps and time on the 24
                 Grams of one bench.py sweep; the norm of tiny columns
                 scaled against unscaled: Q's distance from unitary and
                 Q T Q^H - H on padded Grams (a rank-r theta with the
                 zero pattern of a two-qubit apply) and the sweep's Grams
  backtransform  output columns a CTA (kBtCols = 4, 8, 16) on random
                 reflectors at m = 64 and 128 (keep = m/2) and on the
                 inputs of one bench.py sweep

Each build is checked against the plain version before it is timed (CUDA
events). The builds go to tools/_build/, a git-ignored directory.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "tools", "_build")
SRC = os.path.join(ROOT, "adaptaqc_tpu_torch", "csrc", "eigh_tridiag.cu")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

ROWS16 = [("  if (m <= kTriGroups * 4)\n", "  if (false)\n"),
          ("  else if (m <= kTriGroups * 8)\n", "  else if (false)\n")]
BT_COLS = "constexpr int kBtCols = 8;    // output columns of one CTA"
# the update's arithmetic with the compiler free to contract it into FMAs
FMA_UPDATE = [('#include "common.cuh"\n',
               '#include "common.cuh"\n#define __fadd_rn(a, b) ((a) + (b))\n'
               '#define __fsub_rn(a, b) ((a) - (b))\n'
               '#define __fmul_rn(a, b) ((a) * (b))\n')]
UNSCALED = [("ss < kTinySquares ? scaled_norm(C, k, m, lane) : sqrtf(ss)",
             "sqrtf(ss)")]


def padded_gram(m, r, seed):
    """theta^H theta, symmetrised, for a rank-r theta (m x m) whose columns
    (q, b) are zero for the right-bond index b >= r, as mps_core's
    two-qubit apply leaves them."""
    rng = np.random.default_rng(seed)
    chi = m // 2
    x = rng.standard_normal((m, r)) + 1j * rng.standard_normal((m, r))
    y = (rng.standard_normal((r, 2, chi))
         + 1j * rng.standard_normal((r, 2, chi)))
    y[:, :, r:] = 0.0
    th = x @ y.reshape(r, m)
    t = torch.tensor(th / np.linalg.norm(th), dtype=torch.complex64,
                     device="cuda")
    h = t.mH @ t
    return ((h + h.mH) * 0.5).contiguous()


def factor_errors(run, h):
    """(max |Q Q^H - I|, max |Q T Q^H - H| / max |H|) of the build's
    factors of h, in float64."""
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    m = h.shape[0]
    v, tau, d, e = run(h)
    q = ek.backtransform_plain(v.to(torch.complex128),
                               tau.to(torch.complex128),
                               torch.eye(m, dtype=torch.float64,
                                         device=h.device), m)
    t = (torch.diag(d.double()) + torch.diag(e[:-1].double(), 1)
         + torch.diag(e[:-1].double(), -1)).to(q.dtype)
    h64 = h.to(torch.complex128)
    eye = torch.eye(m, dtype=q.dtype, device=h.device)
    return (float((q @ q.mH - eye).abs().max()),
            float((q @ t @ q.mH - h64).abs().max() / h64.abs().max()))


def build(tag, edits):
    from adaptaqc_tpu_torch.ops.cuda_lib import NVCC_FLAGS, _nvcc
    text = open(SRC).read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{tag}: marker not found: {old!r}")
        text = text.replace(old, new, 1)
    os.makedirs(BUILD, exist_ok=True)
    cu = os.path.join(BUILD, f"variant_{tag}.cu")
    with open(cu, "w") as f:
        f.write(text)
    so = os.path.join(BUILD, f"libvariant_{tag}.so")
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", os.path.dirname(SRC), "-o",
                    so, cu], check=True)
    return ctypes.CDLL(so)


def main():
    if not torch.cuda.is_available():
        print("eigh_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import stage_clocks as sc
    from adaptaqc_tpu_torch.ops import eigh_kernels as ek
    print(f"eigh_variants: on {cs.gpu_line()}", flush=True)
    inputs = sc.sweep_inputs()
    grams = [a[0] for a in inputs["tridiag"]]
    runs = {}
    for tag, edits in (("rows_by_m", []), ("rows16", ROWS16)):
        run = runs[tag] = sc.tridiag_runner(build(tag, edits))
        parts = []
        for m in (32, 64, 128):
            h = sc.random_gram(m)
            d = run(h)[2]
            err = float((d - ek.tridiag_plain(h)[2]).abs().max())
            cs.check(err < 1e-4, f"tridiag {tag} m={m}: d off by {err}")
            parts.append(f"m={m} {cs.cuda_ms(lambda: run(h), 20, torch):.4f}")
        print(f"tridiag {tag}: " + ", ".join(parts) + " ms", flush=True)
    runs["fma_update"] = sc.tridiag_runner(build("fma_update", FMA_UPDATE))
    for tag in ("rows_by_m", "fma_update"):
        run = runs[tag]
        active = np.mean([int((run(h)[3][:-1] != 0).sum()) for h in grams])
        ms = np.mean([cs.cuda_ms(lambda: run(h), 10, torch) for h in grams])
        worst = max(max(factor_errors(run, h)) for h in grams)
        print(f"tridiag {tag} on the sweep's {len(grams)} Grams: {active:.1f}"
              f" active steps of {grams[0].shape[0] - 1} a Gram, {ms:.4f} ms,"
              f" worst factor error {worst:.1e}", flush=True)
    runs["unscaled_norm"] = sc.tridiag_runner(build("unscaled_norm",
                                                    UNSCALED))
    cases = [(f"padded m={m} r={m // 16}", padded_gram(m, m // 16, m))
             for m in (64, 128)]
    cases.append((f"the sweep's {len(grams)} Grams", None))
    for tag in ("rows_by_m", "unscaled_norm"):
        parts = []
        for label, h in cases:
            errs = [factor_errors(runs[tag], g)
                    for g in ([h] if h is not None else grams)]
            parts.append(f"{label}: |QQ^H - I| {max(e[0] for e in errs):.1e},"
                         f" QTQ^H {max(e[1] for e in errs):.1e}")
        print(f"tridiag {tag}: " + "; ".join(parts), flush=True)
    sweep = inputs["backtransform"]
    rand = []
    for m in (64, 128):
        vp, taup, dp, ep = ek.tridiag_plain(sc.random_gram(m))
        rand.append((vp, taup, ek.teig_plain(dp, ep)[1], m // 2))
    for cols in (4, 8, 16):
        bt = sc.backtransform_runner(build(
            f"bt_cols{cols}",
            [(BT_COLS, f"constexpr int kBtCols = {cols};")]))
        for args in rand + sweep:
            err = float((bt(*args) - ek.backtransform_plain(*args))
                        .abs().max())
            cs.check(err < cs.TOL_BT, f"backtransform cols={cols}: {err}")
        times = [cs.cuda_ms(lambda: bt(*a), 20, torch) for a in rand]
        sw = np.mean([cs.cuda_ms(lambda: bt(*a), 10, torch) for a in sweep])
        print(f"backtransform {cols} columns a CTA: random m=64 "
              f"{times[0]:.4f}, m=128 {times[1]:.4f} ms; the sweep's "
              f"{len(sweep)} inputs {sw:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
