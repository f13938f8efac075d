"""The native verifier's eigensolver routes on the Grams of a deep
re-simulation at chi = 1024 (m = 2048), on one CUDA card.

    python3 tools/verifier_routes.py [--layers 2] [--grams 3] [--out FILE]

Runs chip_smoke's deep re-simulation tape (n = 50, brickwork layers of
two-qubit gates) at chi = 1024 under eigh="kernels", keeping every theta
that svd_trunc truncates at m = 2048. On every kept Gram H = theta^H theta it
tries torch.linalg.eigh in complex128 (the verifier's route before it was
repaired: does cuSOLVER converge?); on the first --grams of them that fail
(and one that converges), and on each such Gram turned by a random unitary,
and on a full-rank random Gram at m = 2048, every candidate route:

  eigh_c128    torch.linalg.eigh(H) in complex128
  drop_zero    the same on H without its exactly zero rows and columns
  split_zero   the same on H with distinct negative diagonal entries in
               place of the zeros of its exactly zero rows and columns
  embed_f64    torch.linalg.eigh of the real embedding [[A, -B], [B, A]]
               in float64 (the JAX package's `embed` route)
  svd_<driver> torch.linalg.svd(theta, driver=...) in complex128, for
               gesvd, gesvdj and gesvda

For each: whether it converged, ms per call (CUDA events, after a warm-up
call), the kept eigenvectors' orthonormality, and the residual of H V = V W
relative to max |w| over the columns of non-negligible eigenvalue. Prints one
line per Gram and candidate and writes them as JSON to FILE.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

C128 = torch.complex128


def record_thetas(layers, chi=1024, n=50):
    """The deep re-simulation's thetas at m = 2 chi (complex64, on the
    card), in call order."""
    import chip_smoke as cs
    from adaptaqc_tpu_torch.backends import mps_core
    from adaptaqc_tpu_torch.circuits.circuit import Circuit
    from adaptaqc_tpu_torch.circuits.tape import compile_tape
    from adaptaqc_tpu_torch.ops import cplx
    kept = []
    orig = cplx.svd_trunc

    def recording(theta, chi_keep, threshold, eigh=None):
        if theta.shape[-1] == 2 * chi and theta.dim() == 2:
            kept.append(theta.clone())
        return orig(theta, chi_keep, threshold, eigh)

    cplx.svd_trunc = recording
    try:
        rng = np.random.default_rng(7)  # chip_smoke.phase_hazard's tape
        qc = Circuit(n)
        for layer in range(layers):
            for q in range(n):
                qc.ry(float(rng.uniform(-0.6, 0.6)), q)
                qc.rz(float(rng.uniform(-0.6, 0.6)), q)
            for q in range(layer % 2, n - 1, 2):
                qc.cx(q, q + 1)
        tape = compile_tape(qc)
        st = mps_core.zero_mps(n, chi, torch.complex64, torch.device("cuda"))
        st = mps_core.apply_tape(st, tape.kinds, tape.q0, tape.q1,
                                 tape.angles, 1e-16, eigh="kernels")
        mps_core.apply_tape_adjoint(st, tape.kinds, tape.q0, tape.q1,
                                    tape.angles, 1e-16, eigh="kernels")
        torch.cuda.synchronize()
    finally:
        cplx.svd_trunc = orig
    del cs
    return kept


def embed(h):
    a, b = h.real, h.imag
    return torch.cat([torch.cat([a, -b], 1), torch.cat([b, a], 1)], 0)


def split_zero(h):
    """H with each exactly zero row and column's diagonal entry set to a
    distinct negative value below the spectrum: exact for the rest."""
    zero = (h == 0).all(dim=-1)
    scale = h.abs().max().clamp(min=1e-300)
    ramp = -(1.0 + torch.arange(h.shape[-1], device=h.device,
                                dtype=h.real.dtype)) * scale
    return h + torch.diag_embed(torch.where(zero, ramp, 0).to(h.dtype))


def candidates(theta):
    """name -> a function of nothing giving (w descending, V columns) of
    H = theta^H theta (complex128), or raising."""
    h = theta.mH @ theta
    m = h.shape[-1]

    def eig(x):
        w, v = torch.linalg.eigh(x)
        return w.flip(-1), v.flip(-1)

    def drop():
        nz = torch.nonzero((h != 0).any(dim=-1)).flatten()
        w, v = torch.linalg.eigh(h[nz][:, nz])
        full = torch.zeros((m, nz.numel()), dtype=h.dtype, device=h.device)
        full[nz] = v
        return w.flip(-1), full.flip(-1)

    def emb():
        w2, v2 = torch.linalg.eigh(embed(h))
        w2, v2 = w2.flip(-1), v2.flip(-1)
        # every eigenvalue twice: take the first of each J-pair, as the
        # residual and orthonormality of the kept half show
        v = torch.complex(v2[:m, 0::2], v2[m:, 0::2])
        return w2[0::2], v / torch.linalg.vector_norm(v, dim=0)

    def svd(driver):
        def run():
            _, s, vh = torch.linalg.svd(theta, full_matrices=False,
                                        driver=driver)
            return s * s, vh.mH
        return run

    out = {"eigh_c128": lambda: eig(h),
           "drop_zero": drop,
           "split_zero": lambda: eig(split_zero(h)),
           "embed_f64": emb}
    for d in ("gesvd", "gesvdj", "gesvda"):
        out[f"svd_{d}"] = svd(d)
    return h, out


def quality(h, w, v):
    """(orthonormality of the columns of non-negligible eigenvalue,
    residual of H V = V W there / max |w|, their count)."""
    wmax = float(w.abs().max())
    keep = w.abs() > 1e-10 * max(wmax, 1e-300)
    k = int(keep.sum())
    if k == 0:
        return 0.0, 0.0, 0
    vk, wk = v[:, keep], w[keep].to(h.dtype)
    eye = torch.eye(k, dtype=h.dtype, device=h.device)
    ortho = float((vk.mH @ vk - eye).abs().max())
    resid = float(torch.linalg.vector_norm(h @ vk - vk * wk, dim=0).max())
    return ortho, resid / max(wmax, 1e-300), k


def try_route(fn, reps):
    try:
        w, v = fn()
        torch.cuda.synchronize()
    except Exception as exc:  # a measurement: record the failure
        return None, f"{type(exc).__name__}: {str(exc)[:160]}"
    if not (torch.isfinite(w).all() and torch.isfinite(v).all()):
        return None, "non-finite output"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return (w, v, start.elapsed_time(end) / reps), None


def probe(tag, theta, reps, rows):
    h, routes = candidates(theta)
    zero_rows = int((h == 0).all(dim=-1).sum())
    for name, fn in routes.items():
        res, err = try_route(fn, reps)
        row = dict(gram=tag, route=name, m=h.shape[-1], zero_rows=zero_rows)
        if res is None:
            row.update(converged=False, error=err)
        else:
            w, v, ms = res
            ortho, resid, k = quality(h, w, v)
            row.update(converged=True, ms=ms, ortho=ortho, resid=resid,
                       nonzero_eigenvalues=k)
        rows.append(row)
        print("verifier_routes: " + json.dumps(row), flush=True)


def route_scan(thetas, fails):
    """The port's native route (cplx.eigh_top under eigh="native": zero
    rows split off, then torch.linalg.eigh in complex128) on every
    recorded Gram, formed in complex64 (as before the repair) and in
    complex128 (as svd_trunc now forms it): the Grams it fails on, and its
    ms a call at m = 2048 on the first Gram where the old route failed."""
    from adaptaqc_tpu_torch.ops import cplx
    bad = {"c64": [], "c128": []}
    for i, th in enumerate(thetas):
        t = th.to(C128)
        for form, h in (("c64", (th.mH @ th).to(C128)), ("c128", t.mH @ t)):
            try:
                w, v = cplx.eigh_top(h, th.shape[-1] // 2, "native")
                torch.cuda.synchronize()
                if not (torch.isfinite(w).all() and torch.isfinite(v).all()):
                    bad[form].append(i)
            except Exception:  # a measurement: count the failures
                bad[form].append(i)
    t = thetas[fails[0] if fails else 0].to(C128)
    h = t.mH @ t
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cplx.eigh_top(h, h.shape[-1] // 2, "native")
    start.record()
    for _ in range(5):
        cplx.eigh_top(h, h.shape[-1] // 2, "native")
    end.record()
    torch.cuda.synchronize()
    print(f"verifier_routes: the native route (split zero rows, eigh "
          f"complex128) on all {len(thetas)} Grams: fails on "
          f"{bad['c64']} formed in complex64, {bad['c128']} formed in "
          f"complex128; {start.elapsed_time(end) / 5:.4f} ms a call at "
          f"m={h.shape[-1]}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--grams", type=int, default=3)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("verifier_routes: no CUDA card")
    t0 = time.perf_counter()
    thetas = record_thetas(args.layers)
    fails, ok = [], []
    for i, th in enumerate(thetas):
        h = (th.mH @ th).to(C128)  # as the verifier's route formed it
        try:
            torch.linalg.eigh(h)
            torch.cuda.synchronize()
            ok.append(i)
        except Exception:  # a measurement: count the failures
            fails.append(i)
    print(f"verifier_routes: {len(thetas)} thetas at m=2048 recorded in "
          f"{time.perf_counter() - t0:.1f} s; torch.linalg.eigh(H) complex128 "
          f"fails on {len(fails)}: {fails}; converges on {len(ok)}",
          flush=True)
    route_scan(thetas, fails)
    picks = fails[:args.grams] + ok[:1]
    rows = []
    gen = torch.Generator(device="cpu").manual_seed(2048)
    for i in picks:
        th = thetas[i].to(C128)
        probe(f"resim[{i}]", th, args.reps, rows)
        g = torch.randn((2048, 2048), dtype=C128, generator=gen)
        u, _ = torch.linalg.qr(g.cuda())
        probe(f"resim[{i}] turned", th @ u.mH, args.reps, rows)
    a = torch.randn((2048, 2048), dtype=C128, generator=gen).cuda()
    probe("full-rank random", a / torch.linalg.matrix_norm(a), args.reps,
          rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(fails=fails, ok=ok, rows=rows,
                           card=torch.cuda.get_device_name(0)), f, indent=1)


if __name__ == "__main__":
    main()
