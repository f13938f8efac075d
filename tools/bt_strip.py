"""K4's strip route (csrc/backtransform_strip.cu) on one CUDA card: its
checks, its times beside the routes it replaced and torch.ormqr, and its
cycles by stage.

    python3 tools/bt_strip.py [--parent DIR] [--quick] [--no-stages]
                              [--variants]

  build     the package's library (this tree) and `nvcc -Xptxas -v` of the
            strip source: registers, spills, stack of each kernel;
  checks    the strip route forced at m = 24, 70, 200, 600, 2048 (keep 1,
            m / 2, m) and 4096, 8192 (keep m / 2) in complex64 and
            complex128 against backtransform_plain (chip_smoke's TOL_BT and
            TOL_F64), a rerun bit for bit, a batch of 3 bit for bit against
            its P = 1 launches at m = 600 and 2048, and all-inactive
            reflectors leaving z's columns unchanged; the library's plan
            (workspace, working columns, shared memory, route) against the
            mirrors of ops/eigh_kernels.py;
  times     at keep = m / 2 on synthetic unitary reflectors (a run of 20
            inactive), in turns old, strip, strip, old: the strip route
            forced; the old route at m (the double-buffered cluster route of
            this tree where it fits, else, with --parent DIR, an unpacked
            older tree whose library still has the single and half routes);
            torch.ormqr on the same reflectors (timed only); the bound
            (chip_smoke.kernel_bound). CUDA events, 3 launches a mean at m
            >= 4096, else 10. complex128 m = 1024, 1280, 1536, 2048, 2816
            (the crossover), 4096, 8192; complex64 2048, 3072, 3584, 4096,
            5888, 8192;
  stages    a copy of the strip source built with -DBT_STRIP_STAGES into
            tools/_build/ (git-ignored): CTA (0, 0)'s thread 0 cycles by
            stage (waiting for a chunk's V and Z, the update and its store,
            Y, W = T Y, the whole apply, the copies of the strip in and
            out) at m = 4096 and 8192 in both dtypes.

--quick: the build, the checks and the times at the sizes of the stages
only (a kernel's first call on the card). --variants: copies of the strip
source with the design choices of VARIANTS undone or changed, built in
parallel into tools/_build/, each held against the plain version and
timed in turns against this tree's at VARIANT_SIZES (keep = m / 2).
"""

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from adaptaqc_tpu_torch.ops import cuda_lib  # noqa: E402
from adaptaqc_tpu_torch.ops import eigh_kernels as ek  # noqa: E402

DEV = torch.device("cuda")
STRIP_SRC = ROOT / "adaptaqc_tpu_torch" / "csrc" / "backtransform_strip.cu"
TIME_SIZES = ((True, 1024), (True, 1280), (True, 1536), (True, 2048),
              (True, 2816), (True, 4096), (True, 8192), (False, 2048),
              (False, 3072), (False, 3584), (False, 4096), (False, 5888),
              (False, 8192))
STAGE_SIZES = ((True, 4096), (True, 8192), (False, 4096), (False, 8192))
VARIANT_SIZES = ((True, 2048), (True, 4096), (True, 8192), (False, 4096),
                 (False, 8192))
# name -> edits (old text, new text) of backtransform_strip.cu
VARIANTS = {
    # W = T Y with T's row in two chains (even and odd reflectors, each in
    # order, added at the end) instead of one
    "W in two chains": [
        ("        V acc[COLS / 4];\n#pragma unroll\n"
         "        for (int b = 0; b < COLS / 4; ++b) acc[b] = czero;",
         "        V acc[COLS / 4], acc2[COLS / 4];\n#pragma unroll\n"
         "        for (int b = 0; b < COLS / 4; ++b) acc[b] = acc2[b] = "
         "czero;"),
        ("            cfma(acc[b], t, Ys[jj * COLS + cq + 4 * b]);",
         "            cfma(jj & 1 ? acc2[b] : acc[b], t,\n"
         "                 Ys[jj * COLS + cq + 4 * b]);"),
        ("        for (int b = 0; b < COLS / 4; ++b) Wd[i * COLS + cq + 4 * b] "
         "= acc[b];",
         "        for (int b = 0; b < COLS / 4; ++b)\n"
         "          Wd[i * COLS + cq + 4 * b] = mk(acc[b].x + acc2[b].x, "
         "acc[b].y + acc2[b].y);"),
    ],
}


def synthetic(m, f64, seed, inactive=20):
    """Unitary reflectors drawn on the card (v_k = e_{k+1} + 0.3 x below
    it, tau_k = 2 / |v_k|^2, a run of `inactive` inactive ones from m / 3)
    and an orthonormal real z."""
    dt = torch.complex128 if f64 else torch.complex64
    rdt = torch.float64 if f64 else torch.float32
    g = torch.Generator(device=DEV).manual_seed(seed)
    v = torch.triu(0.3 * torch.randn((m, m), generator=g, dtype=dt,
                                     device=DEV), diagonal=2)
    idx = torch.arange(m - 1, device=DEV)
    v[idx, idx + 1] = 1.0
    tau = torch.zeros(m, dtype=dt, device=DEV)
    tau[:m - 1] = (2.0 / (v[:m - 1].abs() ** 2).sum(-1)).to(dt)
    tau[m // 3:m // 3 + inactive] = 0
    z = torch.linalg.qr(torch.randn((m, m), generator=g, dtype=rdt,
                                    device=DEV))[0].contiguous()
    return v, tau, z


def ptxas():
    nvcc = cuda_lib._nvcc()
    flags = [f for f in cuda_lib.NVCC_FLAGS if f != "-shared"]
    out = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-c", "-o",
                          os.devnull, str(STRIP_SRC)], capture_output=True,
                         text=True)
    for line in out.stderr.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas:", line.strip())


def checks():
    lib = cuda_lib.lib()
    bad = []
    for f64 in (False, True):
        tol = cs.TOL_F64 if f64 else cs.TOL_BT
        for m in (2817, 4096, 5889, 8192, 16384) + ((24, 200) if f64 else ()):
            plan = ek.backtransform_strip_plan(m, f64)
            got = (lib.backtransform_strip_workspace(m, int(f64)),
                   lib.backtransform_strip_zbuf(m, m // 2, int(f64)),
                   lib.backtransform_strip_smem(m, int(f64)),
                   lib.backtransform_strip_smem(0, int(f64)),
                   lib.backtransform_route(m, int(f64)))
            want = (plan["workspace"],
                    ek.backtransform_strip_zbuf_bytes(m, m // 2, f64),
                    plan["smem"], plan["prep_smem"],
                    int(ek.backtransform_routes(m, f64) == "strip"))
            if got != want:
                bad.append(("plan", m, f64, got, want))
        worst = 0.0
        for m in (24, 70, 200, 600, 2048, 4096, 8192):
            t0 = time.perf_counter()
            v, tau, z = synthetic(m, f64, m + 1)
            keeps = (1, m // 2, m) if m <= 2048 else (m // 2,)
            for keep in keeps:
                o = ek.backtransform_strip_launch(v, tau, z, keep)
                again = ek.backtransform_strip_launch(v, tau, z, keep)
                if not torch.equal(o, again):
                    bad.append(("rerun", m, keep, f64))
                err = float((o - ek.backtransform_plain(v, tau, z, keep))
                            .abs().max())
                worst = max(worst, err)
                if not err < tol:
                    bad.append(("plain", m, keep, f64, err))
            if m in (600, 2048):
                vb = torch.stack([v, *synthetic(m, f64, m + 2)[:1],
                                  *synthetic(m, f64, m + 3)[:1]])
                tb = torch.stack([tau, synthetic(m, f64, m + 2)[1],
                                  synthetic(m, f64, m + 3, 0)[1]])
                zb = torch.stack([z, synthetic(m, f64, m + 2)[2],
                                  synthetic(m, f64, m + 3)[2]])
                keep = m // 2
                ob = ek.backtransform_strip_launch(vb, tb, zb, keep)
                for i in range(3):
                    if not torch.equal(ob[i], ek.backtransform_strip_launch(
                            vb[i], tb[i], zb[i], keep)):
                        bad.append(("batch", m, f64, i))
            print(f"check {'c128' if f64 else 'c64'} m={m} keeps {keeps}: "
                  f"worst so far {worst:.2e} < {tol} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        v, _, z = synthetic(300, f64, 5)
        tau = torch.zeros(300, dtype=v.dtype, device=DEV)
        o = ek.backtransform_strip_launch(v, tau, z, 100)
        if not torch.equal(o, z[:, :100].to(v.dtype)):
            bad.append(("inactive", f64))
    print(f"checks: {'FAILED ' + repr(bad[:8]) if bad else 'all passed'}",
          flush=True)
    return not bad


def load_parent(parent):
    spec = importlib.util.spec_from_file_location(
        "parent_cuda_lib",
        Path(parent) / "adaptaqc_tpu_torch" / "ops" / "cuda_lib.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def old_route(mod, v, tau, z, keep):
    """One launch of a library's double/single/half route
    (backtransform_f64_launch / backtransform_wide_launch)."""
    lib = mod.lib()
    m = v.shape[-1]
    f64 = v.dtype == torch.complex128
    ws = torch.empty(lib.backtransform_workspace(m, int(f64)),
                     dtype=torch.uint8, device=DEV)
    out = torch.empty((m, keep), dtype=v.dtype, device=DEV)
    launch = (lib.backtransform_f64_launch if f64
              else lib.backtransform_wide_launch)
    rc = launch(v.data_ptr(), tau.data_ptr(), z.data_ptr(), out.data_ptr(),
                ws.data_ptr(), m, keep, 1, m * m, m, m * m,
                cuda_lib.stream_of(v))
    if rc != 0:
        raise RuntimeError(f"old route m={m}: error {rc}")
    return out


def times(parent, sizes):
    pmod = load_parent(parent) if parent else None
    rows = []
    for f64, m in sizes:
        keep = m // 2
        v, tau, z = synthetic(m, f64, m + 1)
        dt = v.dtype
        reps = 3 if m >= 4096 else 10
        if m <= ek.BT_DOUBLE_MAX[f64]:
            oname, omod = "double", cuda_lib
        elif pmod is not None:
            oname, omod = ("single" if (not f64 or m <= 4096) else "half",
                           pmod)
        else:
            oname, omod = None, None

        def new():
            return ek.backtransform_strip_launch(v, tau, z, keep)

        def old():
            return old_route(omod, v, tau, z, keep)
        err_old = (float((old() - new()).abs().max()) if omod else None)
        t_new, t_old = [], []
        for turn in ("old", "new", "new", "old"):
            if turn == "new":
                t_new.append(cs.cuda_ms(new, reps, torch))
            elif omod is not None:
                t_old.append(cs.cuda_ms(old, reps, torch))
        oa, otau, _ = cs.ormqr_inputs(torch, v, tau, z, keep)
        oz = z[1:, :keep].to(dt).contiguous()
        lms = cs.cuda_ms(lambda: torch.ormqr(oa, otau, oz), reps, torch)
        bms, bby, _, _ = cs.kernel_bound("backtransform", m=m, keep=keep,
                                         f64=f64)
        row = dict(dtype="c128" if f64 else "c64", m=m, keep=keep,
                   strip_ms=float(np.mean(t_new)), strip_turns=t_new,
                   old_route=oname,
                   old_ms=float(np.mean(t_old)) if t_old else None,
                   old_turns=t_old, old_vs_strip=err_old, ormqr_ms=lms,
                   bound_ms=bms, bound_by=bby)
        rows.append(row)
        print("time", row, flush=True)
        del v, tau, z, oa, otau, oz
        torch.cuda.empty_cache()
    return rows


def build_variants():
    """{name: the loaded library of the strip source with its edits}, one
    nvcc a variant, all started together."""
    root = ROOT / "tools" / "_build" / "bt_variants"
    jobs = {}
    for k, (name, edits) in enumerate(VARIANTS.items()):
        d = root / f"v{k}"
        d.mkdir(parents=True, exist_ok=True)
        src = STRIP_SRC.read_text()
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"variant {name!r}: edit not found: {old!r}")
            src = src.replace(old, new)
        (d / STRIP_SRC.name).write_text(src)
        (d / "common.cuh").write_text(
            (STRIP_SRC.parent / "common.cuh").read_text())
        so = d / "libbt_variant.so"
        jobs[name] = (so, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so),
             str(d / STRIP_SRC.name)], cwd=str(d)))
    libs = {}
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, (so, proc) in jobs.items():
        if proc.wait() != 0:
            raise SystemExit(f"variant {name!r}: nvcc failed")
        lib = ctypes.CDLL(str(so))
        lib.backtransform_strip_launch.argtypes = [P, P, P, P, P, P, I, I, I,
                                                   L, L, L, I, P]
        for fn, args in (("backtransform_strip_workspace", [I, I]),
                         ("backtransform_strip_zbuf", [I, I, I])):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = L
        libs[name] = lib
    return libs


def variant_launch(lib, v, tau, z, keep):
    m = v.shape[-1]
    f64 = v.dtype == torch.complex128
    out = torch.empty((m, keep), dtype=v.dtype, device=DEV)
    ws = torch.empty(lib.backtransform_strip_workspace(m, int(f64)),
                     dtype=torch.uint8, device=DEV)
    zb = torch.empty(lib.backtransform_strip_zbuf(m, keep, int(f64)),
                     dtype=torch.uint8, device=DEV)
    rc = lib.backtransform_strip_launch(
        v.data_ptr(), tau.data_ptr(), z.data_ptr(), out.data_ptr(),
        ws.data_ptr(), zb.data_ptr(), m, keep, 1, m * m, m, m * m, int(f64),
        cuda_lib.stream_of(v))
    if rc != 0:
        raise RuntimeError(f"variant launch m={m}: error {rc}")
    return out


def variants():
    libs = build_variants()
    for f64, m in VARIANT_SIZES:
        keep = m // 2
        v, tau, z = synthetic(m, f64, m + 1)
        reps = 3 if m >= 4096 else 10
        tol = cs.TOL_F64 if f64 else cs.TOL_BT
        ref = ek.backtransform_plain(v, tau, z, keep) if m <= 4096 else None

        def base():
            return ek.backtransform_strip_launch(v, tau, z, keep)
        for name, lib in libs.items():
            def var():
                return variant_launch(lib, v, tau, z, keep)
            if ref is not None:
                err = float((var() - ref).abs().max())
                if not err < tol:
                    raise SystemExit(f"variant {name!r} m={m}: {err}")
            else:
                err = float((var() - base()).abs().max())
            t = {"base": [], "variant": []}
            for turn in ("base", "variant", "variant", "base"):
                t[turn].append(cs.cuda_ms(base if turn == "base" else var,
                                          reps, torch))
            print(f"variant {name!r} {'c128' if f64 else 'c64'} m={m}: "
                  f"{np.mean(t['variant']):.4f} ms against this tree's "
                  f"{np.mean(t['base']):.4f} (turns {t}; error {err:.2e})",
                  flush=True)
        del v, tau, z, ref
        torch.cuda.empty_cache()


def stages(sizes):
    build = ROOT / "tools" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    so = build / "libbt_strip_stages.so"
    subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS,
                    "-DBT_STRIP_STAGES", "-o", str(so), str(STRIP_SRC)],
                   check=True, cwd=str(STRIP_SRC.parent))
    lib = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.backtransform_strip_launch.argtypes = [P, P, P, P, P, P, I, I, I, L,
                                               L, L, I, P]
    for name, args in (("backtransform_strip_workspace", [I, I]),
                       ("backtransform_strip_zbuf", [I, I, I])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = L
    lib.backtransform_strip_stages.argtypes = [P]
    names = ("wait for V and Z", "update and store", "Y", "W = T Y",
             "whole apply", "copies in and out")
    for f64, m in sizes:
        keep = m // 2
        v, tau, z = synthetic(m, f64, m + 1)
        out = torch.empty((m, keep), dtype=v.dtype, device=DEV)
        ws = torch.empty(lib.backtransform_strip_workspace(m, int(f64)),
                         dtype=torch.uint8, device=DEV)
        zb = torch.empty(lib.backtransform_strip_zbuf(m, keep, int(f64)),
                         dtype=torch.uint8, device=DEV)
        st = (ctypes.c_ulonglong * 16)()

        def run():
            rc = lib.backtransform_strip_launch(
                v.data_ptr(), tau.data_ptr(), z.data_ptr(), out.data_ptr(),
                ws.data_ptr(), zb.data_ptr(), m, keep, 1, m * m, m, m * m,
                int(f64), cuda_lib.stream_of(v))
            assert rc == 0, rc
        run()
        lib.backtransform_strip_stages(st)  # zero after the warm-up
        run()
        assert lib.backtransform_strip_stages(st) == 0
        parts = {n: int(st[i]) for i, n in enumerate(names)}
        whole = max(parts["whole apply"], 1)
        print(f"stages {'c128' if f64 else 'c64'} m={m} keep={keep}: "
              + ", ".join(f"{n} {c} ({100 * c / whole:.1f}%)"
                          for n, c in parts.items()), flush=True)
        del v, tau, z, out, ws, zb
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--no-stages", action="store_true")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bt_strip: no CUDA card")
    print(cs.card_line() if hasattr(cs, "card_line") else
          subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    cuda_lib.lib()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas()
    ok = checks()
    if args.variants:
        variants()
        return 0 if ok else 1
    times(args.parent, STAGE_SIZES if args.quick else TIME_SIZES)
    if not args.no_stages:
        stages(STAGE_SIZES)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
