"""Variants of the streamed env chain's CTA tiles (csrc/env_chain_stream.cu
kConfigs, plan_config), timed against each other on one CUDA card.

    python3 tools/env_stream_variants.py [--chis 256,512,768,1024]
                                         [--f64-chis 256,512,1024]
                                         [--only base,all64]

Each variant is a copy of the source with text edits (VARIANTS below), built
alone with the package's nvcc flags into tools/_build/<variant>/, all
builds at once. Then, at n = 50 and q = 25 (chip_smoke.env_inputs), every
variant in turn (and the first again at the end, for drift) runs the
package's wrapper env_chain on its library: held against env_chain_plain
(chip_smoke's tolerances), then timed over 10 calls (CUDA events). Prints
one line per variant and chi.
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

ROW0 = "{128, 128, 16, 512, 3, 2, 1, 8, 4},  // 0"
ROW1 = "{64, 64, 16, 128, 4, 2, 3, 8, 4},    // 1"
ROW3 = "{64, 64, 8, 128, 4, 1, 2, 0, 0},     // 3"
PLAN = "return c >= 512 ? 0 : 1;"
# name -> [(old, new)] edits of csrc/env_chain_stream.cu: each undoes one
# choice of the final design
VARIANTS = {
    "base": [],
    # complex64 from 512: the first design's 256 threads of 8 x 8 outputs
    "c0_256thr_8x8": [(ROW0, "{128, 128, 16, 256, 4, 2, 1, 8, 8},  // 0")],
    # complex64 below 512: 3 stages in place of 4
    "c1_3st": [(ROW1, "{64, 64, 16, 128, 3, 2, 4, 8, 4},    // 1")],
    # complex64: one CTA tile at every even chi
    "all128": [(PLAN, "return 0;")],
    "all64": [(PLAN, "return 1;")],
    # complex128: eight warps a CTA (128 x 64), depth tiles of 16
    "d128x64_bk16": [(ROW3, "{128, 64, 16, 256, 3, 1, 1, 0, 0},     // 3")],
}


def build(name, edits):
    d = os.path.join(ROOT, "tools", "_build", name)
    os.makedirs(d, exist_ok=True)
    from adaptaqc_tpu_torch.ops import cuda_lib
    for f in ("env_chain_stream.cu", "common.cuh"):
        shutil.copy(cuda_lib.CSRC / f, os.path.join(d, f))
    src = os.path.join(d, "env_chain_stream.cu")
    text = open(src).read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: edit target not found: {old}")
        text = text.replace(old, new)
    with open(src, "w") as f:
        f.write(text)
    so = os.path.join(d, "lib.so")
    return so, subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", so, src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


class Shim:
    """The package's library with the streamed chain's entry points taken
    from a variant's."""

    def __init__(self, real, variant):
        self.real, self.variant = real, variant

    def __getattr__(self, name):
        if name.startswith("env_chain_stream"):
            return getattr(self.variant, name)
        return getattr(self.real, name)


def load(so):
    h = ctypes.CDLL(so)
    from adaptaqc_tpu_torch.ops import cuda_lib
    f = h.env_chain_stream_launch
    f.argtypes = list(cuda_lib._SIGNATURES["env_chain_stream_launch"])
    f.restype = ctypes.c_int
    w = h.env_chain_stream_work
    w.argtypes, w.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
    return h


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chis", default="256,512,768,1024")
    ap.add_argument("--f64-chis", default="256,512,1024")
    ap.add_argument("--only", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("env_stream_variants: no CUDA card")
    import chip_smoke as cs
    from adaptaqc_tpu_torch.ops import cuda_lib
    from adaptaqc_tpu_torch.ops import env_kernel as envk
    names = args.only.split(",") if args.only else list(VARIANTS)
    procs = {n: build(n, VARIANTS[n]) for n in names}
    libs = {}
    for n, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            print(f"env_stream_variants: {n} failed to build:\n{err[-3000:]}",
                  flush=True)
            continue
        libs[n] = load(so)
    real = cuda_lib.lib()
    print(f"env_stream_variants: built {list(libs)} on {cs.gpu_line()}",
          flush=True)
    n, dev = 50, torch.device("cuda")
    cases = [(False, int(c)) for c in args.chis.split(",") if c] + [
        (True, int(c)) for c in args.f64_chis.split(",") if c]
    order = list(libs) + list(libs)[:1]
    for f64, chi in cases:
        dt = torch.complex128 if f64 else torch.complex64
        tol = cs.TOL_F64_ENV if f64 else cs.TOL_ENV_REL
        br64, bl64 = cs.env_inputs(torch, n, chi, dev)
        br, bl = br64.to(dt), bl64.to(dt)
        del br64, bl64
        ref = envk.env_chain_plain(br, bl, 25)
        parts = []
        for name in order:
            lib = libs[name]
            cuda_lib._lib = Shim(real, lib)
            envk.stream_work = (lambda c_, f_, lib=lib:
                                lib.env_chain_stream_work(c_, int(f_)))
            out = envk.env_chain(br, bl, 25)
            rel = float((out - ref).abs().max() / ref.abs().max())
            ms = cs.cuda_ms(lambda: envk.env_chain(br, bl, 25), 10, torch)
            parts.append(f"{name} {ms:.4f} ms (rel {rel:.1e}"
                         f"{'' if rel < tol else ' FAILED'})")
        b = cs.kernel_bound("env_chain", n=n, chi=chi, f64=f64)
        print(f"env_stream_variants: {str(dt)[6:]} chi={chi} bound "
              f"{b[0]:.4f} ms: " + "; ".join(parts), flush=True)
        del br, bl
    cuda_lib._lib = real


if __name__ == "__main__":
    main()
