"""Trace the port against the JAX package on the CPU in float64, where a
parity test shows the two apart.

  f3  compile_in_parts on the 3-qubit random circuit of
      tests/test_torch_features.py::test_compile_in_parts_pair_history_
      matches_jax (brickwall, 6 layers a part, blocks of depth 5): for
      every O(G) sweep call of each package, its cycles, evaluations, final
      and starting cost and the backwards guard's verdict; then, for the
      first call where the packages part, each cycle's cost and overlap^2
      and the Rotoselect kinds it chose, re-run cycle by cycle.
  f4  the `spin` phase's local-cost compile at n=10 (benchmarks/
      spin_chain.py's configuration, 2 Trotter steps, chi=32), 4 layers:
      layer by layer the pair, the local cost, the global cost and the
      minimiser calls with their cycles.

Run from the repository root:
    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/parity_trace.py f3|f4
"""

import os
import sys

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

import adaptaqc_tpu as jport  # noqa: E402
import adaptaqc_tpu_torch as port  # noqa: E402
from adaptaqc_tpu.optim import minimiser as jmin  # noqa: E402
from adaptaqc_tpu.optim import sweeps as jsw  # noqa: E402
from adaptaqc_tpu_torch.ops import cplx  # noqa: E402
from adaptaqc_tpu_torch.optim import minimiser as tmin  # noqa: E402
from adaptaqc_tpu_torch.optim import sweeps as tsw  # noqa: E402

C128 = torch.complex128
PKGS = {"jax": (jport, jsw, jmin), "torch": (port, tsw, tmin)}


def _record_calls(sweeps_mod, fname, calls):
    """Wrap sweeps_mod.fname: each call's arguments and (cycles, evals,
    cost, cost0)."""
    orig = getattr(sweeps_mod, fname)

    def wrapped(*args, **kw):
        out = orig(*args, **kw)
        calls.append((args, kw, int(out[3]), int(out[4]), float(out[2]),
                      float(out[6])))
        return out
    setattr(sweeps_mod, fname, wrapped)
    return orig


def _random_circuit(cls, n, depth, rng):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tests"))
    from test_torch_features import random_circuit
    return random_circuit(cls, n, depth, rng)


def f3():
    calls = {"jax": [], "torch": []}
    results = {}
    for name, (pkg, sw, _) in PKGS.items():
        orig = _record_calls(sw, "sweep_until_converged", calls[name])
        backend = (jport.SVBackend() if name == "jax"
                   else port.SVBackend(dtype=C128, device="cpu"))
        qc = _random_circuit(pkg.Circuit, 3, 14, np.random.default_rng(23))
        comp = pkg.AdaptCompiler(
            qc, backend=backend,
            adapt_config=pkg.AdaptConfig(method="brickwall", max_layers=6))
        results[name] = comp.compile_in_parts(max_depth_per_block=5)
        sw.sweep_until_converged = orig
    for name, res in results.items():
        print(f"{name}: parts " + ", ".join(
            f"(evals {r.cost_evaluations}, overlap {r.overlap:.12f})"
            for r in res.individual_results))
    first = None
    for i, (cj, ct) in enumerate(zip(calls["jax"], calls["torch"])):
        verdicts = [jmin._sweep_went_backwards(cj[4], cj[5]),
                    tmin._sweep_went_backwards(ct[4], ct[5])]
        print(f"call {i}: cycles {cj[2]} / {ct[2]}, evals {cj[3]} / {ct[3]},"
              f" cost {cj[4]:.15e} / {ct[4]:.15e}, cost0 {cj[5]:.15e} / "
              f"{ct[5]:.15e}, went backwards {verdicts[0]} / {verdicts[1]}")
        if first is None and (cj[2] != ct[2] or abs(cj[4] - ct[4]) > 1e-12):
            first = i
    print(f"calls {len(calls['jax'])} / {len(calls['torch'])}; first call "
          f"that parts: {first}")
    if first is None:
        return
    # the first call that parts, cycle by cycle
    for name, sw in (("jax", jsw), ("torch", tsw)):
        args = calls[name][first][0]
        (eng, bl, rotoselect, max_cycles, prefix, ref, kinds, q0, q1, angles,
         select) = args[:11]
        sel = np.asarray(select)
        print(f"  {name} input: kinds {np.asarray(kinds).tolist()} angles "
              f"{np.round(np.asarray(angles, float), 6).tolist()}")
        for c in range(min(8, calls[name][first][2] + 1)):
            kinds, angles, cost, _, evals, ov2 = sw.sweep(
                eng, bl, rotoselect, prefix, ref, kinds, q0, q1, angles,
                select)
            print(f"  {name} cycle {c}: cost {float(cost):.15e} overlap^2 "
                  f"{float(ov2):.15e} evals {int(evals)} kinds "
                  f"{np.asarray(kinds)[sel].tolist()}")


def _spin_compiler(pkg, n, steps, layers):
    """benchmarks/spin_chain.py's configuration in either package."""
    ops = sys.modules[pkg.__name__ + ".circuits.operations"]
    targets = sys.modules.get(pkg.__name__ + ".utils.targets")
    if pkg is port:
        from adaptaqc_tpu_torch.utils.ansatzes import identity_resolvable
        from adaptaqc_tpu_torch.utils.constants import (
            CMAP_LINEAR, generate_coupling_map)
        from adaptaqc_tpu_torch.utils.targets import (neel_circuit,
                                                      trotter_circuit)
        backend = port.mps_backend_with_args(
            mps_truncation_threshold=1e-8, max_chi=32, dtype=C128,
            device="cpu")
    else:
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                        "benchmarks"))
        from spin_chain import neel_circuit, trotter_circuit
        from adaptaqc_tpu.utils.ansatzes import identity_resolvable
        from adaptaqc_tpu.utils.constants import (CMAP_LINEAR,
                                                  generate_coupling_map)
        backend = jport.mps_backend_with_args(mps_truncation_threshold=1e-8,
                                              max_chi=32)
    del targets
    prep = neel_circuit(n)
    target = prep.copy()
    ops.add_to_circuit(target, trotter_circuit(n, steps, 0.25, delta=1.5,
                                               h=1.0))
    config = pkg.AdaptConfig(
        method="brickwall", cost_improvement_num_layers=1000,
        sufficient_cost=1e-2, max_layers=layers, local_window_layers=16,
        global_polish_frequency=10)
    return pkg.AdaptCompiler(
        target, backend=backend, adapt_config=config,
        coupling_map=generate_coupling_map(n, CMAP_LINEAR),
        custom_layer_2q_gate=identity_resolvable(), starting_circuit=prep,
        optimise_local_cost=True)


def f4(n=10, steps=2, layers=4):
    out = {}
    for name, (pkg, sw, mn) in PKGS.items():
        calls = []
        orig = _record_calls(sw, "sweep_full_chunked_until_converged", calls)
        comp = _spin_compiler(pkg, n, steps, layers)
        per_layer = []
        orig_add = pkg.AdaptCompiler._add_layer

        def add_layer(self, index, _orig=orig_add, _calls=calls,
                      _per=per_layer):
            start = len(_calls)
            cost = _orig(self, index)
            _per.append((float(cost), [(c[2], c[3]) for c in
                                       _calls[start:]]))
            return cost
        pkg.AdaptCompiler._add_layer = add_layer
        try:
            if name == "torch":
                with cplx.verification_eigh():
                    result = comp.compile()
            else:
                result = comp.compile()
        finally:
            pkg.AdaptCompiler._add_layer = orig_add
            sw.sweep_full_chunked_until_converged = orig
        out[name] = (result, per_layer)
    rj, lj = out["jax"]
    rt, lt = out["torch"]
    print(f"pairs jax {rj.qubit_pair_history}\npairs torch "
          f"{rt.qubit_pair_history}")
    for i, (a, b) in enumerate(zip(lj, lt)):
        print(f"layer {i}: local cost {a[0]:.15e} / {b[0]:.15e}; global "
              f"{rj.global_cost_history[i + 1]:.15e} / "
              f"{rt.global_cost_history[i + 1]:.15e}; full-cost calls "
              f"(cycles, evals) {a[1]} / {b[1]}")
    print(f"overlap {rj.overlap:.15e} / {rt.overlap:.15e}; evaluations "
          f"{rj.cost_evaluations} / {rt.cost_evaluations}")


if __name__ == "__main__":
    {"f3": f3, "f4": f4}[sys.argv[1]]()
