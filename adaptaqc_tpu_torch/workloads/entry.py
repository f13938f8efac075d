"""One forward step of the compiler, and the multi-device dry run.

`entry()`: a full-tape statevector cost evaluation, the innermost object
every ADAPT iteration is built from. Counterpart of `entry()` in the JAX
package's `__graft_entry__.py` (:47-67): a 12-qubit tape of 24 random CX
blocks through `sv_core.apply_tape`, then `global_cost`.

`dryrun_multichip(n_devices)`: one ADAPT training step of each engine over
an n_devices mesh (parallel/mesh.py), the twin of the JAX package's
`__graft_entry__.dryrun_multichip` (:86-197): the statevector step at n = 6
with its pair concurrences, the MPS step at chi = max(8, 4 tp) and at n =
8, chi = 256, each with its shard shapes, and the statevector step at n =
24, which fits a per-rank budget only sharded.

    python3 -m adaptaqc_tpu_torch.workloads.entry [--device cuda|cpu]
        [--dryrun N] [--backend gloo|nccl]

prints the cost of the example tape, then, with --dryrun N, runs the dry
run on N ranks (on one card: --backend gloo).
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from ..backends import sv_core
from ..circuits.circuit import Circuit
from ..circuits.tape import compile_tape
from . import _common


def example_tape(n, depth, seed=0):
    """A layer of random RY, then `depth` blocks RZ(a), CX(a, a+1),
    RX(a+1) on random adjacent pairs (`__graft_entry__._example_tape`)."""
    rng = np.random.default_rng(seed)
    qc = Circuit(n)
    for q in range(n):
        qc.ry(float(rng.uniform(-3, 3)), q)
    for _ in range(depth):
        a = int(rng.integers(n - 1))
        qc.rz(float(rng.uniform(-3, 3)), a)
        qc.cx(a, a + 1)
        qc.rx(float(rng.uniform(-3, 3)), a + 1)
    return compile_tape(qc)


def fn(state, kinds, q0, q1, angles):
    """1 - |<0|tape|state>|^2 as a real 0-dim tensor."""
    return sv_core.global_cost(sv_core.apply_tape(state, kinds, q0, q1,
                                                  angles))


def entry(device="cuda", dtype=None):
    """(fn, example_args): the 12-qubit |0> on `device` (the card unless
    the caller asks for the CPU) and the host arrays of a 24-deep tape."""
    device = _common.require_device(device)
    n = 12
    tape = example_tape(n, 24)
    return fn, (sv_core.zero_state(n, dtype, device), tape.kinds, tape.q0,
                tape.q1, tape.angles)


# the dry run's sizes, as the JAX package has them (the CPU tests cut
# them): the statevector step's n, the MPS step's n, the large MPS step's
# (n, chi), the sharded-only statevector's n
DRYRUN_SIZES = dict(n=6, big=(8, 256), sv_n=24)


def _dryrun_rank(n_devices, sizes):
    """One rank of the dry run: the four parts of the JAX package's
    dryrun_multichip with their assertions, each rank running its shards;
    rank 0 prints. Returns a summary (rank 0's is kept)."""
    from ..backends import mps_core
    from ..ops import cplx
    from ..parallel import mesh as pm
    from ..parallel import sv_sharded
    from ..utils.constants import CMAP_FULL, generate_coupling_map
    from ..utils.entanglement_measures import concurrence

    dev = pm.rank_device()
    say = print if torch.distributed.get_rank() == 0 else (lambda *a, **k: 0)
    out = {"platform": _common.platform(dev.type)}
    # on the card the kernels; on the CPU, where the plain K2-K4 are Python
    # loops, the native eigensolver
    with (cplx.verification_eigh() if dev.type == "cpu"
          else contextlib.nullcontext()):
        mesh = pm.make_mesh(n_devices)
        tp = pm.axis_size(mesh, pm.TP)
        n = sizes["n"]
        tape = example_tape(n, 8)
        pairs = np.asarray(generate_coupling_map(n, CMAP_FULL),
                           dtype=np.int32)
        step = pm.make_training_step(mesh, n, tape.padded_length)
        nk, na, cost, rhos, evals = step(sv_core.zero_state(n, device=dev),
                                         tape, tape.trainable, pairs)
        rhos = rhos.cpu().numpy()
        assert rhos.shape[0] == pairs.shape[0]
        assert cost <= 1.0
        scores = [concurrence(rhos[i]) for i in range(len(pairs))]
        say(f"dryrun_multichip OK on mesh {tuple(mesh.shape)}: "
            f"cost={cost:.4f}, {evals} probe-evals, {len(scores)} pair "
            f"concurrences, max={max(scores):.3f}", flush=True)
        out["sv"] = dict(cost=cost, evals=evals, pairs=len(scores))

        chi = max(8, 4 * tp)  # divisible by tp: the bond axis shards
        mtape = example_tape(n, 6, seed=1)
        mstep = pm.make_mps_training_step(mesh, n, chi, mtape.padded_length)
        _, _, mcost, l_state, mrhos, mevals = mstep(
            mps_core.zero_mps(n, chi, device=dev), mtape, mtape.trainable)
        assert mcost <= 1.0 + 1e-6
        shards = tuple(pm.local(l_state.b).shape)
        assert shards == (n, 2, chi, chi // tp), shards
        mrhos = mrhos.cpu().numpy()
        mscores = [concurrence(mrhos[i, j]) for i in range(n)
                   for j in range(i + 1, n)]
        say(f"dryrun_multichip MPS OK on mesh {tuple(mesh.shape)}: chi={chi} "
            f"sharded {chi // tp}/device, cost={mcost:.4f}, {mevals} "
            f"probe-evals, max concurrence={max(mscores):.3f}", flush=True)
        out["mps"] = dict(chi=chi, cost=mcost, shards=shards)

        nb, chi_big = sizes["big"]
        btape = example_tape(nb, 4, seed=2)
        bstep = pm.make_mps_training_step(mesh, nb, chi_big,
                                          btape.padded_length)
        _, _, bcost, b_state, brhos, bevals = bstep(
            mps_core.zero_mps(nb, chi_big, device=dev), btape,
            btape.trainable)
        assert bcost <= 1.0 + 1e-6
        bshards = tuple(pm.local(b_state.b).shape)
        assert bshards == (nb, 2, chi_big, chi_big // tp), bshards
        say(f"dryrun_multichip MPS chi={chi_big} OK: sweep step ran sharded "
            f"{chi_big // tp}/device, cost={bcost:.4f}, {bevals} "
            f"probe-evals", flush=True)
        # its tape and RDMs too, for a comparison with the unsharded sweep
        out["mps_big"] = dict(chi=chi_big, cost=bcost, shards=bshards,
                              tape=btape, rhos=brhos)

        # a state whose unsharded buffer exceeds a per-rank budget, run
        # only because it is tp-sharded over every rank: at n = 24 the
        # complex64 state is 128 MB against 96 MB a rank (3/4 of it),
        # sharded 4-way 32 MB a rank
        nsv = sizes["sv_n"]
        state_bytes = 8 * 2 ** nsv
        budget = 3 * state_bytes // 4
        sv_mesh = pm.make_mesh(n_devices, shape=(1, n_devices))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        big = sv_sharded.zero_state(sv_mesh, nsv, device=dev)
        shard_bytes = pm.local(big).numel() * pm.local(big).element_size()
        assert state_bytes > budget >= shard_bytes, (state_bytes, budget,
                                                     shard_bytes)
        stape = example_tape(nsv, 2, seed=3)
        sstep = pm.make_training_step(sv_mesh, nsv, stape.padded_length,
                                      rotoselect=False)
        spairs = np.asarray([[0, 1], [nsv // 2, nsv // 2 + 1]],
                            dtype=np.int32)
        _, _, scost, srhos, sevals = sstep(big, stape, stape.trainable,
                                           spairs)
        assert scost <= 1.0 + 1e-6 and srhos.shape[0] == 2
        peaks = torch.zeros(n_devices, dtype=torch.float64, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            peaks[torch.distributed.get_rank()] = float(
                torch.cuda.max_memory_allocated() - base)
            peaks = pm.all_sum(peaks, None, n_devices)
        peak_text = ("; peak allocated a rank " + ", ".join(
            f"{p / 2 ** 20:.1f}" for p in peaks.tolist()) + " MB"
            if dev.type == "cuda" else "")
        say(f"dryrun_multichip SV n={nsv} OK (sharded-only-feasible): state "
            f"{state_bytes / 2 ** 20:.0f} MB > {budget / 2 ** 20:.0f} MB/rank "
            f"budget unsharded, {shard_bytes / 2 ** 20:.0f} MB/rank sharded "
            f"{n_devices}-way; sweep step cost={scost:.4f}, {sevals} "
            f"probe-evals{peak_text}", flush=True)
        out["sv_big"] = dict(n=nsv, cost=scost, shard_bytes=shard_bytes,
                             budget=budget, peaks=peaks.tolist())
        out["collectives"] = dict(pm.STATS)
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: str = None) -> dict:
    """One ADAPT training step of each engine over an n_devices mesh (the
    JAX package's __graft_entry__.dryrun_multichip), in n_devices ranks on
    `device` (the card unless the caller passes "cpu"; ranks that share a
    card need backend="gloo"). Returns rank 0's summary."""
    from ..parallel import mesh as pm
    return pm.launch(_dryrun_rank, n_devices, n_devices, DRYRUN_SIZES,
                     device=device, backend=backend)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dryrun", type=int, default=0,
                        help="ranks of the multi-device dry run (0: none)")
    parser.add_argument("--backend", default=None,
                        help="process-group backend of the dry run")
    args = parser.parse_args(argv)
    f, example_args = entry(args.device)
    print(f"cost {float(f(*example_args))!r} on "
          f"{_common.platform(args.device)}")
    if args.dryrun:
        dryrun_multichip(args.dryrun, args.device, args.backend)


if __name__ == "__main__":
    main()
