"""What tests/test_torch_mesh.py runs inside its ranks: 8 gloo ranks on
the CPU, one (dp 2, tp 4) mesh, complex128. Every rank runs every case in
the same order (each case's collectives span the mesh); rank 0's results
come back to the test as numpy. Not a test module itself: the ranks import
it by name."""

import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist

import chip_smoke

from adaptaqc_tpu_torch.backends import mps_core, sv_core
from adaptaqc_tpu_torch.backends.backend import MPSBackend, SVBackend
from adaptaqc_tpu_torch.circuits.circuit import Circuit
from adaptaqc_tpu_torch.circuits.operations import (
    create_random_initial_state_circuit)
from adaptaqc_tpu_torch.compilers import adapt_compiler
from adaptaqc_tpu_torch.compilers.adapt_compiler import AdaptCompiler
from adaptaqc_tpu_torch.compilers.adapt_config import AdaptConfig
from adaptaqc_tpu_torch.io import checkpoint
from adaptaqc_tpu_torch.ops import cplx
from adaptaqc_tpu_torch.parallel import mesh as pm
from adaptaqc_tpu_torch.parallel import mps_sharded, sv_sharded
from adaptaqc_tpu_torch.utils.constants import CMAP_FULL, generate_coupling_map
from adaptaqc_tpu_torch.workloads import entry

C128 = torch.complex128
DRYRUN_SIZES = dict(big=(8, 32), sv_n=14)  # the dry run, cut for the CPU
# the sharded pair contraction's cases: (n, chi, pairs), linear and with
# spans past 1 (some descending)
PAIR_CASES = ((7, 8, ((0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6))),
              (6, 16, ((0, 1), (3, 1), (2, 5), (5, 4), (0, 5), (4, 3))))
GRAD_SIZE = (6, 8)       # (n, chi) of the gradient heuristic's case
VERIFY_SIZE = (8, 8)     # (n, working chi): the verifier pads to chi 16
# the full-cost sweep's cases: (engine, seed, tolerance against the host
# probe loop), as tests/test_torch_full_cost_sweep.py's CASES
FULL_CASES = (("sv", 21, 1e-7), ("mps", 22, 1e-6))
# the MPS compile's layers (its 5 to the stop take 20,000 collectives, about
# 80 s of gloo round trips here; the first 3 already hold every path)
MPS_COMPILE_LAYERS = 3


random_tape = entry.example_tape  # tests/test_mesh.py's _random_tape


def mps_target():
    """tests/test_mesh.py's MPS compile target (chip_smoke's mesh phase
    compiles it too)."""
    return chip_smoke.mesh_target(Circuit)


def r1_state(n, chi, seed):
    """A random MPS (n, chi) in complex128 on the CPU whose every bond
    below the edges has all chi columns (so that every tp rank's columns
    carry weight: a circuit's state of a few gates would leave the higher
    columns, other ranks' shards, zero): random site tensors scaled by
    (2 chi)^-1/2, the edge bonds one-dimensional, random positive bond
    weights (which only <Z> reads)."""
    g = np.random.default_rng(seed)
    b = (g.normal(size=(n, 2, chi, chi)) + 1j * g.normal(
        size=(n, 2, chi, chi))) / np.sqrt(2 * chi)
    b[0, :, 1:, :] = 0.0
    b[-1, :, :, 1:] = 0.0
    lam = g.uniform(0.1, 1.0, size=(n + 1, chi))
    lam[0], lam[-1] = np.eye(chi)[0], np.eye(chi)[0]
    return mps_core.MPS(torch.as_tensor(b), torch.as_tensor(lam),
                        torch.zeros((), dtype=torch.float64))


def r1_ops(k=3, m=2, seed=12):
    """Random complex (k, m, 2, 2) operator pairs (ops_a, ops_b)."""
    g = np.random.default_rng(seed)
    ops = g.normal(size=(2, k, m, 2, 2)) + 1j * g.normal(size=(2, k, m, 2, 2))
    return torch.as_tensor(ops[0]), torch.as_tensor(ops[1])


def grad_inputs(n):
    """The gradient heuristic's inputs (tests/test_torch_compile.py's):
    identity_resolvable's generators and degeneracies, the packed
    operators, a linear coupling map, and a starting circuit of fixed ry
    rotations."""
    from adaptaqc_tpu_torch.utils import gradients
    from adaptaqc_tpu_torch.utils.ansatzes import identity_resolvable
    from adaptaqc_tpu_torch.utils.constants import CMAP_LINEAR
    layer = identity_resolvable()
    gens, degs = gradients.get_generators_and_degeneracies(layer, True,
                                                           inverse=True)
    ops = gradients.prepare_gradient_ops(gradients.zero_ansatz_inverse(layer),
                                         gens)
    start = Circuit(n)
    for q in range(n):
        start.ry(0.3 + 0.1 * q, q)
    return ops, degs, generate_coupling_map(n, CMAP_LINEAR), start


def verify_circuit(target, n, seed=31):
    """set_mps(target), then a random chain of rotations and CX: what the
    verifier re-simulates."""
    rng = np.random.default_rng(seed)
    qc = Circuit(n)
    qc.set_mps(target)
    for _ in range(2):
        for q in range(n):
            qc.ry(float(rng.uniform(-1, 1)), q)
        for q in range(n - 1):
            qc.cx(q, q + 1)
    return qc


def verify_cost(backend, qc):
    """AdaptCompiler._true_cost_of_gate_circuit on `backend` (it reads
    nothing of the compiler but its backend)."""
    import types
    return AdaptCompiler._true_cost_of_gate_circuit(
        types.SimpleNamespace(backend=backend), qc)


def _random_circuit(n, depth, rng):
    """tests/test_torch_full_cost_sweep.random_circuit."""
    qc = Circuit(n)
    for _ in range(depth):
        kind = rng.choice(["rx", "ry", "rz", "cx", "h"])
        if kind == "cx":
            a, b = rng.choice(n, 2, replace=False)
            qc.cx(int(a), int(b))
        elif kind == "h":
            qc.h(int(rng.integers(n)))
        else:
            getattr(qc, kind)(float(rng.uniform(-np.pi, np.pi)),
                              int(rng.integers(n)))
    return qc


def full_sweep(engine, seed, mesh=None, force_host=False, dev="cpu"):
    """One local-cost Rotoselect cycle over a new layer
    (tests/test_torch_full_cost_sweep.py's _prepared and _minimize) on
    the engine's backend, over `mesh` where given: (cost, angles, gate
    names of the variational range)."""
    from adaptaqc_tpu_torch.circuits import operations as co
    from adaptaqc_tpu_torch.utils import constants as vconstants
    layer = Circuit(2)
    layer.ry(0.0, [0, 1])
    layer.cx(0, 1)
    layer.ry(0.0, [0, 1])
    cls = SVBackend if engine == "sv" else MPSBackend
    comp = AdaptCompiler(
        _random_circuit(4, 20, np.random.default_rng(seed)),
        backend=cls(device=dev, dtype=C128, mesh=mesh),
        custom_layer_2q_gate=layer, optimise_local_cost=True)
    idx = comp._add_entangling_layer(0)
    if force_host:
        comp.minimizer._can_full_sweep = lambda *_a, **_k: False
    else:
        assert comp.minimizer._can_full_sweep(True)
    cost = comp.minimizer.minimize_cost(
        algorithm_kind=vconstants.ALG_ROTOSELECT, max_cycles=1,
        stop_val=-np.inf, tol=1e-10, indexes_to_modify=idx)
    rng = comp.variational_circuit_range()
    return (cost, np.asarray(co.find_angles_in_circuit(comp.full_circuit,
                                                       rng)),
            [comp.full_circuit.data[i].name for i in range(*rng)])


def _r1_cases(mesh, dev):
    """R1 and R2 on the shards: the pair contraction, the gradient
    heuristic, the verifier (each with the largest collective it ran
    against one site), the full-cost terms of one state and of a batch,
    and the full-cost sweep on the device path and the host loop."""
    from adaptaqc_tpu_torch.utils import gradients
    out = {}
    ops_a, ops_b = r1_ops()
    pair = []
    for n, chi, pairs in PAIR_CASES:
        bra, ket = (pm.shard_mps(mesh, r1_state(n, chi, s)) for s in (3, 4))
        pm.STATS["max_numel"] = 0
        z = mps_sharded.pair_op_overlaps(mesh, bra, ket, ops_a, ops_b,
                                         np.asarray(pairs), n - 1)
        pair.append(dict(z=z, max_numel=pm.STATS["max_numel"],
                         site=2 * chi * chi))
    out["pair_ops"] = pair

    n, chi = GRAD_SIZE
    ops, degs, cmap, start = grad_inputs(n)
    psi = pm.shard_mps(mesh, r1_state(n, chi, 5))
    pm.STATS["max_numel"] = 0
    grads = gradients.general_grad_of_pairs_device(
        psi, start, ops, degs, cmap,
        MPSBackend(max_chi=chi, device=dev, dtype=C128, mesh=mesh), n)
    out["grad"] = dict(grads=np.asarray(grads),
                       max_numel=pm.STATS["max_numel"], site=2 * chi * chi)

    n, chi = VERIFY_SIZE
    backend = MPSBackend(max_chi=chi, device=dev, dtype=C128, mesh=mesh)
    qc = verify_circuit(pm.shard_mps(mesh, r1_state(n, chi, 6)), n)
    pm.STATS["max_numel"] = 0
    cost = verify_cost(backend, qc)
    out["verify"] = dict(cost=cost, max_numel=pm.STATS["max_numel"],
                         site=2 * (2 * chi) ** 2)

    # full_cost_terms: one state and a batch of 3 (the probes of one gate
    # on a sharded state), SV n = 6 and MPS n = 6, chi = 8
    u = sv_core.build_u4(torch.tensor([1, 2, 3]),  # rx, ry, rz
                         torch.tensor([0.3, -0.7, 1.1], dtype=torch.float64),
                         C128)
    mps = pm.shard_mps(mesh, r1_state(6, 8, 7))
    mref = mps_sharded.zero_mps(mesh, 6, 8, C128, dev)
    mbatch = mps_sharded.apply_gate(mesh, mps, 2, 2, 0, u, 0.0)
    g = torch.Generator().manual_seed(8)
    x = torch.randn(2 ** 6, dtype=C128, generator=g)
    x = (x / x.norm()).to(dev)
    xs = pm.shard_state(mesh, x)
    sref = sv_sharded.zero_state(mesh, 6, C128, dev)
    sbatch = sv_sharded.apply_gate(mesh, xs, 2, 5, 0, u)  # qubit 5: global
    terms = {}
    for name, fn, st, ref in (("mps", mps_sharded, mps, mref),
                              ("mps_batch", mps_sharded, mbatch, mref),
                              ("sv", sv_sharded, xs, sref),
                              ("sv_batch", sv_sharded, sbatch, sref)):
        terms[name] = dict(terms=[t for t in fn.full_cost_terms(mesh, st,
                                                                ref)],
                           state=pm.unshard(st))
    out["cost_terms"] = terms

    full = {}
    for engine, seed, _ in FULL_CASES:
        full[engine] = dict(device=full_sweep(engine, seed, mesh, dev=dev),
                            host=full_sweep(engine, seed, mesh, True, dev))
    out["full_sweep"] = full
    return out


def _sv_step(mesh, n, tape, pairs, dev):
    step = pm.make_training_step(mesh, n, tape.padded_length)
    nk, na, cost, rhos, evals = step(sv_core.zero_state(n, C128, dev), tape,
                                     tape.trainable, pairs)
    return dict(kinds=nk, angles=na, cost=cost, rhos=rhos, evals=evals)


def run_all():
    from torch.distributed.tensor.debug import CommDebugMode
    mesh = pm.make_mesh(8)
    dev = pm.rank_device()
    out = {"mesh": tuple(mesh.shape)}

    n = 6
    pairs = np.asarray(generate_coupling_map(n, CMAP_FULL), np.int32)
    out["sv_step"] = _sv_step(mesh, n, random_tape(n, 8), pairs, dev)
    pairs3 = np.asarray(generate_coupling_map(3, CMAP_FULL), np.int32)
    out["pad_step"] = _sv_step(mesh, 3, random_tape(3, 4, seed=3), pairs3,
                               dev)

    state = SVBackend(device=dev, dtype=C128,
                      mesh=mesh).initial_state(Circuit(6), 6)
    out["layout"] = dict(local=tuple(pm.local(state).shape),
                         placements=[str(p) for p in state.placements])

    n, chi = 20, 32
    tape = random_tape(n, 12, seed=9)
    step = pm.make_mps_training_step(mesh, n, chi, tape.padded_length)
    nk, na, cost, l_state, rhos, evals = step(
        mps_core.zero_mps(n, chi, C128, dev), tape, tape.trainable)
    out["mps_step"] = dict(kinds=nk, angles=na, cost=cost, rhos=rhos,
                           shards=tuple(pm.local(l_state.b).shape),
                           lam_shards=tuple(pm.local(l_state.lam).shape))

    # the observables the backends' cost layers read, on the swept MPS and
    # on a random statevector, against the unsharded engines on the same
    # (gathered) states
    full = pm.unshard(l_state)
    cost0, h10 = mps_core.softened_cost_terms(full)
    cost, h1 = mps_sharded.softened_cost_terms(mesh, l_state)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2 ** 6, dtype=C128, generator=g)
    x = (x / x.norm()).to(dev)
    xs, ref = pm.shard_state(mesh, x), sv_core.zero_state(6, C128, dev)
    terms = sv_sharded.full_cost_terms(mesh, xs, pm.shard_state(mesh, ref))
    terms0 = sv_core.full_cost_terms(x, ref)
    out["observables"] = dict(
        mps_z=float((mps_sharded.z_expectations(mesh, l_state)
                     - mps_core.z_expectations(full)).abs().max()),
        mps_cost=float(abs(cost - cost0)), mps_h1=float(abs(h1 - h10)),
        mps_global=float(abs(mps_sharded.global_cost_normalized(mesh, l_state)
                             - mps_core.global_cost_normalized(full))),
        sv_z=float((sv_sharded.z_expectations(mesh, xs)
                    - sv_core.z_expectations(x)).abs().max()),
        sv_terms=max(float(abs(a - b)) for a, b in zip(terms, terms0)),
        sv_global=float(abs(sv_sharded.global_cost(mesh, xs)
                            - sv_core.global_cost(x))),
        sv_rdm=max(float((sv_sharded.rdm2(mesh, xs, a, b)
                          - sv_core.rdm2(x, a, b)).abs().max())
                   for a, b in ((0, 5), (5, 4), (4, 1), (2, 3))))

    # collectives: the MPS step's, and the SV step's largest payload (one
    # shard: the state is never gathered whole)
    n, chi = 6, 16
    tape = random_tape(n, 4, seed=2)
    step = pm.make_mps_training_step(mesh, n, chi, tape.padded_length)
    with CommDebugMode() as comm:
        step(mps_core.zero_mps(n, chi, C128, dev), tape, tape.trainable)
    out["mps_comms"] = {str(k): v for k, v in comm.get_comm_counts().items()}
    n = 10
    tape = random_tape(n, 6, seed=4)
    before = dict(pm.STATS)
    pm.STATS["max_numel"] = 0
    with CommDebugMode() as comm:
        res = _sv_step(mesh, n, tape, np.asarray([[0, 1], [8, 9], [2, 9],
                                                  [7, 8]], np.int32), dev)
    out["sv_comms"] = {str(k): v for k, v in comm.get_comm_counts().items()}
    out["sv_comm_stats"] = dict(
        collectives=pm.STATS["collectives"] - before["collectives"],
        max_numel=pm.STATS["max_numel"], shard=2 ** n // 4)
    out["sv_step10"] = res

    # the backends' compiles
    target = create_random_initial_state_circuit(4, seed=21)
    np.random.seed(7)
    res = AdaptCompiler(target, backend=SVBackend(
        device=dev, dtype=C128, mesh=mesh)).compile()
    out["sv_compile"] = dict(pairs=res.qubit_pair_history,
                             overlap=res.overlap,
                             exact=res.exact_overlap)
    np.random.seed(11)
    comp = AdaptCompiler(mps_target(), backend=MPSBackend(
        device=dev, dtype=C128, mesh=mesh),
        adapt_config=AdaptConfig(max_layers=MPS_COMPILE_LAYERS))
    with cplx.verification_eigh():
        res = comp.compile()
    out["mps_compile"] = dict(pairs=res.qubit_pair_history,
                              overlap=res.overlap)

    # a checkpoint of the sharded compile: every rank encodes (the payload
    # is gathered), rank 0 loads it back; the mesh is not stored
    data = pickle.dumps(comp)
    if dist.get_rank() == 0:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "c.pkl")
            with open(path, "wb") as f:
                f.write(data)
            loaded = checkpoint.load(path)
        payload = loaded.full_circuit.data[0].payload
        out["checkpoint"] = dict(
            mesh=loaded.backend.mesh, plain=isinstance(payload.b,
                                                       torch.Tensor)
            and type(payload.b) is torch.Tensor,
            chi=payload.chi,
            b=mps_core.to_dense(payload))
    dist.barrier()

    # the chi schedule carries the mesh into each stage's backend
    meshes = []

    class Recording(MPSBackend):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            meshes.append(self.mesh is mesh)

    adapt_compiler.MPSBackend = Recording
    try:
        np.random.seed(11)
        with cplx.verification_eigh():
            res = AdaptCompiler(
                mps_target(), backend=Recording(
                    max_chi=2, device=dev, dtype=C128, mesh=mesh),
                adapt_config=AdaptConfig(max_layers=2),
            ).compile_with_chi_schedule(chis=(2, 4))
    finally:
        adapt_compiler.MPSBackend = MPSBackend
    out["schedule"] = dict(meshes=meshes, chis=[c for c, _ in
                                                res.chi_schedule],
                           pairs=res.qubit_pair_history,
                           overlap=res.overlap)

    # the dry run's rank function at small sizes
    out["dryrun"] = entry._dryrun_rank(8, dict(entry.DRYRUN_SIZES,
                                               **DRYRUN_SIZES))
    out.update(_r1_cases(mesh, dev))
    return out
