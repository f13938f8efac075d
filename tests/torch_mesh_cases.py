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
# the MPS compile's layers (its 5 to the stop take 20,000 collectives, about
# 80 s of gloo round trips here; the first 3 already hold every path)
MPS_COMPILE_LAYERS = 3


random_tape = entry.example_tape  # tests/test_mesh.py's _random_tape


def mps_target():
    """tests/test_mesh.py's MPS compile target (chip_smoke's mesh phase
    compiles it too)."""
    return chip_smoke.mesh_target(Circuit)


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
    return out
