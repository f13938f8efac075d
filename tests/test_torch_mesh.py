"""M7, the device-mesh sharding, against the unsharded port and the JAX
package: the counterpart of tests/test_mesh.py. The port's sharded paths
run in 8 gloo ranks on the CPU, one (dp 2, tp 4) mesh, complex128, all in
one spawn (tests/torch_mesh_cases.py); this process meanwhile runs the
unsharded port and the JAX package on the same inputs (the sweep steps
through JAX's own pmesh training steps on the conftest's 8-device mesh,
the compiles unsharded: tests/test_mesh.py holds JAX's sharded compiles
equal to those).

Tolerances: cost and RDMs 1e-10 (complex128 / x64), Rotoselect kinds
agreeing on at least 80% of the tape (exact ties may break either way,
as tests/test_mesh.py allows); compiles: pair histories equal, overlaps
1e-6 (the MPS compile cut to 3 layers: every collective is a gloo round
trip of about 1.5 ms here); layouts, shard shapes and collective counts
exact; the dry run's complex64 MPS step against the unsharded sweep
1e-6 (chip_smoke.TOL_MESH_C64, the bound the card is held to). R1 and R2
on the shards (the pair contraction, the gradient heuristic's norms, the
verifier's cost, the full-cost terms) 1e-10 against both, with no
collective of the first three past one site; the full-cost device sweep
under the mesh 1e-10 against the unsharded one and within
tests/test_torch_full_cost_sweep.py's bounds (1e-7 SV, 1e-6 MPS) of the
host probe loop.
"""

import types

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the conftest's 8-device CPU mesh, x64)
import jax.numpy as jnp
from adaptaqc_tpu.backends import mps_core as jmps
from adaptaqc_tpu.backends import sv_core as jsv
from adaptaqc_tpu.backends.backend import MPSBackend as JMPSBackend
from adaptaqc_tpu.backends.backend import SVBackend as JSVBackend
from adaptaqc_tpu.circuits.circuit import Circuit as JCircuit
from adaptaqc_tpu.circuits.operations import (
    create_random_initial_state_circuit as jrandom_state)
from adaptaqc_tpu.circuits.tape import compile_tape as jcompile_tape
from adaptaqc_tpu.compilers.adapt_compiler import AdaptCompiler as JCompiler
from adaptaqc_tpu.compilers.adapt_config import AdaptConfig as JAdaptConfig
from adaptaqc_tpu.ops import cplx as jcplx
from adaptaqc_tpu.parallel import mesh as jpmesh
from adaptaqc_tpu.utils import gradients as jgr
from adaptaqc_tpu.utils.ansatzes import identity_resolvable as j_ir

import chip_smoke
import torch_mesh_cases as cases
from adaptaqc_tpu_torch.backends import mps_core, sv_core
from adaptaqc_tpu_torch.backends.backend import MPSBackend, SVBackend
from adaptaqc_tpu_torch.circuits.operations import (
    create_random_initial_state_circuit)
from adaptaqc_tpu_torch.compilers.adapt_compiler import AdaptCompiler
from adaptaqc_tpu_torch.compilers.adapt_config import AdaptConfig
from adaptaqc_tpu_torch.ops import cplx
from adaptaqc_tpu_torch.optim import sweeps
from adaptaqc_tpu_torch.parallel import mesh as pm
from adaptaqc_tpu_torch.utils import gradients
from adaptaqc_tpu_torch.utils.constants import CMAP_FULL, generate_coupling_map
from adaptaqc_tpu_torch.workloads import entry

C128 = torch.complex128
TOL = 1e-10
TOL_OVERLAP = 1e-6
TOL_C64 = chip_smoke.TOL_MESH_C64  # the dry run's complex64 steps


def _jtape(n, depth, seed=0):
    rng = np.random.default_rng(seed)
    qc = JCircuit(n)
    for q in range(n):
        qc.ry(float(rng.uniform(-3, 3)), q)
    for _ in range(depth):
        a = int(rng.integers(n - 1))
        qc.rz(float(rng.uniform(-3, 3)), a)
        qc.cx(a, a + 1)
        qc.rx(float(rng.uniform(-3, 3)), a + 1)
    return jcompile_tape(qc)


def _jmps_target(n=4, seed=5):
    rng = np.random.default_rng(seed)
    qc = JCircuit(n)
    for _ in range(2):
        for q in range(n):
            qc.ry(float(rng.uniform(-3, 3)), q)
        for q in range(n - 1):
            qc.cx(q, q + 1)
    return qc


def _jmps(state):
    """A port MPS (complex128, CPU) as the JAX package's."""
    return jmps.MPS(jcplx.from_np(state.b.numpy(), jnp.float64),
                    jnp.asarray(state.lam.numpy()),
                    jnp.asarray(state.trunc.numpy()))


def _jcircuit(qc, target):
    """The port's verifier circuit in the JAX package: set_mps(target)
    and the same gates."""
    out = JCircuit(qc.num_qubits)
    out.set_mps(target)
    for ins in qc.data[1:]:
        getattr(out, ins.name)(*ins.params, *ins.qubits)
    return out


def _r1_parent():
    """R1 and R2's unsharded and JAX references (the inputs rebuilt from
    the cases' seeds: the same bits)."""
    out = {}
    ops_a, ops_b = cases.r1_ops()
    jops = (jcplx.from_np(ops_a.numpy(), jnp.float64),
            jcplx.from_np(ops_b.numpy(), jnp.float64))
    out["pair_ops"] = []
    for n, chi, pairs in cases.PAIR_CASES:
        bra, ket = (cases.r1_state(n, chi, s) for s in (3, 4))
        pairs = np.asarray(pairs)
        out["pair_ops"].append(dict(
            port=mps_core.pair_op_overlaps(bra, ket, ops_a, ops_b, pairs,
                                           n - 1).numpy(),
            jax=jcplx.to_np(jmps.pair_op_overlaps(
                _jmps(bra), _jmps(ket), *jops,
                jnp.asarray(pairs, jnp.int32), n - 1))))
    n, chi = cases.GRAD_SIZE
    ops, degs, cmap, start = cases.grad_inputs(n)
    psi = cases.r1_state(n, chi, 5)
    port = gradients.general_grad_of_pairs_device(
        psi, start, ops, degs, cmap,
        MPSBackend(max_chi=chi, device="cpu", dtype=C128), n)
    layer = j_ir()
    jgens, jdegs = jgr.get_generators_and_degeneracies(layer, True,
                                                       inverse=True)
    jstart = JCircuit(n)
    for q in range(n):
        jstart.ry(0.3 + 0.1 * q, q)
    jax_grads = jgr.general_grad_of_pairs_device(
        _jmps(psi), jstart,
        jgr.prepare_gradient_ops(jgr.zero_ansatz_inverse(layer), jgens),
        jdegs, cmap, JMPSBackend(max_chi=chi), n)
    out["grad"] = dict(port=np.asarray(port), jax=np.asarray(jax_grads))
    n, chi = cases.VERIFY_SIZE
    target = cases.r1_state(n, chi, 6)
    qc = cases.verify_circuit(target, n)
    out["verify"] = dict(
        port=cases.verify_cost(MPSBackend(max_chi=chi, device="cpu",
                                          dtype=C128), qc),
        jax=JCompiler._true_cost_of_gate_circuit(
            types.SimpleNamespace(backend=JMPSBackend(max_chi=chi)),
            _jcircuit(qc, _jmps(target))))
    out["full_sweep"] = {engine: cases.full_sweep(engine, seed)
                         for engine, seed, _ in cases.FULL_CASES}
    return out


def _port_sv_step(n, tape, pairs):
    zero = sv_core.zero_state(n, C128)
    nk, na, cost, state, _, _ = sweeps.sweep(
        sv_core.sweep_engine(), sweeps.default_block_len(tape.padded_length),
        True, zero, zero, tape.kinds, tape.q0, tape.q1, tape.angles,
        tape.trainable)
    return dict(kinds=nk, cost=cost,
                rhos=sv_core.all_pair_rdms(state, pairs).numpy())


def _parent_side():
    """The unsharded port's and the JAX package's results, made while the
    ranks run."""
    out = {}
    n = 6
    pairs = np.asarray(generate_coupling_map(n, CMAP_FULL), np.int32)
    out["sv_step"] = _port_sv_step(n, cases.random_tape(n, 8), pairs)
    pairs3 = np.asarray(generate_coupling_map(3, CMAP_FULL), np.int32)
    out["pad_step"] = _port_sv_step(3, cases.random_tape(3, 4, seed=3),
                                    pairs3)
    out["sv_step10"] = _port_sv_step(10, cases.random_tape(10, 6, seed=4),
                                     np.asarray([[0, 1], [8, 9], [2, 9],
                                                 [7, 8]], np.int32))
    n, chi = 20, 32
    tape = cases.random_tape(n, 12, seed=9)
    zero = mps_core.zero_mps(n, chi, C128)
    nk, _, cost, state, _, _ = sweeps.sweep(
        mps_core.sweep_engine(0.0),
        sweeps.default_block_len(tape.padded_length,
                                 sweeps.state_nbytes(zero)),
        True, zero, mps_core.zero_mps(n, chi, C128), tape.kinds, tape.q0,
        tape.q1, tape.angles, tape.trainable)
    out["mps_step"] = dict(kinds=nk, cost=cost,
                           rhos=mps_core.all_pair_rdms(state).numpy())

    mesh8 = jpmesh.make_mesh(8)
    n = 6
    jt = _jtape(n, 8)
    step = jpmesh.make_training_step(mesh8, n, jt.padded_length)
    with mesh8:
        nk, _, cost, rhos, _ = step(jsv.zero_state(n), jt, jt.trainable,
                                    pairs)
    out["jax_sv_step"] = dict(kinds=np.asarray(nk), cost=float(cost),
                              rhos=jcplx.to_np(rhos))
    n, chi = 20, 32
    jt = _jtape(n, 12, seed=9)
    step = jpmesh.make_mps_training_step(mesh8, n, chi, jt.padded_length)
    with mesh8:
        nk, _, cost, _, rhos, _ = step(jmps.zero_mps(n, chi), jt,
                                       jt.trainable)
    out["jax_mps_step"] = dict(kinds=np.asarray(nk), cost=float(cost),
                               rhos=jcplx.to_np(rhos))

    np.random.seed(7)
    res = AdaptCompiler(create_random_initial_state_circuit(4, seed=21),
                        backend=SVBackend(device="cpu", dtype=C128)).compile()
    out["sv_compile"] = (res.qubit_pair_history, res.overlap)
    np.random.seed(7)
    res = JCompiler(jrandom_state(4, seed=21), backend=JSVBackend()).compile()
    out["jax_sv_compile"] = (res.qubit_pair_history, res.overlap)
    layers = AdaptConfig(max_layers=cases.MPS_COMPILE_LAYERS)
    np.random.seed(11)
    with cplx.verification_eigh():
        res = AdaptCompiler(cases.mps_target(), backend=MPSBackend(
            device="cpu", dtype=C128), adapt_config=layers).compile()
    out["mps_compile"] = (res.qubit_pair_history, res.overlap)
    np.random.seed(11)
    res = JCompiler(_jmps_target(), backend=JMPSBackend(),
                    adapt_config=JAdaptConfig(
                        max_layers=cases.MPS_COMPILE_LAYERS)).compile()
    out["jax_mps_compile"] = (res.qubit_pair_history, res.overlap)
    np.random.seed(11)
    with cplx.verification_eigh():
        res = AdaptCompiler(
            cases.mps_target(), backend=MPSBackend(max_chi=2, device="cpu",
                                                   dtype=C128),
            adapt_config=AdaptConfig(max_layers=2),
        ).compile_with_chi_schedule(chis=(2, 4))
    out["schedule"] = (res.qubit_pair_history, res.overlap)
    out.update(_r1_parent())
    return out


@pytest.fixture(scope="module")
def run():
    """(the ranks' results, this process's): one spawn for the module."""
    handle = pm.launch(cases.run_all, 8, device="cpu", wait=False)
    try:
        parent = _parent_side()
    finally:
        ranks = handle.result()
    return ranks, parent


def _same_step(got, want, tol=TOL):
    assert abs(got["cost"] - want["cost"]) < tol
    assert np.abs(got["rhos"] - want["rhos"]).max() < tol
    assert np.mean(np.asarray(got["kinds"]) == np.asarray(want["kinds"])) \
        > 0.8


def test_mesh_shape_and_state_layout(run):
    """make_mesh's rule (tp the largest power of two <= 4, dp = 8 / tp),
    and SVBackend(mesh=...).initial_state at n = 6: 2^6 amplitudes over
    tp = 4, 16 a rank, replicated over dp."""
    ranks, _ = run
    assert ranks["mesh"] == (2, 4)
    assert ranks["layout"]["local"] == (16,)
    assert ranks["layout"]["placements"] == ["R", "S(0)"]


@pytest.mark.parametrize("against", ["port", "jax"])
def test_sharded_sweep_matches_unsharded(run, against):
    """The sharded SV step (n = 6, Rotoselect, all 15 pair RDMs dp-sharded)
    against the unsharded port's sweep and JAX's pmesh.make_training_step
    on its 8-device mesh."""
    ranks, parent = run
    want = parent["sv_step" if against == "port" else "jax_sv_step"]
    _same_step(ranks["sv_step"], want)


def test_pair_padding_roundtrip(run):
    """3 pairs over dp = 2: padded to 4 for the sharding, 3 RDMs back, equal
    to the unsharded ones."""
    ranks, parent = run
    assert ranks["pad_step"]["rhos"].shape == (3, 4, 4)
    _same_step(ranks["pad_step"], parent["pad_step"])


@pytest.mark.parametrize("against", ["port", "jax"])
def test_mps_step_real_shape_matches_unsharded(run, against):
    """The MPS step at n = 20, chi = 32: the swept state's bond axis stays
    sharded chi / tp = 8 a rank (b (20, 2, 32, 8), lam (21, 8)), and its
    cost and all-pair RDMs are the unsharded port's and JAX's sharded
    step's."""
    ranks, parent = run
    got = ranks["mps_step"]
    assert got["shards"] == (20, 2, 32, 8)
    assert got["lam_shards"] == (21, 8)
    want = parent["mps_step" if against == "port" else "jax_mps_step"]
    _same_step(got, want)


@pytest.mark.parametrize("name", ["mps_z", "mps_cost", "mps_h1",
                                  "mps_global", "sv_z", "sv_terms",
                                  "sv_global", "sv_rdm"])
def test_sharded_observables_match_unsharded(run, name):
    """What the backends' cost layers read under a mesh, against the
    unsharded engines on the same states: the swept MPS's <Z> per site,
    normalised and softened global costs and Hamming-1 sum; a random
    6-qubit statevector's <Z>, full-cost terms, global cost and RDMs of
    pairs with one, two or no global qubit (qubits 4 and 5 are global at
    tp = 4), 1e-12."""
    ranks, _ = run
    assert ranks["observables"][name] < 1e-12


def test_mps_step_issues_collectives(run):
    """The counterpart of test_mps_step_program_contains_collectives: the
    MPS step at n = 6, chi = 16 issues all-reduces over the tp shards
    (CommDebugMode's count), and no all-gather (gathers are sums of
    zero-padded shards)."""
    ranks, _ = run
    comms = ranks["mps_comms"]
    assert comms.get("c10d.allreduce_", 0) > 0
    assert not any("allgather" in k for k in comms)


def test_sv_step_never_gathers_the_state(run):
    """The SV step at n = 10 over tp = 4 (qubits 8 and 9 global) exchanges
    shards (broadcasts within groups of four, all-reduces of pairs) and
    reduces partial sums, but no collective carries more than one shard
    of 2^10 / 4 amplitudes; its cost and RDMs are the unsharded ones."""
    ranks, parent = run
    comms = ranks["sv_comms"]
    assert comms.get("c10d.broadcast_", 0) > 0
    assert comms.get("c10d.allreduce_", 0) > 0
    stats = ranks["sv_comm_stats"]
    assert stats["collectives"] > 0
    assert stats["max_numel"] <= 2 * stats["shard"] < 2 ** 10
    _same_step(ranks["sv_step10"], parent["sv_step10"])


@pytest.mark.parametrize("against", ["port", "jax"])
def test_sv_backend_compile_matches_unsharded(run, against):
    """AdaptCompiler on SVBackend(mesh=...) (ISL, a random 4-qubit state):
    the unsharded port's and JAX's pair history and overlap."""
    ranks, parent = run
    got = ranks["sv_compile"]
    pairs, overlap = parent["sv_compile" if against == "port"
                            else "jax_sv_compile"]
    assert [tuple(p) for p in got["pairs"]] == [tuple(p) for p in pairs]
    assert abs(got["overlap"] - overlap) < TOL_OVERLAP
    assert got["overlap"] > 0.99 and got["exact"] > 0.99


@pytest.mark.parametrize("against", ["port", "jax"])
def test_mps_backend_compile_matches_unsharded(run, against):
    """AdaptCompiler on MPSBackend(mesh=...) (n = 4, chi = 4 sharded one
    column a rank, native eigensolver on the CPU, its first 3 layers): the
    unsharded port's and JAX's pair history and overlap."""
    ranks, parent = run
    got = ranks["mps_compile"]
    pairs, overlap = parent["mps_compile" if against == "port"
                            else "jax_mps_compile"]
    assert len(got["pairs"]) == cases.MPS_COMPILE_LAYERS
    assert [tuple(p) for p in got["pairs"]] == [tuple(p) for p in pairs]
    assert abs(got["overlap"] - overlap) < TOL_OVERLAP


def test_checkpoint_leaves_the_mesh_out(run):
    """A checkpoint of the sharded MPS compile: the mesh is not stored (as
    in the JAX package), the loaded backend has mesh=None, and the target
    payload comes back whole, the target state of the circuit."""
    ranks, _ = run
    ck = ranks["checkpoint"]
    assert ck["mesh"] is None and ck["plain"] and ck["chi"] == 4
    qc = cases.mps_target()
    dense = MPSBackend(device="cpu", dtype=C128).mps_from_compiler_target(qc)
    want = mps_core.to_dense(dense)
    assert abs(abs(np.vdot(want, ck["b"])) - 1.0) < TOL


def test_chi_schedule_carries_the_mesh(run):
    """compile_with_chi_schedule builds each stage's backend with the
    mesh of its own, and the schedule's result is the unsharded one's."""
    ranks, parent = run
    got = ranks["schedule"]
    assert got["meshes"] and all(got["meshes"])
    assert got["chis"] == [2, 4]
    pairs, overlap = parent["schedule"]
    assert [tuple(p) for p in got["pairs"]] == [tuple(p) for p in pairs]
    assert abs(got["overlap"] - overlap) < TOL_OVERLAP


def test_dryrun_multichip_at_small_sizes(run):
    """dryrun_multichip's rank function on the 8 ranks (small sizes): its
    four parts pass their assertions; the MPS shards are (n, 2, chi, chi /
    tp); the sharded-only statevector's shard fits the budget its whole
    state exceeds."""
    ranks, _ = run
    d = ranks["dryrun"]
    assert d["platform"] == "cpu" and d["sv"]["pairs"] == 15
    assert d["mps"]["shards"] == (6, 2, 16, 4)
    assert d["mps_big"]["shards"] == (8, 2, 32, 8)
    big = d["sv_big"]
    state = 8 * 2 ** big["n"]
    assert big["shard_bytes"] == state // 8 <= big["budget"] < state
    for part in ("sv", "mps", "mps_big", "sv_big"):
        assert d[part]["cost"] <= 1.0 + 1e-6


def test_dryrun_big_mps_step_matches_unsharded(run):
    """The dry run's large MPS step (here n = 8, chi = 32 over tp = 4,
    complex64) against the unsharded sweep of its own tape
    (chip_smoke.unsharded_mps_step, as the mesh phase holds the chi = 256
    step on the card): cost and every RDM entry within TOL_C64."""
    ranks, _ = run
    big = ranks["dryrun"]["mps_big"]
    assert big["chi"] // big["shards"][-1] == 4
    with cplx.verification_eigh():
        cost0, rhos0 = chip_smoke.unsharded_mps_step(
            big["tape"], big["shards"][0], big["chi"], "cpu")
    assert abs(big["cost"] - cost0) < TOL_C64
    assert np.abs(big["rhos"] - rhos0).max() < TOL_C64


def test_dryrun_multichip_launches_its_ranks(monkeypatch):
    """dryrun_multichip(n) starts n ranks of _dryrun_rank through
    mesh.launch on the device and backend it is given, with the JAX
    package's sizes."""
    seen = []
    monkeypatch.setattr(pm, "launch",
                        lambda *a, **k: seen.append((a, k)) or {"ok": 1})
    assert entry.dryrun_multichip(4, device="cpu") == {"ok": 1}
    (args, kwargs), = seen
    assert args[0] is entry._dryrun_rank and args[1:3] == (4, 4)
    assert args[3] == dict(n=6, big=(8, 256), sv_n=24)
    assert kwargs == dict(device="cpu", backend=None)


def test_shared_card_without_gloo_raises(monkeypatch):
    """Ranks that share a card need backend="gloo" (NCCL refuses two ranks
    on one device): without it the launch raises before any rank starts;
    one card a rank takes NCCL by default; the CPU takes gloo only."""
    import torch.multiprocessing as mp
    monkeypatch.setattr(mp, "spawn", lambda *a, **k: pytest.fail("spawned"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        pm.resolve_backend(4, "cuda", None)
    with pytest.raises(ValueError, match="backend='gloo'"):
        pm.launch(entry._dryrun_rank, 4, 4, {}, device="cuda")
    with pytest.raises(ValueError, match="backend='gloo'"):
        pm.resolve_backend(4, "cuda", "nccl")
    assert pm.resolve_backend(4, "cuda", "gloo") == "gloo"
    assert pm.resolve_backend(1, "cuda", None) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert pm.resolve_backend(4, "cuda", None) == "nccl"
    assert pm.resolve_backend(8, "cpu", None) == "gloo"
    with pytest.raises(ValueError):
        pm.resolve_backend(8, "cpu", "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.resolve_backend(2, "cuda", None)


@pytest.mark.parametrize("case", range(len(cases.PAIR_CASES)))
@pytest.mark.parametrize("against", ["port", "jax"])
def test_pair_op_overlaps_on_shards(run, against, case):
    """mps_sharded.pair_op_overlaps on chi-sharded states (n = 7, chi = 8
    linear pairs; n = 6, chi = 16 pairs of span up to 5, some descending;
    3 operators of 2 Schmidt terms) against mps_core.pair_op_overlaps on
    the whole states and the JAX package's, 1e-10; no collective carries
    more than one site (2 chi^2 elements)."""
    ranks, parent = run
    got = ranks["pair_ops"][case]
    assert np.abs(got["z"] - parent["pair_ops"][case][against]).max() < TOL
    assert 0 < got["max_numel"] <= got["site"]


@pytest.mark.parametrize("against", ["port", "jax"])
def test_gradient_norms_on_shards(run, against):
    """The general_gradient heuristic's pair norms on MPSBackend(mesh=...)
    (n = 6, chi = 8, a linear map, identity_resolvable's generators, a
    rotation start) through the sharded contraction, against the
    unsharded port's and the JAX package's, 1e-10; no collective past one
    site."""
    ranks, parent = run
    got = ranks["grad"]
    assert np.abs(got["grads"] - parent["grad"][against]).max() < TOL
    assert max(got["grads"]) > 1e-3
    assert 0 < got["max_numel"] <= got["site"]


@pytest.mark.parametrize("against", ["port", "jax"])
def test_verifier_cost_on_shards(run, against):
    """The verifier (_true_cost_of_gate_circuit) on MPSBackend(mesh=...):
    the sharded target (n = 8, chi = 8) padded and resharded to chi 16, the
    adjoint re-simulation and the norms on the shards, against the
    unsharded port's and the JAX package's cost, 1e-10; no collective past
    one site at chi 16."""
    ranks, parent = run
    got = ranks["verify"]
    assert abs(got["cost"] - parent["verify"][against]) < TOL
    assert 0 < got["max_numel"] <= got["site"]


@pytest.mark.parametrize("name", ["mps", "mps_batch", "sv", "sv_batch"])
@pytest.mark.parametrize("against", ["port", "jax"])
def test_full_cost_terms_on_shards(run, against, name):
    """full_cost_terms of a sharded state and of a batch of 3 (rx, ry, rz
    probes of one gate: on MPS site 2, on statevector qubit 5, a global
    qubit at tp = 4), n = 6, against the unsharded engine and the JAX
    package's on each state, 1e-10."""
    ranks, _ = run
    got = ranks["cost_terms"][name]
    states = got["state"]
    mps = name.startswith("mps")
    if mps:
        states = mps_core.MPS(*(torch.as_tensor(t) for t in states))
    ref = (mps_core.zero_mps(6, 8, C128) if mps
           else sv_core.zero_state(6, C128))
    one = not name.endswith("batch")
    for p in range(1 if one else 3):
        st = (states if one else
              mps_core.MPS(states.b[p], states.lam[p], states.trunc[p]) if mps
              else torch.as_tensor(states[p]))
        if against == "port":
            want = (mps_core if mps else sv_core).full_cost_terms(
                st if mps else torch.as_tensor(st), ref)
        elif mps:
            want = jmps.full_cost_terms(_jmps(st), _jmps(ref))
        else:
            want = jsv.full_cost_terms(
                jcplx.from_np(np.asarray(st), jnp.float64),
                jcplx.from_np(ref.numpy(), jnp.float64))
        for g, w in zip(got["terms"], want):
            g = np.asarray(g) if one else np.asarray(g)[p]
            assert abs(float(g) - float(np.asarray(w))) < TOL


@pytest.mark.parametrize("engine", [c[0] for c in cases.FULL_CASES])
def test_full_cost_sweep_on_the_mesh(run, engine):
    """The local-cost full-cost sweep (one Rotoselect cycle over a new
    layer, n = 4) on the mesh's engines, which now carry cost_terms: the
    device path against the unsharded device path (cost and angles 1e-10,
    gates equal) and against the host probe loop under the mesh within
    1e-7 (SV) / 1e-6 (MPS)."""
    ranks, parent = run
    tol = dict((e, t) for e, _, t in cases.FULL_CASES)[engine]
    dev_cost, dev_ang, dev_names = ranks["full_sweep"][engine]["device"]
    host_cost, host_ang, host_names = ranks["full_sweep"][engine]["host"]
    cost0, ang0, names0 = parent["full_sweep"][engine]
    assert dev_names == names0
    assert abs(dev_cost - cost0) < TOL
    np.testing.assert_allclose(dev_ang, ang0, atol=TOL)
    assert abs(dev_cost - host_cost) < tol
    if host_cost > 1e-10:
        assert dev_names == host_names
        np.testing.assert_allclose(dev_ang, host_ang, atol=tol)
