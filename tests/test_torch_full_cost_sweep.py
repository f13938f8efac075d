"""The port's full-cost sweep (local and softened costs): its device path
against its own host probe loop, and against the JAX package's full-cost
sweep on the same numpy-seeded circuits, case for case with
tests/test_full_cost_sweep.py. Everything runs on the CPU in complex128
(the JAX package in x64, on its XLA path): kinds must be equal, angles
agree to 1e-8 and costs to 1e-10 between the two packages; device against
host within the JAX test's own bounds (1e-7 on the statevector, 1e-6 on the
MPS engine)."""

import numpy as np
import pytest
import torch

import adaptaqc_tpu as jport
from adaptaqc_tpu.circuits import operations as jco
from adaptaqc_tpu.utils import constants as jconstants

import adaptaqc_tpu_torch as port
from adaptaqc_tpu_torch.circuits import operations as co
from adaptaqc_tpu_torch.circuits.tape import compile_tape, select_mask
from adaptaqc_tpu_torch.ops import cplx
from adaptaqc_tpu_torch.optim import sweeps
from adaptaqc_tpu_torch.utils import constants as vconstants

torch.set_num_threads(1)
C128 = torch.complex128
KW = dict(device="cpu", dtype=C128)

PKGS = {
    "jax": dict(pkg=jport, co=jco, consts=jconstants,
                sv=lambda: jport.SVBackend(),
                mps=lambda: jport.MPSBackend()),
    "torch": dict(pkg=port, co=co, consts=vconstants,
                  sv=lambda: port.SVBackend(**KW),
                  mps=lambda: port.MPSBackend(**KW)),
}


def random_circuit(circuit_cls, n, depth, rng):
    """tests/test_sv_core.random_circuit for either package's Circuit."""
    qc = circuit_cls(n)
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


def _ry_dressed_layer(circuit_cls):
    """A CX dressed with ry only: under the Z-basis local cost a trailing rz
    is cost-flat, and the minimiser's angle for it is a rounding-noise
    tie."""
    qc = circuit_cls(2)
    qc.ry(0.0, [0, 1])
    qc.cx(0, 1)
    qc.ry(0.0, [0, 1])
    return qc


def _prepared(which, engine, seed, n=4, depth=20, **kwargs):
    p = PKGS[which]
    qc = random_circuit(p["pkg"].Circuit, n, depth,
                        np.random.default_rng(seed))
    comp = p["pkg"].AdaptCompiler(
        qc, backend=p[engine](),
        custom_layer_2q_gate=_ry_dressed_layer(p["pkg"].Circuit), **kwargs)
    return comp, comp._add_entangling_layer(0)


def _minimize(which, comp, layer_indexes, rotoselect, force_host):
    p = PKGS[which]
    if force_host:
        comp.minimizer._can_full_sweep = lambda *_a, **_k: False
        assert not comp.minimizer._can_fast_sweep()
    alg = (p["consts"].ALG_ROTOSELECT if rotoselect
           else p["consts"].ALG_ROTOSOLVE)
    cost = comp.minimizer.minimize_cost(
        algorithm_kind=alg, max_cycles=1, stop_val=-np.inf, tol=1e-10,
        indexes_to_modify=layer_indexes)
    rng = comp.variational_circuit_range()
    angles = p["co"].find_angles_in_circuit(comp.full_circuit, rng)
    names = [comp.full_circuit.data[i].name for i in range(*rng)]
    return cost, np.asarray(angles), names


CASES = [("sv", 21, dict(optimise_local_cost=True), 1e-7),
         ("mps", 22, dict(optimise_local_cost=True), 1e-6)]


@pytest.mark.parametrize("rotoselect", [False, True])
@pytest.mark.parametrize("engine,seed,kwargs,tol", CASES)
def test_local_cost_device_matches_host(engine, seed, kwargs, tol,
                                        rotoselect):
    ca, idx_a = _prepared("torch", engine, seed, **kwargs)
    cb, idx_b = _prepared("torch", engine, seed, **kwargs)
    assert idx_a == idx_b
    assert ca.minimizer._can_full_sweep(rotoselect)
    cost_dev, ang_dev, names_dev = _minimize("torch", ca, idx_a, rotoselect,
                                             force_host=False)
    cost_host, ang_host, names_host = _minimize("torch", cb, idx_b,
                                                rotoselect, force_host=True)
    assert abs(cost_dev - cost_host) < tol
    if cost_host > 1e-10:  # below the floor, tie-broken probes may differ
        assert names_dev == names_host
        np.testing.assert_allclose(ang_dev, ang_host, atol=tol)


@pytest.mark.parametrize("rotoselect", [False, True])
@pytest.mark.parametrize("engine,seed,kwargs,tol", CASES)
def test_local_cost_sweep_matches_jax(engine, seed, kwargs, tol, rotoselect):
    """Same circuit, same layer, one cycle in both packages: kinds equal,
    angles to 1e-8, cost to 1e-10."""
    cj, idx_j = _prepared("jax", engine, seed, **kwargs)
    ct, idx_t = _prepared("torch", engine, seed, **kwargs)
    assert idx_j == idx_t
    cost_j, ang_j, names_j = _minimize("jax", cj, idx_j, rotoselect, False)
    cost_t, ang_t, names_t = _minimize("torch", ct, idx_t, rotoselect, False)
    assert names_t == names_j
    assert abs(cost_t - cost_j) < 1e-10
    np.testing.assert_allclose(ang_t, ang_j, atol=1e-8)


@pytest.mark.parametrize("engine,tol", [("mps", 1e-6), ("sv", 1e-7)])
def test_softened_cost_device_matches_host_and_jax(engine, tol):
    comps = {}
    for which in ("torch", "torch_host", "jax"):
        c, idx = _prepared(which.split("_")[0], engine, 23,
                           soften_global_cost=True)
        # a nonzero alpha needs a cost history (compile() fills it)
        c.global_cost_history = [0.7]
        comps[which] = _minimize(which.split("_")[0], c, idx, False,
                                 force_host=which.endswith("host"))
    cost_dev, ang_dev, _ = comps["torch"]
    cost_host, ang_host, _ = comps["torch_host"]
    cost_j, ang_j, _ = comps["jax"]
    assert abs(cost_dev - cost_host) < tol
    if cost_host > 1e-10:
        np.testing.assert_allclose(ang_dev, ang_host, atol=tol)
    assert abs(cost_dev - cost_j) < 1e-10
    np.testing.assert_allclose(ang_dev, ang_j, atol=1e-8)


def test_softened_cost_layer_matches_jax():
    """evaluate_global_cost under soften_global_cost: the MPS and the
    statevector backends against the JAX package's, to 1e-10."""
    for engine in ("mps", "sv"):
        vals = []
        for which in ("jax", "torch"):
            c, _ = _prepared(which, engine, 25, soften_global_cost=True)
            c.global_cost_history = [0.6]
            vals.append(c.backend.evaluate_global_cost(c))
        assert abs(vals[0] - vals[1]) < 1e-10


def test_soften_and_local_together_raise():
    qc = random_circuit(port.Circuit, 3, 6, np.random.default_rng(1))
    with pytest.raises(ValueError, match="soften_global_cost"):
        port.AdaptCompiler(qc, backend=port.SVBackend(**KW),
                           optimise_local_cost=True, soften_global_cost=True)


def test_local_cost_compile_uses_device_path(monkeypatch):
    """A whole local-cost compile goes through the full-cost sweep (no
    silent host loop) and converges; the JAX package's bound (0.9)."""
    calls = {"n": 0}
    orig = sweeps.sweep_full_chunked_until_converged

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(sweeps, "sweep_full_chunked_until_converged",
                        counting)
    qc = random_circuit(port.Circuit, 3, 10, np.random.default_rng(24))
    comp = port.AdaptCompiler(qc, backend=port.SVBackend(**KW),
                              optimise_local_cost=True)
    result = comp.compile()
    assert calls["n"] > 0
    assert result.overlap > 0.9
    assert len(result.local_cost_history) == len(result.qubit_pair_history)


def _sweep_inputs(seed):
    comp, idx = _prepared("torch", "mps", seed, optimise_local_cost=True)
    rng_range = comp.minimizer.variational_circuit_range()
    tape = compile_tape(comp.full_circuit,
                        (rng_range[0], len(comp.full_circuit.data)))
    mask = select_mask(tape, [i - rng_range[0] for i in range(*idx)])
    return (comp.backend.sweep_engine(), comp._prefix_state(),
            comp.backend.zero_ref(comp), tape, mask)


def test_chunked_full_sweep_matches_whole_cycle():
    """A cycle driven in chunks (the left state and the tape carried
    between calls) is the whole-tape cycle: same kinds, angles, cost."""
    engine, prefix, ref, tape, mask = _sweep_inputs(27)
    weights = (0.0, 1.0, 0.0)
    args = (tape.kinds, tape.q0, tape.q1, tape.angles, mask)
    k_w, a_w, cost_w, _, ev_w = sweeps.sweep_full(
        engine, False, prefix, ref, *args, weights)
    k_c, a_c, cost_c, cycles, ev_c, _, _ = \
        sweeps.sweep_full_chunked_until_converged(
            engine, False, 1, prefix, ref, *args, -np.inf, 1e-10, weights,
            chunk=3)
    assert cycles == 1 and ev_w == ev_c
    np.testing.assert_array_equal(k_w, k_c)
    np.testing.assert_allclose(a_w, a_c, atol=1e-12)
    assert abs(cost_w - cost_c) < 1e-12
    # by hand, through sweep_full_chunk
    l_state, kinds, angles = prefix, tape.kinds, tape.angles
    for k0 in range(0, len(tape.kinds), 5):
        kinds, angles, l_state, _ = sweeps.sweep_full_chunk(
            engine, False, 5, k0, l_state, ref, kinds, tape.q0, tape.q1,
            angles, mask, weights)
    np.testing.assert_allclose(angles, a_w, atol=1e-12)


def test_full_sweep_uses_cached_init_state():
    """A caller's init_state (the compiler's full-state cache) replaces the
    probe-free pass that gives cost0: cost0 comes from the given state."""
    engine, prefix, ref, tape, mask = _sweep_inputs(28)
    weights = (0.0, 1.0, 0.0)
    args = (engine, False, 1, prefix, ref, tape.kinds, tape.q0, tape.q1,
            tape.angles, mask, -np.inf, 1e-10, weights)
    *_, cost0_plain = sweeps.sweep_full_chunked_until_converged(*args)
    l0 = sweeps.apply_all(engine, prefix, tape.kinds, tape.q0, tape.q1,
                          tape.angles)
    *_, cost0_cached = sweeps.sweep_full_chunked_until_converged(
        *args, init_state=l0)
    assert abs(cost0_plain - cost0_cached) < 1e-12
    *_, cost0_wrong = sweeps.sweep_full_chunked_until_converged(
        *args, init_state=ref)
    assert abs(cost0_wrong - cost0_plain) > 1e-3


def test_probe_blocks_give_the_same_costs(monkeypatch):
    """Where memory asks for it the probes go through the suffix in blocks:
    the result is that of one batch."""
    engine, prefix, ref, tape, mask = _sweep_inputs(27)
    args = (engine, True, prefix, ref, tape.kinds, tape.q0, tape.q1,
            tape.angles, mask, (0.0, 1.0, 0.0))
    whole = sweeps.sweep_full(*args)
    monkeypatch.setattr(sweeps, "PROBE_MEMORY_BUDGET", 1)  # one probe a block
    blocks = sweeps.sweep_full(*args)
    np.testing.assert_array_equal(whole[0], blocks[0])
    np.testing.assert_allclose(whole[1], blocks[1], atol=1e-12)


@pytest.mark.parametrize("rotoselect", [False, True])
def test_one_qubit_runs_equal_gate_by_gate(rotoselect):
    """An engine with apply_1q_layer applies a run of one-qubit gates behind
    a probed gate as one operation: the same kinds, angles (1e-12) and cost
    as gate by gate."""
    engine, prefix, ref, tape, mask = _sweep_inputs(29)
    assert engine.apply_1q_layer is not None
    args = (prefix, ref, tape.kinds, tape.q0, tape.q1, tape.angles, mask,
            (0.3, 1.0, 0.1))
    runs = sweeps.sweep_full(engine, rotoselect, *args)
    gates = sweeps.sweep_full(engine._replace(apply_1q_layer=None), rotoselect,
                              *args)
    np.testing.assert_array_equal(runs[0], gates[0])
    np.testing.assert_allclose(runs[1], gates[1], atol=1e-12)
    assert abs(runs[2] - gates[2]) < 1e-12 and runs[4] == gates[4]
    plans = sweeps._suffix_plans(
        engine, tape.kinds.tolist(), tape.q0.tolist(),
        torch.eye(4, dtype=C128).expand(len(tape.kinds), 4, 4), -1,
        prefix.n)
    ops = []
    node = plans[0]
    while node is not None:
        ops.append(node[0][0])
        node = node[1]
    assert ops == ["run", "gate", "run"]  # ry ry | cx | ry ry + the rest


def test_hybrid_local_compile_with_global_polish():
    """The hybrid schedule on the MPS backend: local-cost layers over a
    capped window and the periodic global-cost polish, which is seen to run
    (phase_timings) through the O(G) sweep; the JAX test's bound."""
    qc = random_circuit(port.Circuit, 4, 20, np.random.default_rng(26))
    comp = port.AdaptCompiler(
        qc, backend=port.MPSBackend(**KW), optimise_local_cost=True,
        adapt_config=port.AdaptConfig(max_layers=40, sufficient_cost=1e-2,
                                      local_window_layers=4,
                                      global_polish_frequency=1))
    # on the native eigensolver: the plain versions' Python loops would
    # take most of a minute here, and the sweep tests above hold them
    with cplx.verification_eigh():
        result = comp.compile()
    assert result.overlap > 0.97
    assert comp.phase_timings["global_polish"] > 0.0
    assert result.phase_timings["window_rotosolve"] > 0.0


def test_hybrid_compile_pair_history_matches_jax():
    """Brickwall pairs are fixed by the layer count, so both packages must
    stop after the same number of layers on a tie-free target, with local
    costs equal to 1e-8."""
    out = {}
    for which in ("jax", "torch"):
        p = PKGS[which]
        qc = random_circuit(p["pkg"].Circuit, 4, 12,
                            np.random.default_rng(30))
        comp = p["pkg"].AdaptCompiler(
            qc, backend=p["mps"](), optimise_local_cost=True,
            custom_layer_2q_gate=_ry_dressed_layer(p["pkg"].Circuit),
            adapt_config=p["pkg"].AdaptConfig(
                method="brickwall", max_layers=4, local_window_layers=2,
                global_polish_frequency=2))
        with cplx.verification_eigh():
            out[which] = comp.compile()
    assert out["torch"].qubit_pair_history == out["jax"].qubit_pair_history
    np.testing.assert_allclose(out["torch"].local_cost_history,
                               out["jax"].local_cost_history, atol=1e-8)
