"""Rotosolve under rotosolve_fraction < 1 (the subsampled O(G) device sweep:
one sweep a cycle over a fresh random subsample of the window's rotation
gates) against the JAX package, in float64 on the CPU.

Both packages draw each cycle's subsample with the stdlib `random` module,
so the same seed gives the same masks: the masks are compared first (a
difference there is a sampling fault, not an optimiser one), then the
angles to 1e-8 and the evaluation counts exactly."""

import random

import numpy as np
import pytest
import torch

import adaptaqc_tpu as jport
from adaptaqc_tpu.circuits import operations as jco
from adaptaqc_tpu.optim import minimiser as jmin

import adaptaqc_tpu_torch as port
from adaptaqc_tpu_torch.circuits import operations as co
from adaptaqc_tpu_torch.circuits.tape import compile_tape, select_mask
from adaptaqc_tpu_torch.ops import cplx
from adaptaqc_tpu_torch.optim import minimiser as tmin

torch.set_num_threads(1)
C128 = torch.complex128


def _backends(kind):
    if kind == "sv":
        return jport.SVBackend(), port.SVBackend(dtype=C128, device="cpu")
    return (jport.mps_backend_with_args(max_chi=4),
            port.mps_backend_with_args(max_chi=4, dtype=C128, device="cpu"))


def _ry_layer(cls):
    """A two-qubit block that Rotosolve alone can train (the default
    block needs Rotoselect to choose its rotation axes)."""
    qc = cls(2)
    for q in (0, 1):
        qc.ry(0.0, q)
    qc.cx(0, 1)
    for q in (0, 1):
        qc.ry(0.0, q)
    return qc


def _compile(pkg, ops, backend, n, seed, layers):
    random.seed(seed)
    np.random.seed(seed)
    qc = ops.create_random_initial_state_circuit(n, seed=seed)
    compiler = pkg.AdaptCompiler(
        qc, backend=backend, rotosolve_fraction=0.5, use_rotoselect=False,
        custom_layer_2q_gate=_ry_layer(pkg.Circuit),
        adapt_config=pkg.AdaptConfig(method="basic", max_layers=layers))
    return compiler.compile()


def _recording(monkeypatch, cls, masks):
    orig = cls._cycle_mask

    def record(self, tape, full_mask, base_indices, rotoselect):
        mask = orig(self, tape, full_mask, base_indices, rotoselect)
        masks.append(np.asarray(mask).copy())
        return mask
    monkeypatch.setattr(cls, "_cycle_mask", record)


def _rotation_circuit(cls, n=3, layers=3):
    """Rotations and CNOTs from a numpy seed (the same in both packages)."""
    rng = np.random.default_rng(4)
    qc = cls(n)
    for _ in range(layers):
        for q in range(n):
            getattr(qc, ("rx", "ry", "rz")[rng.integers(3)])(
                float(rng.uniform(-np.pi, np.pi)), q)
        qc.cx(0, 1)
        qc.cx(1, 2)
    return qc


def _angles(result):
    return np.array([float(p) for i in result.circuit.data for p in i.params])


def test_cycle_masks_match_jax_for_one_seed():
    """One tape, the same stdlib seed: every draw of _cycle_mask is the
    same subsample in both packages, and ceil(fraction x rotations) gates
    of the window are selected, all of them rotations of the window."""
    qc, jqc = _rotation_circuit(port.Circuit), _rotation_circuit(jport.Circuit)
    tape = compile_tape(qc)
    from adaptaqc_tpu.circuits.tape import compile_tape as jcompile_tape
    from adaptaqc_tpu.circuits.tape import select_mask as jselect_mask
    jtape = jcompile_tape(jqc)
    base = list(range(len(qc.data)))
    tm = tmin.CostMinimiser(None, None, None, rotosolve_fraction=0.5)
    jm = jmin.CostMinimiser(None, None, None, rotosolve_fraction=0.5)
    full_t = select_mask(tape, base)
    full_j = jselect_mask(jtape, base)
    assert np.array_equal(np.asarray(full_t), np.asarray(full_j))
    n_rot = sum(1 for i in base if tape.data_index_map[i][1] == 1
                and tape.trainable[tape.data_index_map[i][0]])
    for seed in (0, 1, 2):
        random.seed(seed)
        mt = [np.asarray(tm._cycle_mask(tape, full_t, base, False))
              for _ in range(4)]
        random.seed(seed)
        mj = [np.asarray(jm._cycle_mask(jtape, full_j, base, False))
              for _ in range(4)]
        for a, b in zip(mt, mj):
            assert np.array_equal(a, b)
            assert int(a.sum()) == int(np.ceil(0.5 * n_rot))
            assert not np.any(a & ~np.asarray(full_t))
    # Rotoselect, or a fraction of 1, takes the whole window
    assert tm._cycle_mask(tape, full_t, base, True) is full_t


@pytest.mark.parametrize("backend", ["sv", "mps"])
@pytest.mark.parametrize("seed", [1, 2])
def test_subsampled_rotosolve_compile_matches_jax(monkeypatch, backend,
                                                  seed):
    """A 3-qubit compile of 3 Rotosolve layers at rotosolve_fraction=0.5:
    masks equal draw by draw, then angles 1e-8, evaluation counts and pair
    histories equal."""
    jb, tb = _backends(backend)
    masks_j, masks_t = [], []
    _recording(monkeypatch, jmin.CostMinimiser, masks_j)
    _recording(monkeypatch, tmin.CostMinimiser, masks_t)
    rj = _compile(jport, jco, jb, 3, seed, 3)
    with cplx.verification_eigh():
        rt = _compile(port, co, tb, 3, seed, 3)
    assert len(masks_t) == len(masks_j) > 3
    for a, b in zip(masks_t, masks_j):
        assert np.array_equal(a, b)
    assert rt.qubit_pair_history == rj.qubit_pair_history
    assert rt.cost_evaluations == rj.cost_evaluations
    at, aj = _angles(rt), _angles(rj)
    assert at.shape == aj.shape
    assert np.abs(at - aj).max() < 1e-8
    assert abs(rt.overlap - rj.overlap) < 1e-8


def test_rotosolve_fraction_results_reproducible():
    """test_parity_compile.py::test_rotosolve_fraction_results_reproducible
    on the port: the per-cycle subsample is drawn from the stdlib random
    module, so seeding it reproduces the whole trajectory."""
    qc = co.create_random_initial_state_circuit(3, seed=9)

    def run():
        random.seed(42)
        np.random.seed(42)
        compiler = port.AdaptCompiler(
            qc, backend=port.mps_backend_with_args(dtype=C128, device="cpu"),
            rotosolve_fraction=0.5)
        with cplx.verification_eigh():
            return compiler.compile()

    r1, r2 = run(), run()
    assert r1.overlap == r2.overlap
    assert r1.qubit_pair_history == r2.qubit_pair_history
    assert r1.circuit_qasm == r2.circuit_qasm
