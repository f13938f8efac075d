"""The port's Rotoselect sweep against the JAX sweep, on a scaled-down copy
of bench.py's workload (n = 8, chi = 8): a layered random-entangling target
and a window of dressed-CNOT layers. In float64 the JAX engine runs its XLA
path (no Pallas) and both must pick the same kinds and angles; in float32
the JAX engine runs its teig eigensolver kernels in interpret mode and only
the final costs are compared (float32 trajectories are chaotic, ROADMAP section 3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptaqc_tpu.backends import mps_core as jmps
from adaptaqc_tpu.circuits.circuit import Circuit as JCircuit
from adaptaqc_tpu.circuits.tape import compile_tape as jcompile
from adaptaqc_tpu.ops import cplx as jcplx
from adaptaqc_tpu.optim import sweeps as jsweeps

from adaptaqc_tpu_torch.backends import mps_core
from adaptaqc_tpu_torch.optim import sweeps

torch.set_num_threads(1)


def _workload(n, window_layers, seed=0):
    """bench.build_workload's circuits (3 target layers) at small n."""
    rng = np.random.default_rng(seed)
    target = JCircuit(n)
    for q in range(n):
        target.ry(float(rng.uniform(-3, 3)), q)
    for layer in range(3):
        for q in range(layer % 2, n - 1, 2):
            target.cx(q, q + 1)
        for q in range(n):
            target.rz(float(rng.uniform(-3, 3)), q)
    ansatz = JCircuit(n)
    for _ in range(window_layers):
        a = int(rng.integers(n - 1))
        ansatz.rz(0.1, a)
        ansatz.rz(0.1, a + 1)
        ansatz.cx(a, a + 1)
        ansatz.rz(0.1, a)
        ansatz.rz(0.1, a + 1)
    return jcompile(target), jcompile(ansatz)


def _jax_prefix(ttape, n, chi, jdt):
    return jmps.apply_tape(jmps.zero_mps(n, chi, jdt),
                           jnp.asarray(ttape.kinds), jnp.asarray(ttape.q0),
                           jnp.asarray(ttape.q1),
                           jnp.asarray(ttape.angles).astype(jdt), 1e-16)


def _port(st, tdt):
    return mps_core.mps_from_numpy(np.asarray(st.b.re), np.asarray(st.b.im),
                                   np.asarray(st.lam), np.asarray(st.trunc),
                                   dtype=tdt)


def _jax_sweep(prefix, atape, n, chi, jdt, allow_pallas):
    engine = jmps.sweep_engine(1e-16, allow_pallas=allow_pallas,
                               allow_env_cache=False)
    ref = jmps.zero_mps(n, chi, jdt)
    bl = atape.padded_length
    out = jsweeps.sweep(engine, bl, True, prefix, ref,
                        jnp.asarray(atape.kinds), jnp.asarray(atape.q0),
                        jnp.asarray(atape.q1),
                        jnp.asarray(atape.angles).astype(jdt),
                        jnp.asarray(atape.trainable))
    return (np.asarray(out[0]), np.asarray(out[1]), float(out[2]),
            int(out[4]))


def _port_sweep(prefix, atape, n, chi, tdt, block_len=None):
    engine = mps_core.sweep_engine(1e-16)
    ref = mps_core.zero_mps(n, chi, tdt)
    bl = block_len or sweeps.default_block_len(atape.padded_length,
                                               sweeps.state_nbytes(ref))
    kinds, angles, cost, _, evals, _ = sweeps.sweep(
        engine, bl, True, prefix, ref, atape.kinds, atape.q0, atape.q1,
        atape.angles, atape.trainable)
    return kinds, angles, cost, evals


@pytest.mark.parametrize("block_len", [None, 8], ids=["one_block", "blocks"])
def test_sweep_matches_jax_x64(block_len):
    """Same new kinds, angles within 1e-8, final cost within 1e-10; the
    checkpointed (several-block) sweep gives the single-block result."""
    n, chi = 8, 8
    ttape, atape = _workload(n, 4)
    jprefix = _jax_prefix(ttape, n, chi, jnp.float64)
    jk, ja, jc, jev = _jax_sweep(jprefix, atape, n, chi, jnp.float64, False)
    tk, ta, tc, tev = _port_sweep(_port(jprefix, torch.complex128), atape, n,
                                  chi, torch.complex128, block_len)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_allclose(ta, ja, atol=1e-8)
    assert abs(tc - jc) < 1e-10
    assert tev == jev


def test_sweep_f32_final_cost_matches_jax_interpret(monkeypatch):
    """float32: the JAX sweep with its teig eigensolver kernels in interpret
    mode (its env-chain kernel has no CPU interpret route inside the sweep,
    so probes take its XLA path) against the port's plain kernels; final
    costs within 1e-4."""
    monkeypatch.setenv("ADAPTAQC_PALLAS_INTERPRET", "1")
    prev = jcplx.EIGH_IMPL
    try:
        jcplx.set_eigh_impl("teig")
        n, chi = 8, 8
        ttape, atape = _workload(n, 3, seed=1)
        jprefix = _jax_prefix(ttape, n, chi, jnp.float32)
        _, _, jc, _ = _jax_sweep(jprefix, atape, n, chi, jnp.float32, False)
    finally:
        jcplx.set_eigh_impl(prev or "")
    _, _, tc, _ = _port_sweep(_port(jprefix, torch.complex64), atape, n, chi,
                              torch.complex64)
    assert abs(tc - jc) < 1e-4


def test_sweep_until_converged_and_n_cycles():
    """The convergence loop lowers the cost monotonically from cost0 and its
    evals count 7 per Rotoselect probe (plus the initial evaluation);
    sweep_n_cycles(1) equals one sweep."""
    n, chi = 6, 4
    ttape, atape = _workload(n, 2, seed=2)
    jprefix = _jax_prefix(ttape, n, chi, jnp.float64)
    prefix = _port(jprefix, torch.complex128)
    engine = mps_core.sweep_engine(1e-16)
    ref = mps_core.zero_mps(n, chi, torch.complex128)
    bl = atape.padded_length
    k, a, cost, cycles, evals, state, cost0 = sweeps.sweep_until_converged(
        engine, bl, True, 5, prefix, ref, atape.kinds, atape.q0, atape.q1,
        atape.angles, atape.trainable, -np.inf, 1e-12)
    n_probe = int(np.sum(atape.trainable))
    assert 1 <= cycles <= 5
    assert evals == 1 + 7 * n_probe * cycles
    assert cost <= cost0 + 1e-12
    ov = mps_core.mps_dot(ref, state)
    assert abs(1 - float(ov.real ** 2 + ov.imag ** 2) - cost) < 1e-12
    k1, a1, c1, _ = sweeps.sweep_n_cycles(engine, bl, True, 1, prefix, ref,
                                          atape.kinds, atape.q0, atape.q1,
                                          atape.angles, atape.trainable)
    k2, a2, c2, _, _, _ = sweeps.sweep(engine, bl, True, prefix, ref,
                                       atape.kinds, atape.q0, atape.q1,
                                       atape.angles, atape.trainable)
    np.testing.assert_array_equal(k1, k2)
    np.testing.assert_allclose(a1, a2, atol=0)
    assert c1 == c2


@pytest.mark.parametrize("budget", ["3e6", "1e6", "2500000"])
@pytest.mark.parametrize("padded_len,state_bytes", [(64, 40_000),
                                                     (48, 50_000)])
def test_block_len_reads_the_memory_budget(monkeypatch, budget, padded_len,
                                           state_bytes):
    """default_block_len reads ADAPTAQC_SWEEP_MEMORY_BUDGET where and as
    the JAX package does: budgets above and below padded_len * state_bytes
    (2.56e6 and 2.4e6 bytes) pick one block or the sqrt-style block alike,
    and an explicit memory_budget wins over the variable."""
    monkeypatch.setenv("ADAPTAQC_SWEEP_MEMORY_BUDGET", budget)
    got = sweeps.default_block_len(padded_len, state_bytes)
    assert got == jsweeps.default_block_len(padded_len, state_bytes)
    fits = padded_len * state_bytes <= int(float(budget))
    assert (got == padded_len) == fits
    over = 10 * padded_len * state_bytes
    assert sweeps.default_block_len(padded_len, state_bytes, over) == (
        padded_len) == jsweeps.default_block_len(padded_len, state_bytes,
                                                 over)
    under = padded_len * state_bytes - 1
    assert sweeps.default_block_len(padded_len, state_bytes, under) == (
        jsweeps.default_block_len(padded_len, state_bytes, under)) < (
        padded_len)
    assert sweeps.default_block_len(padded_len) == (
        jsweeps.default_block_len(padded_len))
