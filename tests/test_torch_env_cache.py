"""The port's incremental probe environments (backends/mps_core.py
SweepEnv, _env_init, _env_touch, _env_probe; optim/sweeps.py EnvOps)
against the JAX package's, in float64 on the CPU (JAX at x64, the port in
complex128), n = 5-6, chi = 8, inputs made from numpy seeds.

Tolerances: the 2x2 probe matrix 1e-10 and the frontier pointers equal;
an env-cached sweep's kinds equal, angles 1e-8, cost 1e-10 against the JAX
env-cached sweep, and the same against the port's full-chain sweep. The
JAX engine runs its XLA path (no Pallas)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptaqc_tpu.backends import mps_core as jmps
from adaptaqc_tpu.circuits.circuit import Circuit as JCircuit
from adaptaqc_tpu.circuits.tape import compile_tape as jcompile
from adaptaqc_tpu.optim import sweeps as jsweeps

from adaptaqc_tpu_torch.backends import mps_core
from adaptaqc_tpu_torch.backends.backend import MPSBackend
from adaptaqc_tpu_torch.circuits.circuit import Circuit
from adaptaqc_tpu_torch.circuits.tape import compile_tape
from adaptaqc_tpu_torch.optim import sweeps

torch.set_num_threads(1)
C128 = torch.complex128
THR = 1e-16


def _random_circuit(pkg_circuit, n, depth, rng):
    qc = pkg_circuit(n)
    for _ in range(depth):
        q = int(rng.integers(n))
        qc.ry(float(rng.uniform(-3, 3)), q)
        qc.rz(float(rng.uniform(-3, 3)), q)
        a, b = (int(x) for x in rng.choice(n, 2, replace=False))
        qc.cx(a, b)
    return qc


def _jax_state(qc, n, chi):
    t = jcompile(qc)
    return jmps.apply_tape(jmps.zero_mps(n, chi, jnp.float64),
                           jnp.asarray(t.kinds), jnp.asarray(t.q0),
                           jnp.asarray(t.q1), jnp.asarray(t.angles), THR)


def _port(st):
    return mps_core.mps_from_numpy(np.asarray(st.b.re), np.asarray(st.b.im),
                                   np.asarray(st.lam), np.asarray(st.trunc),
                                   dtype=C128)


# jitted once for every step and seed: unjitted, each JAX call retraces
_jprobe = jax.jit(jmps._env_probe)
_jtouch = jax.jit(jmps._env_touch)
_japply = jax.jit(lambda st, k, a, b, th: jmps.apply_tape(st, k, a, b, th,
                                                          THR))


def _jax_gate(st, rng, n, chi):
    """One random gate on a JAX state: (new state, first site, last
    site)."""
    if rng.random() < 0.5:
        q = int(rng.integers(n))
        qc = JCircuit(n)
        qc.ry(float(rng.uniform(-3, 3)), q)
        t0 = t1 = q
    else:
        a, b = sorted(int(x) for x in rng.choice(n, 2, replace=False))
        qc = JCircuit(n)
        qc.cx(a, b)
        t0, t1 = a, b
    t = jcompile(qc)
    return (_japply(st, jnp.asarray(t.kinds), jnp.asarray(t.q0),
                    jnp.asarray(t.q1), jnp.asarray(t.angles)), t0, t1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_env_probe_sequence_matches_jax(seed):
    """40 steps at n = 6: each moves R or L by a random gate (touching its
    sites) or probes a random site; every probe's C equals the JAX
    _env_probe's and the full chain's (1e-10), and the pointers equal the
    JAX ones after every step. The buffers stay on the state's device and
    dtype."""
    rng = np.random.default_rng(seed)
    n, chi = 6, 8
    jr = _jax_state(_random_circuit(JCircuit, n, 6, rng), n, chi)
    jl = _jax_state(_random_circuit(JCircuit, n, 6, rng), n, chi)
    jenv = jmps._env_init(jl)
    env = mps_core._env_init(_port(jl))
    assert env.e_buf.dtype == C128 and env.e_buf.device.type == "cpu"
    r, l = _port(jr), _port(jl)
    probes = 0
    for _ in range(40):
        if rng.random() < 0.4:
            if rng.random() < 0.5:
                jr, t0, t1 = _jax_gate(jr, rng, n, chi)
                r = _port(jr)
            else:
                jl, t0, t1 = _jax_gate(jl, rng, n, chi)
                l = _port(jl)
            jenv = _jtouch(jenv, t0, t1, True)
            env = mps_core._env_touch(env, t0, t1)
        else:
            q = int(rng.integers(n))
            jc, jenv = _jprobe(jenv, jr, jl, jnp.int32(q))
            c, env = mps_core._env_probe(env, r, l, q)
            np.testing.assert_allclose(
                c.numpy(), np.asarray(jc.re) + 1j * np.asarray(jc.im),
                atol=1e-10)
            np.testing.assert_allclose(
                c.numpy(), mps_core.local_overlap_matrix(r, l, q).numpy(),
                atol=1e-10)
            probes += 1
        assert (env.e_ptr, env.g_ptr) == (int(jenv.e_ptr), int(jenv.g_ptr))
    assert probes > 10


def _sweep_case(n=5, chi=8, seed=41):
    """test_mps_core.py:112's case: arbitrary pair order and distance (swap
    routing), NOP padding."""
    rng = np.random.default_rng(seed)
    jtarget = _random_circuit(JCircuit, n, 10, rng)
    jprefix = _jax_state(jtarget, n, chi)
    ansatz = Circuit(n)
    for _ in range(8):
        a, b = (int(x) for x in rng.choice(n, 2, replace=False))
        ansatz.ry(float(rng.uniform(-3, 3)), a)
        ansatz.cx(a, b)
        ansatz.ry(float(rng.uniform(-3, 3)), b)
    return jprefix, compile_tape(ansatz)


@pytest.mark.parametrize("rotoselect", [False, True],
                         ids=["rotosolve", "rotoselect"])
@pytest.mark.parametrize("blocks", ["one", "several"])
def test_env_cached_sweep_matches_jax_and_full_chain(rotoselect, blocks):
    """One sweep through the env cache against the JAX env-cached sweep and
    the port's full-chain sweep, single- and multi-block (8 entries a
    block): kinds equal, angles 1e-8, final cost 1e-10, evaluations
    equal."""
    n, chi = 5, 8
    jprefix, tape = _sweep_case(n, chi)
    bl = tape.padded_length if blocks == "one" else 8
    assert tape.padded_length % 8 == 0 and (blocks == "one"
                                            or tape.padded_length > 8)
    args = (jnp.asarray(tape.kinds), jnp.asarray(tape.q0),
            jnp.asarray(tape.q1), jnp.asarray(tape.angles),
            jnp.asarray(tape.trainable))
    jeng = jmps.sweep_engine(THR, allow_pallas=False, allow_env_cache=True)
    jout = jsweeps.sweep(jeng, bl, rotoselect, jprefix,
                         jmps.zero_mps(n, chi, jnp.float64), *args)
    prefix, ref = _port(jprefix), mps_core.zero_mps(n, chi, C128)
    outs = []
    for env in (True, False):
        eng = mps_core.sweep_engine(THR, eigh="native", allow_env_cache=env)
        assert (eng.env_ops is not None) is env
        outs.append(sweeps.sweep(eng, bl, rotoselect, prefix, ref,
                                 tape.kinds, tape.q0, tape.q1, tape.angles,
                                 tape.trainable))
    cached, full = ((k, a, c, ev) for k, a, c, _, ev, _ in outs)
    jax_cached = (np.asarray(jout[0]), np.asarray(jout[1]), float(jout[2]),
                  int(jout[4]))
    for other in (jax_cached, full):
        np.testing.assert_array_equal(cached[0], other[0])
        np.testing.assert_allclose(cached[1], other[1], atol=1e-8)
        assert abs(cached[2] - other[2]) < 1e-10
        assert cached[3] == other[3]


def test_env_cached_sweep_launches_no_chain(monkeypatch):
    """Through the env cache no probe calls the env-chain wrapper (K1 on
    the card); the full-chain engine calls it once a probed gate."""
    from adaptaqc_tpu_torch.ops import env_kernel
    calls = []
    real = env_kernel.env_chain

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(mps_core, "env_chain", counting)
    jprefix, tape = _sweep_case()
    prefix, ref = _port(jprefix), mps_core.zero_mps(5, 8, C128)
    for env in (True, False):
        calls.clear()
        eng = mps_core.sweep_engine(THR, eigh="native", allow_env_cache=env)
        sweeps.sweep(eng, tape.padded_length, True, prefix, ref, tape.kinds,
                     tape.q0, tape.q1, tape.angles, tape.trainable)
        assert len(calls) == (0 if env else int(np.sum(tape.trainable)))


def test_env_cache_flag_reads_the_environment(monkeypatch):
    """allow_env_cache=None reads ADAPTAQC_ENVCACHE as the JAX package does
    (any non-empty value turns it on); unset, it is off, so default
    trajectories are unchanged. MPSBackend.sweep_engine passes None."""
    monkeypatch.delenv("ADAPTAQC_ENVCACHE", raising=False)
    backend = MPSBackend(max_chi=4, dtype=C128, device="cpu")
    assert mps_core.sweep_engine(THR).env_ops is None
    assert backend.sweep_engine().env_ops is None
    assert jmps.sweep_engine(THR, allow_env_cache=None).env_ops is None
    monkeypatch.setenv("ADAPTAQC_ENVCACHE", "1")
    assert mps_core.sweep_engine(THR).env_ops is not None
    assert backend.sweep_engine().env_ops is not None
    assert jmps.sweep_engine(THR, allow_env_cache=None).env_ops is not None
    assert mps_core.sweep_engine(THR, allow_env_cache=False).env_ops is None
