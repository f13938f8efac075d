"""The port's zigzag sweeps (optim/sweeps.py: _zz_forward, _zz_backward,
sweep_zigzag_until_converged, sweep_zigzag_n_cycles; CostMinimiser's
zigzag switch) against the JAX package's, in float64 on the CPU (JAX at
x64, the port in complex128), on the statevector and the MPS engine (n =
5-6, chi = 8), with inputs made from numpy seeds.

Tolerances: kinds and evaluation counts equal, angles 1e-8, costs 1e-10;
a compile's pair sequence equal and its costs 1e-6. The JAX MPS engine runs
its XLA path (no Pallas, no env cache); the port's MPS compile runs under
cplx.verification_eigh() (the plain K2-K4 are Python loops)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adaptaqc_tpu as jport
from adaptaqc_tpu.backends import mps_core as jmps
from adaptaqc_tpu.backends import sv_core as jsv
from adaptaqc_tpu.optim import sweeps as jsweeps

import adaptaqc_tpu_torch as port
from adaptaqc_tpu_torch.backends import mps_core, sv_core
from adaptaqc_tpu_torch.circuits.circuit import Circuit
from adaptaqc_tpu_torch.circuits.tape import compile_tape
from adaptaqc_tpu_torch.ops import cplx
from adaptaqc_tpu_torch.optim import minimiser, sweeps

torch.set_num_threads(1)
C128 = torch.complex128
THR = 1e-16


def _circuits(n, layers, seed):
    """A random entangling target and a window of dressed-CNOT layers on
    random (ordered or reversed, near or far) pairs. No rz ends the
    window on a qubit: in front of the projection onto |0> its cost is
    flat, every angle a minimum, and the pick is rounding noise."""
    rng = np.random.default_rng(seed)
    target = Circuit(n)
    for q in range(n):
        target.ry(float(rng.uniform(-3, 3)), q)
    for layer in range(3):
        for q in range(layer % 2, n - 1, 2):
            target.cx(q, q + 1)
        for q in range(n):
            target.rz(float(rng.uniform(-3, 3)), q)
    ansatz = Circuit(n)
    for _ in range(layers):
        a, b = (int(x) for x in rng.choice(n, 2, replace=False))
        ansatz.rz(float(rng.uniform(-1, 1)), a)
        ansatz.ry(float(rng.uniform(-1, 1)), b)
        ansatz.cx(a, b)
        ansatz.rx(float(rng.uniform(-1, 1)), a)
        ansatz.ry(float(rng.uniform(-1, 1)), b)
    return compile_tape(target), compile_tape(ansatz)


def _jargs(tape):
    return (jnp.asarray(tape.kinds), jnp.asarray(tape.q0),
            jnp.asarray(tape.q1), jnp.asarray(tape.angles),
            jnp.asarray(tape.trainable))


def _setup(kind, n=5, layers=4, seed=3):
    """(engine, prefix, ref) of both packages and the ansatz tape; the
    port's states are the JAX ones carried over."""
    tt, at = _circuits(n, layers, seed)
    tk, tq0, tq1, tang, _ = _jargs(tt)
    if kind == "sv":
        jprefix = jsv.apply_tape(jsv.zero_state(n, jnp.float64), tk, tq0,
                                 tq1, tang)
        jref = jsv.zero_state(n, jnp.float64)
        prefix = sv_core.state_from_numpy(np.asarray(jprefix.re),
                                          np.asarray(jprefix.im), dtype=C128)
        return ((jsv.sweep_engine(), jprefix, jref),
                (sv_core.sweep_engine(), prefix,
                 sv_core.zero_state(n, C128)), at)
    chi = 8
    jprefix = jmps.apply_tape(jmps.zero_mps(n, chi, jnp.float64), tk, tq0,
                              tq1, tang, THR)
    jeng = jmps.sweep_engine(THR, allow_pallas=False, allow_env_cache=False)
    prefix = mps_core.mps_from_numpy(
        np.asarray(jprefix.b.re), np.asarray(jprefix.b.im),
        np.asarray(jprefix.lam), np.asarray(jprefix.trunc), dtype=C128)
    return ((jeng, jprefix, jmps.zero_mps(n, chi, jnp.float64)),
            (mps_core.sweep_engine(THR, eigh="native"), prefix,
             mps_core.zero_mps(n, chi, C128)), at)


def _jax_r_buf(engine, ref, args):
    flip = lambda t: jax.tree.map(lambda v: jnp.flip(v, 0), t)

    def back(s, x):
        k, a, b, th, _ = x
        return engine.apply_adjoint(s, k, a, b, th), s

    _, r_rev = jax.lax.scan(back, ref, flip(args))
    return flip(r_rev)


def _port_tape(prefix, tape):
    struct, q0, q1, sel = sweeps._host_structure(tape.kinds, tape.q0,
                                                 tape.q1, tape.trainable)
    kd, ad = sweeps._device_tape(prefix, tape.kinds, tape.angles)
    return struct, q0, q1, sel, kd, ad


@pytest.mark.parametrize("rotoselect", [True, False],
                         ids=["rotoselect", "rotosolve"])
@pytest.mark.parametrize("kind", ["sv", "mps"])
def test_forward_and_backward_cycles_match_jax(kind, rotoselect):
    """One forward cycle from the R states at the input angles, then one
    backward cycle from the forward's L states: kinds equal, angles 1e-8,
    overlaps 1e-10, evaluations equal."""
    (jeng, jprefix, jref), (eng, prefix, ref), at = _setup(kind)
    args = _jargs(at)
    jr_buf = _jax_r_buf(jeng, jref, args)
    jk, ja, jov2, _, jev, jl_buf = jsweeps._zz_forward(
        jeng, rotoselect, jprefix, jref, args, jr_buf)
    struct, q0, q1, sel, kd, ad = _port_tape(prefix, at)
    r_buf, _ = sweeps._zz_right_states(eng, ref, struct, q0, q1, kd, ad)
    kd, ad, ov2, _, ev, l_buf = sweeps._zz_forward(
        eng, rotoselect, prefix, ref, struct, q0, q1, kd, ad, sel, r_buf)
    np.testing.assert_array_equal(kd.numpy(), np.asarray(jk))
    np.testing.assert_allclose(ad.numpy(), np.asarray(ja), atol=1e-8)
    assert abs(float(ov2) - float(jov2)) < 1e-10
    assert ev == int(jev)

    args = (jk, args[1], args[2], ja, args[4])
    jk, ja, jov2, jev, _ = jsweeps._zz_backward(
        jeng, rotoselect, jprefix, jref, args, jl_buf)
    kd, ad, ov2, ev, _ = sweeps._zz_backward(
        eng, rotoselect, prefix, ref, struct, q0, q1, kd, ad, sel, l_buf)
    np.testing.assert_array_equal(kd.numpy(), np.asarray(jk))
    np.testing.assert_allclose(ad.numpy(), np.asarray(ja), atol=1e-8)
    assert abs(float(ov2) - float(jov2)) < 1e-10
    assert ev == int(jev)


@pytest.mark.parametrize("kind", ["sv", "mps"])
def test_zigzag_until_converged_matches_jax(kind):
    """sweep_zigzag_until_converged (Rotoselect, stop 1e-5, tol 1e-5, at
    most 9 cycles): kinds equal, angles 1e-8, final cost and cost0 1e-10,
    cycles and evaluations equal; the returned state is prefix + tape at
    the returned angles (1e-10)."""
    (jeng, jprefix, jref), (eng, prefix, ref), at = _setup(kind)
    out = jsweeps.sweep_zigzag_until_converged(
        jeng, True, 9, jprefix, jref, *_jargs(at),
        jnp.asarray(1e-5), jnp.asarray(1e-5))
    jk, ja, jc, jcyc, jev, _, jc0 = out
    tk, ta, tc, tcyc, tev, state, tc0 = sweeps.sweep_zigzag_until_converged(
        eng, True, 9, prefix, ref, at.kinds, at.q0, at.q1, at.angles,
        at.trainable, 1e-5, 1e-5)
    np.testing.assert_array_equal(tk, np.asarray(jk))
    np.testing.assert_allclose(ta, np.asarray(ja), atol=1e-8)
    assert abs(tc - float(jc)) < 1e-10 and abs(tc0 - float(jc0)) < 1e-10
    assert tcyc == int(jcyc) and tev == int(jev)
    assert tc <= tc0 + 1e-12
    fresh = sweeps.apply_all(eng, prefix, tk, at.q0, at.q1, ta)
    assert abs(abs(complex(eng.overlap(fresh, state)))
               - abs(complex(eng.overlap(state, state)))) < 1e-10
    assert abs(1 - abs(complex(eng.overlap(ref, state))) ** 2 - tc) < 1e-10


@pytest.mark.parametrize("kind", ["sv", "mps"])
def test_zigzag_n_cycles_matches_jax(kind):
    """sweep_zigzag_n_cycles, 2 pairs, Rotosolve: kinds equal, angles
    1e-8, cost 1e-10, evaluations equal."""
    (jeng, jprefix, jref), (eng, prefix, ref), at = _setup(kind, seed=5)
    jk, ja, jc, jev = jsweeps.sweep_zigzag_n_cycles(
        jeng, False, 2, jprefix, jref, *_jargs(at))
    tk, ta, tc, tev = sweeps.sweep_zigzag_n_cycles(
        eng, False, 2, prefix, ref, at.kinds, at.q0, at.q1, at.angles,
        at.trainable)
    np.testing.assert_array_equal(tk, np.asarray(jk))
    np.testing.assert_allclose(ta, np.asarray(ja), atol=1e-8)
    assert abs(tc - float(jc)) < 1e-10 and tev == int(jev)


@pytest.mark.parametrize("kind", ["sv", "mps"])
def test_first_forward_cycle_is_the_standard_sweep(kind):
    """A forward cycle given the R states at the input angles is the
    standard sweep: the same kinds, angles and overlap to 1e-12, the same
    evaluations (the JAX package's tests/test_state_caching.py:273)."""
    _, (eng, prefix, ref), at = _setup(kind, n=6, layers=5, seed=9)
    sk, sa, _, sstate, sev, sov2 = sweeps.sweep(
        eng, at.padded_length, True, prefix, ref, at.kinds, at.q0, at.q1,
        at.angles, at.trainable)
    struct, q0, q1, sel, kd, ad = _port_tape(prefix, at)
    r_buf, _ = sweeps._zz_right_states(eng, ref, struct, q0, q1, kd, ad)
    kd, ad, ov2, _, ev, _ = sweeps._zz_forward(
        eng, True, prefix, ref, struct, q0, q1, kd, ad, sel, r_buf)
    np.testing.assert_array_equal(kd.numpy(), sk)
    np.testing.assert_allclose(ad.numpy(), sa, atol=1e-12)
    assert abs(float(ov2) - sov2) < 1e-12 and ev == sev


def _jax_compile(kind, zigzag):
    backend = (jport.SVBackend() if kind == "sv"
               else jport.MPSBackend(max_chi=8))
    qc = _target(jport)
    np.random.seed(2)
    return jport.AdaptCompiler(
        qc, backend=backend, zigzag=zigzag,
        adapt_config=jport.AdaptConfig(method="basic", max_layers=4,
                                       cost_improvement_num_layers=100)
    ).compile()


def _port_compile(kind, zigzag):
    backend = (port.SVBackend(dtype=C128, device="cpu") if kind == "sv"
               else port.MPSBackend(max_chi=8, dtype=C128, device="cpu"))
    qc = _target(port)
    comp = port.AdaptCompiler(
        qc, backend=backend, zigzag=zigzag,
        adapt_config=port.AdaptConfig(method="basic", max_layers=4,
                                      cost_improvement_num_layers=100))
    assert comp.minimizer.zigzag is zigzag
    with cplx.verification_eigh():
        return comp.compile()


def _target(pkg, n=4, seed=3):
    rng = np.random.default_rng(seed)
    qc = pkg.Circuit(n)
    for _ in range(3):
        for q in range(n):
            qc.ry(float(rng.uniform(-3, 3)), q)
        for q in range(n - 1):
            qc.cx(q, q + 1)
    return qc


@pytest.mark.parametrize("kind", ["sv", "mps"])
def test_compile_with_zigzag_matches_jax(kind):
    """AdaptCompiler(zigzag=True), 'basic' pairs, 4 layers, n = 4: the
    JAX compile's pair sequence, its cost history to 1e-6 and its
    overlap to 1e-6."""
    jres = _jax_compile(kind, True)
    tres = _port_compile(kind, True)
    assert tres.qubit_pair_history == jres.qubit_pair_history
    np.testing.assert_allclose(tres.global_cost_history,
                               jres.global_cost_history, atol=1e-6)
    assert abs(tres.overlap - jres.overlap) < 1e-6


def test_zigzag_runs_the_zigzag_sweep(monkeypatch):
    """With zigzag the minimiser calls sweep_zigzag_until_converged and
    not the standard loop; without, never."""
    calls = []
    real = sweeps.sweep_zigzag_until_converged

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(sweeps, "sweep_zigzag_until_converged", counting)
    _port_compile("sv", True)
    assert calls
    calls.clear()
    _port_compile("sv", False)
    assert not calls


def test_zigzag_flag_reads_the_environment(monkeypatch):
    """zigzag=None reads ADAPTAQC_ZIGZAG, as the JAX package does; unset,
    it is off, so default trajectories are unchanged; an explicit argument
    wins over the variable."""
    monkeypatch.delenv("ADAPTAQC_ZIGZAG", raising=False)
    qc = _target(port)
    backend = port.SVBackend(dtype=C128, device="cpu")
    assert port.AdaptCompiler(qc, backend=backend).minimizer.zigzag is False
    assert minimiser.CostMinimiser(None, None, None).zigzag is False
    monkeypatch.setenv("ADAPTAQC_ZIGZAG", "1")
    assert port.AdaptCompiler(qc, backend=backend).minimizer.zigzag is True
    assert (jport.AdaptCompiler(_target(jport)).minimizer.zigzag
            is True)
    assert port.AdaptCompiler(qc, backend=backend,
                              zigzag=False).minimizer.zigzag is False
    monkeypatch.setenv("ADAPTAQC_ZIGZAG", "0")
    assert port.AdaptCompiler(qc, backend=backend).minimizer.zigzag is False


def test_zigzag_is_carried_to_clones_and_checkpoints(tmp_path):
    """The flag rides in _ctor_kwargs (compile_in_parts and the chi
    schedule's stages) and through a checkpoint."""
    from adaptaqc_tpu_torch.io import checkpoint
    comp = port.AdaptCompiler(
        _target(port), backend=port.SVBackend(dtype=C128, device="cpu"),
        zigzag=True, adapt_config=port.AdaptConfig(method="basic",
                                                   max_layers=2))
    assert comp._ctor_kwargs["zigzag"] is True
    clone = comp._clone_with_target(_target(port))
    assert clone.minimizer.zigzag is True and clone.profile_dir is None
    comp.compile(checkpoint_every=1, checkpoint_dir=str(tmp_path))
    loaded = checkpoint.load(str(tmp_path / "1.pkl"))
    assert loaded.minimizer.zigzag is True
