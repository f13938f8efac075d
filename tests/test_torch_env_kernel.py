"""The port's environment-chain kernel (plain version, CPU) against the JAX
package: the Pallas kernel in interpret mode and the XLA-path
local_overlap_matrix. Inputs are the same MPS states, built by the JAX
engine and carried into the port with mps_from_numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptaqc_tpu.backends import mps_core as jmps
from adaptaqc_tpu.circuits.circuit import Circuit as JCircuit
from adaptaqc_tpu.circuits.tape import compile_tape as jcompile
from adaptaqc_tpu.ops import cplx as jcplx
from adaptaqc_tpu.ops import pallas_env

from adaptaqc_tpu_torch.backends import mps_core
from adaptaqc_tpu_torch.circuits.circuit import Circuit
from adaptaqc_tpu_torch.circuits.tape import compile_tape
from adaptaqc_tpu_torch.ops import env_kernel

torch.set_num_threads(1)


def _jax_state(n, chi, seed, dtype):
    rng = np.random.default_rng(seed)
    qc = JCircuit(n)
    for _ in range(2):
        for q in range(n):
            qc.ry(float(rng.uniform(-3, 3)), q)
            qc.rz(float(rng.uniform(-3, 3)), q)
        for q in range(n - 1):
            qc.cx(q, q + 1)
    tape = jcompile(qc)
    return jmps.apply_tape(
        jmps.zero_mps(n, chi, dtype), jnp.asarray(tape.kinds),
        jnp.asarray(tape.q0), jnp.asarray(tape.q1),
        jnp.asarray(tape.angles).astype(dtype), 1e-12)


def _to_port(st, dtype):
    return mps_core.mps_from_numpy(np.asarray(st.b.re), np.asarray(st.b.im),
                                   np.asarray(st.lam), np.asarray(st.trunc),
                                   dtype=dtype)


@pytest.mark.parametrize("q", [0, 3, 7])
def test_env_chain_plain_matches_pallas_interpret_f32(q):
    """Same bra/ket tensors through the Pallas kernel (interpret mode) and
    env_chain_plain: abs 1e-5 in float32 (the bound of test_pallas_env)."""
    n, chi = 8, 8
    r = _jax_state(n, chi, 1, jnp.float32)
    l_ = _jax_state(n, chi, 2, jnp.float32)
    ref = jcplx.to_np(pallas_env.env_chain(jmps.b_tensors(r),
                                           jmps.b_tensors(l_), q,
                                           interpret=True))
    out = env_kernel.env_chain(_to_port(r, torch.complex64).b,
                               _to_port(l_, torch.complex64).b, q)
    assert out.dtype == torch.complex64
    assert np.abs(out.numpy() - ref).max() < 1e-5


@pytest.mark.parametrize("q", [0, 4, 7])
def test_local_overlap_matches_jax_f64(q):
    """Against the JAX XLA-path local_overlap_matrix in float64: 1e-10."""
    n, chi = 8, 8
    r = _jax_state(n, chi, 3, jnp.float64)
    l_ = _jax_state(n, chi, 4, jnp.float64)
    ref = jcplx.to_np(jmps.local_overlap_matrix(r, l_, jnp.int32(q)))
    rp, lp = _to_port(r, torch.complex128), _to_port(l_, torch.complex128)
    out = mps_core._local_overlap_dispatch(rp, lp, q)
    assert np.abs(out.numpy() - ref).max() < 1e-10
    plain = mps_core.local_overlap_matrix(rp, lp, q)
    assert np.abs(plain.numpy() - ref).max() < 1e-10


def _port_state(n, chi, seed):
    rng = np.random.default_rng(seed)
    qc = Circuit(n)
    for _ in range(3):
        for q in range(n):
            qc.ry(float(rng.uniform(-3, 3)), q)
            qc.rx(float(rng.uniform(-3, 3)), q)
        for q in range(n - 1):
            qc.cx(q, q + 1)
    tape = compile_tape(qc)
    return mps_core.apply_tape(mps_core.zero_mps(n, chi, torch.complex128),
                               tape.kinds, tape.q0, tape.q1, tape.angles,
                               1e-14, eigh="native")


@pytest.mark.parametrize("q", [0, 2, 5])
def test_env_chain_chi_not_multiple_of_8(q):
    """chi = 6 (no lane alignment, which the TPU kernel required): the
    wrapper's float32 result against the port's own float64
    local_overlap_matrix, 1e-5."""
    n, chi = 6, 6
    r = _port_state(n, chi, 5)
    l_ = _port_state(n, chi, 6)
    ref = mps_core.local_overlap_matrix(r, l_, q).numpy()
    out = env_kernel.env_chain(r.b.to(torch.complex64),
                               l_.b.to(torch.complex64), q)
    assert np.abs(out.numpy() - ref).max() < 1e-5


def test_env_chain_launch_counter_untouched_on_cpu():
    """The plain path is not a launch: the counter moves only when the CUDA
    kernel is launched."""
    r = _port_state(4, 4, 7)
    before = env_kernel.env_chain.launches
    env_kernel.env_chain(r.b, r.b, 1)
    assert env_kernel.env_chain.launches == before
