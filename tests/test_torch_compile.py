"""The port's MPS compile path against the JAX package, in float64 on the
CPU: the general_gradient pair scores, the chi=1 product-state start, and
the whole slice through AdaptCompiler.compile() on the synthetic random-MPS
target of benchmarks/random_mps.py (scaled down: n = 6, max_chi = 4, at most
8 layers; otherwise its configuration)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptaqc_tpu import AdaptCompiler as JAdaptCompiler
from adaptaqc_tpu import AdaptConfig as JAdaptConfig
from adaptaqc_tpu import mps_backend_with_args as j_mps_backend
from adaptaqc_tpu.backends import mps_core as jmps
from adaptaqc_tpu.utils import compression as jcomp
from adaptaqc_tpu.utils import gradients as jgr
from adaptaqc_tpu.utils.ansatzes import identity_resolvable as j_ir

from adaptaqc_tpu_torch import AdaptCompiler, AdaptConfig, mps_backend_with_args
from adaptaqc_tpu_torch.backends import mps_core
from adaptaqc_tpu_torch.utils import compression, gradients
from adaptaqc_tpu_torch.utils.ansatzes import identity_resolvable
from adaptaqc_tpu_torch.utils.constants import CMAP_LINEAR, generate_coupling_map
from adaptaqc_tpu_torch.utils.targets import random_target

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "benchmarks"))
from random_mps import random_target as j_random_target  # noqa: E402

torch.set_num_threads(1)
C128 = torch.complex128


def _port(st):
    return mps_core.mps_from_numpy(np.asarray(st.b.re), np.asarray(st.b.im),
                                   np.asarray(st.lam), np.asarray(st.trunc),
                                   dtype=C128)


def _target_pair(n, chi):
    """The same random MPS in both packages (the JAX build carried over)."""
    qmps = j_random_target(1, n=n)
    jst = jmps.from_qiskit_mps(qmps, chi)
    return qmps, jst, _port(jst)


def test_random_target_matches_jax():
    qmps_j = j_random_target(3, n=6)
    qmps_t = random_target(3, n=6, dtype=C128, device="cpu")
    a = mps_core.from_qiskit_mps(qmps_j, 2, dtype=C128)
    b = mps_core.from_qiskit_mps(qmps_t, 2, dtype=C128)
    assert abs(abs(complex(mps_core.mps_dot(a, b))) - 1.0) < 1e-10


def test_general_gradients_match_jax():
    """Pair gradient norms of a random state against the product start,
    linear coupling map, n = 6: 1e-8."""
    n, chi = 6, 8
    qmps, jst, tst = _target_pair(n, chi)
    amps = jcomp.best_product_state(jst)
    start = jcomp.product_state_to_circuit(amps)
    t_start = compression.product_state_to_circuit(amps)
    layer = j_ir()
    gens, degs = jgr.get_generators_and_degeneracies(layer, True, inverse=True)
    jops = jgr.prepare_gradient_ops(jgr.zero_ansatz_inverse(layer), gens)
    cmap = generate_coupling_map(n, CMAP_LINEAR)
    jback = j_mps_backend(mps_truncation_threshold=1e-8, max_chi=chi)
    ref = jgr.general_grad_of_pairs_device(jst, start, jops, degs, cmap,
                                           jback, n)
    t_layer = identity_resolvable()
    t_gens, t_degs = gradients.get_generators_and_degeneracies(
        t_layer, True, inverse=True)
    t_ops = gradients.prepare_gradient_ops(
        gradients.zero_ansatz_inverse(t_layer), t_gens)
    assert t_degs == degs
    tback = mps_backend_with_args(mps_truncation_threshold=1e-8, max_chi=chi,
                                  dtype=C128, device="cpu")
    out = gradients.general_grad_of_pairs_device(tst, t_start, t_ops, t_degs,
                                                 cmap, tback, n)
    np.testing.assert_allclose(out, ref, atol=1e-8)
    assert max(out) > 1e-3


def test_best_product_state_matches_jax():
    """The chi=1 compression reaches the same |<s|psi>| as the JAX one
    (same restarts from default_rng(0)): 1e-8."""
    n, chi = 6, 8
    _, jst, tst = _target_pair(n, chi)

    def overlap(amps, st):
        prod = jmps.product_mps(amps, st.chi)
        return abs(complex(jmps.mps_dot(prod, st).re)
                   + 1j * float(jmps.mps_dot(prod, st).im))

    ref = overlap(jcomp.best_product_state(jst), jst)
    out = overlap(compression.best_product_state(tst), jst)
    assert abs(out - ref) < 1e-8
    assert ref > 0.1


def _config(cls):
    return cls(method="general_gradient", cost_improvement_num_layers=1000,
               sufficient_cost=9.5e-3, max_layers=8)


def test_adapt_compile_slice_matches_jax():
    """The whole slice: AdaptCompiler with the paper's settings
    (general_gradient, identity_resolvable layers, product-state start,
    linear map, truncation 1e-8) on random_target(1) at n = 6. The first
    two pair picks are the JAX compile's, and both reach overlap > 0.99."""
    n = 6
    qmps = j_random_target(1, n=n)
    cmap = generate_coupling_map(n, CMAP_LINEAR)
    jc = JAdaptCompiler(
        qmps, backend=j_mps_backend(mps_truncation_threshold=1e-8, max_chi=4),
        adapt_config=_config(JAdaptConfig), coupling_map=cmap,
        custom_layer_2q_gate=j_ir(), starting_circuit="tenpy_product_state")
    jres = jc.compile()
    tc = AdaptCompiler(
        random_target(1, n=n, dtype=C128, device="cpu"),
        backend=mps_backend_with_args(mps_truncation_threshold=1e-8,
                                      max_chi=4, dtype=C128, device="cpu"),
        adapt_config=_config(AdaptConfig), coupling_map=cmap,
        custom_layer_2q_gate=identity_resolvable(),
        starting_circuit="tenpy_product_state")
    tres = tc.compile()
    assert tres.qubit_pair_history[:2] == jres.qubit_pair_history[:2]
    assert jres.overlap > 0.99
    assert tres.overlap > 0.99
    assert tres.num_2q_gates > 0
    # the returned circuit really prepares the target: re-simulate it
    from adaptaqc_tpu_torch.circuits.operations import make_quantum_only_circuit
    from adaptaqc_tpu_torch.circuits.tape import compile_tape
    tape = compile_tape(make_quantum_only_circuit(tres.circuit))
    st = mps_core.apply_tape(mps_core.zero_mps(n, 8, C128), tape.kinds,
                             tape.q0, tape.q1, tape.angles, 1e-16,
                             eigh="native")
    tgt = mps_core.from_qiskit_mps(qmps, 8, dtype=C128)
    ov = abs(complex(mps_core.mps_dot(tgt, st))) ** 2
    assert abs(ov - tres.overlap) < 1e-6


def test_bobyqa_final_minimisation_softened_and_local_paths_run():
    """Every compile option the JAX package runs runs here too, on the MPS
    path: BOBYQA layers (use_roto_algos=False) and the final BOBYQA
    minimisation, which once raised NotImplementedError, end with a finite
    overlap that the final minimisation does not lower; the softened cost
    and the local-cost full sweep, which once raised too, also run."""
    from adaptaqc_tpu_torch.ops import cplx
    qmps = random_target(1, n=4, dtype=C128, device="cpu")
    backend = mps_backend_with_args(max_chi=4, dtype=C128, device="cpu")
    overlaps = {}
    for kw in ({"use_roto_algos": False}, {"perform_final_minimisation": False},
               {"perform_final_minimisation": True}):
        comp = AdaptCompiler(qmps, backend=backend,
                             adapt_config=AdaptConfig(method="basic",
                                                      max_layers=2), **kw)
        with cplx.verification_eigh():
            result = comp.compile()
        assert np.isfinite(result.overlap) and 0 <= result.overlap <= 1 + 1e-9
        overlaps[tuple(kw.items())] = result.overlap
    assert (overlaps[(("perform_final_minimisation", True),)]
            >= overlaps[(("perform_final_minimisation", False),)] - 1e-9)
    soft = AdaptCompiler(qmps, backend=backend, soften_global_cost=True,
                         adapt_config=AdaptConfig(method="basic",
                                                  max_layers=2))
    assert np.isfinite(soft.compile().overlap)
    comp = AdaptCompiler(qmps, backend=backend, optimise_local_cost=True,
                         adapt_config=AdaptConfig(method="basic",
                                                  max_layers=2))
    result = comp.compile()
    assert len(result.local_cost_history) == 2
    assert np.isfinite(result.overlap)
