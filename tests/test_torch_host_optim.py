"""The host optimisers (BOBYQA layers under use_roto_algos=False, the final
BOBYQA minimisation, the periodic-minimum escape and the gradient) against
the JAX package, in float64 on the CPU, on SVBackend and MPSBackend.

BOBYQA with objfun_has_noise amplifies the last bit of a cost: the two
packages' costs differ by about 1e-16 (their products round in other
orders), and on the same circuit their iterates part after about a hundred
evaluations (traced: 1.4e-5 apart at evaluation 111, from costs 1.1e-16
apart). So both packages' BOBYQA are handed the same start and the same
cost: the start rounded to 1e-10 and every cost to a grid of 2^-30, with
which the two cost functions agree unless one straddles a grid point (odds
about 1e-7 an evaluation); both are also capped at MAXFUN evaluations a
call, alike, to keep the tests short. What remains to compare is everything
else: the angles that reach the circuit, the evaluations counted, and the
solver itself (the port's copy of optim/bobyqa.py). Those must then be
equal."""

import random

import numpy as np
import pytest
import torch

import adaptaqc_tpu as jport
from adaptaqc_tpu.circuits import operations as jco
from adaptaqc_tpu.optim import bobyqa as jbobyqa

import adaptaqc_tpu_torch as port
from adaptaqc_tpu_torch.circuits import operations as co
from adaptaqc_tpu_torch.ops import cplx
from adaptaqc_tpu_torch.optim import bobyqa as tbobyqa

torch.set_num_threads(1)
C128 = torch.complex128
GRID = 2.0 ** 30
MAXFUN = 150


@pytest.fixture
def same_costs(monkeypatch):
    """Both packages' bobyqa.solve see the start rounded to 1e-10 and each
    cost on the 2^-30 grid, and stop after MAXFUN evaluations; returns the
    evaluation logs {"jax", "torch"}."""
    logs = {"jax": [], "torch": []}
    for key, mod in (("jax", jbobyqa), ("torch", tbobyqa)):
        orig = mod.solve

        def solve(objfun, x0, _orig=orig, _log=logs[key], **kw):
            def cost(x):
                c = np.round(objfun(x) * GRID) / GRID
                _log.append((np.array(x, float), c))
                return c
            kw["maxfun"] = min(kw.get("maxfun", MAXFUN), MAXFUN)
            return _orig(cost, np.round(np.asarray(x0, float), 10), **kw)
        monkeypatch.setattr(mod, "solve", solve)
    return logs


def _ry_layer(cls):
    """A two-qubit block of ry rotations around a CNOT: trainable by
    angles alone (the default block needs Rotoselect to pick axes)."""
    qc = cls(2)
    qc.ry(0.0, 0)
    qc.ry(0.0, 1)
    qc.cx(0, 1)
    qc.ry(0.0, 0)
    qc.ry(0.0, 1)
    return qc


def _backends(kind):
    if kind == "sv":
        return jport.SVBackend(), port.SVBackend(dtype=C128, device="cpu")
    return (jport.mps_backend_with_args(max_chi=4),
            port.mps_backend_with_args(max_chi=4, dtype=C128, device="cpu"))


def _compile(pkg, ops, backend, n, seed, layers, **kw):
    random.seed(0)
    np.random.seed(0)
    qc = ops.create_random_initial_state_circuit(n, seed=seed)
    compiler = pkg.AdaptCompiler(
        qc, backend=backend, custom_layer_2q_gate=_ry_layer(pkg.Circuit),
        adapt_config=pkg.AdaptConfig(method="basic", max_layers=layers), **kw)
    return compiler.compile()


def _both(kind, n, seed, layers, **kw):
    jb, tb = _backends(kind)
    rj = _compile(jport, jco, jb, n, seed, layers, **kw)
    with cplx.verification_eigh():
        rt = _compile(port, co, tb, n, seed, layers, **kw)
    return rj, rt


def _angles(result):
    return np.array([float(p) for i in result.circuit.data for p in i.params])


def _assert_same(rj, rt, logs):
    assert len(logs["torch"]) == len(logs["jax"]) > 0
    for (xt, ct), (xj, cj) in zip(logs["torch"], logs["jax"]):
        assert ct == cj
        assert np.abs(xt - xj).max() < 1e-8
    assert rt.cost_evaluations == rj.cost_evaluations
    assert rt.qubit_pair_history == rj.qubit_pair_history
    at, aj = _angles(rt), _angles(rj)
    assert at.shape == aj.shape and at.size > 0
    assert np.abs(at - aj).max() < 1e-8
    assert abs(rt.overlap - rj.overlap) < 1e-8


@pytest.mark.parametrize("kind", ["sv", "mps"])
@pytest.mark.parametrize("n,seed", [(2, 1), (3, 2)])
def test_bobyqa_layers_match_jax(same_costs, kind, n, seed):
    """use_roto_algos=False: each layer optimised by BOBYQA over all
    variational angles (seek_global_minimum). The evaluation sequence,
    angles (1e-8), evaluation counts and pair histories equal JAX's."""
    rj, rt = _both(kind, n, seed, 2, use_roto_algos=False)
    _assert_same(rj, rt, same_costs)


@pytest.mark.parametrize("kind", ["sv", "mps"])
def test_final_minimisation_matches_jax(same_costs, kind):
    """perform_final_minimisation: Rotoselect layers, then one BOBYQA over
    the whole solution before the final cleanup, as in the JAX package."""
    rj, rt = _both(kind, 3, 3, 2, perform_final_minimisation=True)
    _assert_same(rj, rt, same_costs)


def _compiled_pair(kind="sv"):
    """One compiler per package, compiled two layers on the same target,
    then moved to the same random angles."""
    jb, tb = _backends(kind)
    out = []
    for pkg, ops, backend in ((jport, jco, jb), (port, co, tb)):
        qc = ops.create_random_initial_state_circuit(3, seed=5)
        comp = pkg.AdaptCompiler(
            qc, backend=backend,
            adapt_config=pkg.AdaptConfig(method="basic", max_layers=2))
        with cplx.verification_eigh():
            comp.compile()
        out.append(comp)
    cj, ct = out
    rng = cj.variational_circuit_range()
    assert rng == ct.variational_circuit_range()
    k = len(jco.find_angles_in_circuit(cj.full_circuit, rng))
    angles = np.random.default_rng(11).uniform(-np.pi, np.pi, k)
    jco.update_angles_in_circuit(cj.full_circuit, angles, rng)
    co.update_angles_in_circuit(ct.full_circuit, angles, rng)
    cj._invalidate_current()
    ct._invalidate_current()
    return cj, ct, k


@pytest.mark.parametrize("method", ["parameter_shift", "sinusoid"])
def test_gradient_of_circuit_matches_jax(method):
    """_update_gradient_of_circuit at random angles, by the parameter shift
    and from the sinusoid through 0 and +-pi/2: 1e-10, and the angles are
    restored."""
    cj, ct, k = _compiled_pair()
    gj, gt = np.zeros(k), np.zeros(k)
    cj.minimizer._update_gradient_of_circuit(gj, method)
    ct.minimizer._update_gradient_of_circuit(gt, method)
    assert np.abs(gj).max() > 1e-3
    assert np.abs(gt - gj).max() < 1e-10
    rng = ct.variational_circuit_range()
    np.testing.assert_allclose(
        co.find_angles_in_circuit(ct.full_circuit, rng),
        jco.find_angles_in_circuit(cj.full_circuit, rng), atol=1e-12)


def test_gradient_fills_nlopt_style_grad_through_find_cost():
    """_find_cost_with_angles writes the gradient into a non-empty grad
    (nlopt's calling convention) and returns the cost at those angles."""
    cj, ct, k = _compiled_pair()
    x = np.linspace(-1.0, 1.0, k)
    gj, gt = np.zeros(k), np.zeros(k)
    cost_j = cj.minimizer._find_cost_with_angles(x, gj)
    cost_t = ct.minimizer._find_cost_with_angles(x, gt)
    assert abs(cost_t - cost_j) < 1e-10
    assert np.abs(gt - gj).max() < 1e-10


def test_escaping_periodic_local_minimum_matches_jax():
    """try_escaping_periodic_local_minimum: Nelder-Mead on the cost plus a
    periodic penalty, restarted at random multiples of its period (numpy's
    global generator, seeded alike): the same final cost and angles to
    1e-10, and the same evaluation count."""
    cj, ct, _ = _compiled_pair()
    n0j, n0t = cj.cost_evaluation_counter, ct.cost_evaluation_counter
    np.random.seed(3)
    ej = cj.minimizer.try_escaping_periodic_local_minimum(0.5, 0.1)
    np.random.seed(3)
    et = ct.minimizer.try_escaping_periodic_local_minimum(0.5, 0.1)
    assert abs(et - ej) < 1e-10
    rng = ct.variational_circuit_range()
    np.testing.assert_allclose(
        co.find_angles_in_circuit(ct.full_circuit, rng),
        jco.find_angles_in_circuit(cj.full_circuit, rng), atol=1e-10)
    assert (ct.cost_evaluation_counter - n0t
            == cj.cost_evaluation_counter - n0j > 0)


def test_scipy_minimiser_matches_jax():
    """ALG_SCIPY (scipy.optimize.minimize, here Powell) over all variational
    angles: the same cost and angles to 1e-8."""
    from adaptaqc_tpu.utils import constants as jconst
    from adaptaqc_tpu_torch.utils import constants as tconst
    cj, ct, _ = _compiled_pair()
    fj = cj.minimizer.minimize_cost(jconst.ALG_SCIPY, "Powell", tol=1e-6)
    ft = ct.minimizer.minimize_cost(tconst.ALG_SCIPY, "Powell", tol=1e-6)
    assert abs(ft - fj) < 1e-8
    rng = ct.variational_circuit_range()
    np.testing.assert_allclose(
        co.find_angles_in_circuit(ct.full_circuit, rng),
        jco.find_angles_in_circuit(cj.full_circuit, rng), atol=1e-8)


def test_nlopt_bobyqa_identifier_runs_the_own_bobyqa_without_nlopt():
    """Without the nlopt package (neither machine has it) an LN_BOBYQA
    identifier runs the own BOBYQA, as in the JAX package, and any other
    identifier raises ModuleNotFoundError."""
    try:
        import nlopt  # noqa: F401
    except ModuleNotFoundError:
        pass
    else:
        pytest.skip("nlopt is installed: its own path runs")
    from adaptaqc_tpu_torch.utils import constants as tconst
    _, ct, _ = _compiled_pair()
    before = ct.minimizer.cost_finder()
    after = ct.minimizer.minimize_cost(tconst.ALG_NLOPT, "LN_BOBYQA",
                                       tol=1e-6)
    assert after <= before + 1e-12
    with pytest.raises(ModuleNotFoundError):
        ct.minimizer.minimize_cost(tconst.ALG_NLOPT, "LN_COBYLA")
