"""The port's copy of the native BOBYQA (adaptaqc_tpu_torch/optim/bobyqa.py)
on the JAX package's own BOBYQA cases (tests/test_bobyqa.py), and the same
objectives through both packages' `bobyqa.solve`: every iterate equal to
1e-12 and the same evaluation count (the copy is the same NumPy code, so
the two runs are the same arithmetic)."""

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

from adaptaqc_tpu.optim import bobyqa as jbobyqa

from adaptaqc_tpu_torch.optim import bobyqa


def test_sphere_converges_to_machine_precision():
    def f(x):
        return float(np.sum((x - 0.3) ** 2))

    r = bobyqa.solve(f, np.zeros(5), bounds=([-np.pi] * 5, [np.pi] * 5))
    assert r.f < 1e-10
    np.testing.assert_allclose(r.x, 0.3, atol=1e-5)


def test_bound_constrained_optimum_on_boundary():
    def f(x):
        return float(np.sum(x))

    r = bobyqa.solve(f, np.zeros(3), bounds=([-1] * 3, [1] * 3))
    np.testing.assert_allclose(r.x, -1.0, atol=1e-6)


def test_coupled_quadratic_30d():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((30, 30))
    a = a @ a.T / 30 + np.eye(30)
    xstar = rng.uniform(-1, 1, 30)

    def f(x):
        return float((x - xstar) @ a @ (x - xstar))

    # one BLAS thread: the small KKT solves of each step are slower spread
    # over every core (about 100 s against 10 s on an 8-core host)
    with threadpool_limits(limits=1):
        r = bobyqa.solve(f, np.zeros(30),
                         bounds=([-np.pi] * 30, [np.pi] * 30))
    assert r.f < 0.1  # from f(0) ~ 30


def test_seek_global_minimum_escapes_local_well():
    def f(x):
        return float((x[0] ** 2 - 1) ** 2 + 0.3 * x[0] + x[1] ** 2)

    local = bobyqa.solve(f, np.array([0.9, 0.0]), bounds=([-2, -2], [2, 2]))
    assert abs(local.f - 0.294) < 0.01  # stays in the starting well
    glob = bobyqa.solve(f, np.array([0.9, 0.0]), bounds=([-2, -2], [2, 2]),
                        seek_global_minimum=True)
    assert glob.f < -0.30
    assert glob.nrestarts > 0


def test_stopval_halts_early():
    calls = {"n": 0}

    def f(x):
        calls["n"] += 1
        return float(np.sum((x - 0.3) ** 2))

    r = bobyqa.solve(f, np.zeros(4), bounds=([-np.pi] * 4, [np.pi] * 4),
                     stopval=1e-2)
    assert r.f <= 1e-2
    assert r.nf < 100


def test_periodic_cost_profile():
    """Circuit-like cost: a sum of shifted sinusoids."""
    rng = np.random.default_rng(2)
    ph = rng.uniform(-3, 3, 6)

    def f(x):
        return float(np.sum(1 - np.cos(x - ph)))

    r = bobyqa.solve(f, np.zeros(6), bounds=([-np.pi] * 6, [np.pi] * 6),
                     maxfun=2500)
    assert r.f < 1e-4


def _objectives():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((8, 8))
    a = a @ a.T / 8 + np.eye(8)
    xs = rng.uniform(-1, 1, 8)
    ph = rng.uniform(-3, 3, 5)
    return {
        "quadratic": (lambda x: float((x - xs) @ a @ (x - xs)), np.zeros(8),
                      {}),
        "sinusoids": (lambda x: float(np.sum(1 - np.cos(x - ph))),
                      np.zeros(5), {"maxfun": 600}),
        "double_well": (lambda x: float((x[0] ** 2 - 1) ** 2 + 0.3 * x[0]
                                        + x[1] ** 2),
                        np.array([0.9, 0.0]), {"seek_global_minimum": True}),
    }


@pytest.mark.parametrize("name", sorted(_objectives()))
def test_same_iterates_as_the_jax_package(name):
    """Both packages' solve on one objective: the same points asked for, in
    the same order, to 1e-12; the same result and evaluation count."""
    f, x0, kw = _objectives()[name]
    seen = {"jax": [], "torch": []}
    results = {}
    for key, mod in (("jax", jbobyqa), ("torch", bobyqa)):
        def logged(x, key=key):
            seen[key].append(np.array(x, dtype=float))
            return f(x)

        results[key] = mod.solve(logged, x0.copy(),
                                 bounds=([-np.pi] * len(x0),
                                         [np.pi] * len(x0)), **kw)
    assert len(seen["torch"]) == len(seen["jax"]) > 0
    for a, b in zip(seen["torch"], seen["jax"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert results["torch"].nf == results["jax"].nf
    assert results["torch"].nrestarts == results["jax"].nrestarts
    np.testing.assert_allclose(results["torch"].x, results["jax"].x, rtol=0,
                               atol=1e-12)
    assert abs(results["torch"].f - results["jax"].f) < 1e-12
