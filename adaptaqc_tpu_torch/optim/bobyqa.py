"""Native BOBYQA: derivative-free bound-constrained trust-region minimiser.

The JAX package's `optim/bobyqa.py`, copied unchanged below this paragraph
(it is NumPy only): the port imports nothing of that package.

Implements the core of Powell's BOBYQA algorithm (the method behind the
reference's `pybobyqa.solve` calls — cost_minimiser.py:160-193): an
underdetermined quadratic interpolation model with a minimum-Frobenius-norm
Hessian, trust-region steps projected into the bound box, distance-based
interpolation-point replacement, and the rho/Delta two-radius schedule.
`seek_global_minimum=True` adds PyBOBYQA's multi-restart behaviour
(perturbed re-starts from the incumbent, best result kept).

This is a from-scratch implementation of the published algorithm (Powell
2009, "The BOBYQA algorithm for bound constrained optimization without
derivatives"), not a port of the pybobyqa package: the model update solves
the small KKT system directly each iteration (O((2d+1)^3), fine at the
angle counts final minimisation sees) instead of maintaining Powell's
inverse-system factors, and the geometry step is a farthest-point move.

Host-side and engine-agnostic: the objective is the compiler's cost_finder.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


@dataclass
class Result:
    x: np.ndarray
    f: float
    nf: int
    nrestarts: int
    msg: str

    @property
    def flag(self) -> int:
        return 0


def _build_model(pts: np.ndarray, fvals: np.ndarray, xb: np.ndarray,
                 scale: float):
    """Min-Frobenius-norm quadratic interpolant at base xb, built in
    z/scale coordinates (mixed point distances otherwise span many decades
    in the squared-inner-product block and the solve loses the model).

    Returns (c, g, lam, z) in SCALED coordinates: evaluate the model at a
    scaled step s' = s / scale."""
    m, d = pts.shape
    z = (pts - xb) / scale  # (m, d)
    a = 0.5 * (z @ z.T) ** 2
    kkt = np.zeros((m + d + 1, m + d + 1))
    kkt[:m, :m] = a
    kkt[:m, m] = 1.0
    kkt[m, :m] = 1.0
    kkt[:m, m + 1:] = z
    kkt[m + 1:, :m] = z.T
    rhs = np.zeros(m + d + 1)
    rhs[:m] = fvals
    sol, *_ = np.linalg.lstsq(kkt, rhs, rcond=None)
    lam = sol[:m]
    c = sol[m]
    g = sol[m + 1:]
    return c, g, lam, z


def _model_hess_vec(lam: np.ndarray, z: np.ndarray, s: np.ndarray):
    """H s with H = sum_j lam_j z_j z_j^T, never forming H."""
    return z.T @ (lam * (z @ s))


def _lagrange_at(pts: np.ndarray, xb: np.ndarray, xnew: np.ndarray,
                 scale: float):
    """|L_j(xnew)| for every Lagrange function of the interpolation set —
    Powell's replacement weighting (the BIGDEN denominators): evicting the
    point with the largest |L_j(xnew)| * (dist_j)^2 keeps the set
    well-poised, where farthest-point eviction degenerates it."""
    m, d = pts.shape
    z = (pts - xb) / scale
    a = 0.5 * (z @ z.T) ** 2
    kkt = np.zeros((m + d + 1, m + d + 1))
    kkt[:m, :m] = a
    kkt[:m, m] = 1.0
    kkt[m, :m] = 1.0
    kkt[:m, m + 1:] = z
    kkt[m + 1:, :m] = z.T
    rhs = np.zeros((m + d + 1, m))
    rhs[:m, :m] = np.eye(m)
    sol, *_ = np.linalg.lstsq(kkt, rhs, rcond=None)
    lam = sol[:m]          # (m, m): column j = lam of L_j
    c = sol[m]             # (m,)
    g = sol[m + 1:]        # (d, m)
    zn = (xnew - xb) / scale
    quad = 0.5 * lam.T @ (z @ zn) ** 2
    return np.abs(c + g.T @ zn + quad)


def _to_ball_boundary(s, p, delta):
    """Largest a >= 0 with |s + a p| = delta."""
    ss, sp, pp = float(s @ s), float(s @ p), float(p @ p)
    disc = sp * sp + pp * (delta ** 2 - ss)
    return (-sp + np.sqrt(max(disc, 0.0))) / pp if pp > 0 else 0.0


def _trust_region_step(g, lam, z, xk, lower, upper, delta, iters=None):
    """Approximately minimise g.s + 0.5 s^T H s over |s| <= delta within the
    box (TRSBOX's job): Steihaug-Toint truncated CG on the ball, with every
    CG step clipped to the feasible box and the active coordinates frozen
    when a bound is hit (projected-CG restart)."""
    d = g.shape[0]
    iters = iters or min(4 * d, 100)
    s = np.zeros(d)
    gs = g.copy()
    free = np.ones(d, bool)
    p = np.where(free, -gs, 0.0)
    for _ in range(iters):
        pn = np.linalg.norm(p)
        if pn < 1e-14 * max(1.0, np.linalg.norm(g)):
            break
        hp = _model_hess_vec(lam, z, p)
        curv = float(p @ hp)
        gp = float(gs @ p)
        a_ball = _to_ball_boundary(s, p, delta)
        if curv <= 1e-14 * pn * pn:
            a = a_ball  # negative curvature / linear: go to the boundary
        else:
            a = min(-gp / curv, a_ball)
        # box clip
        with np.errstate(divide="ignore", invalid="ignore"):
            hi = np.where(p > 1e-300, (upper - xk - s) / p, np.inf)
            lo = np.where(p < -1e-300, (lower - xk - s) / p, np.inf)
        a_box = float(np.min(np.minimum(hi, lo)))
        a = min(a, a_box)
        if not np.isfinite(a) or a <= 1e-14:
            break
        s = s + a * p
        gs = gs + a * hp
        if a >= a_ball - 1e-14:
            break  # on the trust-region boundary
        if a >= a_box - 1e-14:
            # a bound activated: freeze those coordinates, restart CG in
            # the remaining free subspace
            at_lo = xk + s <= lower + 1e-12
            at_hi = xk + s >= upper - 1e-12
            free = free & ~(at_lo | at_hi)
            p = np.where(free, -gs, 0.0)
            continue
        beta = float(gs @ hp) / curv if curv > 1e-14 else 0.0
        p = np.where(free, -gs + beta * p, 0.0)
    return s


def solve(objfun: Callable[[np.ndarray], float],
          x0: Sequence[float],
          bounds: Optional[Tuple[Sequence[float], Sequence[float]]] = None,
          rhobeg: Optional[float] = None,
          rhoend: float = 1e-8,
          maxfun: Optional[int] = None,
          seek_global_minimum: bool = False,
          objfun_has_noise: bool = False,
          print_progress: bool = False,
          do_logging: bool = False,
          stopval: Optional[float] = None,
          seed: int = 0) -> Result:
    """pybobyqa.solve-compatible entry point (the subset of the interface
    the reference uses). Returns Result(x, f, nf, ...)."""
    x0 = np.asarray(x0, float).copy()
    d = x0.size
    if d == 0:
        return Result(x0, float(objfun(x0)), 1, 0, "empty parameter vector")
    if bounds is None:
        lower = np.full(d, -1e20)
        upper = np.full(d, 1e20)
    else:
        lower = np.asarray(bounds[0], float)
        upper = np.asarray(bounds[1], float)
    if maxfun is None:
        maxfun = (500 if objfun_has_noise else 100) * (d + 1)
        if seek_global_minimum:
            maxfun *= 3  # pybobyqa budgets extra runs for the restarts
    if rhobeg is None:
        rhobeg = 0.1 * max(float(np.max(np.abs(x0))), 1.0)
        rhobeg = min(rhobeg, 0.4 * float(np.min(upper - lower)))
    rng = np.random.default_rng(seed)

    nf_total = 0
    best_x, best_f = None, np.inf
    restarts = seek_global_minimum and d > 0
    max_restarts = 5 if restarts else 0
    nrestarts = 0
    xstart = np.clip(x0, lower, upper)
    msg = "rho reached rhoend"

    while True:
        x, f, nf = _solve_once(objfun, xstart, lower, upper, rhobeg, rhoend,
                               maxfun - nf_total, print_progress, stopval)
        nf_total += nf
        # seed unconditionally on the first pass: if objfun returns NaN for
        # every evaluation, `f < best_f` never fires and Result.x would be
        # None (opaque crash downstream in update_angles_in_circuit)
        if best_x is None or f < best_f:
            best_x, best_f = x, f
        if stopval is not None and best_f <= stopval:
            msg = "stopval reached"
            break
        if nrestarts >= max_restarts or nf_total >= maxfun:
            if nf_total >= maxfun:
                msg = "maxfun reached"
            break
        # seek_global_minimum restarts: alternate PyBOBYQA-style soft
        # restarts (perturb the incumbent by O(10 rhobeg)) with full-box
        # random draws so distant basins are reachable
        nrestarts += 1
        if nrestarts % 2 == 1:
            span = np.minimum(upper - best_x, best_x - lower)
            xstart = np.clip(best_x + rng.uniform(-1.0, 1.0, d)
                             * np.minimum(10 * rhobeg, 0.5 * span),
                             lower, upper)
        else:
            lo = np.maximum(lower, -10.0)
            hi = np.minimum(upper, 10.0)
            xstart = rng.uniform(lo, hi)
    return Result(np.asarray(best_x), float(best_f), nf_total, nrestarts, msg)


def _solve_once(objfun, x0, lower, upper, rhobeg, rhoend, maxfun,
                print_progress, stopval=None):
    if stopval is None:
        stopval = -np.inf
    d = x0.size
    npt = 2 * d + 1
    rho = rhobeg
    delta = rhobeg

    pts = [x0]
    fvals = [float(objfun(x0))]
    nf = 1
    for i in range(d):
        for sgn in (+1.0, -1.0):
            p = x0.copy()
            p[i] = np.clip(p[i] + sgn * rho, lower[i], upper[i])
            if not any(np.array_equal(p, q) for q in pts):
                pts.append(p)
                fvals.append(float(objfun(p)))
                nf += 1
            if len(pts) >= npt or nf >= maxfun:
                break
        if len(pts) >= npt or nf >= maxfun:
            break
    pts = np.asarray(pts)
    fvals = np.asarray(fvals)

    while nf < maxfun and np.min(fvals) > stopval:
        kbest = int(np.argmin(fvals))
        xk = pts[kbest]
        fk = fvals[kbest]
        # model and trust-region subproblem in delta-scaled coordinates
        _, g, lam, z = _build_model(pts, fvals, xk, delta)
        s_sc = _trust_region_step(g, lam, z, np.zeros(d),
                                  (lower - xk) / delta, (upper - xk) / delta,
                                  1.0)
        s = s_sc * delta
        snorm = float(np.linalg.norm(s))
        pred = -(float(g @ s_sc)
                 + 0.5 * float(s_sc @ _model_hess_vec(lam, z, s_sc)))

        if pred <= 0 or snorm < 0.5 * rho:
            if delta > 1.01 * rho:
                delta = max(0.5 * delta, rho)  # refine resolution first
                continue
            # geometry step: pull the farthest point into the rho-ball
            dists = np.linalg.norm(pts - xk, axis=1)
            far = int(np.argmax(dists))
            if dists[far] > 2 * rho and far != kbest:
                direction = pts[far] - xk
                direction = direction / max(np.linalg.norm(direction), 1e-30)
                pnew = np.clip(xk + rho * direction, lower, upper)
                pts[far] = pnew
                fvals[far] = float(objfun(pnew))
                nf += 1
                continue
            if rho <= rhoend:
                break
            delta = max(0.5 * rho, rho * 0.1)
            rho = max(rhoend, rho * 0.1)
            continue

        xnew = np.clip(xk + s, lower, upper)
        fnew = float(objfun(xnew))
        nf += 1
        ratio = (fk - fnew) / pred if pred > 0 else -1.0
        # radius rules: failed steps contract toward the step scale (which
        # arms the rho-reduction branch); growth only when the TR bound
        # actually bound the step
        if ratio < 0.1:
            delta = max(0.5 * snorm, rho)
        elif ratio > 0.7 and snorm > 0.9 * delta:
            delta = min(2.0 * delta, 1e3 * rhobeg)

        # evict by Powell's weighting: |Lagrange_j(xnew)| * (dist_j/delta)^2
        ref = xnew if fnew < fk else xk
        lvals = _lagrange_at(pts, xk, xnew, delta)
        dists = np.linalg.norm(pts - ref, axis=1)
        score = lvals * np.maximum(1.0, (dists / max(delta, 1e-30)) ** 2)
        score[kbest] = -np.inf  # never evict the incumbent best
        repl = int(np.argmax(score))
        pts[repl] = xnew
        fvals[repl] = fnew
        if print_progress:
            print(f"nf={nf} f={min(fk, fnew):.3e} rho={rho:.1e} "
                  f"delta={delta:.1e} ratio={ratio:.2f}")

    kbest = int(np.argmin(fvals))
    return pts[kbest].copy(), float(fvals[kbest]), nf
