"""The order of operations of K2's wide variant (the cluster design of
`tridiag_cluster_kernel` in adaptaqc_tpu_torch/csrc/eigh_tridiag.cu),
emulated in torch on the CPU and held against the plain version.

  ranks     G ranks hold the rows cyclically (rank r: rows r, r + G, ..);
            each posts its first row below the last active step whose
            squares right of the diagonal are not all zero (its flag), and
            the next active step is the least posted row: a run of inactive
            steps is written as identity rows without a step;
  a step    the reflector of row k (the kernel's scalars; the norm scaled
            below tiny / eps), u_i = sum_j A[i][j] v_j by the rank that
            holds row i, s = v^H u summed over the rows in order, w_j from
            u_j and v_j, and the rank-2 update of the trailing block rounded
            as written, so that A stays exactly Hermitian.

Nothing of the order depends on G: the emulation at G = 1, 8 and 16 gives
the same bits, as the kernel's launches at any cluster size would.
"""

import numpy as np
import pytest
import torch

from adaptaqc_tpu_torch.ops import cuda_lib
from adaptaqc_tpu_torch.ops import eigh_kernels as ek

torch.set_num_threads(1)

TOL_F64 = 1e-9     # d, e / max|H|; tau, vrows: against tridiag_plain
TOL_QTQ = 1e-4     # float32 Q T Q^H = H, / max|H|


def cluster_tridiag(h, G, on_step=None):
    """tridiag_cluster_kernel's order on G ranks, for one Hermitian h.

    Returns (vrows, tau, d, e) as tridiag_plain does, and for every step
    whether its column was exactly zero when the step came (the inactive
    steps by a direct test, to hold the flags' skips against). on_step(a)
    is called with the working matrix after each active step's update."""
    m = h.shape[0]
    rdt = h.real.dtype
    a = torch.view_as_real(h.clone()).clone()
    ax, ay = a[..., 0], a[..., 1]
    fi = torch.finfo(rdt)
    tiny = fi.tiny / fi.eps
    one = torch.ones((), dtype=rdt)
    vrows = torch.zeros(m, m, dtype=h.dtype)
    tau = torch.zeros(m, dtype=h.dtype)
    e = torch.zeros(m, dtype=rdt)
    zero_col = []

    def flag(i):  # a square right of the diagonal is nonzero
        x, y = ax[i, i + 1:], ay[i, i + 1:]
        return bool(((x * x + y * y) > 0).any())

    flags = [flag(i) for i in range(m)]
    done, kp = 0, -1
    while True:
        posted = []
        for r in range(G):
            own = [i for i in range(r, m, G) if i > kp and flags[i]]
            posted.append(own[0] if own else m - 1)
        k = min(posted)
        for i in range(done, min(k, m - 1)):
            vrows[i, i + 1] = 1.0
            zero_col.append(not flag(i))
        if k >= m - 1:
            break
        zero_col.append(not flag(k))
        # the reflector of row k, formed by its owner
        rx, ry = ax[k, k + 1:], ay[k, k + 1:]
        ss = (rx * rx + ry * ry).sum()
        if ss < tiny:
            amax = torch.maximum(rx.abs(), ry.abs()).max()
            cx, cy = rx * (one / amax), ry * (one / amax)
            nrm = amax * torch.sqrt((cx * cx + cy * cy).sum())
        else:
            nrm = torch.sqrt(ss)
        inv = one / nrm
        ahr, ahi = rx[0] * inv, -ry[0] * inv
        bh = -one if ahr >= 0 else one
        tr, ti = one - ahr * bh, -ahi * bh
        dr, di = ahr - bh, ahi
        gs = inv / (dr * dr + di * di)
        gr, gi = dr * gs, -di * gs
        vx = torch.zeros(m, dtype=rdt)
        vy = torch.zeros(m, dtype=rdt)
        vx[k + 1:] = gr * rx + gi * ry  # gam conj(A[k][j])
        vy[k + 1:] = -gr * ry + gi * rx
        vx[k + 1], vy[k + 1] = 1.0, 0.0
        vrows[k] = torch.complex(vx, vy)
        tau[k] = torch.complex(tr, ti)
        e[k] = bh * nrm
        # u_i for the rows below k, by the rank that holds row i
        t = slice(k + 1, m)
        ux = torch.zeros(m, dtype=rdt)
        uy = torch.zeros(m, dtype=rdt)
        for r in range(G):
            rows = torch.arange(r, m, G)
            rows = rows[rows > k]
            if len(rows):
                bx, by = ax[rows][:, t], ay[rows][:, t]
                ux[rows] = bx @ vx[t] - by @ vy[t]
                uy[rows] = bx @ vy[t] + by @ vx[t]
        # s = v^H u over the rows in order; w_j; the rank-2 update
        sx = (vx[t] * ux[t] + vy[t] * uy[t]).sum()
        sy = (vx[t] * uy[t] - vy[t] * ux[t]).sum()
        t2r = (tr * sx + ti * sy) * 0.5
        t2i = (tr * sy - ti * sx) * 0.5
        pr = ux - (t2r * vx - t2i * vy)
        pi = uy - (t2r * vy + t2i * vx)
        wx, wy = tr * pr - ti * pi, tr * pi + ti * pr
        vix, viy, wix, wiy = (z[t, None] for z in (vx, vy, wx, wy))
        vjx, vjy, wjx, wjy = (z[None, t] for z in (vx, vy, wx, wy))
        re = (vix * wjx + viy * wjy) + (wix * vjx + wiy * vjy)
        im = (viy * wjx - vix * wjy) + (wiy * vjx - wix * vjy)
        ax[t, t] = ax[t, t] - re
        ay[t, t] = ay[t, t] - im
        for i in range(k + 1, m):
            flags[i] = flag(i)
        if on_step is not None:
            on_step(torch.complex(ax, ay))
        done, kp = k + 1, k
    return (vrows, tau, ax.diagonal().clone(), e), zero_col


def _rand_gram(m, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
    h = torch.tensor(a.conj().T @ a / m, dtype=dtype)
    return (h + h.mH) * 0.5


def _padded_gram(m, r, dtype, seed):
    """The Gram theta^H theta of a rank-r theta with the zero pattern of a
    two-qubit apply (a column (q, b) of theta is zero for b >= r): whole
    rows and columns of H are zero, and the data block is rank-deficient,
    as in the sweep's Grams."""
    rng = np.random.default_rng(seed)
    chi = m // 2
    x = rng.standard_normal((m, r)) + 1j * rng.standard_normal((m, r))
    y = (rng.standard_normal((r, 2, chi))
         + 1j * rng.standard_normal((r, 2, chi)))
    y[:, :, r:] = 0.0
    th = x @ y.reshape(r, m)
    th = th / np.linalg.norm(th)
    h = torch.tensor(th.conj().T @ th, dtype=dtype)
    return (h + h.mH) * 0.5


def _q_t(vrows, tau, d, e):
    """Q (from the reflectors, float64) and the dense T."""
    m = vrows.shape[0]
    q = ek.backtransform_plain(vrows.to(torch.complex128),
                               tau.to(torch.complex128),
                               torch.eye(m, dtype=torch.float64), m)
    t = (torch.diag(d.double()) + torch.diag(e[:-1].double(), 1)
         + torch.diag(e[:-1].double(), -1)).to(torch.complex128)
    return q, t


def _inactive(e, tau):
    return ((e[:-1] == 0) & (tau[:-1] == 0)).tolist()


@pytest.mark.parametrize("m", [192, 256])
def test_cluster_order_matches_plain_in_float64(m):
    """(a) complex128 at G = 1, 8, 16: d, e, tau and vrows against
    tridiag_plain within 1e-9 (d and e relative to max|H|); the three
    cluster sizes give the same bits."""
    h = _rand_gram(m, torch.complex128, seed=m)
    plain = ek.tridiag_plain(h)
    scale = float(h.abs().max())
    outs = {g: cluster_tridiag(h, g)[0] for g in (1, 8, 16)}
    for g, (v, tau, d, e) in outs.items():
        vp, taup, dp, ep = plain
        assert float((d - dp).abs().max()) / scale < TOL_F64, g
        assert float((e - ep).abs().max()) / scale < TOL_F64, g
        assert float((tau - taup).abs().max()) < TOL_F64, g
        assert float((v - vp).abs().max()) < TOL_F64, g
    for g in (8, 16):
        assert all(torch.equal(x, y) for x, y in zip(outs[1], outs[g]))


@pytest.mark.parametrize("m", [192, 256, 512])
def test_cluster_order_reconstructs_h_in_float32(m):
    """(b) complex64: Q T Q^H = H within 1e-4 of max|H| (Q unitary to the
    same bound), and the working matrix exactly Hermitian after every
    step (the update rounded as written)."""
    h = _rand_gram(m, torch.complex64, seed=m + 1)
    hermitian = []
    (v, tau, d, e), _ = cluster_tridiag(
        h, 16, on_step=lambda a: hermitian.append(torch.equal(a, a.mH)))
    assert len(hermitian) == m - 1 and all(hermitian)
    q, t = _q_t(v, tau, d, e)
    h64 = h.to(torch.complex128)
    assert float((q @ q.mH - torch.eye(m)).abs().max()) < TOL_QTQ
    assert float((q @ t @ q.mH - h64).abs().max()
                 / h64.abs().max()) < TOL_QTQ


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("m,r", [(64, 3), (256, 5), (256, 20)])
def test_flags_find_the_inactive_steps(m, r, dtype):
    """(c) padded, rank-deficient Grams: the steps the flags skip, or find
    active, are exactly those whose column is zero (or not) when the step
    comes; every step inactive in the plain version (e = tau = 0) is
    inactive here, and vrows[k] = e_{k+1} there. Where the data block's
    rounding residue reaches exact zero (the update keeps A exactly
    Hermitian; the plain version's does not) this order finds more."""
    h = _padded_gram(m, r, dtype, seed=m + r)
    (v, tau, d, e), zero_col = cluster_tridiag(h, 16)
    inact = _inactive(e, tau)
    assert inact == zero_col
    _, taup, _, ep = ek.tridiag_plain(h)
    plain = _inactive(ep, taup)
    assert sum(plain) >= m // 2 - r  # the padding's steps, at least
    eye = torch.eye(m, dtype=dtype)
    for k in range(m - 1):
        assert inact[k] or not plain[k]
        if inact[k]:
            assert torch.equal(v[k], eye[k + 1])
    q, t = _q_t(v, tau, d, e)
    h64 = h.to(torch.complex128)
    assert float((q @ t @ q.mH - h64).abs().max()
                 / h64.abs().max()) < TOL_QTQ


@pytest.mark.parametrize("scale", [1e-20, 1e-21])
def test_cluster_order_keeps_reflectors_unitary_on_tiny_columns(scale):
    """(d) the case of test_torch_eigh_kernels.py's tiny-column test: the
    columns' sums of squares underflow into subnormals, and the scaled
    norm keeps the reflectors unitary and Q T Q^H = H."""
    n = 16
    rng = np.random.default_rng(5)
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = torch.tensor((a.conj().T @ a) * scale, dtype=torch.complex64)
    h = (h + h.mH) * 0.5
    (v, tau, d, e), _ = cluster_tridiag(h, 4)
    q, t = _q_t(v, tau, d, e)
    assert float((q @ q.mH - torch.eye(n)).abs().max()) < 1e-5
    h64 = h.to(torch.complex128)
    assert float((q @ t @ q.mH - h64).abs().max() / h64.abs().max()) < 1e-5


class _PlanLib:
    """Stands in for the kernel library's plan queries: the cluster size
    (0 where the rows do not fit in the cluster's shared memory), and the
    route, the card-wide one where they do not (or none: `grid` False)."""

    def __init__(self, ctas, grid=True):
        self.ctas, self.grid = ctas, grid

    def tridiag_cluster_size(self, m, f64):
        return self.ctas

    def tridiag_routes(self, m, f64):
        return 0 if self.ctas else (1 if self.grid else -1)


@pytest.mark.parametrize("m,ctas,route", [
    (256, 16, "smem"), (504, 0, "grid"), (64, 4, "smem")])
def test_plan_reports_cluster_rows_and_route(monkeypatch, m, ctas, route):
    """tridiag_cluster_plan: the cluster size as the library plans it and
    the rows a CTA holds in shared memory, ceil(m / ctas), where they fit
    (route "smem"); past the fit (complex128 m = 504) the route is the
    card-wide one and the cluster plan raises."""
    monkeypatch.setattr(cuda_lib, "lib", lambda: _PlanLib(ctas))
    assert ek.tridiag_routes(m, True) == route
    if route == "smem":
        assert ek.tridiag_cluster_plan(m, True) == {
            "ctas": ctas, "rows": -(-m // ctas)}
    else:
        with pytest.raises(RuntimeError, match="no cluster size"):
            ek.tridiag_cluster_plan(m, True)


def test_plan_raises_where_nothing_launches(monkeypatch):
    """A size the card cannot launch (the library plans G = 0 and no
    card-wide plan) raises."""
    monkeypatch.setattr(cuda_lib, "lib", lambda: _PlanLib(0, grid=False))
    with pytest.raises(RuntimeError, match="no cluster size"):
        ek.tridiag_cluster_plan(600)
    with pytest.raises(RuntimeError, match="no route"):
        ek.tridiag_routes(600)
