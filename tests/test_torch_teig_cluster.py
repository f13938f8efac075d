"""The order of operations of K3's wide variant (the cluster design of
`teig_cluster_kernel` in adaptaqc_tpu_torch/csrc/eigh_tridiag.cu), emulated
in torch on the CPU and held against the plain version.

  multisection  the threads of an eigenvalue lane count at every point that
                the next k rounds of bisection can visit (2^k - 1 points a
                lane a Sturm sweep, each the same chain of midpoints as
                tree_point's): w must equal teig_plain's bit for bit, in
                float32 and float64;
  BCGS2         the Gram-Schmidt over a cluster of G ranks of L lanes:
                panels of 16 columns in order, each inside one rank; two
                passes in which every rank with earlier columns Q_r forms
                Q_r (Q_r^T P) and the partials are summed in rank order and
                subtracted from the panel; then CGS2 inside the panel. Held
                against teig_plain's column-by-column CGS2 of the same
                iterate: columns up to sign (separated spectra), the
                degenerate clusters' projectors, orthonormality.

(The kernel sums each row's partials on the rank that owns that row slice;
every element's sum is still taken over the ranks in order, so the slices do
not change the arithmetic and are not emulated.)
"""

import math

import numpy as np
import pytest
import scipy.linalg
import torch

from adaptaqc_tpu_torch.ops import eigh_kernels as ek

PANEL = 16
TOL_VEC = 1e-3                                   # columns, projectors
TOL_ORTHO = {torch.float32: 2e-4, torch.float64: 1e-10}


def cluster_plan(m, cap=16):
    """(G, L) as the launcher plans them: G = ceil(m / 32) ranks, at most
    `cap`, each with L lanes, a multiple of the panel."""
    g0 = min(math.ceil(m / 32), cap)
    lanes = max(PANEL, math.ceil(math.ceil(m / g0) / PANEL) * PANEL)
    return math.ceil(m / lanes), lanes


def tridiagonal(m, kind, dtype, seed=5):
    """(d, e) of a symmetric tridiagonal with the named spectrum: `random`
    (normal d and e), `graded` (eigenvalues 1 .. 1e-7 over 7 decades),
    `separated` (evenly spaced in [1, 2]) or `degenerate` (four values,
    each m/4 times: the Lanczos recurrence leaves e at rounding level after
    four steps)."""
    rng = np.random.default_rng(seed + m)
    if kind == "random":
        d, e = rng.standard_normal(m), rng.standard_normal(m)
    else:
        lam = {"graded": np.logspace(0, -7, m),
               "separated": np.linspace(2.0, 1.0, m),
               "degenerate": np.repeat([1.0, 0.5, 0.25, 0.0], m // 4)}[kind]
        q, _ = np.linalg.qr(rng.standard_normal((m, m)))
        t = scipy.linalg.hessenberg((q * lam) @ q.T)
        d, e = np.diag(t).copy(), np.append(np.diag(t, -1), 0.0)
    return (torch.tensor(d, dtype=dtype), torch.tensor(e, dtype=dtype))


def multisection(d, e, k):
    """w by multisection with 2^k - 1 points a lane a sweep, in the
    kernel's arithmetic (sturm_count, tree_point, mid_rn)."""
    m, dt = d.shape[0], d.dtype
    rounds, _, _ = ek._teig_constants(dt)
    e_row, lo0, hi0, _, pivmin = ek.teig_bounds(d, e)
    e2 = e_row * e_row
    target = (m - 1 - torch.arange(m)).to(dt)
    lo = lo0.expand(m).clone()
    hi = hi0.expand(m).clone()

    def mid(a, b):
        return 0.5 * (a + b)

    for r in range(0, rounds, k):
        kk = min(k, rounds - r)
        npts = (1 << kk) - 1
        pts = []
        for h in range(1, npts + 1):  # heap node h: tree_point's chain
            a, b = lo.clone(), hi.clone()
            for bit in range(h.bit_length() - 2, -1, -1):
                md = mid(a, b)
                if (h >> bit) & 1:
                    a = md
                else:
                    b = md
            pts.append(mid(a, b))
        x = torch.stack(pts, dim=1)  # (m lanes, npts)
        q = d[0] - x
        q = torch.where(q.abs() < pivmin, -pivmin, q)
        cnt = (q < 0).to(torch.int64)
        for i in range(1, m):
            q = (d[i] - x) - e2[i - 1] / q
            q = torch.where(q.abs() < pivmin, -pivmin, q)
            cnt += q < 0
        node = torch.ones(m, dtype=torch.int64)
        for _ in range(kk):
            cn = cnt.gather(1, (node - 1)[:, None])[:, 0].to(dt)
            md = mid(lo, hi)
            above = cn > target
            hi = torch.where(above, md, hi)
            lo = torch.where(above, lo, md)
            node = torch.where(above, 2 * node, 2 * node + 1)
    return mid(lo, hi)


def bcgs2_cluster(bb, groups, lanes):
    """The kernel's distributed BCGS2 of the iterate bb (m, m)."""
    bb = bb.clone()
    m = bb.shape[0]
    for c0 in range(0, m, PANEL):
        owner = c0 // lanes
        pw = min(PANEL, m - c0)
        assert c0 + pw <= min(m, (owner + 1) * lanes), "panel spans ranks"
        if c0 > 0:
            for _ in range(2):
                p = bb[:, c0:c0 + pw].clone()
                acc = None
                for r in range(groups):
                    q = bb[:, r * lanes:min(c0, (r + 1) * lanes)]
                    if q.shape[1] == 0:
                        continue
                    part = q @ (q.T @ p)
                    acc = part if acc is None else acc + part
                bb[:, c0:c0 + pw] = p - acc
        for j in range(max(c0, 1), c0 + pw):
            v = bb[:, j]
            prev = bb[:, c0:j]
            for _ in range(2):
                v = v - prev @ (prev.T @ v)
            bb[:, j] = v * torch.rsqrt(torch.clamp((v * v).sum(), min=1e-30))
    return bb


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [192, 256, 512])
@pytest.mark.parametrize("kind", ["random", "graded", "degenerate"])
def test_multisection_w_bit_equal_to_plain(dtype, m, kind):
    d, e = tridiagonal(m, kind, dtype)
    w_plain, _ = ek.teig_plain_iterates(d, e)
    for k in (5, 4):  # 32 and 16 threads a lane
        assert torch.equal(multisection(d, e, k), w_plain), k


@pytest.mark.parametrize("dtype,m,cap", [
    (torch.float32, 192, 16), (torch.float32, 256, 16),
    (torch.float32, 512, 16), (torch.float32, 512, 8),
    (torch.float64, 64, 16), (torch.float64, 256, 16),
    (torch.float64, 504, 16)])
@pytest.mark.parametrize("kind", ["separated", "degenerate"])
def test_distributed_bcgs2_matches_column_cgs2(dtype, m, cap, kind):
    groups, lanes = cluster_plan(m, cap)
    assert groups > 1 and lanes % PANEL == 0
    d, e = tridiagonal(m, kind, dtype)
    w, it = ek.teig_plain_iterates(d, e)
    z_plain = ek.cgs2_plain(it.clone())
    z = bcgs2_cluster(it, groups, lanes)
    z64, zp64 = z.double(), z_plain.double()
    ortho = float((z64.T @ z64 - torch.eye(m, dtype=torch.float64))
                  .abs().max())
    assert ortho < TOL_ORTHO[dtype]
    if kind == "separated":
        sign = torch.where((z64 * zp64).sum(0) < 0, -1.0, 1.0)
        assert float((z64 * sign - zp64).abs().max()) < TOL_VEC
    else:
        w64 = w.double()
        scale = float(w64.abs().max())
        starts = [0] + [i for i in range(1, m)
                        if w64[i - 1] - w64[i] > 1e-3 * scale] + [m]
        assert len(starts) == 5  # the four eigenvalues
        for a, b in zip(starts[:-1], starts[1:]):
            pk = z64[:, a:b] @ z64[:, a:b].T
            pp = zp64[:, a:b] @ zp64[:, a:b].T
            assert float((pk - pp).abs().max()) < TOL_VEC


def test_plain_split_is_teig_plain():
    d, e = tridiagonal(40, "random", torch.float32)
    w, z = ek.teig_plain(d, e)
    w2, it = ek.teig_plain_iterates(d, e)
    assert torch.equal(w, w2)
    assert torch.equal(z, ek.cgs2_plain(it))


def test_cluster_plan_covers_every_wide_size():
    for m in range(129, 561):
        g, lanes = cluster_plan(m)
        assert 1 < g <= 16 and lanes % PANEL == 0 and (g - 1) * lanes < m
        assert math.ceil(m / lanes) == g
