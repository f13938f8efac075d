"""The order of operations of K2's card-wide route (tridiag_grid_kernel in
adaptaqc_tpu_torch/csrc/tridiag_grid.cu), emulated in torch on the CPU and
held against the plain version.

  matrix    held whole and exactly Hermitian: a panel's trailing update
            computes the entries on and below the diagonal and writes each
            with its conjugate transpose, the diagonal's imaginary part 0;
  panel     up to `nb` processed columns. Column k: its rows j > k brought
            up to date with the panel's V and W (the row owner's sum over
            the panel's columns), the reflector from that column with the
            kernel's scalars (the norm scaled below tiny / eps), y = A v on
            the panel-start matrix, a = W^H v and b = V^H v by slabs of
            `slab` rows summed in slab order, s = v^H y - b^H a - a^H b,
            w = tau (y - V a - W b - (conj(tau) s / 2) v);
  inactive  a column whose squares sum to exactly zero is the identity and
            ends the panel (p > 0); after an inactive step a column whose
            row's squares were zero off the diagonal at the panel's start
            (its flag) is the identity with no step;
  residue   a column whose sum of squares is below NOISE times the largest
            so far, and below 2^-20 times the last such column's, ends the
            panel after its step;
  trailing  A -= V W^H + W V^H on the trailing block by tiles of `tile`,
            each entry's sum over the panel's columns in one order, then
            the flags of the trailing rows.

Nothing of the order depends on which CTA owns a row (each row's sums are
its own, taken by one warp in one instruction sequence wherever it runs)
or on how the trailing block is tiled (each entry's sum over the panel's
columns is taken in one order): the emulation with other tiles gives the
same bits. The slabs are fixed by m (GRID_SLAB rows each), so they are
part of the order.
"""

import numpy as np
import pytest
import torch

from adaptaqc_tpu_torch.ops import cuda_lib
from adaptaqc_tpu_torch.ops import eigh_kernels as ek

from test_torch_tridiag_cluster import _padded_gram, _q_t, _rand_gram

torch.set_num_threads(1)

TOL_F64 = 1e-9     # d, e / max|H|; tau, vrows: against tridiag_plain
NOISE = {torch.float32: 2.0 ** -26, torch.float64: 2.0 ** -84}  # kNoise
TOL_QTQ = 1e-4     # float32 Q T Q^H = H, / max|H|
SLAB = ek.GRID_SLAB


def _flags(a, k0):
    """Row i >= k0 has an entry off the diagonal in columns >= k0 whose
    square is nonzero in either part."""
    m = a.shape[0]
    b = a[k0:, k0:].clone()
    b.diagonal().zero_()
    f = torch.zeros(m, dtype=torch.bool)
    f[k0:] = ((b.real * b.real > 0) | (b.imag * b.imag > 0)).any(dim=1)
    return f


def grid_tridiag(h, nb=32, tile=64, on_panel=None):
    """tridiag_grid_kernel's order on one Hermitian h. Returns (vrows, tau,
    d, e), for every step whether its column was exactly zero when the
    step came (a direct test), which steps the flags skipped, and the
    steps' count. on_panel(a) sees the stored matrix after each trailing
    update."""
    m = h.shape[0]
    cdt, rdt = h.dtype, h.real.dtype
    fi = torch.finfo(rdt)
    tiny = fi.tiny / fi.eps
    one = torch.ones((), dtype=rdt)
    a = h.clone()
    vrows = torch.zeros(m, m, dtype=cdt)
    tau = torch.zeros(m, dtype=cdt)
    d = torch.zeros(m, dtype=rdt)
    e = torch.zeros(m, dtype=rdt)
    zero_col, skipped = [], []
    nz = _flags(a, 0)
    k, prev_in = 0, True
    ss_max = ss_noise = 0.0
    while k < m - 1:
        ks = k
        V = torch.zeros(m, nb, dtype=cdt)
        W = torch.zeros(m, nb, dtype=cdt)
        p = 0
        while k < m - 1 and p < nb:
            # the column as the rows' owners bring it up to date
            col = torch.zeros(m, dtype=cdt)
            col[k + 1:] = a[k + 1:, k] - (
                V[k + 1:, :p] * W[k, :p].conj()
                + W[k + 1:, :p] * V[k, :p].conj()).sum(1)
            sq = col[k + 1:].real ** 2 + col[k + 1:].imag ** 2
            zero_col.append(bool((sq == 0).all()))  # every square zero
            if prev_in and not nz[k]:
                skipped.append(k)
                vrows[k, k + 1] = 1
                k += 1
                continue
            c = col[k + 1:]
            ss = (c.real * c.real + c.imag * c.imag).sum()
            if not ss > 0:
                vrows[k, k + 1] = 1
                prev_in = True
                k += 1
                if p > 0:
                    break
                continue
            ss_max = max(ss_max, float(ss))
            residue_end = False
            if ss < NOISE[rdt] * ss_max:
                residue_end = ss_noise == 0 or ss < ss_noise * 2.0 ** -20
                if residue_end:
                    ss_noise = float(ss)
            else:
                ss_noise = 0.0
            if ss < tiny:
                t = torch.view_as_real(c).abs()
                amax = t.max()
                sc = t * (one / amax)
                nrm = amax * torch.sqrt((sc * sc).sum())
            else:
                nrm = torch.sqrt(ss)
            inv = one / nrm
            ahr, ahi = c[0].real * inv, c[0].imag * inv
            bh = -one if ahr >= 0 else one
            tr, ti = one - ahr * bh, -ahi * bh
            dr, di = ahr - bh, ahi
            gs = inv / (dr * dr + di * di)
            v = torch.zeros(m, dtype=cdt)
            v[k + 1:] = torch.complex(dr * gs, -di * gs) * c
            v[k + 1] = 1
            tk = torch.complex(tr, ti)
            vrows[k], tau[k], e[k] = v, tk, bh * nrm
            # y on the panel-start matrix; a, b by slabs in slab order
            y = torch.zeros(m, dtype=cdt)
            y[k + 1:] = (a[k + 1:, k + 1:] * v[None, k + 1:]).sum(1)
            parts = []
            for s0 in range((k + 1) // SLAB * SLAB, m, SLAB):
                rows = slice(max(k + 1, s0), min(m, s0 + SLAB))
                parts.append(((W[rows, :p].conj() * v[rows, None]).sum(0),
                              (V[rows, :p].conj() * v[rows, None]).sum(0)))
            av = torch.zeros(p, dtype=cdt)
            bv = torch.zeros(p, dtype=cdt)
            for pa, pb in parts:
                av, bv = av + pa, bv + pb
            s = (v[k + 1:].conj() * y[k + 1:]).sum()
            s = s - ((bv.conj() * av).sum() + (av.conj() * bv).sum())
            t2 = tk.conj() * s * 0.5
            yp = y - V[:, :p] @ av - W[:, :p] @ bv
            w = tk * (yp - t2 * v)
            w[:k + 1] = 0
            V[:, p], W[:, p] = v, w
            p += 1
            prev_in = False
            k += 1
            if residue_end:
                break
        kend = m if k == m - 1 else k
        corr = ((V[:, :p] * W[:, :p].conj()).sum(1)
                + (W[:, :p] * V[:, :p].conj()).sum(1))
        d[ks:kend] = (a.diagonal()[ks:kend] - corr[ks:kend]).real
        if p > 0 and k < m - 1:
            for r0 in range(k, m, tile):
                for c0 in range(k, r0 + 1, tile):
                    ri, cj = slice(r0, min(m, r0 + tile)), slice(
                        c0, min(m, c0 + tile))
                    prod = torch.zeros(ri.stop - r0, cj.stop - c0, dtype=cdt)
                    for q in range(p):  # one order for every entry
                        prod = prod + V[ri, q, None] * W[None, cj, q].conj()
                    for q in range(p):
                        prod = prod + W[ri, q, None] * V[None, cj, q].conj()
                    blk = a[ri, cj] - prod
                    if r0 == c0:
                        lo = torch.tril(blk, -1)
                        dg = torch.complex(blk.diagonal().real,
                                           torch.zeros_like(
                                               blk.diagonal().real))
                        blk = lo + lo.mH + torch.diag(dg)
                        a[ri, cj] = blk
                    else:
                        a[ri, cj] = blk
                        a[cj, ri] = blk.mH
            nz = _flags(a, k)
            if on_panel is not None:
                on_panel(a)
    return (vrows, tau, d, e), zero_col, skipped


def _inactive(e, tau):
    return ((e[:-1] == 0) & (tau[:-1] == 0)).tolist()


@pytest.mark.parametrize("nb", [8, 32])
@pytest.mark.parametrize("m,label", [(200, "c64 size"), (640, "c64 size"),
                                     (520, "c128 size")])
def test_grid_order_matches_plain_in_float64(m, label, nb):
    """complex128 at the route's sizes: d, e, tau and vrows against
    tridiag_plain within 1e-9 (d and e relative to max|H|), panels of 8
    and 32 columns."""
    h = _rand_gram(m, torch.complex128, seed=m + nb)
    (v, tau, d, e), _, skipped = grid_tridiag(h, nb=nb)
    vp, taup, dp, ep = ek.tridiag_plain(h)
    scale = float(h.abs().max())
    assert not skipped
    assert float((d - dp).abs().max()) / scale < TOL_F64
    assert float((e - ep).abs().max()) / scale < TOL_F64
    assert float((tau - taup).abs().max()) < TOL_F64
    assert float((v - vp).abs().max()) < TOL_F64


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_grid_order_is_the_same_over_tiles(dtype):
    """The trailing update's tiles do not change a bit (a padded Gram, so
    that skips and panel ends are in the run too)."""
    h = _padded_gram(192, 6, dtype, seed=11)
    outs = [grid_tridiag(h, nb=8, tile=t)[0] for t in (64, 16, 48)]
    for other in outs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(outs[0], other))


@pytest.mark.parametrize("m", [256, 640])
def test_grid_order_reconstructs_h_in_float32(m):
    """complex64: Q T Q^H = H within 1e-4 of max|H| (Q unitary to the same
    bound), and the stored matrix exactly Hermitian after every trailing
    update."""
    h = _rand_gram(m, torch.complex64, seed=m + 3)
    hermitian = []
    (v, tau, d, e), _, _ = grid_tridiag(
        h, on_panel=lambda a: hermitian.append(torch.equal(a, a.mH)))
    assert hermitian and all(hermitian)
    q, t = _q_t(v, tau, d, e)
    h64 = h.to(torch.complex128)
    assert float((q @ q.mH - torch.eye(m)).abs().max()) < TOL_QTQ
    assert float((q @ t @ q.mH - h64).abs().max()
                 / h64.abs().max()) < TOL_QTQ


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("m,r", [(256, 8), (600, 150)])
def test_grid_flags_skip_exactly_zero_columns(m, r, dtype):
    """Padded, rank-deficient Grams: the inactive steps are exactly those
    whose column is zero when the step comes, the flags skip only such
    steps, and every step inactive in the plain version (e = tau = 0) is
    inactive here, with vrows[k] = e_{k+1}; Q T Q^H = H."""
    h = _padded_gram(m, r, dtype, seed=m + r)
    (v, tau, d, e), zero_col, skipped = grid_tridiag(h)
    inact = _inactive(e, tau)
    assert inact == zero_col
    assert skipped and all(zero_col[k] for k in skipped)
    _, taup, _, ep = ek.tridiag_plain(h)
    plain = _inactive(ep, taup)
    assert sum(plain) >= m // 2 - r
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
def test_grid_order_keeps_reflectors_unitary_on_tiny_columns(scale):
    """Columns whose sums of squares underflow into subnormals: the scaled
    norm keeps the reflectors unitary and Q T Q^H = H."""
    n = 16
    rng = np.random.default_rng(5)
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = torch.tensor((a.conj().T @ a) * scale, dtype=torch.complex64)
    h = (h + h.mH) * 0.5
    (v, tau, d, e), _, _ = grid_tridiag(h, nb=4)
    q, t = _q_t(v, tau, d, e)
    assert float((q @ q.mH - torch.eye(n)).abs().max()) < 1e-5
    h64 = h.to(torch.complex128)
    assert float((q @ t @ q.mH - h64).abs().max() / h64.abs().max()) < 1e-5


class _GridLib:
    """Stands in for the kernel library's K2 plan queries as an H100
    answers them: the cluster route to its shared-memory fit, the card-wide
    route past it, one CTA an SM."""

    def tridiag_cluster_size(self, m, f64):
        return 0 if m > (438 if f64 else 640) else min(16, -(-m // 16))

    def tridiag_routes(self, m, f64):
        return int(self.tridiag_cluster_size(m, f64) == 0)

    def tridiag_grid_plan(self, m, f64, out):
        # gsmem: the column (m complex) and the slabs' partials, or the
        # trailing update's planes if larger, then the flags; the column in
        # the workspace where it does not fit (tridiag_grid_column_global)
        cs = 16 if f64 else 8
        col = 0 if ek.tridiag_grid_column_global(m, f64) else m * cs
        out[0], out[1], out[2] = 32, 132, SLAB
        out[3] = max(8 * 64 * 36 * cs // 2, col + 8 * 2 * 32 * cs) \
            + (m + 15) // 16 * 16
        return 0

    def tridiag_grid_workspace(self, m, f64):
        return ek.tridiag_grid_workspace_bytes(m, f64)


@pytest.mark.parametrize("m", [4096, 8192, 16384])
@pytest.mark.parametrize("f64", [False, True])
def test_plan_and_workspace_at_4096(monkeypatch, f64, m):
    """At m = 4096, 8192 and 16384, F5's cap: the card-wide route, 132
    CTAs, panels of 32, slabs of 64; the workspace is the matrix (m^2
    complex, 256 MiB in complex128 at m = 4096, 1 GiB at 8192, 2^32 bytes
    at 16384) with the panel's V and W, the vectors, the slabs' partials,
    the flags and the barrier's words, each from a 256-byte boundary, as
    the library lays it out; past the column's fit (complex128 from m =
    11,566) each CTA's column and v too (256 x m complex); the route's
    shared memory fits a CTA's 227 KB."""
    monkeypatch.setattr(cuda_lib, "lib", lambda: _GridLib())
    assert ek.tridiag_routes(m, f64) == "grid"
    assert ek.tridiag_routes(640 if not f64 else 438, f64) == "smem"
    pl = ek.tridiag_grid_plan(m, f64)
    assert pl["panel"] == 32 and pl["ctas"] == 132 and pl["slab"] == SLAB
    assert pl["smem"] <= 232448
    cs = 16 if f64 else 8
    want = (m * m * cs + 2 * m * 32 * cs + 2 * m * cs
            + (m // SLAB) * 2 * 32 * cs + 2 * m * 4 + 1024)
    column = f64 and m > 11565
    assert ek.tridiag_grid_column_global(m, f64) == column
    assert not ek.tridiag_grid_column_global(11565, True)
    if column:  # from the next 256-byte boundary
        want = (want + 255) // 256 * 256 + 256 * m * cs
    if (m, f64) == (16384, True):
        assert m * m * cs == 2 ** 32 and want > 2 ** 32
    assert ek.tridiag_grid_workspace_bytes(m, f64) == want
    assert ek._tridiag_grid_bytes.__wrapped__(m, f64) == want
    with pytest.raises(RuntimeError, match="no cluster size"):
        ek.tridiag_cluster_plan(m, f64)
