"""K3's card-wide route (the "global" route of eigh_kernels.wide_routes:
complex64 past m = 640, complex128 past 512; teig_grid in
adaptaqc_tpu_torch/csrc/eigh_tridiag.cu) and its contract of the kept
columns, on the CPU.

  keep          teig_plain(d, e, keep=k) is the first k columns of the full
                call, bit for bit: a lane's bisection reads only itself, its
                shift only earlier eigenvalues, CGS2 column j only columns
                before j. Against the JAX package's Pallas teig kernel in
                interpret mode at m <= 128 as well;
  order         the route's block CGS2 emulated in torch: blocks of 32
                columns; two passes of W = Q^T P as partial sums over slabs
                of 64 rows (each in row order), summed in slab order, and
                P -= Q W (each row's sum over the earlier columns in
                order), computed over tiles of Q's columns and of rows;
                then CGS2 inside the block with its rows split over the
                ranks of the in-block cluster, each dot and norm summed
                over the ranks in order. The same bits for every tiling;
                against cgs2_plain of the same iterate at the tolerances of
                test_torch_teig_cluster.py;
  plan          the launch plan's rule at m = 2048 to 16384 (the route
                has no cap of its own: past one CTA's shared memory a
                stage reads its operands from global memory; dispatch's
                REACH keeps m <= 16384), and the wrapper's query of it.

(The kernel's FMAs round once where torch's products round twice, so the
emulation follows the order of the sums, not their last bits.)
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptaqc_tpu.ops import pallas_eigh

from adaptaqc_tpu_torch.ops import cuda_lib
from adaptaqc_tpu_torch.ops import eigh_kernels as ek

from test_torch_teig_cluster import tridiagonal

torch.set_num_threads(1)

BLOCK = 32       # kTgBlockOf: columns a block
SLAB = 64        # kTgSlab: rows a W partial
IN_ROWS = 128    # kTgInRows: the rows an in-block rank aims at
MAX_RANKS = 16   # kTgMaxCluster
SMEM = 232448    # an H100 CTA's opt-in shared memory, bytes
TOL_VEC = 1e-3                                   # columns up to sign
TOL_ORTHO = {torch.float32: 2e-4, torch.float64: 1e-10}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [192, 600])
@pytest.mark.parametrize("part", ["one", "half", "all"])
def test_teig_plain_keep_is_the_full_calls_prefix(dtype, m, part):
    """Bit for bit: w[:k] and z[:, :k] of the full call (tolerance 0)."""
    k = {"one": 1, "half": m // 2, "all": m}[part]
    d, e = tridiagonal(m, "random", dtype)
    w, z = ek.teig_plain(d, e)
    wk, zk = ek.teig_plain(d, e, keep=k)
    assert wk.shape == (k,) and zk.shape == (m, k)
    assert torch.equal(wk, w[:k])
    assert torch.equal(zk, z[:, :k])
    wi, it = ek.teig_plain_iterates(d, e, keep=k)
    assert torch.equal(wi, wk) and it.shape == (m, k)


@pytest.mark.parametrize("n,keep", [(16, 4), (16, 8), (64, 16), (64, 32)])
def test_teig_plain_keep_matches_pallas_teig_kernel(n, keep):
    """The kept columns of the plain K3 on the Pallas tridiagonalisation's
    (d, e) against the JAX package's _teig_kernel in interpret mode (all n
    columns, sliced): eigenvalues to 1e-6 of the scale, eigenvectors up to
    sign to 1e-4 (test_torch_eigh_kernels.py's bounds; its b0 is the same
    array)."""
    rng = np.random.default_rng(n + keep)
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = a.conj().T @ a
    hre = np.asarray(h.real, np.float32)
    him = np.asarray(h.imag, np.float32)
    hre, him = (hre + hre.T) * np.float32(0.5), (him - him.T) * np.float32(0.5)
    _, _, _, _, packed = pallas_eigh._tridiag_call(
        jnp.asarray(hre, jnp.float32), jnp.asarray(him, jnp.float32), True)
    wp, zp = pallas_eigh._teig_call(packed, pallas_eigh._teig_b0(n), True)
    packed = np.asarray(packed)
    d, e = torch.tensor(packed[3]), torch.tensor(packed[2])
    w, z = ek.teig_plain(d, e, keep=keep)
    scale = np.abs(packed[3]).max() + np.abs(packed[2]).max()
    assert np.abs(w.numpy() - np.asarray(wp)[0, :keep]).max() / scale < 1e-6
    overlap = np.abs(np.sum(z.numpy() * np.asarray(zp)[:, :keep], axis=0))
    assert np.abs(overlap - 1.0).max() < 1e-4


def grid_plan(m, f64, smem=SMEM):
    """teig_grid's plan rule (tg_plan_for): the fewest in-block ranks, at
    least ceil(m / IN_ROWS) and at most MAX_RANKS, whose rows (BLOCK + 16
    bytes a row), double-buffered slots and static reduction buffer fit one
    CTA's shared memory; where no count does, ceil(m / IN_ROWS) ranks (at
    most MAX_RANKS) with their rows in global memory. `global`: the stages
    that read their operands from global memory, each where they and its
    static shared memory pass one CTA's at keep = m: the multisection's d
    and e2 (static sc[4] and red[2][8]: 20 reals), the inverse iteration's
    d, e, w and rings (sc[4], red[2][1]: 6 reals), the in-block rows."""
    real = 8 if f64 else 4
    ld = BLOCK + 16 // real
    ring = 2 * 16 * 32  # two chunks of 16 steps x 32 lanes
    stages = []
    if (2 * m + 20) * real > smem:
        stages.append("bisect")
    invit = (((3 * m + 3) // 4 * 4 + 3 * ring + 6) * real + ring * 4)
    if invit > smem:
        stages.append("invit")
    static = 2 * 4 * BLOCK * real  # red[2][4 warps][BLOCK]
    g0 = min(-(-m // IN_ROWS), MAX_RANKS)
    for g in range(g0, MAX_RANKS + 1):
        rows = -(-m // g)
        need = ((2 * g * BLOCK + 3) // 4 * 4 + rows * ld) * real + static
        if need <= smem:
            return {"block": BLOCK, "inblock_ctas": g, "rows": rows,
                    "slabs": -(-m // SLAB), "global": tuple(stages)}
    return {"block": BLOCK, "inblock_ctas": g0, "rows": -(-m // g0),
            "slabs": -(-m // SLAB), "global": tuple(stages + ["inblock"])}


def grid_bcgs2(it, g, tile_c, tile_r):
    """The route's CGS2 of the iterate it (m, keep) in its order of
    operations: W over tiles of tile_c columns of Q (every slab's partial
    in its rows' order, rows past m weighing zero, then the slabs in
    order), P -= Q W over tiles of tile_r rows (each row's sum over the
    earlier columns in order), the in-block CGS2 over g ranks."""
    it = it.clone()
    m, keep = it.shape
    ns = -(-m // SLAB)
    nt = -(-m // tile_r)
    rank_rows = -(-m // g)
    ranks = [(r, min(m, r + rank_rows)) for r in range(0, m, rank_rows)]
    for c0 in range(0, keep, BLOCK):
        pw = min(BLOCK, keep - c0)
        for _ in range(2 if c0 > 0 else 0):
            q = torch.zeros((ns * SLAB, c0), dtype=it.dtype)
            q[:m] = it[:, :c0]
            p = torch.zeros((ns * SLAB, pw), dtype=it.dtype)
            p[:m] = it[:, c0:c0 + pw]
            qs, ps = q.view(ns, SLAB, c0), p.view(ns, SLAB, pw)
            w = torch.empty((c0, pw), dtype=it.dtype)
            for t0 in range(0, c0, tile_c):  # a tile of Q's columns
                qt = qs[:, :, t0:t0 + tile_c]
                acc = torch.zeros((ns, qt.shape[2], pw), dtype=it.dtype)
                for i in range(SLAB):  # every slab's rows in order
                    acc = acc + qt[:, i, :, None] * ps[:, i, None, :]
                tot = acc[0]
                for s in range(1, ns):  # the slabs in order
                    tot = tot + acc[s]
                w[t0:t0 + qt.shape[2]] = tot
            qr = torch.zeros((nt * tile_r, c0), dtype=it.dtype)
            qr[:m] = it[:, :c0]
            qr = qr.view(nt, tile_r, c0)  # tiles of rows
            y = torch.zeros((nt, tile_r, pw), dtype=it.dtype)
            for c in range(c0):  # the earlier columns in order
                y = y + qr[:, :, c, None] * w[c]
            it[:, c0:c0 + pw] = it[:, c0:c0 + pw] - y.view(-1, pw)[:m]
        for j in range(max(c0, 1), c0 + pw):
            prev = it[:, c0:j]
            v = it[:, j].clone()
            for _ in range(2 if j > c0 else 0):
                dots = None
                for a, b in ranks:  # each rank's rows, then the ranks in order
                    part = (prev[a:b] * v[a:b, None]).sum(0)
                    dots = part if dots is None else dots + part
                v = v - prev @ dots
            nrm2 = None
            for a, b in ranks:
                part = (v[a:b] * v[a:b]).sum()
                nrm2 = part if nrm2 is None else nrm2 + part
            it[:, j] = v * torch.rsqrt(torch.clamp(nrm2, min=1e-30))
    return it


def check_grid_order(m, dtype, keep, tilings):
    """grid_bcgs2 over the plan's in-block ranks at m, on the kept columns
    of a separated spectrum's iterate: the same bits for every tiling, and
    against cgs2_plain columns up to sign (TOL_VEC) and orthonormality
    (TOL_ORTHO)."""
    plan = grid_plan(m, dtype == torch.float64)
    d, e = tridiagonal(m, "separated", dtype)
    _, it = ek.teig_plain_iterates(d, e, keep=keep)
    outs = [grid_bcgs2(it, plan["inblock_ctas"], tc, tr)
            for tc, tr in tilings]
    for other in outs[1:]:
        assert torch.equal(other, outs[0])
    z = outs[0].double()
    zp = ek.cgs2_plain(it.clone()).double()
    eye = torch.eye(keep, dtype=torch.float64)
    assert float((z.T @ z - eye).abs().max()) < TOL_ORTHO[dtype]
    sign = torch.where((z * zp).sum(0) < 0, -1.0, 1.0)
    assert float((z * sign - zp).abs().max()) < TOL_VEC
    return plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [768, 1024])
def test_grid_order_matches_column_cgs2(dtype, m):
    """At keep = m / 2 (what the sweeps launch), over Q tiles of 32 and
    64 columns and row tiles of 16 and 32 (the products' CTA tiles in
    float and others): the same bits, and the column CGS2's columns and
    orthonormality."""
    plan = check_grid_order(m, dtype, m // 2, [(32, 16), (64, 32)])
    assert plan["inblock_ctas"] == -(-m // IN_ROWS)


def test_grid_plan_at_2048_and_4096(monkeypatch):
    """The plan at m = 2048, 4096, 8192 and 16384 in both dtypes: 16 ranks
    of 128, 256, 512 and 1024 rows, slabs of 64 rows; the route has no cap
    of its own: below where each stage's operands fit one CTA's shared
    memory every stage reads them there (float: 800 rows a rank at m =
    12800, 120 KB, and every stage to m = 16384), past it the stage reads
    them from global memory (double: the inverse iteration's d, e and w
    past m = 8488, the in-block rows past 13056, the multisection's d and
    e2 past 14518). The wrapper's query returns the library's plan with
    those stages by name (a stand-in library answering with grid_plan),
    and raises where the library has none."""
    for f64 in (False, True):
        assert grid_plan(2048, f64) == {"block": 32, "inblock_ctas": 16,
                                        "rows": 128, "slabs": 32,
                                        "global": ()}
        assert grid_plan(4096, f64) == {"block": 32, "inblock_ctas": 16,
                                        "rows": 256, "slabs": 64,
                                        "global": ()}
        assert grid_plan(8192, f64) == {"block": 32, "inblock_ctas": 16,
                                        "rows": 512, "slabs": 128,
                                        "global": ()}
    assert grid_plan(12800, False)["rows"] == 800
    assert grid_plan(16384, False) == {"block": 32, "inblock_ctas": 16,
                                       "rows": 1024, "slabs": 256,
                                       "global": ()}
    assert grid_plan(16384, True) == {
        "block": 32, "inblock_ctas": 16, "rows": 1024, "slabs": 256,
        "global": ("bisect", "invit", "inblock")}
    edges = {8488: (), 8489: ("invit",), 13056: ("invit",),
             13057: ("invit", "inblock"), 14518: ("invit", "inblock"),
             14519: ("bisect", "invit", "inblock")}
    for m, stages in edges.items():
        assert grid_plan(m, True)["global"] == stages
    # too little shared memory for 16 ranks' rows (and the inverse
    # iteration's operands): those go global
    assert grid_plan(4096, True, smem=70000)["global"] == ("invit",
                                                           "inblock")

    class Lib:
        def teig_grid_plan(self, m, f64, out):
            if m > 10 ** 5:
                return 9  # cudaErrorInvalidConfiguration
            plan = grid_plan(m, bool(f64))
            out[0], out[1] = plan["block"], plan["inblock_ctas"]
            out[2], out[3] = plan["rows"], plan["slabs"]
            out[4] = sum(1 << i for i, name in enumerate(
                ek.TEIG_GLOBAL_STAGES) if name in plan["global"])
            return 0

    monkeypatch.setattr(cuda_lib, "lib", lambda: Lib())
    for m in (4096, 8576, 16384):
        assert ek.teig_grid_plan(m, True) == grid_plan(m, True)
    with pytest.raises(RuntimeError, match="no card-wide plan"):
        ek.teig_grid_plan(10 ** 6, True)


def test_grid_plan_covers_the_route():
    """Every m of the route (complex64 641-2048, complex128 513-2048) has a
    plan, its ranks cover the rows, and no rank is empty."""
    for f64, lo in ((False, 641), (True, 513)):
        for m in range(lo, 2049):
            plan = grid_plan(m, f64)
            g, rows = plan["inblock_ctas"], plan["rows"]
            assert g == min(MAX_RANKS, math.ceil(m / IN_ROWS))
            assert (g - 1) * rows < m <= g * rows
