"""The order of operations of the complex64 wide env-chain kernel (K1 at
64 < chi <= 128, csrc/env_chain_wide.cu), emulated in torch on the CPU and
held against the plain version env_kernel.env_chain_plain and the JAX
package's local_overlap_matrix (its XLA path), with its plan and dispatch.

  ranks     a 4 x 4 cluster a chain: rank 4 i + j owns block rows I_i x
            columns J_j of the environment (br = bc = ceil(chi / 4), the
            last block ragged) and keeps rows I_i whole;
  step 1    M_p = E[I_i, :] B_p[:, J_j] (backward F[I_i, :] B_p[J_j, :]^T),
            its depth (chi, made even by a zero column) summed in order;
  step 2    rank (i, j)'s partial of e'[:, J_j]: sum over p, then over the
            rows a of I_i in order, of conj(A_p[a, :])^T M_p[a, :]
            (backward conj(A_p[:, a]) M_p[a, :]);
  exchange  block x of each partial goes to its owner (x / br, j), which
            sums the four of its column group in row order; the owner's
            block is posted into the rows of its row peers;
  combine   on each rank's block, G_p = e B_p and K_u = conj(A_u) f, the
            sums of G_p K_u over the block, added in rank order.

Tolerances, relative to max |C|: 1e-10 in float64, 1e-5 in float32 (the
emulation rounds a product and a sum where the kernel fuses them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptaqc_tpu.backends import mps_core as jmps
from adaptaqc_tpu.ops import cplx as jcplx

from adaptaqc_tpu_torch.ops import dispatch, env_kernel

from test_torch_dispatch import card, _counts, _reset  # noqa: F401
from test_torch_reach import _jax_mps, _sites

torch.set_num_threads(1)

TOL = {torch.complex128: 1e-10, torch.complex64: 1e-5}
SMEM_BYTES = 232448   # a CTA's shared memory on an H100
STATIC_BYTES = 1024   # the kernel's static shared memory, at most
CHIS = (65, 96, 127, 128)


def _blocks(chi):
    """[(start, size)] of the four row (and column) blocks."""
    b = -(-chi // 4)
    return [(k * b, max(0, min(b, chi - k * b))) for k in range(4)]


def _ordered_product(lhs, rhs):
    """lhs @ rhs with the depth summed in order, as the kernel's step 1
    does (a rank-1 update a depth index)."""
    acc = torch.zeros((lhs.shape[0], rhs.shape[1]), dtype=lhs.dtype)
    for b in range(lhs.shape[1]):
        acc = acc + lhs[:, b:b + 1] * rhs[b:b + 1, :]
    return acc


def _site(env, a, b, fwd):
    """One site of either chain on the 4 x 4 ranks: step 1 (outputs
    partitioned into blocks, each summed in depth order), step 2 each row
    block's partial summed over p, then its rows in order, and the owners'
    sums in row order."""
    chi = env.shape[0]
    m = [_ordered_product(env, b[p] if fwd else b[p].T) for p in range(2)]
    parts = []
    for x0, rows in _blocks(chi):
        acc = torch.zeros((chi, chi), dtype=env.dtype)
        for p in range(2):
            for r in range(x0, x0 + rows):
                ar = a[p][r, :] if fwd else a[p][:, r]
                acc = acc + ar.conj()[:, None] * m[p][r:r + 1, :]
        parts.append(acc)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def wide_emulated(br, bl, q):
    """C (2, 2) as csrc/env_chain_wide.cu computes it."""
    n, _, chi, _ = br.shape
    e0 = torch.zeros((chi, chi), dtype=br.dtype)
    e0[0, 0] = 1.0
    e = e0
    for i in range(q):
        e = _site(e, br[i], bl[i], True)
    f = e0
    for i in range(n - 1, q, -1):
        f = _site(f, br[i], bl[i], False)
    g = [_ordered_product(e, bl[q][p]) for p in range(2)]
    k = [_ordered_product(br[q][u].conj(), f) for u in range(2)]
    out = torch.zeros((2, 2), dtype=br.dtype)
    for x0, rows in _blocks(chi):
        for y0, cols in _blocks(chi):
            blk = (slice(x0, x0 + rows), slice(y0, y0 + cols))
            for u in range(2):
                for p in range(2):
                    out[u, p] += (g[p][blk] * k[u][blk]).sum()
    return out


@pytest.mark.parametrize("chi", CHIS)
@pytest.mark.parametrize("n", [6, 8])
@pytest.mark.parametrize("where", ["first", "second", "middle",
                                   "next_to_last", "last"])
def test_wide_order_matches_plain_and_jax(chi, n, where):
    """The emulated order against env_chain_plain in complex128 and
    complex64, and against the JAX XLA path's local_overlap_matrix in
    float64, at q at both ends, next to them and in the middle."""
    q = {"first": 0, "second": 1, "middle": n // 2, "next_to_last": n - 2,
         "last": n - 1}[where]
    br, bl = _sites(n, chi, seed=chi + n)
    ref = jcplx.to_np(jmps.local_overlap_matrix(
        _jax_mps(br, jnp.float64), _jax_mps(bl, jnp.float64), jnp.int32(q)))
    for dt in (torch.complex128, torch.complex64):
        tr, tl = torch.tensor(br, dtype=dt), torch.tensor(bl, dtype=dt)
        got = wide_emulated(tr, tl, q)
        plain = env_kernel.env_chain_plain(tr, tl, q)
        scale = float(plain.abs().max())
        assert float((got - plain).abs().max()) / scale < TOL[dt], dt
        if dt == torch.complex128:
            rel = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
            assert rel < TOL[dt]


def test_wide_plan_fits_and_keeps_threads_busy():
    """At every chi of 65..128: the 4 x 4 cluster (the one size the plan
    takes) with every block non-empty, its shared memory under a CTA's
    232,448 bytes, and each step's tiles filling at least 55% of the
    threads of their last round."""
    assert env_kernel.WIDE_GRID == (4, 4)
    for chi in range(65, 129):
        pl = env_kernel.wide_plan(chi)
        assert pl["ctas"] == 16 and pl["br"] == pl["bc"] == -(-chi // 4)
        assert all(size > 0 for _, size in _blocks(chi))
        assert pl["smem"] + STATIC_BYTES <= SMEM_BYTES, chi
        assert pl["ld"] in (chi, chi + 1) and pl["ld"] % 2 == 0
        assert all(pl[k] % 2 == 0 for k in ("lde", "ldb", "lda"))
        assert pl["vec"] == (chi % 2 == 0 and pl["br"] % 2 == 0)
        br, bc = pl["br"], pl["bc"]
        (ra, ry), (rx, ry2) = pl["step1"], pl["step2"]
        for tiles in (2 * -(-br // ra) * -(-bc // ry),
                      -(-chi // rx) * -(-bc // ry2)):
            rounds = -(-tiles // pl["threads"])
            assert tiles / (rounds * pl["threads"]) >= 0.55, (chi, tiles)
    for chi in (64, 129):
        with pytest.raises(ValueError):
            env_kernel.wide_plan(chi)


def test_wide_plan_picks_the_cheapest_tiles():
    """The tiles at the sizes the main path runs: 4 x 2 and 4 x 4 at chi =
    128 (every thread one tile), 3 x 2 and 3 x 3 at 96, 2 x 2 and 4 x 2
    at 65; the shared memory 218,624 bytes at 128."""
    want = {128: ((4, 2), (4, 4)), 127: ((4, 2), (4, 4)),
            96: ((3, 2), (3, 3)), 65: ((2, 2), (4, 2))}
    for chi, (s1, s2) in want.items():
        pl = env_kernel.wide_plan(chi)
        assert (pl["step1"], pl["step2"]) == (s1, s2), chi
    assert env_kernel.wide_plan(128)["smem"] == 218624


@pytest.mark.parametrize("chi", CHIS)
def test_wide_range_goes_to_the_new_launcher(card, chi):  # noqa: F811
    """On the card a complex64 call at 64 < chi <= 128 launches
    env_chain_wide_launch (counted in wide_launches), chi = 64 the narrow
    kernel, and complex128 at the same chi the double instantiation
    (f64_launches)."""
    for dtype, launcher in ((torch.complex64, "env_chain_wide_launch"),
                            (torch.complex128, "env_chain_f64_launch")):
        br = torch.zeros(5, 2, chi, chi, dtype=dtype)
        env_kernel.env_chain(br, br, 2)
        assert card.calls[-1] == launcher
    br = torch.zeros(5, 2, 64, 64, dtype=torch.complex64)
    env_kernel.env_chain(br, br, 2)
    assert card.calls == ["env_chain_wide_launch", "env_chain_f64_launch",
                          "env_chain_launch"]
    assert _counts()["env_chain"] == (3, 1, 1)
    assert dispatch.use_kernel("env", "cuda", torch.complex64, chi)


def test_wide_cpu_calls_run_the_plain_version():
    """On the CPU a wide-range call runs the plain version and counts
    nothing."""
    _reset()
    br, bl = _sites(4, 65, seed=3)
    tr = torch.tensor(br, dtype=torch.complex64)
    tl = torch.tensor(bl, dtype=torch.complex64)
    out = env_kernel.env_chain(tr, tl, 1)
    assert torch.equal(out, env_kernel.env_chain_plain(tr, tl, 1))
    assert env_kernel.env_chain.wide_launches == 0
