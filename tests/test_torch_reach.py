"""The MPS paths past chi = 128 and the eigensolver past m = 560 (complex128:
504), where the card runs the streamed env-chain kernel
(csrc/env_chain_stream.cu) and the wide K2-K4 with their operands partly in
global memory. On the CPU the wrappers run their plain versions, held here
against the JAX package (its XLA path: local_overlap_matrix, the MPS engine
with the `embed` eigh) and against numpy float64; the streamed kernel's order
of operations is emulated in torch and held against the plain version. K4
keeps its order of operations when its panel moves to global memory, so its
emulation (test_torch_eigh_kernels.py) runs here at the new sizes; K3 past
its cluster route runs the card-wide route, whose order
(test_torch_teig_global.py) runs here at the new sizes and plans."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptaqc_tpu.backends import mps_core as jmps
from adaptaqc_tpu.ops import cplx as jcplx

from adaptaqc_tpu_torch.backends import mps_core
from adaptaqc_tpu_torch.ops import cuda_lib
from adaptaqc_tpu_torch.ops import eigh_kernels as ek, env_kernel

from test_torch_eigh_kernels import _backtransform_panels, _bt_inputs
from test_torch_sweep import _jax_prefix, _jax_sweep, _port, _port_sweep
from test_torch_sweep import _workload
from test_torch_teig_cluster import multisection, tridiagonal
from test_torch_teig_global import check_grid_order, grid_plan

torch.set_num_threads(1)

TOL_ENV = {"x64": 1e-10, "f32": 1e-5}  # |C - C_jax| / max|C_jax|


def _sites(n, chi, seed):
    """Bra and ket site stacks (n, 2, chi, chi) as numpy complex128: a ket
    close to the bra keeps C of order one (independent random tensors make
    the chains decay)."""
    rng = np.random.default_rng(seed)
    scale = (2.0 * chi) ** -0.5

    def normal():
        return (rng.standard_normal((n, 2, chi, chi))
                + 1j * rng.standard_normal((n, 2, chi, chi))) * scale

    br = normal()
    return br, br + 0.1 * normal()


def _jax_mps(b, jdt):
    n, _, chi, _ = b.shape
    return jmps.MPS(jcplx.C(jnp.asarray(b.real, jdt), jnp.asarray(b.imag,
                                                                   jdt)),
                    jnp.zeros((n + 1, chi), jdt), jnp.zeros((), jdt))


@pytest.mark.parametrize("prec", ["x64", "f32"])
@pytest.mark.parametrize("chi", [160, 256])
def test_plain_env_chain_past_128_matches_jax_local_overlap(chi, prec):
    """env_chain on CPU tensors (its plain version: what the streamed
    kernel is held to on the card) against the JAX XLA-path
    local_overlap_matrix, n = 5, every site q: 1e-10 in complex128, 1e-5 in
    complex64, relative to max |C|."""
    n = 5
    jdt, tdt = ((jnp.float64, torch.complex128) if prec == "x64"
                else (jnp.float32, torch.complex64))
    br, bl = _sites(n, chi, seed=chi)
    jr, jl = _jax_mps(br, jdt), _jax_mps(bl, jdt)
    tr, tl = torch.tensor(br, dtype=tdt), torch.tensor(bl, dtype=tdt)
    for q in range(n):
        ref = jcplx.to_np(jmps.local_overlap_matrix(jr, jl, jnp.int32(q)))
        out = env_kernel.env_chain(tr, tl, q)
        assert out.dtype == tdt
        rel = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
        assert rel < TOL_ENV[prec], (q, rel)


def _views(l_, r, conj_l, l_i, l_a, l_p, r_a, r_j, r_p, np_, chi):
    """The operands of one product of the streamed kernel, read from flat
    storage with the strides the host loop gives it: L_p (chi x chi, rows
    i, depth a; conjugated if conj_l) and R_p (depth a, columns j), p <
    np_."""
    ls, rs = [], []
    for p in range(np_):
        lv = torch.as_strided(l_, (chi, chi), (l_i, l_a),
                              l_.storage_offset() + p * l_p)
        ls.append(lv.conj() if conj_l else lv)
        rs.append(torch.as_strided(r, (chi, chi), (r_a, r_j),
                                   r.storage_offset() + p * r_p))
    return ls, rs


def product_order(ls, rs, slices, bk, rows=slice(None), cols=slice(None)):
    """One product as the streamed kernel sums it (stream_product_*_kernel
    and stream_reduce_kernel), for the outputs [rows, cols]: the depth
    (p outer, a inner) cut into tiles of bk per p, the tiles into `slices`
    slices ([s T / S, (s + 1) T / S) of the T tiles); within a slice one
    sum per output over its depth in order, then the slices added in
    order. Complex64 as the FFMA kernel: acc.x = fma(a.x, b.x, fma(-a.y,
    b.y, acc.x)), acc.y = fma(a.x, b.y, fma(a.y, b.x, acc.y)) a depth
    index (here rounded after each product); complex128 as the DMMA
    kernel: by steps of 4 depth indices, four real products each summed
    over the step into the real (a.x b.x, then -a.y b.y) or imaginary (a.x
    b.y, then a.y b.x) accumulator. Real arithmetic only, so the bits do
    not depend on the shape of the outputs taken."""
    chi = ls[0].shape[0]
    ktp = -(-chi // bk)
    total = len(ls) * ktp
    f64 = ls[0].dtype == torch.complex128
    lr = [(x.real.contiguous()[rows], x.imag.contiguous()[rows])
          for x in (l.resolve_conj() for l in ls)]
    rr = [(x.real.contiguous()[:, cols], x.imag.contiguous()[:, cols])
          for x in rs]
    out = None
    for s in range(slices):
        re = im = None
        for t in range(s * total // slices, (s + 1) * total // slices):
            p, a0 = t // ktp, (t % ktp) * bk
            (ax, ay), (bx, by) = lr[p], rr[p]
            if re is None:
                re = torch.zeros((ax.shape[0], bx.shape[1]), dtype=ax.dtype)
                im = torch.zeros_like(re)
            steps = range(a0, min(a0 + bk, chi))
            if not f64:
                for a in steps:
                    xa, ya = ax[:, a:a + 1], ay[:, a:a + 1]
                    xb, yb = bx[a:a + 1], by[a:a + 1]
                    re = (re - ya * yb) + xa * xb
                    im = (im + ya * xb) + xa * yb
                continue
            for k0 in range(a0, min(a0 + bk, chi), 4):
                ks = range(k0, min(k0 + 4, chi))
                for acc, pairs in (("re", ((ax, bx, 1.0), (ay, by, -1.0))),
                                   ("im", ((ax, by, 1.0), (ay, bx, 1.0)))):
                    v = re if acc == "re" else im
                    for x, y, sign in pairs:
                        for a in ks:
                            v = v + (sign * x[:, a:a + 1]) * y[a:a + 1]
                    if acc == "re":
                        re = v
                    else:
                        im = v
        out = (re, im) if out is None else (out[0] + re, out[1] + im)
    return torch.complex(*out)


def _product(l_, r, conj_l, l_i, l_a, l_p, r_a, r_j, r_p, np_, chi,
             products):
    """One product of a launch of `products` products (the plan's slices
    for that launch), in the streamed kernel's order (product_order)."""
    f64 = l_.dtype == torch.complex128
    bk = env_kernel.STREAM_CONFIGS[env_kernel.stream_config(chi, f64)][2]
    slices = env_kernel.stream_slices(chi, f64, products, np_)
    ls, rs = _views(l_, r, conj_l, l_i, l_a, l_p, r_a, r_j, r_p, np_, chi)
    return product_order(ls, rs, slices, bk)


def stream_emulated(br, bl, q):
    """The streamed kernel's host loop (csrc/env_chain_stream.cu `run`)
    with its products in their order: per site step 1, M_p = X S_p
    (forward: S_p[a][j]) or X S_p^T (backward: S_p[j][a]), a launch of 2
    products per chain still running; step 2, the environment = sum over
    the depth (p, a) of L M, L(x, p, a) = conj(A_p[a][x]) (forward) or
    conj(A_p[x][a]) (backward), one product per chain; then the combine's
    four products G_j = e B_j, K_i = conj(A_i) f and C[i][j] = sum G_j
    K_i."""
    n, _, chi, _ = br.shape
    cc = chi * chi
    fb, fk = br.reshape(-1), bl.reshape(-1)
    e0 = env_kernel.boundary_env(chi, br.dtype, br.device).reshape(-1)
    cur = [e0, e0]
    for s in range(max(q, n - 1 - q)):
        live = [ch for ch, count in enumerate((q, n - 1 - q)) if s < count]
        for ch in live:
            fwd = ch == 0
            i = s if fwd else n - 1 - s
            m = torch.stack([_product(
                cur[ch], fk[i * 2 * cc + p * cc:], False, chi, 1, 0,
                chi if fwd else 1, 1 if fwd else chi, 0, 1, chi,
                2 * len(live)) for p in range(2)]).reshape(-1)
            cur[ch] = _product(fb[i * 2 * cc:], m, True,
                               1 if fwd else chi, chi if fwd else 1, cc,
                               chi, 1, cc, 2, chi, len(live)).reshape(-1)
    g = [_product(cur[0], fk[q * 2 * cc + j * cc:], False, chi, 1, 0, chi, 1,
                  0, 1, chi, 4) for j in range(2)]
    k = [_product(fb[q * 2 * cc + i * cc:], cur[1], True, chi, 1, 0, chi, 1,
                  0, 1, chi, 4) for i in range(2)]
    return torch.stack([torch.stack([(g[j] * k[i]).sum() for j in range(2)])
                        for i in range(2)])


@pytest.mark.parametrize("q", [0, 2, 4])
@pytest.mark.parametrize("dtype,tol", [(torch.complex128, 1e-12),
                                       (torch.complex64, 1e-4)])
def test_stream_order_matches_plain(dtype, tol, q):
    """The streamed kernel's products, strides, depth slices and order
    (product_order), emulated at chi = 160 (two 64-wide tiles and a ragged
    one, depth slices by the plan), n = 5, against env_chain_plain: 1e-12
    relative in complex128, 1e-4 (the card's tolerance) in complex64."""
    n, chi = 5, 160
    br, bl = (torch.tensor(x, dtype=dtype) for x in _sites(n, chi, seed=9))
    out = stream_emulated(br, bl, q)
    ref = env_kernel.env_chain_plain(br, bl, q)
    assert float((out - ref).abs().max() / ref.abs().max()) < tol


def test_apply_tape_at_chi_160_matches_jax_x64():
    """The MPS engine on a state padded to chi = 160 (the Grams of its
    two-qubit applies m = 320, past the narrow kernels; the real bond rank
    stays below 8): the port's apply_tape (the eigensolver kernels' plain
    versions) against the JAX engine's (`embed` eigh), n = 6, complex128,
    as dense vectors: 1e-10."""
    n, chi = 6, 160
    ttape, _ = _workload(n, 1)
    jst = _jax_prefix(ttape, n, chi, jnp.float64)
    tst = mps_core.apply_tape(mps_core.zero_mps(n, chi, torch.complex128),
                              ttape.kinds, ttape.q0, ttape.q1, ttape.angles,
                              1e-16)
    assert tst.chi == chi
    np.testing.assert_allclose(mps_core.to_dense(tst), jmps.to_dense(jst),
                               atol=1e-10)


def test_sweep_at_chi_160_matches_jax_x64():
    """One Rotoselect sweep over two dressed-CNOT layers on the JAX prefix
    padded to chi = 160 (K1 past 128 on the card): the same kinds, angles
    within 1e-8, the final cost within 1e-10, the same evaluations."""
    n, chi = 6, 160
    ttape, atape = _workload(n, 2)
    jprefix = _jax_prefix(ttape, n, chi, jnp.float64)
    jk, ja, jc, jev = _jax_sweep(jprefix, atape, n, chi, jnp.float64, False)
    tk, ta, tc, tev = _port_sweep(_port(jprefix, torch.complex128), atape, n,
                                  chi, torch.complex128)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_allclose(ta, ja, atol=1e-8)
    assert abs(tc - jc) < 1e-10
    assert tev == jev


@pytest.mark.parametrize("m,dtype,tol", [
    (600, torch.complex64, {"w": 2e-5, "ortho": 2e-4, "resid": 2e-4}),
    (512, torch.complex128, {"w": 1e-10, "ortho": 1e-10, "resid": 1e-10})])
def test_plain_chain_past_the_wide_sizes_matches_numpy_f64(m, dtype, tol):
    """The plain K2-K4 chain (what the kernels are held to on the card) on a
    random Gram past 560 in complex64 and past 504 in complex128, against
    numpy float64 eigh over m / 4 kept pairs: eigenvalues, orthonormality
    and residuals relative to the scale."""
    rng = np.random.default_rng(m)
    a = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
    th = torch.tensor(a / np.linalg.norm(a), dtype=dtype)
    h = th.mH @ th
    keep = m // 4
    w, v = ek.eigh_top_kernels(h, keep)
    h64 = h.to(torch.complex128).numpy()
    wx = np.linalg.eigvalsh(h64)[::-1][:keep]
    scale = np.abs(wx).max()
    w = w.numpy().astype(float)
    V = v.numpy().astype(complex)
    assert np.abs(w - wx).max() / scale < tol["w"]
    assert np.abs(V.conj().T @ V - np.eye(keep)).max() < tol["ortho"]
    resid = np.linalg.norm(h64 @ V - V * w, axis=0).max() / scale
    assert resid < tol["resid"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_teig_global_plan_and_order_at_1024(dtype):
    """K3 at m = 1024 (the card-wide route on the card): the plan's 8
    in-block ranks of 128 rows and 16 slabs; the multisection with a warp
    a lane (k = 5) gives the plain version's w bit for bit; the route's
    block CGS2 at keep = 256 over two tilings, the same bits, against the
    column CGS2 at the tolerances of test_torch_teig_cluster.py."""
    m = 1024
    assert grid_plan(m, dtype == torch.float64) == {
        "block": 32, "inblock_ctas": 8, "rows": 128, "slabs": 16,
        "global": ()}
    d, e = tridiagonal(m, "separated", dtype)
    w, _ = ek.teig_plain_iterates(d, e, keep=m // 2)
    assert torch.equal(multisection(d, e, 5)[:m // 2], w)
    check_grid_order(m, dtype, 256, [(32, 16), (64, 32)])


K2_ROWS_CTA = 16   # tridiag_cluster_kernel: G = ceil(m / 16) CTAs
K2_FIT = {False: 640, True: 438}  # the most whose rows fit in the cluster


def tridiag_cluster_rows(m, cap):
    """K2's cluster plan rule (eigh_tridiag.cu tridiag_plan): (G, the rows
    a CTA) with G = ceil(m / 16), at most `cap`."""
    g = min(math.ceil(m / K2_ROWS_CTA), cap)
    return g, math.ceil(m / g)


class _PlanLib:
    """Stands in for the kernel library's K2 plan queries as an H100
    answers them: the cluster route while its rows fit in shared memory
    (K2_FIT), the card-wide route past it."""

    def tridiag_cluster_size(self, m, f64):
        return 0 if m > K2_FIT[f64] else tridiag_cluster_rows(m, 16)[0]

    def tridiag_routes(self, m, f64):
        return int(m > K2_FIT[f64])


def test_k2_and_k3_plans_and_k3_order_at_2048(monkeypatch):
    """At m = 2048 (and past it) K2 runs its card-wide route, which has no
    cap of its own below its column's shared memory: the cluster route
    stops where its rows no longer fit (complex64 640: 16 CTAs of 40 rows;
    complex128 438). K3's card-wide route has no cap of its own: 16
    in-block ranks of 128 rows, 32 slabs, at m = 2049 too; its block CGS2
    at keep = 128 over the plan's 16 ranks, against the column CGS2 of
    cgs2_plain on a separated float32 spectrum's iterate: columns up to
    sign 1e-3, orthonormality 2e-4."""
    m = 2048
    assert tridiag_cluster_rows(K2_FIT[False], 16) == (16, 40)
    assert tridiag_cluster_rows(K2_FIT[True], 16) == (16, 28)
    monkeypatch.setattr(cuda_lib, "lib", lambda: _PlanLib())
    for f64 in (False, True):
        assert ek.tridiag_routes(m, f64) == "grid"
        assert ek.tridiag_routes(m + 1, f64) == "grid"
        assert ek.tridiag_routes(K2_FIT[f64], f64) == "smem"
        assert ek.tridiag_cluster_plan(K2_FIT[f64], f64)["rows"] == (
            28 if f64 else 40)
    monkeypatch.undo()
    for f64 in (False, True):
        assert grid_plan(m, f64) == {"block": 32, "inblock_ctas": 16,
                                     "rows": 128, "slabs": 32, "global": ()}
        assert grid_plan(m + 1, f64)["rows"] == 129
    check_grid_order(m, torch.float32, 128, [(32, 16)])


@pytest.mark.parametrize("m,dtype,tol", [(600, torch.complex64, 1e-5),
                                         (520, torch.complex128, 1e-12)])
def test_backtransform_panel_order_past_the_wide_sizes(m, dtype, tol):
    """K4 past 560 (complex64) and 504 (complex128, where the card reads
    the panel's reflectors from global memory in the same order): the
    compact-WY panel order against the plain backtransform."""
    vrows, tau, z = _bt_inputs(m, dtype, seed=m)
    keep = m // 2
    ref = ek.backtransform_plain(vrows, tau, z, keep)
    out = _backtransform_panels(vrows, tau, z, keep)
    assert float((out - ref).abs().max()) < tol
