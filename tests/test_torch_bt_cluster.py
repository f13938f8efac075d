"""The order of operations of K4's wide design (csrc/backtransform_wide.cu:
a preparation launch, then a cluster of G CTAs over the rows of each tile
of 32 output columns), emulated in torch on the CPU and held against the
plain version backtransform_plain.

  preparation  the active reflectors (tau != 0) in order, in panels of
               NB = 16; each panel's G = V^H V over all its rows (four
               partial sums by row mod 4, combined in order) and T by the
               zlarft recurrence, T[:i, i] = -tau_i T[:i, :i] G[:i, i];
               the panel's rows dealt to the ranks cyclically (rank g:
               rows g, g + G, ..);
  apply        per tile of 32 columns, panels last first: each rank's
               partial Y = V_g^H Z_g over its rows below the panel's first
               reflector; Y = the partials summed in rank order; W = T Y;
               each rank's Z_g -= V_g W.

Held against backtransform_plain: 1e-5 in complex64, 1e-12 in complex128,
at keep 1, m/2 and m, on padded Grams' reflectors with an all-inactive
panel, over G = 1, 4 and 16 ranks, and once past m = 1024 with the plan's
own G. The preparation does not depend on G, so T is the same bits for
every G; the apply's sums over the ranks do, so its bits are promised for
reruns and batches at one G, not across G.

The half route (complex128 past m = 4096: panels of 8, tiles of 16
columns, the partial Y summed over the warps' row groups in a fixed tree)
is emulated in its own order, forced at small m: 1e-12 against the plain
version, and the same bits over column tiles of 16, 8 and 1. Its plan,
shared memory and workspace mirrors at m = 4097, 6144 and 8192.
"""

import functools
import math

import numpy as np
import pytest
import torch

from adaptaqc_tpu_torch.ops import eigh_kernels as ek

from test_torch_dispatch import card  # noqa: F401
from test_torch_eigh_kernels import _bt_inputs

torch.set_num_threads(1)

NB = 16         # reflectors of a panel
COLS = 32       # output columns of a cluster
ROWS_CTA = 128  # rows a CTA aims at: G = ceil(m / 128), at most 16
ROWS_SMALL = 64  # or ceil(m / 64) at m <= 512
TOL = {torch.complex64: 1e-5, torch.complex128: 1e-12}


@functools.lru_cache(maxsize=8)
def _inputs(m, dtype, seed):
    """_bt_inputs, made once a case (the emulation reads them only)."""
    return _bt_inputs(m, dtype, seed)


def _reflectors(m, dtype, seed):
    """Unitary reflectors without a tridiagonalization (cheap at large m):
    v_k = e_{k+1} + x_k below it, tau_k = 2 / |v_k|^2, with a run of
    inactive ones; z orthonormal."""
    rng = np.random.default_rng(seed)
    v = np.zeros((m, m), complex)
    tau = np.zeros(m, complex)
    for k in range(m - 1):
        x = 0.3 * (rng.standard_normal(m - k - 2)
                   + 1j * rng.standard_normal(m - k - 2))
        v[k, k + 1] = 1.0
        v[k, k + 2:] = x
        tau[k] = 2.0 / (1.0 + np.vdot(x, x).real)
    tau[m // 3:m // 3 + 20] = 0.0
    z = np.linalg.qr(rng.standard_normal((m, m)))[0]
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    return (torch.tensor(v, dtype=dtype), torch.tensor(tau, dtype=dtype),
            torch.tensor(z, dtype=rdt))


def bt_plan(m, cap=16):
    """(G, R): the plan's cluster size and rows a CTA."""
    rows = ROWS_SMALL if m <= 512 else ROWS_CTA
    g = min(math.ceil(m / rows), cap)
    return g, math.ceil(m / g)


def prepare(vrows, tau, nb=NB):
    """bt_prep_kernel: [(first reflector k0, V (m, nb), T (nb, nb))] of
    every panel of nb reflectors (NB, or NB_HALF on the half route), in
    order."""
    m = vrows.shape[0]
    active = [k for k in range(m - 1) if tau[k] != 0]
    panels = []
    for s0 in range(0, len(active), nb):
        idx = active[s0:s0 + nb]
        pn = len(idx)
        v = torch.zeros((m, nb), dtype=vrows.dtype)
        v[:, :pn] = vrows[idx].T  # row k of vrows is zero through entry k
        parts = [v[j::4].conj().T @ v[j::4] for j in range(4)]
        g = (parts[0] + parts[1]) + (parts[2] + parts[3])
        t = torch.zeros((nb, nb), dtype=vrows.dtype)
        for i in range(pn):
            t[i, i] = tau[idx[i]]
            t[:i, i] = -tau[idx[i]] * (t[:i, :i] @ g[:i, i])
        panels.append((idx[0], v, t))
    return panels


def apply(panels, z, keep, groups):
    """bt_apply_kernel on `groups` ranks: (m, keep) complex."""
    m = z.shape[0]
    # rank g holds rows g, g + G, ..: none where g >= m
    rows = [torch.arange(g, max(g, m), groups) for g in range(groups)]
    out = torch.zeros((m, keep), dtype=panels[0][1].dtype if panels
                      else torch.complex64)
    for c0 in range(0, keep, COLS):
        cw = min(COLS, keep - c0)
        zs = [z[r, c0:c0 + cw].to(out.dtype) for r in rows]
        for k0, v, t in reversed(panels):
            below = [r > k0 for r in rows]  # rows above k0 are zero in V
            vg = [v[r][b] for r, b in zip(rows, below)]
            y = None
            for g in range(groups):  # partials, summed in rank order
                part = vg[g].conj().T @ zs[g][below[g]]
                y = part if y is None else y + part
            w = t @ y
            for g in range(groups):
                zs[g][below[g]] = zs[g][below[g]] - vg[g] @ w
        for g in range(groups):
            out[rows[g], c0:c0 + cw] = zs[g]
    return out


def emulate(vrows, tau, z, keep, groups):
    panels = prepare(vrows, tau)
    if not panels:
        return z[:, :keep].to(vrows.dtype)
    return apply(panels, z, keep, groups)


@pytest.mark.parametrize("dtype,m", [
    (torch.complex64, 8), (torch.complex64, 64), (torch.complex64, 200),
    (torch.complex64, 600), (torch.complex128, 64),
    (torch.complex128, 520)])
@pytest.mark.parametrize("keep", ["one", "half", "all"])
def test_cluster_order_matches_plain(dtype, m, keep):
    """Every G of 1, 4 and 16 ranks gives backtransform_plain's
    Q z[:, :keep], on reflectors with runs of inactive ones (an
    all-inactive panel past m = 32)."""
    vrows, tau, z = _inputs(m, dtype, m)
    assert int((tau[: m - 1] == 0).sum()) >= 1
    kp = {"one": 1, "half": m // 2, "all": m}[keep]
    ref = ek.backtransform_plain(vrows, tau, z, kp)
    for groups in (1, 4, 16):
        out = emulate(vrows, tau, z, kp, groups)
        assert out.shape == (m, kp)
        assert float((out - ref).abs().max()) < TOL[dtype], groups


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_panels_and_t_do_not_depend_on_the_ranks(dtype):
    """The preparation gathers and forms T once a panel, whatever the
    cluster size: the same panels and the same bits of T; the apply's
    rank sums make its bits depend on G, but a rerun at one G repeats
    them."""
    m = 200
    vrows, tau, z = _bt_inputs(m, dtype, seed=7)
    first = prepare(vrows, tau)
    assert len(first) == math.ceil(int((tau[: m - 1] != 0).sum()) / NB)
    for (k0, v, t), (k1, v1, t1) in zip(first, prepare(vrows, tau)):
        assert k0 == k1 and torch.equal(v, v1) and torch.equal(t, t1)
    assert all(torch.equal(t.triu(), t) for _, _, t in first)
    a = emulate(vrows, tau, z, m // 2, 4)
    assert torch.equal(a, emulate(vrows, tau, z, m // 2, 4))


def test_plan_past_1024():
    """Past m = 1024 (m = 1040, keep = 8: one ragged column tile): the
    plan's 9 ranks of 116 rows against the plain version, on unitary
    reflectors with a run of inactive ones; the plan at the cap, 16 ranks
    of 128 rows."""
    m = 1040
    assert bt_plan(m) == (9, 116)
    assert bt_plan(2048) == (16, 128)
    assert bt_plan(512) == (8, 64) and bt_plan(513) == (5, 103)
    vrows, tau, z = _reflectors(m, torch.complex64, m)
    ref = ek.backtransform_plain(vrows, tau, z, 8)
    out = emulate(vrows, tau, z, 8, bt_plan(m)[0])
    assert float((out - ref).abs().max()) < TOL[torch.complex64]


def test_all_inactive_reflectors_leave_z():
    """No active reflector (tau all zero): the preparation makes no panel
    and the apply writes z's columns unchanged."""
    m = 130
    vrows, _, z = _bt_inputs(m, torch.complex64, seed=3)
    tau = torch.zeros(m, dtype=torch.complex64)
    assert prepare(vrows, tau) == []
    out = emulate(vrows, tau, z, 40, bt_plan(m)[0])
    assert torch.equal(out, z[:, :40].to(torch.complex64))
    assert torch.equal(out, ek.backtransform_plain(vrows, tau, z, 40))


SMEM_BUDGET = 232448 - 32  # a CTA's shared memory on an H100, less the
                           # apply's static mbarriers


@pytest.mark.parametrize("f64,m,route", [
    (False, 2048, "double"), (False, 4096, "double"),
    (False, 5888, "double"), (False, 5889, "single"),
    (False, 8192, "single"),
    (True, 2048, "double"), (True, 2816, "double"), (True, 2817, "single"),
    (True, 4096, "single"), (True, 4097, "half"), (True, 8192, "half")])
def test_apply_route_and_its_shared_memory(f64, m, route):
    """The apply's route by m and the dtype alone (ek.backtransform_routes,
    the mirror of bt_route): complex64 keeps two panel buffers to m =
    5888 and one past it (221,440 bytes at m = 8192); complex128 past m =
    2816, where two panel buffers beside a CTA's rows of z outgrow its
    shared memory on the plan's cluster of 16, keeps one buffer and rows of
    z at a stride of 33 (226,816 bytes at m = 4096), and past 4096 (257
    rows a CTA fit neither) takes the half route, panels of 8 and tiles of
    16 columns (230,528 bytes at m = 8192). The route is the largest that
    fits: each shorter route fits only where the one before it does not.
    The order of operations of the double and single routes is the same
    (only the storage differs), so the emulation above holds both; the
    half route's is emulated below."""
    assert ek.backtransform_routes(m, f64) == route
    g, r = bt_plan(m)
    assert g == 16 and r == -(-m // 16)
    assert ek.backtransform_apply_smem(m, g, f64) <= SMEM_BUDGET
    order = ("double", "single", "half") if f64 else ("double", "single")
    for earlier in order[:order.index(route)]:
        assert ek.backtransform_apply_smem(m, g, f64, earlier) > SMEM_BUDGET
    want = {(False, 8192): 221440, (True, 4096): 226816,
            (True, 8192): 230528}.get((f64, m))
    if want:
        assert ek.backtransform_apply_smem(m, g, f64) == want
    if (f64, m) == (True, 4096):
        assert ek.backtransform_apply_smem(4097, 16, True,
                                           "single") > SMEM_BUDGET


def test_workspace_mirror_at_the_cap():
    """The workspace a matrix (bt_ws): the active count and the panels'
    first reflectors, every panel's T and its reflector block of m + 15
    rows of nb entries and 16 bytes; at complex128 m = 4096, 256 panels of
    16; at m = 8192 (the half route), 1024 panels of 8."""
    m, es = 4096, 16
    npmax = 256
    t_off = -(-4 * (1 + npmax) // 16) * 16
    want = t_off + npmax * 256 * es + npmax * (m + 15) * (16 + 1) * es
    assert ek.backtransform_workspace_bytes(m, True) == want == 287306768
    assert ek.backtransform_workspace_bytes(2048, False) == (
        -(-4 * 129 // 16) * 16 + 128 * 256 * 8 + 128 * 2063 * 18 * 8)
    m, npmax = 8192, 1024
    t_off = -(-4 * (1 + npmax) // 16) * 16
    want = t_off + npmax * 64 * es + npmax * (m + 15) * (8 + 1) * es
    assert ek.backtransform_workspace_bytes(m, True) == want == 1211224080
    assert ek.backtransform_workspace_bytes(8192, False) == (
        -(-4 * 513 // 16) * 16 + 512 * 256 * 8 + 512 * 8207 * 18 * 8)


@pytest.mark.parametrize("m,rows,smem,ws", [
    (4097, 257, 128640, 303695888), (6144, 384, 176256, 681925648),
    (8192, 512, 230528, 1211224080)])
def test_half_route_plan_and_mirrors(m, rows, smem, ws):
    """The half route's plan (complex128, m in (4096, 8192]): a cluster of
    16 CTAs of ceil(m / 16) rows over each tile of 16 columns (keep = m /
    2: m / 32 tiles), the apply's shared memory (rows of z at a stride of
    17, one panel of 8 at a stride of 9, T, the rank partials, W, the four
    warps' scratch) and the workspace, by m alone; m = 8193 fits no
    route."""
    assert ek.backtransform_routes(m, True) == "half"
    assert ek.backtransform_panel(m, True) == (NB_HALF, COLS_HALF)
    assert bt_plan(m) == (16, rows)
    rp = -(-rows // 16) * 16
    npmax = -(-(m - 1) // NB_HALF)
    elems = (rp * 17 + rp * 9 + 64 + 16 * 8 + 8 + 8 * 16 + 4 * 8 * 16)
    assert ek.backtransform_apply_smem(m, 16, True) == (
        elems * 16 + -(-4 * npmax // 16) * 16) == smem
    assert smem <= SMEM_BUDGET
    assert ek.backtransform_workspace_bytes(m, True) == ws
    assert -(-(m // 2) // COLS_HALF) == m // 32
    assert ek.backtransform_apply_smem(8193, 16, True) > SMEM_BUDGET


NB_HALF = 8     # kNbHalf: reflectors of a panel on the half route
COLS_HALF = 16  # kColsHalf: output columns of a cluster there
WARPS = 8       # the apply's warps, each a share of the partial Y's rows


def _warp_tree(parts):
    """The eight warps' partial Y summed as the kernel's scratch tree does:
    warps 4-7 into 0-3, then 2-3 into 0-1, then 1 into 0 (each adds the
    other's tile to its own)."""
    parts = list(parts)
    span = len(parts) // 2
    while span >= 1:
        for w in range(span):
            parts[w] = parts[w] + parts[w + span]
        span //= 2
    return parts[0]


def _cmul(a, b):
    """a b of complex numbers held as (real, imaginary) pairs of float64
    tensors: four products and two sums, each one rounding, so that an
    entry's bits cannot depend on its neighbours (torch's complex kernels
    may fuse differently across vector widths)."""
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _cadd(a, b):
    return (a[0] + b[0], a[1] + b[1])


def _pair(x):
    return (x.real.clone(), x.imag.clone()) if x.is_complex() else (
        x.clone(), torch.zeros_like(x))


def _zeros(shape):
    return (torch.zeros(shape, dtype=torch.float64),
            torch.zeros(shape, dtype=torch.float64))


def _warp_tree(parts):
    """The eight warps' partial Y summed as the kernel's scratch tree does:
    warps 4-7 into 0-3, then 2-3 into 0-1, then 1 into 0 (each adds the
    other's tile to its own)."""
    parts = list(parts)
    span = len(parts) // 2
    while span >= 1:
        for w in range(span):
            parts[w] = _cadd(parts[w], parts[w + span])
        span //= 2
    return parts[0]


def apply_half(panels, z, keep, groups, cols=COLS_HALF):
    """bt_apply_kernel on the half route (complex128) over `groups` ranks,
    tiles of `cols` columns, in its order of operations, each column's
    arithmetic elementwise in real pairs (so that the bits cannot depend on
    the tile): per panel, last first, each rank's partial Y over its rows
    below the panel's first reflector, warp w taking the groups of four
    rows 4 (w + 8 j) from the first such row rounded down to four, each
    group's four products summed in row order into the warp's sum; the
    warps' sums in the scratch tree; the ranks' partials in rank order; W
    = T Y, T's row summed over the reflectors in order; Z -= V W in two
    steps of four reflectors."""
    m = z.shape[0]
    rows = [torch.arange(g, max(g, m), groups) for g in range(groups)]
    out = torch.zeros((m, keep), dtype=torch.complex128)
    nb = panels[0][1].shape[1]
    for c0 in range(0, keep, cols):
        cw = min(cols, keep - c0)
        zs = [_pair(z[r, c0:c0 + cw]) for r in rows]
        for k0, v, t in reversed(panels):
            y = None
            vgs = []
            for g in range(groups):
                rg = rows[g]
                l0 = int((rg <= k0).sum())  # first row below k0
                vg = _pair(v[rg].conj())
                vgs.append((l0, vg))
                warps = []
                for w in range(WARPS):
                    acc = _zeros((nb, cw))
                    for l4 in range((l0 & ~3) + 4 * w, len(rg), 4 * WARPS):
                        grp = _zeros((nb, cw))
                        for l in range(max(l4, l0), min(l4 + 4, len(rg))):
                            grp = _cadd(grp, _cmul(
                                (vg[0][l][:, None], vg[1][l][:, None]),
                                (zs[g][0][l][None, :], zs[g][1][l][None, :])))
                        acc = _cadd(acc, grp)
                    warps.append(acc)
                part = _warp_tree(warps)
                y = part if y is None else _cadd(y, part)
            tp = _pair(t)
            w_ = _zeros((nb, cw))
            for j in range(nb):
                w_ = _cadd(w_, _cmul((tp[0][:, j:j + 1], tp[1][:, j:j + 1]),
                                     (y[0][j:j + 1], y[1][j:j + 1])))
            for g in range(groups):
                l0, vc = vgs[g]
                vg = (vc[0], -vc[1])  # V again, from its conjugate
                for ks in range(0, nb, 4):
                    upd = _zeros(zs[g][0][l0:].shape)
                    for i in range(ks, ks + 4):
                        upd = _cadd(upd, _cmul(
                            (vg[0][l0:, i:i + 1], vg[1][l0:, i:i + 1]),
                            (w_[0][i:i + 1], w_[1][i:i + 1])))
                    zs[g][0][l0:] -= upd[0]
                    zs[g][1][l0:] -= upd[1]
        for g in range(groups):
            out[rows[g], c0:c0 + cw] = torch.complex(*zs[g])
    return out


@pytest.mark.parametrize("m,keep", [(24, 24), (40, 13), (70, 35)])
def test_half_route_order_matches_plain(m, keep):
    """The half route's order (panels of 8, tiles of 16 columns, the
    warps' row groups and scratch tree, the rank partials in order),
    forced at small m in complex128 on reflectors with a run of inactive
    ones, against backtransform_plain to 1e-12 over 1, 4 and 16 ranks;
    tiles of 16, 8 and 1 columns give the same bits."""
    vrows, tau, z = _reflectors(m, torch.complex128, m)
    tau[m // 3:m // 3 + 3] = 0.0
    ref = ek.backtransform_plain(vrows, tau, z, keep)
    panels = prepare(vrows, tau, NB_HALF)
    assert all(v.shape[1] == NB_HALF for _, v, _ in panels)
    for groups in (1, 4, 16):
        out = apply_half(panels, z, keep, groups)
        assert float((out - ref).abs().max()) < TOL[torch.complex128], groups
    at16 = apply_half(panels, z, keep, 4)
    for cols in (8, 1):
        assert torch.equal(apply_half(panels, z, keep, 4, cols), at16)


def test_c128_cap_launches_with_a_stand_in_library(card):  # noqa: F811
    """On the card (library replaced by a recorder that sizes the
    workspace by the mirror) complex128 K4 at m = 8192, the half route,
    launches its double instantiation and counts as a reach launch of
    complex128 and a launch of the half route; at m = 8193 the call raises
    before any launch."""
    card.backtransform_workspace = ek.backtransform_workspace_bytes
    ek.backtransform.half_launches = 0
    m, keep = 8192, 8
    vrows = torch.zeros((), dtype=torch.complex128).expand(m, m)
    tau = torch.zeros((), dtype=torch.complex128).expand(m)
    z = torch.zeros((), dtype=torch.float64).expand(m, m)
    out = ek.backtransform(vrows, tau, z, keep)
    assert out.shape == (m, keep)
    assert card.calls == ["backtransform_f64_launch"]
    assert card.args[0][5:8] == (m, keep, 1)
    assert ek.backtransform.reach_f64_launches == 1
    assert ek.backtransform.half_launches == 1
    with pytest.raises(ValueError, match="size <= 8192"):
        big = torch.zeros((), dtype=torch.complex128).expand(m + 1, m + 1)
        ek.backtransform(big, tau, z, keep)
    assert len(card.calls) == 1
