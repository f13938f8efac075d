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

From complex128 m = 1536 and complex64 m = 3072 (the measured crossover;
the cluster route's shared memory holds to 2816 and 5888) K4 takes its
strip route (csrc/backtransform_strip.cu), which
tests/test_torch_bt_strip.py emulates in full; here its route, shared
memory and workspace beside the cluster route's, its plan at m = 4097,
6144 and 8192, and its order at small m in complex128 again beside the
cluster route's.
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
    (False, 2048, "double"), (False, 3071, "double"),
    (False, 5888, "strip"), (False, 5889, "strip"),
    (False, 8192, "strip"),
    (True, 1535, "double"), (True, 2816, "strip"), (True, 2817, "strip"),
    (True, 4096, "strip"), (True, 4097, "strip"), (True, 8192, "strip")])
def test_apply_route_and_its_shared_memory(f64, m, route):
    """The route by m and the dtype alone (ek.backtransform_routes, the
    mirror of bt_strip_route): the cluster route below the measured
    crossover (complex64 m = 3072, complex128 1536), the strip route from
    it. The cluster route's two panel buffers beside its rows of z on a
    cluster of 16 fit a CTA's shared memory to complex64 m = 5888 and
    complex128 2816 and outgrow it past them; the strip route's shared
    memory is fixed but for the panels' first rows (186,880 bytes at
    complex64 m = 8192, 153,856 at complex128 4096 in strips of 16
    columns, 170,496 at 8192)."""
    assert ek.backtransform_routes(m, f64) == route
    g = min(16, -(-m // (64 if m <= 512 else 128)))
    assert ek.backtransform_routes(m - 1, f64) == (
        "double" if m - 1 < ek.BT_STRIP_FROM[f64] else "strip")
    fits = ek.backtransform_apply_smem(m, 16, f64) <= SMEM_BUDGET
    assert fits == (m <= ek.BT_DOUBLE_MAX[f64])
    if route == "double":
        assert bt_plan(m)[0] == g and ek.backtransform_apply_smem(
            m, g, f64) <= SMEM_BUDGET
    if route == "strip":
        smem = ek.backtransform_strip_plan(m, f64)["smem"]
        assert smem <= SMEM_BUDGET
        want = {(False, 8192): 186880, (True, 4096): 153856,
                (True, 8192): 170496}.get((f64, m))
        if want:
            assert smem == want


def test_workspace_mirror_at_the_cap():
    """The workspaces a matrix: the cluster route's (bt_ws: the active
    count and the panels' first reflectors, every panel's 16 x 16 T and its
    reflector block of m + 15 rows of 16 entries and 16 bytes) at its last
    m, and the strip route's at the cap m = 8192 (strip_ws: 128 panels of
    64, panel p's T and its rows 64 p .. 8192 at a stride of 66 elements),
    about half of a whole panel block a panel."""
    assert ek.backtransform_workspace_bytes(2048, False) == (
        -(-4 * 129 // 16) * 16 + 128 * 256 * 8 + 128 * 2063 * 18 * 8)
    m, npmax = 2816, 176
    assert ek.backtransform_workspace_bytes(m, True) == (
        -(-4 * (1 + npmax) // 16) * 16 + npmax * 256 * 16
        + npmax * (m + 15) * 17 * 16)
    m, npmax = 8192, 128
    t_off = -(-4 * (1 + npmax) // 16) * 16
    rows = npmax * m - 64 * npmax * (npmax - 1) // 2
    for f64, es in ((False, 8), (True, 16)):
        want = t_off + npmax * 64 * 64 * es + rows * 66 * es
        assert ek.backtransform_strip_plan(m, f64)["workspace"] == want
    assert ek.backtransform_strip_plan(m, True)["workspace"] == 566362640


@pytest.mark.parametrize("m,cols,tiles", [(4097, 16, 128), (6144, 32, 96),
                                          (8192, 32, 128)])
def test_strip_route_plan_and_mirrors(m, cols, tiles):
    """The strip route's plan at the complex128 sizes the half route took
    before it (m in (4096, 8192]): one CTA a strip of 32 columns, or 16 to
    m = 4224 (keep = m / 2: at most one wave on 132 SMs), panels of 64,
    chunks of 32 rows, the apply's and the preparation's shared memory, the
    workspace and the working columns, by m alone."""
    plan = ek.backtransform_strip_plan(m, True)
    assert ek.backtransform_routes(m, True) == "strip"
    assert (plan["nb"], plan["cols"], plan["rows"]) == (64, cols, 32)
    assert -(-(m // 2) // plan["cols"]) == tiles
    npmax = -(-(m - 1) // 64)
    assert plan["panels"] == npmax
    assert plan["smem"] == 2 * (2 * 32 * 66 + 32 * (cols + 2)) * 16 + (
        -(-4 * npmax // 16) * 16) <= SMEM_BUDGET
    assert plan["prep_smem"] == (64 * 65 + 64 * 64) * 16
    mpad = -(-m // 64) * 64
    assert ek.backtransform_strip_zbuf_bytes(m, m // 2, True) == (
        tiles * mpad * cols * 16)
    assert plan["workspace"] == (
        -(-4 * (1 + npmax) // 16) * 16 + npmax * 64 * 64 * 16
        + (npmax * mpad - 64 * npmax * (npmax - 1) // 2) * 66 * 16)


@pytest.mark.parametrize("m,keep", [(24, 24), (40, 13), (70, 35)])
def test_strip_route_order_matches_plain(m, keep):
    """The strip route's order (test_torch_bt_strip.emulate), forced at
    small m in complex128 on the reflectors and inactive runs the cluster
    route's tests use, against backtransform_plain to 1e-12 and against
    the cluster route's order over 1, 4 and 16 ranks to 1e-12; strips of
    32, 8 and 1 columns give the same bits (the order of the plan's strips
    of 16 at these m)."""
    from test_torch_bt_strip import emulate as strip_emulate
    vrows, tau, z = _reflectors(m, torch.complex128, m)
    tau[m // 3:m // 3 + 3] = 0.0
    ref = ek.backtransform_plain(vrows, tau, z, keep)
    out = strip_emulate(vrows, tau, z, keep)
    assert float((out - ref).abs().max()) < TOL[torch.complex128]
    for groups in (1, 4, 16):
        cl = emulate(vrows, tau, z, keep, groups)
        assert float((out - cl).abs().max()) < TOL[torch.complex128]
    for cols in (32, 8, 1):
        assert torch.equal(strip_emulate(vrows, tau, z, keep, cols), out)


def test_c128_cap_launches_with_a_stand_in_library(card):  # noqa: F811
    """On the card (library replaced by a recorder that sizes the
    workspace by the mirrors) complex128 K4 at the cap, m = 16384 (the
    strip route's kMaxM), launches the strip route and counts as a reach
    launch of complex128 and a launch of the strip route; at m = 16385 the
    call raises before any launch."""
    ek.backtransform.strip_launches = 0
    m, keep = ek.BT_STRIP_MAX_M, 8
    vrows = torch.zeros((), dtype=torch.complex128).expand(m, m)
    tau = torch.zeros((), dtype=torch.complex128).expand(m)
    z = torch.zeros((), dtype=torch.float64).expand(m, m)
    out = ek.backtransform(vrows, tau, z, keep)
    assert out.shape == (m, keep)
    assert card.calls == ["backtransform_strip_launch"]
    assert card.args[0][6:9] == (m, keep, 1)
    assert ek.backtransform.reach_f64_launches == 1
    assert ek.backtransform.strip_launches == 1
    with pytest.raises(ValueError, match="size <= 16384"):
        big = torch.zeros((), dtype=torch.complex128).expand(m + 1, m + 1)
        ek.backtransform(big, tau, z, keep)
    assert len(card.calls) == 1
