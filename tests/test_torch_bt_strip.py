"""K4's strip route (csrc/backtransform_strip.cu: complex64 from m = 3072,
complex128 from 1536), its order of operations emulated in torch on the
CPU with the route forced at small m, and its plan mirrors.

  preparation  the active reflectors (tau != 0) in order, in panels of 64;
               each panel's G = V^H V over its rows in row order (one chain
               an entry) and T by the zlarft recurrence, T[l][i] = -tau_i
               sum_{q = l}^{i - 1} T[l][q] G[q][i] in q order;
  apply        a strip of 32 columns a CTA (16 to m = 4224), its own rows
               summed by itself:
               npan + 1 fused passes, pass j the update Z -= V_q W_q of
               panel q = npan - j (j > 0), then on the same chunk of rows
               Y_p += V_p^H Z of panel p = q - 1, chunk by chunk (32 rows
               in complex128, 64 in complex64) from p's first reflector's
               chunk; at the end of the pass W_p = T_p Y_p, T's row summed
               over all 64 reflectors in order. The update in complex64:
               Z the accumulator, one chain an entry over the reflectors in
               order; in complex128 the DMMA steps of four reflectors
               (lane k takes reflector 8 (s / 2) + 2 (s % 2) + {0, 1, 4,
               5}[k]), the even steps on Z's fragment, the odd ones on a
               second accumulator, added at the end. Y one chain an entry
               over the rows in order.

Every entry is computed from real pairs elementwise (so its bits cannot
depend on its neighbours): the columns of a strip never meet, so the same
bits come out over strip widths of 32, 8 and 1, and a batch of matrices
gives the bits of its P = 1 calls. Held against backtransform_plain: 1e-12
in complex128, 1e-5 in complex64, at m = 24, 70, 200, 600 and keep 1, m /
2, m on unitary reflectors with a run of inactive ones.
"""

import functools

import pytest
import torch

from adaptaqc_tpu_torch.ops import eigh_kernels as ek

from test_torch_bt_cluster import _reflectors
from test_torch_dispatch import card  # noqa: F401

torch.set_num_threads(1)

NB = 64                     # reflectors of a panel
COLS = 32                   # columns of a strip (16 to m = 4224)
ROWS = {False: 64, True: 32}  # rows of a chunk, by f64
TOL = {False: 1e-5, True: 1e-12}
SMEM_BUDGET = 232448 - 16   # a CTA's shared memory on an H100, less the
                            # apply's two static mbarriers


def _pair(x):
    return (x.real.clone(), x.imag.clone())


def _cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _cmul_conj(a, b):  # conj(a) b
    return (a[0] * b[0] + a[1] * b[1], a[0] * b[1] - a[1] * b[0])


def _cadd(a, b):
    return (a[0] + b[0], a[1] + b[1])


def _csub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def _zeros(shape, rdt):
    return (torch.zeros(shape, dtype=rdt), torch.zeros(shape, dtype=rdt))


def refl(s, k):
    """The reflector lane k takes in the complex128 update's k step s."""
    return 8 * (s >> 1) + 2 * (s & 1) + (k & 1) + 4 * (k >> 1)


def prepare(vrows, tau):
    """strip_prep_kernel: [(first reflector k0, V (m, NB) as a real pair,
    T (NB, NB) as a real pair)] of every panel, in order."""
    m = vrows.shape[0]
    rdt = vrows.real.dtype
    active = [k for k in range(m - 1) if tau[k] != 0]
    panels = []
    for p, s0 in enumerate(range(0, len(active), NB)):
        idx = active[s0:s0 + NB]
        pn = len(idx)
        v = torch.zeros((m, NB), dtype=vrows.dtype)
        v[:, :pn] = vrows[idx].T  # row k of vrows is zero through entry k
        vp = _pair(v)
        g = _zeros((NB, NB), rdt)
        for r in range(NB * p, m):  # rows above 64 p are zero in the panel
            g = _cadd(g, _cmul_conj((vp[0][r][:, None], vp[1][r][:, None]),
                                    (vp[0][r][None, :], vp[1][r][None, :])))
        t = _zeros((NB, NB), rdt)
        tp = _pair(tau[idx])
        for i in range(pn):
            t[0][i, i], t[1][i, i] = tp[0][i], tp[1][i]
            acc = _zeros(i, rdt)
            for q in range(i):
                acc = _cadd(acc, _cmul((t[0][:i, q], t[1][:i, q]),
                                       (g[0][q, i], g[1][q, i])))
            ta = _cmul((tp[0][i], tp[1][i]), acc)
            t[0][:i, i], t[1][:i, i] = -ta[0], -ta[1]
        panels.append((idx[0], vp, t))
    return panels


def _update(zc, vq, w, f64):
    """One chunk's Z -= V W (zc: a pair of (rows, cols), vq: of (rows,
    NB), w: of (NB, cols)) in the kernel's order."""
    def term(i):
        v = (vq[0][:, i:i + 1], vq[1][:, i:i + 1])
        return _cmul(v, (w[0][i:i + 1], w[1][i:i + 1]))
    if not f64:
        for i in range(NB):
            zc = _csub(zc, term(i))
        return zc
    acc = [zc, _zeros(zc[0].shape, zc[0].dtype)]
    for s in range(NB // 4):
        for k in range(4):
            acc[s & 1] = _csub(acc[s & 1], term(refl(s, k)))
    return _cadd(acc[0], acc[1])


def apply_strip(panels, z, keep, f64, cols=None):
    """strip_apply_kernel in its order, strips of `cols` columns (all keep
    at once by default: the columns never meet)."""
    m = z.shape[0]
    cols = cols or keep
    rdt = torch.float64 if f64 else torch.float32
    rows = ROWS[f64]
    out = torch.zeros((m, keep), dtype=torch.complex128 if f64
                      else torch.complex64)
    npan = len(panels)
    for c0 in range(0, keep, cols):
        cw = min(cols, keep - c0)
        zs = (z[:, c0:c0 + cw].to(rdt).clone(),
              torch.zeros((m, cw), dtype=rdt))
        w = None
        for j in range(npan + 1):
            q, p = npan - j, npan - j - 1
            rlo = (panels[p][0] if p >= 0 else panels[q][0]) + 1
            qfirst = (panels[q][0] + 1) // rows if j > 0 else m
            y = _zeros((NB, cw), rdt)
            for c in range(rlo // rows, (m - 1) // rows + 1):
                r0, r1 = c * rows, min(c * rows + rows, m)
                if j > 0 and c >= qfirst:
                    vq = panels[q][1]
                    zc = _update((zs[0][r0:r1], zs[1][r0:r1]),
                                 (vq[0][r0:r1], vq[1][r0:r1]), w, f64)
                    zs[0][r0:r1], zs[1][r0:r1] = zc
                if p >= 0:
                    vp = panels[p][1]
                    for r in range(r0, r1):
                        y = _cadd(y, _cmul_conj(
                            (vp[0][r][:, None], vp[1][r][:, None]),
                            (zs[0][r][None, :], zs[1][r][None, :])))
            if p < 0:
                break
            t = panels[p][2]
            w = _zeros((NB, cw), rdt)
            for jj in range(NB):
                w = _cadd(w, _cmul((t[0][:, jj:jj + 1], t[1][:, jj:jj + 1]),
                                   (y[0][jj:jj + 1], y[1][jj:jj + 1])))
        out[:, c0:c0 + cw] = torch.complex(*zs)
    return out


def emulate(vrows, tau, z, keep, cols=None):
    f64 = vrows.dtype == torch.complex128
    panels = prepare(vrows, tau)
    if not panels:
        return z[:, :keep].to(vrows.dtype)
    return apply_strip(panels, z, keep, f64, cols)


@functools.lru_cache(maxsize=16)
def _inputs(m, dtype, seed):
    vrows, tau, z = _reflectors(m, dtype, seed)
    return vrows, tau, z


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("m", [24, 70, 200, 600])
@pytest.mark.parametrize("keep", ["one", "half", "all"])
def test_strip_order_matches_plain(dtype, m, keep):
    """The strip route's order (panels of 64, fused passes by chunks of
    rows, W = T Y) forced at small m gives backtransform_plain's Q z[:,
    :keep] on unitary reflectors with a run of inactive ones: 1e-12 in
    complex128, 1e-5 in complex64."""
    vrows, tau, z = _inputs(m, dtype, m)
    f64 = dtype == torch.complex128
    kp = {"one": 1, "half": m // 2, "all": m}[keep]
    ref = ek.backtransform_plain(vrows, tau, z, kp)
    out = emulate(vrows, tau, z, kp)
    assert out.shape == (m, kp)
    assert float((out - ref).abs().max()) < TOL[f64]


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_strip_width_and_batch_give_the_same_bits(dtype):
    """A strip's columns never meet: strips of 32, 8 and 1 columns give the
    bits of all keep columns at once, and each matrix of a batch is
    computed from its own reflectors alone (a batch's bits are its P = 1
    calls'); the preparation's panels and T do not depend on keep."""
    m, keep = 150, 40
    vrows, tau, z = _inputs(m, dtype, 11)
    at32 = emulate(vrows, tau, z, keep, COLS)
    assert torch.equal(emulate(vrows, tau, z, keep), at32)
    for cols in (8, 1):
        assert torch.equal(emulate(vrows, tau, z, keep, cols), at32)
    first = prepare(vrows, tau)
    again = prepare(vrows, tau)
    for (k0, v, t), (k1, v1, t1) in zip(first, again):
        assert k0 == k1 and all(torch.equal(a, b) for a, b in zip(t, t1))
    batch = [(vrows, tau, z), _inputs(m, dtype, 12)]
    outs = [emulate(v, t, zz, keep) for v, t, zz in batch]
    assert torch.equal(outs[0], at32)
    assert torch.equal(outs[1], emulate(*_inputs(m, dtype, 12), keep))
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_inactive_reflectors_leave_z(dtype):
    """Exactly inactive reflectors (tau = 0) are dropped: with none active
    no panel is made and z's columns come out unchanged; a panel of a few
    active ones among many inactive leaves z's rows above its first
    reflector unchanged, bit for bit."""
    m = 130
    vrows, tau, z = _inputs(m, dtype, 3)
    none = torch.zeros(m, dtype=dtype)
    assert prepare(vrows, none) == []
    out = emulate(vrows, none, z, 40)
    assert torch.equal(out, z[:, :40].to(dtype))
    assert torch.equal(out, ek.backtransform_plain(vrows, none, z, 40))
    few = torch.zeros(m, dtype=dtype)
    few[90:95] = tau[90:95]
    panels = prepare(vrows, few)
    assert len(panels) == 1 and panels[0][0] == 90
    out = emulate(vrows, few, z, 40)
    assert torch.equal(out[:91], z[:91, :40].to(dtype))
    ref = ek.backtransform_plain(vrows, few, z, 40)
    assert float((out - ref).abs().max()) < TOL[dtype == torch.complex128]


def _workspace(m, es):
    npmax = -(-(m - 1) // NB)
    mpad = -(-m // 64) * 64
    t_off = -(-4 * (1 + npmax) // 16) * 16
    rows = sum(mpad - NB * p for p in range(npmax))
    return t_off + npmax * NB * NB * es + rows * 66 * es


@pytest.mark.parametrize("f64,m", [
    (True, 2817), (True, 4096), (False, 5889), (True, 5889), (False, 8192),
    (True, 8192), (False, 16384), (True, 16384)])
def test_strip_plan_mirrors(f64, m):
    """The strip route's plan at m, by m and the dtype alone: its route;
    its workspace a matrix (the count and first rows, each panel's T, panel
    p's rows 64 p .. mpad at a stride of 66 elements), its working columns
    (ceil(keep / 32) strips of mpad rows of 32), its shared memory (two
    stages of two panels' chunk and Z's chunk, W in complex64, the first
    rows) within a CTA's, and the preparation's; defined to m = 16384."""
    es = 16 if f64 else 8
    plan = ek.backtransform_strip_plan(m, f64)
    cols = 16 if m <= 4224 else COLS
    assert ek.backtransform_routes(m, f64) == "strip"
    assert (plan["nb"], plan["cols"], plan["rows"]) == (NB, cols, ROWS[f64])
    npmax = -(-(m - 1) // NB)
    assert plan["panels"] == npmax and plan["mpad"] % 64 == 0
    assert plan["workspace"] == _workspace(m, es)
    rows = ROWS[f64]
    stage = 2 * rows * 66 + rows * (cols + 2)
    extra = 0 if f64 else NB * cols * es
    assert plan["smem"] == 2 * stage * es + extra + (
        -(-4 * npmax // 16) * 16)
    assert plan["smem"] <= SMEM_BUDGET
    assert plan["prep_smem"] == (NB * 65 + NB * NB) * es <= SMEM_BUDGET
    for keep in (1, m // 2, m):
        assert ek.backtransform_strip_zbuf_bytes(m, keep, f64) == (
            -(-keep // cols) * plan["mpad"] * cols * es)
    want = {(True, 4096): (153856, 144769296),
            (False, 8192): (186880, 283181584),
            (True, 8192): (170496, 566362640),
            (True, 16384): (171008, 2240021520)}.get((f64, m))
    if want:
        assert (plan["smem"], plan["workspace"]) == want


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_cap_launches_the_strip_route_with_a_stand_in_library(  # noqa: F811
        card, dtype):
    """On the card (library replaced by a recorder that sizes by the
    mirrors) K4 at the cap, m = 16384 (the strip plan's kMaxM), launches
    the strip route once, with the workspace and working columns the
    mirrors size, counts as a reach launch of its dtype and a strip launch;
    at m = 16385 it raises before any launch."""
    f64 = dtype == torch.complex128
    ek.backtransform.strip_launches = 0
    m, keep = ek.BT_STRIP_MAX_M, 40
    rdt = torch.float64 if f64 else torch.float32
    vrows = torch.zeros((), dtype=dtype).expand(m, m)
    tau = torch.zeros((), dtype=dtype).expand(m)
    z = torch.zeros((), dtype=rdt).expand(m, m)
    out = ek.backtransform(vrows, tau, z, keep)
    assert out.shape == (m, keep)
    assert card.calls == ["backtransform_strip_launch"]
    args = card.args[0]
    assert args[6:9] == (m, keep, 1) and args[12] == int(f64)
    assert ek.backtransform.strip_launches == 1
    assert (ek.backtransform.reach_f64_launches if f64
            else ek.backtransform.reach_launches) == 1
    with pytest.raises(ValueError, match="size <= 16384"):
        big = torch.zeros((), dtype=dtype).expand(m + 1, m + 1)
        ek.backtransform(big, tau, z, keep)
    assert len(card.calls) == 1


class _PlanLibrary:
    """Answers K4's plan queries as the library does (by the mirrors), one
    answer off where `off` names it."""

    def __init__(self, off=None):
        self.off = off

    def _bump(self, name, value):
        return value + (16 if name == self.off else 0)

    def backtransform_route(self, m, f64):
        return int(ek.backtransform_routes(m, bool(f64)) == "strip")

    def backtransform_strip_workspace(self, m, f64):
        return self._bump("workspace", ek.backtransform_strip_plan(
            m, bool(f64))["workspace"])

    def backtransform_strip_zbuf(self, m, keep, f64):
        return ek.backtransform_strip_zbuf_bytes(m, keep, bool(f64))

    def backtransform_strip_smem(self, m, f64):
        if m == 0:
            return ek.backtransform_strip_plan(2, bool(f64))["prep_smem"]
        return self._bump("smem", ek.backtransform_strip_plan(
            m, bool(f64))["smem"])

    def backtransform_cluster_size(self, m, keep, f64):
        return min(16, -(-m // (64 if m <= 512 else 128)))

    def backtransform_workspace(self, m, f64):
        return ek.backtransform_workspace_bytes(m, bool(f64))

    def backtransform_apply_smem(self, m, g, f64):
        return ek.backtransform_apply_smem(m, g, bool(f64))


@pytest.mark.parametrize("f64,m", [(False, 2048), (False, 8192),
                                   (True, 2816), (True, 4096),
                                   (True, 8192)])
def test_chip_smoke_plan_check_with_a_stand_in_library(monkeypatch, f64, m):
    """chip_smoke.bt_mirror_check holds the route and, by the route, the
    strip route's workspace, working columns and both launches' shared
    memory, or the cluster route's workspace and shared memory, against
    the library's answers, and fails where one differs; bt_plan_text names
    the plan the reach lines print."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from adaptaqc_tpu_torch.ops import cuda_lib
    monkeypatch.setattr(cuda_lib, "lib", lambda: _PlanLibrary())
    chip_smoke.bt_mirror_check(ek, cuda_lib, m, m // 2, f64)
    text = chip_smoke.bt_plan_text(ek, m, m // 2, f64)
    strip = ek.backtransform_routes(m, f64) == "strip"
    assert text.startswith("strip route" if strip else "double route")
    if strip:
        cols = ek.backtransform_strip_cols(m, f64)
        assert f"{-(-(m // 2) // cols)} strips of {cols} columns" in text
        for off in ("workspace", "smem"):
            monkeypatch.setattr(cuda_lib, "lib", lambda: _PlanLibrary(off))
            with pytest.raises(chip_smoke.SmokeFailure, match="mirror"):
                chip_smoke.bt_mirror_check(ek, cuda_lib, m, m // 2, f64)
