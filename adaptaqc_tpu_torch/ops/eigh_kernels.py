"""The three eigensolver kernels of the bond truncation (K2-K4), their plain
PyTorch versions, and their wrappers.

Counterpart of the JAX package's `ops/pallas_eigh.py`. `svd_trunc` needs the
top eigenpairs of the Hermitian Gram matrix h = theta^H theta (m = 2 chi):

  tridiag        h = Q T Q^H, T real symmetric tridiagonal (zhetd2 semantics:
                 beta = -sign(Re alpha) |x|, tau = 1 - beta^ alpha^, scale-
                 invariant reflector v = [0.., 1, x^ / (alpha^ - beta^)]);
                 a step whose column is exactly zero (|alpha|^2 + |x|^2 ==
                 0) is the identity: tau = e = 0, v = e_{k+1}. One
                 deviation from the JAX kernel: where that sum of squares
                 falls below tiny / eps (gradual underflow; the residue
                 columns of a rank-deficient Gram reach it) the norm is
                 taken scaled, so the reflector stays unitary;
  teig           the top `keep` eigenpairs of T (all m by default): 30
                 rounds of Sturm bisection (one lane per eigenvalue,
                 descending), ulp-scaled separation of coincident shifts,
                 two rounds of partial-pivoted LU inverse iteration from the
                 fixed right-hand side b0, then CGS2 across the columns. The
                 first keep columns depend on no later one (a lane's
                 bisection reads only itself, its shift only earlier
                 eigenvalues, CGS2 column j only columns < j), so keep
                 columns of the call equal the first keep of the full call;
  backtransform  out = H_0 H_1 ... H_{m-2} z with H_k = I - tau_k v_k v_k^H.

Each wrapper runs the plain version for a tensor on the CPU and launches the
CUDA kernel (csrc/eigh_tridiag.cu, csrc/tridiag_grid.cu for K2 past its
cluster's shared memory, csrc/backtransform_wide.cu and
csrc/backtransform_strip.cu for K4's wide design) for a tensor on a CUDA
device (ops/dispatch.py): in complex64 for m <= 128 the register and
shared-memory designs, for 128 < m <= 4096 the wide
variants (K2 and K3 on a thread-block cluster of up to 16 CTAs a matrix;
K4 a preparation launch that gathers the active reflectors into panels
with their T, then a cluster of CTAs over the rows of each tile of 32
output columns), chosen by m alone; in complex128 / float64 the wide
variants' double instantiation, for every m <= 2048 (K4's cap there). Past what a cluster's
shared memory holds, K2 runs its card-wide route (`tridiag_routes`:
"grid", complex64 past m = 640, complex128 past 438: one persistent kernel
over every SM, the matrix in the wrapper's workspace, a blocked Householder
reduction whose trailing updates run on the tensor cores in complex128),
and K3 runs its card-wide route (`wide_routes`: "global", complex64 past m
= 640, complex128 past 512: the iterate in global memory), launches over
the whole card that compute only the kept columns, its LU factors and
products in `scratch`, and K4 runs its strip route (`backtransform_routes`:
"strip", complex64 from m = 3072, complex128 from 1536:
csrc/backtransform_strip.cu, a CTA a strip of 32 output columns kept in
global memory, panels of 64 reflectors). It raises for anything the
kernels do not take (m above dispatch.REACH's 16384, another dtype, a
non-contiguous tensor). There is no fallback from a kernel to the plain
version. Each wrapper counts its launches in `<wrapper>.launches`, those of
them that took a batch (P > 1 matrices in one launch) in
`<wrapper>.batched_launches`, and each wide or complex128 launch in the
counter of the code it ran: `.reach_launches` (complex64) or
`.reach_f64_launches` (complex128) for what runs only past the old caps (K2
and K4 past REACH_M, by size; K3 on its card-wide route: `wide_routes`),
else
`<wrapper>.wide_launches` (complex64, m > 128) or `.f64_launches`
(complex128).

Every function here also takes one leading batch dimension P (h of shape
(P, m, m), d of (P, m), ...): the full-cost sweep applies each gate to its
probe states at once. A wrapper launches once for the whole batch (one CTA,
one column of CTAs or one cluster a matrix; nothing is shared across the batch, so each
matrix gets the result of its own launch, bit for bit); a plain version
loops over the batch.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_lib, dispatch

NARROW_MAX_M = 128  # the register and shared-memory designs; above it the
                    # wide variants
# by f64: the eigensolver's cap before its wide variants took m past it
# (complex64: the JAX kernels' own reach, pallas_eigh.supported;
# complex128: the largest m whose first wide K4's panel fit in shared
# memory). K2's and K4's launches past it count as reach_launches /
# reach_f64_launches, and only past it does K3 take its card-wide
# route (wide_routes)
REACH_M = {False: 560, True: 504}
_B0_SEED = 181818


def _teig_constants(dtype: torch.dtype):
    """(bisection rounds, relative eps, pivmin floor) for a real dtype.

    float32 keeps the JAX kernel's constants (30 rounds, 1.2e-7, 1e-35).
    float64 scales them to its mantissa: 60 rounds, 2.3e-16 (its machine
    epsilon rounded up as 1.2e-7 is float32's), floor 1e-300."""
    if dtype == torch.float32:
        return 30, 1.2e-7, 1e-35
    if dtype == torch.float64:
        return 60, 2.3e-16, 1e-300
    raise TypeError(f"teig: unsupported dtype {dtype}")


@functools.lru_cache(maxsize=32)
def _b0_np(m: int) -> np.ndarray:
    """Fixed inverse-iteration right-hand side: the JAX package's array
    (numpy default_rng(181818).normal, rounded to float32)."""
    return np.random.default_rng(_B0_SEED).normal(size=(m, m)).astype(
        np.float32)


_B0_CACHE = {}


def teig_b0(m: int, dtype: torch.dtype, device) -> torch.Tensor:
    """b0 on the device, uploaded once per (m, dtype, device)."""
    key = (m, dtype, str(device))
    t = _B0_CACHE.get(key)
    if t is None:
        t = torch.from_numpy(_b0_np(m)).to(device=device, dtype=dtype)
        _B0_CACHE[key] = t
    return t


# ------------------------------------------------------------------ plain

def _over_batch(fn, *tensors):
    """fn on every matrix of a batch (the leading dimension of each tensor),
    its outputs stacked."""
    outs = [fn(*args) for args in zip(*tensors)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def tridiag_plain(h: torch.Tensor):
    """Householder tridiagonalization of a Hermitian h (m, m), or of every
    matrix of a batch (P, m, m).

    Returns (vrows (m, m) complex with row k = v_k, tau (m,) complex,
    d (m,) real, e (m,) real); entries m-1 of tau and e are zero."""
    if h.dim() == 3:
        return _over_batch(tridiag_plain, h)
    m = h.shape[-1]
    a = h.clone()
    rdt = a.real.dtype
    dev = a.device
    vrows = torch.zeros_like(a)
    tau = torch.zeros(m, dtype=a.dtype, device=dev)
    e = torch.zeros(m, dtype=rdt, device=dev)
    one = torch.ones((), dtype=rdt, device=dev)
    zero = torch.zeros((), dtype=rdt, device=dev)
    fi = torch.finfo(rdt)
    tiny_squares = fi.tiny / fi.eps
    for k in range(m - 1):
        col = a[:, k]
        alpha = col[k + 1]
        x = col[k + 2:]
        xnorm2 = (x.real * x.real + x.imag * x.imag).sum()
        ss = alpha.real * alpha.real + alpha.imag * alpha.imag + xnorm2
        # a sum of squares this small may have lost bits to gradual
        # underflow, and a reflector normalised by it is not unitary: take
        # the norm scaled by the column's largest component instead
        tail = torch.view_as_real(col[k + 1:]).abs()
        amax = tail.max()
        sc = tail * torch.where(amax > 0, one / amax, zero)
        nrm = torch.where(ss < tiny_squares,
                          amax * torch.sqrt((sc * sc).sum()), torch.sqrt(ss))
        active = ss > 0
        inv = torch.where(active, one / torch.where(active, nrm, one), zero)
        ahr = alpha.real * inv
        ahi = alpha.imag * inv
        bh = torch.where(ahr >= 0, -one, one)
        beta = torch.where(active, bh * nrm, zero)
        tau_k = torch.complex(torch.where(active, 1.0 - ahr * bh, zero),
                              torch.where(active, -ahi * bh, zero))
        dr = ahr - bh
        di = ahi
        sdn = torch.where(active, dr * dr + di * di, one)
        v = torch.zeros(m, dtype=a.dtype, device=dev)
        v[k + 1] = 1.0
        v[k + 2:] = torch.complex((x.real * dr + x.imag * di) * inv / sdn,
                                  (x.imag * dr - x.real * di) * inv / sdn)
        u = a @ v
        s = torch.vdot(v, u)
        t2 = tau_k.conj() * s * 0.5
        w = tau_k * (u - t2 * v)
        a = a - torch.outer(v, w.conj()) - torch.outer(w, v.conj())
        vrows[k] = v
        tau[k] = tau_k
        e[k] = beta
    d = a.diagonal().real.clone()
    return vrows, tau, d, e


def teig_bounds(d: torch.Tensor, e: torch.Tensor):
    """(e_row, lo0, hi0, scale, pivmin) of the tridiagonal (d, e[:m-1]):
    e with e[m-1] = 0, the Gershgorin interval that bisection starts from,
    the spectrum's scale and the pivot floor of the Sturm and LU
    recurrences."""
    m = d.shape[0]
    dt = d.dtype
    _, eps_rel, piv_floor = _teig_constants(dt)
    e_row = e.clone()
    e_row[m - 1] = 0.0
    zero1 = torch.zeros(1, dtype=dt, device=d.device)
    e_left = torch.cat([zero1, e_row[:-1]])
    radius = e_row.abs() + e_left.abs()
    lo0 = (d - radius).min()
    hi0 = (d + radius).max()
    scale = torch.clamp(torch.maximum(lo0.abs(), hi0.abs()), min=1e-30)
    pivmin = torch.clamp((eps_rel * scale) ** 2, min=piv_floor)
    return e_row, lo0, hi0, scale, pivmin


def teig_plain_iterates(d: torch.Tensor, e: torch.Tensor,
                        b0: torch.Tensor = None, keep: int = None):
    """teig_plain up to its CGS2 (one matrix): (w (keep,) descending, the
    inverse-iteration iterate (m, keep), column j normalised for w[j]);
    keep = m by default. Every step is a lane's own, so the keep lanes of
    the call equal the first keep of the full call bit for bit."""
    m = d.shape[0]
    keep = m if keep is None else keep
    dt = d.dtype
    dev = d.device
    rounds, eps_rel, _ = _teig_constants(dt)
    if b0 is None:
        b0 = teig_b0(m, dt, dev)
    e_row, lo0, hi0, scale, pivmin = teig_bounds(d, e)
    neg_piv = -pivmin
    e2 = e_row * e_row
    lane = torch.arange(keep, device=dev)
    target = (m - 1 - lane).to(dt)

    # Sturm bisection: lane j converges onto the j-th largest eigenvalue.
    # Step i is q = (d_i - mid) - e_{i-1}^2 / q (addcdiv rounds exactly so),
    # with |q| < pivmin replaced by -pivmin; the count is of negative q.
    # A round first runs without the guard; only if some |q| fell below
    # pivmin (the guard would have fired) is it rerun with the guard, so
    # the result is that of the guarded recurrence either way.
    los = lo0.expand(keep).clone()
    his = hi0.expand(keep).clone()
    e2_rows = e2.unbind(0)

    def sturm(dm, guarded):
        q = dm[0]
        qs = []
        for i in range(m):
            if i:
                q = torch.addcdiv(dm[i], e2_rows[i - 1], q, value=-1.0)
            if guarded:
                q = torch.where(q.abs() < pivmin, neg_piv, q)
            qs.append(q)
        return torch.stack(qs)

    for _ in range(rounds):
        mid = 0.5 * (los + his)
        dm = (d[:, None] - mid[None, :]).unbind(0)
        qs = sturm(dm, False)
        if bool((qs.abs() < pivmin).any()):
            qs = sturm(dm, True)
        cnt = (qs < 0).sum(dim=0).to(dt)
        above = cnt > target
        los = torch.where(above, los, mid)
        his = torch.where(above, mid, his)
    w = 0.5 * (los + his)

    # lam[j] = min_{l<=j} (w[l] - (j-l) eps): coincident shifts split by ulps
    eps = eps_rel * scale
    gap = (lane[None, :] - lane[:, None]).to(dt)  # [l, j] = j - l
    sep = torch.where(gap >= 0, w[:, None] - gap * eps, hi0 + scale)
    lam = sep.min(dim=0).values

    def guard(v):
        return torch.where(v.abs() < pivmin,
                           torch.where(v >= 0, pivmin, neg_piv), v)

    # partial-pivoted LU of (T - lam I), one factorisation per lane
    e_rows = e_row.unbind(0)
    d_lam = (d[:, None] - lam[None, :]).unbind(0)
    zero = torch.zeros((), dtype=dt, device=dev)
    du, u1, u2, mrow, swp = [], [], [], [], []
    a_i = d_lam[0]
    s1_i = e_rows[0]
    for i in range(m - 1):
        a_next = d_lam[i + 1]
        s1_next = e_rows[i + 1]
        r2 = e_rows[i]
        swap = r2.abs() > a_i.abs()
        top0 = guard(torch.where(swap, r2, a_i))
        top1 = torch.where(swap, a_next, s1_i)
        top2 = torch.where(swap, s1_next, zero)
        bot0 = torch.where(swap, a_i, r2)
        bot1 = torch.where(swap, s1_i, a_next)
        bot2 = torch.where(swap, zero, s1_next)
        mlt = bot0 / top0
        du.append(top0)
        u1.append(top1)
        u2.append(top2)
        mrow.append(mlt)
        swp.append(swap)
        a_i = bot1 - mlt * top1
        s1_i = bot2 - mlt * top2
    du.append(guard(a_i))

    # two rounds of inverse iteration from b0 (rows of the iterate as a list)
    rows = list(b0[:, :keep].unbind(0))
    for _ in range(2):
        for i in range(m - 1):
            bi, bi1 = rows[i], rows[i + 1]
            bt = torch.where(swp[i], bi1, bi)
            rows[i] = bt
            rows[i + 1] = torch.where(swp[i], bi, bi1) - mrow[i] * bt
        rows[m - 1] = rows[m - 1] / du[m - 1]
        rows[m - 2] = (rows[m - 2] - u1[m - 2] * rows[m - 1]) / du[m - 2]
        for i in range(m - 3, -1, -1):
            rows[i] = (rows[i] - u1[i] * rows[i + 1]
                       - u2[i] * rows[i + 2]) / du[i]
        # a lane's column as a contiguous row, so that its sum of squares
        # is taken the same way whatever keep is
        bt = torch.stack(rows, dim=1)
        # scale by the max-abs first: a nearly singular shift leaves
        # |x| ~ 1/pivmin^2, whose square overflows float32
        amax = bt.abs().max(dim=1).values
        bt = bt / torch.where(amax > 0, amax, torch.ones_like(amax))[:, None]
        nrm2 = (bt * bt).sum(dim=1)
        bt = bt * torch.rsqrt(torch.clamp(nrm2, min=1e-30))[:, None]
        rows = list(bt.unbind(1))
    return w, bt.T.contiguous()


def cgs2_plain(bb: torch.Tensor) -> torch.Tensor:
    """CGS2 across the columns of bb (m, k), in place, column by column
    (descending order keeps clusters contiguous); column 0 is kept. The
    columns are worked on as the contiguous rows of bb^T, so that column j
    comes out the same whatever k is."""
    bt = bb.T.contiguous()
    for j in range(1, bt.shape[0]):
        prev = bt[:j]
        v = bt[j]
        for _ in range(2):
            v = v - prev.T @ (prev @ v)
        nrm2 = (v * v).sum()
        bt[j] = v * torch.rsqrt(torch.clamp(nrm2, min=1e-30))
    bb.copy_(bt.T)
    return bb


def teig_plain(d: torch.Tensor, e: torch.Tensor, b0: torch.Tensor = None,
               keep: int = None):
    """The top `keep` eigenpairs (all m by default) of the real symmetric
    tridiagonal (d, e[:m-1]).

    Returns (w (keep,) descending, z (m, keep) with column j the eigenvector
    of w[j]), the first keep of the full call's bit for bit. Vectorised over
    the eigenvalue lanes. d and e may carry a leading batch dimension (b0 is
    shared)."""
    if d.dim() == 2:
        return _over_batch(lambda dd, ee: teig_plain(dd, ee, b0, keep), d, e)
    w, bb = teig_plain_iterates(d, e, b0, keep)
    return w, cgs2_plain(bb)


def backtransform_plain(vrows: torch.Tensor, tau: torch.Tensor,
                        z: torch.Tensor, keep: int) -> torch.Tensor:
    """Q z[:, :keep] for Q = H_0 ... H_{m-2}: (m, keep) complex (with a
    leading batch dimension on vrows, tau and z: for every matrix)."""
    if vrows.dim() == 3:
        return _over_batch(
            lambda v, t, zz: backtransform_plain(v, t, zz, keep), vrows, tau,
            z)
    m = vrows.shape[0]
    out = z[:, :keep].to(vrows.dtype)
    for k in range(m - 2, -1, -1):
        v = vrows[k]
        y = v.conj() @ out  # (keep,)
        out = out - torch.outer(tau[k] * v, y)
    return out


# --------------------------------------------------------------- wrappers

def _batch_of(t: torch.Tensor, core_dims: int, name: str):
    """(lead, P): the leading shape () or (P,) of a tensor whose matrix or
    vector takes the last `core_dims` dimensions, and the batch size."""
    lead = tuple(t.shape[:-core_dims])
    if len(lead) > 1:
        raise ValueError(f"{name}: at most one batch dimension, got shape "
                         f"{tuple(t.shape)}")
    return lead, (lead[0] if lead else 1)


def _count(fn, p: int, m: int, f64: bool, reach: bool = False):
    """One launch of fn at m; `reach`: it ran code that only sizes past the
    old caps run."""
    fn.launches += 1
    fn.batched_launches += p > 1
    fn.wide_launches += not f64 and NARROW_MAX_M < m and not reach
    fn.f64_launches += f64 and not reach
    fn.reach_launches += not f64 and reach
    fn.reach_f64_launches += f64 and reach


def tridiag(h: torch.Tensor):
    """Kernel K2 (replaces pallas_eigh._tridiag_kernel). h (m, m) or
    (P, m, m) must already be Hermitian (the caller symmetrises it). Same
    outputs as tridiag_plain; one launch whatever P."""
    m = h.shape[-1]
    if not dispatch.use_kernel("eigh", h.device.type, h.dtype, m):
        return tridiag_plain(h)
    lead, p = _batch_of(h, 2, "tridiag")
    cuda_lib.require(h, "tridiag h", h.dtype, lead + (m, m))
    dev = h.device
    f64 = h.dtype == torch.complex128
    rdt = torch.float64 if f64 else torch.float32
    vrows = torch.empty(lead + (m, m), dtype=h.dtype, device=dev)
    tau = torch.empty(lead + (m,), dtype=h.dtype, device=dev)
    d = torch.empty(lead + (m,), dtype=rdt, device=dev)
    e = torch.empty(lead + (m,), dtype=rdt, device=dev)
    lib = cuda_lib.lib()
    if (f64 or m > NARROW_MAX_M) and tridiag_routes(m, f64) == "grid":
        # the card-wide route: the matrix, the panel and its vectors in one
        # workspace (the batch's matrices one after another)
        ws = torch.empty(_tridiag_grid_bytes(m, f64), dtype=torch.uint8,
                         device=dev)
        launch = (lib.tridiag_grid_f64_launch if f64
                  else lib.tridiag_grid_launch)
        rc = launch(h.data_ptr(), ws.data_ptr(), vrows.data_ptr(),
                    tau.data_ptr(), d.data_ptr(), e.data_ptr(), m, p, m * m,
                    cuda_lib.stream_of(h))
    elif f64 or m > NARROW_MAX_M:
        launch = lib.tridiag_f64_launch if f64 else lib.tridiag_wide_launch
        rc = launch(h.data_ptr(), vrows.data_ptr(), tau.data_ptr(),
                    d.data_ptr(), e.data_ptr(), m, p, m * m,
                    cuda_lib.stream_of(h))
    else:
        rc = lib.tridiag_launch(
            h.data_ptr(), vrows.data_ptr(), tau.data_ptr(), d.data_ptr(),
            e.data_ptr(), m, p, m * m, cuda_lib.stream_of(h))
    cuda_lib.check(rc, "tridiag")
    _count(tridiag, p, m, f64, m > REACH_M[f64])
    return vrows, tau, d, e


@functools.lru_cache(maxsize=64)
def _teig_scratch_reals(m: int) -> int:
    """K3's wide scratch a matrix, in reals: m fixes it (every route, every
    keep)."""
    return int(cuda_lib.lib().teig_wide_scratch(int(m)))


def teig(d: torch.Tensor, e: torch.Tensor, keep: int = None):
    """Kernel K3 (replaces pallas_eigh._teig_kernel). The outputs of
    teig_plain(d, e, keep=keep): (w (keep,) descending, z (m, keep)
    eigenvector columns), with the leading batch dimension of d and e if
    they have one; w bit for bit, z to rounding (the kernel orthogonalises
    in blocks, BCGS2). On the card z is a view of the first keep columns of
    an (m, m) buffer (row stride m); the card-wide route computes only
    those, the other routes all m."""
    m = d.shape[-1]
    keep = m if keep is None else int(keep)
    if not 1 <= keep <= m:
        raise ValueError(f"teig: keep={keep} outside [1, {m}]")
    if not dispatch.use_kernel("eigh", d.device.type,
                               torch.promote_types(d.dtype, torch.complex64),
                               m):
        return teig_plain(d, e, keep=keep)
    lead, p = _batch_of(d, 1, "teig")
    rdt = d.dtype
    cuda_lib.require(d, "teig d", rdt, lead + (m,))
    cuda_lib.require(e, "teig e", rdt, lead + (m,))
    dev = d.device
    f64 = rdt == torch.float64
    lib = cuda_lib.lib()
    b0 = teig_b0(m, rdt, dev)
    w = torch.empty(lead + (m,), dtype=rdt, device=dev)
    z = torch.empty(lead + (m, m), dtype=rdt, device=dev)
    # the card-wide route starts past REACH_M: within it, the older code
    reach = m > REACH_M[f64] and wide_routes(m, f64)["teig"] == "global"
    if f64 or m > NARROW_MAX_M:
        # the cluster route's LU factors where they do not fit in its shared
        # memory; the card-wide route's LU factors and W partials
        sn = _teig_scratch_reals(m)
        scratch = torch.empty((p, sn), dtype=rdt, device=dev)
        launch = lib.teig_f64_launch if f64 else lib.teig_wide_launch
        rc = launch(d.data_ptr(), e.data_ptr(), b0.data_ptr(), w.data_ptr(),
                    z.data_ptr(), scratch.data_ptr(), m, keep, p, m, m, sn,
                    cuda_lib.stream_of(d))
    else:
        rc = lib.teig_launch(
            d.data_ptr(), e.data_ptr(), b0.data_ptr(), w.data_ptr(),
            z.data_ptr(), m, p, m, m, cuda_lib.stream_of(d))
    cuda_lib.check(rc, "teig")
    _count(teig, p, m, f64, reach)
    return w[..., :keep], z[..., :, :keep]


def teig_cluster_size(m: int, f64: bool = False) -> int:
    """CTAs of the thread-block cluster on which K3's cluster route solves
    one matrix of size m (complex64 above NARROW_MAX_M, or f64: complex128
    at every m, up to where the iterate fits: wide_routes "smem"): ceil(m /
    32), at most 16, or 8 where the card does not take a cluster of 16."""
    g = cuda_lib.lib().teig_cluster_size(int(m), int(f64))
    if g == 0:
        raise RuntimeError(f"teig: no cluster size can launch m={m}"
                           + (" in complex128" if f64 else ""))
    return g


TEIG_GLOBAL_STAGES = ("bisect", "invit", "inblock")  # bits 1, 2, 4


def teig_grid_plan(m: int, f64: bool = False) -> dict:
    """How K3's card-wide route (wide_routes "global") runs one matrix of
    size m: `block`, the columns a block of its BCGS2; `inblock_ctas`, the
    CTAs of the cluster whose shared memory holds a block's m rows for the
    CGS2 inside it (ceil(m / 128), at most 16, more where a CTA's rows would
    not fit); `rows`, the rows a CTA of it, ceil(m / inblock_ctas); `slabs`,
    the row slabs of its W partial sums, ceil(m / 64); `global`, the stages
    that read their operands from global memory because one CTA's shared
    memory does not hold them at keep = m (of TEIG_GLOBAL_STAGES: in double
    the inverse iteration's d, e and w past m = 8,488, the in-block rows
    past 13,056 at 16 CTAs, the multisection's d and e2 past 14,518; none
    in float to m = 16384). Those stages give the same bits as where they
    fit. Every m has a plan: shared memory no longer caps the route."""
    out = (ctypes.c_int * 5)()
    rc = cuda_lib.lib().teig_grid_plan(int(m), int(f64), out)
    if rc != 0:
        raise RuntimeError(f"teig: no card-wide plan launches m={m}"
                           + (" in complex128" if f64 else ""))
    return {"block": out[0], "inblock_ctas": out[1], "rows": out[2],
            "slabs": out[3],
            "global": tuple(name for bit, name in enumerate(TEIG_GLOBAL_STAGES)
                            if out[4] >> bit & 1)}


def wide_routes(m: int, f64: bool = False) -> dict:
    """The route of K3's wide variant at m (complex64 above NARROW_MAX_M,
    or f64: complex128 at every m): `teig`, "smem" where one cluster keeps
    the iterate's columns in its CTAs' shared memory (complex64 to m = 640,
    complex128 to 512), "global" past it: the card-wide route, its iterate
    in global memory (teig_grid_plan)."""
    r = cuda_lib.lib().eigh_wide_routes(int(m), int(f64))
    if r < 0:
        raise RuntimeError(f"eigh: no wide plan launches m={m}"
                           + (" in complex128" if f64 else ""))
    return {"teig": "global" if r & 1 else "smem"}


def backtransform_cluster_size(m: int, keep: int, f64: bool = False) -> int:
    """CTAs of the cluster over the rows of one tile of 32 output columns
    on K4's double route (complex64 above NARROW_MAX_M, or f64: complex128,
    to BT_DOUBLE_MAX) for `keep` columns of one matrix: ceil(m / 128)
    (ceil(m / 64) at m <= 512), at most 16, or fewer where that makes all
    of the launch's clusters fit on the card at once."""
    g = cuda_lib.lib().backtransform_cluster_size(int(m), int(keep),
                                                  int(f64))
    if g == 0:
        raise RuntimeError(f"backtransform: no cluster size can launch m={m}"
                           + (" in complex128" if f64 else ""))
    return g


def tridiag_routes(m: int, f64: bool = False) -> str:
    """The route of K2's wide variant at m (complex64 above NARROW_MAX_M,
    or f64: complex128 at every m): "smem" where one thread-block cluster
    keeps every row in its CTAs' shared memory (complex64 to m = 640,
    complex128 to 438: tridiag_cluster_plan), "grid" past it: the
    card-wide route (tridiag_grid_plan, which raises where it cannot
    launch). Raises below the wide variant's sizes."""
    r = cuda_lib.lib().tridiag_routes(int(m), int(f64))
    if r < 0:
        raise RuntimeError(f"tridiag: no route launches m={m}"
                           + (" in complex128" if f64 else ""))
    return "grid" if r else "smem"


def tridiag_cluster_plan(m: int, f64: bool = False) -> dict:
    """How K2's cluster route runs one matrix of size m (complex64 above
    NARROW_MAX_M, or f64: complex128 at every m, while its rows fit):
    `ctas`, the CTAs of its thread-block cluster (1 at m <= 64, else
    ceil(m / 16), at most 16, or 8 where the card does not take the larger
    cluster); `rows`, the rows a CTA holds in its shared memory, ceil(m /
    ctas). Raises where they do not fit (the card-wide route's sizes)."""
    g = cuda_lib.lib().tridiag_cluster_size(int(m), int(f64))
    if g == 0:
        raise RuntimeError(f"tridiag: no cluster size can launch m={m}"
                           + (" in complex128" if f64 else ""))
    return {"ctas": g, "rows": -(-int(m) // g)}


def tridiag_grid_plan(m: int, f64: bool = False) -> dict:
    """How K2's card-wide route runs a matrix of size m: `panel`, the
    columns a panel reduces before its trailing update; `ctas`, the CTAs of
    its persistent kernel (one an SM); `slab`, the rows of a partial sum of
    the panel's products with v; `smem`, a CTA's dynamic shared memory in
    bytes (the column, or the trailing update's tiles). Raises where it
    cannot launch."""
    out = (ctypes.c_int * 4)()
    rc = cuda_lib.lib().tridiag_grid_plan(int(m), int(f64), out)
    if rc != 0:
        raise RuntimeError(f"tridiag: no card-wide plan launches m={m}"
                           + (" in complex128" if f64 else ""))
    return {"panel": out[0], "ctas": out[1], "slab": out[2],
            "smem": out[3]}


GRID_PANEL = 32  # tridiag_grid.cu kNb: the columns of a panel
GRID_SLAB = 64   # kSlab: the rows of a slab's partial sums


GRID_MAX_CTAS = 256          # kMaxCtas: the barrier's words
GRID_COLUMN_SMEM = 200 * 1024  # kColumnSmem


def tridiag_grid_column_global(m: int, f64: bool = False) -> bool:
    """Whether the card-wide K2 keeps each CTA's column and v in its
    workspace (gcol_global): where the column (m complex), the slabs'
    partials (8 x 2 GRID_PANEL complex), or the trailing update's planes (8
    x 64 x 36 reals) if larger, and the row flags (m bytes), each rounded
    to 16 bytes, pass GRID_COLUMN_SMEM: complex128 past m = 11,565."""
    cs = 16 if f64 else 8

    def r16(x):
        return (x + 15) // 16 * 16
    col = r16(m * cs) + 8 * 2 * GRID_PANEL * cs
    planes = 8 * 64 * 36 * (cs // 2)
    return r16(max(planes, col)) + r16(m) > GRID_COLUMN_SMEM


def tridiag_grid_workspace_bytes(m: int, f64: bool = False) -> int:
    """The card-wide K2's workspace as csrc/tridiag_grid.cu lays it out
    (glayout), each part from a 256-byte boundary: the matrix (m x m
    complex), the panel's V and W (m x GRID_PANEL each), the column and y
    (m each), the slabs' partials of a and b (ceil(m / GRID_SLAB) x 2 x
    GRID_PANEL), two buffers of row flags (2 m ints) and the grid barrier's
    words (GRID_MAX_CTAS of 4 bytes); where tridiag_grid_column_global,
    then each CTA's column (GRID_MAX_CTAS x m complex). Every offset is
    64-bit (the matrix alone is 2^32 bytes at complex128 m = 16384).
    chip_smoke.py holds it equal to the library's."""
    cs = 16 if f64 else 8

    def align(x):
        return (x + 255) // 256 * 256
    slabs = -(-m // GRID_SLAB)
    total = (align(m * m * cs) + 2 * align(m * GRID_PANEL * cs)
             + 2 * align(m * cs) + align(slabs * 2 * GRID_PANEL * cs)
             + align(2 * m * 4) + GRID_MAX_CTAS * 4)
    if tridiag_grid_column_global(m, f64):
        total = align(total) + GRID_MAX_CTAS * m * cs
    return total


@functools.lru_cache(maxsize=64)
def _tridiag_grid_bytes(m: int, f64: bool) -> int:
    """The card-wide K2's workspace, in bytes: m and the dtype fix it."""
    nbytes = cuda_lib.lib().tridiag_grid_workspace(int(m), int(f64))
    if nbytes <= 0:
        raise RuntimeError(f"tridiag: no workspace at m={m}"
                           + (" in complex128" if f64 else ""))
    return nbytes


BT_NB = 16            # backtransform_wide.cu kNb: reflectors of a panel
BT_COLS = 32          # kCols: output columns of a cluster
BT_MAX_CLUSTER = 16   # kMaxCluster
# by f64: the last m whose rows of z a cluster of 16 keeps beside two panel
# buffers (kDoubleMaxF64 / kDoubleMaxF32)
BT_DOUBLE_MAX = {False: 5888, True: 2816}
# csrc/backtransform_strip.cu, the strip route: from BT_STRIP_FROM[f64]
# (kStripFromF32 / kStripFromF64, the first sizes where it measured faster
# than the double route) it takes every m
BT_STRIP_FROM = {False: 3072, True: 1536}
BT_STRIP_NB = 64       # kNb: reflectors of a panel
BT_STRIP_LDV = 66      # kLdv: a panel row's stride, in elements
BT_STRIP_NARROW_MAX = 4224  # kNarrowMax: strips of 16 columns to it, else
                            # of 32
BT_STRIP_ALIGN = 64    # kAlign: the padded m, panel p's first row 64 p
BT_STRIP_ROWS = {False: 64, True: 32}  # Cplx<T>::kRows: rows of a chunk
BT_STRIP_PREP_CHUNK = 64  # kPrepChunk
BT_STRIP_MAX_M = 16384    # kMaxM: the plan and the workspace are defined
                          # to it (dispatch.REACH's cap)


def backtransform_routes(m: int, f64: bool = False) -> str:
    """The wide K4's route at m, by m and the dtype alone (bt_strip_route,
    C backtransform_route): "double" (backtransform_wide.cu: a cluster of
    CTAs over the rows of each tile of 32 columns, two panel buffers;
    below complex64 m = 3072, complex128 m = 1536) or "strip"
    (backtransform_strip.cu: a CTA a strip of 16 or 32 columns, panels of
    64, every m from BT_STRIP_FROM)."""
    return "strip" if m >= BT_STRIP_FROM[f64] else "double"


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def backtransform_workspace_bytes(m: int, f64: bool = False) -> int:
    """The double route's workspace a matrix as csrc/backtransform_wide.cu
    lays it out (bt_ws): the active count and each panel's first reflector
    (ints), each panel's T (16 x 16), then each panel's reflector block of
    m + BT_MAX_CLUSTER - 1 rows of 16 entries and 16 bytes. chip_smoke.py
    holds it equal to the library's."""
    es = 16 if f64 else 8
    nb = BT_NB
    npmax = -(-(m - 1) // nb)
    ldv = nb + 16 // es
    t_off = _round16(4 * (1 + npmax))
    v_off = t_off + npmax * nb * nb * es
    return v_off + npmax * (m + BT_MAX_CLUSTER - 1) * ldv * es


def backtransform_apply_smem(m: int, g: int, f64: bool = False) -> int:
    """The double route's bt_apply_kernel dynamic shared memory in bytes at
    m on a cluster of g CTAs (bt_smem): rows of z (R = ceil(m / g),
    rounded up to 16, at a stride of 36), two panel buffers and two T, the
    partial Y posted by every rank, their sum, W, and the panels' first
    reflectors."""
    es = 16 if f64 else 8
    nb, cols = BT_NB, BT_COLS
    rp = _round16(-(-m // g))
    ldz = cols + 4
    ldv = nb + 16 // es
    ncmax = -(-cols // g)
    elems = (rp * ldz + 2 * rp * ldv + 2 * nb * nb + g * nb * ncmax
             + nb * ncmax + nb * cols)
    return elems * es + _round16(4 * -(-(m - 1) // nb))


def backtransform_strip_cols(m: int, f64: bool = False) -> int:
    """The columns of a strip (one CTA) at m (bt_strip_cols): 16 to m =
    BT_STRIP_NARROW_MAX (keep = m / 2 then makes at most 132 strips, one
    wave on an H100), else 32; the same in both dtypes."""
    return 16 if m <= BT_STRIP_NARROW_MAX else 32


def backtransform_strip_plan(m: int, f64: bool = False) -> dict:
    """How the strip route runs a matrix of size m (backtransform_strip.cu,
    by m and the dtype alone): `nb` reflectors a panel, `cols` columns a
    strip (a CTA; a launch has ceil(keep / cols) of them a matrix), `rows`
    of a chunk staged at a time, `mpad` (m rounded up to BT_STRIP_ALIGN),
    `panels` at most, `smem` the apply's dynamic shared memory (strip_smem:
    two stages of two panels' chunk and Z's chunk at a stride of cols + 2,
    W in complex64, the first rows) and `prep_smem` the preparation's, and
    `workspace` a matrix in bytes (strip_ws: the count and first rows, each
    panel's 64 x 64 T, then panel p's rows 64 p .. mpad of BT_STRIP_LDV
    entries). chip_smoke.py holds them equal to the library's."""
    es = 16 if f64 else 8
    nb, rows = BT_STRIP_NB, BT_STRIP_ROWS[f64]
    cols = backtransform_strip_cols(m, f64)
    npmax = -(-(m - 1) // nb)
    mpad = -(-m // BT_STRIP_ALIGN) * BT_STRIP_ALIGN
    stage = 2 * rows * BT_STRIP_LDV + rows * (cols + 2)
    extra = 0 if f64 else nb * cols
    smem = (2 * stage + extra) * es + _round16(4 * npmax)
    t_off = _round16(4 * (1 + npmax))
    v_rows = npmax * mpad - nb * npmax * (npmax - 1) // 2
    return {"nb": nb, "cols": cols, "rows": rows, "mpad": mpad,
            "panels": npmax, "smem": smem,
            "prep_smem": (nb * (BT_STRIP_PREP_CHUNK + 1) + nb * nb) * es,
            "workspace": (t_off + npmax * nb * nb * es
                          + v_rows * BT_STRIP_LDV * es)}


def backtransform_strip_zbuf_bytes(m: int, keep: int,
                                   f64: bool = False) -> int:
    """The strip route's working columns a matrix (strip_zbuf): ceil(keep /
    cols) strips of mpad rows of cols complex elements."""
    mpad = -(-m // BT_STRIP_ALIGN) * BT_STRIP_ALIGN
    cols = backtransform_strip_cols(m, f64)
    return -(-keep // cols) * mpad * cols * (16 if f64 else 8)


@functools.lru_cache(maxsize=64)
def _bt_workspace_bytes(m: int, f64: bool) -> int:
    """The double route's workspace a matrix, in bytes: m and the dtype fix
    it."""
    nbytes = cuda_lib.lib().backtransform_workspace(int(m), int(f64))
    if nbytes <= 0:
        raise RuntimeError(f"backtransform: no workspace at m={m}"
                           + (" in complex128" if f64 else ""))
    return nbytes


@functools.lru_cache(maxsize=64)
def _bt_strip_bytes(m: int, f64: bool) -> int:
    """The strip route's workspace a matrix, in bytes: m and the dtype fix
    it."""
    nbytes = cuda_lib.lib().backtransform_strip_workspace(int(m), int(f64))
    if nbytes <= 0:
        raise RuntimeError(f"backtransform: no strip workspace at m={m}"
                           + (" in complex128" if f64 else ""))
    return nbytes


def backtransform_strip_launch(vrows, tau, z, keep: int,
                               z_stride: int = None) -> torch.Tensor:
    """One launch of the strip route on CUDA tensors, whatever the route
    at m (the wrapper takes it past BT_STRIP_FROM; a timing script may
    force it below): vrows (P, m, m) or (m, m), tau, z as the wrapper
    checks them. Counts nothing."""
    m = vrows.shape[-1]
    lead, p = _batch_of(vrows, 2, "backtransform")
    f64 = vrows.dtype == torch.complex128
    if z_stride is None:
        z_stride = z.stride(0) if lead else m * m
    lib = cuda_lib.lib()
    out = torch.empty(lead + (m, keep), dtype=vrows.dtype,
                      device=vrows.device)
    ws = torch.empty((p, _bt_strip_bytes(m, f64)), dtype=torch.uint8,
                     device=vrows.device)
    zb = torch.empty((p, lib.backtransform_strip_zbuf(int(m), int(keep),
                                                      int(f64))),
                     dtype=torch.uint8, device=vrows.device)
    rc = lib.backtransform_strip_launch(
        vrows.data_ptr(), tau.data_ptr(), z.data_ptr(), out.data_ptr(),
        ws.data_ptr(), zb.data_ptr(), m, keep, p, m * m, m, z_stride,
        int(f64), cuda_lib.stream_of(vrows))
    cuda_lib.check(rc, "backtransform")
    return out


def backtransform(vrows: torch.Tensor, tau: torch.Tensor, z: torch.Tensor,
                  keep: int) -> torch.Tensor:
    """Kernel K4 (replaces pallas_eigh._backtransform_kernel): the first
    `keep` columns of z lifted to the complex basis, (m, keep), or
    (P, m, keep) for a batch. Each matrix drops its own inactive reflectors
    inside the kernel: the wrapper reads nothing back. The wide design's
    workspace (the gathered panels and their T) has a size that depends on
    m and the dtype alone."""
    m = vrows.shape[-1]
    if not dispatch.use_kernel("eigh", vrows.device.type, vrows.dtype, m):
        return backtransform_plain(vrows, tau, z, keep)
    if not 1 <= keep <= m:
        raise ValueError(f"backtransform: keep={keep} outside [1, {m}]")
    lead, p = _batch_of(vrows, 2, "backtransform")
    f64 = vrows.dtype == torch.complex128
    cuda_lib.require(vrows, "backtransform vrows", vrows.dtype,
                     lead + (m, m))
    cuda_lib.require(tau, "backtransform tau", vrows.dtype, lead + (m,))
    # z: an (m, m) matrix, or teig's view of the first columns of one
    z_stride = cuda_lib.require_columns(
        z, "backtransform z", torch.float64 if f64 else torch.float32, lead,
        m, keep, m)
    strip = (f64 or m > NARROW_MAX_M) and backtransform_routes(
        m, f64) == "strip"
    if strip:
        out = backtransform_strip_launch(vrows, tau, z, keep, z_stride)
    else:
        out = torch.empty(lead + (m, keep), dtype=vrows.dtype,
                          device=vrows.device)
        lib = cuda_lib.lib()
        stream = cuda_lib.stream_of(vrows)
        if f64 or m > NARROW_MAX_M:
            ws = torch.empty((p, _bt_workspace_bytes(m, f64)),
                             dtype=torch.uint8, device=vrows.device)
            launch = (lib.backtransform_f64_launch if f64
                      else lib.backtransform_wide_launch)
            rc = launch(vrows.data_ptr(), tau.data_ptr(), z.data_ptr(),
                        out.data_ptr(), ws.data_ptr(), m, keep, p, m * m, m,
                        z_stride, stream)
        else:
            rc = lib.backtransform_launch(vrows.data_ptr(), tau.data_ptr(),
                                          z.data_ptr(), out.data_ptr(), m,
                                          keep, p, m * m, m, z_stride, stream)
        cuda_lib.check(rc, "backtransform")
    _count(backtransform, p, m, f64, m > REACH_M[f64])
    backtransform.strip_launches += strip
    return out


backtransform.strip_launches = 0  # the strip route's launches
for _fn in (tridiag, teig, backtransform):
    _fn.launches = 0
    _fn.batched_launches = 0
    _fn.wide_launches = 0
    _fn.f64_launches = 0
    _fn.reach_launches = 0
    _fn.reach_f64_launches = 0


def eigh_top_kernels(h: torch.Tensor, keep: int):
    """Top-`keep` eigenpairs of Hermitian h (m, m) or (P, m, m) through
    K2 -> K3 -> K4: three launches whatever P. Returns (w (keep,)
    descending, V (m, keep) eigenvector columns), batched as h is."""
    hh = (h + h.mH) * 0.5
    vrows, tau, d, e = tridiag(hh.contiguous())
    w, z = teig(d, e, keep)
    return w, backtransform(vrows, tau, z, keep)
