"""The environment-chain kernel of the sweep probes (K1), its plain PyTorch
version, and its wrapper.

Counterpart of the JAX package's `ops/pallas_env.py`. A Rotosolve /
Rotoselect probe on site q needs the 2x2 local overlap matrix

    C[i, j] = <R| (|i><j| at site q) |L>

from the B-form site tensors of the bra R and the ket L (n, 2, chi, chi):

  forward   e' = sum_p A_p^H e B_p           over sites 0 .. q-1
  backward  f' = sum_p conj(A_p) f B_p^T     over sites n-1 .. q+1
  combine   C[i, j] = sum conj(A_i[a, x]) e[a, b] B_j[b, y] f[x, y]  at q

with A = R's and B = L's tensors and both chains starting from |0><0| on the
(padded) boundary bond. The wrapper runs the plain version for tensors on the
CPU and launches the CUDA kernels for tensors on a CUDA device
(ops/dispatch.py), raising for anything they do not take (chi > 8192, another
dtype, a non-contiguous or misaligned tensor). To chi = 128 each chain runs
on a thread-block cluster and the two combine in whichever cluster finishes
last, chosen through a counter that the wrapper keeps per device and
stream: complex64 to chi = 64 in the narrow kernel of csrc/env_chain.cu,
above it in csrc/env_chain_wide.cu (a 4 x 4 cluster, each CTA a block of
the environment: `wide_plan`), complex128 in env_chain.cu's double
instantiation. Past chi = 128 the
streamed kernel of csrc/env_chain_stream.cu keeps the environments in the
wrapper's global scratch and runs each site as two tiled products over the
whole card, both chains in the same launches, in either dtype (complex64 on
FFMA, complex128 on the fp64 tensor cores), with the depth split into
slices where a launch would not fill the card (`stream_slices`). Every call
counts one in `env_chain.launches`, and one in the counter of its variant:
`env_chain.wide_launches` (complex64, 64 < chi <= 128), `.f64_launches`
(complex128, chi <= 128), `.reach_launches` (streamed, complex64) or
`.reach_f64_launches` (streamed, complex128).
"""

from __future__ import annotations

import torch

from . import cuda_lib, dispatch

NARROW_MAX_CHI = 64  # the narrow variant holds both B_p of a site and two
                     # chi x chi partials in a CTA's shared memory; above
                     # it complex64 runs csrc/env_chain_wide.cu
CLUSTER_MAX_CHI = 128  # csrc/env_chain.cu; past it the streamed kernel

_COUNTERS = {}  # (device, stream) -> the kernel's combine counter (int32)

# The complex64 wide kernel's plan (csrc/env_chain_wide.cu wide_plan;
# chip_smoke.py holds the two equal on the card): a chain's cluster of
# WIDE_GRID CTAs of WIDE_THREADS threads, the register tiles it picks by
# cost, and its shared memory.
WIDE_GRID = (4, 4)
WIDE_THREADS = 256
WIDE_STEP1_TILES = ((4, 2), (3, 2), (2, 2))
WIDE_STEP2_TILES = ((4, 4), (3, 3), (4, 2))

# The streamed kernel's plan (csrc/env_chain_stream.cu kConfigs, plan_config,
# plan_slices, plan_work; chip_smoke.py holds the two equal on the card).
# A config: (rows, columns, depth tile, CTAs an SM holds that the plan
# fills) of a CTA's tile.
STREAM_CONFIGS = ((128, 128, 16, 1),  # complex64, even chi >= 512
                  (64, 64, 16, 3),    # complex64, even chi < 512
                  (64, 64, 16, 3),    # complex64, odd chi
                  (64, 64, 8, 2))     # complex128 (DMMA)
STREAM_WAVE = 132  # the H100 SXM's SMs
STREAM_MAX_SLICES = 16
# (products, depth blocks np) of the host loop's launches: step 1 of both
# chains or one (the combine's four products are the first), step 2 of both
# or one
STREAM_LAUNCHES = ((4, 1), (2, 1), (2, 2), (1, 2))


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def stream_config(chi: int, f64: bool) -> int:
    """The index in STREAM_CONFIGS of the streamed kernel's CTA tile."""
    if f64:
        return 3
    if chi % 2:
        return 2
    return 0 if chi >= 512 else 1


def stream_slices(chi: int, f64: bool, products: int, np_: int) -> int:
    """Depth slices of a launch of `products` products of depth np_ chi: of
    S = 1 .. STREAM_MAX_SLICES (at most one depth tile a slice), the S whose
    waves of STREAM_WAVE times the CTAs an SM holds, each 1 / S of the
    depth, take the least time, ceil(ctas S / wave) / S; a split must give
    at least STREAM_WAVE CTAs, and a larger S must gain 10% over the best
    smaller one, to pay for its reduction."""
    bm, bn, bk, fill = STREAM_CONFIGS[stream_config(chi, f64)]
    ctas = _ceil(chi, bm) * _ceil(chi, bn) * products
    wave = STREAM_WAVE * fill
    best, best_w = 1, _ceil(ctas, wave)
    for s in range(2, min(np_ * _ceil(chi, bk), STREAM_MAX_SLICES) + 1):
        w = _ceil(ctas * s, wave)
        if ctas * s >= STREAM_WAVE and 10 * w * best < 9 * best_w * s:
            best, best_w = s, w
    return best


def stream_work(chi: int, f64: bool) -> int:
    """Elements of the streamed kernel's scratch: the environments and
    products (6 chi^2) and the most partial sums a launch keeps."""
    part = max([s * p for p, np_ in STREAM_LAUNCHES
                if (s := stream_slices(chi, f64, p, np_)) > 1], default=0)
    return (6 + part) * chi * chi


def _tile_cost(tiles: int, r1: int, r2: int) -> int:
    """A thread's cost per depth step of an r1 x r2 tile when `tiles` tiles
    share the block: rounds times 4 FMAs an output and r1 + r2 loads, a
    load counted as two FMAs."""
    return _ceil(tiles, WIDE_THREADS) * (4 * r1 * r2 + 2 * (r1 + r2))


def wide_plan(chi: int) -> dict:
    """The complex64 wide K1's plan at 64 < chi <= 128: CTA (i, j) of the
    4 x 4 cluster owns block rows [i br, i br + br) x columns [j bc, j bc +
    bc) of the environment; `ld` is step 1's depth (chi made even), `lde`,
    `ldb` and `lda` the row strides of the environment's rows (and the
    forward A block) and of the backward B and A blocks, all even; `vec`:
    TMA copies (chi and br even); the tiles (`step1`, `step2`) are the
    cheapest by _tile_cost (the first of a tie); `smem` the dynamic shared
    memory in bytes: the B and A blocks in either chain's layout, the rows
    of E, the partials received and the products M."""
    if not NARROW_MAX_CHI < chi <= CLUSTER_MAX_CHI:
        raise ValueError(f"env_chain: no wide plan at chi={chi}")
    gr, gc = WIDE_GRID
    br, bc = _ceil(chi, gr), _ceil(chi, gc)
    ld = chi + chi % 2

    def pick(tiles, cands):
        return min(cands, key=lambda t: _tile_cost(tiles(*t), *t))
    step1 = pick(lambda r1, r2: 2 * _ceil(br, r1) * _ceil(bc, r2),
                 WIDE_STEP1_TILES)
    step2 = pick(lambda r1, r2: _ceil(chi, r1) * _ceil(bc, r2),
                 WIDE_STEP2_TILES)
    lde = ldb = ld + 2
    lda = (br + 2) & ~1
    def up(x):  # buffers start on 128 bytes (16 elements)
        return -(-x // 16) * 16
    elems = (up(2 * max(bc * ldb, ld * bc)) + up(2 * max(ld * lda, br * lde))
             + up(br * lde) + up(gr * br * bc) + 2 * br * bc)
    return dict(ctas=gr * gc, grid=(gr, gc), br=br, bc=bc, ld=ld, lde=lde,
                ldb=ldb, lda=lda, vec=chi % 2 == 0 and br % 2 == 0,
                step1=step1, step2=step2, smem=8 * elems,
                threads=WIDE_THREADS)


def _counter(device, stream: int) -> torch.Tensor:
    """A zeroed int32 that the kernel leaves at zero: one per stream, so
    launches that share one are ordered."""
    key = (str(device), stream)
    t = _COUNTERS.get(key)
    if t is None:
        t = torch.zeros(1, dtype=torch.int32, device=device)
        _COUNTERS[key] = t
    return t


_BOUNDARY = {}  # (chi, dtype, device) -> the shared boundary environment


def boundary_env(chi: int, dtype, device) -> torch.Tensor:
    """|0><0| on the padded boundary bond: where every chain starts. One
    shared tensor per (chi, dtype, device), which no caller may write into:
    setting its one element costs a host-to-device copy, a synchronisation
    that the full-cost sweep would pay three times a probed gate."""
    key = (chi, dtype, str(device))
    e0 = _BOUNDARY.get(key)
    if e0 is None:
        e0 = torch.zeros((chi, chi), dtype=dtype, device=device)
        e0[0, 0] = 1.0
        _BOUNDARY[key] = e0
    return e0


def forward_step(e, a, b):
    """e' = sum_p A_p^H e B_p for site tensors a, b (2, chi, chi); any of
    the three may carry leading batch dimensions, which broadcast."""
    return torch.einsum("...pax,...pay->...xy", a.conj(),
                        e.unsqueeze(-3) @ b)


def backward_step(f, a, b):
    """f' = sum_p conj(A_p) f B_p^T."""
    return torch.einsum("pxa,pay->xy", a.conj(), f @ b.transpose(-1, -2))


def env_chain_plain(br: torch.Tensor, bl: torch.Tensor, q: int):
    """C (2, 2) complex, as above, in plain PyTorch."""
    n, _, chi, _ = br.shape
    e0 = boundary_env(chi, br.dtype, br.device)
    e = e0
    for i in range(q):
        e = forward_step(e, br[i], bl[i])
    f = e0
    for i in range(n - 1, q, -1):
        f = backward_step(f, br[i], bl[i])
    h = (e @ bl[q]) @ f.transpose(-1, -2)  # H_j[a, x] = (e B_j f^T)[a, x]
    return torch.einsum("iax,jax->ij", br[q].conj(), h)


def cluster_size(chi: int, f64: bool = False) -> int:
    """CTAs a chain the kernel runs on at this chi, in complex64 or (f64)
    complex128: in env_chain.cu 8, or 16 where the card takes two such
    clusters at once, never more than chi; in the complex64 wide kernel
    (64 < chi <= 128) its 4 x 4 cluster."""
    lib = cuda_lib.lib()
    cs = (lib.env_chain_wide_cluster_size(int(chi))
          if not f64 and chi > NARROW_MAX_CHI
          else lib.env_chain_cluster_size(int(chi), int(f64)))
    if cs == 0:
        raise RuntimeError(f"env_chain: no cluster size can launch chi={chi}")
    return cs


def env_chain(br: torch.Tensor, bl: torch.Tensor, q: int) -> torch.Tensor:
    """Kernel K1 (replaces pallas_env._env_kernel): C (2, 2) complex."""
    n, _, chi, _ = br.shape
    if not dispatch.use_kernel("env", br.device.type, br.dtype, chi):
        return env_chain_plain(br, bl, q)
    if not 0 <= q < n:
        raise ValueError(f"env_chain: site q={q} outside [0, {n})")
    dt = br.dtype
    cuda_lib.require(br, "env_chain bra", dt, (n, 2, chi, chi))
    cuda_lib.require(bl, "env_chain ket", dt, (n, 2, chi, chi))
    if bl.device != br.device:
        raise ValueError("env_chain: bra and ket on different devices")
    if (br.data_ptr() | bl.data_ptr()) % 16:
        raise ValueError("env_chain: site stacks must be 16-byte aligned")
    f64 = dt == torch.complex128
    lib = cuda_lib.lib()
    stream = cuda_lib.stream_of(br)
    out = torch.empty((2, 2), dtype=dt, device=br.device)
    if chi > CLUSTER_MAX_CHI:
        # the environments E, F, the products M_0, M_1 of each chain and
        # the depth slices' partial sums
        size = stream_work(chi, f64)
        work = torch.empty(size, dtype=dt, device=br.device)
        rc = lib.env_chain_stream_launch(
            br.data_ptr(), bl.data_ptr(),
            boundary_env(chi, dt, br.device).data_ptr(), work.data_ptr(),
            size, out.data_ptr(), n, chi, int(q), int(f64), stream)
        cuda_lib.check(rc, "env_chain")
        env_chain.launches += 1
        env_chain.reach_launches += not f64
        env_chain.reach_f64_launches += f64
        return out
    counter = _counter(br.device, stream).data_ptr()
    snaps = torch.empty((2, chi, chi), dtype=dt, device=br.device)
    if f64:
        count = lib.env_chain_f64_partials(chi)
        if count == 0:
            raise RuntimeError(f"env_chain: no cluster size can launch "
                               f"chi={chi} in complex128")
        partials = torch.empty(count, dtype=dt, device=br.device)
        rc = lib.env_chain_f64_launch(
            br.data_ptr(), bl.data_ptr(), snaps.data_ptr(),
            partials.data_ptr(), counter, out.data_ptr(), n, chi, int(q),
            stream)
    else:
        launch = (lib.env_chain_wide_launch if chi > NARROW_MAX_CHI
                  else lib.env_chain_launch)
        rc = launch(br.data_ptr(), bl.data_ptr(), snaps.data_ptr(), counter,
                    out.data_ptr(), n, chi, int(q), stream)
    cuda_lib.check(rc, "env_chain")
    env_chain.launches += 1
    env_chain.wide_launches += not f64 and chi > NARROW_MAX_CHI
    env_chain.f64_launches += f64
    return out


env_chain.launches = 0
env_chain.wide_launches = 0
env_chain.f64_launches = 0
env_chain.reach_launches = 0
env_chain.reach_f64_launches = 0
