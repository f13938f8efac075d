"""Multi-device sharding for ADAPT-AQC on torch.distributed.

Counterpart of the JAX package's `parallel/mesh.py`. Two mesh axes, as
there:

 - dp: candidate-pair scoring shards its pairs over the dp ranks; each
   scores its pairs against the state, which every dp rank holds alike;
 - tp: the simulation state itself shards over the tp ranks: the 2^n
   statevector on its amplitude axis, the MPS on its right-bond (chi) axis.

The JAX package hands its sharded arrays to GSPMD, which partitions every
contraction and inserts the collectives. torch runs one process a device,
so here the sharded programs are written out (parallel/sv_sharded.py,
parallel/mps_sharded.py) over the local shards with explicit collectives:
all-reduces and broadcasts, the two that NCCL and gloo both take on CUDA
tensors, each on the smallest group that needs it. A sharded state is a
DTensor (distribute_tensor with Replicate/Shard placements, as
NamedSharding is), so its global shape and its shards read as the JAX
package's do.

Integration goes through the backends: `SVBackend(mesh=...)` and
`MPSBackend(mesh=...)` shard every engine state, so the O(G) sweeps and
the pair scoring run over the mesh with no compiler-side changes.

`launch(fn, n_devices, ...)` starts the ranks (torch.multiprocessing, a
FileStore in a temporary directory) and returns rank 0's result as numpy;
inside them `make_mesh` builds the (dp, tp) DeviceMesh. Ranks that share a
card need `backend="gloo"` (NCCL refuses two ranks on one device); where
each rank has its own card the default is NCCL.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import os
import pickle
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..backends import mps_core
from ..optim import sweeps

# the mesh's two axes, fixed here: the engines read them by these names
DP, TP = "dp", "tp"
AXES = (DP, TP)

# collectives this package issued in this process: their count and the
# largest payload one carried (elements of the tensors it sums, a complex
# element one), read by the tests to show that a sharded step never moves a
# whole statevector, and that the gradient and verifier contractions move
# at most one site of an MPS at a time
STATS = {"collectives": 0, "max_numel": 0}
# the most elements one all_sum_many may carry (None: no limit); payload_cap
_CAP = [None]

_RANK = {"device": None}  # the device this rank runs on (set by launch)
TIMEOUT_S = 900  # a collective that waits longer fails its rank


# ------------------------------------------------------------- launching

def _to_host(x):
    """Tensors (and DTensors' local shards) to numpy, through containers."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.to_local()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_to_host(v) for v in x)
    if hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    return x


def _rank_main(rank, world, device, backend, store, out, fn, args):
    if device == "cpu":
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    _RANK["device"] = dev
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S),
                            device_id=dev if backend == "nccl" else None)
    try:
        result = fn(*args)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(_to_host(result), f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def resolve_backend(n_devices: int, device: str,
                    backend: Optional[str]) -> str:
    """The process-group backend for n_devices ranks on `device`: gloo on
    the CPU; on CUDA NCCL where each rank has its own card, and where
    ranks share one the caller must name gloo (NCCL refuses two ranks on
    one device): no quiet switch."""
    if device == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"ranks on the CPU take backend='gloo', got "
                             f"{backend!r}")
        return "gloo"
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "ranks on the CPU")
    if n_devices > cards:
        if backend != "gloo":
            raise ValueError(
                f"{n_devices} ranks share {cards} card(s): NCCL refuses two "
                f"ranks on one device; pass backend='gloo' to run them over "
                f"gloo")
        return "gloo"
    return backend or "nccl"


class Launch:
    """Ranks started by launch(..., wait=False): result() waits for them
    and returns rank 0's result."""

    def __init__(self, context, tmp, out):
        self._context, self._tmp, self._out = context, tmp, out

    def result(self):
        try:
            while not self._context.join():
                pass
            with open(self._out, "rb") as f:
                return pickle.load(f)
        finally:
            self._tmp.cleanup()


def launch(fn, n_devices: int, *args, device: str = "cuda",
           backend: Optional[str] = None, wait: bool = True):
    """fn(*args) in n_devices ranks of one process group on `device` (the
    card unless the caller passes "cpu"); returns rank 0's result with its
    tensors as numpy (wait=False: a Launch, whose result() waits). fn must
    be importable by name (a module-level function), and a script that
    calls launch must guard its own work with `if __name__ ==
    "__main__"`, as every torch.multiprocessing spawn needs. On the card
    the kernels are built here first, so that every rank finds them
    built."""
    import torch.multiprocessing as mp
    backend = resolve_backend(n_devices, device, backend)
    if device == "cuda":
        from ..ops import cuda_lib
        cuda_lib.build()
    tmp = tempfile.TemporaryDirectory(prefix="adaptaqc_mesh_")
    store, out = os.path.join(tmp.name, "store"), os.path.join(tmp.name,
                                                               "out")
    try:
        context = mp.spawn(_rank_main, args=(n_devices, device, backend,
                                             store, out, fn, args),
                           nprocs=n_devices, join=False)
    except BaseException:
        tmp.cleanup()
        raise
    run = Launch(context, tmp, out)
    return run.result() if wait else run


def rank_device() -> torch.device:
    """The device of this rank (set by launch; the CPU outside it)."""
    return _RANK["device"] or torch.device("cpu")


# ------------------------------------------------------------------ mesh

def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Tuple[int, int]] = None):
    """The (dp, tp) DeviceMesh over the process group's ranks, by the JAX
    package's rule (mesh.py:38-50): tp the largest power of two <= 4 that
    fits, dp = n // tp. Every rank calls it, in the same order as every
    other collective. The statevector engine's exchange groups (the tp
    ranks that differ in a chosen set of one or two of the bits of their
    tp index) are made here too."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    n = n_devices or world
    if shape is None:
        tp = 1
        while tp * 2 <= n and tp < 4:
            tp *= 2
        shape = (n // tp, tp)
    dp, tp = shape
    if dp * tp != world:
        raise ValueError(f"a mesh of shape {shape} needs {dp * tp} ranks; "
                         f"the process group has {world}")
    if tp & (tp - 1):
        raise ValueError(f"the tp extent must be a power of two, got {tp}")
    mesh = init_device_mesh(rank_device().type, (dp, tp),
                            mesh_dim_names=AXES)
    mesh.adaptaqc_bit_groups = _bit_groups(dp, tp)
    return mesh


def _bit_groups(dp, tp):
    """{bits: (group, members)}: for every set of one or two bit positions
    of the tp index, this rank's group of the tp ranks (of its dp row)
    that agree with it on every other bit, with its members' global ranks
    in the order of their tp index. Every rank makes every group, in one
    order."""
    k = tp.bit_length() - 1
    me = dist.get_rank()
    sets = [(b,) for b in range(k)] + [(a, b) for a in range(k)
                                       for b in range(a + 1, k)]
    out = {}
    for bits in sets:
        mask = sum(1 << b for b in bits)
        for d in range(dp):
            for base in range(tp):
                if base & mask:
                    continue
                members = [d * tp + t for t in range(tp)
                           if t & ~mask == base]
                group = dist.new_group(members)
                if me in members:
                    out[bits] = (group, members)
    return out


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


# ----------------------------------------------------------- collectives

def _record(numel: int):
    STATS["collectives"] += 1
    STATS["max_numel"] = max(STATS["max_numel"], numel)


def _real(x):
    return torch.view_as_real(x) if x.is_complex() else x


def _all_reduce(buf: torch.Tensor, group, numel=None) -> torch.Tensor:
    """buf summed over `group` in place (complex as its real pairs);
    `numel`: the elements it carries, where buf holds complex ones as real
    pairs."""
    _record(buf.numel() if numel is None else numel)
    dist.all_reduce(_real(buf), group=group)
    return buf


@contextlib.contextmanager
def payload_cap(numel: int):
    """Within: all_sum_many carries at most `numel` elements an
    all-reduce, packing its terms first fit in their order (a term larger
    than that goes alone). The gradient and verifier contractions of
    parallel/mps_sharded.py run under one MPS site (2 chi^2): where their
    steps need more, they run several all-reduces."""
    before = _CAP[0]
    _CAP[0] = int(numel)
    try:
        yield
    finally:
        _CAP[0] = before


def all_sum(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The sum of x over the ranks of `group` (a new tensor; x itself
    where the group is one rank)."""
    if size == 1:
        return x
    return _all_reduce(x.contiguous().clone(), group)


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """x from global rank src to every rank of `group`, in place."""
    _record(x.numel())
    dist.broadcast(_real(x), src=src, group=group)
    return x


def all_sum_many(xs, group, size: int):
    """The sums over `group` of several tensors of one real type (complex
    ones as their real pairs) through one all-reduce of their values laid
    end to end (several under payload_cap): [sum of xs[0], sum of xs[1],
    ...]."""
    if size == 1 or not xs:
        return list(xs)
    cap = _CAP[0]
    bins, loads = [], []
    for i, x in enumerate(xs):
        for b, load in enumerate(loads):
            if cap is None or load + x.numel() <= cap:
                bins[b].append(i)
                loads[b] += x.numel()
                break
        else:
            bins.append([i])
            loads.append(x.numel())
    out = [None] * len(xs)
    for idx, load in zip(bins, loads):
        flat = [_real(xs[i].contiguous()).reshape(-1) for i in idx]
        buf = _all_reduce(torch.cat(flat), group, load)
        at = 0
        for i, f in zip(idx, flat):
            part = buf[at:at + f.numel()].view(_real(xs[i]).shape)
            out[i] = (torch.view_as_complex(part) if xs[i].is_complex()
                      else part)
            at += f.numel()
    return out


def padded(x: torch.Tensor, dim: int, size: int, index: int) -> torch.Tensor:
    """x as the index-th of `size` equal shards along `dim` of zeros: the
    term this rank adds to a gather by sum (gather_dim, all_sum_many)."""
    if size == 1:
        return x
    dim = dim % x.dim()
    shape = list(x.shape)
    w = shape[dim]
    shape[dim] = w * size
    full = torch.zeros(shape, dtype=x.dtype, device=x.device)
    full.narrow(dim, index * w, w).copy_(x)
    return full


def gather_dim(x: torch.Tensor, dim: int, group, size: int,
               index: int) -> torch.Tensor:
    """The shards x of `size` ranks (this one the index-th) joined along
    `dim`: each rank writes its shard into zeros and the group sums them
    (exact: every other term is zero), so NCCL and gloo alike take it."""
    if size == 1:
        return x
    return _all_reduce(padded(x, dim, size, index), group)


# -------------------------------------------------------------- sharding

def _placements(mesh, axis: Optional[str], dim: int):
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(dim) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def _distribute(mesh, x, axis, dim):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, _placements(mesh, axis, dim),
                             src_data_rank=None)


def replicate(mesh, x):
    """Every tensor of x (a tensor, an MPS or a tuple) replicated over the
    mesh; each rank keeps its own copy (no data moves)."""
    if isinstance(x, mps_core.MPS):
        return mps_core.MPS(*(replicate(mesh, t) for t in x))
    if isinstance(x, (tuple, list)):
        return type(x)(replicate(mesh, t) for t in x)
    return _distribute(mesh, x, None, 0)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard_state(mesh, state: torch.Tensor):
    """A statevector tp-sharded over its amplitude axis (replicated where
    the axis does not divide); a state already on the mesh as it is."""
    if _is_dtensor(state):
        return state
    if state.shape[-1] % axis_size(mesh, TP):
        return replicate(mesh, state)
    return _distribute(mesh, state, TP, state.dim() - 1)


def shard_mps(mesh, state: mps_core.MPS):
    """An MPS tp-sharded over its right-bond (chi) axis: b (n, 2, chi, chi)
    and lam (n+1, chi) on their last axis, trunc replicated (all replicated
    where chi does not divide); a state already on the mesh as it is."""
    if _is_dtensor(state.b):
        return state
    if state.chi % axis_size(mesh, TP):
        return replicate(mesh, state)
    return mps_core.MPS(_distribute(mesh, state.b, TP, 3),
                        _distribute(mesh, state.lam, TP, 1),
                        _distribute(mesh, state.trunc, None, 0))


def shard_pairs(mesh, pairs):
    """A (P, 2) coupling-map array dp-sharded, P padded up to a multiple
    of the dp extent with copies of the first pair. Returns
    (sharded_pairs, original_count)."""
    pairs = np.asarray(pairs, dtype=np.int32).reshape(-1, 2)
    n_pairs = len(pairs)
    dp = axis_size(mesh, DP)
    pad = (-n_pairs) % dp
    if pad:
        pairs = np.concatenate([pairs, np.tile(pairs[:1], (pad, 1))])
    t = torch.as_tensor(pairs, device=rank_device())
    return _distribute(mesh, t, DP, 0), n_pairs


def place(y: torch.Tensor, mesh, split: bool):
    """y, a local shard, as a DTensor on `mesh`: on the tp axis Shard of
    y's last dimension where `split`, else replicated (its global shape
    follows from y's)."""
    from torch.distributed.tensor import DTensor
    tp = axis_size(mesh, TP) if split else 1
    shape = (*y.shape[:-1], y.shape[-1] * tp) if y.dim() else ()
    stride, acc = [], 1
    for extent in reversed(shape):
        stride.append(acc)
        acc *= extent
    return DTensor.from_local(
        y, mesh, _placements(mesh, TP if split else None, max(y.dim() - 1, 0)),
        run_check=False, shape=torch.Size(shape), stride=tuple(stride[::-1]))


def wrap_as(y: torch.Tensor, ref):
    """y, a local shard, as a DTensor placed as ref is (place: split on tp
    where ref is), so a batch of states, or a state at another chi, keeps
    its layout; y itself where ref is not a DTensor."""
    from torch.distributed.tensor import DTensor
    if not isinstance(ref, DTensor):
        return y
    return place(y, ref.device_mesh, split_of(ref) > 1)


def local(x):
    """The local shard of a DTensor (x itself otherwise)."""
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def split_of(x) -> int:
    """How many shards x is split into along the tp axis (1 where it is
    replicated there, or not a DTensor)."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return 1
    tp_dim = AXES.index(TP)
    return (x.device_mesh.size(tp_dim)
            if isinstance(x.placements[tp_dim], Shard) else 1)


def unshard(x):
    """A plain tensor (or MPS) of the whole of a sharded one, gathered
    explicitly over its sharded mesh dimensions; anything else as it is.
    For a checkpoint, which stores every amplitude."""
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(x, mps_core.MPS):
        return mps_core.MPS(*(unshard(t) for t in x))
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    out = x.to_local()
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            name = mesh.mesh_dim_names[i]
            out = gather_dim(out, p.dim, mesh.get_group(name), mesh.size(i),
                             mesh.get_local_rank(name))
    return out


class OnMesh:
    """A sharded engine module (parallel/sv_sharded.py, mps_sharded.py)
    with its mesh bound: each name takes what the same name of the core
    engine (backends/sv_core.py, mps_core.py) takes, so a backend calls
    one engine either way."""

    def __init__(self, module, mesh):
        self._module, self._mesh = module, mesh

    def __getattr__(self, name):
        return functools.partial(getattr(self._module, name), self._mesh)


# -------------------------------------------------------- training steps

def make_mps_training_step(mesh, n: int, chi: int, padded_len: int,
                           threshold: float = 0.0, rotoselect: bool = True):
    """One ADAPT optimisation step over the mesh for the MPS engine: a
    Rotoselect sweep on the chi-sharded MPS (every bond contraction of the
    environment chains over the tp shards with collectives, each two-qubit
    apply's Gram replicated and solved by K2-K4 on every rank, the result
    resharded), then the all-pair 2-site RDMs of the swept state. As in the
    JAX package, the env-chain kernel (K1) and the incremental environments
    are single-device programs and do not run under a mesh.

    run(prefix, tape, select) -> (kinds, angles, cost, swept state (MPS of
    DTensors), rhos (n, n, 4, 4), evaluations)."""
    from . import mps_sharded
    engine = mps_sharded.sweep_engine(mesh, threshold)
    bl = sweeps.default_block_len(  # (a rank's shard: its memory budget)
        padded_len, sweeps.state_nbytes(mps_sharded.zero_mps(mesh, n, chi)))

    def run(prefix, tape, select):
        prefix = shard_mps(mesh, prefix)
        ref = mps_sharded.zero_mps(mesh, n, chi, prefix.dtype, rank_device())
        nk, na, cost, l_state, evals, _ = sweeps.sweep(
            engine, bl, rotoselect, prefix, ref, tape.kinds, tape.q0,
            tape.q1, tape.angles, select)
        rhos = mps_sharded.all_pair_rdms(mesh, l_state)
        return nk, na, cost, l_state, rhos, evals

    return run


def make_training_step(mesh, n: int, padded_len: int,
                       rotoselect: bool = True):
    """One ADAPT optimisation step over the mesh: a Rotoselect sweep on the
    tp-sharded statevector, then the 2-site RDMs of the coupling-map pairs,
    dp-sharded: the quantities the ISL heuristic consumes (the concurrence
    of each 4x4 RDM stays on the host).

    run(prefix, tape, select, pairs) -> (kinds, angles, cost, rhos (P, 4,
    4) complex on the host, evaluations)."""
    from . import sv_sharded
    engine = sv_sharded.sweep_engine(mesh)
    bl = sweeps.default_block_len(padded_len)

    def run(prefix, tape, select, pairs):
        prefix = shard_state(mesh, prefix)
        ref = sv_sharded.zero_state(mesh, n, prefix.dtype, rank_device())
        nk, na, cost, l_state, evals, _ = sweeps.sweep(
            engine, bl, rotoselect, prefix, ref, tape.kinds, tape.q0,
            tape.q1, tape.angles, select)
        rhos = sv_sharded.all_pair_rdms(mesh, l_state, pairs)
        return nk, na, cost, rhos, evals

    return run
