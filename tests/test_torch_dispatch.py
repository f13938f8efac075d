"""The kernels' dispatch rule (ops/dispatch.py) as a pure function of (op,
device type, dtype, size), and the wrappers' launch counters.

On a CUDA device a call launches its kernel wherever one takes it:
complex64 and complex128, chi up to the env chain's cap, m up to the
eigensolver's cap of its dtype. Anything else raises before a launch: there
is no non-kernel route on the card. On the CPU every call runs the plain
version. No card here: the CUDA side is checked as the rule and, for the
wrappers' choice of launcher, with the device type answered as on the card
and the kernel library replaced by a recorder."""

import numpy as np
import pytest
import torch

from adaptaqc_tpu_torch.ops import cplx, cuda_lib, dispatch, eigh_kernels
from adaptaqc_tpu_torch.ops import env_kernel

C64, C128 = torch.complex64, torch.complex128
ENV_CAP = dispatch.REACH["env"][C64][1]
EIGH_CAP, EIGH_CAP_64 = (dispatch.REACH["eigh"][C64][1],
                         dispatch.REACH["eigh"][C128][1])
KERNELS = (env_kernel.env_chain, eigh_kernels.tridiag, eigh_kernels.teig,
           eigh_kernels.backtransform)


def test_caps_are_the_kernels_reach():
    assert dispatch.REACH == {
        "env": {C64: (1, 8192), C128: (1, 8192)},
        "eigh": {C64: (2, 16384), C128: (2, 16384)}}
    assert env_kernel.NARROW_MAX_CHI == 64
    assert env_kernel.CLUSTER_MAX_CHI == 128
    assert eigh_kernels.NARROW_MAX_M == 128
    assert eigh_kernels.REACH_M == {False: 560, True: 504}


@pytest.mark.parametrize("size,want", [
    (1, True), (64, True), (65, True), (128, True), (129, True),
    (ENV_CAP - 1, True), (ENV_CAP, True), (ENV_CAP + 1, False),
    (4 * ENV_CAP, False)])
def test_env_route_on_the_card_by_chi(size, want):
    """complex64 and complex128 alike (the double instantiations take every
    chi the complex64 kernels do); above the cap the call raises."""
    for dtype in (C64, C128):
        if want:
            assert dispatch.use_kernel("env", "cuda", dtype, size)
        else:
            with pytest.raises(ValueError, match=f"size <= {ENV_CAP}"):
                dispatch.use_kernel("env", "cuda", dtype, size)


@pytest.mark.parametrize("size", [1, 2, 128, 129, 256, 504, 505, 560, 561,
                                  EIGH_CAP_64, EIGH_CAP_64 + 1, EIGH_CAP - 1,
                                  EIGH_CAP, EIGH_CAP + 1, 16384])
def test_eigh_route_on_the_card_by_m(size):
    for dtype, hi in ((C64, EIGH_CAP), (C128, EIGH_CAP_64)):
        if 2 <= size <= hi:
            assert dispatch.use_kernel("eigh", "cuda", dtype, size)
        else:
            with pytest.raises(ValueError, match=f"size <= {hi}"):
                dispatch.use_kernel("eigh", "cuda", dtype, size)


@pytest.mark.parametrize("op", ["env", "eigh"])
@pytest.mark.parametrize("dtype", [C64, C128])
@pytest.mark.parametrize("size", [2, 128, 129, 560, 561, 16384])
def test_cpu_always_takes_the_wrappers(op, dtype, size):
    """On the CPU the wrappers run the plain versions, at any size."""
    assert dispatch.use_kernel(op, "cpu", dtype, size) is False


def test_unknown_op_raises():
    with pytest.raises(KeyError):
        dispatch.use_kernel("svd", "cuda", C64, 4)


@pytest.mark.parametrize("op", ["env", "eigh"])
def test_other_dtypes_and_devices_raise_on_the_card(op):
    """A dtype no kernel takes raises; any device but the CPU is held to
    the card's rule (the wrapper then refuses a non-CUDA tensor:
    test_torch_eigh_kernels.py::test_wrapper_never_falls_back_off_cpu)."""
    for dtype in (torch.float32, torch.complex32, torch.bfloat16):
        with pytest.raises(TypeError):
            dispatch.use_kernel(op, "cuda", dtype, 8)
    assert dispatch.use_kernel(op, "meta", C64, 8)
    with pytest.raises(ValueError):
        dispatch.use_kernel(op, "meta", C64, dispatch.REACH[op][C64][1] + 1)


def _reset():
    for fn in KERNELS:
        fn.launches = fn.wide_launches = fn.f64_launches = 0
        fn.reach_launches = fn.reach_f64_launches = 0
    for fn in KERNELS[1:]:
        fn.batched_launches = 0


def _counts():
    return {fn.__name__: (fn.launches, fn.wide_launches, fn.f64_launches)
            for fn in KERNELS}


def _reach_counts():
    return {fn.__name__: (fn.reach_launches, fn.reach_f64_launches)
            for fn in KERNELS}


def _gram(m, dtype, seed=0):
    """A random Gram; past m = 1024, where the recorder only reads its
    shape, a diagonal one (a product of two 4096 x 4096 matrices would take
    a minute here)."""
    rng = np.random.default_rng(seed)
    if m > 1024:
        return torch.diag(torch.tensor(rng.random(m), dtype=dtype))
    a = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
    t = torch.tensor(a / np.linalg.norm(a), dtype=dtype)
    return t.mH @ t


def test_counters_stay_still_on_the_cpu():
    """CPU calls of either dtype run the plain versions: no launch, no
    count."""
    _reset()
    for dtype in (C64, C128):
        cplx.eigh_top(_gram(8, dtype), 4)
        br = torch.randn(5, 2, 4, 4, dtype=dtype)
        env_kernel.env_chain(br, br, 2)
    assert all(v == (0, 0, 0) for v in _counts().values())
    assert all(v == (0, 0) for v in _reach_counts().values())


class _Recorder:
    """Stands in for the kernel library: every launcher records its name
    and returns success; the size queries answer as the library does."""

    def __init__(self):
        self.calls = []
        self.args = []

    def teig_wide_scratch(self, m):
        return 3 * m * m + ((m + 31) // 32) * m

    def teig_grid_plan(self, m, f64, out):
        # K3's card-wide plan as the library makes it on an H100
        out[0], out[1] = 32, min(16, -(-m // 128))
        out[2], out[3] = -(-m // out[1]), -(-m // 64)
        return 0

    def env_chain_f64_partials(self, chi):
        cs = min(8, chi)
        return 2 * cs * cs * (-(-chi // cs)) * chi

    def eigh_wide_routes(self, m, f64):
        # as the library answers on an H100 (227 KB of shared memory a
        # CTA): K3's card-wide route, its iterate in global memory, past m
        # = 640 (complex128 512)
        return int(m > (512 if f64 else 640))

    def backtransform_workspace(self, m, f64):
        return 4096 * m

    def backtransform_strip_workspace(self, m, f64):
        return eigh_kernels.backtransform_strip_plan(m, f64)["workspace"]

    def backtransform_strip_zbuf(self, m, keep, f64):
        return eigh_kernels.backtransform_strip_zbuf_bytes(m, keep, f64)

    def tridiag_routes(self, m, f64):
        # K2's card-wide route past its cluster's shared memory (m = 640,
        # complex128 438), as the library answers on an H100
        return int(m > (438 if f64 else 640))

    def tridiag_grid_workspace(self, m, f64):
        return eigh_kernels.tridiag_grid_workspace_bytes(m, f64)

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append(name)
            self.args.append(args)
            return 0
        return launch


@pytest.fixture
def card(monkeypatch):
    """The wrappers as on the card: the rule answered for "cuda", the
    argument checks and the stream query passed, the library recorded."""
    real = dispatch.use_kernel
    monkeypatch.setattr(dispatch, "use_kernel",
                        lambda op, dev, dtype, size: real(op, "cuda", dtype,
                                                          size))
    monkeypatch.setattr(cuda_lib, "require", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "require_columns",
                        lambda t, name, dtype, lead, rows, cols, stride:
                        rows * stride)
    monkeypatch.setattr(cuda_lib, "stream_of", lambda t: 0)
    lib = _Recorder()
    monkeypatch.setattr(cuda_lib, "lib", lambda: lib)
    _reset()
    yield lib
    _reset()


def test_counters_move_only_on_launches(card):
    """Each wrapper picks its launcher by dtype and size alone and counts
    one launch per call: complex64 m <= 128 the register designs, above it
    the wide variants (wide_launches), complex128 the double instantiation
    at every m (f64_launches). A call above its cap raises before any
    launch and counts nothing."""
    cplx.eigh_top(_gram(64, C64), 8)
    assert card.calls == ["tridiag_launch", "teig_launch",
                          "backtransform_launch"]
    cplx.eigh_top(_gram(192, C64), 8)
    assert card.calls[3:] == ["tridiag_wide_launch", "teig_wide_launch",
                              "backtransform_wide_launch"]
    cplx.eigh_top(_gram(64, C128), 8)
    assert card.calls[6:] == ["tridiag_f64_launch", "teig_f64_launch",
                              "backtransform_f64_launch"]
    for name in ("tridiag", "teig", "backtransform"):
        assert _counts()[name] == (3, 1, 1)
    with pytest.raises(ValueError):
        cplx.eigh_top(_gram(EIGH_CAP_64 + 8, C128), 8)
    assert len(card.calls) == 9
    assert _counts()["tridiag"] == (3, 1, 1)

    for dtype, chi, launcher in ((C64, 8, "env_chain_launch"),
                                 (C64, 96, "env_chain_wide_launch"),
                                 (C128, 96, "env_chain_f64_launch")):
        br = torch.zeros(6, 2, chi, chi, dtype=dtype)
        env_kernel.env_chain(br, br, 3)
        assert card.calls[-1] == launcher
    assert _counts()["env_chain"] == (3, 1, 1)
    with pytest.raises(ValueError):
        br = torch.zeros(2, 2, ENV_CAP + 8, ENV_CAP + 8, dtype=C64)
        env_kernel.env_chain(br, br, 0)
    assert len(card.calls) == 12 and _counts()["env_chain"] == (3, 1, 1)


@pytest.mark.parametrize("dtype", [C64, C128])
def test_reach_edges_launch_and_raise(card, dtype):
    """At the caps the wrappers launch (the streamed env chain at chi =
    8192, the wide eigensolver at m = 16384 in both dtypes, K2 on its
    card-wide route, K4 on its strip route), each launch counted once, by
    the code it ran:
    the streamed K1, K2 and K4 past REACH_M and K3 with its iterate in
    global memory as reach launches of their dtype. One past the caps (chi
    = 8193, m = 16385) the call raises before any launch and counts
    nothing. The inputs are one zero broadcast to their shapes, and K2-K4
    are called as eigh_top_kernels chains them (the recorder reads shapes
    only; a dense Gram at m = 16384 would be 4.3 GB in complex128)."""
    f64 = dtype == C128
    cap = EIGH_CAP_64 if f64 else EIGH_CAP

    def zeros(*shape):
        return torch.zeros((), dtype=dtype).expand(*shape)
    br = zeros(3, 2, ENV_CAP, ENV_CAP)
    env_kernel.env_chain(br, br, 1)
    env_kernel._BOUNDARY.clear()  # its chi x chi boundary, 1 GB at the cap
    assert card.calls == ["env_chain_stream_launch"]
    vrows, tau, d, e = eigh_kernels.tridiag(zeros(cap, cap))
    _, z = eigh_kernels.teig(d, e, 8)
    eigh_kernels.backtransform(vrows, tau, z, 8)
    wide = "f64" if f64 else "wide"
    assert card.calls[1:] == [
        "tridiag_grid_f64_launch" if f64 else "tridiag_grid_launch",
        f"teig_{wide}_launch", "backtransform_strip_launch"]
    for name in ("env_chain", "tridiag", "teig", "backtransform"):
        assert _counts()[name] == (1, 0, 0)
        assert _reach_counts()[name] == ((0, 1) if f64 else (1, 0))
    with pytest.raises(ValueError, match=f"size <= {ENV_CAP}"):
        br = zeros(2, 2, ENV_CAP + 1, ENV_CAP + 1)
        env_kernel.env_chain(br, br, 0)
    with pytest.raises(ValueError, match=f"size <= {cap}"):
        eigh_kernels.tridiag(zeros(cap + 1, cap + 1))
    assert len(card.calls) == 4
    assert _counts()["env_chain"] == (1, 0, 0)


@pytest.mark.parametrize("dtype,m,reach", [
    (C64, 560, False), (C64, 561, True), (C128, 504, False),
    (C128, 505, True)])
def test_reach_counter_starts_past_the_shared_memory_sizes(card, dtype, m,
                                                          reach):
    """K2-K4 launches count as reach launches exactly past REACH_M (560 in
    complex64, 504 in complex128), and as the wide or complex128 variant's
    up to it; the env chain's past chi = 128."""
    f64 = dtype == C128
    cplx.eigh_top(_gram(m, dtype), 8)
    got = _counts()["tridiag"][1:] + _reach_counts()["tridiag"]
    want = [0, 0, 0, 0]
    want[(2 if reach else 0) + f64] = 1
    assert got == tuple(want)
    for chi, streamed in ((128, False), (129, True)):
        br = torch.zeros(3, 2, chi, chi, dtype=dtype)
        env_kernel.env_chain(br, br, 1)
        assert (card.calls[-1] == "env_chain_stream_launch") == streamed
    assert _reach_counts()["env_chain"] == ((0, 1) if f64 else (1, 0))


@pytest.mark.parametrize("dtype,m,kernel,route", [
    (C64, 640, "teig", "smem"), (C64, 641, "teig", "global"),
    (C128, 512, "teig", "smem"), (C128, 513, "teig", "global"),
    (C64, 2048, "teig", "global"), (C128, 2048, "teig", "global"),
    (C64, 560, "backtransform", "size"),
    (C64, 1024, "backtransform", "size"),
    (C128, 504, "backtransform", "size"),
    (C128, 505, "backtransform", "size")])
def test_reach_counters_follow_the_routes(card, dtype, m, kernel, route):
    """K3 counts a launch as a reach launch exactly when the plan sends it
    down the route that only sizes past the old caps take (the card-wide
    route, its iterate in global memory, eigh_kernels.wide_routes), and as
    the wide or
    complex128 variant's where it runs the old code. K4's wide design has
    one route at every m ("size"): it counts as a reach launch exactly
    past REACH_M, as K2 does, and wide_routes names no route of it."""
    f64 = dtype == C128
    routes = eigh_kernels.wide_routes(m, f64)
    if route == "size":
        assert kernel not in routes
        reach = m > eigh_kernels.REACH_M[f64]
    else:
        assert routes[kernel] == route
        reach = route == "global"
    cplx.eigh_top(_gram(m, dtype), 8)
    got = _counts()[kernel][1:] + _reach_counts()[kernel]
    want = [0, 0, 0, 0]
    want[(2 if reach else 0) + f64] = 1
    assert got == tuple(want)


@pytest.mark.parametrize("dtype,m", [(C64, 64), (C64, 256), (C64, 1024),
                                     (C128, 1024), (C64, EIGH_CAP)])
def test_teig_passes_keep_to_its_launcher(card, dtype, m):
    """K3's wrapper hands `keep` to the launcher of every route (the
    narrow kernel has no keep: it computes all m), returns the first keep
    eigenpairs as (keep,) and (m, keep) views of its (m, m) output, and
    K4 reads those keep columns in place at row stride m; a keep outside
    [1, m] raises before any launch. eigh_top's chain passes its own keep
    through."""
    f64 = dtype == C128
    rdt = torch.float64 if f64 else torch.float32
    d, e = torch.zeros(m, dtype=rdt), torch.zeros(m, dtype=rdt)
    keep = m // 2
    w, z = eigh_kernels.teig(d, e, keep)
    assert w.shape == (keep,) and z.shape == (m, keep)
    assert z.stride() == (m, 1)
    name = card.calls[-1]
    if f64 or m > eigh_kernels.NARROW_MAX_M:
        assert name == ("teig_f64_launch" if f64 else "teig_wide_launch")
        # d, e, b0, w, z, scratch, m, keep, batch, strides, stream
        assert card.args[-1][6:9] == (m, keep, 1)
        assert card.args[-1][11] == card.teig_wide_scratch(m)
    else:
        assert name == "teig_launch"
    for bad in (0, m + 1):
        with pytest.raises(ValueError, match="keep"):
            eigh_kernels.teig(d, e, bad)
    assert card.calls[-1] == name and len(card.calls) == 1
    cplx.eigh_top(_gram(m, dtype), 5)
    if f64 or m > eigh_kernels.NARROW_MAX_M:
        assert card.args[-2][7] == 5  # teig's keep; then K4's launch
    assert card.calls[-1].startswith("backtransform")
